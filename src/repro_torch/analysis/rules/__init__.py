"""Rule registry: one module per contract, all instantiated here."""

from repro_torch.analysis.rules.base import Rule
from repro_torch.analysis.rules.build_in_hot_path import BuildInHotPath
from repro_torch.analysis.rules.id_into_values import IdIntoValues
from repro_torch.analysis.rules.stale_remap import StaleRemap
from repro_torch.analysis.rules.unchecked_oom import UncheckedOom
from repro_torch.analysis.rules.unthreaded_pool import UnthreadedPool
from repro_torch.analysis.rules.use_after_consume import UseAfterConsume

ALL_RULES = (
    UnthreadedPool(),
    StaleRemap(),
    IdIntoValues(),
    UseAfterConsume(),
    BuildInHotPath(),
    UncheckedOom(),
)

RULES_BY_NAME = {r.name: r for r in ALL_RULES}

__all__ = ["ALL_RULES", "RULES_BY_NAME", "Rule"]
