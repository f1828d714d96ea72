"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the architectures whose model family is ported are known; the rest
of the reference's registry (``repro.configs.registry.ARCHS``) raises
until its family is ported (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from repro_torch.configs import starcoder2_3b
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "smoke_config"]

ARCHS = {"starcoder2_3b": starcoder2_3b}
ALIASES = {"starcoder2-3b": "starcoder2_3b"}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))
    if name not in ARCHS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet; the port knows "
            f"{tuple(ARCHS)} (other families: ROADMAP.md queue 1, item 6)"
        )
    return ARCHS[name]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU runs and tests."""
    return _module(arch).SMOKE
