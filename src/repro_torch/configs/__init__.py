"""Architecture registry of the port: ``--arch <id>`` resolves here.

The architectures whose model family the port serves from the paged KV
cache (dense, audio, moe) are known; the rest of the reference's
registry (``repro.configs.registry.ARCHS``: gemma3-12b, llama-3.2-vision-90b,
mamba2-130m, zamba2-7b) decodes through the reference's dense-cache path
and raises until that path is ported (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

from repro_torch.configs import (
    command_r_plus_104b,
    deepseek_moe_16b,
    musicgen_large,
    phi35_moe_42b,
    qwen25_32b,
    starcoder2_3b,
)
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "get_config", "smoke_config"]

ARCHS = {
    "deepseek_moe_16b": deepseek_moe_16b,
    "phi35_moe_42b": phi35_moe_42b,
    "starcoder2_3b": starcoder2_3b,
    "command_r_plus_104b": command_r_plus_104b,
    "qwen25_32b": qwen25_32b,
    "musicgen_large": musicgen_large,
}
# canonical ids -> module names, as the reference's registry has them
ALIASES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "starcoder2-3b": "starcoder2_3b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2.5-32b": "qwen25_32b",
    "musicgen-large": "musicgen_large",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))
    if name not in ARCHS:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet: its family decodes through the "
            f"reference's dense-cache path (ROADMAP.md queue 1, item 6); the port knows "
            f"{tuple(ARCHS)}"
        )
    return ARCHS[name]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU runs and tests."""
    return _module(arch).SMOKE
