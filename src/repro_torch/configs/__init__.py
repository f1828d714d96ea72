"""Architecture registry of the port: ``--arch <id>`` resolves here.

Every architecture of the reference's registry
(``repro.configs.registry.ARCHS``), by module name or canonical id; an
unknown one raises.  ``LanguageModel`` builds them all; the paged
``ServeEngine`` serves the dense, audio and moe families, and the others
decode through ``LanguageModel.prefill``/``decode_step``'s dense caches.
``ShapeSpec``, ``SHAPES`` and ``shape_cells`` live in
:mod:`repro_torch.configs.registry` (imported here on first use).
"""

from __future__ import annotations

from repro_torch.configs import (
    command_r_plus_104b,
    deepseek_moe_16b,
    gemma3_12b,
    llama32_vision_90b,
    mamba2_130m,
    musicgen_large,
    phi35_moe_42b,
    qwen25_32b,
    starcoder2_3b,
    zamba2_7b,
)
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "ALIASES", "SHAPES", "get_config", "smoke_config", "shape_cells"]

ARCHS = {
    "zamba2_7b": zamba2_7b,
    "deepseek_moe_16b": deepseek_moe_16b,
    "phi35_moe_42b": phi35_moe_42b,
    "starcoder2_3b": starcoder2_3b,
    "gemma3_12b": gemma3_12b,
    "command_r_plus_104b": command_r_plus_104b,
    "qwen25_32b": qwen25_32b,
    "llama32_vision_90b": llama32_vision_90b,
    "musicgen_large": musicgen_large,
    "mamba2_130m": mamba2_130m,
}
# canonical ids -> module names, as the reference's registry has them
ALIASES = {
    "zamba2-7b": "zamba2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "starcoder2-3b": "starcoder2_3b",
    "gemma3-12b": "gemma3_12b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2.5-32b": "qwen25_32b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "musicgen-large": "musicgen_large",
    "mamba2-130m": "mamba2_130m",
}


def _module(arch: str):
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))
    if name not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r}; the port knows {tuple(ARCHS)}")
    return ARCHS[name]


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU runs and tests."""
    return _module(arch).SMOKE


def __getattr__(name: str):
    # The registry imports this module: its names resolve on first use.
    if name in ("SHAPES", "ShapeSpec", "shape_cells"):
        from repro_torch.configs import registry

        return getattr(registry, name)
    raise AttributeError(name)
