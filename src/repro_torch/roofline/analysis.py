"""A model's FLOPs and unavoidable HBM bytes per step, and the card's
peaks (the port of ``repro.roofline.analysis:28-96``).

``CostModel.from_roofline`` (:mod:`repro_torch.serving.sim`) prices a
decode tick and a prefill as the larger of the two times: useful FLOPs
over the peak rate, or the bytes a step must move over the HBM rate.

The reference's ``Roofline`` and ``analyze_compiled`` read XLA's compiled
HLO; their counterparts (``torch.utils.flop_counter`` and profiler
measurements) wait for ROADMAP.md queue 1, item 8.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

__all__ = ["H100_SXM", "Hardware", "model_bytes_for", "model_flops_for"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float  # FLOP/s per card (bf16, dense)
    hbm_bw: float  # bytes/s per card
    nvlink_bw: float  # bytes/s per card, each way


# NVIDIA's data sheet, SXM part, dense rates at the full 700 W power limit.
H100_SXM = Hardware(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, nvlink_bw=450e9)


def model_flops_for(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * batch * seq
    if kind == "prefill":
        return 2.0 * n_active * batch * seq
    # decode: one token per sequence
    return 2.0 * n_active * batch


def model_bytes_for(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """Unavoidable HBM traffic for one step (bf16), across all cards.

    Training/prefill: read the (active) weights once per microbatch pass
    — the single-read floor.  Decode additionally reads the whole KV
    cache (or SSM states) once per token: the intrinsic memory-bound
    floor that makes a pure-compute ideal meaningless for decode shapes.
    """
    wb = 2.0 * cfg.active_param_count()
    if kind != "decode":
        return wb
    if cfg.family == "ssm":
        state = cfg.n_layers * cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
        return wb + batch * state
    kv_layers = cfg.n_layers
    window_layers = 0
    if cfg.family == "local_global":
        units = cfg.n_layers // (cfg.local_ratio + 1)
        kv_layers = units
        window_layers = units * cfg.local_ratio
    if cfg.family == "hybrid":
        kv_layers = cfg.n_layers // max(cfg.attn_every, 1)
    kv = kv_layers * seq * cfg.n_kv_heads * cfg.hd * 2 * 2
    kv += window_layers * min(seq, cfg.window) * cfg.n_kv_heads * cfg.hd * 2 * 2
    if cfg.family == "hybrid":
        kv += cfg.n_layers * cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    return wb + batch * kv
