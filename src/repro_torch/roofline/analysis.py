"""Roofline terms of a traced step, a model's FLOPs and unavoidable HBM
bytes per step, and the card's peaks (the port of
``repro.roofline.analysis``).

Three terms per (arch x shape x mesh), in seconds, per card:

    compute    = traced FLOPs            / peak FLOP/s
    memory     = traced bytes accessed   / HBM bandwidth
    collective = collective operand bytes / NVLink bandwidth

:func:`analyze_traced` is the counterpart of the reference's
``analyze_compiled``: it reads :mod:`repro_torch.distributed.costs`'s
walk of the per-rank graph (already per card, as XLA's partitioned
module is) where the reference reads XLA's cost analysis and its HLO
parse.  Also reported: MODEL_FLOPS (6 N_active tokens for training,
2 N_active tokens for inference) and the usefulness ratio MODEL_FLOPS /
(traced FLOPs x cards), which exposes redundant work.

``CostModel.from_roofline`` (:mod:`repro_torch.serving.sim`) prices a
decode tick and a prefill as the larger of two times: useful FLOPs over
the peak rate, or the bytes a step must move over the HBM rate;
``CostModel.from_traced`` prices them from a traced step.
"""

from __future__ import annotations

import dataclasses

from typing import Any, Dict

from repro_torch.models.config import ModelConfig

__all__ = ["H100_SXM", "Hardware", "Roofline", "analyze_traced", "model_bytes_for", "model_flops_for",
           "weight_budget_gb"]


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float  # FLOP/s per card (bf16, dense)
    hbm_bw: float  # bytes/s per card
    nvlink_bw: float  # bytes/s per card, each way
    hbm_bytes: float = 80e9  # device memory per card


# NVIDIA's data sheet, SXM part, dense rates at the full 700 W power limit.
H100_SXM = Hardware(name="h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, nvlink_bw=450e9, hbm_bytes=80e9)

#: The share of a card's memory the weights and KV of a decode cell may
#: take and still keep them resident (TP-only): the reference's 14.0 GB of
#: a TPU v5e's 16 GB (``launch/steps.py:329`` of the JAX package).
HBM_HEADROOM = 14.0 / 16.0


def weight_budget_gb(hw: Hardware) -> float:
    """GB of weights plus KV a card of ``hw`` holds resident."""
    return hw.hbm_bytes * HBM_HEADROOM / 1e9


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


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_card: float
    bytes_per_card: float
    collective_bytes_per_card: float
    collective_breakdown: Dict[str, int]
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (traced FLOPs * cards)
    dominant: str
    step_time_lower_bound_s: float
    roofline_fraction: float  # max-term time vs the ideal

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def analyze_traced(
    costs: Dict[str, Any],
    n_cards: int,
    cfg: ModelConfig,
    kind: str,
    batch: int,
    seq: int,
    hw: Hardware = H100_SXM,
) -> Roofline:
    """The roofline of one card's traced step (``costs``:
    :func:`repro_torch.distributed.costs.graph_costs`' keys).

    The collective term prices every collective byte at ``hw.nvlink_bw``.
    A 16-way model axis spans two 8-card NVLink domains of an H100 host
    (and the data and pod axes cross hosts), so part of that traffic
    crosses the slower inter-host network: the term is a lower bound."""
    flops = float(costs["flops"])
    bytes_accessed = float(costs["bytes"])
    coll_total = float(costs["collective_bytes"])
    terms = {
        "compute": flops / hw.peak_flops,
        "memory": bytes_accessed / hw.hbm_bw,
        "collective": coll_total / hw.nvlink_bw,
    }
    mf = model_flops_for(cfg, kind, batch, seq)
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    # ideal: useful FLOPs at peak, or the intrinsic HBM floor (weights +
    # KV/state reads), whichever binds, spread over all cards.
    mb = model_bytes_for(cfg, kind, batch, seq)
    ideal = max(mf / (n_cards * hw.peak_flops), mb / (n_cards * hw.hbm_bw))
    return Roofline(
        compute_s=terms["compute"],
        memory_s=terms["memory"],
        collective_s=terms["collective"],
        flops_per_card=flops,
        bytes_per_card=bytes_accessed,
        collective_bytes_per_card=coll_total,
        collective_breakdown={k: int(v) for k, v in costs["collective_breakdown"].items()},
        model_flops=mf,
        useful_ratio=mf / max(flops * n_cards, 1.0),
        dominant=dominant,
        step_time_lower_bound_s=bound,
        roofline_fraction=min(1.0, ideal / bound) if bound > 0 else 0.0,
    )
