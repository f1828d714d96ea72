"""Analytic roofline terms for the H100 (the port of what
``repro.roofline`` gives the scheduler simulator and the write-path
bench): the card's peaks, a model's FLOPs and HBM bytes per step, and the
COW write path's traffic model."""

from repro_torch.roofline.analysis import (
    H100_SXM,
    Hardware,
    model_bytes_for,
    model_flops_for,
)
from repro_torch.roofline.write_path import (
    WRITE_PATHS,
    WriteCost,
    append_cost,
    chain_cost,
    clone_cost,
    compact_cost,
    grow_cost,
)

__all__ = [
    "H100_SXM",
    "Hardware",
    "model_bytes_for",
    "model_flops_for",
    "WRITE_PATHS",
    "WriteCost",
    "append_cost",
    "chain_cost",
    "clone_cost",
    "compact_cost",
    "grow_cost",
]
