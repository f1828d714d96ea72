"""Roofline terms for the H100 (the port of ``repro.roofline``): the
card's peaks, a model's FLOPs and HBM bytes per step, a traced step's
roofline (:func:`analyze_traced`; the dry-run tables are
:mod:`repro_torch.roofline.report`), and the COW write path's traffic
model."""

from repro_torch.roofline.analysis import (
    H100_SXM,
    Hardware,
    Roofline,
    analyze_traced,
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
    "Roofline",
    "analyze_traced",
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
