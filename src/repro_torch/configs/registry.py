"""Registry over the per-architecture config modules and the input shapes
(the port of ``repro.configs.registry``).  ``ARCHS``, ``ALIASES``,
``get_config`` and ``smoke_config`` live in :mod:`repro_torch.configs`
and are re-exported here."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import ALIASES, ARCHS, get_config, smoke_config

__all__ = ["ARCHS", "ALIASES", "ShapeSpec", "SHAPES", "get_config", "smoke_config", "shape_cells"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_cells(arch: str) -> List[str]:
    """The shape cells of an arch: ``long_500k`` only for the
    sub-quadratic families; every arch is decoder-style, so the decode
    shapes always apply."""
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if get_config(arch).sub_quadratic:
        cells.append("long_500k")
    return cells
