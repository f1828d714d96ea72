"""Public entry points for the fused clone bookkeeping.

:func:`refcount_delta` is the kernel wrapper: CUDA tensors launch
``csrc/refcount_update.cu``, CPU tensors run
:func:`refcount_delta_ref`.  :func:`refcount_update` builds the
``add_refs`` -> ``sub_refs`` -> ``freeze`` replacement on it, handing it
the tables' row length so the kernel can follow a block down the
particle axis: the new refcount, the new frozen mask, and the
newly-freed mask for the caller's ``pool.push_free_mask``.  Integer arithmetic commutes and
FREEZE is idempotent membership, so both paths are bit-exact.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check, route
from repro_torch.kernels.refcount_update.ref import refcount_delta_ref

_P, _I = ctypes.c_void_p, ctypes.c_int64


def refcount_delta(
    new_tables: torch.Tensor,  # [e] int32, flattened (NULL = -1 allowed)
    old_tables: torch.Tensor,  # [e] int32
    num_blocks: int,
    *,
    row: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(delta [num_blocks] int32, member [num_blocks] bool)``.

    ``row``: the tables' row length (``[e // row, row]`` row-major; default
    one row of ``e``).  It changes no result, only the order in which the
    kernel walks the entries: down each column, where resampled tables
    repeat a block over runs of particles."""
    e = new_tables.shape[0]
    check(new_tables, "new_tables", torch.int32, (e,))
    check(old_tables, "old_tables", torch.int32, (e,))
    row = e if row is None else row
    if e and (row <= 0 or e % row):
        raise ValueError(f"row length {row} does not divide {e} entries")
    if route(new_tables, old_tables) == "cpu":
        return refcount_delta_ref(new_tables, old_tables, num_blocks)
    dev = new_tables.device
    delta = torch.zeros(num_blocks, dtype=torch.int32, device=dev)
    member = torch.zeros(num_blocks, dtype=torch.bool, device=dev)
    if e > 0 and num_blocks > 0:
        _build.launch(
            "refcount_delta",
            (_P, _P, _I, _I, _I, _P, _P),
            dev,
            _build.ptr(new_tables),
            _build.ptr(old_tables),
            e // row,
            row,
            num_blocks,
            _build.ptr(delta),
            _build.ptr(member),
        )
        refcount_delta.launches += 1
    return delta, member


refcount_delta.launches = 0


def refcount_update(
    refcount: torch.Tensor,  # [num_blocks] int32
    frozen: torch.Tensor,  # [num_blocks] bool
    new_tables: torch.Tensor,  # any shape, int32 (NULL = -1 allowed)
    old_tables: torch.Tensor,  # same shape, int32
    *,
    do_freeze: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(refcount', frozen', newly_freed [num_blocks] bool)``."""
    nb = refcount.shape[0]
    row = new_tables.shape[-1] if new_tables.dim() > 1 and new_tables.shape[-1] else None
    delta, member = refcount_delta(
        new_tables.reshape(-1).contiguous(), old_tables.reshape(-1).contiguous(), nb, row=row
    )
    new_refcount = refcount + delta
    newly_freed = (refcount > 0) & (new_refcount == 0)
    new_frozen = frozen | member if do_freeze else frozen
    return new_refcount, new_frozen, newly_freed
