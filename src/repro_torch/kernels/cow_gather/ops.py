"""Public entry points for the COW block gather and pool compaction.

CUDA tensors launch ``csrc/cow_gather.cu``; CPU tensors run
:func:`cow_gather_ref`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cow_gather.ref import cow_gather_ref
from repro_torch.kernels.dispatch import check, route

_P, _I = ctypes.c_void_p, ctypes.c_int64
_WORD_DTYPES = (torch.float32, torch.int32)


def cow_gather(
    pool: torch.Tensor,
    table: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather pool blocks by table; negative entries yield zero blocks.

    pool: [rows, *block_shape], of 32-bit words, or of any dtype whose
    rows are whole words (viewed as int32); table: [k] int32.  Returns
    ``[k, *block_shape]``, written into ``out`` when it is given.
    """
    k = table.shape[0]
    if pool.dtype not in _WORD_DTYPES and pool.is_contiguous():
        # Any payload is gathered as 32-bit words (a bf16 KV page is
        # [L, 2, bs, KVH, hd] halves): view it, gather, view back.
        row_bytes = pool[0].numel() * pool.element_size() if pool.shape[0] else 0
        if row_bytes % 4 == 0 and (out is None or out.is_contiguous()):
            words = pool.reshape(pool.shape[0], -1).view(torch.int32)
            if out is None:
                out = torch.empty((k, *pool.shape[1:]), dtype=pool.dtype, device=pool.device)
            cow_gather(words, table, out=out.reshape(k, -1).view(torch.int32))
            return out
    check(pool, "pool", _WORD_DTYPES)
    check(table, "table", torch.int32, (k,))
    if out is None:
        out = torch.empty((k, *pool.shape[1:]), dtype=pool.dtype, device=pool.device)
    check(out, "out", pool.dtype, (k, *pool.shape[1:]))
    if route(pool, table, out) == "cpu":
        out.copy_(cow_gather_ref(pool, table))
    elif k > 0:
        _build.launch(
            "cow_gather",
            (_P, _P, _P, _I, _I, _I),
            pool.device,
            _build.ptr(pool),
            _build.ptr(table),
            _build.ptr(out),
            k,
            math.prod(pool.shape[1:]),
            pool.shape[0],
        )
        cow_gather.launches += 1
    return out


cow_gather.launches = 0


def pool_compact(data: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Relocate pool payload rows for compaction.

    ``data: [num_blocks + 1, *block_shape]`` is a pool's payload with its
    trailing dump row; ``perm: [target] int32`` names the old block
    feeding each new slot (``-1`` leaves the slot zero).  Returns
    ``[target + 1, *block_shape]`` with a fresh zero dump row — one
    gather straight into the new buffer.
    """
    target = perm.shape[0]
    out = torch.empty((target + 1, *data.shape[1:]), dtype=data.dtype, device=data.device)
    cow_gather(data, perm, out=out[:target])
    out[target].zero_()
    return out
