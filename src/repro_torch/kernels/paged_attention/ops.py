"""Public entry point for single-token paged attention over the COW pool.

:func:`paged_attention` takes the layer's K/V pool views, the block
tables and the lengths (with the token being decoded counted) and, under
delta COW, the pool's ``parent``/``dirty`` leaves.  It goes to one of two
kernel wrappers, each with its own ``launches`` counter:

* :func:`paged_attention_kernel` — ``paged_attention_pallas``'s port;
* :func:`paged_attention_delta_kernel` — ``paged_attention_delta_pallas``'s.

CUDA tensors launch ``csrc/paged_attention.cu`` (one source, templated on
the variant); CPU tensors run :func:`paged_attention_ref`.  The pools may
be strided views of the ``[blocks, L, 2, bs, KVH, hd]`` pool: only their
last dimension must be contiguous, and the kernel takes their strides.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check, route
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_P, _I, _D, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    tables: torch.Tensor,
    lengths: torch.Tensor,
    *,
    parent: Optional[torch.Tensor] = None,
    dirty: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token GQA attention through the block tables.

    q: [B, H, d]; k_pool/v_pool: [rows, bs, KVH, d] (strided views
    allowed); tables: [B, nb] int32 (-1 = NULL); lengths: [B] int32.
    With ``parent`` ([num_blocks] int32) and ``dirty`` ([num_blocks, bs]
    bool), delta pages resolve their clean slots through the parent.
    Returns [B, H, d] in q's dtype; a row with no valid slot is 0.
    """
    if parent is None:
        return paged_attention_kernel(q, k_pool, v_pool, tables, lengths)
    return paged_attention_delta_kernel(q, k_pool, v_pool, tables, lengths, parent, dirty)


def _check_pools(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor) -> None:
    b, h, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape[-1] != d:
        raise ValueError(f"k_pool: shape {tuple(k_pool.shape)}, expected [rows, bs, KVH, {d}]")
    if v_pool.shape != k_pool.shape or v_pool.stride() != k_pool.stride():
        raise ValueError("v_pool must match k_pool in shape and strides")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools {k_pool.dtype}/{v_pool.dtype}, expected q's {q.dtype}")
    if k_pool.stride(-1) != 1:
        raise ValueError("k_pool/v_pool: the head dimension must be contiguous")
    if h % k_pool.shape[2]:
        raise ValueError(f"{h} query heads do not group over {k_pool.shape[2]} KV heads")


def _launch(q, k_pool, v_pool, tables, lengths, parent, dirty, delta: bool) -> torch.Tensor:
    b, h, d = q.shape
    check(q, "q", tuple(_DTYPES), (b, h, d))
    _check_pools(q, k_pool, v_pool)
    nb = tables.shape[1] if tables.dim() == 2 else -1
    check(tables, "tables", torch.int32, (b, nb))
    check(lengths, "lengths", torch.int32, (b,))
    tensors = [q, k_pool, v_pool, tables, lengths]
    if delta:
        rows = parent.shape[0]
        check(parent, "parent", torch.int32, (rows,))
        check(dirty, "dirty", torch.bool, (rows, k_pool.shape[1]))
        tensors += [parent, dirty]
    if route(*tensors) == "cpu":
        return paged_attention_ref(
            q, k_pool, v_pool, tables, lengths, parent=parent, dirty=dirty
        )
    out = torch.empty_like(q)
    null = ctypes.c_void_p(0)
    _build.launch(
        "paged_attention",
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _D, _C, _C),
        q.device,
        _build.ptr(q),
        _build.ptr(k_pool),
        _build.ptr(v_pool),
        _build.ptr(tables),
        _build.ptr(lengths),
        _build.ptr(parent) if delta else null,
        _build.ptr(dirty) if delta else null,
        _build.ptr(out),
        b,
        h,
        k_pool.shape[2],
        d,
        k_pool.shape[1],
        nb,
        k_pool.stride(0),
        k_pool.stride(1),
        k_pool.stride(2),
        1.0 / math.sqrt(d),
        _DTYPES[q.dtype],
        int(delta),
    )
    wrapper = paged_attention_delta_kernel if delta else paged_attention_kernel
    wrapper.launches += 1
    return out


def paged_attention_kernel(q, k_pool, v_pool, tables, lengths) -> torch.Tensor:
    """The port of ``paged_attention_pallas`` (kernel.py:210)."""
    return _launch(q, k_pool, v_pool, tables, lengths, None, None, delta=False)


def paged_attention_delta_kernel(q, k_pool, v_pool, tables, lengths, parent, dirty) -> torch.Tensor:
    """The port of ``paged_attention_delta_pallas`` (kernel.py:142)."""
    return _launch(q, k_pool, v_pool, tables, lengths, parent, dirty, delta=True)


paged_attention_kernel.launches = 0
paged_attention_delta_kernel.launches = 0
