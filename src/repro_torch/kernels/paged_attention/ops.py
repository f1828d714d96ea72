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

The kernel splits each row's pages into runs (:func:`split_plan`), one
CTA per run and KV head, and a second kernel merges a row's runs in
order.  On the CUDA route the wrapper raises on what the kernel does not
take (:func:`check_kernel_inputs`); the plain version takes any shape.

:func:`paged_attention` goes through the custom ops
``repro_torch::paged_attention`` and ``repro_torch::paged_attention_delta``
(:mod:`repro_torch.kernels._library`), whose CUDA implementations are the
two wrappers: a ``FakeTensorMode`` or DTensor trace holds each call as one
node with its FLOPs (``4 d`` a slot the tables can hold, per query head:
the shapes do not say how many are valid) and shards it over the heads,
or over the rows where the pools are whole on each rank.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._library import replicate_all, shardings
from repro_torch.kernels.dispatch import check, route
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

_P, _I, _D, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Head dims the kernel is built for (``csrc/paged_attention.cu``'s dispatch):
#: those of the repository's dense configs.
HEAD_DIMS = (16, 64, 128, 256)
#: Query heads per KV head: the rows of one tensor-core tile.
MAX_GROUP = 16
#: Slots per warp tile; a split is a whole number of tiles.
SLOT_TILE = 16
#: The fewest CTAs a call aims for: two on each of an H100's 132 SMs.
MIN_CTAS = 2 * 132


def split_plan(b: int, kvh: int, nb: int, bs: int) -> tuple[int, int]:
    """``(pages_per_split, splits)`` for ``b`` rows of ``nb`` pages of
    ``bs`` slots over ``kvh`` KV heads.

    Split ``i`` covers page indices ``[i * pages_per_split, (i + 1) *
    pages_per_split)`` of every row, so each page index lies in exactly
    one split.  The plan reads the shapes alone, never the tables, the
    lengths or the pool: a row's result does not depend on its contents'
    layout, only on its bytes.  A split is a whole number of 16-slot
    tiles, and the splits are as long as allows ``b * kvh * splits >=
    MIN_CTAS`` where the row has pages enough.
    """
    if bs <= 0 or (SLOT_TILE % bs and bs % SLOT_TILE):
        raise ValueError(f"block size {bs}: the kernel takes a divisor or a multiple of {SLOT_TILE}")
    unit = max(1, SLOT_TILE // bs)  # pages in the smallest whole run of tiles
    units = -(-nb // unit)
    want = -(-MIN_CTAS // max(1, b * kvh))
    pages = max(1, units // want) * unit
    return pages, max(1, -(-nb // pages))


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
        return torch.ops.repro_torch.paged_attention(q, k_pool, v_pool, tables, lengths)
    return torch.ops.repro_torch.paged_attention_delta(q, k_pool, v_pool, tables, lengths, parent, dirty)


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


def check_kernel_inputs(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor) -> None:
    """Raise on what the CUDA kernel does not take: a head dim outside
    :data:`HEAD_DIMS`, more than :data:`MAX_GROUP` query heads per KV head,
    or a q or pool whose base or strides are not 16-byte aligned (its loads
    are 16 bytes a lane).  :func:`split_plan` refuses the block sizes it
    cannot split into whole 16-slot tiles."""
    _, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    if h // k_pool.shape[2] > MAX_GROUP:
        raise ValueError(f"{h // k_pool.shape[2]} query heads per KV head; the kernel takes <= {MAX_GROUP}")
    elem = q.element_size()
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16 or any(st * elem % 16 for st in t.stride()[:-1]):
            raise ValueError(f"{name}: base and strides must be multiples of 16 bytes")


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
    check_kernel_inputs(q, k_pool, v_pool)
    kvh, bs = k_pool.shape[2], k_pool.shape[1]
    pages, splits = split_plan(b, kvh, nb, bs)
    out = torch.empty_like(q)
    # Each (row, KV head, split)'s partial state: acc[G][d], m[G], l[G].
    ws = torch.empty(b * kvh * splits * (h // kvh) * (d + 2), dtype=torch.float32, device=q.device)
    null = ctypes.c_void_p(0)
    _build.launch(
        "paged_attention",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _D, _C, _C),
        q.device,
        _build.ptr(q),
        _build.ptr(k_pool),
        _build.ptr(v_pool),
        _build.ptr(tables),
        _build.ptr(lengths),
        _build.ptr(parent) if delta else null,
        _build.ptr(dirty) if delta else null,
        _build.ptr(out),
        _build.ptr(ws),
        b,
        h,
        kvh,
        d,
        bs,
        nb,
        pages,
        splits,
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


# ---------------------------------------------------------------------------
# the custom ops (kernels/_library.py)
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::paged_attention", mutates_args=(), device_types=("cuda", "cpu"))
def _paged_op(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, tables: torch.Tensor,
              lengths: torch.Tensor) -> torch.Tensor:
    """:func:`paged_attention_kernel`: its checks, then the kernel (CUDA) or
    :func:`paged_attention_ref` (CPU)."""
    return paged_attention_kernel(q, k_pool, v_pool, tables, lengths)


@_paged_op.register_fake
def _(q, k_pool, v_pool, tables, lengths):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::paged_attention_delta", mutates_args=(), device_types=("cuda", "cpu"))
def _paged_delta_op(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor, tables: torch.Tensor,
                    lengths: torch.Tensor, parent: torch.Tensor, dirty: torch.Tensor) -> torch.Tensor:
    """:func:`paged_attention_delta_kernel`, as :func:`_paged_op`."""
    return paged_attention_delta_kernel(q, k_pool, v_pool, tables, lengths, parent, dirty)


@_paged_delta_op.register_fake
def _(q, k_pool, v_pool, tables, lengths, parent, dirty):
    return torch.empty_like(q)


def table_flops(q_shape, k_shape, t_shape) -> int:
    """``4 d`` FLOPs a slot the tables can hold, per row and query head."""
    b, h, d = q_shape
    return 4 * d * b * h * t_shape[1] * k_shape[1]


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.paged_attention)
    def _(q_shape, k_shape, v_shape, t_shape, l_shape, *args, out_shape=None, **kwargs):
        return table_flops(q_shape, k_shape, t_shape)

    @register_flop_formula(torch.ops.repro_torch.paged_attention_delta)
    def _(q_shape, k_shape, v_shape, t_shape, l_shape, *args, out_shape=None, **kwargs):
        return table_flops(q_shape, k_shape, t_shape)


_register_flops()


def _paged_shardings(n_extra: int):
    from torch.distributed.tensor import Replicate, Shard

    r, extra = Replicate(), [Replicate()] * n_extra
    return [
        ([Shard(1)], [Shard(1), Shard(2), Shard(2), r, r] + extra),
        ([Shard(0)], [Shard(0), r, r, Shard(0), Shard(0)] + extra),
        replicate_all(1, 5 + n_extra, (True,) * (5 + n_extra)),
    ]


@shardings(torch.ops.repro_torch.paged_attention.default)
def _(q, k_pool, v_pool, tables, lengths):
    return _paged_shardings(0)


@shardings(torch.ops.repro_torch.paged_attention_delta.default)
def _(q, k_pool, v_pool, tables, lengths, parent, dirty):
    return _paged_shardings(2)
