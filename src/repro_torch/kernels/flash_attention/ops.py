"""Public flash-attention entry point, in the model layout ``[B, S, H, d]``
as the reference's ``flash_attention/ops.py``.

CUDA tensors launch ``csrc/flash_attention.cu``, which works in the
``[B, H, S, d]`` layout of the TPU kernel: it is handed the transposed
views and their strides, so no layout copy is made, and it writes the
``[B, S, H, d]`` output through the same kind of view.  bf16 inputs at
head dim 64 and above go to the tensor-core kernel, whose TMA loads need
16-byte aligned bases and strides (a view without them raises); f32
inputs, and bf16 at head dims 16 and 32, to the CUDA-core kernel (bf16
there is loaded into f32 and the arithmetic is f32: P is not rounded to
bf16).  CPU tensors run :func:`flash_attention_ref` on the same views.

On CUDA tensors the call is differentiable through one
``torch.autograd.Function``: its backward launches
``csrc/flash_attention_bwd.cu`` (:func:`flash_attention_bwd`), which
recomputes P from the row log-sum-exp and writes dQ, dK and dV without
atomics, so a repeat call is bit-equal.  The backward takes the same
route as the forward (:func:`tensor_core_route`): on the tensor-core
route the forward kernel also writes the row log-sum-exp when autograd
will need it, and the ``Function`` keeps it for the backward.  On CPU
tensors autograd differentiates the plain version, as the reference's
``jax.grad`` differentiates ``attention_chunked``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check, require_aligned, route
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

_P, _I, _D, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dimensions the kernel is built for: those of the configs, and the
#: smoke configs' 16 and 32
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: those the bf16 tensor-core kernel takes (one wgmma k-step is 16 wide and
#: a K tile a 64-column box); bf16 at 16 and 32 runs on the CUDA-core kernel
WGMMA_HEAD_DIMS = (64, 112, 128, 256)
#: query rows of one tensor-core tile: the row log-sum-exp's buffer holds
#: this multiple of Sq a (batch, head), so each tile's 64 values are one
#: TMA box
LSE_ROWS = 64


def tensor_core_route(dtype: torch.dtype, d: int) -> bool:
    """Whether the kernels take inputs of ``dtype`` at head dim ``d`` on
    the tensor cores (wgmma), forward and backward: bf16 at the head dims
    of ``WGMMA_HEAD_DIMS``.  f32 (TF32 would break its limits) and bf16 at
    d 16 and 32 (one wgmma k-step is 16 wide, a tile a 64-column box) run
    on the CUDA cores."""
    return dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS


def _lse_buffer(q: torch.Tensor) -> torch.Tensor:
    """The forward's row log-sum-exp for the tensor-core backward: f32
    ``[B, H, Sq rounded up to LSE_ROWS]``."""
    b, sq, h, _ = q.shape
    return torch.empty((b, h, -(-sq // LSE_ROWS) * LSE_ROWS), dtype=torch.float32, device=q.device)


def flash_attention(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, S, KVH, d]
    v: torch.Tensor,  # [B, S, KVH, d]
    *,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Causal GQA attention (``window > 0``: key j visible to query i only
    where ``i - j < window``).  Returns ``[B, S, H, d]`` in q's dtype."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(t, name, tuple(_DTYPES))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if route(q, k, v) == "cpu":
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        return flash_attention_ref(qt, kt, vt, scale=scale, window=window).transpose(1, 2)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    return _FlashAttention.apply(q, k, v, int(window), float(scale))


def _forward(q, k, v, window: int, scale: float, lse: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on checked CUDA inputs, counted
    as one call of :func:`flash_attention`."""
    out = _launch_forward(q, k, v, window, scale, lse)
    flash_attention.launches += 1
    return out


def _launch_forward(q, k, v, window: int, scale: float, lse: torch.Tensor | None = None) -> torch.Tensor:
    """The forward kernel's launch; with ``lse`` (tensor-core route only,
    :func:`_lse_buffer`'s shape) it also writes each row's log-sum-exp
    there, in log2 units of the scaled scores."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if sk == 0:  # no key: every row writes 0, and TMA takes no empty extent
        if lse is not None:
            lse.fill_(math.inf)
        return torch.zeros_like(q)
    if tensor_core_route(q.dtype, d):
        require_aligned("flash_attention (TMA)", strides=3, q=q, k=k, v=v)
    elif lse is not None:
        raise ValueError("the CUDA-core forward writes no log-sum-exp")
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    out = torch.empty_like(q)
    ot = out.transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*(s for t in (qt, kt, vt, ot) for s in t.stride()[:3]))
    _build.launch(
        "flash_attention",
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _D, _I, _C, _P, _I),
        q.device,
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        b, h, kvh, sq, sk, d,
        ctypes.cast(strides, ctypes.c_void_p), float(scale), int(window), _DTYPES[q.dtype],
        ctypes.c_void_p(None if lse is None else lse.data_ptr()), 0 if lse is None else lse.shape[-1],
    )
    return out


def forward_lse(q, k, v, *, window: int = 0, scale: float | None = None):
    """The forward on the tensor-core route, as the autograd ``Function``
    runs it when it keeps the log-sum-exp: ``(out, lse)``, ``lse`` each
    row's log-sum-exp of the scaled scores in log2 units
    (:func:`_lse_buffer`'s shape), for a direct call of
    :func:`flash_attention_bwd`.  One call of :func:`flash_attention`,
    counted as one.  CUDA inputs on the tensor-core route only
    (:func:`tensor_core_route`)."""
    if route(q, k, v) == "cpu" or not tensor_core_route(q.dtype, q.shape[-1]):
        raise ValueError(f"the row log-sum-exp is the tensor-core forward's ({q.dtype}, d {q.shape[-1]}, "
                         f"{q.device})")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    lse = _lse_buffer(q)
    return _forward(q, k, v, int(window), float(scale), lse), lse


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale):
        keep = tensor_core_route(q.dtype, q.shape[-1]) and any(ctx.needs_input_grad[:3])
        lse = _lse_buffer(q) if keep else None
        out = _forward(q, k, v, window, scale, lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.scale = window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, window=ctx.window, scale=ctx.scale, lse=lse)
        return dq, dk, dv, None, None


flash_attention.launches = 0


def flash_attention_bwd(
    q: torch.Tensor,  # [B, Sq, H, d]
    k: torch.Tensor,  # [B, Sk, KVH, d]
    v: torch.Tensor,  # [B, Sk, KVH, d]
    out: torch.Tensor,  # [B, Sq, H, d], the forward's output
    dout: torch.Tensor,  # [B, Sq, H, d]
    *,
    window: int = 0,
    scale: float | None = None,
    lse: torch.Tensor | None = None,
):
    """The gradient of :func:`flash_attention`: ``(dq, dk, dv)`` in q's
    dtype.  CUDA tensors launch ``csrc/flash_attention_bwd.cu``, its
    launches counted as one call, on the forward's route
    (:func:`tensor_core_route`).  On the tensor cores, two:
    ``rowsum(dout * out)``, then dK and dV with dQ in one launch, reading
    the row log-sum-exp that the forward kernel wrote into ``lse`` (log2
    units, :func:`_lse_buffer`'s shape): the autograd ``Function`` keeps
    it, and :func:`forward_lse` gives it with the output for a direct
    call.  There ``lse`` is required and the inputs must sit at 16-byte
    aligned addresses (TMA), else ``ValueError``.  On the CUDA cores, three:
    the row log-sum-exp and ``rowsum(dout * out)``, then dK and dV, then dQ;
    ``lse`` is not read.  CPU tensors run :func:`flash_attention_bwd_ref`,
    which ignores ``out`` and ``lse``."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be q's shape")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if route(q, k, v, out, dout) == "cpu":
        return flash_attention_bwd_ref(q, k, v, dout, scale=scale, window=window)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    q, k, v, out = (t.contiguous() for t in (q, k, v, out))
    dout = dout.to(q.dtype).contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        check(t, name, tuple(_DTYPES))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if sq == 0 or sk == 0 or b == 0 or h == 0:  # nothing is visible: every gradient is 0
        return dq.zero_(), dk.zero_(), dv.zero_()
    if tensor_core_route(q.dtype, d):
        require_aligned("flash_attention_bwd (TMA)", strides=3, q=q, k=k, v=v, out=out, dout=dout)
        if lse is None or lse.shape != _lse_buffer(q).shape or lse.dtype != torch.float32 \
                or not lse.is_contiguous():
            raise ValueError(f"lse {None if lse is None else (tuple(lse.shape), lse.dtype)}: the tensor-core "
                             f"backward reads the forward's [B, H, Sq rounded up to {LSE_ROWS}] f32 "
                             f"(forward_lse)")
    else:
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    _build.launch(
        "flash_attention_bwd",
        (_P,) * 10 + (_I, _I, _I, _I, _I, _I, _D, _I, _C, _I),
        q.device,
        *(_build.ptr(t) for t in (q, k, v, out, dout, dq, dk, dv, lse, delta)),
        b, h, kvh, sq, sk, d, float(scale), int(window), _DTYPES[q.dtype], lse.shape[-1],
    )
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
