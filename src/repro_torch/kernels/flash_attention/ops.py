"""Public flash-attention entry point, in the model layout ``[B, S, H, d]``
as the reference's ``flash_attention/ops.py``.

CUDA tensors launch ``csrc/flash_attention.cu``, which works in the
``[B, H, S, d]`` layout of the TPU kernel: it is handed the transposed
views and their strides, so no layout copy is made, and it writes the
``[B, S, H, d]`` output through the same kind of view.  bf16 inputs go to
the tensor-core kernel, whose TMA loads need 16-byte aligned bases and
strides (a view without them raises); f32 inputs to the CUDA-core
kernel.  CPU tensors run :func:`flash_attention_ref` on the same views.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check, route
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I, _D, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dimensions the kernel is built for: those of the configs, and the
#: smoke configs' 16 and 32
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: those the bf16 tensor-core kernel takes: 16 and 32 are f32 only (the
#: CUDA-core kernel), since no config runs bf16 at those widths
BF16_HEAD_DIMS = (64, 112, 128, 256)


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
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if route(q, k, v) == "cpu":
        return flash_attention_ref(qt, kt, vt, scale=scale, window=window).transpose(1, 2)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and d not in BF16_HEAD_DIMS:
        raise ValueError(f"head dim {d} in bf16: the tensor-core kernel is built for {BF16_HEAD_DIMS}")
    if sk == 0:  # no key: every row writes 0, and TMA takes no empty extent
        return torch.zeros_like(q)
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:3]):
                raise ValueError(f"{name}: TMA needs 16-byte aligned base and strides {t.stride()}")
    out = torch.empty_like(q)
    ot = out.transpose(1, 2)
    strides = (ctypes.c_int64 * 12)(*(s for t in (qt, kt, vt, ot) for s in t.stride()[:3]))
    _build.launch(
        "flash_attention",
        (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _D, _I, _C),
        q.device,
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        b, h, kvh, sq, sk, d,
        ctypes.cast(strides, ctypes.c_void_p), float(scale), int(window), _DTYPES[q.dtype],
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
