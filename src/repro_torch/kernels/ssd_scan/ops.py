"""Public SSD-scan entry point (Mamba2's chunked scan, one B/C group).

CUDA tensors launch ``csrc/ssd_scan.cu``; CPU tensors run
:func:`ssd_scan_ref`.  Both return ``(y [B,S,H,P] f32, h_final
[B,H,P,N] f32)``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check, route
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] (post-softplus)
    a: torch.Tensor,  # [H] (negative)
    bmat: torch.Tensor,  # [B, S, N]
    cmat: torch.Tensor,  # [B, S, N]
    *,
    chunk: int = 64,
):
    """Chunked SSD scan; returns (y [B,S,H,P] f32, h_final [B,H,P,N] f32).
    x, bmat and cmat are f32 or bf16 (one dtype); dt and a go in as f32.
    On the card, a chunk, P and N whose tiles overflow a block's shared
    memory (~227 KB; 133 KB at chunk 64, P 64, N 128) make the launch
    raise."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    check(x, "x", tuple(_DTYPES))
    check(bmat, "bmat", x.dtype, (b, s, n))
    check(cmat, "cmat", x.dtype, (b, s, n))
    dt = dt.float().contiguous()
    a = a.float().contiguous()
    check(dt, "dt", torch.float32, (b, s, h))
    check(a, "a", torch.float32, (h,))
    q = min(chunk, s)
    if q and s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    if route(x, dt, a, bmat, cmat) == "cpu":
        return ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk)
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    hout = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if b and h and s:
        _build.launch(
            "ssd_scan",
            (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _C),
            x.device,
            _build.ptr(x), _build.ptr(dt), _build.ptr(a), _build.ptr(bmat), _build.ptr(cmat),
            _build.ptr(y), _build.ptr(hout),
            b, s, h, p, n, q, _DTYPES[x.dtype],
        )
        ssd_scan.launches += 1
    return y, hout


ssd_scan.launches = 0
