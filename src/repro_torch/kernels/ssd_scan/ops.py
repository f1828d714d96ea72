"""Public SSD-scan entry point (Mamba2's chunked scan, one B/C group).

CUDA tensors launch ``csrc/ssd_scan.cu`` (a chunk-parallel kernel, then
a pass over the chunks, both on the tensor cores) under the plan that
:func:`card_plan` reads from the shapes; CPU tensors run
:func:`ssd_scan_ref`.  Both return ``(y [B,S,H,P] f32, h_final
[B,H,P,N] f32)``.

The kernel takes the chunk as a multiple of 16; the wrapper takes any
length the plain version does (S a multiple of ``min(chunk, S)``).  Where
that chunk is not a multiple of 16 (S = 1, 20 or 40 at chunk 64), the
card runs the chunk rounded up to 16 over a tail padded with ``dt = 0``
(:func:`card_length`, :func:`pad_tail`): a padded step decays the state
by ``exp(0 · a) = 1`` and adds ``0 · x B = 0``, so every output up to S
and the final state are the unpadded scan's; the padded outputs are
dropped.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check, route
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

_P, _I, _C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Heads per CTA of the chunk-parallel kernel, and the columns of P per CTA
#: of the pass it may take (16, 32 or 64; the widest that divides P): the
#: shipped choice (``scripts/torch_ssd_split.py`` times the others).
HEADS_PER_CTA = 4
P_TILES = (64, 32, 16)
#: Shared memory one CTA may take on an H100 (227 KB).
SMEM_LIMIT = 232_448


def _r16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def card_plan(b, s, h, p, n, q, dtype, *, heads=HEADS_PER_CTA, p_tile=None) -> dict:
    """The card path's launch plan, from shapes alone.

    The kernels take the chunk ``q``, ``p`` and ``n`` as multiples of 16
    (mma tiles), and ``p_tile`` (16, 32 or 64; by default the widest of
    ``P_TILES`` that divides ``p``) must divide ``p``; other shapes raise
    ``ValueError`` (the CPU path takes any).  Shared memory,
    ``t`` = 4 bytes for f32 and 2 for bf16, ``a`` = 4 for f32 and 8 for
    bf16, each array rounded up to 16 bytes (``csrc/ssd_scan.cu``):

    * chunk kernel: ``max(q(n+8)t + qpt + 4q(p+8) + 4 heads q, 2q(n+a)t)``;
    * pass: ``2(q(PT+8)t + q(n+a)t + 4q(q+4) + 4q) + 8PT(n+4) + 8q``;

    70,656 and 207,872 bytes at mamba2-130m's widths (q 64, p 64, n 128,
    f32, 4 heads, PT 64); more than 227 KB raises.  The scratch, allocated per
    call, holds ``C Bᵀ`` (``b (s/q) q²`` floats) and the chunk states s_c
    (``b h (s/q) p n`` floats): 2.1 MB and 100.7 MB at B = 4, S = 2,048,
    H = 24.
    """
    for name, v in (("chunk", q), ("P", p), ("N", n)):
        if v <= 0 or v % 16:
            raise ValueError(f"ssd_scan on the card takes the chunk, P and N as multiples of 16 "
                             f"(got {name} = {v})")
    if p_tile is None:
        p_tile = next(pt for pt in P_TILES if p % pt == 0)
    if p_tile not in P_TILES or p % p_tile:
        raise ValueError(f"the P tile {p_tile} must be 16, 32 or 64 and divide P = {p}")
    if heads < 1:
        raise ValueError(f"heads per CTA {heads} must be at least 1")
    t = 4 if dtype == torch.float32 else 2
    pad = 4 if t == 4 else 8
    chunk_smem = max(_r16(q * (n + 8) * t) + _r16(q * p * t) + _r16(4 * q * (p + 8)) + 4 * heads * q,
                     2 * q * (n + pad) * t)
    stage = _r16(q * (p_tile + 8) * t) + _r16(q * (n + pad) * t) + _r16(4 * q * (q + 4)) + _r16(4 * q)
    pass_smem = 2 * stage + 8 * p_tile * (n + 4) + 8 * q
    if max(chunk_smem, pass_smem) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan at chunk {q}, P {p}, N {n} needs {max(chunk_smem, pass_smem)} "
                         f"bytes of shared memory a CTA, above the card's {SMEM_LIMIT}")
    nc = s // q
    return {
        "heads": heads, "p_tile": p_tile,
        "chunk_ctas": b * nc * (math.ceil(h / heads) + 1), "pass_ctas": b * h * (p // p_tile),
        "chunk_smem": chunk_smem, "pass_smem": pass_smem,
        "cb_floats": b * nc * q * q, "sc_floats": b * h * nc * p * n,
    }


def card_length(s: int, q: int) -> tuple[int, int]:
    """``(padded length, chunk)`` the card runs for a scan of length ``s``
    at chunk ``q = min(chunk, s)``: the chunk rounded up to a multiple of
    16, the length up to a multiple of that chunk."""
    qc = -(-q // 16) * 16
    return -(-s // qc) * qc, qc


def pad_tail(x, dt, bmat, cmat, s_pad: int):
    """x, dt, bmat and cmat with zeros appended along the sequence axis up
    to ``s_pad`` steps: ``dt = 0`` there, so the padded steps leave the
    state as it was (and add no input)."""
    def pad(t):
        tail = t.new_zeros((t.shape[0], s_pad - t.shape[1], *t.shape[2:]))
        return torch.cat([t, tail], dim=1)

    return pad(x), pad(dt), pad(bmat), pad(cmat)


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
    On the card P and N must be multiples of 16 and x, bmat and cmat
    16-byte aligned (``ValueError`` otherwise; :func:`card_plan` gives
    the shared memory and the scratch); a chunk that is not a multiple of
    16 runs rounded up over a ``dt = 0`` tail (:func:`card_length`)."""
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
    if not (b and h and s):
        return (torch.empty((b, s, h, p), dtype=torch.float32, device=x.device),
                torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    s_pad, qc = card_length(s, q)
    if s_pad == s:
        out = card_call(x, dt, a, bmat, cmat, qc)
    else:
        xp, dtp, bp, cp = pad_tail(x, dt, bmat, cmat, s_pad)
        y, hf = card_call(xp, dtp, a, bp, cp, qc)
        out = y[:, :s].contiguous(), hf
    ssd_scan.launches += 1
    return out


ssd_scan.launches = 0


def card_call(x, dt, a, bmat, cmat, q, *, heads=HEADS_PER_CTA, p_tile=None):
    """Launch ``csrc/ssd_scan.cu`` on checked CUDA inputs of :func:`ssd_scan`
    (dt and a f32, chunk ``q`` dividing S) under ``card_plan``'s launch
    shape; ``heads`` and ``p_tile`` change no result.  Returns (y, h_final)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    plan = card_plan(b, s, h, p, n, q, x.dtype, heads=heads, p_tile=p_tile)
    if any(t.data_ptr() % 16 for t in (x, bmat, cmat)):
        raise ValueError("ssd_scan on the card takes x, bmat and cmat at 16-byte aligned addresses")
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    hout = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan["cb_floats"] + plan["sc_floats"], dtype=torch.float32, device=x.device)
    _build.launch(
        "ssd_scan",
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _C),
        x.device,
        _build.ptr(x), _build.ptr(dt), _build.ptr(a), _build.ptr(bmat), _build.ptr(cmat),
        _build.ptr(y), _build.ptr(hout), _build.ptr(scratch),
        b, s, h, p, n, q, heads, plan["p_tile"], _DTYPES[x.dtype],
    )
    return y, hout
