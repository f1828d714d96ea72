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

On CUDA tensors the call is differentiable through one
``torch.autograd.Function`` whose backward launches
``csrc/ssd_scan_bwd.cu`` (:func:`ssd_scan_bwd`, chunk-parallel like the
forward, under :func:`bwd_plan`) over the same padded length: the
gradient of the final state, where one is given, starts the backward
recurrence over the chunks, and the gradients of the padded tail are
dropped.  On CPU tensors autograd differentiates the plain
version, as the reference's ``jax.grad`` differentiates ``ssd_chunked``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import check, require_aligned, route
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref

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
    return _SSDScan.apply(x, dt, a, bmat, cmat, chunk)


def _forward(x, dt, a, bmat, cmat, chunk: int):
    """The card path of :func:`ssd_scan` on checked CUDA inputs."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if not (b and h and s):
        return (torch.empty((b, s, h, p), dtype=torch.float32, device=x.device),
                torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    s_pad, qc = card_length(s, min(chunk, s))
    if s_pad == s:
        out = card_call(x, dt, a, bmat, cmat, qc)
    else:
        xp, dtp, bp, cp = pad_tail(x, dt, bmat, cmat, s_pad)
        y, hf = card_call(xp, dtp, a, bp, cp, qc)
        out = y[:, :s].contiguous(), hf
    ssd_scan.launches += 1
    return out


class _SSDScan(torch.autograd.Function):
    """The forward kernel, and the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, chunk):
        out = _forward(x, dt, a, bmat, cmat, chunk)
        ctx.save_for_backward(x, dt, a, bmat, cmat)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, dy, dh):
        grads = ssd_scan_bwd(*ctx.saved_tensors, dy, dh, chunk=ctx.chunk)
        return (*grads, None)


ssd_scan.launches = 0


def card_call(x, dt, a, bmat, cmat, q, *, heads=HEADS_PER_CTA, p_tile=None):
    """Launch ``csrc/ssd_scan.cu`` on checked CUDA inputs of :func:`ssd_scan`
    (dt and a f32, chunk ``q`` dividing S) under ``card_plan``'s launch
    shape; ``heads`` and ``p_tile`` change no result.  Returns (y, h_final)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    plan = card_plan(b, s, h, p, n, q, x.dtype, heads=heads, p_tile=p_tile)
    require_aligned("ssd_scan", x=x, bmat=bmat, cmat=cmat)
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


#: Heads per CTA of the backward's two chunk-parallel kernels (C Bᵀ is
#: formed once for them, and dB and dC summed over them in order).
BWD_HEADS_PER_CTA = 4


def bwd_plan(b, s, h, p, n, q) -> dict:
    """The backward's launch plan from shapes alone (``csrc/ssd_scan_bwd.cu``).

    Three launches: the chunk states and gradient increments, a CTA per
    (head group, chunk, batch); the two recurrences over the chunks, a
    thread per four (b, h, p, n); the gradients, a CTA per (head group,
    chunk, batch).  The chunk ``q``, ``p`` and ``n`` must be multiples of
    16 (mma tiles).  Shared memory, f32, with ``NT`` = 4 where 32 divides
    the width, else 2:

    * states: ``4 (2q(n+8) + 2q(p+8) + q)``;
    * gradients: ``4 (2q(n+4) + 3q(q+4) + 2q(p+4) + 2p(n+4) + 10q + q p/(8 NTp)
      + q n/(8 NTn) + 8)``;

    106,752 and 226,336 bytes at mamba2-130m's widths (q 64, p 64, n 128);
    more than 227 KB raises ``ValueError``.  Scratch: the chunk states,
    overwritten by each chunk's h_in, and the gradient increments,
    overwritten by each chunk's G (``b h (s/q) p n`` floats each: 100.7 MB
    apiece at [2, 4,096, 24, 64, 128]), each chunk's sum of dt a (``b h
    (s/q)``); the partial sums of dB and dC per head group (``(h/heads) b s
    n`` each) and of da per (b, chunk) (``b (s/q) h``), which one
    ``torch.sum`` each reduces."""
    for name, v in (("chunk", q), ("P", p), ("N", n)):
        if v <= 0 or v % 16:
            raise ValueError(f"ssd_scan's backward on the card takes the chunk, P and N as multiples of 16 "
                             f"(got {name} = {v})")
    heads = BWD_HEADS_PER_CTA
    nt = {w: 4 if w % 32 == 0 else 2 for w in (p, n)}
    states_smem = 4 * (2 * q * (n + 8) + 2 * q * (p + 8) + q)
    grads_smem = 4 * (2 * q * (n + 4) + 3 * q * (q + 4) + 2 * q * (p + 4) + 2 * p * (n + 4) + 10 * q
                      + q * p // (8 * nt[p]) + q * n // (8 * nt[n]) + 8)
    if max(states_smem, grads_smem) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan's backward at chunk {q}, P {p}, N {n} needs {max(states_smem, grads_smem)} "
                         f"bytes of shared memory a CTA, above the card's {SMEM_LIMIT}")
    nc, groups = s // q, math.ceil(h / heads)
    return {"heads": heads, "groups": groups,
            "states_ctas": b * nc * groups, "recur_threads": b * h * p * n // 4, "grads_ctas": b * nc * groups,
            "states_smem": states_smem, "grads_smem": grads_smem,
            "state_floats": b * h * nc * p * n, "tot_floats": b * h * nc,
            "part_floats": groups * b * s * n, "da_floats": b * nc * h}


def ssd_scan_bwd(x, dt, a, bmat, cmat, dy, dh=None, *, chunk: int = 64):
    """The gradient of :func:`ssd_scan` for ``dy`` [B,S,H,P] (the output's
    gradient) and ``dh`` [B,H,P,N] (the final state's, or None):
    ``(dx, ddt, da, dbmat, dcmat)``, dx, dbmat and dcmat in the inputs'
    dtype, ddt and da f32.  CUDA tensors launch ``csrc/ssd_scan_bwd.cu``
    (three launches under :func:`bwd_plan`, counted as one call, over the
    length the forward ran: a chunk that is no multiple of 16 over a
    ``dt = 0`` tail whose gradients are dropped; bf16 inputs are widened
    to f32 first); x, bmat, cmat, dy and dh must then sit at 16-byte
    aligned addresses, as the forward's inputs (``ValueError`` otherwise);
    the partial sums of dB and dC per head group and of da per (b, chunk)
    are reduced by one ``torch.sum`` each, in a fixed order.  CPU tensors
    run :func:`ssd_scan_bwd_ref`."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    check(bmat, "bmat", x.dtype, (b, s, n))
    check(cmat, "cmat", x.dtype, (b, s, n))
    if dy.shape != x.shape or (dh is not None and dh.shape != (b, h, p, n)):
        raise ValueError(f"dy {tuple(dy.shape)} / dh must be y's and the final state's shapes")
    q = min(chunk, s)
    if q and s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    tensors = (x, dt, a, bmat, cmat, dy) + (() if dh is None else (dh,))
    if route(*tensors) == "cpu":
        return ssd_scan_bwd_ref(x, dt, a, bmat, cmat, dy, dh, chunk=chunk)
    dev = x.device
    if not (b and h and s):
        return (torch.zeros_like(x), torch.zeros((b, s, h), device=dev), torch.zeros((h,), device=dev),
                torch.zeros_like(bmat), torch.zeros_like(cmat))
    s_pad, qc = card_length(s, q)
    card_plan(b, s_pad, h, p, n, qc, torch.float32)  # the forward's limits
    plan = bwd_plan(b, s_pad, h, p, n, qc)
    xf, dtf, bf, cf = (t.float().contiguous() for t in (x, dt, bmat, cmat))
    dyf = dy.float().contiguous()
    if s_pad != s:
        xf, dtf, bf, cf = pad_tail(xf, dtf, bf, cf, s_pad)
        dyf = torch.cat([dyf, dyf.new_zeros((b, s_pad - s, h, p))], dim=1)
    af = a.float().contiguous()
    dhf = None if dh is None else dh.float().contiguous()
    require_aligned("ssd_scan_bwd", x=xf, bmat=bf, cmat=cf, dy=dyf, dh=dhf)
    nc = s_pad // qc
    dx = torch.empty_like(xf)
    ddt = torch.empty((b, s_pad, h), dtype=torch.float32, device=dev)
    da = torch.empty((b, nc, h), dtype=torch.float32, device=dev)
    db = torch.empty((plan["groups"], b, s_pad, n), dtype=torch.float32, device=dev)
    dc = torch.empty_like(db)
    st = torch.empty(plan["state_floats"], dtype=torch.float32, device=dev)
    ug = torch.empty_like(st)
    tot = torch.empty(plan["tot_floats"], dtype=torch.float32, device=dev)
    _build.launch(
        "ssd_scan_bwd",
        (_P,) * 15 + (_I,) * 7,
        dev,
        *(_build.ptr(t) for t in (xf, dtf, af, bf, cf, dyf)),
        ctypes.c_void_p(None if dhf is None else dhf.data_ptr()),
        *(_build.ptr(t) for t in (dx, ddt, da, db, dc, st, ug, tot)),
        b, s_pad, h, p, n, qc, plan["heads"],
    )
    ssd_scan_bwd.launches += 1
    return (dx[:, :s].to(x.dtype), ddt[:, :s], da.sum((0, 1)),
            db.sum(0)[:, :s].to(bmat.dtype), dc.sum(0)[:, :s].to(cmat.dtype))


ssd_scan_bwd.launches = 0
