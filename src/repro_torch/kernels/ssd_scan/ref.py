"""Plain PyTorch version of the Mamba2 SSD chunked scan: the port's own
copy of the reference model layer's ``ssd_chunked``
(``repro/models/ssm.py``), which the reference's ``ssd_scan/ref.py``
imports.  Within a chunk the masked quadratic dual, across chunks the
linear state recurrence; all in float32.  The CPU path, and the
yardstick ``csrc/ssd_scan.cu`` is held against on the card."""

from __future__ import annotations

from typing import Tuple

import torch

N_GROUPS = 1  # B/C shared across heads (mamba2 default)


def ssd_chunked(
    xh: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H] (post-softplus)
    a: torch.Tensor,  # [H] (negative)
    bmat: torch.Tensor,  # [B, S, G, N]
    cmat: torch.Tensor,  # [B, S, G, N]
    chunk: int = 64,
    h0: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y [B,S,H,P], final state [B,H,P,N])."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    nc = s // q
    xc = xh.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h).float()
    bc = bmat.reshape(b, nc, q, N_GROUPS, n).float()
    cc = cmat.reshape(b, nc, q, N_GROUPS, n).float()

    da = dtc * a.float()  # [b,nc,q,h]
    da_cs = torch.cumsum(da, dim=2)
    da_sum = da_cs[:, :, -1, :]  # [b,nc,h]

    # intra-chunk (masked quadratic dual)
    diff = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]  # [b,nc,qi,qj,h]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    l_mat = torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)
    cb = torch.einsum("bcign,bcjgn->bcij", cc, bc)  # G=1 shared across heads
    y_diag = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", cb, l_mat, dtc, xc)

    # chunk states and the inter-chunk recurrence
    decay_to_end = torch.exp(da_sum[:, :, None, :] - da_cs)  # [b,nc,q,h]
    states = torch.einsum("bcjh,bcjh,bcjhp,bcjgn->bchpn", decay_to_end, dtc, xc, bc)
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device) if h0 is None else h0
    h_in = []
    for c in range(nc):
        h_in.append(hstate)  # the state entering chunk c
        hstate = hstate * torch.exp(da_sum[:, c])[:, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)  # [b,nc,h,p,n]

    y_off = torch.einsum("bcign,bchpn,bcih->bcihp", cc, h_in, torch.exp(da_cs))
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, hstate


def ssd_scan_ref(x, dt, a, bmat, cmat, *, chunk: int = 64):
    """x [B,S,H,P], dt [B,S,H], a [H], bmat/cmat [B,S,N] (G=1)."""
    return ssd_chunked(x, dt, a, bmat[:, :, None, :], cmat[:, :, None, :], chunk=chunk)
