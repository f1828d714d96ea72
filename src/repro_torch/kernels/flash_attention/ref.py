"""Plain PyTorch version of causal flash attention: the naive masked
softmax of the reference's ``flash_attention/ref.py`` (causal, optional
sliding window, GQA), computed in float32 and returned in q's dtype.
The CPU path, and the yardstick ``csrc/flash_attention.cu`` is held
against on the card."""

from __future__ import annotations

import math

import torch


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Sq, d]
    k: torch.Tensor,  # [B, KVH, Sk, d]
    v: torch.Tensor,
    *,
    scale: float | None = None,
    window: int = 0,
) -> torch.Tensor:
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    g = h // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kvh, g, sq, d).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = q_pos >= k_pos
    if window > 0:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return out.reshape(b, h, sq, d).to(q.dtype)


def flash_attention_bwd_ref(
    q: torch.Tensor,  # [B, Sq, H, d]
    k: torch.Tensor,  # [B, Sk, KVH, d]
    v: torch.Tensor,
    dout: torch.Tensor,  # [B, Sq, H, d]
    *,
    scale: float | None = None,
    window: int = 0,
):
    """The gradient of :func:`flash_attention_ref` in the model layout
    ``[B, S, heads, d]``: autograd of the plain forward, ``(dq, dk, dv)``
    in the inputs' dtypes.  The yardstick ``csrc/flash_attention_bwd.cu``
    is held against on the card; the CPU path differentiates the plain
    forward itself."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        qt, kt, vt = (t.transpose(1, 2) for t in leaves)
        out = flash_attention_ref(qt, kt, vt, scale=scale, window=window).transpose(1, 2)
        return torch.autograd.grad(out, leaves, dout)
