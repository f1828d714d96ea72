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
