"""Attention: GQA with RoPE and causal masks, in PyTorch (the port of
``repro.models.attention``).

The prefill path computes scores in *query chunks* so the full
``[S, S]`` score matrix is never held at once, as the reference's
``attention_chunked`` does; it is plain PyTorch there too (the reference
computes it in ``jnp``, not in a Pallas kernel).  Single-token decode
against the paged cache lives in :mod:`repro_torch.serving.engine` and
goes through the paged-attention kernel.  The reference's sharding hooks
(``constrain``, ``gather_weight``) are the identity on one device and are
dropped.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, apply_rope

NEG_INF = -1e30

__all__ = [
    "init_attention",
    "qkv_proj",
    "out_proj",
    "causal_mask",
    "attention_chunked",
    "attention_train",
]


def init_attention(b, cfg: ModelConfig, cross: bool = False) -> None:
    d, hd = cfg.d_model, cfg.hd
    b.param("wq", (d, cfg.n_heads, hd))
    b.param("wk", (d, cfg.n_kv_heads, hd))
    b.param("wv", (d, cfg.n_kv_heads, hd))
    # Fan-in n_heads, as the reference's (H, hd, d) layout gives it.
    b.param("wo", (cfg.n_heads, hd, d))
    if cfg.qkv_bias and not cross:
        b.param("bq", (cfg.n_heads, hd), init="zeros")
        b.param("bk", (cfg.n_kv_heads, hd), init="zeros")
        b.param("bv", (cfg.n_kv_heads, hd), init="zeros")


def qkv_proj(
    params: Params, x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> q [B, S, H, hd], k and v [B, S, KVH, hd]."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"].to(dt))
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return q, k, v


def out_proj(params: Params, attn_out: torch.Tensor) -> torch.Tensor:
    """[B, S, H, hd] -> [B, S, D]."""
    return torch.einsum("bshk,hkd->bsd", attn_out, params["wo"].to(attn_out.dtype))


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """GQA scores: q [B,Sq,H,hd], k [B,Sk,KVH,hd] -> [B,KVH,G,Sq,Sk]."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    return torch.einsum("bqhgk,bshk->bhgqs", qg, k) / math.sqrt(hd)


def _grouped_out(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B,KVH,G,Sq,Sk] x [B,Sk,KVH,hd] -> [B,Sq,H,hd]."""
    b, kvh, g, sq, sk = scores.shape
    out = torch.einsum("bhgqs,bshk->bqhgk", scores, v)
    return out.reshape(b, sq, kvh * g, v.shape[-1])


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int = 0) -> torch.Tensor:
    """[..., Sq, Sk] bool mask: causal, optionally sliding-window."""
    ok = q_pos[..., :, None] >= k_pos[..., None, :]
    if window:
        ok = ok & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    return ok


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    window: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention over query chunks, so
    peak memory is O(S * chunk) instead of O(S^2).  Softmax in float32,
    probabilities cast back to V's dtype, as the reference does."""
    b, sq, h, hd = q.shape
    chunk = min(chunk, sq)
    assert sq % chunk == 0, (sq, chunk)
    outs = []
    for c in range(sq // chunk):
        qi = q[:, c * chunk : (c + 1) * chunk]
        qpi = q_pos[:, c * chunk : (c + 1) * chunk]
        scores = _grouped_scores(qi, k).float()
        ok = causal_mask(qpi, k_pos, window)  # [B, chunk, Sk]
        scores = torch.where(ok[:, None, None], scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        outs.append(_grouped_out(probs, v))
    return torch.cat(outs, dim=1)


def attention_train(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    window: int = 0,
    rope: bool = True,
) -> torch.Tensor:
    """Full training/prefill self-attention over x: [B, S, D]."""
    q, k, v = qkv_proj(params, x, cfg)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = attention_chunked(q, k, v, positions, positions, window=window)
    return out_proj(params, out)
