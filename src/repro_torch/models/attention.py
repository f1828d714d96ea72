"""Attention: GQA with RoPE, causal and sliding-window masks,
cross-attention and single-token decode against a dense cache, in
PyTorch (the port of ``repro.models.attention``).

The training/prefill path (:func:`attention_train`) goes, on CUDA
tensors, through the registry's ``flash_attention`` (``csrc/
flash_attention.cu``), the kernel the reference names as its drop-in
replacement on the accelerator; on CPU tensors through
:func:`attention_chunked`, the reference's oracle, which computes scores
in *query chunks* so the full ``[S, S]`` score matrix is never held at
once.  :func:`cross_attention` and :func:`attention_decode` are plain
PyTorch on both, as the reference computes them outside any kernel.
Single-token decode against the paged cache lives in
:mod:`repro_torch.serving.engine` and goes through the paged-attention
kernel.  The reference's sharding hooks (``constrain``,
``gather_weight``) are the identity on one device and are dropped.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
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
    "cross_attention",
    "attention_decode",
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
    window: int = 0,
    rope: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full training/prefill self-attention over x: [B, S, D] at positions
    ``0..S-1`` in every row.  Returns the output [B, S, D] and the layer's
    K (rotated) and V [B, S, KVH, hd], the entries a decode cache holds
    (the reference returns the output alone and takes the positions as an
    argument; every caller of it passes ``0..S-1``).  The positions are
    fixed because on CUDA tensors the kernel applies the causal (and
    window) mask by index (``csrc/flash_attention.cu``); on CPU tensors
    ``attention_chunked`` masks by the same positions."""
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    q, k, v = qkv_proj(params, x, cfg)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if x.is_cuda:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=window)
    else:
        out = attention_chunked(q, k, v, positions, positions, window=window)
    return out_proj(params, out), k, v


def cross_attention(
    params: Params, x: torch.Tensor, kv_feats: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    """Non-causal attention of x [B, S, D] to precomputed features
    [B, n, D] (the VLM's image tokens)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", kv_feats, params["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", kv_feats, params["wv"].to(dt))
    probs = torch.softmax(_grouped_scores(q, k).float(), dim=-1).to(dt)
    return out_proj(params, _grouped_out(probs, v))


def attention_decode(
    params: Params,
    x: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    position: torch.Tensor,
    cfg: ModelConfig,
    window: int = 0,
    rope: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: x [B, 1, D] at ``position`` [B] against a dense
    cache [B, S, KVH, hd] whose entries below ``position`` are written.

    Returns (attention output [B, 1, D], new k entry, new v entry); the
    caller writes the entries into its cache.  The cache's scores and the
    new token's score against itself combine by a two-part softmax (their
    max and sums), as the reference does."""
    q, k_new, v_new = qkv_proj(params, x, cfg)
    if rope:
        pos = position[:, None]  # [B, 1]
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
    b, g = q.shape[0], cfg.n_heads // cfg.n_kv_heads
    k_pos = torch.arange(k_cache.shape[1], dtype=torch.int32, device=x.device)[None, :]
    scores = _grouped_scores(q, k_cache).float()  # [B, KVH, G, 1, S]
    ok = k_pos < position[:, None]  # written entries only
    if window > 0:
        ok = ok & (position[:, None] - k_pos < window)
    scores = torch.where(ok[:, None, None, None, :], scores, NEG_INF)
    self_score = torch.einsum(
        "bqhgk,bshk->bhgqs", q.reshape(b, 1, cfg.n_kv_heads, g, cfg.hd), k_new
    ).float() / math.sqrt(cfg.hd)  # [B, KVH, G, 1, 1]
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), self_score)
    p_cache = torch.exp(scores - m)
    p_self = torch.exp(self_score - m)
    denom = p_cache.sum(dim=-1, keepdim=True) + p_self
    out_cache = _grouped_out((p_cache / denom).to(x.dtype), v_cache)
    w_self = (p_self / denom).reshape(b, 1, cfg.n_heads, 1).to(x.dtype)
    v_rep = v_new.reshape(b, 1, cfg.n_kv_heads, 1, cfg.hd).expand(b, 1, cfg.n_kv_heads, g, cfg.hd)
    out = out_cache + w_self * v_rep.reshape(b, 1, cfg.n_heads, cfg.hd)
    return out_proj(params, out), k_new, v_new
