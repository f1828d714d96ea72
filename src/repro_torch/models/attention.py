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
``gather_weight``, the train-mode repeat of KV heads that do not divide
the model axis) sit where the reference has them; outside
``activation_sharding`` they are the identity.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.distributed.sharding import constrain, einsum, gather_weight, sharding_mode, tp_size
from repro_torch.kernels.dispatch import route
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, apply_rope

NEG_INF = -1e30
KV_AXES = ("act_batch", "act_kv_seq", "act_kv_heads", None)

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
    b.param("wq", (d, cfg.n_heads, hd), ("embed", "heads", "head_dim"))
    b.param("wk", (d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"))
    b.param("wv", (d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"))
    # Fan-in n_heads, as the reference's (H, hd, d) layout gives it.
    b.param("wo", (cfg.n_heads, hd, d), ("heads", "head_dim", "embed"))
    if cfg.qkv_bias and not cross:
        b.param("bq", (cfg.n_heads, hd), ("heads", "head_dim"), init="zeros")
        b.param("bk", (cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
        b.param("bv", (cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")


def qkv_proj(
    params: Params, x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> q [B, S, H, hd], k and v [B, S, KVH, hd]."""
    dt = x.dtype
    wq = gather_weight(params["wq"].to(dt), (None, "act_heads", "act_head_dim"))
    wk = gather_weight(params["wk"].to(dt), (None, "act_kv_heads", "act_head_dim"))
    wv = gather_weight(params["wv"].to(dt), (None, "act_kv_heads", "act_head_dim"))
    q = einsum("bsd,dhk->bshk", x, wq)
    k = einsum("bsd,dhk->bshk", x, wk)
    v = einsum("bsd,dhk->bshk", x, wv)
    if "bq" in params:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return q, k, v


def out_proj(params: Params, attn_out: torch.Tensor) -> torch.Tensor:
    """[B, S, H, hd] -> [B, S, D]."""
    wo = gather_weight(params["wo"].to(attn_out.dtype), ("act_heads", "act_head_dim", None))
    return einsum("bshk,hkd->bsd", attn_out, wo)


def _group(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """q [B,Sq,H,hd] -> [B,Sq,KVH,G,hd].  A DTensor q whose heads are
    sharded over more pieces than the KV heads divide into is gathered on
    those mesh dimensions first (a GQA group cannot straddle ranks)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    b, sq, h, hd = q.shape
    if isinstance(q, DTensor):
        pl = tuple(Replicate() if p == Shard(2) and kvh % q.device_mesh.size(i) else p
                   for i, p in enumerate(q.placements))
        if pl != tuple(q.placements):
            q = q.redistribute(q.device_mesh, pl)
    return q.reshape(b, sq, kvh, h // kvh, hd)


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """GQA scores: q [B,Sq,H,hd], k [B,Sk,KVH,hd] -> [B,KVH,G,Sq,Sk]."""
    qg = _group(q, k.shape[2])
    return einsum("bqhgk,bshk->bhgqs", qg, k) / math.sqrt(q.shape[-1])


def _grouped_out(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B,KVH,G,Sq,Sk] x [B,Sk,KVH,hd] -> [B,Sq,H,hd]."""
    b, kvh, g, sq, sk = scores.shape
    out = einsum("bhgqs,bshk->bqhgk", scores, v)
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


def layout_kv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's layout of a training attention's q, k, v over the
    mesh (``attention.py:116-135`` of the JAX package): in train mode,
    KV heads that do not divide the model axis while the query heads do
    are repeated to the full head count, so every attention tensor is
    head-sharded; otherwise K and V take ``KV_AXES`` (heads, or the
    sequence when the heads do not divide).  The identity outside
    ``activation_sharding``."""
    tp = tp_size()
    h, kvh = q.shape[2], k.shape[2]
    if tp > 1 and sharding_mode() == "train" and h % tp == 0 and kvh % tp != 0:
        g = h // kvh
        names = ("act_batch", None, "act_heads", None)
        k = constrain(k.repeat_interleave(g, dim=2), names)
        v = constrain(v.repeat_interleave(g, dim=2), names)
        return constrain(q, names), k, v
    return q, constrain(k, KV_AXES), constrain(v, KV_AXES)


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
    qa, ka, va = layout_kv(q, k, v)
    if route(x) == "cuda":
        out = flash_attention(qa.contiguous(), ka.contiguous(), va.contiguous(), window=window)
    else:
        out = attention_chunked(qa, ka, va, positions, positions, window=window)
    return out_proj(params, out), k, v


def cross_attention(
    params: Params, x: torch.Tensor, kv_feats: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    """Non-causal attention of x [B, S, D] to precomputed features
    [B, n, D] (the VLM's image tokens)."""
    dt = x.dtype
    q = einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = einsum("bsd,dhk->bshk", kv_feats, params["wk"].to(dt))
    v = einsum("bsd,dhk->bshk", kv_feats, params["wv"].to(dt))
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
    k_cache = constrain(k_cache, KV_AXES)
    v_cache = constrain(v_cache, KV_AXES)
    b, g = q.shape[0], cfg.n_heads // cfg.n_kv_heads
    k_pos = torch.arange(k_cache.shape[1], dtype=torch.int32, device=x.device)[None, :]
    scores = _grouped_scores(q, k_cache).float()  # [B, KVH, G, 1, S]
    ok = k_pos < position[:, None]  # written entries only
    if window > 0:
        ok = ok & (position[:, None] - k_pos < window)
    scores = torch.where(ok[:, None, None, None, :], scores, NEG_INF)
    self_score = einsum(
        "bqhgk,bshk->bhgqs", _group(q, cfg.n_kv_heads), k_new
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
