"""Mixture-of-experts layer, in PyTorch (the port of ``repro.models.moe``):
shared + routed experts with top-k routing and fixed-capacity dispatch.

Covers deepseek-moe (2 shared + 64 routed, top-6, fine-grained experts)
and phi3.5-moe (16 routed, top-2).  Dispatch is the Switch-style
capacity scheme: each expert takes at most
``capacity = int(tokens * top_k / n_experts * capacity_factor) + 1``
tokens, rounded up to a multiple of 8 (at least 8); a (token, expert)
pair past that, in row-major (token, k) order, is dropped (its combine
weight is 0).  So a token's output depends on the tokens before it in
the batch: under capacity the rows of one decode step are coupled.

The router's logits are taken in float32 from the router's float32
weights, as the reference takes them; the expert products are plain
batched matrix products on ``[E, cap, D]`` (the reference's ``einsum``,
outside any Pallas kernel).  The reference's sharding hooks sit where
it has them: the expert weights gathered to their expert-parallel
layout, the dispatch buffer constrained to it; both are the identity
outside ``activation_sharding``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.distributed.sharding import bmm, constrain, gather_weight, matmul
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, act_fn

__all__ = ["Routing", "moe_capacity", "init_moe", "route", "moe_layer"]


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    # round to a lane-friendly multiple
    return max(8, (cap + 7) // 8 * 8)


def init_moe(b, cfg: ModelConfig) -> None:
    d = cfg.d_model
    e_ff = cfg.expert_d_ff or cfg.d_ff
    b.param("router", (d, cfg.n_experts), ("embed", "experts"))
    s = b.scope("experts")
    s.param("w_gate", (cfg.n_experts, d, e_ff), ("experts", "embed", "expert_mlp"))
    s.param("w_up", (cfg.n_experts, d, e_ff), ("experts", "embed", "expert_mlp"))
    s.param("w_down", (cfg.n_experts, e_ff, d), ("experts", "expert_mlp", "embed"))
    if cfg.n_shared_experts:
        sh = b.scope("shared")
        sh_ff = e_ff * cfg.n_shared_experts
        sh.param("w_gate", (d, sh_ff), ("embed", "mlp"))
        sh.param("w_up", (d, sh_ff), ("embed", "mlp"))
        sh.param("w_down", (sh_ff, d), ("mlp", "embed"))


class Routing(NamedTuple):
    """One routing pass over ``T`` tokens: ``gates`` [T, E] (softmax of the
    float32 logits), ``top_w`` [T, k] (renormalised, 0 where dropped),
    ``top_e`` [T, k] expert ids, ``pos`` [T, k] each pair's place in its
    expert's queue, ``keep`` [T, k] whether it fits the capacity ``cap``."""

    gates: torch.Tensor
    top_w: torch.Tensor
    top_e: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int


def route(router: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig) -> Routing:
    """Top-k routing with capacity positions for tokens [T, D]."""
    n_tok = tokens.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(cfg, n_tok)
    logits = matmul(tokens.float(), router.float())
    gates = torch.softmax(logits, dim=-1)  # [T, E]
    top_w, top_e = torch.topk(gates, k, dim=-1)  # [T, k], descending
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    # Each (token, k) pair's place in its expert's queue: an integer cumsum
    # over the flat [T * k, E] one-hot, exclusive.
    onehot = torch.nn.functional.one_hot(top_e, e).to(torch.int32)  # [T, k, E]
    flat = onehot.reshape(n_tok * k, e)
    before = (torch.cumsum(flat, dim=0, dtype=torch.int32) - flat).reshape(n_tok, k, e)
    pos = (before * onehot).sum(dim=-1, dtype=torch.int32)  # [T, k]
    keep = pos < cap
    top_w = torch.where(keep, top_w, 0.0)
    return Routing(gates, top_w, top_e, pos, keep, cap)


def dispatch(tokens: torch.Tensor, r: Routing, n_experts: int) -> tuple:
    """Scatter tokens [T, D] into ``[E, cap, D]`` by ``r``; a dropped pair
    goes to a spare row ``E`` that is sliced off.  Returns the buffer and
    the flat (expert, slot) of every pair."""
    n_tok, d = tokens.shape
    k = r.top_e.shape[1]
    eid = torch.where(r.keep, r.top_e, n_experts).reshape(-1)
    slot = torch.where(r.keep, r.pos, 0).reshape(-1).long()
    buf = tokens.new_zeros((n_experts + 1, r.cap, d))
    buf[eid, slot] = tokens[:, None, :].expand(n_tok, k, d).reshape(-1, d)
    return buf[:n_experts], eid, slot


def _routed_tokens(router, we_gate, we_up, we_down, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Route + dispatch + expert compute + combine for tokens [T, D]."""
    n_tok, d = tokens.shape
    e, k = cfg.n_experts, cfg.top_k
    r = route(router, tokens, cfg)
    dispatched, eid, slot = dispatch(tokens, r, e)  # [E, cap, D]
    dispatched = constrain(dispatched, ("act_experts", None, None))
    act = act_fn(cfg.act)
    gate = act(bmm(dispatched, we_gate))
    up = bmm(dispatched, we_up)
    expert_out = bmm(gate * up, we_down)  # [E, cap, D]
    gathered = expert_out[eid.clamp(max=e - 1), slot].reshape(n_tok, k, d)
    return (gathered * r.top_w[..., None].to(tokens.dtype)).sum(dim=1)


def moe_layer(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D].

    When the token count exceeds ``cfg.moe_route_chunk`` and divides by
    it, routing runs chunk by chunk (the reference's ``lax.scan``): the
    dispatch intermediates and capacities are per chunk."""
    b, s, d = x.shape
    dt = x.dtype
    tokens = x.reshape(b * s, d)
    n_tok = b * s
    experts = params["experts"]
    we = [gather_weight(experts[name].to(dt), ("act_experts", None, None))
          for name in ("w_gate", "w_up", "w_down")]
    chunk = cfg.moe_route_chunk
    if chunk and n_tok > chunk and n_tok % chunk == 0:
        combined = torch.cat([
            _routed_tokens(params["router"], *we, tc, cfg) for tc in tokens.split(chunk)
        ])
    else:
        combined = _routed_tokens(params["router"], *we, tokens, cfg)
    if "shared" in params:
        act = act_fn(cfg.act)
        sp = params["shared"]
        g = act(matmul(tokens, sp["w_gate"].to(dt))) * matmul(tokens, sp["w_up"].to(dt))
        combined = combined + matmul(g, sp["w_down"].to(dt))
    return combined.reshape(b, s, d)
