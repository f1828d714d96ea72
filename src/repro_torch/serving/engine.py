"""Batched decode engine over the COW-paged KV cache, in PyTorch (the
port of ``repro.serving.engine``).

Per decode step it resolves one writable block per sequence (the COW
GET), then every layer projects K/V for the new token, writes them into
that block, and attends through the block table with the paged-attention
kernel (``csrc/paged_attention.cu`` on the card, its plain version on the
CPU).  Under ``KVCacheConfig(delta_cow=True)`` the attention resolves
delta pages through the pool's ``parent``/``dirty`` leaves in place.

``prefill`` runs the training forward over the prompts and bulk-writes
their K/V pages, after which ``fork`` replicates a prompt across a
population for O(1).  Runs are eager: the reference's ``jit`` and layer
``scan`` become a Python loop over the stacked layer weights.  Only the
``dense`` family is ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import pool as pool_lib
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, embed, mlp, rms_norm, torch_dtype, unembed
from repro_torch.models.model import LanguageModel, layer_params
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.kv_cache import KVCacheConfig, PagedKVCache

SUPPORTED_FAMILIES = ("dense",)
# Families the reference serves from the paged cache, and where their port
# is queued (ROADMAP.md queue 1).
UNPORTED_FAMILIES = {"moe": "item 6 (models/moe.py)", "audio": "item 6 (the audio configs)"}


def cast_matrices(params: Params, dtype: torch.dtype, device: torch.device) -> Params:
    """The parameter tree on ``device`` with the layer matrices cast once
    to ``dtype`` (every use casts them to the activation dtype anyway);
    the embedding table and the norm scales stay in their own (float32)
    type, as the reference's f32 unembedding and norms need."""

    def walk(tree: Params, in_blocks: bool) -> Params:
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = walk(leaf, in_blocks or name == "blocks")
            elif in_blocks and name != "scale":
                out[name] = leaf.to(device=device, dtype=dtype)
            else:
                out[name] = leaf.to(device)
        return out

    return walk(params, False)


class ServeEngine:
    """The engine over a pool sized by the caller: ``cache_cfg`` has no
    default, since the automatic pool size is the forked-population bound
    and independent prompts can exhaust it (sticky ``oom``, dropped writes)."""

    def __init__(
        self,
        lm: LanguageModel,
        params: Params,
        cache_cfg: KVCacheConfig,
        *,
        device: torch.device | str = "cuda",
    ):
        cfg = lm.cfg
        if cfg.family in UNPORTED_FAMILIES:
            raise NotImplementedError(
                f"paged serving for family {cfg.family!r} is not ported yet "
                f"(ROADMAP.md queue 1, {UNPORTED_FAMILIES[cfg.family]})"
            )
        if cfg.family not in SUPPORTED_FAMILIES:
            raise NotImplementedError(
                f"paged serving for family {cfg.family!r} uses the dense-cache "
                f"decode path; paged support covers {SUPPORTED_FAMILIES}"
            )
        self.device = resolve_device(device)
        self.lm = lm
        self.params = cast_matrices(params, torch_dtype(cfg.dtype), self.device)
        self.cache_cfg = cache_cfg
        self.cache = kvc.create(cache_cfg, device=self.device)

    # -- stateful convenience wrappers -----------------------------------
    def prefill(self, tokens: torch.Tensor, seq_ids: torch.Tensor) -> torch.Tensor:
        logits, self.cache = _prefill(
            self.lm.cfg, self.cache_cfg, self.params, self.cache, tokens, seq_ids
        )
        return logits

    def decode(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is None:
            mask = self.cache.lengths > 0
        logits, self.cache = _decode_step(
            self.lm.cfg, self.cache_cfg, self.params, self.cache, tokens, mask
        )
        return logits

    def fork(self, ancestors: torch.Tensor) -> None:
        self.cache = kvc.fork(self.cache, ancestors)

    def free(self, mask: torch.Tensor) -> None:
        self.cache = kvc.free(self.cache, mask)

    # -- slot-range ops (the scheduler's packed slot table) ---------------
    def fork_slots(self, lo: int, ancestors_local: torch.Tensor) -> None:
        """Fork within the slot range ``[lo, lo + len(ancestors_local))``;
        the identity elsewhere, so other sequences are untouched."""
        n = ancestors_local.shape[0]
        anc = torch.arange(self.cache_cfg.max_seqs, dtype=torch.int32, device=self.device)
        anc[lo : lo + n] = lo + ancestors_local.to(torch.int32)
        self.cache = kvc.fork(self.cache, anc)

    def free_slots(self, lo: int, n: int) -> None:
        """Release the sequences in slot range ``[lo, lo + n)``."""
        mask = torch.zeros(self.cache_cfg.max_seqs, dtype=torch.bool, device=self.device)
        mask[lo : lo + n] = True
        self.cache = kvc.free(self.cache, mask)

    def compact_cache(self, new_num_blocks: int | None = None) -> None:
        """Densify live pages (optionally shrink-to-fit) between decode
        steps; invisible to attention, which reads through the tables."""
        self.cache = kvc.compact(self.cache, new_num_blocks)

    def grow_cache(self, new_num_blocks: int) -> None:
        """Expand the KV page pool between decode steps (ids preserved)."""
        self.cache = kvc.grow(self.cache, new_num_blocks)

    @property
    def used_blocks(self) -> int:
        return int(kvc.used_blocks(self.cache))

    @property
    def free_blocks(self) -> int:
        return int(kvc.free_blocks(self.cache))

    @property
    def oom(self) -> bool:
        return bool(kvc.oom_flag(self.cache))

    @property
    def num_blocks(self) -> int:
        return self.cache.pool.num_blocks


# ---------------------------------------------------------------------------
# functional core
# ---------------------------------------------------------------------------


def _attn_block(
    cfg: ModelConfig,
    ccfg: KVCacheConfig,
    p: Params,
    h: torch.Tensor,
    cache: PagedKVCache,
    bid: torch.Tensor,
    pos: torch.Tensor,
    layer: int,
    mask: torch.Tensor,
    lengths_incl: torch.Tensor,
):
    """One attention sub-block in paged-decode mode. h: [S, 1, D]."""
    hn = rms_norm(h, p["ln1"]["scale"], cfg.norm_eps)
    q, k_new, v_new = attn_lib.qkv_proj(p["attn"], hn, cfg)
    position = cache.lengths  # pre-append position of the new token
    q = attn_lib.apply_rope(q, position[:, None], cfg.rope_theta)
    k_new = attn_lib.apply_rope(k_new, position[:, None], cfg.rope_theta)
    cache = kvc.write_kv(ccfg, cache, bid, pos, layer, k_new[:, 0], v_new[:, 0], mask)
    k_pool, v_pool = kvc.layer_views(cache, layer)
    delta = (
        dict(parent=cache.pool.parent, dirty=cache.pool.dirty) if ccfg.delta_cow else {}
    )
    out = paged_attention(
        q[:, 0].contiguous(), k_pool, v_pool, cache.tables, lengths_incl, **delta
    )
    h = h + attn_lib.out_proj(p["attn"], out[:, None])
    return h, cache


def _decode_step(
    cfg: ModelConfig,
    ccfg: KVCacheConfig,
    params: Params,
    cache: PagedKVCache,
    tokens: torch.Tensor,  # [S, 1]
    mask: torch.Tensor,  # [S] bool
):
    x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))  # [S, 1, D]
    cache, bid, pos = kvc.ensure_writable(ccfg, cache, mask)
    lengths_incl = cache.lengths + mask.to(torch.int32)  # include the new token
    for layer in range(cfg.n_layers):
        p = layer_params(params["blocks"], layer)
        x, cache = _attn_block(cfg, ccfg, p, x, cache, bid, pos, layer, mask, lengths_incl)
        x = x + mlp(p["mlp"], rms_norm(x, p["ln2"]["scale"], cfg.norm_eps), cfg.act)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(params.get("unembed", params["embed"]), x)[:, 0]
    return logits, kvc.advance(cache, mask)


def _prefill(
    cfg: ModelConfig,
    ccfg: KVCacheConfig,
    params: Params,
    cache: PagedKVCache,
    tokens: torch.Tensor,  # [B, S] (S % block_size == 0 is not required)
    seq_ids: torch.Tensor,  # [B] slots to fill
):
    """Run the training forward and bulk-write K/V pages for the prompt."""
    b, s = tokens.shape
    bs = ccfg.block_size
    nb = -(-s // bs)
    pad = nb * bs - s
    dev = tokens.device
    x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    k_all, v_all = [], []
    for layer in range(cfg.n_layers):
        p = layer_params(params["blocks"], layer)
        hn = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        _, k_new, v_new = attn_lib.qkv_proj(p["attn"], hn, cfg)
        k_all.append(attn_lib.apply_rope(k_new, positions, cfg.rope_theta))
        v_all.append(v_new)
        x = x + attn_lib.attention_train(p["attn"], hn, cfg, positions)
        x = x + mlp(p["mlp"], rms_norm(x, p["ln2"]["scale"], cfg.norm_eps), cfg.act)
    # Only the last position's logits are returned: unembed it alone.
    x = rms_norm(x[:, -1:], params["final_norm"]["scale"], cfg.norm_eps)
    logits = unembed(params.get("unembed", params["embed"]), x)[:, -1]

    # Allocate nb pages per prompt and write them (in place).
    pool, tables, lengths = cache.pool, cache.tables.clone(), cache.lengths.clone()
    sid = seq_ids.long()
    for j in range(nb):
        pool, bids = pool_lib.alloc(pool, b)
        tables[sid, j] = bids

    def pages(arrs):  # L x [B, S, KVH, hd] -> [B * nb, L, bs, KVH, hd]
        arr = torch.stack(arrs)
        arr = torch.nn.functional.pad(arr, (0, 0, 0, 0, 0, pad))
        arr = arr.reshape(cfg.n_layers, b, nb, bs, cfg.n_kv_heads, cfg.hd)
        return arr.permute(1, 2, 0, 3, 4, 5).reshape(b * nb, cfg.n_layers, bs, cfg.n_kv_heads, cfg.hd)

    page_bids = tables[sid, :nb].reshape(-1).long()  # NULL wraps to the dump row
    pool.data[page_bids, :, 0] = pages(k_all).to(pool.data.dtype)
    pool.data[page_bids, :, 1] = pages(v_all).to(pool.data.dtype)
    lengths[sid] = s
    return logits, PagedKVCache(pool=pool, tables=tables, lengths=lengths)
