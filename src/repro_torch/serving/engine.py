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
``scan`` become a Python loop over the stacked layer weights.  The
families are the reference's paged ones: ``dense``, ``audio`` and
``moe`` (deepseek's dense layer 0 included).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import pool as pool_lib
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import attention as attn_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, embed, rms_norm, torch_dtype, unembed
from repro_torch.models.model import LanguageModel, feed_forward, iter_layers
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.kv_cache import KVCacheConfig, PagedKVCache

SUPPORTED_FAMILIES = ("dense", "audio", "moe")


#: Leaves the reference reads in float32 whatever the activation dtype:
#: the norm scales (``rms_norm`` takes its scale in f32; the SSM's
#: ``norm_scale`` too), the MoE router (a cast router would route
#: otherwise), and the SSM's ``a_log``, ``dt_bias`` and ``d_skip``
#: (``repro/models/ssm.py`` casts each to f32 where it reads it).
F32_LEAVES = ("scale", "norm_scale", "router", "a_log", "dt_bias", "d_skip")


def is_cast_leaf(path: str) -> bool:
    """Whether the leaf at ``path`` (``"blocks/attn/wq"``) is one of the
    layer matrices cast once to the activation dtype: every leaf of
    ``blocks``, ``block0`` and hybrid's ``shared_attn`` (whose matrices
    every invocation would cast again) but the :data:`F32_LEAVES`."""
    parts = path.split("/")
    return parts[0] in ("blocks", "block0", "shared_attn") and parts[-1] not in F32_LEAVES


def cast_matrices(params: Params, dtype: torch.dtype, device: torch.device) -> Params:
    """The parameter tree on ``device`` with the layer matrices
    (:func:`is_cast_leaf`) cast once to ``dtype`` (every use casts them to
    the activation dtype anyway); the embedding table, the norm scales and
    the router stay in their own (float32) type, as the reference's f32
    unembedding, norms and routing need."""

    def walk(tree: Params, prefix: str) -> Params:
        out = {}
        for name, leaf in tree.items():
            path = prefix + name
            if isinstance(leaf, dict):
                out[name] = walk(leaf, path + "/")
            elif is_cast_leaf(path):
                out[name] = leaf.to(device=device, dtype=dtype)
            else:
                out[name] = leaf.to(device)
        return out

    return walk(params, "")


def draw_cast_params(
    lm: LanguageModel, generator: torch.Generator, *, device: torch.device | str = "cuda"
) -> Params:
    """``cast_matrices(lm.init(generator), activation dtype)``, bit for
    bit, drawn leaf by leaf on ``device`` with each layer matrix cast as
    soon as it is drawn: the peak is the cast tree plus one float32 leaf,
    not both whole trees (deepseek-moe-16b: ~33 GB and its 19.9 GB expert
    leaf, against ~98 GB)."""
    dtype = torch_dtype(lm.cfg.dtype)
    return lm.init(
        generator, device=device,
        finish=lambda path, value: value.to(dtype) if is_cast_leaf(path) else value,
    )


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
    for layer, p in enumerate(iter_layers(params, cfg)):
        x, cache = _attn_block(cfg, ccfg, p, x, cache, bid, pos, layer, mask, lengths_incl)
        x = x + feed_forward(p, rms_norm(x, p["ln2"]["scale"], cfg.norm_eps), cfg)
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
    """Run the training forward and bulk-write K/V pages for the prompt
    (positions ``0..S-1``: on the card the forward's attention is the
    flash kernel)."""
    b, s = tokens.shape
    bs = ccfg.block_size
    nb = -(-s // bs)
    pad = nb * bs - s
    dev = tokens.device
    x = embed(params["embed"], tokens, torch_dtype(cfg.dtype))
    k_all, v_all = [], []
    for p in iter_layers(params, cfg):
        hn = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
        out, k_new, v_new = attn_lib.attention_train(p["attn"], hn, cfg)
        k_all.append(k_new)
        v_all.append(v_new)
        x = x + out
        x = x + feed_forward(p, rms_norm(x, p["ln2"]["scale"], cfg.norm_eps), cfg)
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
