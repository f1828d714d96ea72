"""Paged, copy-on-write KV cache on the lazy-copy block pool, in PyTorch
(the port of ``repro.serving.kv_cache``).

The paper's platform applied to serving: sequences are the particles,
tokens the generations, the KV cache the payload.

  * a **block** holds ``block_size`` token positions across *all* layers
    (pool payload ``[L, 2, bs, KVH, hd]``), so one refcount governs one
    page of context;
  * ``fork`` is a table gather plus a refcount delta: no payload moves;
  * appending a token first resolves a writable tail block
    (:func:`ensure_writable`): a fresh block at page boundaries, a COW
    copy if the tail is shared, in place otherwise; every layer then
    writes its K/V slice into that block (:func:`write_kv`).

The bookkeeping (tables, lengths, the pool's refcounts, free stack,
parent and dirty leaves) is functional, as in the reference: every op
returns a new cache.  The payload ``pool.data`` is written **in place**
by :func:`ensure_writable` (the COW copy), :func:`write_kv` and the
engine's prefill, where the reference's jitted step updates its donated
buffer: a functional copy would move the whole pool per layer per token.
A cache passed to one of these must not be read again as the old state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import pool as pool_lib
from repro_torch.core.pool import NULL_BLOCK, BlockPool
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.models.layers import torch_dtype

__all__ = [
    "KVCacheConfig",
    "PagedKVCache",
    "create",
    "fork",
    "ensure_writable",
    "write_kv",
    "advance",
    "layer_views",
    "used_blocks",
    "free_blocks",
    "oom_flag",
    "grow",
    "compact",
    "free",
]

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    block_size: int = 16
    max_seqs: int = 8
    max_blocks_per_seq: int = 64
    num_blocks: int = 0  # 0 = auto (sparse-bound sized)
    dtype: str = "float32"
    # Sub-block delta COW: a mid-page fork's COW copy moves only the token
    # slots the tail block has materialized; the untouched prefix resolves
    # through the parent page, which paged attention reads directly.
    delta_cow: bool = False

    @property
    def pool_blocks(self) -> int:
        """The pool's size: ``num_blocks``, or the sparse bound for a
        forked population of ``max_seqs`` sequences.  That bound is too
        small for independent sequences (16 prompts of 512 tokens need
        656 blocks, it gives 250): size those by :attr:`pool_blocks_cap`."""
        if self.num_blocks:
            return self.num_blocks
        n, t = self.max_seqs, self.max_blocks_per_seq
        bound = t + int(4 * n * max(1.0, math.log(max(n, 2)))) + 2 * n
        return min(n * t, max(bound, 16))

    @property
    def pool_blocks_cap(self) -> int:
        """Capacity at which allocation provably cannot fail: every
        sequence owns at most ``max_blocks_per_seq`` pages plus one
        transient while a COW source and its copy coexist."""
        return self.max_seqs * self.max_blocks_per_seq + self.max_seqs


class PagedKVCache(NamedTuple):
    pool: BlockPool  # data [num_blocks + 1, L, 2, bs, KVH, hd] (dump row last)
    tables: torch.Tensor  # [max_seqs, max_blocks_per_seq] int32
    lengths: torch.Tensor  # [max_seqs] int32


def create(cfg: KVCacheConfig, *, device: torch.device | str = "cuda") -> PagedKVCache:
    dev = resolve_device(device)
    pool = pool_lib.init(
        cfg.pool_blocks,
        (cfg.n_layers, 2, cfg.block_size, cfg.n_kv_heads, cfg.head_dim),
        torch_dtype(cfg.dtype),
        npos=cfg.block_size,  # the dirty mask tracks the token-position axis
        device=dev,
    )
    return PagedKVCache(
        pool=pool,
        tables=torch.full((cfg.max_seqs, cfg.max_blocks_per_seq), NULL_BLOCK, dtype=I32, device=dev),
        lengths=torch.zeros(cfg.max_seqs, dtype=I32, device=dev),
    )


def fork(cache: PagedKVCache, ancestors: torch.Tensor) -> PagedKVCache:
    """Lazy deep copy of sequences (resampling): bookkeeping only."""
    anc = ancestors.long()
    new_tables = cache.tables[anc]
    pool = pool_lib.add_refs(cache.pool, new_tables)
    pool = pool_lib.sub_refs(pool, cache.tables)
    return PagedKVCache(pool=pool, tables=new_tables, lengths=cache.lengths[anc])


def _write_pages(pool: BlockPool, ids: torch.Tensor, pages: torch.Tensor, mask: torch.Tensor) -> None:
    """Write whole pages in place; masked and NULL rows land in the dump
    row, which is re-zeroed (``pool.write_blocks`` without its copy)."""
    sids = torch.where(mask & (ids >= 0), ids, pool.num_blocks).long()
    pool.data[sids] = pages.to(pool.data.dtype)
    pool.data[pool.num_blocks].zero_()


def ensure_writable(
    cfg: KVCacheConfig, cache: PagedKVCache, mask: torch.Tensor
) -> Tuple[PagedKVCache, torch.Tensor, torch.Tensor]:
    """Resolve a writable tail block per active sequence (the GET).

    Returns ``(cache, block_ids [S], pos_in_block [S])``; block ids are
    valid where ``mask``.  COW copies happen here, once per token for all
    layers.
    """
    n = cfg.max_seqs
    dev = cache.lengths.device
    rows = torch.arange(n, device=dev)
    bs = cfg.block_size
    width = cache.tables.shape[1]
    idx = (cache.lengths // bs).long()
    pos = cache.lengths % bs
    in_range = idx < width  # a full row's table write is dropped, as in the reference
    col = idx.clamp(max=width - 1)
    cur = cache.tables[rows, col]
    cur_safe = torch.where(cur >= 0, cur, 0).long()
    fresh = (cur == NULL_BLOCK) & mask
    shared = cache.pool.refcount[cur_safe] > 1
    need_copy = (~fresh) & shared & mask
    need_block = fresh | need_copy
    if cfg.delta_cow:
        # Captured before the refcount traffic: sub_refs below may free
        # cur and clear its delta bookkeeping.
        dirty_cur = cache.pool.dirty[cur_safe]  # [S, bs]
        par_cur = cache.pool.parent[cur_safe]
        root = torch.where(need_copy & (par_cur >= 0), par_cur, cur)

    # Rank-compacted: a sparse set of active slots cannot spuriously OOM.
    pool, new_bid = pool_lib.alloc_compact(cache.pool, n, commit=need_block)
    nb = pool.num_blocks
    if cfg.delta_cow:
        # The child's reference on its parent, added before the writer's
        # reference on cur is released (no transient zero on the parent).
        pool = pool_lib.add_refs(pool, torch.where(need_copy, root, NULL_BLOCK))
        # Move only the slots cur materialized; rows with nothing to keep
        # read the (zero) dump row instead of the shared page.
        src = torch.where(need_copy & dirty_cur.any(dim=1), cur, nb).long()
        keep = dirty_cur[:, None, None, :, None, None]
        payload = torch.where(keep, pool.data[src], torch.zeros((), dtype=pool.data.dtype, device=dev))
    else:
        src = torch.where(need_copy, cur, nb).long()
        payload = pool.data[src]
    _write_pages(pool, new_bid, payload, need_copy)
    pool = pool_lib.sub_refs(pool, torch.where(need_copy, cur, NULL_BLOCK))
    bid = torch.where(need_block, new_bid, cur)
    tables = cache.tables.clone()
    tables[rows, col] = torch.where(mask & in_range, bid, cur)
    if cfg.delta_cow:
        # Rows whose resolved block is a delta page: fresh pages are full,
        # COW rows attach to root, in-place rows keep their parent.  The
        # incoming token's slot is marked dirty here, so every layer's
        # write_kv lands in a slot the read path resolves locally.  A
        # mask that fills up degenerates the page back to a full block.
        pa = torch.where(need_copy, root, torch.where(fresh, NULL_BLOCK, par_cur))
        mark = mask & (pa >= 0)
        slots = torch.arange(bs, device=dev)
        new_dirty = dirty_cur | (slots[None, :] == pos[:, None])
        deg = mark & new_dirty.all(dim=1)
        dscat = torch.where(mark, bid, nb)
        dirty = pool_lib._set(pool.dirty, dscat, torch.where(deg[:, None], False, new_dirty))
        parent = pool_lib._set(pool.parent, dscat, torch.where(deg, NULL_BLOCK, pa))
        pool = pool._replace(dirty=dirty, parent=parent)
        pool = pool_lib.sub_refs(pool, torch.where(deg, pa, NULL_BLOCK))
    return PagedKVCache(pool=pool, tables=tables, lengths=cache.lengths), bid, pos


def write_kv(
    cfg: KVCacheConfig,
    cache: PagedKVCache,
    bid: torch.Tensor,  # [S] from ensure_writable
    pos: torch.Tensor,  # [S]
    layer: int,
    k: torch.Tensor,  # [S, KVH, hd]
    v: torch.Tensor,
    mask: torch.Tensor,
) -> PagedKVCache:
    """Write one layer's K/V of the new token into each row's block, in
    place.  Masked rows land in the dump row, whose touched layer is
    re-zeroed."""
    data = cache.pool.data
    nb = cache.pool.num_blocks
    sid = torch.where(mask & (bid >= 0), bid, nb).long()
    p = pos.long()
    data[sid, layer, 0, p] = k.to(data.dtype)
    data[sid, layer, 1, p] = v.to(data.dtype)
    data[nb, layer].zero_()
    return cache


def advance(cache: PagedKVCache, mask: torch.Tensor) -> PagedKVCache:
    return cache._replace(lengths=cache.lengths + mask.to(I32))


def layer_views(cache: PagedKVCache, layer: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k_pool, v_pool) as ``[num_blocks + 1, bs, KVH, hd]`` strided views
    of the pool (one block every ``L*2*bs*KVH*hd`` elements); the dump
    row is unreachable through any table."""
    return cache.pool.data[:, layer, 0], cache.pool.data[:, layer, 1]


def used_blocks(cache: PagedKVCache) -> torch.Tensor:
    return pool_lib.blocks_in_use(cache.pool)


def free_blocks(cache: PagedKVCache) -> torch.Tensor:
    """Allocation headroom in pages (the free-stack depth)."""
    return cache.pool.free_top


def oom_flag(cache: PagedKVCache) -> torch.Tensor:
    """Sticky allocation-failure flag: when set, page writes have been
    dropped to the dump row and decoded logits are not trustworthy."""
    return cache.pool.oom


def grow(cache: PagedKVCache, new_num_blocks: int) -> PagedKVCache:
    """Expand the page pool; block ids are preserved, so tables stay
    valid.  Call between decode steps."""
    return cache._replace(pool=pool_lib.grow(cache.pool, new_num_blocks))


def compact(cache: PagedKVCache, new_num_blocks: int | None = None) -> PagedKVCache:
    """Relocate live pages to a dense prefix (one ``cow_gather`` of the
    pool) and rewrite the tables, optionally shrinking to fit —
    invisible to paged attention, which reads only through the tables."""
    pool, remap = pool_lib.compact(cache.pool, new_num_blocks)
    return cache._replace(pool=pool, tables=pool_lib.remap_tables(cache.tables, remap))


def free(cache: PagedKVCache, mask: torch.Tensor) -> PagedKVCache:
    """Release sequences (refcount GC reclaims unshared blocks)."""
    drop = torch.where(mask[:, None], cache.tables, NULL_BLOCK)
    pool = pool_lib.sub_refs(cache.pool, drop)
    tables = torch.where(mask[:, None], NULL_BLOCK, cache.tables)
    lengths = torch.where(mask, 0, cache.lengths)
    return PagedKVCache(pool=pool, tables=tables, lengths=lengths)
