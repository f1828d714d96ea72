"""Refcounted block pool — the substrate for lazy object copy, in PyTorch.

The port of ``repro.core.pool`` (see its docstring and DESIGN.md §2-3
for the paper correspondence).  Payload lives in fixed-size *blocks* of
a pre-allocated pool; objects are block tables of indices into it; a
lazy deep copy is a refcount increment; a block with refcount 0 is free.
Allocation pops a maintained free stack (``free_stack[:free_top]`` holds
exactly the ids with ``refcount == 0``, each once).

Every op returns the successor pool and leaves its input's bookkeeping
tensors intact; the one tensor written in place is ``data``, by the
store's COW write (``kernels/cow_write``), as the TPU kernel's aliased
output does.  Nothing here synchronizes with the host: counts and flags
stay 0-dim device tensors.

Each JAX ``.at[ids].op(..., mode="drop")`` becomes a scatter into a
buffer one slot longer, with the extra slot sliced off (:func:`_set`,
:func:`_add`).  Ids and masks stay int32 and bool at the surface so the
leaves compare with the reference; they widen to int64 only to index.
Masked/NULL entries of a payload scatter go to the pool's dump row
(``data`` has ``num_blocks + 1`` rows; the last is never referenced).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.cow_gather import pool_compact

__all__ = [
    "NULL_BLOCK",
    "BlockPool",
    "init",
    "alloc",
    "alloc_scan",
    "alloc_compact",
    "add_refs",
    "sub_refs",
    "release_parents",
    "parent_or_self",
    "freeze",
    "write_blocks",
    "read_blocks",
    "push_free_mask",
    "blocks_in_use",
    "blocks_free",
    "grow",
    "next_capacity",
    "compact",
    "remap_tables",
    "rebuild_free_stack",
    "free_stack_consistent",
    "refcount_matches_tables",
    "check_invariants",
]

NULL_BLOCK = -1
I32 = torch.int32


class BlockPool(NamedTuple):
    """A pool of reference-counted payload blocks (leaves as in
    ``repro.core.pool.BlockPool``).

    Attributes:
      data:       ``[num_blocks + 1, *block_shape]``; the last row is the
                  write-only dump row.
      refcount:   ``[num_blocks] int32`` — 0 means free.
      frozen:     ``[num_blocks] bool`` — the paper's read-only set (LAZY).
      free_stack: ``[num_blocks] int32`` — LIFO stack of free ids.
      free_top:   0-dim int32 — live entries in ``free_stack``.
      oom:        0-dim bool, sticky: an allocation ever failed.
      parent:     ``[num_blocks] int32`` — delta-COW backing block (the
                  store's and the KV cache's ``delta_cow``; all NULL
                  without it).
      dirty:      ``[num_blocks, npos] bool`` — delta-COW slot mask.
    """

    data: torch.Tensor
    refcount: torch.Tensor
    frozen: torch.Tensor
    free_stack: torch.Tensor
    free_top: torch.Tensor
    oom: torch.Tensor
    parent: torch.Tensor
    dirty: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return self.data.shape[0] - 1

    @property
    def block_shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[1:])


def init(
    num_blocks: int,
    block_shape: Sequence[int],
    dtype: torch.dtype = torch.float32,
    npos: int | None = None,
    *,
    device: torch.device | str,
) -> BlockPool:
    """An empty pool of ``num_blocks`` blocks (+ the dump row).  The free
    stack is seeded descending so pops hand out ascending ids."""
    block_shape = tuple(block_shape)
    if npos is None:
        npos = block_shape[0] if block_shape else 1
    dev = torch.device(device)
    return BlockPool(
        data=torch.zeros((num_blocks + 1, *block_shape), dtype=dtype, device=dev),
        refcount=torch.zeros(num_blocks, dtype=I32, device=dev),
        frozen=torch.zeros(num_blocks, dtype=torch.bool, device=dev),
        free_stack=torch.arange(num_blocks - 1, -1, -1, dtype=I32, device=dev),
        free_top=torch.tensor(num_blocks, dtype=I32, device=dev),
        oom=torch.zeros((), dtype=torch.bool, device=dev),
        parent=torch.full((num_blocks,), NULL_BLOCK, dtype=I32, device=dev),
        dirty=torch.zeros((num_blocks, npos), dtype=torch.bool, device=dev),
    )


# ---------------------------------------------------------------------------
# drop-mode scatters
# ---------------------------------------------------------------------------


def _drop_index(idx: torch.Tensor, size: int) -> torch.Tensor:
    """int64 scatter index with every out-of-range entry on slot ``size``."""
    return torch.where((idx >= 0) & (idx < size), idx, size).long()


def _padded(arr: torch.Tensor) -> torch.Tensor:
    return torch.cat([arr, arr.new_zeros((1, *arr.shape[1:]))])


def _set(arr: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """``arr.at[idx].set(values, mode="drop")`` (valid ids distinct, or
    carrying equal values)."""
    buf = _padded(arr)
    buf[_drop_index(idx, arr.shape[0])] = values
    return buf[:-1]


def _add(arr: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``arr.at[idx].add(values, mode="drop")``."""
    buf = _padded(arr)
    buf.index_add_(0, _drop_index(idx, arr.shape[0]), values)
    return buf[:-1]


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=I32)


def _cumsum(mask: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(mask, 0, dtype=I32)


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=like.device)


def _scatter_ids(
    num_blocks: int, ids: torch.Tensor, mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Route NULL/masked entries to the dump index so scatters skip them."""
    ok = ids >= 0
    if mask is not None:
        ok = ok & mask
    return torch.where(ok, ids, num_blocks)


def _gather_ids(ids: torch.Tensor) -> torch.Tensor:
    """Clip NULL entries to 0 for gathers (callers mask the result)."""
    return torch.where(ids >= 0, ids, 0).long()


def _amount(amount: torch.Tensor | int, ids: torch.Tensor) -> torch.Tensor:
    amt = torch.as_tensor(amount, dtype=I32, device=ids.device)
    return torch.broadcast_to(amt, ids.shape).contiguous()


# ---------------------------------------------------------------------------
# allocation and refcounts
# ---------------------------------------------------------------------------


def _push_free_ids(
    stack: torch.Tensor, top: torch.Tensor, ids: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Push non-NULL ids (distinct, and absent from the stack)."""
    valid = ids >= 0
    rank = _cumsum(valid) - 1
    pos = torch.where(valid, top + rank, stack.shape[0])
    return _set(stack, pos, ids), top + _count(valid)


def push_free_mask(
    stack: torch.Tensor, top: torch.Tensor, freed: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Push every block selected by ``freed`` (``[num_blocks] bool``), in
    ascending id order; none may already be in the stack."""
    nb = stack.shape[0]
    rank = _cumsum(freed) - 1
    pos = torch.where(freed, top + rank, nb)
    return _set(stack, pos, _arange(nb, stack)), top + _count(freed)


def alloc(
    pool: BlockPool, n: int, commit: torch.Tensor | None = None
) -> Tuple[BlockPool, torch.Tensor]:
    """Allocate up to ``n`` blocks by popping the free stack.

    ``commit`` (``[n] bool``, default all-true) selects the candidates
    actually committed (refcount 1, unfrozen); the rest are pushed back
    in their order.  Uncommitted and unsatisfied entries come back as
    ``NULL_BLOCK``; a committed request beyond the free stack sets the
    sticky ``oom`` flag.  O(n) work, no pass over the pool.
    """
    dev = pool.refcount.device
    if commit is None:
        commit = torch.ones(n, dtype=torch.bool, device=dev)
    if n == 0:
        return pool, torch.zeros(0, dtype=I32, device=dev)
    nb = pool.num_blocks
    top = pool.free_top
    i = _arange(n, pool.refcount)
    have = i < top
    if nb > 0:
        cand_pos = torch.clamp(top - 1 - i, 0, nb - 1)
        cand = torch.where(have, pool.free_stack[cand_pos.long()], NULL_BLOCK)
    else:
        cand = torch.full((n,), NULL_BLOCK, dtype=I32, device=dev)
    ok = have & commit
    sids = _scatter_ids(nb, cand, ok)
    refcount = _add(pool.refcount, sids, torch.ones_like(sids))
    frozen = _set(pool.frozen, sids, False)
    parent = _set(pool.parent, sids, NULL_BLOCK)
    dirty = _set(pool.dirty, sids, False)
    oom = pool.oom | torch.any(commit & ~have)
    # Remove the committed candidates from the stack window, compacting
    # the uncommitted survivors downward in their original order — an
    # alloc whose commits all fail is a bit-exact no-op.
    keep = have & ~commit
    kept = _cumsum(keep)
    base = top - _count(have)
    tgt = torch.where(keep, base + (kept[-1] - kept), nb)
    stack = _set(pool.free_stack, tgt, cand)
    top = top - _count(ok)
    out_ids = torch.where(ok, cand, NULL_BLOCK)
    pool = pool._replace(
        refcount=refcount,
        frozen=frozen,
        oom=oom,
        free_stack=stack,
        free_top=top,
        parent=parent,
        dirty=dirty,
    )
    return pool, out_ids


def alloc_scan(
    pool: BlockPool, n: int, commit: torch.Tensor | None = None
) -> Tuple[BlockPool, torch.Tensor]:
    """Debug/verify allocator: the O(num_blocks) scan.  Same contract as
    :func:`alloc`; the candidates are the *lowest* free ids instead of the
    stack's top, and the free stack is rebuilt canonically afterwards, so
    the two allocators can interleave."""
    dev = pool.refcount.device
    if commit is None:
        commit = torch.ones(n, dtype=torch.bool, device=dev)
    free = _ascending(pool.refcount == 0)[:n]
    if free.shape[0] < n:
        pad = torch.full((n - free.shape[0],), NULL_BLOCK, dtype=I32, device=dev)
        free = torch.cat([free, pad])
    ok = (free >= 0) & commit
    sids = _scatter_ids(pool.num_blocks, free, ok)
    pool = pool._replace(
        refcount=_add(pool.refcount, sids, torch.ones_like(sids)),
        frozen=_set(pool.frozen, sids, False),
        oom=pool.oom | torch.any(commit & (free < 0)),
        parent=_set(pool.parent, sids, NULL_BLOCK),
        dirty=_set(pool.dirty, sids, False),
    )
    return rebuild_free_stack(pool), torch.where(ok, free, NULL_BLOCK)


def alloc_compact(
    pool: BlockPool, n: int, commit: torch.Tensor
) -> Tuple[BlockPool, torch.Tensor]:
    """Like :func:`alloc`, with committed requests packed by rank onto the
    first candidates: succeeds whenever ``sum(commit)`` blocks are free."""
    total = _count(commit)
    prefix = _arange(n, commit) < total
    pool, cand = alloc(pool, n, commit=prefix)
    rank = _cumsum(commit) - 1
    picked = cand[torch.where(commit, rank, 0).long()]
    return pool, torch.where(commit, picked, NULL_BLOCK)


def add_refs(
    pool: BlockPool, ids: torch.Tensor, amount: torch.Tensor | int = 1
) -> BlockPool:
    """Increment refcounts (repeats and NULL entries allowed).  Every id
    must name a live block: resurrecting a freed one would leave a stale
    free-stack entry."""
    ids = ids.reshape(-1)
    sids = _scatter_ids(pool.num_blocks, ids)
    return pool._replace(refcount=_add(pool.refcount, sids, _amount(amount, ids)))


def _sub_refs_level(
    pool: BlockPool, ids: torch.Tensor, amount: torch.Tensor | int = 1
) -> Tuple[BlockPool, torch.Tensor]:
    """One decrement pass; returns the freed ids, deduplicated (only the
    first occurrence of a freed id carries it, the rest are NULL)."""
    ids = ids.reshape(-1)
    k = ids.shape[0]
    nb = pool.num_blocks
    sids = _scatter_ids(nb, ids)
    refcount = _add(pool.refcount, sids, -_amount(amount, ids))
    gids = _gather_ids(ids)
    flip = (ids >= 0) & (pool.refcount[gids] > 0) & (refcount[gids] == 0)
    order = _arange(k, ids)
    claim = torch.full((nb + 1,), k, dtype=I32, device=ids.device)
    claim = claim.scatter_reduce(0, sids.long(), order, reduce="amin")
    rep = flip & (claim[gids] == order)
    freed = torch.where(rep, ids, NULL_BLOCK)
    stack, top = _push_free_ids(pool.free_stack, pool.free_top, freed)
    return pool._replace(refcount=refcount, free_stack=stack, free_top=top), freed


def sub_refs(
    pool: BlockPool, ids: torch.Tensor, amount: torch.Tensor | int = 1
) -> BlockPool:
    """Decrement refcounts; blocks reaching zero are pushed onto the free
    stack.  A freed delta block releases its parent reference (one more
    level); with all-NULL parents that pass is a value-level no-op."""
    pool, freed = _sub_refs_level(pool, ids, amount)
    parents = torch.where(freed >= 0, pool.parent[_gather_ids(freed)], NULL_BLOCK)
    pool, _ = _sub_refs_level(pool, parents, 1)
    sids = _scatter_ids(pool.num_blocks, freed)
    parent = _set(pool.parent, sids, NULL_BLOCK)
    dirty = _set(pool.dirty, sids, False)
    return pool._replace(parent=parent, dirty=dirty)


def release_parents(pool: BlockPool, freed: torch.Tensor) -> BlockPool:
    """Cascade a mask-shaped free (``[num_blocks] bool``) to the delta
    parents; a value-level no-op with all-NULL parents."""
    nb = pool.num_blocks
    child_par = torch.where(freed, pool.parent, NULL_BLOCK)
    sids = _scatter_ids(nb, child_par)
    drops = _add(torch.zeros(nb, dtype=I32, device=freed.device), sids, torch.ones_like(sids))
    refcount = pool.refcount - drops
    newly = (drops > 0) & (pool.refcount > 0) & (refcount == 0)
    stack, top = push_free_mask(pool.free_stack, pool.free_top, newly)
    parent = torch.where(freed, NULL_BLOCK, pool.parent)
    dirty = torch.where(freed[:, None], False, pool.dirty)
    return pool._replace(
        refcount=refcount, free_stack=stack, free_top=top, parent=parent, dirty=dirty
    )


def parent_or_self(pool: BlockPool, ids: torch.Tensor) -> torch.Tensor:
    """Resolve table entries to the block holding their base payload:
    full blocks to themselves, delta blocks to their parent, NULL stays."""
    par = pool.parent[_gather_ids(ids)]
    return torch.where((ids >= 0) & (par >= 0), par, ids)


def freeze(pool: BlockPool, ids: torch.Tensor) -> BlockPool:
    """Mark blocks read-only — Algorithm 7's FREEZE over a table."""
    sids = _scatter_ids(pool.num_blocks, ids.reshape(-1))
    return pool._replace(frozen=_set(pool.frozen, sids, True))


def write_blocks(
    pool: BlockPool,
    ids: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> BlockPool:
    """Overwrite whole blocks (``values: [k, *block_shape]``), masked.
    Masked/NULL rows land in the dump row, which is re-zeroed."""
    ids = ids.reshape(-1)
    sids = _scatter_ids(pool.num_blocks, ids, mask)
    data = pool.data.clone()
    data[sids.long()] = values.to(data.dtype)
    data[pool.num_blocks] = 0
    return pool._replace(data=data)


def read_blocks(pool: BlockPool, ids: torch.Tensor) -> torch.Tensor:
    """Gather whole blocks (``[*ids.shape, *block_shape]``); NULL ids read
    block 0 (callers mask)."""
    out = pool.data[_gather_ids(ids.reshape(-1))]
    return out.reshape(tuple(ids.shape) + pool.block_shape)


def blocks_in_use(pool: BlockPool) -> torch.Tensor:
    """Live blocks (0-dim int32) — the memory metric of Figures 5-7."""
    return _count(pool.refcount > 0)


def blocks_free(pool: BlockPool) -> torch.Tensor:
    """Allocation headroom (0-dim int32).  Per shard it is what the
    sharded store watches: imports land as fresh blocks on the importing
    shard, so a skewed resampling step spends headroom there while the
    population's occupancy stays flat."""
    return _count(pool.refcount == 0)


# ---------------------------------------------------------------------------
# lifecycle: grow / compact (shape-changing, between generations)
# ---------------------------------------------------------------------------


def grow(pool: BlockPool, new_num_blocks: int) -> BlockPool:
    """Expand capacity, preserving block ids, payload, refcounts, frozen
    bits and the free stack's pop order (fresh ids go *below* it,
    descending).  ``oom`` stays sticky."""
    nb = pool.num_blocks
    if new_num_blocks < nb:
        raise ValueError(
            f"grow cannot shrink: {new_num_blocks} < {nb} (use compact "
            "with new_num_blocks for shrink-to-fit)"
        )
    if new_num_blocks == nb:
        return pool
    dev = pool.refcount.device

    def widen(old: torch.Tensor, fill, rows: int) -> torch.Tensor:
        new = torch.full((rows, *old.shape[1:]), fill, dtype=old.dtype, device=dev)
        new[:nb] = old[:nb]
        return new

    fresh = torch.arange(new_num_blocks - 1, nb - 1, -1, dtype=I32, device=dev)
    return BlockPool(
        data=widen(pool.data, 0, new_num_blocks + 1),
        refcount=widen(pool.refcount, 0, new_num_blocks),
        frozen=widen(pool.frozen, False, new_num_blocks),
        free_stack=torch.cat([fresh, pool.free_stack]),
        free_top=pool.free_top + (new_num_blocks - nb),
        oom=pool.oom,
        parent=widen(pool.parent, NULL_BLOCK, new_num_blocks),
        dirty=widen(pool.dirty, False, new_num_blocks),
    )


def next_capacity(num_blocks: int, demand: int, cap: int, factor: float) -> int:
    """Growth sizing shared by every lifecycle driver: geometric growth
    covering at least ``demand`` more blocks, capped at ``cap``."""
    return min(cap, max(int(num_blocks * factor), num_blocks + demand))


def remap_tables(tables: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """Rewrite block tables through a :func:`compact` remap; NULL stays NULL."""
    return torch.where(tables >= 0, remap[_gather_ids(tables)], NULL_BLOCK)


def _ascending(mask: torch.Tensor) -> torch.Tensor:
    """``nonzero(mask, size=len, fill_value=-1)`` without a host sync: the
    set ids in ascending order, padded with NULL."""
    n = mask.shape[0]
    slot = torch.where(mask, _cumsum(mask) - 1, n)
    out = torch.full((n,), NULL_BLOCK, dtype=I32, device=mask.device)
    return _set(out, slot, _arange(n, mask))


def compact(
    pool: BlockPool, new_num_blocks: int | None = None
) -> Tuple[BlockPool, torch.Tensor]:
    """Relocate live blocks to a dense ascending prefix.

    Returns ``(pool, remap)``; ``remap[old_id]`` is the block's new id
    (NULL for free blocks) and every block table must be rewritten
    through it.  Payload moves in one ``pool_compact`` gather; the free
    stack comes back canonical.  A ``new_num_blocks`` too small for the
    live set maps the overflow to NULL and sets ``oom``.
    """
    nb = pool.num_blocks
    target = nb if new_num_blocks is None else new_num_blocks
    dev = pool.refcount.device
    live = pool.refcount > 0
    n_live = _count(live)
    remap = torch.where(live, _cumsum(live) - 1, NULL_BLOCK)
    remap = torch.where(remap < target, remap, NULL_BLOCK)
    perm = _ascending(live)  # old id feeding each new slot
    if target < nb:
        perm = perm[:target]
    elif target > nb:
        pad = torch.full((target - nb,), NULL_BLOCK, dtype=I32, device=dev)
        perm = torch.cat([perm, pad])
    data = pool_compact(pool.data, perm)
    has = perm >= 0
    safe = _gather_ids(perm)
    refcount = torch.where(has, pool.refcount[safe], 0)
    frozen = torch.where(has, pool.frozen[safe], False)
    par_old = torch.where(has, pool.parent[safe], NULL_BLOCK)
    parent = remap_tables(par_old, remap)
    dirty = torch.where(has[:, None], pool.dirty[safe], False)
    n_free = torch.clamp(target - n_live, min=0)
    slot = torch.arange(target, dtype=I32, device=dev)
    stack = torch.where(slot < n_free, target - 1 - slot, NULL_BLOCK)
    oom = pool.oom | (n_live > target)
    pool = BlockPool(
        data=data,
        refcount=refcount,
        frozen=frozen,
        free_stack=stack,
        free_top=n_free,
        oom=oom,
        parent=parent,
        dirty=dirty,
    )
    return pool, remap


# ---------------------------------------------------------------------------
# verify path
# ---------------------------------------------------------------------------


def rebuild_free_stack(pool: BlockPool) -> BlockPool:
    """Recompute the canonical free stack (free ids descending) from the
    refcount mask.  O(num_blocks)."""
    nb = pool.num_blocks
    free = pool.refcount == 0
    count = _count(free)
    asc = _ascending(free)
    i = _arange(nb, free)
    pos = torch.clamp(count - 1 - i, 0, max(nb - 1, 0))
    stack = torch.where(i < count, asc[pos.long()], NULL_BLOCK)
    return pool._replace(free_stack=stack, free_top=count)


def free_stack_consistent(pool: BlockPool) -> torch.Tensor:
    """0-dim bool: ``free_stack[:free_top]`` holds exactly the ids with
    ``refcount == 0``, each once."""
    nb = pool.num_blocks
    live = _arange(nb, pool.refcount) < pool.free_top
    ids = pool.free_stack
    valid = torch.all(~live | (ids >= 0))
    sids = _scatter_ids(nb, torch.where(live, ids, NULL_BLOCK))
    zeros = torch.zeros(nb, dtype=I32, device=ids.device)
    counts = _add(zeros, sids, torch.ones_like(sids))
    free = (pool.refcount == 0).to(I32)
    return valid & (pool.free_top == free.sum(dtype=I32)) & torch.all(counts == free)


def refcount_matches_tables(pool: BlockPool, tables: torch.Tensor) -> torch.Tensor:
    """0-dim bool: refcount equals the histogram of table references plus
    each delta child's reference on its parent."""
    nb = pool.num_blocks
    zeros = torch.zeros(nb, dtype=I32, device=pool.refcount.device)
    sids = _scatter_ids(nb, tables.reshape(-1).to(I32))
    counts = _add(zeros, sids, torch.ones_like(sids))
    psids = _scatter_ids(nb, pool.parent)
    counts = _add(counts, psids, torch.ones_like(psids))
    return torch.all(counts == pool.refcount)


def check_invariants(
    pool: BlockPool, tables: Optional[torch.Tensor] = None
) -> List[str]:
    """Run the pool's conservation laws; return the violations (empty
    means clean).  The sticky ``oom`` flag is not a violation."""
    problems: List[str] = []
    if not bool(free_stack_consistent(pool)):
        problems.append("free stack disagrees with the refcount mask")
    if tables is not None and not bool(refcount_matches_tables(pool, tables)):
        problems.append("refcount/table reference conservation violated")
    return problems
