"""ParticleStore: population state with lazy-copy semantics, in PyTorch.

The port of ``repro.core.store`` (whose docstring and DESIGN.md §2-3
give the paper correspondence).  N particles each own an append-only,
mutable sequence of items, cloned wholesale at every resampling step:

``CopyMode.EAGER``
    Dense ``[N, capacity, *item]``; ``clone`` gathers whole trajectories.
``CopyMode.LAZY``
    Block-pool storage; ``clone`` gathers block tables and bumps
    refcounts, and freezes every block the new generation reaches; any
    write to a frozen block copies it first.
``CopyMode.LAZY_SR``
    As LAZY with the single-reference optimization: a block with
    ``refcount == 1`` is written in place.

Differences from the reference:

* Writes update the store in place: ``append``/``write_at`` write the
  payload (``pool.data`` through the COW kernel, or ``dense``) and the
  block tables into the tensors they are given.  A caller that needs
  the old state (the executor's rollback checkpoint) clones it first.
  Pool bookkeeping (refcount, free stack, flags) is never mutated in
  place.
* ``strict_oom`` is a host-side ``RuntimeError``.
* The kernels run when the store lives on a CUDA device; there is no
  ``use_kernels`` switch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core import pool as pool_lib
from repro_torch.core.config import CopyMode
from repro_torch.core.pool import NULL_BLOCK, BlockPool
from repro_torch.kernels.clone_chain import clone_chain as clone_chain_op
from repro_torch.kernels.cow_gather import cow_gather
from repro_torch.kernels.cow_write import cow_write, cow_write_delta
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.kernels.refcount_update import refcount_update

__all__ = [
    "StoreConfig",
    "ParticleStore",
    "create",
    "append",
    "write_at",
    "clone",
    "clone_chain",
    "clone_partial",
    "import_trajectories",
    "read_at",
    "read_last",
    "trajectory",
    "materialize",
    "materialize_batch",
    "used_blocks",
    "used_bytes",
    "oom_flag",
    "free_blocks",
    "grow",
    "compact",
]

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Static store configuration (as ``repro.core.store.StoreConfig``,
    without ``use_kernels``: the device decides)."""

    mode: CopyMode
    n: int  # number of particles
    block_size: int  # items per block (the COW granularity)
    max_blocks: int  # blocks per particle trajectory
    item_shape: Tuple[int, ...] = ()
    dtype: str = "float32"
    num_blocks: int = 0  # pool capacity; 0 = auto
    # Sub-block delta COW (DESIGN.md §3.2): a write to a shared block
    # copies only the slots the writer had materialized (its dirty mask)
    # plus the written item; the rest resolve through ``pool.parent``.
    # Observationally equal to the whole-block path (valid-prefix
    # trajectories, reads, lengths); the pool's leaves differ.
    delta_cow: bool = False
    # trajectory / materialize / materialize_batch raise RuntimeError on
    # a pool whose sticky oom flag is set.
    strict_oom: bool = False

    @property
    def capacity(self) -> int:
        return self.block_size * self.max_blocks

    @property
    def pool_blocks(self) -> int:
        if self.num_blocks:
            return self.num_blocks
        # Generous default: the sparse bound T/B + c·N·log N blocks, padded.
        t_term = self.max_blocks
        n_term = (
            int(10 * self.n * max(1.0, math.log(max(self.n, 2)))) // self.block_size
        )
        return min(self.n * self.max_blocks, max(t_term + n_term + 2 * self.n, 64))

    @property
    def pool_blocks_cap(self) -> int:
        """Capacity at which allocation provably cannot fail: every
        particle owns at most ``max_blocks`` blocks, plus one transient
        per particle while a COW source and its copy coexist."""
        return self.n * self.max_blocks + self.n

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class ParticleStore(NamedTuple):
    """The population state (leaves as in ``repro.core.store.ParticleStore``)."""

    pool: BlockPool  # lazy modes ([1]-block dummy under EAGER)
    dense: torch.Tensor  # eager mode ([N, 0]-shaped dummy under lazy modes)
    tables: torch.Tensor  # [N, max_blocks] int32 block ids (NULL = unset)
    lengths: torch.Tensor  # [N] int32
    peak_blocks: torch.Tensor  # 0-dim int32 running peak of used_blocks


def create(cfg: StoreConfig, device: torch.device | str = "cuda") -> ParticleStore:
    """An empty store on ``device`` (the GPU unless the caller asks for
    the CPU; raises when asked for CUDA and none is present)."""
    dev = resolve_device(device)
    dtype = cfg.torch_dtype
    if cfg.mode is CopyMode.EAGER:
        pool = pool_lib.init(1, (cfg.block_size, *cfg.item_shape), dtype, device=dev)
        dense = torch.zeros((cfg.n, cfg.capacity, *cfg.item_shape), dtype=dtype, device=dev)
    else:
        pool = pool_lib.init(
            cfg.pool_blocks, (cfg.block_size, *cfg.item_shape), dtype, device=dev
        )
        dense = torch.zeros((cfg.n, 0, *cfg.item_shape), dtype=dtype, device=dev)
    return ParticleStore(
        pool=pool,
        dense=dense,
        tables=torch.full((cfg.n, cfg.max_blocks), NULL_BLOCK, dtype=I32, device=dev),
        lengths=torch.zeros(cfg.n, dtype=I32, device=dev),
        peak_blocks=torch.zeros((), dtype=I32, device=dev),
    )


def _bump_peak(cfg: StoreConfig, store: ParticleStore) -> ParticleStore:
    return store._replace(
        peak_blocks=torch.maximum(store.peak_blocks, used_blocks(cfg, store))
    )


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - mask.dim()))


# ---------------------------------------------------------------------------
# writes
# ---------------------------------------------------------------------------


def append(
    cfg: StoreConfig, store: ParticleStore, values: torch.Tensor
) -> ParticleStore:
    """Append one item per particle (``values: [N, *item]``), COW applied."""
    store = _write_impl(cfg, store, store.lengths, values, advance=True)
    return _bump_peak(cfg, store)


def write_at(
    cfg: StoreConfig,
    store: ParticleStore,
    positions: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> ParticleStore:
    """Mutate an existing item per particle (COW applies);
    ``positions: [N]`` must be < lengths."""
    store = _write_impl(cfg, store, positions, values, advance=False, mask=mask)
    return _bump_peak(cfg, store)


def _write_impl(
    cfg: StoreConfig,
    store: ParticleStore,
    positions: torch.Tensor,
    values: torch.Tensor,
    advance: bool,
    mask: torch.Tensor | None = None,
) -> ParticleStore:
    n = cfg.n
    dev = store.tables.device
    rows = torch.arange(n, device=dev)
    positions = positions.to(I32)
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    lengths = store.lengths + mask.to(I32) if advance else store.lengths
    if cfg.mode is CopyMode.EAGER:
        cur = store.dense[rows, positions.long()]
        sel = torch.where(_expand(mask, values.dim()), values.to(cur.dtype), cur)
        store.dense[rows, positions.long()] = sel
        return store._replace(lengths=lengths)

    pool = store.pool
    bs = cfg.block_size
    idx = (positions // bs).long()
    pos = positions % bs
    cur_bid = store.tables[rows, idx]
    fresh = (cur_bid == NULL_BLOCK) & mask
    cur_safe = torch.where(cur_bid >= 0, cur_bid, 0).long()
    if cfg.mode is CopyMode.LAZY:
        # Algorithm 5: any write to a frozen block copies it.
        shared = pool.frozen[cur_safe]
    else:
        # Remark 1: only genuinely shared blocks (refcount > 1) copy.
        shared = pool.refcount[cur_safe] > 1
    need_copy = (~fresh) & shared & mask
    need_block = fresh | need_copy
    if cfg.delta_cow:
        # Read before any refcount traffic: sub_refs below may free cur
        # and clear its delta bookkeeping.  (Indexing copies, so later
        # pool updates cannot reach these.)
        dirty_cur = pool.dirty[cur_safe]  # [n, block_size]
        par_cur = pool.parent[cur_safe]
        # The new delta child's backing block: cur itself when cur is
        # full, else cur's parent (delta depth stays <= 1).
        root = torch.where(need_copy & (par_cur >= 0), par_cur, cur_bid)

    pool, new_bid = pool_lib.alloc(pool, n, commit=need_block)
    # Transient peak: COW sources and their copies coexist until the
    # writer's reference is released below.
    peak = torch.maximum(store.peak_blocks, pool_lib.blocks_in_use(pool))
    if cfg.delta_cow:
        # The child's reference on its parent goes in before the
        # writer's reference on cur comes out, so a parent shared only
        # through cur never dips to refcount 0 in between.
        pool = pool_lib.add_refs(pool, torch.where(need_copy, root, NULL_BLOCK))
    pool = pool_lib.sub_refs(pool, torch.where(need_copy, cur_bid, NULL_BLOCK))

    bid = torch.where(need_block, new_bid, cur_bid)
    store.tables[rows, idx] = torch.where(mask, bid, cur_bid)
    # Fused COW + item write: copy rows stream their source block,
    # in-place/fresh rows read-modify-write their own, masked/NULL rows
    # self-copy the dump row.  Two unmasked writers never share a
    # destination: the block was exclusively owned, or COW just gave
    # each its own copy.
    dst = torch.where(mask & (bid >= 0), bid, pool.num_blocks)
    src = torch.where(need_copy, cur_bid, dst)
    values = values.reshape(n, *cfg.item_shape)
    if not cfg.delta_cow:
        cow_write(pool.data, src, dst, pos, values)
        return store._replace(pool=pool, lengths=lengths, peak_blocks=peak)

    # Sub-block delta COW.  A copy row keeps only the slots cur had
    # materialized (its dirty mask; none when cur is full: the sparse
    # win); in-place and fresh rows keep everything.  Copy rows with
    # nothing to keep read the dump row instead of their source.
    keep = torch.where(need_copy[:, None], dirty_cur, True)
    src = torch.where(need_copy & ~keep.any(1), pool.num_blocks, src)
    cow_write_delta(pool.data, src, dst, pos, values, keep)
    # Dirty/parent bookkeeping of rows whose block is now a delta block:
    # fresh blocks are full (no parent), COW rows attach to root,
    # in-place rows keep their parent.  A mask that fills up turns the
    # child back into a full block: parent and mask cleared, the parent
    # reference released.
    pa = torch.where(need_copy, root, torch.where(fresh, NULL_BLOCK, par_cur))
    mark = mask & (pa >= 0)
    slots = torch.arange(cfg.block_size, dtype=I32, device=dev)
    new_dirty = dirty_cur | (slots[None, :] == pos[:, None])
    deg = mark & new_dirty.all(1)
    dscat = torch.where(mark, bid, pool.num_blocks)
    pool = pool._replace(
        dirty=pool_lib._set(pool.dirty, dscat, torch.where(deg[:, None], False, new_dirty)),
        parent=pool_lib._set(pool.parent, dscat, torch.where(deg, NULL_BLOCK, pa)),
    )
    pool = pool_lib.sub_refs(pool, torch.where(deg, pa, NULL_BLOCK))
    return store._replace(pool=pool, lengths=lengths, peak_blocks=peak)


# ---------------------------------------------------------------------------
# clone (the deep copy at resampling)
# ---------------------------------------------------------------------------


def _clone_bookkeeping(
    cfg: StoreConfig,
    pool: BlockPool,
    old_tables: torch.Tensor,
    new_tables: torch.Tensor,
) -> BlockPool:
    """Single-pass clone bookkeeping: ``refcount += mult(new) - mult(old)``,
    the LAZY freeze bits, and the newly-freed push (``refcount_update``).
    ``new_tables`` may only reference blocks live under ``old_tables``."""
    refcount, frozen, freed = refcount_update(
        pool.refcount,
        pool.frozen,
        new_tables,
        old_tables,
        do_freeze=cfg.mode is CopyMode.LAZY,
    )
    stack, top = pool_lib.push_free_mask(pool.free_stack, pool.free_top, freed)
    pool = pool._replace(refcount=refcount, frozen=frozen, free_stack=stack, free_top=top)
    if cfg.delta_cow:
        # Freed delta children release their parent reference.
        pool = pool_lib.release_parents(pool, freed)
    return pool


def clone(
    cfg: StoreConfig, store: ParticleStore, ancestors: torch.Tensor
) -> ParticleStore:
    """Replace the population by copies of ``ancestors`` (``[N] int32``).

    EAGER gathers whole trajectories; the lazy modes gather block tables
    and apply the refcount delta (no payload moves), and LAZY freezes
    every block the new generation reaches.
    """
    anc = ancestors.long()
    lengths = store.lengths[anc]
    if cfg.mode is CopyMode.EAGER:
        store = store._replace(dense=store.dense[anc], lengths=lengths)
        return _bump_peak(cfg, store)
    new_tables = store.tables[anc]
    pool = _clone_bookkeeping(cfg, store.pool, store.tables, new_tables)
    store = store._replace(pool=pool, tables=new_tables, lengths=lengths)
    return _bump_peak(cfg, store)


def clone_chain(
    cfg: StoreConfig, store: ParticleStore, gen: Any, logw: torch.Tensor
) -> Tuple[ParticleStore, torch.Tensor]:
    """Fused systematic resample -> clone (``kernels/clone_chain``).

    Returns ``(store', ancestors)``, ancestor-bit-exact with
    ``clone(cfg, store, resampling.resample_systematic(gen, logw))`` and
    drawing the same one uniform.  EAGER has no tables, so it composes.
    """
    if cfg.mode is CopyMode.EAGER:
        from repro_torch.smc import resampling

        ancestors = resampling.resample_systematic(gen, logw)
        return clone(cfg, store, ancestors), ancestors

    pool = store.pool
    ancestors, new_tables, delta, member = clone_chain_op(
        gen, logw, store.tables, num_blocks=pool.num_blocks
    )
    refcount = pool.refcount + delta
    freed = (pool.refcount > 0) & (refcount == 0)
    frozen = pool.frozen | member if cfg.mode is CopyMode.LAZY else pool.frozen
    stack, top = pool_lib.push_free_mask(pool.free_stack, pool.free_top, freed)
    pool = pool._replace(refcount=refcount, frozen=frozen, free_stack=stack, free_top=top)
    if cfg.delta_cow:
        pool = pool_lib.release_parents(pool, freed)
    store = store._replace(
        pool=pool, tables=new_tables, lengths=store.lengths[ancestors.long()]
    )
    return _bump_peak(cfg, store), ancestors


def clone_partial(
    cfg: StoreConfig,
    store: ParticleStore,
    ancestors: torch.Tensor,
    valid: torch.Tensor,
) -> ParticleStore:
    """Clone where only ``valid`` slots take an ancestor; invalid slots
    come back empty (NULL table, zero length).  With ``valid`` all-true
    this is :func:`clone`."""
    anc = ancestors.long()
    lengths = torch.where(valid, store.lengths[anc], 0)
    if cfg.mode is CopyMode.EAGER:
        dense = torch.where(_expand(valid, store.dense.dim()), store.dense[anc], 0)
        store = store._replace(dense=dense.to(store.dense.dtype), lengths=lengths)
        return _bump_peak(cfg, store)
    new_tables = torch.where(valid[:, None], store.tables[anc], NULL_BLOCK)
    pool = _clone_bookkeeping(cfg, store.pool, store.tables, new_tables)
    store = store._replace(pool=pool, tables=new_tables, lengths=lengths)
    return _bump_peak(cfg, store)


def import_trajectories(
    cfg: StoreConfig,
    store: ParticleStore,
    trajs: torch.Tensor,
    new_lengths: torch.Tensor,
    mask: torch.Tensor,
) -> ParticleStore:
    """Write dense trajectories (``trajs: [N, capacity, *item]``) into the
    ``mask``-selected slots as fresh, exclusively owned storage: the
    receiving half of the sharded store's exchange (the eager finish a
    shard boundary forces).  Masked slots must already be empty (see
    :func:`clone_partial`).  Each imported particle gets newly allocated
    blocks (refcount 1), packed by rank onto the free stack
    (``alloc_compact``) in the reference's order; under LAZY they join the
    new generation frozen."""
    if cfg.mode is CopyMode.EAGER:
        dense = torch.where(_expand(mask, store.dense.dim()), trajs.to(store.dense.dtype), store.dense)
        lengths = torch.where(mask, new_lengths.to(I32), store.lengths)
        return _bump_peak(cfg, store._replace(dense=dense, lengths=lengths))

    n, mb, bs = cfg.n, cfg.max_blocks, cfg.block_size
    new_lengths = new_lengths.to(I32)
    n_needed = -(-torch.clamp(new_lengths, min=0) // bs)  # ceil(len / bs)
    slots = torch.arange(mb, dtype=I32, device=mask.device)
    commit = (mask[:, None] & (slots[None, :] < n_needed[:, None])).reshape(-1)
    pool, bids = pool_lib.alloc_compact(store.pool, n * mb, commit=commit)
    payload = trajs.reshape(n * mb, bs, *cfg.item_shape)
    pool = pool_lib.write_blocks(pool, bids, payload, mask=commit)
    if cfg.mode is CopyMode.LAZY:
        pool = pool_lib.freeze(pool, torch.where(commit, bids, NULL_BLOCK))
    tables = torch.where(mask[:, None], bids.reshape(n, mb), store.tables)
    lengths = torch.where(mask, new_lengths, store.lengths)
    return _bump_peak(cfg, store._replace(pool=pool, tables=tables, lengths=lengths))


# ---------------------------------------------------------------------------
# reads (never copy inside the pool)
# ---------------------------------------------------------------------------


def _check_oom(cfg: StoreConfig, store: ParticleStore, op: str) -> None:
    """The ``strict_oom`` path: refuse to read an exhausted pool (its
    dropped appends read back as zeros)."""
    if not cfg.strict_oom or cfg.mode is CopyMode.EAGER:
        return
    if bool(store.pool.oom.any()):
        raise RuntimeError(
            f"ParticleStore.{op} on an exhausted pool: the sticky oom flag is "
            "set, so trajectories are corrupt (appends were dropped to the "
            "dump row). Grow the pool at a generation boundary (store.grow / "
            "FilterConfig.grow) or size num_blocks up."
        )


def read_at(
    cfg: StoreConfig, store: ParticleStore, positions: torch.Tensor | int
) -> torch.Tensor:
    """Read one item per particle at ``positions: [N]`` (or a scalar)."""
    dev = store.tables.device
    positions = torch.broadcast_to(
        torch.as_tensor(positions, dtype=I32, device=dev), (cfg.n,)
    ).long()
    rows = torch.arange(cfg.n, device=dev)
    if cfg.mode is CopyMode.EAGER:
        return store.dense[rows, positions]
    bs = cfg.block_size
    bid = store.tables[rows, positions // bs]
    safe = torch.where(bid >= 0, bid, 0).long()
    out = store.pool.data[safe, positions % bs]
    if cfg.delta_cow:
        # Non-dirty slots of a delta block resolve through the parent.
        res = pool_lib.parent_or_self(store.pool, bid)
        base = store.pool.data[torch.where(res >= 0, res, 0).long(), positions % bs]
        d = store.pool.dirty[safe, positions % bs] & (bid >= 0)
        out = torch.where(_expand(d, out.dim()), out, base)
    return out


def read_last(cfg: StoreConfig, store: ParticleStore) -> torch.Tensor:
    return read_at(cfg, store, torch.clamp(store.lengths - 1, min=0))


def _delta_resolve(
    pool: BlockPool, tab_flat: torch.Tensor, blocks: torch.Tensor
) -> torch.Tensor:
    """Fill the non-dirty slots of gathered blocks
    (``cow_gather(pool.data, tab_flat)``) from their parents.  Full
    blocks gather themselves twice; NULL entries stay zero."""
    base = cow_gather(pool.data, pool_lib.parent_or_self(pool, tab_flat).contiguous())
    d = pool.dirty[torch.where(tab_flat >= 0, tab_flat, 0).long()] & (tab_flat >= 0)[:, None]
    return torch.where(d.reshape(d.shape + (1,) * (blocks.dim() - 2)), blocks, base)


def trajectory(
    cfg: StoreConfig, store: ParticleStore, i: int | torch.Tensor
) -> torch.Tensor:
    """Full path of particle ``i`` as ``[capacity, *item]`` (entries past
    ``lengths[i]`` are unspecified)."""
    if cfg.mode is CopyMode.EAGER:
        return store.dense[i]
    _check_oom(cfg, store, "trajectory")
    tab = store.tables[i].contiguous()
    blocks = cow_gather(store.pool.data, tab)
    if cfg.delta_cow:
        blocks = _delta_resolve(store.pool, tab, blocks)
    return blocks.reshape((cfg.capacity, *cfg.item_shape))


def materialize(
    cfg: StoreConfig, store: ParticleStore, i: int | torch.Tensor
) -> torch.Tensor:
    """Eager deep copy of one particle's trajectory, outside the pool
    (under EAGER a copy of its dense row, not a view that would keep the
    whole population alive)."""
    if cfg.mode is CopyMode.EAGER:
        return store.dense[i].clone()
    return trajectory(cfg, store, i)


def materialize_batch(
    cfg: StoreConfig, store: ParticleStore, ids: torch.Tensor
) -> torch.Tensor:
    """Eager deep copies of several trajectories: ``[k, capacity, *item]``."""
    ids = ids.reshape(-1).long()
    if cfg.mode is CopyMode.EAGER:
        return store.dense[ids]
    _check_oom(cfg, store, "materialize_batch")
    tab = store.tables[ids].reshape(-1)  # [k * max_blocks]
    blocks = cow_gather(store.pool.data, tab)
    if cfg.delta_cow:
        blocks = _delta_resolve(store.pool, tab, blocks)
    return blocks.reshape((ids.shape[0], cfg.capacity, *cfg.item_shape))


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def used_blocks(cfg: StoreConfig, store: ParticleStore) -> torch.Tensor:
    """Live blocks (0-dim int32): EAGER owns every block of every
    trajectory, the lazy modes the blocks with nonzero refcount."""
    if cfg.mode is CopyMode.EAGER:
        per = (store.lengths + cfg.block_size - 1) // cfg.block_size
        return per.sum(dtype=I32)
    return pool_lib.blocks_in_use(store.pool)


def used_bytes(cfg: StoreConfig, store: ParticleStore) -> torch.Tensor:
    item_bytes = cfg.torch_dtype.itemsize * math.prod(cfg.item_shape)
    block_bytes = item_bytes * cfg.block_size
    table_bytes = 4 * cfg.n * cfg.max_blocks if cfg.mode.is_lazy else 0
    return used_blocks(cfg, store) * block_bytes + table_bytes


def oom_flag(cfg: StoreConfig, store: ParticleStore) -> torch.Tensor:
    """0-dim bool: did any allocation ever fail?  (Sticky.)"""
    if cfg.mode is CopyMode.EAGER:
        return torch.zeros((), dtype=torch.bool, device=store.tables.device)
    return store.pool.oom.any()


def free_blocks(cfg: StoreConfig, store: ParticleStore) -> torch.Tensor:
    """Allocation headroom in blocks (int32 max for EAGER, which never
    allocates)."""
    if cfg.mode is CopyMode.EAGER:
        return torch.tensor(torch.iinfo(I32).max, dtype=I32, device=store.tables.device)
    return store.pool.free_top.min()


# ---------------------------------------------------------------------------
# pool lifecycle — between generations, shape-changing
# ---------------------------------------------------------------------------


def grow(cfg: StoreConfig, store: ParticleStore, new_num_blocks: int) -> ParticleStore:
    """Expand the pool; block ids are preserved, so tables stay valid."""
    if cfg.mode is CopyMode.EAGER:
        raise ValueError("EAGER stores are dense; there is no pool to grow")
    return store._replace(pool=pool_lib.grow(store.pool, new_num_blocks))


def compact(
    cfg: StoreConfig, store: ParticleStore, new_num_blocks: int | None = None
) -> ParticleStore:
    """Relocate live blocks to a dense prefix and rewrite the tables;
    every trajectory reads back bit-exact.  EAGER: no-op."""
    if cfg.mode is CopyMode.EAGER:
        return store
    pool, remap = pool_lib.compact(store.pool, new_num_blocks)
    return store._replace(pool=pool, tables=pool_lib.remap_tables(store.tables, remap))
