"""Sharded ParticleStore: per-shard block pools over a shard mesh.

The port of ``repro.distributed.sharded_store`` (its docstring and
DESIGN.md §6 give the design).  Each shard owns an independent block
pool and an ``n_local = N / num_shards`` slice of the population:
per-shard free stacks and refcounts, no cross-shard allocation.
Resampling is the only cross-shard operation:

1. every shard computes the same global ancestor vector from the
   gathered weights and a shared draw;
2. within-shard ancestry is a lazy :func:`~repro_torch.core.store.clone_partial`
   (block tables and refcounts, no payload);
3. each shard materializes only the trajectories remote shards demand,
   compacted into ``exports`` slots; the boundary sets are all-gathered
   and each importing shard writes its crossers into fresh refcount-1
   blocks (:func:`~repro_torch.core.store.import_trajectories`).

A :class:`ShardedStore` holds the shards this process holds (all of them
on an in-process mesh, its rank's on a process group), each a plain
:class:`~repro_torch.core.store.ParticleStore` of ``cfg.local``'s sizes
with its own tensors.  :func:`stacked` turns it into the reference's
global view (leaves concatenated shard-major, tables holding shard-local
ids, each shard's dump row kept in ``pool.data``, the scalar leaves
``[S]``), which is what the tests compare leaf by leaf.

Differences from the reference:

* The import side finds each slot's ancestor among the gathered exports
  by a scatter of positions indexed by global id (``[N]``), not the
  reference's ``[n_local, S·exports]`` match matrix: the exported ids are
  unique, so both give the same position and the same ``found``.
* Every shard's exports are materialized before any shard's clone and
  imports write its store (the store writes in place).
* ``used_blocks_per_shard`` and ``peak_blocks_per_shard`` take the mesh:
  on a process group they gather across ranks.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core import pool as pool_lib
from repro_torch.core import store as store_lib
from repro_torch.core.config import CopyMode
from repro_torch.core.pool import BlockPool
from repro_torch.core.store import ParticleStore, StoreConfig
from repro_torch.distributed.mesh import ShardMesh

__all__ = [
    "ShardedStoreConfig",
    "ShardedStore",
    "sharded_clone",
    "gather_global",
    "create",
    "append",
    "write_at",
    "clone",
    "grow",
    "compact",
    "lifecycle_cap",
    "local_num_blocks",
    "free_blocks",
    "oom_flag",
    "read_last",
    "trajectories",
    "used_blocks_per_shard",
    "peak_blocks_per_shard",
    "stacked",
]

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ShardedStoreConfig:
    """Static configuration of a sharded store (as the reference's).

    Attributes:
      base:        the *global* :class:`StoreConfig` (``base.n`` = N).
      num_shards:  shards along the axis; must divide ``base.n``.
      axis_name:   the mesh axis the population is split over.
      max_exports: per-shard export slots of the exchange; 0 means
                   ``n_local`` (a shard is never asked for more than its
                   own n_local distinct trajectories, so it cannot
                   overflow).
    """

    base: StoreConfig
    num_shards: int
    axis_name: str = "shards"
    max_exports: int = 0

    def __post_init__(self):
        if self.base.n % self.num_shards != 0:
            raise ValueError(
                f"population size {self.base.n} not divisible by "
                f"num_shards={self.num_shards}"
            )

    @property
    def n_local(self) -> int:
        return self.base.n // self.num_shards

    @property
    def exports(self) -> int:
        return self.max_exports or self.n_local

    @property
    def local(self) -> StoreConfig:
        """Per-shard StoreConfig (what each shard holds)."""
        b = self.base
        if b.num_blocks:
            blocks = -(-b.num_blocks // self.num_shards)
        elif self.num_shards == 1:
            blocks = 0  # keep the single-device auto size: bit-exact
        else:
            nl = self.base.n // self.num_shards
            auto = dataclasses.replace(b, n=nl).pool_blocks
            # Pad for import skew (a resampling step may land up to n_local
            # imported trajectories on one shard's pool), and one transient
            # block per particle above the dense bound: LAZY copies even
            # sole-owner frozen blocks, so source and copy coexist within a
            # write step.
            dense = nl * b.max_blocks + nl
            blocks = min(dense, auto + (nl * b.max_blocks) // 4 + nl)
        return dataclasses.replace(b, n=self.base.n // self.num_shards, num_blocks=blocks)


class ShardedStore(NamedTuple):
    """The shards this process holds, in shard order (all S on an
    in-process mesh, one on a process group)."""

    shards: Tuple[ParticleStore, ...]


def _check(cfg: ShardedStoreConfig, mesh: ShardMesh) -> None:
    if mesh.num_shards != cfg.num_shards:
        raise ValueError(f"mesh has {mesh.num_shards} shards, the config {cfg.num_shards}")


def _local_slices(cfg: ShardedStoreConfig, mesh: ShardMesh, x: torch.Tensor):
    """This process's shards' slices of a global ``[N, ...]`` tensor."""
    nl = cfg.n_local
    return [x[s * nl : (s + 1) * nl] for s in mesh.shard_ids]


def _map(store: ShardedStore, fn) -> ShardedStore:
    return ShardedStore(tuple(fn(i, st) for i, st in enumerate(store.shards)))


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------


def gather_global(mesh: ShardMesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Shard-major concatenation of per-shard leading axes: local
    ``[n_local, ...]`` per shard -> global ``[N, ...]``."""
    return mesh.all_gather(parts)


def _export_slots(my_dem: torch.Tensor, k: int) -> torch.Tensor:
    """``nonzero(my_dem, size=k, fill_value=-1)`` without a host sync: the
    first ``k`` demanded local ids ascending, padded with -1."""
    rank = torch.cumsum(my_dem, 0, dtype=I32) - 1
    slot = torch.where(my_dem & (rank < k), rank, k).long()
    ids = torch.arange(my_dem.shape[0], dtype=I32, device=my_dem.device)
    out = torch.full((k + 1,), -1, dtype=I32, device=my_dem.device)
    out[slot] = torch.where(my_dem, ids, -1)
    return out[:k]


def sharded_clone(
    cfg: ShardedStoreConfig, mesh: ShardMesh, store: ShardedStore, global_ancestors: torch.Tensor
) -> ShardedStore:
    """Population clone under a global ancestor vector (``[N] int32``, the
    same on every shard).  Within-shard ancestry is a lazy clone; boundary
    crossers move through the compacted materialize / all-gather / import
    exchange.  Export overflow and an ancestor missing from the gathered
    set stick ``oom`` on the shard concerned."""
    _check(cfg, mesh)
    local = cfg.local
    nl, k, n = cfg.n_local, cfg.exports, cfg.base.n
    anc_all = global_ancestors.to(I32)
    dev = anc_all.device
    if cfg.num_shards == 1:
        # No remote shard: the exchange is empty, and the clone is the
        # single-device one, leaf for leaf.
        return ShardedStore((store_lib.clone(local, store.shards[0], anc_all),))

    # Which particles do remote shards demand (the same on every shard)?
    slot_shard = torch.arange(n, dtype=I32, device=dev) // nl
    cross = slot_shard != anc_all // nl
    demanded = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    demanded[torch.where(cross, anc_all, n).long()] = True
    demanded = demanded[:n]

    # Export side, every shard before any store is written: materialize
    # only the boundary set.
    exports = []
    for s, st in zip(mesh.shard_ids, store.shards, strict=True):
        my_dem = demanded[s * nl : (s + 1) * nl]
        exp_local = _export_slots(my_dem, k)
        valid = exp_local >= 0
        safe = torch.where(valid, exp_local, 0)
        exports.append((
            store_lib.materialize_batch(local, st, safe),
            torch.where(valid, exp_local + s * nl, -1),
            torch.where(valid, st.lengths[safe.long()], 0),
            my_dem.sum(dtype=I32) > k,
        ))
    g_traj = mesh.all_gather([e[0] for e in exports])  # [S*k, capacity, *item]
    g_gid = mesh.all_gather([e[1] for e in exports])  # [S*k]
    g_len = mesh.all_gather([e[2] for e in exports])  # [S*k]

    # Import side: the exported ids are unique, so a scatter of positions
    # by global id finds each slot's ancestor in the gathered set.
    pos_of = torch.full((n + 1,), -1, dtype=I32, device=dev)
    pos_of[torch.where(g_gid >= 0, g_gid, n).long()] = torch.arange(g_gid.shape[0], dtype=I32, device=dev)
    pos_of[n] = -1

    out = []
    for (s, st), (_, _, _, overflow) in zip(zip(mesh.shard_ids, store.shards), exports, strict=True):
        anc = anc_all[s * nl : (s + 1) * nl]
        is_local = anc // nl == s
        local_anc = torch.where(is_local, anc - s * nl, 0)
        pos = pos_of[anc.long()]
        found = pos >= 0
        pos = torch.where(found, pos, 0).long()
        do_import = ~is_local & found
        st = store_lib.clone_partial(local, st, local_anc, is_local)
        st = store_lib.import_trajectories(local, st, g_traj[pos], g_len[pos], do_import)
        missing = torch.any(~is_local & ~found)
        st = st._replace(pool=st.pool._replace(oom=st.pool.oom | overflow | missing))
        out.append(st)
    return ShardedStore(tuple(out))


# ---------------------------------------------------------------------------
# global-view wrappers (values and ancestors are global [N] tensors)
# ---------------------------------------------------------------------------


def create(cfg: ShardedStoreConfig, mesh: ShardMesh) -> ShardedStore:
    """Empty per-shard pools on the mesh's device."""
    _check(cfg, mesh)
    return ShardedStore(tuple(store_lib.create(cfg.local, mesh.device) for _ in mesh.shard_ids))


def append(
    cfg: ShardedStoreConfig, mesh: ShardMesh, store: ShardedStore, values: torch.Tensor
) -> ShardedStore:
    """Append one item per particle (``values: [N, *item]``): each shard
    appends its slice, in place."""
    parts = _local_slices(cfg, mesh, values)
    return _map(store, lambda i, st: store_lib.append(cfg.local, st, parts[i]))


def write_at(
    cfg: ShardedStoreConfig,
    mesh: ShardMesh,
    store: ShardedStore,
    positions: torch.Tensor,
    values: torch.Tensor,
) -> ShardedStore:
    """Mutate one existing item per particle (COW applies), shard by shard."""
    pos = _local_slices(cfg, mesh, positions)
    vals = _local_slices(cfg, mesh, values)
    return _map(store, lambda i, st: store_lib.write_at(cfg.local, st, pos[i], vals[i]))


def clone(
    cfg: ShardedStoreConfig, mesh: ShardMesh, store: ShardedStore, ancestors: torch.Tensor
) -> ShardedStore:
    """Global resampling clone (``ancestors: [N]`` global ids)."""
    return sharded_clone(cfg, mesh, store, ancestors)


def read_last(cfg: ShardedStoreConfig, mesh: ShardMesh, store: ShardedStore) -> torch.Tensor:
    """Each particle's last item, ``[N, *item]``."""
    return mesh.all_gather([store_lib.read_last(cfg.local, st) for st in store.shards])


def trajectories(cfg: ShardedStoreConfig, mesh: ShardMesh, store: ShardedStore) -> torch.Tensor:
    """Materialize the whole population: ``[N, capacity, *item]``."""
    ids = torch.arange(cfg.n_local, dtype=I32, device=mesh.device)
    return mesh.all_gather([store_lib.materialize_batch(cfg.local, st, ids) for st in store.shards])


# ---------------------------------------------------------------------------
# lifecycle: every shard in lockstep, so all keep one shape
# ---------------------------------------------------------------------------


def lifecycle_cap(cfg: ShardedStoreConfig) -> int:
    """Growth ceiling of lockstep per-shard growth: the per-shard dense
    bound (0 under EAGER, which has no pool to grow)."""
    return 0 if cfg.base.mode is CopyMode.EAGER else cfg.local.pool_blocks_cap


def local_num_blocks(store: ShardedStore) -> int:
    """Per-shard pool capacity (every shard grows in lockstep)."""
    return store.shards[0].pool.num_blocks


def free_blocks(cfg: ShardedStoreConfig, mesh: ShardMesh, store: ShardedStore) -> torch.Tensor:
    """The worst shard's allocation headroom (0-dim)."""
    return mesh.all_gather([store_lib.free_blocks(cfg.local, st) for st in store.shards]).min()


def oom_flag(cfg: ShardedStoreConfig, mesh: ShardMesh, store: ShardedStore) -> torch.Tensor:
    """0-dim bool: did any shard's allocation, export or import ever fail?
    (Sticky; an EAGER shard's pool flag records only the exchange's.)"""
    return mesh.all_gather([st.pool.oom for st in store.shards]).any()


def grow(
    cfg: ShardedStoreConfig, mesh: ShardMesh, store: ShardedStore, new_num_blocks: int
) -> ShardedStore:
    """Grow every shard's pool to ``new_num_blocks`` blocks; block ids are
    shard-local and kept, so tables stay valid.  (As the reference's, it
    grows an EAGER store's placeholder pool too.)"""
    _check(cfg, mesh)
    return _map(store, lambda i, st: st._replace(pool=pool_lib.grow(st.pool, new_num_blocks)))


def compact(
    cfg: ShardedStoreConfig,
    mesh: ShardMesh,
    store: ShardedStore,
    new_num_blocks: int | None = None,
) -> ShardedStore:
    """Per-shard compaction, in lockstep.  With ``new_num_blocks`` every
    shard shrinks to that capacity, which must hold the worst shard's
    live set (else that shard's ``oom`` sticks)."""
    _check(cfg, mesh)
    return _map(store, lambda i, st: store_lib.compact(cfg.local, st, new_num_blocks))


# ---------------------------------------------------------------------------
# accounting and the reference's global view
# ---------------------------------------------------------------------------


def used_blocks_per_shard(cfg: ShardedStoreConfig, mesh: ShardMesh, store: ShardedStore) -> torch.Tensor:
    """Live blocks per shard, ``[num_shards]`` int32."""
    return mesh.all_gather([store_lib.used_blocks(cfg.local, st) for st in store.shards])


def peak_blocks_per_shard(cfg: ShardedStoreConfig, mesh: ShardMesh, store: ShardedStore) -> torch.Tensor:
    """Running per-shard peak, ``[num_shards]`` int32."""
    return mesh.all_gather([st.peak_blocks for st in store.shards])


def stacked(mesh: ShardMesh, store: ShardedStore) -> ParticleStore:
    """The reference's stacked global view: every leaf the shard-major
    concatenation of the shards' leaves (``tables`` holding shard-local
    ids, ``pool.data`` each shard's rows with its dump row, ``free_top``,
    ``oom`` and ``peak_blocks`` of shape ``[S]``)."""

    def cat(get):
        return mesh.all_gather([get(st) for st in store.shards])

    pool = BlockPool(*(cat(lambda st, f=f: getattr(st.pool, f)) for f in BlockPool._fields))
    return ParticleStore(
        pool=pool,
        dense=cat(lambda st: st.dense),
        tables=cat(lambda st: st.tables),
        lengths=cat(lambda st: st.lengths),
        peak_blocks=cat(lambda st: st.peak_blocks),
    )
