"""Scale-out: the port of the reference's ``repro.distributed``.

:class:`~repro_torch.distributed.mesh.ShardMesh` is the sharded store's
shard axis (in process, or one shard per ``torch.distributed`` rank) with
its one collective, the all-gather; :mod:`repro_torch.distributed.sharded_store`
holds per-shard block pools over it (DESIGN.md §6).
:mod:`repro_torch.distributed.sharding` lays a model out over a device
mesh by its parameters' logical axes, and
:mod:`repro_torch.distributed.costs` reads a traced per-rank step's
FLOPs, bytes and collective bytes (the counterpart of the reference's
HLO analysis, ``distributed/hlo.py``).
"""

from repro_torch.distributed.mesh import ShardMesh, ShardStreams
from repro_torch.distributed.sharded_store import ShardedStore, ShardedStoreConfig
from repro_torch.distributed.sharding import ShardingRules, default_rules, shardings_for

__all__ = [
    "ShardMesh",
    "ShardStreams",
    "ShardedStore",
    "ShardedStoreConfig",
    "ShardingRules",
    "default_rules",
    "shardings_for",
]
