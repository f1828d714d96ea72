"""Scale-out of the population over shards: the port of the reference's
``repro.distributed`` as far as the sharded store goes (DESIGN.md §6).

:class:`~repro_torch.distributed.mesh.ShardMesh` is the shard axis (in
process, or one shard per ``torch.distributed`` rank) with its one
collective, the all-gather; :mod:`repro_torch.distributed.sharded_store`
holds per-shard block pools over it.  The reference's model-parallel
layout rules (``distributed/sharding.py``) and its XLA cost analysis
(``distributed/hlo.py``) are not ported here.
"""

from repro_torch.distributed.mesh import ShardMesh, ShardStreams
from repro_torch.distributed.sharded_store import ShardedStore, ShardedStoreConfig

__all__ = ["ShardMesh", "ShardStreams", "ShardedStore", "ShardedStoreConfig"]
