"""The population's shard axis: the port's counterpart of a one-axis
``jax.sharding.Mesh`` together with ``lax.all_gather(..., tiled=True)``.

A :class:`ShardMesh` splits N particles into ``num_shards`` shards of
``N / num_shards`` (shard-major: global particle ``i`` lives on shard
``i // n_local``) and offers the one collective the sharded store and
filter need, :meth:`ShardMesh.all_gather`: each shard's leading-axis
slice in, the shard-major concatenation out.  It has two backends, and
the code above it is the same for both:

* **in process** (:meth:`ShardMesh.in_process`): all shards live in this
  process on one device, the all-gather is a concatenation.  The
  counterpart of the reference's faked host mesh; one card runs S > 1
  shards this way.
* **process group** (:meth:`ShardMesh.process_group`): one shard per
  ``torch.distributed`` rank, the all-gather a collective on the group
  (gloo across CPU processes, NCCL across cards; one NCCL communicator
  cannot hold two ranks on one card).

Randomness follows the reference's structure (:class:`ShardStreams`):
one shared stream feeds what every shard must draw alike (the resampling
uniforms), one stream per shard what each draws on its own (the model's
init and propagation noise, where the reference folds its key with the
shard index).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch

from repro_torch import random as rnd
from repro_torch.kernels.dispatch import resolve_device

__all__ = ["ShardMesh", "ShardStreams", "require_mesh", "entry_device"]


class ShardStreams:
    """The draws of a sharded run: ``shared`` is the same stream on every
    shard (resampling), ``shards`` one stream per shard this process holds,
    in shard order (init and the model's propagation).  Each entry is a
    ``torch.Generator`` or a :class:`~repro_torch.random.Replay`; on a
    1-shard mesh the one shard's stream may be ``shared`` itself.

    It is one leaf to :func:`repro_torch.smc.executor.snapshot`: its
    :meth:`clone` copies each stream once, so a stream that serves as both
    stays one stream in the copy."""

    def __init__(self, shared: Any, shards: Sequence[Any]):
        self.shared = shared
        self.shards = tuple(shards)

    def clone(self) -> "ShardStreams":
        shared = rnd.snapshot(self.shared)
        return ShardStreams(shared, [shared if g is self.shared else rnd.snapshot(g) for g in self.shards])


class ShardMesh:
    """A one-axis shard mesh (see the module docstring).

    Attributes:
      num_shards: shards along the axis.
      shard_ids:  the shards this process holds, ascending (all of them in
                  process; its rank in a process group).
      device:     where this process's shards live.
      axis_name:  the axis' name (``FilterConfig.data_axes`` must match).
      distributed: whether the shards are the ranks of a process group.
      group:      that group (None: the default group).
    """

    def __init__(
        self,
        num_shards: int,
        shard_ids: Sequence[int],
        device: torch.device,
        axis_name: str = "shards",
        *,
        distributed: bool = False,
        group: Any = None,
    ):
        if num_shards < 1:
            raise ValueError(f"a mesh needs at least one shard (got {num_shards})")
        self.num_shards = num_shards
        self.shard_ids = tuple(shard_ids)
        self.device = device
        self.axis_name = axis_name
        self.distributed = distributed
        self.group = group

    @classmethod
    def in_process(
        cls, num_shards: int, device: torch.device | str = "cuda", axis_name: str = "shards"
    ) -> "ShardMesh":
        """All ``num_shards`` shards in this process on ``device`` (the GPU
        unless the caller asks for the CPU; raises without one)."""
        return cls(num_shards, range(num_shards), resolve_device(device), axis_name)

    @classmethod
    def process_group(
        cls,
        group: Any = None,
        device: torch.device | str = "cuda",
        axis_name: str = "shards",
    ) -> "ShardMesh":
        """One shard per rank of ``group`` (the default group when None;
        ``torch.distributed`` must be initialized), this rank's shard on
        ``device``."""
        import torch.distributed as dist

        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        return cls(world, (rank,), resolve_device(device), axis_name, distributed=True, group=group)

    @property
    def shape(self) -> dict:
        """``{axis_name: num_shards}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: self.num_shards}

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Shard-major concatenation along the leading axis of one tensor
        per shard: ``parts`` are this process's shards' tensors in shard
        order (all S in process, one in a process group), of one shape.
        0-dim parts gather to ``[S]``."""
        parts = [p.reshape(1) if p.dim() == 0 else p for p in parts]
        if len(parts) != len(self.shard_ids):
            raise ValueError(f"{len(parts)} parts for {len(self.shard_ids)} local shards")
        if not self.distributed:
            return torch.cat(parts) if len(parts) > 1 else parts[0].clone()
        import torch.distributed as dist

        local = parts[0].contiguous()
        wire = local.to(torch.uint8) if local.dtype == torch.bool else local
        out = [torch.empty_like(wire) for _ in range(self.num_shards)]
        dist.all_gather(out, wire, group=self.group)
        return torch.cat(out).to(local.dtype)

    def streams(self, gen: Any) -> ShardStreams:
        """The :class:`ShardStreams` of a run started from ``gen``.

        A :class:`ShardStreams` is returned as it is.  On a 1-shard mesh
        ``gen`` is both the shared stream and the shard's, so a run draws
        exactly what the single-device run draws.  With more shards,
        ``gen`` (a ``torch.Generator``) is the shared stream, and each
        shard's generator is seeded from S seeds drawn from it first:
        every process of a group derives the same seeds, so in-process
        and process-group runs draw alike.  A replay over several shards
        must come as :class:`ShardStreams`."""
        if isinstance(gen, ShardStreams):
            if len(gen.shards) != len(self.shard_ids):
                raise ValueError(f"{len(gen.shards)} shard streams for {len(self.shard_ids)} local shards")
            return gen
        if self.num_shards == 1:
            return ShardStreams(gen, (gen,))
        if not isinstance(gen, torch.Generator):
            raise TypeError(
                "a run over several shards takes a torch.Generator or ShardStreams "
                f"(got {type(gen).__name__})"
            )
        seeds = torch.randint(
            0, 2**62, (self.num_shards,), generator=gen, device=gen.device, dtype=torch.int64
        ).tolist()
        return ShardStreams(gen, tuple(rnd.generator(seeds[s], self.device) for s in self.shard_ids))

    def __repr__(self) -> str:
        where = f"process group, shard {self.shard_ids[0]}" if self.distributed else "in process"
        return f"ShardMesh({self.num_shards} shards, {where}, {self.device})"


def entry_device(mesh: Optional[ShardMesh], device: torch.device | str | None) -> torch.device:
    """The device of an entry point given its ``mesh`` and the caller's
    ``device``: the mesh's (``device``, if given, must be it), else
    ``device``, by default the GPU (raising without one)."""
    if mesh is None:
        return resolve_device("cuda" if device is None else device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def require_mesh(mesh: Optional[Any]) -> Optional[ShardMesh]:
    """``mesh`` if it is None or a :class:`ShardMesh`; ``TypeError``
    otherwise (a ``jax.sharding.Mesh`` is not the port's)."""
    if mesh is not None and not isinstance(mesh, ShardMesh):
        raise TypeError(f"mesh must be a repro_torch.distributed.ShardMesh, not {type(mesh).__name__}")
    return mesh
