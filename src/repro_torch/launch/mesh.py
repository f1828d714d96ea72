"""Production and host meshes, as ``torch.distributed`` device meshes (the
port of ``repro.launch.mesh``).

Functions, never module-level constants: importing this module builds no
mesh and starts no process group.  Both meshes are ``DeviceMesh``es over
the default process group.  The dry run sets a fake group of 256 or 512
ranks (:func:`fake_group`) and builds the production mesh on it in one
process; a real run starts its group first (NCCL, a card a rank, or gloo
on the CPU), and :func:`make_host_mesh` starts a one-rank group itself
when none is set.
"""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["PRODUCTION_SHAPES", "fake_group", "make_host_mesh", "make_production_mesh"]

#: The reference's meshes: one pod of 16 x 16 chips, two pods of them.
PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def fake_group(world_size: int) -> None:
    """Set the default process group to PyTorch's fake backend of
    ``world_size`` ranks, this process rank 0: collectives are recorded by
    tracing and never run.  Process-global (run it in a process of its
    own); a fake group of another size is replaced, a real group raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group of {dist.get_world_size()} ranks is set")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The target deployment mesh, over the default group of 256 (one pod)
    or 512 ranks (two pods).

    single pod: 16 x 16 = 256 cards, axes (data, model)
    multi pod:  2 x 16 x 16 = 512 cards, axes (pod, data, model) — the
    ``pod`` axis composes with ``data`` for batch/FSDP sharding.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """The ranks this job really has, as a 1-D ``("data",)`` mesh of
    ``device_type`` (the card unless the caller asks for the CPU; CUDA
    without a card raises).  With no process group set, one rank in this
    process (NCCL on the card, gloo on the CPU) over an in-process store."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.dispatch import resolve_device

    resolve_device(device_type)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=("data",))
