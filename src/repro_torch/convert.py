"""Carry the platform's state between the JAX reference and the port.

This system has no model weights: its state is the block pool and the
particle store.  :func:`pool_from_numpy` / :func:`store_from_numpy` turn
a reference ``BlockPool`` / ``ParticleStore`` given as numpy leaves (any
object with the same field names, e.g.
``jax.tree.map(np.asarray, ref_store)``) into the port's, on a device;
:func:`pool_to_numpy` / :func:`store_to_numpy` go back, as the port's
NamedTuples with numpy leaves.  Dtypes carry over unchanged (int32 ids,
bool masks, the payload dtype).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.pool import BlockPool
from repro_torch.core.store import ParticleStore

__all__ = ["pool_from_numpy", "pool_to_numpy", "store_from_numpy", "store_to_numpy"]


def _tensor(x: Any, device: torch.device | str) -> torch.Tensor:
    # np.array copies: reference leaves are often read-only views.
    return torch.as_tensor(np.array(x), device=torch.device(device))


def pool_from_numpy(pool: Any, device: torch.device | str) -> BlockPool:
    return BlockPool(*(_tensor(getattr(pool, f), device) for f in BlockPool._fields))


def pool_to_numpy(pool: BlockPool) -> BlockPool:
    return BlockPool(*(t.detach().cpu().numpy() for t in pool))


def store_from_numpy(store: Any, device: torch.device | str) -> ParticleStore:
    return ParticleStore(
        pool=pool_from_numpy(store.pool, device),
        **{f: _tensor(getattr(store, f), device) for f in ParticleStore._fields[1:]},
    )


def store_to_numpy(store: ParticleStore) -> ParticleStore:
    return ParticleStore(
        pool=pool_to_numpy(store.pool),
        **{f: getattr(store, f).detach().cpu().numpy() for f in ParticleStore._fields[1:]},
    )
