"""Carry state between the JAX reference and the port.

The platform's state is the block pool and the particle store; serving
adds the model's parameters and the paged KV cache.
:func:`pool_from_numpy` / :func:`store_from_numpy` turn
a reference ``BlockPool`` / ``ParticleStore`` given as numpy leaves (any
object with the same field names, e.g.
``jax.tree.map(np.asarray, ref_store)``) into the port's, on a device;
:func:`pool_to_numpy` / :func:`store_to_numpy` go back, as the port's
NamedTuples with numpy leaves.  Dtypes carry over unchanged (int32 ids,
bool masks, the payload dtype).  A bfloat16 leaf, which numpy holds as
``ml_dtypes.bfloat16``, comes in by its bits and goes back as float32.

:func:`params_from_numpy` maps the reference's parameter pytree (numpy
leaves, layers stacked under ``blocks``) onto the port's tree, checking
every leaf against the port's own shapes; :func:`kv_cache_from_numpy` /
:func:`kv_cache_to_numpy` do for a ``PagedKVCache`` what the pool's do.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.pool import BlockPool
from repro_torch.core.store import ParticleStore
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LanguageModel
from repro_torch.serving.kv_cache import PagedKVCache

__all__ = [
    "to_numpy",
    "pool_from_numpy",
    "pool_to_numpy",
    "store_from_numpy",
    "store_to_numpy",
    "params_from_numpy",
    "kv_cache_from_numpy",
    "kv_cache_to_numpy",
]


def _tensor(x: Any, device: torch.device | str) -> torch.Tensor:
    # np.array copies: reference leaves are often read-only views.
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        bits = torch.as_tensor(arr.view(np.int16))
        return bits.view(torch.bfloat16).to(torch.device(device))
    return torch.as_tensor(arr, device=torch.device(device))


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: keep the f32 value
        t = t.float()
    return t.numpy()


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as a contiguous numpy array of its own (bfloat16 as its
    float32 value)."""
    return np.array(_numpy(t), order="C")


def pool_from_numpy(pool: Any, device: torch.device | str) -> BlockPool:
    return BlockPool(*(_tensor(getattr(pool, f), device) for f in BlockPool._fields))


def pool_to_numpy(pool: BlockPool) -> BlockPool:
    return BlockPool(*(_numpy(t) for t in pool))


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


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device: torch.device | str) -> Dict[str, Any]:
    """The reference's parameter pytree (nested dicts of numpy-convertible
    leaves) as the port's, on ``device``.  Raises unless the two trees
    have the same leaves with the same shapes."""
    specs = LanguageModel(cfg).param_specs()
    flat: Dict[str, Any] = {}

    def walk(node: Dict[str, Any], prefix: str) -> None:
        for name, leaf in node.items():
            path = f"{prefix}{name}"
            if isinstance(leaf, dict):
                walk(leaf, path + "/")
            else:
                flat[path] = leaf

    walk(tree, "")
    if set(flat) != set(specs):
        raise ValueError(
            f"parameter trees differ: only in the reference {sorted(set(flat) - set(specs))}, "
            f"only in the port {sorted(set(specs) - set(flat))}"
        )
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        value = _tensor(leaf, device)
        if tuple(value.shape) != specs[path]:
            raise ValueError(f"{path}: shape {tuple(value.shape)}, the port expects {specs[path]}")
        node = out
        *parents, name = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = value
    return out


def kv_cache_from_numpy(cache: Any, device: torch.device | str) -> PagedKVCache:
    return PagedKVCache(
        pool=pool_from_numpy(cache.pool, device),
        tables=_tensor(cache.tables, device),
        lengths=_tensor(cache.lengths, device),
    )


def kv_cache_to_numpy(cache: PagedKVCache) -> PagedKVCache:
    return PagedKVCache(
        pool=pool_to_numpy(cache.pool), tables=_numpy(cache.tables), lengths=_numpy(cache.lengths)
    )
