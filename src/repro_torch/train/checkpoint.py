"""Checkpoints with async save and elastic restore (the port of
``repro.train.checkpoint``), in the reference's on-disk format:

  * a checkpoint is a directory ``step_<n>/`` of one ``leaf_<i>.npy`` per
    leaf and a ``meta.json`` with the step, the index (each leaf's key,
    file, shape and dtype) and ``extra`` (the data cursor);
  * a leaf's key is its path in the tree, as the reference's
    ``_path_str`` writes it: dict keys (sorted), tuple indices and
    NamedTuple field names joined by ``/`` (``"0/blocks/attn/wq"``,
    ``"1/mu/embed"``, ``"1/step"`` for ``(params, OptState)``), so a
    checkpoint written by one package restores into the other;
  * a write goes to ``step_<n>.tmp/`` and is renamed into place, so a
    crash mid-save never corrupts the latest checkpoint;
  * ``save_async`` copies the leaves to host memory on the caller
    (synchronously) and writes the files on a daemon thread;
  * ``keep`` checkpoints are retained, older ones removed;
  * restore loads full tensors onto any device (``device=``), or, with
    ``placements=``, onto any mesh: each rank keeps its shard of every
    leaf (elastic restore across meshes, as the reference's
    ``shardings=``);
  * a DTensor leaf is saved whole (gathered over its mesh), and on a
    process group only rank 0 writes.

numpy has no bfloat16: a bf16 leaf is written as its f32 value, and
restore casts every leaf to the dtype of the matching leaf of ``like``.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device

__all__ = ["Checkpointer", "flatten_with_paths"]


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` of every leaf of a tree of dicts, tuples, lists and
    NamedTuples, in the reference's flattening order and with its keys."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in flatten_with_paths(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for f, v in zip(tree._fields, tree, strict=True) for item in flatten_with_paths(v, join(f))]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree) for item in flatten_with_paths(v, join(i))]
    return [(prefix, tree)]


def _unflatten(like: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(like, dict):
        return {k: _unflatten(v, values, join(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, values, join(f)) for f, v in zip(like._fields, like, strict=True)))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, values, join(i)) for i, v in enumerate(like))
    return values[prefix]


def _host(leaf: Any) -> np.ndarray:
    from torch.distributed.tensor import DTensor

    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return np.array(t.cpu().numpy(), copy=True)
    return np.array(leaf, copy=True)


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, extra: Optional[Dict] = None) -> Path:
        """Write ``state`` as step ``step``; every rank of a process group
        calls it (DTensor leaves are gathered), rank 0 writes, and all
        return once the checkpoint is in place."""
        self.wait()
        host = self._snapshot(state)
        final = self.dir / f"step_{step:010d}"
        if _rank() == 0:
            final = self._save_sync(step, host, extra or {})
        if torch.distributed.is_initialized():
            torch.distributed.barrier()
        return final

    def save_async(self, step: int, state: Any, extra: Optional[Dict] = None) -> None:
        """Snapshot on the caller, write on a background thread."""
        self.wait()
        host = self._snapshot(state)
        self._thread = threading.Thread(
            target=self._save_sync, args=(step, host, extra or {}), daemon=True
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _snapshot(self, state: Any) -> List[Tuple[str, np.ndarray]]:
        return [(k, _host(v)) for k, v in flatten_with_paths(state)]

    def _save_sync(self, step: int, host_leaves, extra: Dict) -> Path:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = []
        for i, (key, arr) in enumerate(host_leaves):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            index.append({"key": key, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)})
        (tmp / "meta.json").write_text(json.dumps({"step": step, "index": index, "extra": extra}))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        return final

    def _complete(self) -> List[Path]:
        return [c for c in sorted(self.dir.glob("step_*")) if not c.name.endswith(".tmp")]

    def _gc(self) -> None:
        for old in self._complete()[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(old)

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ckpts = self._complete()
        return int(ckpts[-1].name.split("_")[1]) if ckpts else None

    def restore(
        self, like: Any, step: Optional[int] = None, *, device: torch.device | str = "cuda",
        placements: Any = None,
    ) -> Tuple[Any, int, Dict]:
        """Load into the structure of ``like`` (each leaf cast to the dtype
        of ``like``'s, on ``device``); returns ``(state, step, extra)``.
        The files hold full tensors, so any device takes them, and any
        mesh: ``placements``, a tree like ``like`` of
        :class:`~repro_torch.distributed.sharding.NamedSharding`, makes each
        leaf a DTensor of that layout, this rank's shard cut from the file
        (no communication)."""
        dev = resolve_device(device)
        layouts = dict(flatten_with_paths(placements)) if placements is not None else {}
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = self.dir / f"step_{step:010d}"
        meta = json.loads((path / "meta.json").read_text())
        by_key = {e["key"]: e for e in meta["index"]}
        values = {}
        for key, leaf in flatten_with_paths(like):
            entry = by_key.get(key)
            if entry is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = torch.as_tensor(np.load(path / entry["file"]))
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: stored shape {tuple(arr.shape)}, expected {tuple(leaf.shape)}")
            values[key] = arr.to(device=dev, dtype=leaf.dtype)
            if key in layouts:
                values[key] = _shard(values[key], layouts[key])
        return _unflatten(like, values), meta["step"], meta.get("extra", {})


def _rank() -> int:
    return torch.distributed.get_rank() if torch.distributed.is_initialized() else 0


def _shard(full: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's shard of ``full`` under ``sharding`` (a NamedSharding),
    as a DTensor."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    pls = sharding.placements
    shape, offset = compute_local_shape_and_global_offset(full.shape, sharding.mesh, pls)
    local = full[tuple(slice(o, o + n) for o, n in zip(offset, shape, strict=True))]
    return DTensor.from_local(local.contiguous(), sharding.mesh, pls, run_check=False,
                              shape=full.shape, stride=full.stride())
