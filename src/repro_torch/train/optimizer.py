"""AdamW with global-norm clipping and a warm-up + cosine schedule, in
PyTorch (the port of ``repro.train.optimizer``).

Plain tensor functions on the port's parameter dicts, as the reference's
are on its pytrees (no ``torch.optim``: its clipping, schedule and
weight-decay order are not the reference's).  The optimizer state is a
tree shaped like the params: f32 moments ``mu`` and ``nu`` and an int32
``step``.  The update runs in f32 and is cast back to each parameter's
dtype.

One departure, for memory: :func:`adamw_update` and
:func:`clip_by_global_norm` update the params, moments and gradients
*in place*, and each leaf is worked in slices of :data:`SLICE` elements,
so a step holds a few hundred MB of temporaries beside a 3 B-parameter
model instead of several copies of its largest leaf.  The arithmetic per
element is the reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, NamedTuple, Tuple

import torch

__all__ = [
    "AdamWConfig",
    "OptState",
    "adamw_init",
    "schedule",
    "global_norm",
    "clip_by_global_norm",
    "adamw_update",
    "tree_leaves",
    "tree_map",
]

#: Elements of a leaf worked at once by the in-place update (256 MB of f32).
SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # first moment (a tree like the params)
    nu: Any  # second moment


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, tuples and lists, in the
    reference's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure; leaves are visited in
    :func:`tree_leaves`' order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *nodes) for nodes in zip(tree, *rest, strict=True)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *nodes) for nodes in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def adamw_init(params: Any) -> OptState:
    """Zero f32 moments beside each parameter, step 0."""
    some = tree_leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=some.device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; an f32 scalar
    on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.learning_rate * warm * decay


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard (the update is elementwise); a tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _all_sum(leaf: torch.Tensor, local_sum: torch.Tensor) -> torch.Tensor:
    """The sum over a DTensor leaf's shards of their ``local_sum`` (an
    all-reduce over the mesh dimensions that shard it); a plain leaf's
    ``local_sum`` as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(leaf, DTensor):
        return local_sum
    pls = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in leaf.placements)
    summed = DTensor.from_local(local_sum, leaf.device_mesh, pls, run_check=False)
    return summed.redistribute(leaf.device_mesh, tuple(Replicate() for _ in pls)).to_local()


def _slices(t: torch.Tensor) -> Iterator[torch.Tensor]:
    # A shard of a DTensor gradient may be a transposed view (read only
    # here); params and moments are contiguous, so their slices are views.
    local = _local(t)
    flat = local.view(-1) if local.is_contiguous() else local.reshape(-1)
    for start in range(0, flat.numel(), SLICE):
        yield flat[start : start + SLICE]


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (a
    DTensor leaf's summed over its shards)."""
    sums = []
    for leaf in tree_leaves(tree):
        parts = [torch.sum(torch.square(s.float())) for s in _slices(leaf)]
        sums.append(_all_sum(leaf, torch.stack(parts).sum() if len(parts) > 1 else parts[0]))
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale the gradients (in place) so their global norm is at most
    ``max_norm``; returns them and the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm


@torch.no_grad()
def adamw_update(
    cfg: AdamWConfig, params: Any, grads: Any, state: OptState
) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: the gradients are clipped to
    ``clip_norm``, the moments and params updated.  Returns ``(params,
    state, {"grad_norm", "learning_rate"})`` (the same params and moment
    tensors, a new step)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    lr_, bc1, bc2 = _local(lr), _local(bc1), _local(bc2)
    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
                 strict=True)
    for p, g, m, v in leaves:
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m), _slices(v), strict=True):
            g32 = gs.float()
            ms.mul_(b1).add_((1 - b1) * g32)
            vs.mul_(b2).add_((1 - b2) * g32 * g32)
            p32 = ps.float()
            delta = (ms / bc1) / (torch.sqrt(vs / bc2) + cfg.eps) + cfg.weight_decay * p32
            ps.copy_(p32 - lr_ * delta)
    return params, OptState(step=step, mu=state.mu, nu=state.nu), {"grad_norm": gnorm, "learning_rate": lr}
