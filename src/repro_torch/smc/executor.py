"""The population executor (DESIGN.md §4), in PyTorch.

The port of ``repro.smc.executor``: the host loop every population
method drives — run a chunk of generations, read the headroom/OOM
signal at the chunk boundary, grow the pool ahead of need (or roll back
and retry), stitch the per-chunk traces together.

Differences from the reference, both because PyTorch runs eagerly:

* There is no jit.  :meth:`PopulationExecutor.jit_chunk` keeps its name
  and its per-key cache of built chunk functions, but builds nothing
  that compiles, so ``ExecutorStats.compiles`` stays 0.
* The store is written in place (``repro_torch.core.store``), so the
  rollback checkpoint is a copy: when growth and retry are on, the loop
  snapshots the carry's tensors (and its generator's position) at every
  chunk boundary, and a retried chunk replays the same draws from the
  snapshot.  Nothing else copies the pool.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch import random as rnd
from repro_torch.core import pool as pool_lib

__all__ = [
    "ExecutorStats",
    "GrowthPolicy",
    "PoolView",
    "PopulationExecutor",
    "concat_chunk_outs",
    "filter_empty_outs",
    "snapshot",
    "tree_map",
]


@dataclasses.dataclass
class ExecutorStats:
    """Mutable per-executor telemetry.

    Attributes:
      compiles: always 0 in the port (no jit; kept for the reference's
        telemetry schema).
      chunks:   chunk invocations across all runs (accepted + retried).
      grow_events: pool growth events (watermark, retry, ``ensure``).
      retries:  rollback-retry events (chunk discarded and re-run).
    """

    compiles: int = 0
    chunks: int = 0
    grow_events: int = 0
    retries: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class GrowthPolicy:
    """How a consumer wants the lifecycle loop driven: ``grow`` turns on
    chunked growth, ``chunk`` generations run between host checks,
    ``factor`` multiplies capacity per growth event, ``retry`` enables
    the rollback-retry backstop."""

    grow: bool
    chunk: int = 8
    factor: float = 2.0
    retry: bool = True


@dataclasses.dataclass(frozen=True)
class PoolView:
    """How the executor reads and grows a consumer's pool; every accessor
    takes the loop carry.  ``cap=0`` disables growth."""

    free: Callable[[Any], Any]  # -> int-able allocation headroom (blocks)
    num_blocks: Callable[[Any], int]  # -> current capacity
    cap: int  # growth ceiling; 0 = never grow
    grow_to: Callable[[Any, int], Any]  # -> carry with the grown pool
    oom: Optional[Callable[[Any], Any]] = None  # -> bool-able sticky flag


def filter_empty_outs(
    device: torch.device | str = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The empty ``(ess, resampled, used)`` traces of a zero-length run."""
    return (
        torch.zeros(0, dtype=torch.float32, device=device),
        torch.zeros(0, dtype=torch.bool, device=device),
        torch.zeros(0, dtype=torch.int32, device=device),
    )


def concat_chunk_outs(
    outs: Sequence[Tuple[torch.Tensor, ...]], empty: Tuple[torch.Tensor, ...]
) -> Tuple[torch.Tensor, ...]:
    """Stitch per-chunk trace tuples into full-run traces; an empty run
    yields ``empty``."""
    if outs:
        return tuple(torch.cat([o[i] for o in outs]) for i in range(len(empty)))
    return empty


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` to the leaves of ``tree`` (and the matching leaves of
    ``rest``); tuples, NamedTuples, lists and dicts are containers, all
    else is a leaf."""
    if isinstance(tree, tuple):
        items = [tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    if isinstance(tree, list):
        return [tree_map(fn, *xs) for xs in zip(tree, *rest, strict=True)]
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _copy_leaf(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, torch.Generator) or hasattr(x, "clone"):
        return rnd.snapshot(x)
    return x


def snapshot(carry: Any) -> Any:
    """A deep copy of a carry: tensors cloned, generators (and replay
    objects) copied at their position."""
    return tree_map(_copy_leaf, carry)


class PopulationExecutor:
    """One per consumer instance: owns its chunk cache, telemetry and
    lifecycle loop."""

    def __init__(self) -> None:
        self._cache: dict = {}
        self.stats = ExecutorStats()

    def jit_chunk(self, key: Any, build: Callable[[], Callable]) -> Callable:
        """Per-instance cache of ``build()`` (run at most once per key).
        Nothing is compiled, so ``stats.compiles`` is not bumped."""
        fn = self._cache.get(key)
        if fn is None:
            fn = self._cache[key] = build()
        return fn

    def ensure(self, pool: PoolView, carry: Any, need: int, factor: float) -> Any:
        """Pre-emptive watermark growth: grow so the next ``need`` block
        allocations cannot fail, capped at ``pool.cap``."""
        if need <= 0:
            return carry
        nb = pool.num_blocks(carry)
        if nb >= pool.cap:
            return carry
        free = int(pool.free(carry))
        if free >= need:
            return carry
        carry = pool.grow_to(
            carry, pool_lib.next_capacity(nb, need - free, pool.cap, factor)
        )
        self.stats.grow_events += 1
        return carry

    def run(
        self,
        carry: Any,
        *,
        n_steps: int,
        chunk_fn: Callable[[Any, range], Tuple[Any, Any]],
        policy: GrowthPolicy,
        need_per_step: int = 0,
        pool: Optional[PoolView] = None,
        boundary: Optional[Callable[[Any, range], Any]] = None,
        after: Optional[Callable[[Any, range], None]] = None,
    ) -> Tuple[Any, List[Any], int]:
        """Drive ``chunk_fn(carry, ts) -> (carry, out)`` over ``n_steps``
        generations; ``ts`` is a ``range`` of generation indices.

        Without ``policy.grow`` and without a ``boundary`` hook, one chunk
        runs every generation with no host check (the reference's single
        traced scan).  Otherwise the chunked host loop runs: the optional
        ``boundary`` hook (the serving scheduler's admission and growth
        of several pools), watermark growth so the chunk's
        ``len(ts) * need_per_step`` allocations cannot fail, the chunk,
        and on a stuck ``oom`` flag the rollback: the chunk's outputs are
        dropped, the pre-chunk snapshot grows, and the chunk re-runs with
        the same draws.  The optional ``after`` hook runs once per
        committed chunk, never for a rolled-back one.

        Returns ``(carry, outs, grew)``.
        """
        if not policy.grow and boundary is None:
            ts = range(n_steps)
            carry, out = chunk_fn(carry, ts)
            if after is not None:
                after(carry, ts)
            return carry, [out], 0
        start_grew = self.stats.grow_events
        chunk = max(1, policy.chunk)
        can_retry = (
            policy.grow and policy.retry and pool is not None and pool.oom is not None
        )
        outs: List[Any] = []
        t = 0
        while t < n_steps:
            ts = range(t, min(t + chunk, n_steps))
            g = len(ts)
            if boundary is not None:
                carry = boundary(carry, ts)
            if policy.grow and pool is not None:
                carry = self.ensure(pool, carry, g * need_per_step, policy.factor)
            # The chunk writes the store in place: keep a private copy to
            # roll back to.
            ckpt = snapshot(carry) if can_retry else None
            new_carry, out = chunk_fn(carry, ts)
            self.stats.chunks += 1
            if ckpt is not None and bool(pool.oom(new_carry)):
                nb = pool.num_blocks(ckpt)
                if nb < pool.cap:
                    carry = pool.grow_to(
                        ckpt,
                        pool_lib.next_capacity(
                            nb, g * need_per_step, pool.cap, policy.factor
                        ),
                    )
                    self.stats.grow_events += 1
                    self.stats.retries += 1
                    continue  # retry the same chunk from the clean checkpoint
            carry, t = new_carry, t + g
            outs.append(out)
            if after is not None:
                after(carry, ts)
        return carry, outs, self.stats.grow_events - start_grew
