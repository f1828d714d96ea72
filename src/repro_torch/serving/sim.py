"""Deterministic discrete-event simulator of the serving scheduler, in the
port (the port of ``repro.serving.sim``; host code, no device).

The scheduler makes every admission/growth/preemption decision from the
shared pool's block accounting, so those decisions are a deterministic
function of the arrival trace, the fork (resampling) schedule and the pool
arithmetic, none of which needs a device.  This module is the model of
:class:`~repro_torch.serving.scheduler.Scheduler` that exploits that: it
replays a :class:`~repro_torch.serving.traces.Trace` against

* an exact host-side mirror of the shared pool's block accounting
  (:class:`SimPool` — prefill, fork refcounts, fresh/COW/in-place
  appends, frees, growth via the same
  :func:`repro_torch.core.pool.next_capacity`, compaction), and
* a :class:`CostModel` for the *times* the accounting cannot derive —
  per-tick decode, prefill, grow/compact traffic — priced analytically
  from :mod:`repro_torch.roofline` for the H100, or calibrated from a
  recorded :class:`~repro_torch.serving.scheduler.SchedulerEventLog`.

The contract (``tests/test_torch_sim.py``; ``chip_smoke.py`` phase 13 on
the card): on a recorded trace, the simulator is **decision-exact** — it
reproduces the real run's decision sequence (admit/resume/grow/preempt/
complete/compact and the per-tick pool occupancy) tuple for tuple, and its
peak block count bit for bit.  Decisions are exact up to the first pool
OOM (a regime the admission policy exists to prevent; after it the real
pool's table corruption is not modeled).  Token *values*, logits, and the
token-trace store are out of scope — they never feed back into a decision.

The port's simulator is also bit-equal to the reference's on the same
trace and cost numbers.  ``CostModel.from_traced`` is the counterpart of
the reference's ``CostModel.from_hlo``: it prices a tick from the
engine's own decode step, traced (``repro_torch.distributed.costs``).
"""


from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import pool as pool_lib
from repro_torch.roofline.analysis import (
    H100_SXM,
    Hardware,
    model_bytes_for,
    model_flops_for,
)
from repro_torch.roofline.write_path import compact_cost, grow_cost
from repro_torch.serving import faults as faults_lib
from repro_torch.serving.faults import (
    AllReplicasSaturated,
    DeviceLost,
    FaultInjector,
    FaultKind,
    FaultRetriesExhausted,
    RequestStatus,
    RetryPolicy,
)
from repro_torch.serving.kv_cache import KVCacheConfig
from repro_torch.serving.scheduler import (
    AdmissionRefused,
    PreemptPolicy,
    SchedulerEventLog,
    SchedulerStats,
    SlotTable,
    resolve_preempt_policy,
)
from repro_torch.serving.traces import Trace, TraceRequest

__all__ = [
    "CostModel",
    "SimPool",
    "SimResult",
    "SimScheduler",
    "first_divergence",
    "simulate",
    "simulate_router",
]


def _dtype_bytes(name: str) -> int:
    if name in ("bfloat16", "float16"):
        return 2
    return int(np.dtype(name).itemsize)


def _block_bytes(cfg: KVCacheConfig) -> int:
    return (
        cfg.n_layers
        * 2
        * cfg.block_size
        * cfg.n_kv_heads
        * cfg.head_dim
        * _dtype_bytes(cfg.dtype)
    )


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Seconds per simulated event.  The decode step is one fixed-shape
    call over all ``max_seqs`` slots (masked rows still compute), so
    ``step_s`` is a constant per tick — which is also why a model
    calibrated on one arrival pattern transfers to another."""

    step_s: float
    prefill_s: float
    grow_s_per_block: float
    compact_s_per_block: float

    @classmethod
    def from_roofline(
        cls,
        model_cfg,
        cache_cfg: KVCacheConfig,
        *,
        plen: int = 64,
        hw: Hardware = H100_SXM,
    ) -> "CostModel":
        """Analytic costs for capacity planning on target hardware (the
        H100 by default): each term is the max of its compute and HBM
        roofline times (``roofline/analysis.py``), growth/compaction
        priced by the write path's traffic model
        (``roofline/write_path.py``)."""
        batch = cache_cfg.max_seqs
        seq = cache_cfg.max_blocks_per_seq * cache_cfg.block_size
        step = max(
            model_flops_for(model_cfg, "decode", batch, seq) / hw.peak_flops,
            model_bytes_for(model_cfg, "decode", batch, seq) / hw.hbm_bw,
        )
        prefill = max(
            model_flops_for(model_cfg, "prefill", 1, plen) / hw.peak_flops,
            model_bytes_for(model_cfg, "prefill", 1, plen) / hw.hbm_bw,
        )
        bb = _block_bytes(cache_cfg)
        grow_b = grow_cost(old_blocks=1, block_bytes=bb).bytes / hw.hbm_bw
        comp_b = (
            compact_cost(live=1, num_blocks=1, table_entries=0, block_bytes=bb).bytes
            / hw.hbm_bw
        )
        return cls(
            step_s=step,
            prefill_s=prefill,
            grow_s_per_block=grow_b,
            compact_s_per_block=comp_b,
        )

    @classmethod
    def from_traced(cls, engine, base: "CostModel", *, hw: Hardware = H100_SXM) -> "CostModel":
        """Price the decode tick from the engine's own decode step, traced
        on fake tensors with the card's routing
        (:func:`repro_torch.distributed.costs.trace_per_rank`): the larger
        of its FLOPs over the peak rate and its bytes over the HBM rate,
        one card's program as the scheduler runs it.  Falls back to
        ``base`` when the step does not trace (the counterpart of the
        reference's ``from_hlo``, ``serving/sim.py:176-209`` of the JAX
        package, which has no caller there either)."""
        import torch

        from repro_torch.distributed.costs import traced_costs
        from repro_torch.serving.engine import _decode_step

        n = engine.cache_cfg.max_seqs
        dev = engine.cache.lengths.device
        tokens = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        mask = torch.zeros((n,), dtype=torch.bool, device=dev)
        cfg, ccfg = engine.lm.cfg, engine.cache_cfg

        def step(params, cache, tokens, mask):
            return _decode_step(cfg, ccfg, params, cache, tokens, mask)

        try:
            costs = traced_costs(step, (engine.params, engine.cache, tokens, mask), None, None)
        except Exception:
            return base
        flops, byts = float(costs["flops"]), float(costs["bytes"])
        if flops <= 0.0 and byts <= 0.0:
            return base
        return dataclasses.replace(base, step_s=max(flops / hw.peak_flops, byts / hw.hbm_bw))

    @classmethod
    def from_event_log(cls, log: SchedulerEventLog) -> "CostModel":
        """Calibrate from a recorded run's measured wall times (means —
        the consistent estimator for the summed device-path wall the
        ±25% gate compares against; the fixed-shape step keeps
        warm tick walls tight enough that skew robustness isn't worth
        the systematic under-prediction a median buys).  Growth cost is
        amortized over the relocated blocks; segments the log never saw
        fall back to fractions of the step time."""
        step = statistics.fmean(log.step_wall_s) if log.step_wall_s else 1e-3
        prefill = (
            statistics.fmean(log.prefill_wall_s) if log.prefill_wall_s else step
        )
        relocated = sum(log.grow_old_blocks)
        grow_b = (sum(log.grow_wall_s) / relocated if relocated else 0.01 * step)
        return cls(
            step_s=step,
            prefill_s=prefill,
            grow_s_per_block=grow_b,
            compact_s_per_block=grow_b,
        )


class SimPool:
    """Exact counter model of the shared page pool: refcounts per block,
    live/free totals, growth/compaction of capacity.  Block ids are
    abstract (monotonic) — admission and preemption read only *counts*,
    and the free stack's LIFO order never reaches a decision."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self.ref: Dict[int, int] = {}
        self._next = 0
        self.used = 0
        self.peak = 0
        self.min_free = num_blocks
        self.oom = False

    @property
    def free(self) -> int:
        return self.num_blocks - self.used

    def alloc(self) -> int:
        """One committed block, or -1 + sticky oom on an empty pool
        (mirrors ``pool.alloc``'s NULL grant)."""
        if self.free <= 0:
            self.oom = True
            return -1
        bid = self._next
        self._next += 1
        self.ref[bid] = 1
        self.used += 1
        self.peak = max(self.peak, self.used)
        self.min_free = min(self.min_free, self.free)
        return bid

    def add_ref(self, bid: int, k: int = 1) -> None:
        if bid >= 0 and k:
            self.ref[bid] += k

    def sub_ref(self, bid: int, k: int = 1) -> None:
        if bid < 0 or not k:
            return
        self.ref[bid] -= k
        assert self.ref[bid] >= 0, "refcount went negative"
        if self.ref[bid] == 0:
            del self.ref[bid]
            self.used -= 1

    def grow(self, new_num_blocks: int) -> None:
        self.num_blocks = new_num_blocks

    def compact(self, new_num_blocks: Optional[int]) -> None:
        if new_num_blocks is not None:
            assert new_num_blocks >= self.used, "compact below live set"
            self.num_blocks = new_num_blocks
            self.min_free = min(self.min_free, self.free)


class _SimReq:
    """Simulator-side request state; mirrors ``scheduler._ReqState``
    field-for-field where a decision can read it (``on_boundary`` hooks
    poke at ``t_done``/``req.rid``, tests reuse the same hook object
    against both schedulers)."""

    def __init__(self, req: TraceRequest):
        self.req = req
        self.lo: Optional[int] = None
        self.t_done = 0
        self.started = False  # mirrors `trace is not None`
        self.tables: Optional[List[List[int]]] = None
        self.length = 0
        self.preemptions = 0
        self.status = RequestStatus.OK.value
        self.arrival_s: Optional[float] = None
        self.arrival_tick: Optional[int] = None
        self.admit_s: Optional[float] = None
        self.admit_tick: Optional[int] = None
        self.done_s: Optional[float] = None
        self.done_tick: Optional[int] = None

    @property
    def n(self) -> int:
        return self.req.n_particles

    @property
    def done(self) -> bool:
        return self.t_done >= self.req.steps

    def prefill_blocks(self, bs: int) -> int:
        return -(-self.req.plen // bs)


@dataclasses.dataclass
class SimResult:
    """What a simulated schedule produced: the decision sequence (the
    differential oracle's half of the comparison), block accounting
    outcomes, and the modeled serving metrics."""

    trace_name: str
    decisions: List[tuple]
    stats: SchedulerStats
    peak_blocks: int  # max pool occupancy sampled at decode ticks
    pool_peak: int  # absolute max (incl. mid-boundary transients)
    num_blocks: int  # final capacity
    grow_events: int
    min_free: int
    oom: bool
    sim_time_s: float
    tokens: int
    requests: Dict[str, dict]

    @property
    def tokens_per_sec(self) -> float:
        return self.tokens / self.sim_time_s if self.sim_time_s > 0 else 0.0

    def _latencies(self, key: str) -> List[float]:
        out = []
        for spec in self.requests.values():
            if spec[key] is not None and spec["arrival_s"] is not None:
                out.append(spec[key] - spec["arrival_s"])
        return out

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p99 of queueing (arrival -> first admission) and
        completion (arrival -> departure) latency, in modeled seconds."""
        out = {}
        for label, key in (("queue", "admit_s"), ("completion", "done_s")):
            lat = self._latencies(key)
            for p in (50, 99):
                out[f"{label}_p{p}_s"] = (
                    float(np.percentile(lat, p)) if lat else float("nan")
                )
        return out

    def latency_ticks(self) -> Dict[str, float]:
        """Tick-based p50/p99 latencies, measured from the request's
        *declared* arrival (``arrive_at``) like the real scheduler's
        :meth:`SchedulerEventLog.latency_ticks` — the two must agree
        exactly on a decision-exact replay, which is what lets the
        bench gate latency deterministically across machines."""
        out: Dict[str, float] = {}
        for label, key in (("queue", "admit_tick"), ("completion", "done_tick")):
            lat = [
                spec[key] - spec["arrive_at"]
                for spec in self.requests.values()
                if spec.get(key) is not None
            ]
            for p in (50, 99):
                out[f"{label}_p{p}"] = (
                    float(np.percentile(lat, p)) if lat else float("nan")
                )
        return out


class SimScheduler:
    """The model of :class:`~repro_torch.serving.scheduler.Scheduler`:
    same slot table (the real class), same admission/growth/preemption
    arithmetic (mirrored statement for statement against the same
    ``next_capacity`` policy), with the decode replaced by exact block
    accounting plus a :class:`CostModel` clock.

    This is deliberately an *independent implementation*, not a shared
    code path: the differential tests are only an oracle because the
    two can disagree.
    """

    def __init__(
        self,
        cache_cfg: KVCacheConfig,
        cost: CostModel,
        *,
        grow: bool = True,
        grow_factor: float = 2.0,
        watermark: float = 1.0,
        admission_margin: float = 1.0,
        preempt_margin: float = 1.0,
        strict_admission: bool = True,
        shrink_on_complete: bool = False,
        on_boundary: Optional[Callable[["SimScheduler"], None]] = None,
        initial_blocks: Optional[int] = None,
        faults: Optional[FaultInjector] = None,
        retry_policy: Optional[RetryPolicy] = None,
        admission: str = "fifo",
        queue_limit: Optional[int] = None,
        preempt_policy=None,
    ):
        if admission not in ("fifo", "shed"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.cache_cfg = cache_cfg
        self.cost = cost
        self.grow = grow
        self.grow_factor = grow_factor
        self.watermark = watermark
        self.admission_margin = admission_margin
        self.preempt_margin = preempt_margin
        self.strict_admission = strict_admission
        self.shrink_on_complete = shrink_on_complete
        self.on_boundary = on_boundary
        # The fault model, decision-mirrored: hand this
        # a fresh injector over the *same schedule* the real run
        # consumed (the real scheduler's quarantine must be on — the
        # sim models poison detection as always succeeding).
        self.faults = faults
        self.retry_policy = retry_policy or RetryPolicy()
        self.admission = admission
        self.queue_limit = queue_limit
        # The same policy object (or registry name) the real scheduler
        # takes — `_SimReq` exposes the same fields `select` reads, so
        # preemption decisions mirror per policy.
        self.preempt_policy: PreemptPolicy = resolve_preempt_policy(preempt_policy)
        self.slots = SlotTable(cache_cfg.max_seqs)
        # initial_blocks overrides the config's fresh-pool size — replay
        # against an engine whose pool already grew (a warm recording).
        self.pool = SimPool(
            cache_cfg.pool_blocks if initial_blocks is None else initial_blocks
        )
        self.cap = cache_cfg.pool_blocks_cap
        self.stats = SchedulerStats()
        self.decisions: List[tuple] = []
        self.grow_events = 0
        self._queue: List[_SimReq] = []
        self._active: List[_SimReq] = []
        self._done: Dict[str, _SimReq] = {}
        self.tick = 0
        self.time = 0.0

    # -- public API ----------------------------------------------------------

    def submit(self, req: TraceRequest) -> None:
        live = {s.req.rid for s in self._queue + self._active}
        if req.rid in live or req.rid in self._done:
            raise ValueError(f"duplicate request id {req.rid!r}")
        self._queue.append(_SimReq(req))

    def run(self) -> SimResult:
        while self.step():
            pass
        return self.result()

    def step(self) -> bool:
        """One boundary + one modeled decode tick; mirrors
        :meth:`Scheduler.step` so a router can interleave simulated
        replicas exactly like real ones."""
        if not (self._queue or self._active):
            return False
        self._boundary()
        self._token_step()
        return bool(self._queue or self._active)

    def result(self) -> SimResult:
        """The schedule's outcome so far (complete once :meth:`run`
        returns or :meth:`step` goes False)."""
        # t_done == steps for completed requests; terminated ones
        # contribute their completed prefix.
        tokens = sum(s.req.n_particles * s.t_done for s in self._done.values())
        return SimResult(
            trace_name="",
            decisions=self.decisions,
            stats=self.stats,
            peak_blocks=max(
                (e[3] for e in self.decisions if e[0] == "step"), default=0
            ),
            pool_peak=self.pool.peak,
            num_blocks=self.pool.num_blocks,
            grow_events=self.grow_events,
            min_free=self.pool.min_free,
            oom=self.pool.oom,
            sim_time_s=self.time,
            tokens=tokens,
            requests={
                rid: {
                    "arrival_s": s.arrival_s,
                    "admit_s": s.admit_s,
                    "done_s": s.done_s,
                    "arrive_at": s.req.arrive_at,
                    "arrival_tick": s.arrival_tick,
                    "admit_tick": s.admit_tick,
                    "done_tick": s.done_tick,
                    "preemptions": s.preemptions,
                    "status": s.status,
                }
                for rid, s in self._done.items()
            },
        )

    # -- the router's placement protocol (mirrors Scheduler's) ---------------

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    @property
    def free_slots(self) -> int:
        return self.slots.free_slots

    @property
    def max_seqs(self) -> int:
        return self.cache_cfg.max_seqs

    @property
    def block_size(self) -> int:
        return self.cache_cfg.block_size

    @property
    def free_blocks(self) -> int:
        return self.pool.free

    @property
    def num_blocks(self) -> int:
        return self.pool.num_blocks

    @property
    def blocks_cap(self) -> int:
        return self.cap

    @property
    def active_particles(self) -> int:
        return sum(s.n for s in self._active)

    @property
    def load_particles(self) -> int:
        """Active plus queued particles (the router's load metric —
        mirrors ``Scheduler.load_particles``)."""
        return self.active_particles + sum(s.n for s in self._queue)

    @property
    def results(self) -> Dict[str, "_SimReq"]:
        """Finalized requests in completion order (the router collects
        per-replica completions from here, like `Scheduler.results`)."""
        return self._done

    def preempt(self, rid: str) -> None:
        for s in self._active:
            if s.req.rid == rid:
                self._preempt(s)
                return
        raise KeyError(f"request {rid!r} is not active")

    def cancel(self, rid: str) -> None:
        for s in self._active + self._queue:
            if s.req.rid == rid:
                self._terminate(s, RequestStatus.CANCELLED, "cancel")
                return
        raise KeyError(f"request {rid!r} is not live")

    def compact(self, new_num_blocks: Optional[int] = None) -> None:
        # SimPool is the mutable cost model, not the functional pool API.
        self.pool.compact(new_num_blocks)  # repro-lint: disable=unthreaded-pool
        self.time += self.cost.compact_s_per_block * self.pool.used
        self.stats.compactions += 1
        self.decisions.append(("compact", self.tick, self.pool.num_blocks))

    # -- accounting ----------------------------------------------------------

    def _ensure(self, need: int) -> None:
        """Mirror of ``PopulationExecutor.ensure`` over the scheduler's
        ``_kv_view`` (same ``next_capacity`` arithmetic, same logging
        point inside ``grow_to``)."""
        if need <= 0:
            return
        nb = self.pool.num_blocks
        if nb >= self.cap:
            return
        free = self.pool.free
        if free >= need:
            return
        new = pool_lib.next_capacity(nb, need - free, self.cap, self.grow_factor)
        # SimPool is the mutable cost model, not the functional pool API.
        self.pool.grow(new)  # repro-lint: disable=unthreaded-pool
        self.time += self.cost.grow_s_per_block * nb
        self.decisions.append(("grow", self.tick, new))
        self.grow_events += 1

    def _join_demand(self, s: _SimReq) -> int:
        bs = self.cache_cfg.block_size
        demand = s.prefill_blocks(bs) + s.n
        if s.t_done > 0:
            plen = s.req.plen
            demand += s.n * (-(-(plen + s.t_done) // bs) - plen // bs)
        return demand

    def _fork(self, s: _SimReq, anc: Tuple[int, ...]) -> None:
        """``fork_slots``: new tables gathered through the ancestors;
        refs added for the new references, then dropped for the old —
        lineages no ancestor chose free their divergent tails."""
        new_tables = [list(s.tables[a]) for a in anc]
        adds: Dict[int, int] = {}
        for tbl in new_tables:
            for b in tbl:
                adds[b] = adds.get(b, 0) + 1
        for b, k in adds.items():
            self.pool.add_ref(b, k)
        for tbl in s.tables:
            for b in tbl:
                self.pool.sub_ref(b)
        s.tables = new_tables

    def _append_union(self, states: List[_SimReq]) -> None:
        """One decode tick's ``ensure_writable`` over the union of the
        active slot ranges: two-phase (plan against the pre-step
        refcount snapshot, then allocate-before-release) exactly like
        the batched kernel; grants follow global row order (the
        rank-compacted allocator's order)."""
        plans = []  # (row, table, idx, cow_source | None)
        for s in states:
            idx = s.length // self.cache_cfg.block_size
            for i, tbl in enumerate(s.tables):
                if idx >= len(tbl) or tbl[idx] < 0:
                    plans.append((s.lo + i, tbl, idx, None))
                elif self.pool.ref[tbl[idx]] > 1:
                    plans.append((s.lo + i, tbl, idx, tbl[idx]))
        plans.sort(key=lambda p: p[0])
        releases = []
        for _, tbl, idx, cow_src in plans:
            bid = self.pool.alloc()
            if bid < 0:
                continue  # post-oom: real tables corrupt; not modeled
            while len(tbl) <= idx:
                tbl.append(-1)
            tbl[idx] = bid
            if cow_src is not None:
                releases.append(cow_src)
        for b in releases:
            self.pool.sub_ref(b)
        for s in states:
            s.length += 1

    def _free_pages(self, s: _SimReq) -> None:
        for tbl in s.tables:
            for b in tbl:
                self.pool.sub_ref(b)
        s.tables = None
        s.length = 0

    # -- admission -----------------------------------------------------------

    def _stamp_arrivals(self) -> None:
        for s in self._queue:
            if s.arrival_s is None and s.req.arrive_at <= self.tick:
                s.arrival_s = self.time
                s.arrival_tick = self.tick

    def _admit_ready(self) -> None:
        while self._queue:
            s = self._queue[0]
            if s.req.arrive_at > self.tick:
                if self._active:
                    break
                # idle fast-forward: ticks pass on the step_s clock grid
                self.time += (s.req.arrive_at - self.tick) * self.cost.step_s
                self.tick = s.req.arrive_at
                self._stamp_arrivals()
            if self._expired(s):
                self._terminate(s, RequestStatus.EXPIRED, "expired")
                continue
            lo = self.slots.alloc(s.n)
            if lo is None:
                if not self._active:
                    self.decisions.append(
                        (
                            "refused",
                            s.req.rid,
                            self.tick,
                            "slots",
                            s.n - self.slots.free_slots,
                        )
                    )
                    raise AdmissionRefused(
                        f"request {s.req.rid!r} needs {s.n} slots; "
                        f"{self.slots.free_slots} of {self.slots.capacity} free",
                        rid=s.req.rid,
                        resource="slots",
                        needed=s.n,
                        available=self.slots.free_slots,
                    )
                break
            demand = self._join_demand(s) + math.ceil(
                self.admission_margin * sum(a.n for a in self._active)
            )
            if self.grow:
                self._ensure(demand)
            if self.strict_admission and self.pool.free < demand:
                resuming = s.started
                if resuming and not self._active:
                    pass  # last-resort resume, mirroring the scheduler
                else:
                    self.slots.free(lo, s.n)
                    if not self._active:
                        self.decisions.append(
                            (
                                "refused",
                                s.req.rid,
                                self.tick,
                                "blocks",
                                demand - self.pool.free,
                            )
                        )
                        raise AdmissionRefused(
                            f"request {s.req.rid!r} needs {demand} pages; "
                            f"pool has {self.pool.free} free of "
                            f"{self.pool.num_blocks} (cap {self.cap})",
                            rid=s.req.rid,
                            resource="blocks",
                            needed=demand,
                            available=self.pool.free,
                        )
                    break
            self._queue.pop(0)
            kind = "resume" if s.started else "admit"
            self.decisions.append((kind, s.req.rid, self.tick, lo))
            self._place(s, lo)
            self._active.append(s)
            if s.done:
                self._finalize(s)

    def _place(self, s: _SimReq, lo: int) -> None:
        s.lo = lo
        resuming = s.t_done > 0 or s.started
        if not resuming:
            s.started = True
            self.stats.admitted += 1
            s.admit_s = self.time
            s.admit_tick = self.tick
        else:
            self.stats.resumes += 1
        # prefill once, then fork across the range: nb blocks, each
        # referenced by all n particles.
        blocks = [self.pool.alloc() for _ in range(s.prefill_blocks(
            self.cache_cfg.block_size
        ))]
        for b in blocks:
            self.pool.add_ref(b, s.n - 1)
        s.tables = [list(blocks) for _ in range(s.n)]
        s.length = s.req.plen
        self.time += self.cost.prefill_s
        if resuming:
            self._replay(s)

    # -- preemption / resume -------------------------------------------------

    def _preempt(self, s: _SimReq) -> None:
        self.decisions.append(("preempt", s.req.rid, self.tick))
        self._free_pages(s)
        self.slots.free(s.lo, s.n)
        self._active.remove(s)
        s.lo = None
        s.preemptions += 1
        self.stats.preemptions += 1
        self._queue.insert(0, s)

    def _replay(self, s: _SimReq) -> None:
        forks = s.req.forks or {}
        for t in range(s.t_done):
            if self.grow:
                self._ensure(s.n)
            anc = forks.get(t)
            if anc is not None:
                self._fork(s, anc)
            self._append_union([s])
            self.stats.replayed_tokens += 1
            self.time += self.cost.step_s

    # -- typed terminations (mirror of the real scheduler's) ------------------

    def _expired(self, s: _SimReq) -> bool:
        return s.req.deadline is not None and self.tick >= s.req.deadline

    def _expire_deadlines(self) -> None:
        for s in [a for a in self._active if self._expired(a)]:
            self._terminate(s, RequestStatus.EXPIRED, "expired")
        for s in [q for q in self._queue if self._expired(q)]:
            self._terminate(s, RequestStatus.EXPIRED, "expired")

    def _shed_overflow(self) -> None:
        if self.admission != "shed" or self.queue_limit is None:
            return
        waiting = [
            s
            for s in self._queue
            if not s.started and s.req.arrive_at <= self.tick
        ]
        for s in waiting[self.queue_limit :]:
            self._terminate(s, RequestStatus.SHED, "shed")

    def _terminate(self, s: _SimReq, status: RequestStatus, event: str) -> None:
        self.decisions.append((event, s.req.rid, self.tick))
        setattr(self.stats, status.value, getattr(self.stats, status.value) + 1)
        self._finalize(s, status=status)

    # -- the boundary + one token step ---------------------------------------

    def _boundary(self) -> None:
        if self.on_boundary is not None:
            self.on_boundary(self)
        self._stamp_arrivals()
        self._expire_deadlines()
        self._admit_ready()
        # Shed AFTER admission, like the real scheduler: the queue
        # bound applies to requests that actually have to wait.
        self._shed_overflow()
        need = sum(s.n for s in self._active)
        if need == 0:
            return
        if self.grow:
            self._ensure(math.ceil(self.watermark * need))
        while (
            self.pool.free < math.ceil(self.preempt_margin * need)
            and len(self._active) > 1
        ):
            self._preempt(self.preempt_policy.select(self._active, self.tick))
            need = sum(s.n for s in self._active)

    def _token_step(self) -> None:
        if not self._active:
            if self._queue:
                # Mirror of the real scheduler's anti-spin surface: a
                # tick with waiters and no admitted work would change
                # nothing, forever.
                rids = tuple(s.req.rid for s in self._queue)
                self.decisions.append(("saturated", self.tick, rids))
                raise AllReplicasSaturated(
                    f"tick {self.tick}: {len(rids)} request(s) waiting "
                    "but none admitted and no active request remains",
                    tick=self.tick,
                    rids=rids,
                )
            self.tick += 1
            return
        # Fault-model mirror: consume the schedule per
        # decode attempt, exactly like the real recovery loop — fault
        # tuples per attempt, a retry tuple per rollback, the step
        # tuple only for the surviving attempt.  The rollback itself is
        # a no-op here (the accounting below hasn't run yet); only the
        # decision stream and the clock need modeling.
        attempt = 0
        while True:
            events = self.faults.step_events(self.tick) if self.faults else []
            for ev in events:
                self.stats.faults += 1
                self.decisions.append(faults_lib.fault_tuple(ev, self.tick))
                if ev.kind is FaultKind.DEVICE_LOSS:
                    raise DeviceLost(f"device lost at tick {self.tick}")
                if ev.kind is FaultKind.LATENCY:
                    self.time += ev.delay_s
            failing = any(
                ev.kind in (FaultKind.STEP_FAILURE, FaultKind.OOM) for ev in events
            )
            if not failing:
                break
            self.time += self.cost.step_s  # the discarded attempt's decode
            attempt += 1
            if attempt > self.retry_policy.max_retries:
                raise FaultRetriesExhausted(
                    f"tick {self.tick} failed {attempt} times "
                    f"(max_retries={self.retry_policy.max_retries})",
                    tick=self.tick,
                    attempts=attempt,
                )
            self.stats.retries += 1
            self.decisions.append(("retry", self.tick, attempt))
            self.time += self.retry_policy.delay_s(attempt)
        poison = {ev.rid for ev in events if ev.kind is FaultKind.NAN_LOGITS}
        for s in self._active:
            anc = (s.req.forks or {}).get(s.t_done)
            if anc is not None:
                self._fork(s, anc)
        self._append_union(self._active)
        used = self.pool.used
        self.decisions.append(
            ("step", self.tick, tuple(s.req.rid for s in self._active), used)
        )
        for s in self._active:
            s.t_done += 1
        self.tick += 1
        self.stats.ticks += 1
        self.time += self.cost.step_s
        for s in [a for a in self._active if a.done]:
            self._finalize(s)
        for s in [a for a in self._active if a.req.rid in poison]:
            self._terminate(s, RequestStatus.POISONED, "poisoned")

    # -- completion ----------------------------------------------------------

    def _finalize(
        self, s: _SimReq, status: RequestStatus = RequestStatus.OK
    ) -> None:
        ok = status is RequestStatus.OK
        if ok:
            self.decisions.append(("complete", s.req.rid, self.tick))
        if s.tables is not None:
            self._free_pages(s)
        if s.lo is not None:
            self.slots.free(s.lo, s.n)
        if s in self._active:
            self._active.remove(s)
        if s in self._queue:
            self._queue.remove(s)
        s.lo = None
        s.status = status.value
        s.done_s = self.time
        s.done_tick = self.tick
        self._done[s.req.rid] = s
        if ok:
            self.stats.completed += 1
        if self.shrink_on_complete and self._active:
            live = self.pool.used
            floor = 2 * sum(a.n for a in self._active)
            target = max(-(-live * 5 // 4), live + floor, 16)
            if target < self.pool.num_blocks:
                self.compact(target)


def simulate(
    trace: Trace,
    cache_cfg: KVCacheConfig,
    cost: CostModel,
    **knobs,
) -> SimResult:
    """Run a trace through a fresh :class:`SimScheduler`; ``knobs`` are
    the scheduler's policy arguments (grow, watermark, margins, ...)."""
    sched = SimScheduler(cache_cfg, cost, **knobs)
    for r in trace.requests:
        sched.submit(r)
    res = sched.run()
    res.trace_name = trace.name
    return res


def simulate_router(
    trace: Trace,
    cache_cfg: KVCacheConfig,
    cost: CostModel,
    *,
    n_replicas: int = 2,
    placement="least_loaded",
    **knobs,
):
    """Run a trace through a fleet of ``n_replicas`` fresh
    :class:`SimScheduler`\\ s behind the *same*
    :class:`~repro_torch.serving.router.Router` class that drives real
    schedulers (it only speaks the shared placement protocol), and
    return the router.  Callers inspect ``router.event_log`` (fleet
    placement decisions, compared tuple-for-tuple against a real
    fleet's), ``router.results``, and each
    ``router.replicas[i].scheduler`` for per-replica decision logs and
    stats — the replicated-serving differential oracle."""
    from repro_torch.serving.router import Router, RouterEventLog

    scheds = [SimScheduler(cache_cfg, cost, **knobs) for _ in range(n_replicas)]
    router = Router(scheds, placement=placement, event_log=RouterEventLog())
    for r in trace.requests:
        router.submit(r)
    router.run()
    return router


def first_divergence(real: List[tuple], sim: List[tuple]) -> Optional[str]:
    """First index where two decision sequences disagree (None when
    decision-exact) — the differential test's error message."""
    for i, (a, b) in enumerate(zip(real, sim, strict=False)):
        if tuple(a) != tuple(b):
            return f"event {i}: real={a!r} sim={b!r}"
    if len(real) != len(sim):
        longer, tag = (real, "real") if len(real) > len(sim) else (sim, "sim")
        i = min(len(real), len(sim))
        return f"event {i}: only {tag} continues with {longer[i]!r}"
    return None
