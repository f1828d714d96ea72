"""Continuous-batching SMC serving scheduler over one shared COW pool, in
PyTorch (the port of ``repro.serving.scheduler``).

Many concurrent requests — each its own SMC population with its own
prompt, particle count and step budget — compete for one
:class:`~repro_torch.serving.kv_cache.PagedKVCache` page pool and one
decode step:

* **Packed slot table.**  ``max_seqs`` is a capacity: each request gets a
  contiguous slot range of the one decode batch, forks/frees per range,
  and every token step is one decode over the union of active slots.
* **Admission is free-block accounting.**  A request joins only when the
  pool can absorb its prefill plus one worst-case token; refusal on a
  full pool surfaces (:class:`AdmissionRefused`), never a silent drop.
* **Join/leave at token boundaries**, in the executor's ``boundary`` hook.
* **Pressure: grow first, preempt second.**  A preempted request's pages
  are freed; its token history stays in its token-trace store plus a
  host-side replay log, and resumption re-prefills the prompt and replays
  the recorded tokens and forks through the same decode step, so it
  finishes bit-exactly like an uninterrupted run.

It is also the recovery layer: every tick runs inside a rollback-retry
loop; non-finite logits quarantine their request; deadlines, cancel and
the ``shed`` admission policy end requests with typed statuses; and
:meth:`Scheduler.checkpoint`/:meth:`Scheduler.restore` serialize the
whole mid-run state for a bit-exact resume in a fresh process.  Fault
schedules come from :mod:`repro_torch.serving.faults`.

Differences from the reference, where the port writes in place and draws
from stateful generators:

* A request carries a generator (``DecodeRequest.gen``: a
  ``torch.Generator`` or a :class:`~repro_torch.random.Replay`), not a
  key.  ``submit`` takes a copy at its position, so a request can be
  submitted again and draws the same stream.
* The rollback snapshot copies what a tick writes in place: every leaf of
  the KV cache (its payload is written in place by the COW copy, the K/V
  writes and prefill), each active request's token-trace store and its
  generator.  The reference captures references to immutable arrays.
  The copy is the whole pool payload, taken on every tick of a scheduler
  with a ``faults`` injector (only an injected fault fails a tick), and
  on none without one.
* The checkpoint holds the pool as numpy (a bfloat16 payload widened to
  float32, which is lossless) and each generator's position
  (:func:`repro_torch.random.state`); :meth:`Scheduler.restore` casts the
  payload back to the cache's dtype.

:meth:`SchedulerEventLog.to_trace` gives the recorded run as a trace that
:mod:`repro_torch.serving.sim` replays decision-exactly.
"""

from __future__ import annotations

import dataclasses
import math
import pickle
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import convert
from repro_torch import random as rnd
from repro_torch.core import pool as pool_lib
from repro_torch.core.config import CopyMode
from repro_torch.models.layers import torch_dtype
from repro_torch.serving import faults as faults_lib
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.faults import (
    AllReplicasSaturated,
    DeviceLost,
    FaultInjector,
    FaultKind,
    FaultRetriesExhausted,
    RequestStatus,
    RetryPolicy,
    TransientStepFailure,
)
from repro_torch.serving.smc_decode import SMCDecodeResult, _TokenTrace, smc_token_update
from repro_torch.smc import executor as executor_lib

__all__ = [
    "AdmissionRefused",
    "AllReplicasSaturated",
    "DecodeRequest",
    "LongestWait",
    "NewestFirst",
    "PREEMPT_POLICIES",
    "PreemptPolicy",
    "RequestStatus",
    "RetryPolicy",
    "Scheduler",
    "SchedulerEventLog",
    "SchedulerStats",
    "SlaAware",
    "SlotTable",
    "TokenEvent",
    "TUNED_DEFAULTS",
    "load_checkpoint",
    "resolve_preempt_policy",
    "save_checkpoint",
    "stream_tokens",
]

# The reference's knob values from its simulator sweep; opt in with
# ``Scheduler(engine, **TUNED_DEFAULTS)``.
TUNED_DEFAULTS = {
    "grow_factor": 1.5,
    "watermark": 1.0,
    "admission_margin": 1.0,
    "preempt_margin": 1.0,
}


class AdmissionRefused(RuntimeError):
    """The pool (or slot table) cannot absorb a request and no progress
    is possible — surfaced loudly instead of dropping the request.

    ``resource`` is ``"slots"`` (decode-batch rows) or ``"blocks"`` (pool
    pages), ``needed``/``available`` the demand and supply at the refusal,
    ``shortfall`` their difference.
    """

    def __init__(
        self,
        msg: str,
        *,
        rid: Optional[str] = None,
        resource: Optional[str] = None,
        needed: Optional[int] = None,
        available: Optional[int] = None,
    ):
        super().__init__(msg)
        self.rid = rid
        self.resource = resource
        self.needed = needed
        self.available = available

    @property
    def shortfall(self) -> Optional[int]:
        if self.needed is None or self.available is None:
            return None
        return self.needed - self.available


# -- pluggable preemption policy ----------------------------------------------


class PreemptPolicy:
    """Chooses the victim when the pressure backstop must evict.

    A policy reads ``req.deadline``, ``req.arrive_at``, ``req.steps``,
    ``t_done`` and ``n``; ``select`` must be deterministic (ties broken by
    batch position) and return one of ``active``.  The backstop
    re-evaluates after each eviction.
    """

    name = "base"

    def select(self, active: Sequence, tick: int):
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class NewestFirst(PreemptPolicy):
    """Evict the most recently admitted request: the oldest keep
    finishing, and a resume goes to the queue front, so there is no
    thrash."""

    name = "newest"

    def select(self, active: Sequence, tick: int):
        return active[-1]


class SlaAware(PreemptPolicy):
    """Evict the request with the most deadline slack —
    ``deadline - tick - remaining_steps``; no deadline is infinite slack;
    ties break newest-first."""

    name = "sla"

    def select(self, active: Sequence, tick: int):
        def slack(item):
            i, s = item
            d = s.req.deadline
            left = s.req.steps - s.t_done
            return (math.inf if d is None else d - tick - left, i)

        return max(enumerate(active), key=slack)[1]


class LongestWait(PreemptPolicy):
    """Protect the request that waited longest: evict the latest arrival
    (ties break newest-first)."""

    name = "longest_wait"

    def select(self, active: Sequence, tick: int):
        return max(enumerate(active), key=lambda it: (it[1].req.arrive_at, it[0]))[1]


PREEMPT_POLICIES = {
    "newest": NewestFirst,
    "sla": SlaAware,
    "longest_wait": LongestWait,
}


def resolve_preempt_policy(policy: Union[str, PreemptPolicy, None]) -> PreemptPolicy:
    """A registry name, a policy instance, or None (the newest-first
    default); unknown names raise."""
    if policy is None:
        return NewestFirst()
    if isinstance(policy, str):
        cls = PREEMPT_POLICIES.get(policy)
        if cls is None:
            raise ValueError(
                f"unknown preempt policy {policy!r} (known: {sorted(PREEMPT_POLICIES)})"
            )
        return cls()
    return policy


# -- per-token streaming -------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One committed decode step of one request, for a streaming consumer
    (``Scheduler(on_token=...)`` / :meth:`Scheduler.stream`).

    ``token`` is the post-resample token vector fed to the decode step
    (``[n] int32``) and ``ancestors`` the resampling ancestors applied just
    before it (None when the step did not resample): together the
    request's replay log, which :func:`stream_tokens` reassembles into
    ``run()``'s token matrix.  Events come only from committed ticks.  The
    last event of a request has ``final=True``, ``token=None`` and the
    terminal status in ``status``."""

    rid: str
    t: int  # step index within the request (== t_done on the final marker)
    token: Optional[np.ndarray]  # [n] int32; None on the final marker
    ancestors: Optional[np.ndarray]  # resample ancestors before this token
    tick: int  # scheduler tick at emission
    final: bool = False
    status: str = "ok"


def stream_tokens(events: Sequence[TokenEvent], *, n: int, steps: int) -> np.ndarray:
    """Reassemble one request's streamed events into the ``[n, steps]``
    token matrix of its result: gather by each event's ancestors, then
    append its token (the token store's lineage semantics); zero-padded
    past the streamed prefix."""
    hist = np.zeros((n, 0), np.int32)
    for ev in events:
        if ev.token is None:
            continue
        if ev.ancestors is not None:
            hist = hist[np.asarray(ev.ancestors)]
        tok = np.asarray(ev.token, np.int32).reshape(n, 1)
        hist = np.concatenate([hist, tok], axis=1)
    if hist.shape[1] < steps:
        pad = np.zeros((n, steps - hist.shape[1]), np.int32)
        hist = np.concatenate([hist, pad], axis=1)
    return hist[:, :steps]


@dataclasses.dataclass(frozen=True)
class DecodeRequest:
    """One SMC-decode request.  ``gen`` is its generator (a
    ``torch.Generator`` or a :class:`~repro_torch.random.Replay`; the
    scheduler draws from a copy).  ``arrive_at`` and ``deadline`` are in
    token-boundary ticks; a request still live at the boundary of tick
    ``deadline`` ends with ``RequestStatus.EXPIRED``."""

    rid: str
    prompt: torch.Tensor  # [plen] int
    n_particles: int
    steps: int
    gen: Any
    target_temp: float = 0.7
    proposal_temp: float = 1.0
    ess_threshold: float = 0.5
    token_copy_mode: CopyMode = CopyMode.LAZY_SR
    token_block_size: Optional[int] = None  # None -> engine block size
    mesh: Optional[Any] = None  # a ShardMesh shards the token-history store
    arrive_at: int = 0
    deadline: Optional[int] = None


class SlotTable:
    """Packed first-fit allocator over the engine's ``max_seqs`` decode
    slots; ranges are freed wholesale."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._ranges: List[tuple] = []  # sorted [(lo, n), ...]

    def alloc(self, n: int) -> Optional[int]:
        """First contiguous gap of ``n`` slots, or None."""
        lo = 0
        for rlo, rn in self._ranges:
            if rlo - lo >= n:
                break
            lo = max(lo, rlo + rn)
        if lo + n > self.capacity:
            return None
        self._ranges.append((lo, n))
        self._ranges.sort()
        return lo

    def free(self, lo: int, n: int) -> None:
        """Release exactly a range :meth:`alloc` returned; a double free or
        an overlapping/partial free raises."""
        if (lo, n) not in self._ranges:
            raise ValueError(
                f"SlotTable.free({lo}, {n}): no such allocated range "
                f"(allocated: {self._ranges}) — double free or overlapping free"
            )
        self._ranges.remove((lo, n))

    @property
    def used(self) -> int:
        return sum(n for _, n in self._ranges)

    @property
    def free_slots(self) -> int:
        return self.capacity - self.used


@dataclasses.dataclass
class SchedulerStats:
    """Host-side telemetry."""

    admitted: int = 0
    completed: int = 0
    preemptions: int = 0
    resumes: int = 0
    replayed_tokens: int = 0
    compactions: int = 0
    ticks: int = 0
    faults: int = 0  # injected fault events fired
    retries: int = 0  # rollback-retried ticks (per attempt)
    cancelled: int = 0
    expired: int = 0
    poisoned: int = 0
    shed: int = 0
    checkpoints: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SchedulerEventLog:
    """The run's decision sequence and per-segment wall times.

    Decision tuples (``tick`` is the scheduler tick at the decision):
    ``("admit"|"resume", rid, tick, lo)``, ``("grow", tick, new_num_blocks)``,
    ``("preempt", rid, tick)``, ``("complete", rid, tick)``,
    ``("compact", tick, new_num_blocks)``,
    ``("refused", rid, tick, resource, shortfall)``,
    ``("step", tick, (rid, ...), used_blocks)``, ``("fault", kind, tick)``
    (``("fault", "nan_logits", tick, rid)``), ``("retry", tick, attempt)``,
    ``("cancel"|"expired"|"shed"|"poisoned", rid, tick)`` and
    ``("saturated", tick, rids)``.  Only the surviving attempt of a
    rolled-back tick keeps its step tuple.
    """

    events: List[tuple] = dataclasses.field(default_factory=list)
    requests: Dict[str, dict] = dataclasses.field(default_factory=dict)
    step_wall_s: List[float] = dataclasses.field(default_factory=list)
    prefill_wall_s: List[float] = dataclasses.field(default_factory=list)
    grow_wall_s: List[float] = dataclasses.field(default_factory=list)
    grow_old_blocks: List[int] = dataclasses.field(default_factory=list)

    def emit(self, *event) -> None:
        self.events.append(tuple(event))

    @property
    def decisions(self) -> List[tuple]:
        return list(self.events)

    def peak_blocks(self) -> int:
        """Peak shared-pool blocks over the recorded decode ticks."""
        used = [e[3] for e in self.events if e[0] == "step"]
        return max(used) if used else 0

    def recorded_wall_s(self) -> float:
        """Decode ticks + prefills + growth relocations, in seconds."""
        return sum(self.step_wall_s) + sum(self.prefill_wall_s) + sum(self.grow_wall_s)

    def latency_ticks(self) -> Dict[str, float]:
        """p50/p99 of queueing (arrival -> first admission) and completion
        (arrival -> terminal event) latency, in scheduler ticks."""
        admit: Dict[str, int] = {}
        done: Dict[str, int] = {}
        for e in self.events:
            if e[0] == "admit":
                admit.setdefault(e[1], e[2])
            elif e[0] in ("complete", "cancel", "expired", "shed", "poisoned"):
                done.setdefault(e[1], e[2])
        out: Dict[str, float] = {}
        for label, stamps in (("queue", admit), ("completion", done)):
            lat = [
                t - self.requests[rid]["arrive_at"]
                for rid, t in stamps.items()
                if rid in self.requests
            ]
            for p in (50, 99):
                out[f"{label}_p{p}"] = float(np.percentile(lat, p)) if lat else float("nan")
        return out

    def record_request(self, req: DecodeRequest) -> None:
        self.requests[req.rid] = {
            "arrive_at": req.arrive_at,
            "n_particles": req.n_particles,
            "steps": req.steps,
            "plen": int(req.prompt.shape[0]),
            "deadline": req.deadline,
            "forks": {},
        }

    def record_forks(self, rid: str, forks: Dict[int, np.ndarray]) -> None:
        self.requests[rid]["forks"] = {
            int(t): tuple(int(a) for a in anc) for t, anc in forks.items()
        }

    def to_trace(self, name: str = "recorded"):
        """The recorded run as a replayable
        :class:`~repro_torch.serving.traces.Trace` (submission order
        preserved; forks as recorded)."""
        from repro_torch.serving import traces as traces_lib

        reqs = tuple(
            traces_lib.TraceRequest(
                rid=rid,
                arrive_at=spec["arrive_at"],
                n_particles=spec["n_particles"],
                steps=spec["steps"],
                plen=spec["plen"],
                deadline=spec.get("deadline"),
                forks=dict(spec["forks"]),
            )
            for rid, spec in self.requests.items()
        )
        return traces_lib.Trace(name=name, requests=reqs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _ReqState:
    """Scheduler-internal request state, from submit to completion;
    survives preemption (``lo`` is None while off the batch)."""

    def __init__(self, req: DecodeRequest, block_size: int, device: torch.device):
        self.req = req
        self.device = device
        self.block_size = req.token_block_size if req.token_block_size else block_size
        self.lo: Optional[int] = None
        self.trace: Optional[_TokenTrace] = None
        self.trace_view: Optional[executor_lib.PoolView] = None
        # The scheduler's own copy: the request itself stays reusable.
        self.gen = rnd.snapshot(req.gen)
        self.logw = torch.full(
            (req.n_particles,), -math.log(req.n_particles), dtype=torch.float32, device=device
        )
        self.logz = torch.zeros((), dtype=torch.float32, device=device)
        self.logits: Optional[torch.Tensor] = None
        self.t_done = 0
        self.ess: List[torch.Tensor] = []
        self.used: List[int] = []
        self.resampled: List[bool] = []
        # Replay log for a bit-exact resume: the token vector fed to the
        # decode at each past step (post-resample), and the ancestors of
        # each resampling event.
        self.fed: List[np.ndarray] = []
        self.forks: Dict[int, np.ndarray] = {}
        # Streaming cursor: fed[t] for t < emitted_t has been delivered.
        self.emitted_t = 0
        self.grew0 = 0
        self.oom0 = False
        self.preemptions = 0

    @property
    def n(self) -> int:
        return self.req.n_particles

    @property
    def done(self) -> bool:
        return self.t_done >= self.req.steps

    def prefill_blocks(self, bs: int) -> int:
        return -(-int(self.req.prompt.shape[0]) // bs)

    def new_trace(self) -> _TokenTrace:
        return _TokenTrace(
            self.n,
            self.req.steps,
            self.req.token_copy_mode,
            self.block_size,
            self.req.mesh,
            device=self.device,
        )


class Scheduler:
    """Multiplex many SMC-decode requests over one engine (one shared COW
    page pool, one decode step per tick).

    ``strict_admission=False`` keeps the single-request decoder's
    semantics: a request that cannot fit is admitted anyway and the sticky
    ``oom`` flag surfaces in its result.  With the default ``True``,
    admission waits for departures and raises :class:`AdmissionRefused`
    when no active request remains to wait for.

    Policy knobs: ``watermark`` (boundary growth when free blocks dip
    under ``ceil(watermark * worst_case_need)``), ``admission_margin``
    (headroom a join must leave for the incumbents) and ``preempt_margin``
    (the backstop preempts while free blocks are under
    ``ceil(preempt_margin * need)`` once growth is exhausted).

    Fault knobs: ``faults`` (a :class:`FaultInjector`), ``retry_policy``,
    ``quarantine`` (end a request whose logits go non-finite),
    ``admission`` (``"fifo"`` or ``"shed"`` with ``queue_limit``) and
    ``watchdog`` (:meth:`check_invariants` at every boundary).

    Serving knobs: ``preempt_policy`` (a :data:`PREEMPT_POLICIES` name or a
    :class:`PreemptPolicy`) and ``on_token`` (a per-token streaming
    callback fed :class:`TokenEvent`\\ s as each tick commits).
    """

    def __init__(
        self,
        engine: ServeEngine,
        *,
        grow: bool = True,
        grow_factor: float = 2.0,
        watermark: float = 1.0,
        admission_margin: float = 1.0,
        preempt_margin: float = 1.0,
        strict_admission: bool = True,
        shrink_on_complete: bool = False,
        executor: Optional[executor_lib.PopulationExecutor] = None,
        on_boundary: Optional[Callable[["Scheduler"], None]] = None,
        event_log: Optional[SchedulerEventLog] = None,
        faults: Optional[FaultInjector] = None,
        retry_policy: Optional[RetryPolicy] = None,
        quarantine: bool = True,
        admission: str = "fifo",
        queue_limit: Optional[int] = None,
        watchdog: bool = False,
        preempt_policy: Union[str, PreemptPolicy, None] = "newest",
        on_token: Optional[Callable[[TokenEvent], None]] = None,
    ):
        if admission not in ("fifo", "shed"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.engine = engine
        self.device = engine.device
        self.grow = grow
        self.grow_factor = grow_factor
        self.watermark = watermark
        self.admission_margin = admission_margin
        self.preempt_margin = preempt_margin
        self.strict_admission = strict_admission
        self.shrink_on_complete = shrink_on_complete
        self.event_log = event_log
        self.faults = faults
        self.retry_policy = retry_policy or RetryPolicy()
        self.quarantine = quarantine
        self.admission = admission
        self.queue_limit = queue_limit
        self.watchdog = watchdog
        self.preempt_policy = resolve_preempt_policy(preempt_policy)
        self.on_token = on_token
        # Leading edge of every token boundary, before admission/growth/
        # preemption (tests force preemption; benches sample occupancy).
        self.on_boundary = on_boundary
        self.slots = SlotTable(engine.cache_cfg.max_seqs)
        self.stats = SchedulerStats()
        # Residual device-sync stall inside committed token steps (s).
        self.sync_wait_s = 0.0
        self._exec = executor if executor is not None else executor_lib.PopulationExecutor()
        self._queue: List[_ReqState] = []  # FIFO; resumes go to the front
        self._active: List[_ReqState] = []  # admission order
        self._results: Dict[str, SMCDecodeResult] = {}
        self._pending_final: List[tuple] = []
        self.tick = 0

    # -- public API ----------------------------------------------------------

    def submit(self, req: DecodeRequest) -> None:
        live = {s.req.rid for s in self._queue + self._active}
        if req.rid in live or req.rid in self._results:
            raise ValueError(f"duplicate request id {req.rid!r}")
        self._queue.append(self._state(req))
        if self.event_log is not None:
            self.event_log.record_request(req)

    def run(self) -> Dict[str, SMCDecodeResult]:
        """Drive every submitted request to completion; returns
        ``{rid: SMCDecodeResult}``."""
        while self.step():
            pass
        if self.watchdog:
            self._run_watchdog()
        return self._results

    def step(self) -> bool:
        """One token boundary plus one decode tick.  Returns True while
        submitted work remains."""
        if not (self._queue or self._active):
            return False
        self._exec.run(
            None,
            n_steps=1,
            chunk_fn=self._token_step,
            policy=executor_lib.GrowthPolicy(
                grow=self.grow, chunk=1, factor=self.grow_factor, retry=False
            ),
            boundary=self._boundary,
            after=self._after_chunk,
        )
        return bool(self._queue or self._active)

    def stream(self) -> Iterator[TokenEvent]:
        """Drive the schedule like :meth:`run`, yielding
        :class:`TokenEvent`\\ s as each tick commits; results are in
        :attr:`results` once exhausted.  An ``on_token`` callback keeps
        firing (the stream tees)."""
        buf: List[TokenEvent] = []
        prev = self.on_token

        def tee(ev: TokenEvent) -> None:
            if prev is not None:
                prev(ev)
            buf.append(ev)

        self.on_token = tee
        try:
            while self.step():
                while buf:
                    yield buf.pop(0)
            while buf:
                yield buf.pop(0)
        finally:
            self.on_token = prev
        if self.watchdog:
            self._run_watchdog()

    @property
    def results(self) -> Dict[str, SMCDecodeResult]:
        return self._results

    @property
    def executor(self) -> executor_lib.PopulationExecutor:
        return self._exec

    # -- placement protocol --------------------------------------------------

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._active)

    @property
    def free_slots(self) -> int:
        return self.slots.free_slots

    @property
    def max_seqs(self) -> int:
        return self.engine.cache_cfg.max_seqs

    @property
    def block_size(self) -> int:
        return self.engine.cache_cfg.block_size

    @property
    def free_blocks(self) -> int:
        return int(self.engine.free_blocks)

    @property
    def num_blocks(self) -> int:
        return int(self.engine.num_blocks)

    @property
    def blocks_cap(self) -> int:
        return self.engine.cache_cfg.pool_blocks_cap

    @property
    def active_particles(self) -> int:
        return sum(s.n for s in self._active)

    @property
    def load_particles(self) -> int:
        """Active plus queued particles."""
        return self.active_particles + sum(s.n for s in self._queue)

    # -- streaming emission (trailing edge) ----------------------------------

    def _after_chunk(self, carry, ts) -> None:
        self._flush_streams()

    def _flush_streams(self) -> None:
        if self.on_token is None:
            self._pending_final.clear()
            return
        for s in self._active:
            self._emit_committed(s)
        for s, status in self._pending_final:
            self._emit_committed(s)
            self.on_token(
                TokenEvent(
                    rid=s.req.rid,
                    t=s.t_done,
                    token=None,
                    ancestors=None,
                    tick=self.tick,
                    final=True,
                    status=status.value,
                )
            )
        self._pending_final.clear()

    def _emit_committed(self, s: _ReqState) -> None:
        while s.emitted_t < s.t_done:
            t = s.emitted_t
            self.on_token(
                TokenEvent(
                    rid=s.req.rid,
                    t=t,
                    token=s.fed[t],
                    ancestors=s.forks.get(t),
                    tick=self.tick,
                )
            )
            s.emitted_t += 1

    def preempt(self, rid: str) -> None:
        """Force-preempt an active request (callable from ``on_boundary``):
        pages freed, token history and SMC state kept."""
        for s in self._active:
            if s.req.rid == rid:
                self._preempt(s)
                return
        raise KeyError(f"request {rid!r} is not active")

    def cancel(self, rid: str) -> None:
        """End a live (queued or active) request with
        ``RequestStatus.CANCELLED``; its completed prefix is surfaced."""
        for s in self._active + self._queue:
            if s.req.rid == rid:
                self._terminate(s, RequestStatus.CANCELLED, "cancel")
                return
        raise KeyError(f"request {rid!r} is not live")

    def compact(self, new_num_blocks: Optional[int] = None) -> None:
        """Densify the shared page pool (optionally shrink-to-fit) at a
        token boundary — observationally invisible."""
        self.engine.compact_cache(new_num_blocks)
        self.stats.compactions += 1
        if self.event_log is not None:
            self.event_log.emit("compact", self.tick, self.engine.num_blocks)

    # -- crash consistency ---------------------------------------------------

    def checkpoint(self) -> dict:
        """The whole mid-run state as a picklable dict of host arrays: the
        KV cache (payload widened to float32 if bfloat16), slot table,
        per-request SMC state, replay logs, token-trace stores and
        generator positions.  Call at a token boundary or between runs;
        :meth:`restore` continues bit-exactly."""
        cfg = self.engine.cache_cfg
        self.stats.checkpoints += 1
        return {
            "version": 1,
            "tick": self.tick,
            "cache_shape": {
                "block_size": cfg.block_size,
                "max_seqs": cfg.max_seqs,
                "max_blocks_per_seq": cfg.max_blocks_per_seq,
            },
            "cache": convert.kv_cache_to_numpy(self.engine.cache),
            "slot_ranges": list(self.slots._ranges),
            "stats": self.stats.as_dict(),
            "active": [self._req_ckpt(s) for s in self._active],
            "queue": [self._req_ckpt(s) for s in self._queue],
            "results": {
                rid: res._replace(
                    **{
                        f: convert.to_numpy(v)
                        for f, v in res._asdict().items()
                        if isinstance(v, torch.Tensor)
                    }
                )
                for rid, res in self._results.items()
            },
        }

    @classmethod
    def restore(cls, engine: ServeEngine, state: dict, **knobs) -> "Scheduler":
        """Rebuild a mid-run scheduler from a :meth:`checkpoint` dict,
        possibly in a fresh process, on ``engine`` (built from the same
        model and cache config); ``knobs`` are the constructor's policy
        arguments."""
        cfg = engine.cache_cfg
        shape = state["cache_shape"]
        if (cfg.block_size, cfg.max_seqs, cfg.max_blocks_per_seq) != (
            shape["block_size"],
            shape["max_seqs"],
            shape["max_blocks_per_seq"],
        ):
            raise ValueError(
                f"engine cache config does not match the checkpoint (checkpoint: {shape})"
            )
        sched = cls(engine, **knobs)
        dev = engine.device
        cache = convert.kv_cache_from_numpy(state["cache"], dev)
        data = cache.pool.data.to(torch_dtype(cfg.dtype))
        engine.cache = cache._replace(pool=cache.pool._replace(data=data))
        sched.tick = state["tick"]
        sched.slots._ranges = sorted(tuple(r) for r in state["slot_ranges"])
        sched.stats = SchedulerStats(**state["stats"])
        sched._active = [sched._req_restore(d) for d in state["active"]]
        sched._queue = [sched._req_restore(d) for d in state["queue"]]
        sched._results = {
            rid: res._replace(
                **{
                    f: torch.as_tensor(v, device=dev)
                    for f, v in res._asdict().items()
                    if isinstance(v, np.ndarray)
                }
            )
            for rid, res in state["results"].items()
        }
        return sched

    # -- the invariant watchdog ----------------------------------------------

    def check_invariants(self) -> List[str]:
        """The bookkeeping conservation laws over every pool the scheduler
        owns (the KV pool, the slot table, each active token-trace store);
        returns the violated ones (empty = clean)."""
        problems: List[str] = []
        cache = self.engine.cache
        for p in pool_lib.check_invariants(cache.pool, cache.tables):
            problems.append(f"kv pool: {p}")
        held = sum(s.n for s in self._active)
        if self.slots.used != held:
            problems.append(
                f"slot table holds {self.slots.used} slots; active requests account for {held}"
            )
        for s in self._active:
            if s.trace is None or s.trace.cfg.mode is CopyMode.EAGER:
                continue
            shards = s.trace.store.shards if s.req.mesh is not None else (s.trace.store,)
            for st in shards:
                for p in pool_lib.check_invariants(st.pool, st.tables):
                    problems.append(f"trace pool ({s.req.rid!r}): {p}")
        return problems

    def _run_watchdog(self) -> None:
        problems = self.check_invariants()
        if problems:
            raise faults_lib.InvariantViolation(problems, self.tick)

    # -- checkpoint helpers --------------------------------------------------

    def _state(self, req: DecodeRequest) -> _ReqState:
        return _ReqState(req, self.engine.cache_cfg.block_size, self.device)

    def _req_ckpt(self, s: _ReqState) -> dict:
        req = s.req
        if req.mesh is not None:
            raise NotImplementedError("checkpoint of mesh-sharded token traces")
        return {
            "req": dataclasses.replace(
                req, prompt=convert.to_numpy(req.prompt), gen=rnd.state(req.gen)
            ),
            "lo": s.lo,
            "gen": rnd.state(s.gen),
            "logw": convert.to_numpy(s.logw),
            "logz": convert.to_numpy(s.logz),
            "logits": None if s.logits is None else convert.to_numpy(s.logits),
            "t_done": s.t_done,
            "ess": [convert.to_numpy(e) for e in s.ess],
            "used": list(s.used),
            "resampled": list(s.resampled),
            "fed": [np.asarray(f) for f in s.fed],
            "forks": {int(t): np.asarray(a) for t, a in s.forks.items()},
            # Growth attribution survives the executor swap.
            "grew_sofar": self._exec.stats.grow_events - s.grew0,
            "oom0": s.oom0,
            "preemptions": s.preemptions,
            "store": None if s.trace is None else convert.store_to_numpy(s.trace.store),
        }

    def _req_restore(self, d: dict) -> _ReqState:
        dev = self.device
        req = dataclasses.replace(
            d["req"],
            prompt=torch.as_tensor(d["req"].prompt, device=dev),
            gen=rnd.from_state(d["req"].gen),
        )
        s = self._state(req)
        s.lo = d["lo"]
        s.gen = rnd.from_state(d["gen"])
        s.logw = torch.as_tensor(d["logw"], device=dev)
        s.logz = torch.as_tensor(d["logz"], device=dev)
        s.logits = None if d["logits"] is None else torch.as_tensor(d["logits"], device=dev)
        s.t_done = d["t_done"]
        s.ess = [torch.as_tensor(e, device=dev) for e in d["ess"]]
        s.used = list(d["used"])
        s.resampled = list(d["resampled"])
        s.fed = [np.asarray(f, dtype=np.int32) for f in d["fed"]]
        s.forks = {int(t): np.asarray(a) for t, a in d["forks"].items()}
        s.grew0 = self._exec.stats.grow_events - d["grew_sofar"]
        s.oom0 = d["oom0"]
        s.preemptions = d["preemptions"]
        if d["store"] is not None:
            s.trace = s.new_trace()
            s.trace.store = convert.store_from_numpy(d["store"], dev)
            s.trace_view = s.trace.pool_view()
        if self.event_log is not None:
            self.event_log.record_request(req)
        return s

    # -- pool views ----------------------------------------------------------

    def _kv_view(self) -> executor_lib.PoolView:
        """The executor's growth port over the engine's shared KV page pool
        (host-mutable: the accessors ignore the carry)."""
        eng = self.engine
        return executor_lib.PoolView(
            free=lambda _: eng.free_blocks,
            num_blocks=lambda _: eng.num_blocks,
            cap=eng.cache_cfg.pool_blocks_cap,
            grow_to=lambda carry, nb: (self._grow_cache(nb), carry)[1],
            oom=lambda _: eng.oom,
        )

    def _grow_cache(self, new_num_blocks: int) -> None:
        """Grow the shared pool, recording the decision and its wall time."""
        if self.event_log is None:
            self.engine.grow_cache(new_num_blocks)
            return
        old = self.engine.num_blocks
        t0 = time.perf_counter()
        self.engine.grow_cache(new_num_blocks)
        _sync(self.device)
        self.event_log.grow_wall_s.append(time.perf_counter() - t0)
        self.event_log.grow_old_blocks.append(old)
        self.event_log.emit("grow", self.tick, new_num_blocks)

    # -- admission -----------------------------------------------------------

    def _join_demand(self, s: _ReqState) -> int:
        """Worst-case pages a joining request needs before the next
        boundary: its prefill plus one page per particle for the first
        token; a resume adds ``n`` pages per block its recorded tokens
        span (an upper bound that ignores COW sharing)."""
        bs = self.engine.cache_cfg.block_size
        demand = s.prefill_blocks(bs) + s.n
        if s.t_done > 0:
            plen = int(s.req.prompt.shape[0])
            demand += s.n * (-(-(plen + s.t_done) // bs) - plen // bs)
        return demand

    def _admit_ready(self) -> None:
        """FIFO admission at a token boundary (head-of-line blocking is
        deliberate: deterministic order, no starvation of big requests)."""
        while self._queue:
            s = self._queue[0]
            if s.req.arrive_at > self.tick:
                if self._active:
                    break  # not here yet; keep decoding who is
                self.tick = s.req.arrive_at  # idle: fast-forward
            if self._expired(s):
                self._terminate(s, RequestStatus.EXPIRED, "expired")
                continue
            lo = self.slots.alloc(s.n)
            if lo is None:
                if not self._active:
                    if self.event_log is not None:
                        self.event_log.emit(
                            "refused", s.req.rid, self.tick, "slots",
                            s.n - self.slots.free_slots,
                        )
                    raise AdmissionRefused(
                        f"request {s.req.rid!r} needs {s.n} slots; "
                        f"{self.slots.free_slots} of {self.slots.capacity} "
                        "are free and no active request remains to finish",
                        rid=s.req.rid,
                        resource="slots",
                        needed=s.n,
                        available=self.slots.free_slots,
                    )
                break
            if s.trace is None:
                # Fresh admission: growth and pool-oom transitions from
                # here on are attributed to this request.
                s.grew0 = self._exec.stats.grow_events
                s.oom0 = bool(self.engine.oom)
            demand = self._join_demand(s) + math.ceil(
                self.admission_margin * sum(a.n for a in self._active)
            )
            if self.grow:
                self._exec.ensure(self._kv_view(), None, demand, self.grow_factor)
            if self.strict_admission and self.engine.free_blocks < demand:
                resuming = s.trace is not None
                if not (resuming and not self._active):
                    # (A last-resort resume with nothing active is placed
                    # anyway; a real shortfall surfaces through ``oom``.)
                    self.slots.free(lo, s.n)
                    if not self._active:
                        if self.event_log is not None:
                            self.event_log.emit(
                                "refused", s.req.rid, self.tick, "blocks",
                                demand - self.engine.free_blocks,
                            )
                        raise AdmissionRefused(
                            f"request {s.req.rid!r} needs {demand} pages "
                            f"(prefill + worst-case clone/append demand); "
                            f"pool has {self.engine.free_blocks} free of "
                            f"{self.engine.num_blocks} "
                            f"(cap {self.engine.cache_cfg.pool_blocks_cap}) "
                            "and no active request remains to free any",
                            rid=s.req.rid,
                            resource="blocks",
                            needed=demand,
                            available=self.engine.free_blocks,
                        )
                    break
            self._queue.pop(0)
            if self.event_log is not None:
                kind = "resume" if s.trace is not None else "admit"
                self.event_log.emit(kind, s.req.rid, self.tick, lo)
            self._place(s, lo)
            self._active.append(s)
            if s.done:  # zero-step request: joins and leaves in one tick
                self._finalize(s)

    def _place(self, s: _ReqState, lo: int) -> None:
        """Prefill + fork into the slot range; replay if resuming."""
        eng = self.engine
        s.lo = lo
        resuming = s.t_done > 0 or s.trace is not None
        if not resuming:
            s.trace = s.new_trace()
            s.trace_view = s.trace.pool_view()
            self.stats.admitted += 1
        else:
            self.stats.resumes += 1
        # Prefill the prompt once into the range's first slot, then fork
        # the population across the range: O(1) per particle.
        t0 = time.perf_counter()
        prompt = s.req.prompt.to(device=self.device)
        logits = eng.prefill(
            prompt[None, :], torch.tensor([lo], dtype=torch.int32, device=self.device)
        )
        eng.fork_slots(lo, torch.zeros(s.n, dtype=torch.int32, device=self.device))
        s.logits = logits[0].expand(s.n, logits.shape[-1])
        if self.event_log is not None:
            _sync(self.device)
            self.event_log.prefill_wall_s.append(time.perf_counter() - t0)
        if resuming:
            self._replay(s)

    # -- preemption / resume -------------------------------------------------

    def _preempt(self, s: _ReqState) -> None:
        """Release the request's pages; keep its token history and SMC
        state.  It resumes from the front of the queue."""
        if self.event_log is not None:
            self.event_log.emit("preempt", s.req.rid, self.tick)
        self.engine.free_slots(s.lo, s.n)
        self.slots.free(s.lo, s.n)
        self._active.remove(s)
        s.lo = None
        s.logits = None  # re-derived bit-exactly by the resume replay
        s.preemptions += 1
        self.stats.preemptions += 1
        self._queue.insert(0, s)

    def _replay(self, s: _ReqState) -> None:
        """Rebuild the request's KV pages from the replay log: re-apply
        each recorded fork and feed each recorded token through the same
        decode step (masked to this request's slots), so every page and
        the COW sharing structure come back as they were."""
        eng = self.engine
        S = eng.cache_cfg.max_seqs
        dev = self.device
        mask = torch.zeros(S, dtype=torch.bool, device=dev)
        mask[s.lo : s.lo + s.n] = True
        for t in range(s.t_done):
            if self.grow:
                self._exec.ensure(self._kv_view(), None, s.n, self.grow_factor)
            anc = s.forks.get(t)
            if anc is not None:
                eng.fork_slots(s.lo, torch.as_tensor(anc, device=dev))
            tok = torch.zeros(S, dtype=torch.int32, device=dev)
            tok[s.lo : s.lo + s.n] = torch.as_tensor(s.fed[t], device=dev)
            logits = eng.decode(tok[:, None], mask)
            s.logits = logits[s.lo : s.lo + s.n]
            self.stats.replayed_tokens += 1

    # -- typed terminations --------------------------------------------------

    def _expired(self, s: _ReqState) -> bool:
        return s.req.deadline is not None and self.tick >= s.req.deadline

    def _expire_deadlines(self) -> None:
        """Deadline enforcement at the boundary, active first then queued
        (both oldest first)."""
        for s in [a for a in self._active if self._expired(a)]:
            self._terminate(s, RequestStatus.EXPIRED, "expired")
        for s in [q for q in self._queue if self._expired(q)]:
            self._terminate(s, RequestStatus.EXPIRED, "expired")

    def _shed_overflow(self) -> None:
        """The ``shed`` policy's queue bound: at most ``queue_limit``
        arrived, fresh requests wait; the excess sheds newest-first
        (preempted requests waiting to resume are exempt)."""
        if self.admission != "shed" or self.queue_limit is None:
            return
        waiting = [s for s in self._queue if s.trace is None and s.req.arrive_at <= self.tick]
        for s in waiting[self.queue_limit :]:
            self._terminate(s, RequestStatus.SHED, "shed")

    def _terminate(self, s: _ReqState, status: RequestStatus, event: str) -> None:
        """Typed early termination: emit the decision, bump the stat, and
        finalize with the partial result."""
        if self.event_log is not None:
            self.event_log.emit(event, s.req.rid, self.tick)
        setattr(self.stats, status.value, getattr(self.stats, status.value) + 1)
        self._finalize(s, status=status)

    # -- the boundary hook ---------------------------------------------------

    def _boundary(self, carry, ts):
        """Leading edge of a token boundary: admit (and resume), grow
        pre-emptively, preempt as the backstop."""
        if self.on_boundary is not None:
            self.on_boundary(self)
        if self.watchdog:
            self._run_watchdog()
        self._expire_deadlines()
        self._admit_ready()
        self._shed_overflow()
        need = sum(s.n for s in self._active)
        if need == 0:
            return carry
        if self.grow:
            # A token step allocates at most one page per active particle.
            self._exec.ensure(
                self._kv_view(), None, math.ceil(self.watermark * need), self.grow_factor
            )
        while (
            self.engine.free_blocks < math.ceil(self.preempt_margin * need)
            and len(self._active) > 1
        ):
            victim = self.preempt_policy.select(self._active, self.tick)
            self._preempt(victim)
            need = sum(s.n for s in self._active)
        for s in self._active:
            if self.grow:
                self._exec.ensure(s.trace_view, None, s.trace.append_need, self.grow_factor)
        return carry

    # -- one global token step ----------------------------------------------

    def _snapshot(self) -> dict:
        """A copy of the state one decode tick can change: every leaf of
        the KV cache (the payload is written in place), batch membership,
        and per active request its SMC state, a copy of its token-trace
        store and of its generator, and its log lengths."""
        return {
            "cache": executor_lib.snapshot(self.engine.cache),
            "active": list(self._active),
            "queue": list(self._queue),
            "reqs": [
                (
                    s,
                    rnd.snapshot(s.gen),
                    s.logw,
                    s.logz,
                    s.logits,
                    s.t_done,
                    None if s.trace is None else executor_lib.snapshot(s.trace.store),
                    len(s.ess),
                    len(s.used),
                    len(s.resampled),
                    len(s.fed),
                    dict(s.forks),
                )
                for s in self._active
            ],
            "grow_events": self._exec.stats.grow_events,
        }

    def _restore(self, snap: dict) -> None:
        """Return to ``snap``; the snapshot is copied again, so it can be
        restored once per failed attempt."""
        self.engine.cache = executor_lib.snapshot(snap["cache"])
        self._active = list(snap["active"])
        self._queue = list(snap["queue"])
        for s, gen, logw, logz, logits, t_done, store, ne, nu, nr, nf, forks in snap["reqs"]:
            s.gen = rnd.snapshot(gen)
            s.logw, s.logz, s.logits, s.t_done = logw, logz, logits, t_done
            if store is not None:
                s.trace.store = executor_lib.snapshot(store)
            del s.ess[ne:], s.used[nu:], s.resampled[nr:], s.fed[nf:]
            s.forks = dict(forks)
        self._exec.stats.grow_events = snap["grow_events"]

    def _log_mark(self) -> Optional[tuple]:
        """Event-log lengths at the start of one decode attempt."""
        log = self.event_log
        if log is None:
            return None
        return (
            len(log.events),
            len(log.step_wall_s),
            len(log.prefill_wall_s),
            len(log.grow_wall_s),
            len(log.grow_old_blocks),
        )

    def _log_truncate(self, mark: Optional[tuple]) -> None:
        if mark is None:
            return
        log = self.event_log
        ne, ns, npre, ng, ngo = mark
        del log.events[ne:]
        del log.step_wall_s[ns:]
        del log.prefill_wall_s[npre:]
        del log.grow_wall_s[ng:]
        del log.grow_old_blocks[ngo:]

    def _log_fault(self, ev: faults_lib.FaultEvent) -> None:
        if self.event_log is not None:
            self.event_log.emit(*faults_lib.fault_tuple(ev, self.tick))

    def _token_step(self, carry, ts):
        """One decode tick inside the recovery loop: a transient failure
        rolls the tick back to its pre-step snapshot and retries under the
        :class:`RetryPolicy`; the surviving attempt is bit-identical to a
        fault-free tick."""
        if not self._active:
            if self._queue:
                rids = tuple(s.req.rid for s in self._queue)
                if self.event_log is not None:
                    self.event_log.emit("saturated", self.tick, rids)
                raise AllReplicasSaturated(
                    f"tick {self.tick}: {len(rids)} request(s) waiting "
                    f"({', '.join(map(repr, rids))}) but none admitted "
                    "and no active request remains to free capacity",
                    tick=self.tick,
                    rids=rids,
                )
            self.tick += 1
            return carry, ()
        # Only an injected fault fails a tick, so fault-free serving keeps
        # no copy to roll back to.
        snap = None if self.faults is None else self._snapshot()
        attempt = 0
        while True:
            mark = self._log_mark()
            try:
                return self._token_step_attempt(carry)
            except TransientStepFailure as exc:
                if snap is None:
                    raise
                self._restore(snap)
                self._log_truncate(mark)
                attempt += 1
                for ev in exc.events:
                    self._log_fault(ev)
                if attempt > self.retry_policy.max_retries:
                    raise FaultRetriesExhausted(
                        f"tick {self.tick} failed {attempt} times "
                        f"(max_retries={self.retry_policy.max_retries}); "
                        "state restored to the pre-tick snapshot",
                        tick=self.tick,
                        attempts=attempt,
                    ) from exc
                self.stats.retries += 1
                if self.event_log is not None:
                    self.event_log.emit("retry", self.tick, attempt)
                delay = self.retry_policy.delay_s(attempt)
                if delay > 0.0:
                    time.sleep(delay)

    def _token_step_attempt(self, carry):
        """One token for every active request: per-request SMC updates
        (sample -> reweight -> resample/fork), one decode over the union
        of the active slot ranges, then appends and departures
        (completions, then quarantines)."""
        t0 = time.perf_counter()
        eng = self.engine
        dev = self.device
        events = self.faults.step_events(self.tick) if self.faults else []
        for ev in events:
            self.stats.faults += 1
            self._log_fault(ev)
            if ev.kind is FaultKind.DEVICE_LOSS:
                # Unrecoverable, and raised before any mutation.
                raise DeviceLost(f"device lost at tick {self.tick}")
            if ev.kind is FaultKind.LATENCY and ev.delay_s > 0.0:
                time.sleep(ev.delay_s)
        fail_step = any(ev.kind is FaultKind.STEP_FAILURE for ev in events)
        starve = any(ev.kind is FaultKind.OOM for ev in events)
        poison = {ev.rid for ev in events if ev.kind is FaultKind.NAN_LOGITS}
        S = eng.cache_cfg.max_seqs
        tokens = torch.zeros(S, dtype=torch.int32, device=dev)
        mask = torch.zeros(S, dtype=torch.bool, device=dev)
        pending: List[tuple] = []
        for s in self._active:
            token, s.logw, s.logz, ess, do_res, anc, k_res = smc_token_update(
                s.gen,
                s.logits,
                s.logw,
                s.logz,
                n=s.n,
                target_temp=s.req.target_temp,
                proposal_temp=s.req.proposal_temp,
                ess_threshold=s.req.ess_threshold,
            )
            if do_res:
                if self.grow:
                    # A sharded trace imports boundary crossers as fresh
                    # blocks: size that demand, with the token's append,
                    # before the clone runs.
                    s.trace.ensure_clone_headroom(
                        anc, self.grow_factor, ex=self._exec, extra=s.trace.append_need
                    )
                eng.fork_slots(s.lo, anc)  # zero-copy clone of KV lineages
                # Fused resample -> clone of the token histories, drawing
                # the same uniform from the snapshot taken before it.
                chained = s.trace.clone_chain(k_res, s.logw)
                if not torch.equal(chained, anc):
                    raise RuntimeError(
                        f"request {s.req.rid!r}, step {s.t_done}: the token store's "
                        "clone_chain drew other ancestors than the KV fork"
                    )
                token = token[anc.long()]
                s.logw = torch.full((s.n,), -math.log(s.n), dtype=torch.float32, device=dev)
                s.forks[s.t_done] = anc.cpu().numpy()
            token = token.to(torch.int32)
            s.ess.append(ess)
            s.resampled.append(do_res)
            # The host copy of the fed tokens, read before the decode is
            # queued (the ESS test above has already synchronized).
            pending.append((s, token, token.cpu().numpy()))
            tokens[s.lo : s.lo + s.n] = token
            mask[s.lo : s.lo + s.n] = True
        if starve:
            # Forced mid-run alloc OOM: empty the free stack so every
            # allocation inside this decode fails (sticky ``oom``, dump-row
            # writes), then fail the step.  The rollback restores the
            # pre-starvation pool, flag and payload included.
            pool = eng.cache.pool
            eng.cache = eng.cache._replace(
                pool=pool._replace(free_top=torch.zeros_like(pool.free_top))
            )
        logits = eng.decode(tokens[:, None], mask)
        if fail_step or starve:
            raise TransientStepFailure(
                f"transient step failure at tick {self.tick}", events=events
            )
        if any(s.req.rid in poison for s in self._active):
            # Poisoned after the decode, on a copy: the population's rows
            # go non-finite, as a diverged model output would.
            logits = logits.clone()
            for s in self._active:
                if s.req.rid in poison:
                    logits[s.lo : s.lo + s.n] = float("nan")
        # Queue the transfer the quarantine scan needs, do the bookkeeping
        # that reads no device value, then wait for it.
        finite_host = ready = None
        if self.quarantine:
            finite_dev = torch.isfinite(logits).all(dim=-1)
            if finite_dev.is_cuda:
                finite_host = torch.empty(finite_dev.shape, dtype=torch.bool, pin_memory=True)
                finite_host.copy_(finite_dev, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            else:
                finite_host = finite_dev
        for s, token, fed in pending:
            s.logits = logits[s.lo : s.lo + s.n]
            s.trace.append(token)
            s.fed.append(fed)
        t_sync = time.perf_counter()
        if ready is not None:
            ready.synchronize()
        finite = None if finite_host is None else finite_host.numpy()
        used = eng.used_blocks  # one device sync, shared by all requests
        self.sync_wait_s += time.perf_counter() - t_sync
        if self.event_log is not None:
            self.event_log.step_wall_s.append(time.perf_counter() - t0)
            self.event_log.emit(
                "step", self.tick, tuple(s.req.rid for s in self._active), used
            )
        poisoned: List[_ReqState] = []
        for s, _, _ in pending:
            s.used.append(used)
            s.t_done += 1
            if finite is not None and not bool(finite[s.lo : s.lo + s.n].all()):
                poisoned.append(s)
        self.tick += 1
        self.stats.ticks += 1
        # Departures at the trailing edge: completions, then quarantines.
        for s in [a for a in self._active if a.done]:
            self._finalize(s)
        # This tick's token was sampled from the previous (clean) logits,
        # so the completed prefix is trustworthy; only the next sample
        # would read the NaNs.  A request that finished this very tick
        # keeps its completion.
        for s in poisoned:
            if s in self._active:
                self._terminate(s, RequestStatus.POISONED, "poisoned")
        return carry, ()

    # -- completion ----------------------------------------------------------

    def _finalize(self, s: _ReqState, status: RequestStatus = RequestStatus.OK) -> None:
        steps = s.req.steps
        ok = status is RequestStatus.OK
        dev = self.device
        if self.event_log is not None:
            if ok:
                self.event_log.emit("complete", s.req.rid, self.tick)
            self.event_log.record_forks(s.req.rid, s.forks)
        if s.trace is not None:
            tokens = s.trace.tokens(steps)
            if not ok and s.t_done < steps:
                # Ended mid-flight: the completed prefix, zero-padded.
                cols = torch.arange(steps, dtype=torch.int32, device=dev)[None, :]
                tokens = torch.where(cols < s.t_done, tokens, 0)
        else:
            tokens = torch.zeros((s.n, steps), dtype=torch.int32, device=dev)
        self._results[s.req.rid] = SMCDecodeResult(
            tokens=tokens,
            log_weights=s.logw,
            log_evidence=s.logz,
            ess_trace=(
                torch.stack(s.ess) if s.ess else torch.zeros(0, dtype=torch.float32, device=dev)
            ),
            used_blocks_trace=torch.tensor(s.used, dtype=torch.int32, device=dev),
            resampled=torch.tensor(s.resampled, dtype=torch.bool, device=dev),
            # The pool flag is sticky: report only transitions that
            # happened while this request was resident.
            oom=torch.tensor(
                (s.trace is not None and s.trace.oom()) or (self.engine.oom and not s.oom0),
                device=dev,
            ),
            grew=torch.tensor(
                self._exec.stats.grow_events - s.grew0, dtype=torch.int32, device=dev
            ),
            preemptions=s.preemptions,
            status=status.value,
        )
        if s.lo is not None:
            # Never-placed terminations hold no slots or pages.
            self.engine.free_slots(s.lo, s.n)
            self.slots.free(s.lo, s.n)
        if s in self._active:
            self._active.remove(s)
        if s in self._queue:
            self._queue.remove(s)
        s.lo = None
        if self.on_token is not None:
            # Departed requests leave _active before the trailing-edge
            # flush: park them so their last tokens and status stream out.
            self._pending_final.append((s, status))
        if ok:
            self.stats.completed += 1
        if self.shrink_on_complete and self._active:
            # Shrink to 1.25x the live set, floored at two worst-case
            # tokens for the remaining batch.
            live = int(self.engine.used_blocks)
            floor = 2 * sum(a.n for a in self._active)
            target = max(-(-live * 5 // 4), live + floor, 16)
            if target < self.engine.num_blocks:
                self.compact(target)


# -- checkpoint persistence ----------------------------------------------------


def save_checkpoint(path, state: dict) -> None:
    """Write a :meth:`Scheduler.checkpoint` dict to disk (pickled host
    arrays: a local, trusted-process format)."""
    with open(path, "wb") as f:
        pickle.dump(state, f)


def load_checkpoint(path) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)
