"""Replicated serving: data-parallel scheduler replicas behind a router, in
the port (the port of ``repro.serving.router``).

One :class:`~repro_torch.serving.scheduler.Scheduler` multiplexes many
requests over one engine's shared COW pool; a deployment has many.  This
module composes N *unchanged* schedulers — one engine and pool each, on
one card or several (:func:`make_replicas`) — behind a :class:`Router`
that owns the fleet-level queue and places each incoming request by
free-slot/free-block accounting.  The composition inherits the platform's
reproducibility contracts instead of weakening them:

* **Placement is pure accounting.**  A request is placed only on a
  replica that can *ever* hold it (``max_seqs``, pool cap) and that
  currently has slots plus block headroom (free + growth-to-cap) for
  its join demand — the same arithmetic the scheduler's own admission
  uses, read through a small shared protocol (``free_slots``,
  ``free_blocks``, ``blocks_cap``, ``active_particles``) that the
  simulator's :class:`~repro_torch.serving.sim.SimScheduler` implements
  too.  The *same* ``Router`` class therefore drives real and simulated
  fleets, and ``first_divergence`` on the router event logs (plus the
  per-replica decision logs) stays a meaningful differential oracle.
* **Per-request results are bit-exact with single-replica runs** of the
  same ``max_seqs``.  Every per-row computation in a replica's decode is
  independent and each request carries its own generator, so which
  replica a request lands in cannot change its tokens/weights/logZ
  (``tests/test_torch_router.py`` on the CPU, ``chip_smoke.py`` phase 13
  on the card).
* **Rounds are deterministic.**  ``run`` loops fleet *rounds*: place
  waiting requests (FIFO, head-of-line like the scheduler), then step
  every replica that has work, in replica order.  No threads, no
  wall-clock — the round sequence is a pure function of the submitted
  requests and the placement policy.
* **Saturation is surfaced, never spun on.**  If waiters remain, none
  could be placed, and no replica holds work that could free capacity,
  another round would change nothing — forever.  The router emits a
  ``("saturated", round, rids)`` event and raises
  :class:`~repro_torch.serving.faults.AllReplicasSaturated` (the
  scheduler and simulator raise the same type at their own no-progress
  seam).

Placement policies (:data:`PLACEMENT_POLICIES`): ``least_loaded``
(fewest active particles, most free blocks), ``round_robin`` (rotating
cursor over feasible replicas), ``affinity`` (requests sharing a
``"session/"`` rid prefix stick to the replica that served the prefix,
falling back to least-loaded).  Streaming (``Scheduler(on_token=...)`` /
:meth:`Router.stream`) tees through unchanged: replicas emit committed
:class:`~repro_torch.serving.scheduler.TokenEvent`\\ s as the round steps
them, so fleet callers also see tokens before :meth:`Router.run`
returns.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
from typing import (
    Any,
    Callable,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np
import torch

from repro_torch.serving.faults import AllReplicasSaturated
from repro_torch.serving.scheduler import TokenEvent

__all__ = [
    "PLACEMENT_POLICIES",
    "Replica",
    "Router",
    "RouterEventLog",
    "affinity",
    "least_loaded",
    "make_replicas",
    "round_robin",
]


def _plen(req) -> int:
    """Prompt length of a DecodeRequest (array prompt) or TraceRequest
    (integer ``plen``) — placement works on either."""
    plen = getattr(req, "plen", None)
    if plen is not None:
        return int(plen)
    return int(req.prompt.shape[0])


def _affinity_key(rid: str) -> str:
    return rid.split("/", 1)[0]


# -- placement policies -------------------------------------------------------


def least_loaded(router: "Router", req, candidates: List[int]) -> int:
    """Fewest active-plus-queued particles, then most free blocks, then
    lowest replica index — spreads load and keeps ties deterministic.
    Queued particles count so a burst placed within one round spreads
    instead of piling onto the first replica."""

    def score(i: int):
        s = router.replicas[i].scheduler
        return (s.load_particles, -s.free_blocks, i)

    return min(candidates, key=score)


def round_robin(router: "Router", req, candidates: List[int]) -> int:
    """Rotating cursor over the fleet, skipping replicas that cannot
    take the request this round."""
    n = len(router.replicas)
    for k in range(n):
        i = (router._rr_next + k) % n
        if i in candidates:
            router._rr_next = (i + 1) % n
            return i
    return candidates[0]  # unreachable: candidates is non-empty


def affinity(router: "Router", req, candidates: List[int]) -> int:
    """Sticky sessions: requests whose rid shares a ``"prefix/"`` with
    an earlier placement go back to that replica (resumes and
    continuations reuse its warmed pool and token traces); unmatched
    requests fall back to least-loaded."""
    i = router._affinity.get(_affinity_key(req.rid))
    if i is not None and i in candidates:
        return i
    return least_loaded(router, req, candidates)


PLACEMENT_POLICIES: Dict[str, Callable] = {
    "least_loaded": least_loaded,
    "round_robin": round_robin,
    "affinity": affinity,
}


# -- event log ----------------------------------------------------------------


@dataclasses.dataclass
class RouterEventLog:
    """Fleet-level decision record, in the same tuple style as
    :class:`~repro_torch.serving.scheduler.SchedulerEventLog` so
    ``first_divergence`` compares real and simulated fleets directly:

    * ``("place", rid, round, replica)``
    * ``("complete", rid, round, replica)`` — the request's result was
      collected (terminal statuses included; the per-replica logs carry
      the status-typed event)
    * ``("saturated", round, (rid, ...))`` — immediately before
      :class:`~repro_torch.serving.faults.AllReplicasSaturated`
    """

    events: List[tuple] = dataclasses.field(default_factory=list)
    arrivals: Dict[str, int] = dataclasses.field(default_factory=dict)

    def emit(self, *event) -> None:
        self.events.append(tuple(event))

    @property
    def decisions(self) -> List[tuple]:
        return list(self.events)

    def latency_rounds(self) -> Dict[str, float]:
        """p50/p99 of queueing (arrival → placement) and completion
        (arrival → collection) latency in fleet rounds — deterministic,
        so benches gate them exactly (the per-replica event logs carry
        the tick-level view)."""
        place: Dict[str, int] = {}
        done: Dict[str, int] = {}
        for e in self.events:
            if e[0] == "place":
                place.setdefault(e[1], e[2])
            elif e[0] == "complete":
                done.setdefault(e[1], e[2])
        out: Dict[str, float] = {}
        for label, stamps in (("queue", place), ("completion", done)):
            lat = [
                r - self.arrivals[rid]
                for rid, r in stamps.items()
                if rid in self.arrivals
            ]
            for p in (50, 99):
                out[f"{label}_p{p}"] = (
                    float(np.percentile(lat, p)) if lat else float("nan")
                )
        return out


@dataclasses.dataclass
class Replica:
    """One scheduler (real or simulated) plus its fleet bookkeeping."""

    index: int
    scheduler: Any
    device: Any = None
    placed: int = 0
    collected: set = dataclasses.field(default_factory=set)


# -- the router ---------------------------------------------------------------


class Router:
    """Place requests across scheduler replicas and drive them in
    deterministic rounds.  ``replicas`` are
    :class:`~repro_torch.serving.scheduler.Scheduler`\\ s (or
    :class:`~repro_torch.serving.sim.SimScheduler`\\ s — anything speaking the
    placement protocol); ``placement`` is a
    :data:`PLACEMENT_POLICIES` name or a callable
    ``(router, request, candidate_indices) -> index``."""

    def __init__(
        self,
        replicas: Sequence[Any],
        *,
        placement: Union[str, Callable] = "least_loaded",
        event_log: Optional[RouterEventLog] = None,
        devices: Optional[Sequence[Any]] = None,
    ):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        devices = list(devices) if devices is not None else [None] * len(replicas)
        self.replicas = [
            Replica(index=i, scheduler=s, device=d)
            for i, (s, d) in enumerate(zip(replicas, devices, strict=True))
        ]
        if isinstance(placement, str):
            fn = PLACEMENT_POLICIES.get(placement)
            if fn is None:
                raise ValueError(
                    f"unknown placement policy {placement!r} "
                    f"(known: {sorted(PLACEMENT_POLICIES)})"
                )
            self.placement, self.placement_name = fn, placement
        else:
            self.placement, self.placement_name = placement, getattr(
                placement, "__name__", "custom"
            )
        self.event_log = event_log
        self.round = 0
        self._waiting: List[Any] = []  # FIFO, like the scheduler's queue
        self._seen: set = set()
        self._affinity: Dict[str, int] = {}
        self._rr_next = 0
        self._results: Dict[str, Any] = {}

    # -- submission ----------------------------------------------------------

    def submit(self, req) -> None:
        if req.rid in self._seen:
            raise ValueError(f"duplicate request id {req.rid!r}")
        self._seen.add(req.rid)
        self._waiting.append(req)
        if self.event_log is not None:
            self.event_log.arrivals[req.rid] = req.arrive_at

    # -- placement accounting ------------------------------------------------

    def _hard_fits(self, sched, req) -> bool:
        """Could this replica *ever* hold the request (empty pool, full
        growth)?  A request that hard-fits nowhere waits — and turns
        into a typed saturation once the fleet drains."""
        n = req.n_particles
        prefill = -(-_plen(req) // sched.block_size)
        cap = max(sched.blocks_cap, sched.num_blocks)
        return n <= sched.max_seqs and prefill + n <= cap

    def _soft_fits(self, sched, req) -> bool:
        """Can the replica take the request *now*: free slots for its
        particles, and current-free plus growth-to-cap headroom for the
        same join demand its own admission will compute.  The replica's
        admission remains the authority — this check only decides
        placement, so a transiently wrong guess queues inside the
        replica rather than corrupting anything."""
        n = req.n_particles
        prefill = -(-_plen(req) // sched.block_size)
        demand = prefill + n + int(
            np.ceil(sched.admission_margin * sched.load_particles)
        )
        headroom = sched.free_blocks
        if sched.grow:
            headroom += max(sched.blocks_cap - sched.num_blocks, 0)
        return sched.free_slots >= n and headroom >= demand

    def _place_round(self) -> int:
        """Place arrived waiters in FIFO order onto feasible replicas.
        Head-of-line blocking is deliberate (the scheduler's own
        admission rationale: skipping ahead starves big requests and
        breaks deterministic order)."""
        placed = 0
        while self._waiting:
            req = self._waiting[0]
            if req.arrive_at > self.round:
                break
            hard = [
                rep.index
                for rep in self.replicas
                if self._hard_fits(rep.scheduler, req)
            ]
            candidates = [
                i for i in hard if self._soft_fits(self.replicas[i].scheduler, req)
            ]
            if not candidates:
                break
            i = self.placement(self, req, candidates)
            self._waiting.pop(0)
            rep = self.replicas[i]
            rep.scheduler.submit(req)
            rep.placed += 1
            self._affinity[_affinity_key(req.rid)] = i
            if self.event_log is not None:
                self.event_log.emit("place", req.rid, self.round, i)
            placed += 1
        return placed

    def _collect(self, rep: Replica) -> None:
        res = rep.scheduler.results
        for rid in res:  # insertion (completion) order — deterministic
            if rid not in rep.collected:
                rep.collected.add(rid)
                self._results[rid] = res[rid]
                if self.event_log is not None:
                    self.event_log.emit("complete", rid, self.round, rep.index)

    # -- the round loop ------------------------------------------------------

    def step_round(self) -> bool:
        """One fleet round: place arrived waiters, then step every
        replica that has work (in replica order), collecting completed
        results.  Returns True while fleet work remains."""
        placed = self._place_round()
        worked = 0
        for rep in self.replicas:
            if rep.scheduler.has_work:
                worked += 1
                rep.scheduler.step()
                self._collect(rep)
        if self._waiting and not placed and not worked:
            head = self._waiting[0]
            if head.arrive_at > self.round:
                # Fleet idle, head not due: fast-forward, like the
                # scheduler's own idle arrival skip.
                self.round = head.arrive_at
                return True
            # No placement, no replica progress, waiters due: one more
            # round would repeat this state verbatim.  Surface it.
            rids = tuple(r.rid for r in self._waiting)
            if self.event_log is not None:
                self.event_log.emit("saturated", self.round, rids)
            raise AllReplicasSaturated(
                f"round {self.round}: {len(rids)} request(s) waiting "
                f"({', '.join(map(repr, rids))}) but no replica can admit "
                "them and no replica holds work that could free capacity",
                tick=self.round,
                rids=rids,
            )
        self.round += 1
        return bool(
            self._waiting or any(r.scheduler.has_work for r in self.replicas)
        )

    def run(self) -> Dict[str, Any]:
        """Drive every submitted request to completion across the
        fleet; returns ``{rid: result}`` (results are whatever the
        replicas produce — ``SMCDecodeResult`` for real schedulers)."""
        while self.step_round():
            pass
        return dict(self._results)

    def stream(self) -> Iterator[TokenEvent]:
        """Fleet-wide streaming: yields every replica's committed
        :class:`~repro_torch.serving.scheduler.TokenEvent`\\ s in round order
        (replica order within a round).  Tees on top of any ``on_token``
        callbacks already installed on the replicas."""
        buf: List[TokenEvent] = []
        prev: List[tuple] = []
        for rep in self.replicas:
            sched = rep.scheduler
            if not hasattr(sched, "on_token"):
                continue
            old = sched.on_token

            def tee(ev: TokenEvent, _old=old) -> None:
                if _old is not None:
                    _old(ev)
                buf.append(ev)

            sched.on_token = tee
            prev.append((sched, old))
        try:
            while self.step_round():
                while buf:
                    yield buf.pop(0)
            while buf:
                yield buf.pop(0)
        finally:
            for sched, old in prev:
                sched.on_token = old

    @property
    def results(self) -> Dict[str, Any]:
        return dict(self._results)

    # -- telemetry -----------------------------------------------------------

    def utilization(self) -> List[dict]:
        """Per-replica utilization snapshot (the bench uploads this as
        a CI artifact): placements, completions, live occupancy, pool
        shape, and scheduler counters."""
        out = []
        for rep in self.replicas:
            s = rep.scheduler
            out.append(
                {
                    "replica": rep.index,
                    "device": str(rep.device) if rep.device is not None else None,
                    "placed": rep.placed,
                    "collected": len(rep.collected),
                    "active_particles": s.active_particles,
                    "free_slots": s.free_slots,
                    "max_seqs": s.max_seqs,
                    "free_blocks": s.free_blocks,
                    "num_blocks": s.num_blocks,
                    "blocks_cap": s.blocks_cap,
                    "ticks": s.stats.ticks,
                    "admitted": s.stats.admitted,
                    "completed": s.stats.completed,
                    "preemptions": s.stats.preemptions,
                }
            )
        return out

    def write_utilization(self, path) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "rounds": self.round,
                    "placement": self.placement_name,
                    "replicas": self.utilization(),
                },
                f,
                indent=2,
                sort_keys=True,
            )


def make_replicas(
    build: Callable[[int, Any], Any],
    *,
    n: Optional[int] = None,
    devices: Optional[Sequence[Any]] = None,
) -> Tuple[List[Any], List[Any]]:
    """Construct one scheduler per device: ``build(index, device)`` runs
    under ``torch.cuda.device(device)`` for a CUDA device, so each
    replica's engine and pool land on its own card.  ``devices`` defaults
    to every card (``torch.device("cuda", i)``), and raises when there is
    none: pass ``devices=[torch.device("cpu")]`` to run on the host.  ``n``
    truncates or cycles the device list (several replicas per card is
    fine — the point of replication is independent pools, not hardware).
    Returns ``(schedulers, devices)`` ready for :class:`Router`."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=[torch.device('cpu')] "
                "to build the replicas on the host"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if n is not None:
        devs = [devs[i % len(devs)] for i in range(n)]
    scheds = []
    for i, dev in enumerate(devs):
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            scheds.append(build(i, dev))
    return scheds, devs
