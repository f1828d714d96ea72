"""Deterministic fault injection for the serving stack, in PyTorch (the
port's own copy of ``repro.serving.faults``; numpy only, as there).

The fault model: a seeded, recorded schedule of failures injected at the
scheduler's engine/pool boundary, so every chaos run is replayable.

Fault taxonomy (:class:`FaultKind`):

* ``STEP_FAILURE`` — the decode "ran" but its effects must be discarded
  (a transient device error).  Recoverable: the scheduler rolls the tick
  back to its pre-step snapshot and retries with capped exponential
  backoff (:class:`RetryPolicy`).
* ``OOM`` — the pool's free stack is emptied right before the decode,
  so every allocation in the step fails (sticky ``oom`` flag, dump-row
  writes) — then the step is failed.  Recoverable the same way; the
  rollback restores the pre-starvation pool, flag and payload included.
* ``LATENCY`` — the step stalls for ``delay_s`` host seconds.  Not an
  error: no retry, results unaffected.
* ``NAN_LOGITS`` — one request's logits rows are poisoned to NaN after
  the decode.  The scheduler's quarantine detects the non-finite rows
  and terminates *that* request (``RequestStatus.POISONED``) at the
  tick's trailing edge; the shared batch is unaffected.
* ``DEVICE_LOSS`` — the device is gone.  Unrecoverable: raised as
  :class:`DeviceLost` *before* any state is mutated, so the pool is
  still invariant-clean and a :meth:`Scheduler.checkpoint` taken
  earlier restores bit-exactly in a fresh process.

Consumption semantics: an event fires on the decode *attempt(s)* at its
tick — ``repeats`` consecutive attempts for the failing kinds — and is
then spent.  Ticks the scheduler never decodes (idle fast-forward)
never consume their events.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "AllReplicasSaturated",
    "DeviceLost",
    "FaultEvent",
    "FaultInjector",
    "FaultKind",
    "FaultRetriesExhausted",
    "InvariantViolation",
    "RequestStatus",
    "RetryPolicy",
    "TransientStepFailure",
    "chaos_schedule",
    "fault_tuple",
    "schedule_from_json",
    "schedule_to_json",
]


class FaultKind(str, enum.Enum):
    STEP_FAILURE = "step_failure"
    OOM = "oom"
    LATENCY = "latency"
    NAN_LOGITS = "nan_logits"
    DEVICE_LOSS = "device_loss"


#: The kinds the scheduler recovers from by rollback-retry.
RECOVERABLE = (FaultKind.STEP_FAILURE, FaultKind.OOM, FaultKind.LATENCY)


class RequestStatus(str, enum.Enum):
    """Typed terminal status of a request (``SMCDecodeResult.status``).

    Every submitted request ends in exactly one of these — nothing is
    silently dropped, and nothing hangs the batch (DESIGN.md §10).
    """

    OK = "ok"
    CANCELLED = "cancelled"  # Scheduler.cancel(rid)
    EXPIRED = "expired"  # deadline passed (queued or active)
    POISONED = "poisoned"  # non-finite logits quarantined
    SHED = "shed"  # dropped by the load-shedding admission policy


class TransientStepFailure(RuntimeError):
    """A decode attempt whose effects must be discarded (injected
    ``STEP_FAILURE``/``OOM``).  Caught by the scheduler's retry loop —
    never escapes a :meth:`Scheduler.run` unless retries are exhausted
    (then wrapped in :class:`FaultRetriesExhausted`)."""

    def __init__(self, msg: str, events: Sequence["FaultEvent"] = ()):
        super().__init__(msg)
        self.events = tuple(events)


class FaultRetriesExhausted(RuntimeError):
    """The same tick failed more than ``RetryPolicy.max_retries`` times.
    The scheduler restores its pre-tick snapshot before raising, so the
    pool is invariant-clean for a post-mortem checkpoint."""

    def __init__(self, msg: str, tick: int, attempts: int):
        super().__init__(msg)
        self.tick = tick
        self.attempts = attempts


class DeviceLost(RuntimeError):
    """Unrecoverable device loss.  Raised before any state mutation:
    recovery is a fresh process restoring the last checkpoint."""


class AllReplicasSaturated(RuntimeError):
    """Requests are waiting but no scheduler (replica) can ever admit
    them and no active work remains to free capacity.  Without this, the
    loop would burn ticks forever — a decode tick per round with an
    empty batch — while the wait queue never drains.  Raised (after a
    ``("saturated", tick, rids)`` event) instead of the silent spin;
    the simulator raises at the identical decision point so the surface
    is differentially testable."""

    def __init__(self, msg: str, *, tick: int, rids: Sequence[str] = ()):
        super().__init__(msg)
        self.tick = tick
        self.rids = tuple(rids)


class InvariantViolation(AssertionError):
    """The online watchdog found corrupted bookkeeping (free-stack /
    refcount / slot-table conservation).  Carries every failed check."""

    def __init__(self, problems: Sequence[str], tick: int):
        super().__init__(
            f"pool invariants violated at tick {tick}: " + "; ".join(problems)
        )
        self.problems = tuple(problems)
        self.tick = tick


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped exponential backoff for transient step failures.  The
    default base of 0 sleeps never (tests and CI); production sets a
    base and the delay doubles per attempt up to ``backoff_cap_s``."""

    max_retries: int = 3
    backoff_base_s: float = 0.0
    backoff_cap_s: float = 1.0

    def delay_s(self, attempt: int) -> float:
        if self.backoff_base_s <= 0.0:
            return 0.0
        return min(self.backoff_cap_s, self.backoff_base_s * 2.0 ** (attempt - 1))


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``tick`` is the scheduler tick whose decode
    attempt(s) it hits; ``rid`` targets ``NAN_LOGITS`` at one request;
    ``repeats`` makes the failing kinds hit that many consecutive
    attempts (``repeats > max_retries + 1`` exhausts the retry loop)."""

    kind: FaultKind
    tick: int
    rid: Optional[str] = None
    delay_s: float = 0.0
    repeats: int = 1


class FaultInjector:
    """Consumes a deterministic schedule of :class:`FaultEvent`\\ s.

    One injector instance drives one run — construct a fresh one (or
    :meth:`reset`) to replay the same schedule against another scheduler
    (the simulator's differential gate does exactly that)."""

    def __init__(self, schedule: Sequence[FaultEvent] = ()):
        self.schedule = tuple(schedule)
        self._left: List[int] = [ev.repeats for ev in self.schedule]
        self.fired = 0

    def reset(self) -> "FaultInjector":
        return FaultInjector(self.schedule)

    def step_events(self, tick: int) -> List[FaultEvent]:
        """The events hitting this decode attempt (consumed)."""
        out: List[FaultEvent] = []
        for i, ev in enumerate(self.schedule):
            if ev.tick == tick and self._left[i] > 0:
                self._left[i] -= 1
                self.fired += 1
                out.append(ev)
        return out


def chaos_schedule(
    seed: int,
    ticks: int,
    *,
    rate: float = 0.1,
    kinds: Sequence[FaultKind] = RECOVERABLE,
    rids: Sequence[str] = (),
    p_poison: float = 0.0,
    delay_s: float = 0.0,
    max_repeats: int = 1,
) -> List[FaultEvent]:
    """Seeded random fault schedule: each tick draws a fault from
    ``kinds`` with probability ``rate`` (failing kinds repeat uniformly
    in ``[1, max_repeats]``), and poisons a random request of ``rids``
    with probability ``p_poison``.  Same seed, same schedule, every
    process — the chaos harness's reproducibility contract."""
    rng = np.random.default_rng(seed)
    out: List[FaultEvent] = []
    kinds = tuple(kinds)
    for t in range(ticks):
        if kinds and rng.random() < rate:
            kind = kinds[int(rng.integers(len(kinds)))]
            repeats = 1
            if kind in (FaultKind.STEP_FAILURE, FaultKind.OOM):
                repeats = int(rng.integers(1, max_repeats + 1))
            out.append(
                FaultEvent(
                    kind=kind,
                    tick=t,
                    delay_s=delay_s if kind is FaultKind.LATENCY else 0.0,
                    repeats=repeats,
                )
            )
        if rids and rng.random() < p_poison:
            rid = rids[int(rng.integers(len(rids)))]
            out.append(FaultEvent(kind=FaultKind.NAN_LOGITS, tick=t, rid=rid))
    return out


# -- serialization (the committed chaos regression corpus) -------------------


def schedule_to_json(schedule: Sequence[FaultEvent]) -> str:
    rows = [
        {
            "kind": ev.kind.value,
            "tick": ev.tick,
            "rid": ev.rid,
            "delay_s": ev.delay_s,
            "repeats": ev.repeats,
        }
        for ev in schedule
    ]
    return json.dumps(rows, indent=2, sort_keys=True)


def schedule_from_json(text: str) -> List[FaultEvent]:
    return [
        FaultEvent(
            kind=FaultKind(row["kind"]),
            tick=row["tick"],
            rid=row.get("rid"),
            delay_s=row.get("delay_s", 0.0),
            repeats=row.get("repeats", 1),
        )
        for row in json.loads(text)
    ]


def fault_tuple(ev: FaultEvent, tick: int) -> tuple:
    """The canonical event-log decision tuple for a fired fault — shared
    by the real scheduler and the simulator so chaos logs compare
    tuple-for-tuple."""
    if ev.kind is FaultKind.NAN_LOGITS:
        return ("fault", ev.kind.value, tick, ev.rid)
    return ("fault", ev.kind.value, tick)


#: Schedules bundled as {name: (trace_kwargs, schedule)} specs live in
#: tests/chaos_corpus/*.json.
CorpusSpec = Dict[str, object]
