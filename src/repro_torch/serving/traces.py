"""Seeded arrival traces, in the port (its own copy of
``repro.serving.traces``; numpy only, as there).

The scheduler's differential oracle (:mod:`repro_torch.serving.sim`), the
router's fleet replay and the benches consume *request arrival traces*: a
:class:`Trace` of :class:`TraceRequest` rows, produced by seeded
generators, so the same seed gives the same bytes in every process and in
both packages (``tests/test_torch_traces.py`` holds the two to equal
``to_json`` output).

Two kinds of trace:

* **synthetic** — :func:`staggered`, :func:`poisson`, :func:`bursty`,
  :func:`diurnal` draw arrivals (and optionally per-request sizes) from
  a ``numpy`` ``default_rng`` seeded explicitly, never from process
  state.  :func:`with_synthetic_forks` adds a seeded resample schedule
  so the simulator can model COW sharing without running a model.
* **recorded** — ``Scheduler(event_log=...)`` captures the fork
  (ancestor) schedule a real run actually took;
  ``SchedulerEventLog.to_trace()`` rebuilds a :class:`Trace` whose
  replay through the simulator must be decision-exact.

``arrive_at`` is in token-boundary ticks — the unit the scheduler's
admission loop uses (``DecodeRequest.arrive_at``).

:func:`to_decode_requests` is where the port differs: it draws each
prompt with ``torch.randint`` from a generator seeded with the request's
``seed`` (the reference draws from a threefry key, which the port does
not have), so the port's prompts are not the reference's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - typing only
    import torch

    from repro_torch.serving.scheduler import DecodeRequest

__all__ = [
    "Trace",
    "TraceRequest",
    "bursty",
    "diurnal",
    "from_json",
    "poisson",
    "staggered",
    "to_decode_requests",
    "to_json",
    "with_deadlines",
    "with_synthetic_forks",
]

# An int spec is a fixed value; a (lo, hi) spec draws uniformly
# (inclusive) per request from the trace's seeded rng.
SizeSpec = Union[int, Tuple[int, int]]


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One request of an arrival trace.

    ``seed`` derives the request's prompt and generator when the trace is
    lowered to real :class:`~repro_torch.serving.scheduler.DecodeRequest`s
    (:func:`to_decode_requests`), and its synthetic fork schedule
    (:func:`with_synthetic_forks`).  ``forks`` maps step -> ancestor
    tuple; ``None`` means "no resample at any step" until a schedule is
    attached or recorded.  ``deadline`` mirrors
    ``DecodeRequest.deadline`` (ticks; ``None`` = no SLA bound) so
    chaos/SLA traces replay decision-exact through the simulator.
    """

    rid: str
    arrive_at: int
    n_particles: int
    steps: int
    plen: int
    seed: int = 0
    forks: Optional[Dict[int, Tuple[int, ...]]] = None
    deadline: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Trace:
    name: str
    requests: Tuple[TraceRequest, ...]
    seed: int = 0

    @property
    def total_tokens(self) -> int:
        return sum(r.n_particles * r.steps for r in self.requests)


def _draw(spec: SizeSpec, rng: np.random.Generator) -> int:
    if isinstance(spec, tuple):
        lo, hi = spec
        return int(rng.integers(lo, hi + 1))
    return int(spec)


def _build(
    name: str,
    arrivals: Sequence[int],
    n_particles: SizeSpec,
    steps: SizeSpec,
    plen: SizeSpec,
    seed: int,
    rng: np.random.Generator,
) -> Trace:
    reqs = tuple(
        TraceRequest(
            rid=f"r{i}",
            arrive_at=int(t),
            n_particles=_draw(n_particles, rng),
            steps=_draw(steps, rng),
            plen=_draw(plen, rng),
            seed=seed * 100_000 + i,
        )
        for i, t in enumerate(arrivals)
    )
    return Trace(name=name, requests=reqs, seed=seed)


def staggered(
    n_reqs: int,
    interval: int,
    *,
    n_particles: SizeSpec,
    steps: SizeSpec,
    plen: SizeSpec,
    seed: int = 0,
    name: Optional[str] = None,
) -> Trace:
    """Requests every ``interval`` ticks — ``interval=0`` is the bench's
    ``burst`` pattern, 2/6 its ``stagger2``/``stagger6``."""
    rng = np.random.default_rng(seed)
    arrivals = [i * interval for i in range(n_reqs)]
    return _build(
        name or (f"stagger{interval}" if interval else "burst"),
        arrivals,
        n_particles,
        steps,
        plen,
        seed,
        rng,
    )


def poisson(
    n_reqs: int,
    rate: float,
    *,
    n_particles: SizeSpec,
    steps: SizeSpec,
    plen: SizeSpec,
    seed: int = 0,
    name: Optional[str] = None,
) -> Trace:
    """Poisson arrivals at ``rate`` requests per tick (exponential
    inter-arrival gaps, accumulated and floored onto the tick grid)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate, 1e-9), n_reqs)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    return _build(
        name or f"poisson{rate:g}", arrivals, n_particles, steps, plen, seed, rng
    )


def bursty(
    n_bursts: int,
    burst_size: int,
    gap: int,
    *,
    n_particles: SizeSpec,
    steps: SizeSpec,
    plen: SizeSpec,
    seed: int = 0,
    name: Optional[str] = None,
) -> Trace:
    """``n_bursts`` simultaneous bursts of ``burst_size`` requests,
    ``gap`` ticks apart — the flash-crowd arrival shape."""
    rng = np.random.default_rng(seed)
    arrivals = [b * gap for b in range(n_bursts) for _ in range(burst_size)]
    return _build(
        name or f"bursty{burst_size}x{n_bursts}",
        arrivals,
        n_particles,
        steps,
        plen,
        seed,
        rng,
    )


def diurnal(
    n_reqs: int,
    period: int,
    peak_rate: float,
    trough_rate: float,
    *,
    n_particles: SizeSpec,
    steps: SizeSpec,
    plen: SizeSpec,
    seed: int = 0,
    name: Optional[str] = None,
) -> Trace:
    """Sinusoidal-rate arrivals (period in ticks): a thinned Poisson
    process whose instantaneous rate swings between ``trough_rate`` and
    ``peak_rate`` — the day/night serving load shape."""
    rng = np.random.default_rng(seed)
    arrivals: List[int] = []
    t = 0.0
    while len(arrivals) < n_reqs:
        t += rng.exponential(1.0 / max(peak_rate, 1e-9))
        phase = 0.5 * (1.0 + np.sin(2.0 * np.pi * t / period))
        rate_t = trough_rate + (peak_rate - trough_rate) * phase
        if rng.random() < rate_t / peak_rate:  # thinning
            arrivals.append(int(t))
    return _build(
        name or f"diurnal{period}", arrivals, n_particles, steps, plen, seed, rng
    )


def with_deadlines(
    trace: Trace,
    slack_x: float = 2.0,
    floor: int = 4,
    tight_every: int = 0,
    tight_slack_x: float = 1.1,
) -> Trace:
    """Attach SLA deadlines to a trace: each request's deadline is
    ``arrive_at + max(floor, ceil(slack_x * steps))`` ticks — a service
    level proportional to the work requested.  With ``tight_every = k >
    0``, every ``k``-th request gets the tighter ``tight_slack_x``
    multiplier instead: the mixed loose/tight population the SLA-aware
    preemption policy is measured on (bench_scheduler's ``sla_bursty``
    scenario).  Deterministic — no rng draw — so the same trace gets
    the same deadlines in every process."""
    reqs: List[TraceRequest] = []
    for i, r in enumerate(trace.requests):
        x = tight_slack_x if tight_every and (i + 1) % tight_every == 0 else slack_x
        deadline = r.arrive_at + max(floor, int(np.ceil(x * r.steps)))
        reqs.append(dataclasses.replace(r, deadline=deadline))
    return dataclasses.replace(trace, requests=tuple(reqs))


def with_synthetic_forks(trace: Trace, p_resample: float = 0.5) -> Trace:
    """Attach a seeded resample schedule to every request: step ``t``
    resamples with probability ``p_resample``, ancestors drawn uniformly.

    The schedule drives the simulator's COW accounting for traces that
    were never run on a model; it is derived from each request's own
    ``seed``, so the same trace yields the same schedule in every
    process.
    """
    reqs = []
    for r in trace.requests:
        rng = np.random.default_rng((r.seed, 0xF0CC5))
        forks: Dict[int, Tuple[int, ...]] = {}
        for t in range(r.steps):
            if rng.random() < p_resample:
                forks[t] = tuple(
                    int(a) for a in rng.integers(0, r.n_particles, r.n_particles)
                )
        reqs.append(dataclasses.replace(r, forks=forks))
    return Trace(name=trace.name, requests=tuple(reqs), seed=trace.seed)


def to_decode_requests(
    trace: Trace,
    vocab_size: int,
    *,
    target_temp: float = 0.5,
    token_block_size: Optional[int] = None,
    key_base: int = 1000,
    device: "torch.device | str" = "cuda",
) -> "List[DecodeRequest]":
    """Lower a trace to real :class:`DecodeRequest`s on ``device`` (the card
    by default; it raises when there is none): each prompt is
    ``torch.randint(0, vocab_size, (plen,))`` from a generator seeded with
    the request's ``seed``, and each request's generator is seeded with
    ``key_base + seed``."""
    import torch  # deferred: trace generation itself stays numpy-only

    from repro_torch.kernels.dispatch import resolve_device
    from repro_torch.serving.scheduler import DecodeRequest

    dev = resolve_device(device)

    def seeded(seed: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(seed)

    return [
        DecodeRequest(
            rid=r.rid,
            prompt=torch.randint(
                0, vocab_size, (r.plen,), generator=seeded(r.seed), device=dev
            ),
            n_particles=r.n_particles,
            steps=r.steps,
            gen=seeded(key_base + r.seed),
            target_temp=target_temp,
            token_block_size=token_block_size,
            arrive_at=r.arrive_at,
            deadline=r.deadline,
        )
        for r in trace.requests
    ]


# -- serialization (CI artifacts + the cross-process regression test) --------


def to_json(trace: Trace) -> str:
    payload = {
        "name": trace.name,
        "seed": trace.seed,
        "requests": [
            {
                "rid": r.rid,
                "arrive_at": r.arrive_at,
                "n_particles": r.n_particles,
                "steps": r.steps,
                "plen": r.plen,
                "seed": r.seed,
                "deadline": r.deadline,
                "forks": (
                    None
                    if r.forks is None
                    else {str(t): list(a) for t, a in sorted(r.forks.items())}
                ),
            }
            for r in trace.requests
        ],
    }
    return json.dumps(payload, indent=2, sort_keys=True)


def from_json(text: str) -> Trace:
    payload = json.loads(text)
    reqs = tuple(
        TraceRequest(
            rid=r["rid"],
            arrive_at=r["arrive_at"],
            n_particles=r["n_particles"],
            steps=r["steps"],
            plen=r["plen"],
            seed=r["seed"],
            # .get: traces recorded before the fault-model PR have no
            # deadline field.
            deadline=r.get("deadline"),
            forks=(
                None
                if r["forks"] is None
                else {int(t): tuple(a) for t, a in r["forks"].items()}
            ),
        )
        for r in payload["requests"]
    )
    return Trace(name=payload["name"], requests=reqs, seed=payload["seed"])
