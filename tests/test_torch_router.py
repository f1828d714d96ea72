"""The port's replica router, against the JAX reference's and against
itself.

* **Simulated fleets equal the reference's.**  The port's ``Router`` over
  the port's ``SimScheduler``\\ s and the reference's over its own, fed
  the same trace, give equal router event logs, per-replica decisions,
  latency percentiles in rounds and utilization, under all three
  placement policies; saturation raises ``AllReplicasSaturated`` after
  the same ``("saturated", ...)`` event in real and simulated fleets.
* **Replication is invisible to results.**  A 2-replica port fleet on the
  CPU gives every request the tokens, log-weights, log-evidence, ESS and
  resampling steps of a 1-replica fleet of the same ``max_seqs``, and
  ``Router.stream()`` rebuilds the collected tokens.
* **A real fleet replays through the simulator.**  The union of the
  replicas' recorded traces, in submission order, through
  ``simulate_router`` gives the real fleet's router event log and each
  replica's decisions: held on the reference first (its own real fleet
  against its own simulator), then on the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import smoke_config  # noqa: E402
from repro.models.model import LanguageModel as JLanguageModel  # noqa: E402
from repro.serving import router as jrouter  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving import sim as jsim  # noqa: E402
from repro.serving import traces as jtraces  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serving.kv_cache import KVCacheConfig as JKVCacheConfig  # noqa: E402
from repro_torch.configs.starcoder2_3b import SMOKE  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import router as trouter  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving import sim as tsim  # noqa: E402
from repro_torch.serving import traces as ttraces  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.kv_cache import KVCacheConfig  # noqa: E402

BS = 4
TARGET, PROPOSAL = 1.0, 4.0  # temperatures at which the smoke model resamples
COST = dict(step_s=1e-3, prefill_s=2e-3, grow_s_per_block=1e-5, compact_s_per_block=1e-5)
CPU = [torch.device("cpu")]


def cache_kw(max_seqs):
    return dict(n_layers=SMOKE.n_layers, n_kv_heads=SMOKE.n_kv_heads, head_dim=SMOKE.hd,
                block_size=BS, max_seqs=max_seqs, max_blocks_per_seq=24, dtype=SMOKE.dtype)


# ---------------------------------------------------------------------------
# simulated fleets, against the reference's
# ---------------------------------------------------------------------------


def sessions(lib):
    """Requests whose rids share ``"sN/"`` prefixes (affinity's input)."""
    reqs = tuple(
        lib.TraceRequest(rid=rid, arrive_at=i * 2, n_particles=4, steps=6 + i % 3, plen=4 + i,
                         seed=i)
        for i, rid in enumerate(["s0/a", "s1/a", "s0/b", "s1/b", "s0/c", "s2/a", "s1/c"]))
    return lib.with_synthetic_forks(lib.Trace(name="sessions", requests=reqs), 0.4)


TRACES = {
    "stagger2": lambda lib: lib.with_synthetic_forks(
        lib.staggered(6, 2, n_particles=4, steps=8, plen=(3, 12), seed=0), 0.5),
    "bursty": lambda lib: lib.with_synthetic_forks(
        lib.bursty(2, 4, 6, n_particles=(2, 6), steps=(2, 12), plen=(1, 14), seed=1), 0.5),
    "poisson": lambda lib: lib.with_synthetic_forks(
        lib.poisson(10, 0.6, n_particles=(1, 8), steps=(0, 10), plen=(1, 20), seed=2), 0.3),
    "sessions": sessions,
}


def sim_fleet(sched_lib, router_lib, sim_lib, ccfg_cls, placement, max_seqs=(8, 8),
              num_blocks=0, **knobs):
    scheds = [sim_lib.SimScheduler(ccfg_cls(**cache_kw(m), num_blocks=num_blocks),
                                   sim_lib.CostModel(**COST), **knobs)
              for m in max_seqs]
    return router_lib.Router(scheds, placement=placement, event_log=router_lib.RouterEventLog())


def drive(router, trace):
    for r in trace.requests:
        router.submit(r)
    router.run()
    return router


def same_fleets(got, want):
    assert got.event_log.events == want.event_log.events
    assert got.round == want.round and got.placement_name == want.placement_name
    np.testing.assert_equal(got.event_log.latency_rounds(), want.event_log.latency_rounds())
    assert got.utilization() == want.utilization()
    assert list(got.results) == list(want.results)
    for a, b in zip(got.replicas, want.replicas, strict=True):
        assert a.scheduler.decisions == b.scheduler.decisions
        assert a.scheduler.stats.as_dict() == b.scheduler.stats.as_dict()


@pytest.mark.parametrize("num_blocks", [0, 12], ids=["auto_pool", "small_pool"])
@pytest.mark.parametrize("trace", sorted(TRACES))
@pytest.mark.parametrize("placement", sorted(trouter.PLACEMENT_POLICIES))
def test_sim_fleet_equals_reference(placement, trace, num_blocks):
    """Two replicas of unequal width (a request of 8 fits only the wide
    one), growth and the default knobs, under each placement; with a pool
    of 12 pages, placement counts on the headroom growth gives."""
    jt, tt = TRACES[trace](jtraces), TRACES[trace](ttraces)
    assert ttraces.to_json(tt) == jtraces.to_json(jt)
    want = drive(sim_fleet(jsched, jrouter, jsim, JKVCacheConfig, placement, (6, 10), num_blocks), jt)
    got = drive(sim_fleet(tsched, trouter, tsim, KVCacheConfig, placement, (6, 10), num_blocks), tt)
    same_fleets(got, want)
    if num_blocks:
        assert any(e[0] == "grow" for rep in got.replicas for e in rep.scheduler.decisions)
    placed = {e[3] for e in got.event_log.events if e[0] == "place"}
    assert placed == {0, 1}


def test_simulate_router_equals_reference():
    """The helper over a fixed-pool fleet that queues: placement latency
    in rounds, utilization, every replica's decisions."""
    jt, tt = TRACES["bursty"](jtraces), TRACES["bursty"](ttraces)
    kw = {**cache_kw(8), "num_blocks": 24}
    want = jsim.simulate_router(jt, JKVCacheConfig(**kw), jsim.CostModel(**COST), n_replicas=2,
                                placement="round_robin", grow=False)
    got = tsim.simulate_router(tt, KVCacheConfig(**kw), tsim.CostModel(**COST), n_replicas=2,
                               placement="round_robin", grow=False)
    same_fleets(got, want)
    assert got.event_log.latency_rounds()["queue_p99"] > 0
    assert sum(u["completed"] for u in got.utilization()) == len(tt.requests)


def test_placement_edges():
    """A request wider than one replica's slot table goes to the one that
    fits it; an unknown policy name raises."""
    fleet = sim_fleet(tsched, trouter, tsim, KVCacheConfig, "least_loaded", (4, 12))
    drive(fleet, ttraces.Trace(name="wide", requests=(
        ttraces.TraceRequest(rid="wide", arrive_at=0, n_particles=8, steps=4, plen=4),)))
    assert fleet.event_log.events[0] == ("place", "wide", 0, 1)
    with pytest.raises(ValueError, match="unknown placement"):
        trouter.Router(fleet.replicas, placement="nope")
    with pytest.raises(ValueError, match="at least one replica"):
        trouter.Router([])


# ---------------------------------------------------------------------------
# real fleets on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    return LanguageModel(SMOKE).init(torch.Generator().manual_seed(0), device="cpu")


def requests(trace):
    """The trace lowered on the CPU, at temperatures that resample."""
    return [dataclasses.replace(r, proposal_temp=PROPOSAL) for r in ttraces.to_decode_requests(
        trace, SMOKE.vocab_size, target_temp=TARGET, token_block_size=BS, device="cpu")]


def real_fleet(params, n_replicas, max_seqs, placement="least_loaded", logs=None):
    ccfg = KVCacheConfig(**cache_kw(max_seqs))

    def build(i, dev):
        log = None if logs is None else logs.setdefault(i, tsched.SchedulerEventLog())
        return tsched.Scheduler(ServeEngine(LanguageModel(SMOKE), params, ccfg, device=dev),
                                event_log=log)

    scheds, devs = trouter.make_replicas(build, n=n_replicas, devices=CPU)
    return trouter.Router(scheds, placement=placement, event_log=trouter.RouterEventLog(),
                          devices=devs)


def test_two_replicas_bit_exact_with_one(params):
    """Four staggered requests through a 2-replica fleet and through a
    1-replica fleet of the same ``max_seqs``: equal results; both
    replicas served; the 1-replica fleet queued."""
    reqs = requests(ttraces.staggered(4, 2, n_particles=4, steps=(6, 10), plen=(4, 9), seed=5))
    two, one = real_fleet(params, 2, 8), real_fleet(params, 1, 8)
    for r in reqs:
        two.submit(r)
        one.submit(r)
    res2, res1 = two.run(), one.run()
    assert sorted(res2) == sorted(res1) == [r.rid for r in reqs]
    for r in reqs:
        for f in ("tokens", "log_weights", "log_evidence", "ess_trace", "resampled"):
            assert torch.equal(getattr(res2[r.rid], f), getattr(res1[r.rid], f)), (r.rid, f)
    assert any(bool(res2[r.rid].resampled.any()) for r in reqs)
    assert {e[3] for e in two.event_log.events if e[0] == "place"} == {0, 1}
    assert one.event_log.latency_rounds()["queue_p99"] > 0
    assert [u["device"] for u in two.utilization()] == ["cpu", "cpu"]


def test_fleet_streaming_parity(params):
    """``Router.stream()`` yields every replica's committed tokens; each
    request's events rebuild its collected tokens, and the last one
    carries its status."""
    reqs = requests(ttraces.staggered(3, 1, n_particles=4, steps=(6, 10), plen=(4, 9), seed=6))
    fleet = real_fleet(params, 2, 4)
    for r in reqs:
        fleet.submit(r)
    events = list(fleet.stream())
    res = fleet.results
    for r in reqs:
        evs = [ev for ev in events if ev.rid == r.rid]
        assert evs[-1].final and evs[-1].status == res[r.rid].status == "ok"
        rec = tsched.stream_tokens(evs, n=r.n_particles, steps=r.steps)
        np.testing.assert_array_equal(rec, res[r.rid].tokens.numpy())
    assert all(rep.scheduler.on_token is None for rep in fleet.replicas)


def test_saturation_differential(params):
    """A request no replica can ever hold: the port's real fleet, the
    port's simulated fleet and the reference's simulated fleet emit the
    same event and raise the same type."""
    trace = ttraces.Trace(name="huge", requests=(
        ttraces.TraceRequest(rid="huge", arrive_at=0, n_particles=12, steps=4, plen=4, seed=1),))
    real = real_fleet(params, 2, 4)
    fleets = [(real, requests(trace)),
              (sim_fleet(tsched, trouter, tsim, KVCacheConfig, "least_loaded", (4, 4)),
               trace.requests)]
    logs = []
    for fleet, reqs in fleets:
        for r in reqs:
            fleet.submit(r)
        with pytest.raises(tfaults.AllReplicasSaturated) as exc:
            fleet.run()
        assert exc.value.rids == ("huge",)
        logs.append(fleet.event_log.events)
    jfleet = sim_fleet(jsched, jrouter, jsim, JKVCacheConfig, "least_loaded", (4, 4))
    with pytest.raises(jrouter.AllReplicasSaturated):
        drive(jfleet, jtraces.from_json(ttraces.to_json(trace)))
    assert logs[0] == logs[1] == jfleet.event_log.events == [("saturated", 0, ("huge",))]


def test_make_replicas_devices():
    """``n`` cycles the device list; the devices default to every card and
    raise when there is none."""
    built = []
    scheds, devs = trouter.make_replicas(lambda i, d: built.append((i, d)) or i, n=3, devices=CPU)
    assert scheds == [0, 1, 2] and devs == CPU * 3 and built == list(zip(range(3), CPU * 3))
    if torch.cuda.is_available():
        _, devs = trouter.make_replicas(lambda i, d: i)
        assert [d.type for d in devs] == ["cuda"] * torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trouter.make_replicas(lambda i, d: i, n=2)


# ---------------------------------------------------------------------------
# a real fleet replayed through the simulator
# ---------------------------------------------------------------------------

FLEET_TRACE = dict(n_particles=4, steps=10, plen=6, seed=1)


def union(logs, rids, lib):
    """The replicas' recorded traces as one, in the fleet's submission
    order."""
    recorded = {r.rid: r for log in logs.values() for r in log.to_trace().requests}
    return lib.Trace(name="fleet", requests=tuple(recorded[rid] for rid in rids))


def test_reference_fleet_replays_through_its_simulator():
    """The reference's own real fleet against ``simulate_router`` over its
    replicas' recorded traces: the fleet-level replay is the reference's
    contract before it is the port's."""
    cfg = smoke_config("starcoder2_3b")
    lm = JLanguageModel(cfg)
    params, _ = lm.init(jax.random.PRNGKey(0))
    ccfg = JKVCacheConfig(**{**cache_kw(8), "n_layers": cfg.n_layers, "n_kv_heads": cfg.n_kv_heads,
                             "head_dim": cfg.hd, "dtype": cfg.dtype})
    logs = {}

    def build(i, dev):
        return jsched.Scheduler(JServeEngine(lm, params, ccfg),
                                event_log=logs.setdefault(i, jsched.SchedulerEventLog()))

    scheds, devs = jrouter.make_replicas(build, n=2)
    fleet = jrouter.Router(scheds, event_log=jrouter.RouterEventLog(), devices=devs)
    trace = jtraces.staggered(5, 2, **FLEET_TRACE)
    for r in jtraces.to_decode_requests(trace, cfg.vocab_size, target_temp=TARGET,
                                        token_block_size=BS):
        fleet.submit(dataclasses.replace(r, proposal_temp=PROPOSAL))
    fleet.run()
    replay = union(logs, [r.rid for r in trace.requests], jtraces)
    assert any(r.forks for r in replay.requests)
    sim = jsim.simulate_router(replay, ccfg, jsim.CostModel(**COST), n_replicas=2)
    assert sim.event_log.events == fleet.event_log.events
    for i, log in logs.items():
        assert jsim.first_divergence(log.decisions, sim.replicas[i].scheduler.decisions) is None
    assert fleet.event_log.latency_rounds()["queue_p99"] > 0


def test_port_fleet_replays_through_its_simulator(params):
    """The same on the port: a 2-replica CPU fleet's router event log and
    every replica's decisions, from the simulator."""
    logs = {}
    fleet = real_fleet(params, 2, 8, logs=logs)
    trace = ttraces.staggered(5, 2, **FLEET_TRACE)
    for r in requests(trace):
        fleet.submit(r)
    fleet.run()
    replay = union(logs, [r.rid for r in trace.requests], ttraces)
    assert any(r.forks for r in replay.requests)
    sim = tsim.simulate_router(replay, KVCacheConfig(**cache_kw(8)), tsim.CostModel(**COST),
                               n_replicas=2)
    assert sim.event_log.events == fleet.event_log.events
    for i, log in logs.items():
        assert tsim.first_divergence(log.decisions, sim.replicas[i].scheduler.decisions) is None
    assert fleet.event_log.latency_rounds()["queue_p99"] > 0
