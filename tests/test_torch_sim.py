"""The port's scheduler simulator, against the JAX reference's and against
the port's own scheduler.

Two contracts:

* **Bit-equal with the reference's simulator.**  The same trace (the
  port's generators give the reference's bytes, ``test_torch_traces``)
  and the same cost numbers through ``repro.serving.sim`` and
  ``repro_torch.serving.sim`` give equal decisions, ``SchedulerStats``,
  ``peak_blocks``, ``pool_peak``, ``sim_time_s`` and latency percentiles:
  seeded random traces with synthetic forks over random pools, knobs,
  preemption policies, admission policies and fault schedules, and the
  three ``tests/chaos_corpus/*.json`` schedules with their injectors.
  The roofline and write-path arithmetic behind ``CostModel`` is held
  equal for every model family the reference configures.
* **Decision-exact with the port's scheduler** at starcoder2-3b's smoke
  width on the CPU: a recorded run's ``to_trace`` replays through
  ``simulate`` tuple for tuple, peak blocks and stats equal — the
  reference's ``TestDecisionExact`` scenarios, its chaos differentials,
  the SLA-policy and no-progress differentials, the chaos corpus — and
  the calibrated cost model predicts the recorded wall within +/-25%.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.configs import ARCHS, get_config  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import write_path as jwrite  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving import sim as jsim  # noqa: E402
from repro.serving import traces as jtraces  # noqa: E402
from repro.serving.kv_cache import KVCacheConfig as JKVCacheConfig  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.configs.starcoder2_3b import SMOKE  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.roofline import analysis as tanalysis  # noqa: E402
from repro_torch.roofline import write_path as twrite  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving import sim as tsim  # noqa: E402
from repro_torch.serving import traces as ttraces  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.kv_cache import KVCacheConfig  # noqa: E402

BS = 4
TARGET, PROPOSAL = 1.0, 4.0  # temperatures at which the smoke model resamples
CORPUS_DIR = os.path.join(os.path.dirname(__file__), "chaos_corpus")
COST = dict(step_s=1e-3, prefill_s=2e-3, grow_s_per_block=1e-5, compact_s_per_block=1e-5)
# What a simulated schedule may end in, in each package.
J_ENDS = (jsched.AdmissionRefused, jfaults.AllReplicasSaturated, jfaults.DeviceLost,
          jfaults.FaultRetriesExhausted)
T_ENDS = (tsched.AdmissionRefused, tfaults.AllReplicasSaturated, tfaults.DeviceLost,
          tfaults.FaultRetriesExhausted)


def corpus():
    files = sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json")))
    assert len(files) == 3, files
    return [json.load(open(f)) for f in files]


# ---------------------------------------------------------------------------
# the port's simulator against the reference's
# ---------------------------------------------------------------------------


def both_traces(make):
    """``make(lib)`` with each package's traces module; their JSON equal."""
    jt, tt = make(jtraces), make(ttraces)
    assert ttraces.to_json(tt) == jtraces.to_json(jt)
    return jt, tt


def run_sim(sim_lib, faults_lib, ends, trace, ccfg, schedule, knobs):
    """``trace`` through a fresh ``SimScheduler``; the result, or the
    decisions and the exception's type name where the schedule ended in
    a typed refusal or failure."""
    faults = None if schedule is None else faults_lib.FaultInjector(
        faults_lib.schedule_from_json(schedule))
    sched = sim_lib.SimScheduler(ccfg, sim_lib.CostModel(**COST), faults=faults, **knobs)
    for r in trace.requests:
        sched.submit(r)
    try:
        res = sched.run()
    except ends as exc:
        return None, sched.decisions, type(exc).__name__
    return res, res.decisions, None


def same_outcome(got, want):
    """Equal decisions and ending; for a finished schedule every field of
    ``SimResult`` and its latency percentiles (NaN equal to NaN)."""
    (tres, tdec, texc), (jres, jdec, jexc) = got, want
    assert tdec == jdec
    assert texc == jexc
    if jres is None:
        return
    assert tres.stats.as_dict() == jres.stats.as_dict()
    for f in ("peak_blocks", "pool_peak", "num_blocks", "grow_events", "min_free", "oom",
              "sim_time_s", "tokens", "requests"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert tres.tokens_per_sec == jres.tokens_per_sec
    np.testing.assert_equal(tres.latency_percentiles(), jres.latency_percentiles())
    np.testing.assert_equal(tres.latency_ticks(), jres.latency_ticks())


def sims_agree(make_trace, cache_kw, schedule=None, knobs=None):
    jt, tt = both_traces(make_trace)
    knobs = knobs or {}
    want = run_sim(jsim, jfaults, J_ENDS, jt, JKVCacheConfig(**cache_kw), schedule, knobs)
    got = run_sim(tsim, tfaults, T_ENDS, tt, KVCacheConfig(**cache_kw), schedule, knobs)
    same_outcome(got, want)
    return want


def random_scenario(seed: int):
    """A seeded trace (Poisson arrivals, random sizes, synthetic forks,
    sometimes deadlines), pool, knobs and fault schedule."""
    rng = np.random.default_rng(seed)
    n_reqs = int(rng.integers(1, 7))
    rate, p_res, tseed = float(rng.uniform(0.05, 1.0)), float(rng.uniform(0.0, 0.8)), int(
        rng.integers(0, 2**31))
    deadlines = rng.random() < 0.3

    def make(lib):
        t = lib.with_synthetic_forks(
            lib.poisson(n_reqs, rate, n_particles=(1, 6), steps=(0, 12), plen=(1, 10), seed=tseed),
            p_resample=p_res)
        return lib.with_deadlines(t, slack_x=1.5, tight_every=2) if deadlines else t

    max_len = 10 + 12
    bs = int(rng.integers(2, 9))
    cache_kw = dict(n_layers=1, n_kv_heads=1, head_dim=8, block_size=bs,
                    max_seqs=int(rng.integers(6, 17)), max_blocks_per_seq=-(-max_len // bs) + 1,
                    num_blocks=int(rng.integers(0, 24)), dtype="float32")
    knobs = dict(
        grow=bool(rng.random() < 0.7), grow_factor=float(rng.choice([1.5, 2.0])),
        watermark=float(rng.choice([1.0, 1.5])), admission_margin=float(rng.choice([0.5, 1.0])),
        preempt_margin=float(rng.choice([1.0, 1.5])), strict_admission=bool(rng.random() < 0.8),
        shrink_on_complete=bool(rng.random() < 0.3),
        preempt_policy=str(rng.choice(["newest", "sla", "longest_wait"])),
    )
    if rng.random() < 0.3:
        knobs.update(admission="shed", queue_limit=int(rng.integers(0, 3)))
    schedule = None
    if rng.random() < 0.5:
        kinds = list(tfaults.FaultKind) if rng.random() < 0.2 else list(tfaults.RECOVERABLE)
        schedule = tfaults.schedule_to_json(tfaults.chaos_schedule(
            int(rng.integers(0, 2**31)), 40, rate=0.2, kinds=kinds,
            rids=[f"r{i}" for i in range(n_reqs)], p_poison=0.1, delay_s=0.001, max_repeats=3))
    return make, cache_kw, schedule, knobs


@settings(derandomize=True, database=None, max_examples=150, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_random_schedules_bit_equal_to_reference(seed):
    sims_agree(*random_scenario(seed))


@pytest.mark.parametrize("spec", corpus(), ids=lambda s: s["name"])
def test_chaos_corpus_bit_equal_to_reference(spec):
    """Each corpus schedule, its requests as a trace with synthetic forks,
    through both simulators with fresh injectors of the schedule."""

    def make(lib):
        reqs = tuple(
            lib.TraceRequest(rid=r["rid"], arrive_at=r.get("arrive_at", 0), n_particles=r["n"],
                             steps=r["steps"], plen=r["plen"], seed=r["seed"],
                             deadline=r.get("deadline"))
            for r in spec["requests"])
        return lib.with_synthetic_forks(lib.Trace(name=spec["name"], requests=reqs), 0.5)

    cache_kw = dict(n_layers=SMOKE.n_layers, n_kv_heads=SMOKE.n_kv_heads, head_dim=SMOKE.hd,
                    block_size=BS, max_seqs=spec["engine"]["max_seqs"], max_blocks_per_seq=24,
                    dtype=SMOKE.dtype)
    res, _, exc = sims_agree(make, cache_kw, json.dumps(spec["schedule"]), spec.get("knobs", {}))
    assert exc is None and res.stats.faults > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_cost_model_arithmetic_equals_reference(arch):
    """``model_flops_for``/``model_bytes_for`` for each family the
    reference configures, ``CostModel.from_roofline`` on the same hardware
    numbers, and the write path's five cost functions."""
    jcfg = get_config(arch)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    for kind in ("train", "prefill", "decode"):
        for batch, seq in ((1, 64), (32, 592), (2, 4096)):
            assert tanalysis.model_flops_for(tcfg, kind, batch, seq) == janalysis.model_flops_for(
                jcfg, kind, batch, seq)
            assert tanalysis.model_bytes_for(tcfg, kind, batch, seq) == janalysis.model_bytes_for(
                jcfg, kind, batch, seq)
    tpu = janalysis.TPU_V5E
    hw = tanalysis.Hardware(name=tpu.name, peak_flops=tpu.peak_flops, hbm_bw=tpu.hbm_bw,
                            nvlink_bw=tpu.ici_bw)
    cache_kw = dict(n_layers=jcfg.n_layers, n_kv_heads=jcfg.n_kv_heads, head_dim=jcfg.hd,
                    block_size=16, max_seqs=32, max_blocks_per_seq=37, dtype="bfloat16")
    got = tsim.CostModel.from_roofline(tcfg, KVCacheConfig(**cache_kw), plen=500, hw=hw)
    want = jsim.CostModel.from_roofline(jcfg, JKVCacheConfig(**cache_kw), plen=500, hw=tpu)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    h100 = tsim.CostModel.from_roofline(tcfg, KVCacheConfig(**cache_kw), plen=500)
    assert h100.step_s < got.step_s  # the H100's peaks are the default, and higher
    cost = dataclasses.astuple  # each package's own WriteCost class
    for path in twrite.WRITE_PATHS:
        for delta in (False, True) if path == "kernel" else (False,):
            kw = dict(n=64, touched=60, copies=7, num_blocks=1000, block_bytes=491_520,
                      item_bytes=16, delta=delta, dirty_items=5)
            assert cost(twrite.append_cost(path, **kw)) == cost(jwrite.append_cost(path, **kw))
        kw = dict(table_entries=2048, num_blocks=999)
        assert cost(twrite.clone_cost(path, **kw)) == cost(jwrite.clone_cost(path, **kw))
        assert cost(twrite.chain_cost(path, n=64, **kw)) == cost(jwrite.chain_cost(path, n=64, **kw))
    kw = dict(old_blocks=544, block_bytes=491_520)
    assert cost(twrite.grow_cost(**kw)) == cost(jwrite.grow_cost(**kw))
    kw = dict(live=151, num_blocks=544, table_entries=32 * 37, block_bytes=491_520)
    assert cost(twrite.compact_cost(**kw)) == cost(jwrite.compact_cost(**kw))


def test_cost_model_from_event_log_equals_reference():
    """The calibration reads the same wall lists the same way."""
    walls = dict(step_wall_s=[0.07, 0.065, 0.08], prefill_wall_s=[0.2, 0.1],
                 grow_wall_s=[0.003], grow_old_blocks=[544])
    got = tsim.CostModel.from_event_log(tsched.SchedulerEventLog(**walls))
    want = jsim.CostModel.from_event_log(jsched.SchedulerEventLog(**walls))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    empty = tsim.CostModel.from_event_log(tsched.SchedulerEventLog())
    assert dataclasses.asdict(empty) == dataclasses.asdict(
        jsim.CostModel.from_event_log(jsched.SchedulerEventLog()))


# ---------------------------------------------------------------------------
# decision-exact with the port's scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    return LanguageModel(SMOKE).init(torch.Generator().manual_seed(0), device="cpu")


def make_engine(params, max_seqs, num_blocks=0):
    ccfg = KVCacheConfig(
        n_layers=SMOKE.n_layers, n_kv_heads=SMOKE.n_kv_heads, head_dim=SMOKE.hd, block_size=BS,
        max_seqs=max_seqs, max_blocks_per_seq=24, num_blocks=num_blocks, dtype=SMOKE.dtype)
    return ServeEngine(LanguageModel(SMOKE), params, ccfg, device="cpu")


def request(rid, seed, n, steps, plen, arrive_at=0, deadline=None):
    prompt = torch.randint(0, SMOKE.vocab_size, (plen,),
                           generator=torch.Generator().manual_seed(seed))
    return tsched.DecodeRequest(
        rid=rid, prompt=prompt, n_particles=n, steps=steps, gen=rnd.generator(100 + seed, "cpu"),
        target_temp=TARGET, proposal_temp=PROPOSAL, token_block_size=BS, arrive_at=arrive_at,
        deadline=deadline)


def preempt_once_at(rid, t):
    """A fresh boundary hook: preempt ``rid`` the first time the oldest
    active request reaches ``t`` decoded tokens (the same surface on the
    scheduler and the simulator)."""
    fired = []

    def hook(sched):
        if sched._active and sched._active[0].t_done == t and not fired:
            fired.append(True)
            sched.preempt(rid)

    return hook


def chaos(seed):
    return tfaults.schedule_to_json(tfaults.chaos_schedule(
        seed, 12, rate=0.3, rids=("a", "b"), p_poison=0.1, max_repeats=2))


def event(kind, tick, **kw):
    return {**dict(kind=kind, tick=tick, rid=None, delay_s=0.0, repeats=1), **kw}


# name: (requests as request() args, max_seqs, num_blocks, knobs, schedule, hook, check)
SCENARIOS = {
    "burst": ([("a", 1, 6, 8, 6), ("b", 2, 4, 10, 9)], 10, 0, {}, None, None,
              lambda s, log: s.stats.preemptions == 0),
    "staggered_arrival": ([("a", 5, 6, 10, 4), ("b", 6, 4, 6, 6, 5)], 10, 0, {}, None, None,
                          lambda s, log: [e[0] for e in log.events].count("admit") == 2),
    "queue_overflow_waits": ([(f"r{i}", 10 + i, 4, 5, 4) for i in range(3)], 4, 0, {}, None, None,
                             lambda s, log: s.stats.completed == 3),
    "forced_preempt_resume": ([("a", 7, 6, 10, 6)], 6, 0, {}, None, ("a", 4),
                              lambda s, log: s.stats.replayed_tokens == 4),
    "pressure_preemption_fixed_pool": ([("a", 1, 4, 12, 4), ("b", 2, 4, 12, 4)], 8, 20,
                                       dict(grow=False), None, None,
                                       lambda s, log: s.stats.preemptions >= 1),
    "growth_preferred": ([("a", 1, 4, 12, 4), ("b", 2, 4, 12, 4)], 8, 8, {}, None, None,
                         lambda s, log: s.stats.preemptions == 0
                         and any(e[0] == "grow" for e in log.events)),
    "shrink_on_complete": ([("a", 1, 6, 5, 4), ("b", 2, 4, 12, 4)], 10, 0,
                           dict(shrink_on_complete=True), None, None,
                           lambda s, log: s.stats.compactions >= 1),
    "recoverable_chaos": ([("a", 1, 6, 8, 6), ("b", 2, 4, 10, 9, 3)], 10, 0, {},
                          json.dumps([event("step_failure", 2, repeats=2),
                                      event("latency", 4, delay_s=0.001), event("oom", 6)]),
                          None, lambda s, log: s.stats.retries == 3),
    "poison_and_deadline_chaos": ([("a", 3, 6, 10, 6), ("b", 4, 4, 12, 4, 0, 8)], 10, 0, {},
                                  json.dumps([{**event("nan_logits", 5), "rid": "a"}]), None,
                                  lambda s, log: s.results["a"].status == "poisoned"
                                  and s.results["b"].status == "expired"),
    "seeded_chaos_3": ([("a", 3, 4, 8, 4), ("b", 4, 4, 6, 6, 2)], 10, 0, {}, chaos(3), None,
                       lambda s, log: s.stats.faults > 0),
    "seeded_chaos_11": ([("a", 11, 4, 8, 4), ("b", 12, 4, 6, 6, 2)], 10, 0, {}, chaos(11), None,
                        lambda s, log: s.stats.faults > 0),
    "sla_policy_pressure": ([("a", 1, 4, 16, 4, 0, 200), ("b", 2, 4, 16, 4, 0, 25)], 8, 20,
                            dict(grow=False, preempt_policy="sla"), None, None,
                            lambda s, log: any(e[:2] == ("preempt", "a") for e in log.events)
                            and s.results["b"].status == "ok"),
}
for spec in corpus():
    SCENARIOS[f"corpus_{spec['name']}"] = (
        [(r["rid"], r["seed"], r["n"], r["steps"], r["plen"], r.get("arrive_at", 0),
          r.get("deadline")) for r in spec["requests"]],
        spec["engine"]["max_seqs"], 0, spec.get("knobs", {}), json.dumps(spec["schedule"]), None,
        lambda s, log: s.stats.faults > 0)


def record(params, reqs, max_seqs, num_blocks=0, schedule=None, hook=None, **knobs):
    """The port's scheduler with an event log (and a fresh injector of
    ``schedule``); returns the scheduler and its log."""
    log = tsched.SchedulerEventLog()
    faults = None if schedule is None else tfaults.FaultInjector(
        tfaults.schedule_from_json(schedule))
    sched = tsched.Scheduler(make_engine(params, max_seqs, num_blocks), event_log=log,
                             faults=faults, on_boundary=hook, **knobs)
    for r in reqs:
        sched.submit(r)
    sched.run()
    return sched, log


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_decision_exact_with_the_port_scheduler(params, name):
    """The recorded run's trace, through JSON, replays tuple for tuple
    through the simulator with the same knobs, hook and schedule: peak
    blocks, stats and every request's status equal."""
    specs, max_seqs, num_blocks, knobs, schedule, preempt, check = SCENARIOS[name]
    hooks = (preempt_once_at(*preempt), preempt_once_at(*preempt)) if preempt else (None, None)
    sched, log = record(params, [request(*a) for a in specs], max_seqs, num_blocks, schedule,
                        hooks[0], **knobs)
    assert check(sched, log), name
    trace = ttraces.from_json(ttraces.to_json(log.to_trace(name)))
    assert trace == log.to_trace(name)
    faults = None if schedule is None else tfaults.FaultInjector(
        tfaults.schedule_from_json(schedule))
    res = tsim.simulate(trace, sched.engine.cache_cfg, tsim.CostModel(**COST), faults=faults,
                        on_boundary=hooks[1], **knobs)
    div = tsim.first_divergence(log.decisions, res.decisions)
    assert div is None, div
    assert res.peak_blocks == log.peak_blocks()
    assert res.stats.as_dict() == sched.stats.as_dict()
    assert {rid: r["status"] for rid, r in res.requests.items()} == {
        rid: r.status for rid, r in sched.results.items()}
    np.testing.assert_equal(res.latency_ticks(), log.latency_ticks())


def test_no_progress_guard_differential(params):
    """A tick that starts with waiters and nothing active (reachable only
    through a pathological admission hook) raises typed, with the same
    event, in the scheduler and the simulator."""
    log = tsched.SchedulerEventLog()
    sched = tsched.Scheduler(make_engine(params, 8), event_log=log)
    sched._admit_ready = lambda: None
    sched.submit(request("stuck", 1, 4, 4, 4))
    with pytest.raises(tfaults.AllReplicasSaturated) as exc:
        sched.run()
    assert exc.value.tick == 0 and exc.value.rids == ("stuck",)
    sim = tsim.SimScheduler(sched.engine.cache_cfg, tsim.CostModel(**COST))
    sim._admit_ready = lambda: None
    sim.submit(ttraces.TraceRequest(rid="stuck", arrive_at=0, n_particles=4, steps=4, plen=4))
    with pytest.raises(tfaults.AllReplicasSaturated) as sim_exc:
        sim.run()
    assert (sim_exc.value.tick, sim_exc.value.rids) == (0, ("stuck",))
    assert tsim.first_divergence(log.decisions, sim.decisions) is None
    assert log.decisions == [("saturated", 0, ("stuck",))]


@pytest.mark.parametrize("interval", [0, 3], ids=["burst", "stagger3"])
def test_self_prediction(params, interval):
    """The cost model calibrated on a warm recorded run predicts that run's
    recorded wall (decode ticks, prefills, growth) within +/-25%: the
    reference's gate (``tests/test_sim.py``).  The cold pass absorbs the
    pool's growth."""
    trace = ttraces.staggered(2, interval, n_particles=5, steps=24, plen=6)
    reqs = ttraces.to_decode_requests(trace, SMOKE.vocab_size, target_temp=0.5,
                                      token_block_size=BS, device="cpu")
    eng = make_engine(params, 10)

    def once(log=None):
        sched = tsched.Scheduler(eng, event_log=log)
        for r in reqs:
            sched.submit(r)
        sched.run()

    once()
    pre = eng.num_blocks
    log = tsched.SchedulerEventLog()
    once(log)
    res = tsim.simulate(log.to_trace(), eng.cache_cfg, tsim.CostModel.from_event_log(log),
                        initial_blocks=pre)
    assert tsim.first_divergence(log.decisions, res.decisions) is None
    ratio = res.sim_time_s / log.recorded_wall_s()
    assert 0.75 <= ratio <= 1.25, ratio
