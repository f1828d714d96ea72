"""The port's continuous-batching scheduler and fault layer, within the port.

starcoder2-3b's smoke config on the CPU path.  Every scheduled request
must be bit-exact (tokens, log-weights, log-evidence, ESS, resampling
steps) with the same request run without the disturbance: concurrency,
staggered arrival, preemption under pressure, growth, shrinking,
streaming, checkpoint/restore, the committed chaos schedules
(``tests/chaos_corpus/*.json``, read as data) and recoverable faults on a
tick that forks.  The port writes its KV payload and token stores in
place, so a rolled-back tick must leave every leaf as it was before the
tick, payload included.

The uninterrupted runs mirror the reference's contract
(``tests/test_scheduler.py``): a request alone in an ``SMCDecoder`` of its
own size.  On the CPU a row's logits depend on the batch's row count,
though: PyTorch's float32 GEMM has given one row's output other last bits
at 1, at 2-4 and at 5 or more rows (``scripts/torch_cpu_bit_checks.py``).
So where the decoder's engine would fall in another of those classes than
the schedule's (a request of 2 or 4 particles against an engine of 8
rows), the uninterrupted run is the request alone on an engine of the
schedule's ``max_seqs``, and the decoder's run is held to equal tokens,
as the reference's test holds it.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import random as rnd  # noqa: E402
from repro_torch.configs.starcoder2_3b import SMOKE  # noqa: E402
from repro_torch.core.config import CopyMode  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AdmissionRefused,
    DecodeRequest,
    DeviceLost,
    FaultEvent,
    FaultInjector,
    FaultKind,
    FaultRetriesExhausted,
    RequestStatus,
    RetryPolicy,
    Scheduler,
    SchedulerEventLog,
    SlotTable,
    TokenEvent,
    load_checkpoint,
    save_checkpoint,
    stream_tokens,
)
from repro_torch.serving import faults as faults_lib  # noqa: E402
from repro_torch.serving import scheduler as sched_lib  # noqa: E402
from repro_torch.serving import sim, traces  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.kv_cache import KVCacheConfig  # noqa: E402
from repro_torch.serving.smc_decode import SMCDecoder  # noqa: E402
from repro_torch.smc.executor import snapshot  # noqa: E402

BS = 4
TARGET, PROPOSAL = 1.0, 4.0  # temperatures at which the smoke model resamples
CORPUS_DIR = os.path.join(os.path.dirname(__file__), "chaos_corpus")


@pytest.fixture(scope="module")
def params():
    return LanguageModel(SMOKE).init(torch.Generator().manual_seed(0), device="cpu")


def make_engine(params, max_seqs, num_blocks=0, max_blocks_per_seq=24):
    ccfg = KVCacheConfig(
        n_layers=SMOKE.n_layers, n_kv_heads=SMOKE.n_kv_heads, head_dim=SMOKE.hd,
        block_size=BS, max_seqs=max_seqs, max_blocks_per_seq=max_blocks_per_seq,
        num_blocks=num_blocks, dtype=SMOKE.dtype,
    )
    return ServeEngine(LanguageModel(SMOKE), params, ccfg, device="cpu")


def make_request(rid, seed, n, steps, plen, arrive_at=0, deadline=None):
    prompt = torch.randint(0, SMOKE.vocab_size, (plen,), generator=torch.Generator().manual_seed(seed))
    return DecodeRequest(
        rid=rid, prompt=prompt, n_particles=n, steps=steps, gen=rnd.generator(100 + seed, "cpu"),
        target_temp=TARGET, proposal_temp=PROPOSAL, token_block_size=BS,
        arrive_at=arrive_at, deadline=deadline,
    )


def decoder_run(params, req):
    """The request decoded by a private SMCDecoder of its own size."""
    dec = SMCDecoder(LanguageModel(SMOKE), params, req.n_particles, max_len=96,
                     target_temp=req.target_temp, proposal_temp=req.proposal_temp,
                     block_size=BS, device="cpu")
    return dec.run(req.gen, req.prompt, req.steps)


def run_sched(params, reqs, max_seqs, num_blocks=0, hook=None, **kw):
    eng = make_engine(params, max_seqs, num_blocks)
    sched = Scheduler(eng, on_boundary=hook, **kw)
    for r in reqs:
        sched.submit(r)
    return sched, sched.run()


def alone(params, req, max_seqs):
    """The request alone on an engine of the schedule's ``max_seqs``."""
    return run_sched(params, [dataclasses.replace(req, arrive_at=0, deadline=None)], max_seqs)[1][req.rid]


def assert_bit_exact(got, want):
    for f in ("tokens", "log_weights", "log_evidence", "ess_trace", "resampled"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def leaves(tree):
    if isinstance(tree, tuple):
        return [x for leaf in tree for x in leaves(leaf)]
    return [tree]


def same_leaves(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb, strict=True))


# ---------------------------------------------------------------------------
# host-side pieces
# ---------------------------------------------------------------------------


class TestSlotTable:
    def test_pack_free_refill(self):
        t = SlotTable(10)
        assert (t.alloc(4), t.alloc(3), t.alloc(3)) == (0, 4, 7) and t.free_slots == 0
        assert t.alloc(1) is None
        t.free(4, 3)
        assert t.alloc(4) is None and t.alloc(2) == 4
        t.free(0, 4)
        assert t.alloc(4) == 0

    @pytest.mark.parametrize("lo,n", [(0, 4), (0, 2), (2, 4)])
    def test_bad_free_raises(self, lo, n):
        t = SlotTable(10)
        t.alloc(4)
        if (lo, n) == (0, 4):
            t.free(0, 4)
        with pytest.raises(ValueError, match="no such allocated range"):
            t.free(lo, n)


def test_preempt_policies():
    S = dataclasses.make_dataclass("S", ["req", "t_done"])
    R = dataclasses.make_dataclass("R", ["deadline", "arrive_at", "steps"])
    active = [S(R(None, 0, 10), 2), S(R(20, 5, 10), 2), S(R(8, 1, 10), 2)]
    assert sched_lib.resolve_preempt_policy(None).select(active, 3) is active[-1]
    assert sched_lib.resolve_preempt_policy("sla").select(active, 3) is active[0]
    assert sched_lib.resolve_preempt_policy("longest_wait").select(active, 3) is active[1]
    with pytest.raises(ValueError, match="unknown preempt policy"):
        sched_lib.resolve_preempt_policy("oldest")


def test_stream_tokens_reassembles_lineages():
    evs = [
        TokenEvent("a", 0, np.array([1, 2, 3]), None, 0),
        TokenEvent("a", 1, np.array([4, 5, 6]), np.array([2, 2, 0]), 1),
        TokenEvent("a", 2, None, None, 2, final=True),
    ]
    np.testing.assert_array_equal(
        stream_tokens(evs, n=3, steps=3), [[3, 4, 0], [3, 5, 0], [1, 6, 0]]
    )


def test_faults_module_round_trips():
    sched = faults_lib.chaos_schedule(3, 20, rate=0.5, rids=("a",), p_poison=0.3, max_repeats=2)
    assert faults_lib.schedule_from_json(faults_lib.schedule_to_json(sched)) == sched
    inj = FaultInjector([FaultEvent(FaultKind.OOM, tick=1, repeats=2)])
    assert [len(inj.step_events(1)) for _ in range(3)] == [1, 1, 0] and inj.fired == 2
    assert RetryPolicy(backoff_base_s=0.1, backoff_cap_s=0.25).delay_s(3) == 0.25


def test_event_log_has_no_trace_yet(params):
    """The name is from before ``to_trace`` existed.  A recorded run with
    a staggered arrival and a forced preemption: its ``to_trace`` keeps
    submission order, sizes and the forks as recorded, round-trips through
    JSON, and replays decision-exact through the simulator."""
    log = SchedulerEventLog()
    reqs = [make_request("b", 2, n=4, steps=12, plen=9, arrive_at=2),
            make_request("a", 1, n=6, steps=10, plen=6)]

    def preempt_b(s):
        if s.tick == 6 and not s.stats.preemptions:
            s.preempt("b")

    sched, res = run_sched(params, reqs, max_seqs=10, hook=preempt_b, event_log=log)
    trace = log.to_trace("recorded")
    assert [r.rid for r in trace.requests] == ["b", "a"] and trace.name == "recorded"
    for r, tr in zip(reqs, trace.requests, strict=True):
        assert (tr.arrive_at, tr.n_particles, tr.steps, tr.plen) == (
            r.arrive_at, r.n_particles, r.steps, len(r.prompt))
        assert set(tr.forks) == {t for t, on in enumerate(res[r.rid].resampled.tolist()) if on}
        assert all(len(anc) == r.n_particles for anc in tr.forks.values())
    assert any(tr.forks for tr in trace.requests)
    assert traces.from_json(traces.to_json(trace)) == trace
    replay = sim.simulate(traces.from_json(traces.to_json(trace)), sched.engine.cache_cfg,
                          sim.CostModel.from_event_log(log), on_boundary=preempt_b)
    assert sim.first_divergence(log.decisions, replay.decisions) is None
    assert replay.stats.as_dict() == sched.stats.as_dict() and replay.stats.preemptions == 1


# ---------------------------------------------------------------------------
# concurrency
# ---------------------------------------------------------------------------


class TestConcurrency:
    def test_two_concurrent_bit_exact_with_sequential(self, params):
        """Two requests over one pool against each decoded alone by an
        SMCDecoder of its own size (the reference's contract: engines of
        8, 6 and 14 rows); the shared pool's peak below the sum of the
        dense caches."""
        ra = make_request("a", 1, n=8, steps=10, plen=6)
        rb = make_request("b", 2, n=6, steps=13, plen=9)
        sched, res = run_sched(params, [ra, rb], max_seqs=14)
        for r in (ra, rb):
            assert_bit_exact(res[r.rid], decoder_run(params, r))
            assert not bool(res[r.rid].oom)
        assert res["a"].resampled.any() or res["b"].resampled.any()
        peak = max(int(res[r].used_blocks_trace.max()) for r in ("a", "b"))
        dense = sum(r.n_particles * -(-(len(r.prompt) + r.steps) // BS) for r in (ra, rb))
        assert peak < dense
        assert sched.stats.completed == 2 and sched.stats.preemptions == 0
        # The requests were not consumed: a second schedule draws the same.
        assert_bit_exact(run_sched(params, [ra, rb], max_seqs=14)[1]["b"], res["b"])

    def test_queue_overflow_waits(self, params):
        reqs = [make_request(f"r{i}", 10 + i, n=4, steps=6, plen=4) for i in range(3)]
        sched, res = run_sched(params, reqs, max_seqs=4)
        for r in reqs:
            assert_bit_exact(res[r.rid], decoder_run(params, r))
        assert sched.stats.admitted == 3 and sched.stats.completed == 3

    def test_staggered_arrival_bit_exact(self, params):
        ra = make_request("a", 5, n=6, steps=12, plen=4)
        rb = make_request("b", 6, n=4, steps=8, plen=6, arrive_at=5)
        _, res = run_sched(params, [ra, rb], max_seqs=10)
        for r in (ra, rb):
            assert_bit_exact(res[r.rid], alone(params, r, 10))


# ---------------------------------------------------------------------------
# admission, preemption, growth
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_refused_on_full_pool_surfaces(self, params):
        req = make_request("big", 3, n=8, steps=8, plen=8)
        eng = make_engine(params, max_seqs=8, num_blocks=6)
        sched = Scheduler(eng, grow=False)
        sched.submit(req)
        with pytest.raises(AdmissionRefused, match="big") as exc:
            sched.run()
        assert exc.value.resource == "blocks" and exc.value.shortfall == 10 - 6
        assert sched.stats.completed == 0

    def test_refused_on_full_slot_table_surfaces(self, params):
        eng = make_engine(params, max_seqs=4)
        sched = Scheduler(eng)
        sched.submit(make_request("wide", 4, n=8, steps=4, plen=4))
        with pytest.raises(AdmissionRefused, match="slots") as exc:
            sched.run()
        assert exc.value.resource == "slots" and exc.value.shortfall == 4

    def test_duplicate_rid_rejected(self, params):
        sched = Scheduler(make_engine(params, max_seqs=4))
        sched.submit(make_request("a", 1, n=4, steps=2, plen=4))
        with pytest.raises(ValueError, match="duplicate"):
            sched.submit(make_request("a", 2, n=4, steps=2, plen=4))
        sched.run()
        with pytest.raises(ValueError, match="duplicate"):
            sched.submit(make_request("a", 2, n=4, steps=2, plen=4))

    def test_sticky_pool_oom_does_not_taint_later_requests(self, params):
        eng = make_engine(params, max_seqs=8, num_blocks=12)
        sched = Scheduler(eng, grow=False, strict_admission=False)
        sched.submit(make_request("bad", 8, n=8, steps=10, plen=4))
        assert bool(sched.run()["bad"].oom)
        small = make_request("small", 9, n=2, steps=4, plen=4)
        sched2 = Scheduler(eng, grow=False, strict_admission=False)
        sched2.submit(small)
        res = sched2.run()["small"]
        assert not bool(res.oom)
        assert torch.equal(res.tokens, decoder_run(params, small).tokens)
        assert_bit_exact(res, alone(params, small, 8))


class TestPreemption:
    def test_forced_preempt_resume_bit_exact(self, params):
        req = make_request("a", 7, n=8, steps=12, plen=6)
        fired = []

        def force_once(sched):
            if sched._active and sched._active[0].t_done == 5 and not fired:
                fired.append(True)
                sched.preempt("a")

        sched, res = run_sched(params, [req], max_seqs=8, hook=force_once)
        assert res["a"].preemptions == 1 and sched.stats.replayed_tokens == 5
        assert_bit_exact(res["a"], decoder_run(params, req))
        assert not bool(res["a"].oom)

    def test_pressure_preemption_recovers_bit_exact(self, params):
        ra = make_request("a", 1, n=4, steps=16, plen=4)
        rb = make_request("b", 2, n=4, steps=16, plen=4)
        sched, res = run_sched(params, [ra, rb], max_seqs=8, num_blocks=20, grow=False)
        assert sched.stats.preemptions >= 1
        for r in (ra, rb):
            assert torch.equal(res[r.rid].tokens, decoder_run(params, r).tokens)
            assert_bit_exact(res[r.rid], alone(params, r, 8))
            assert not bool(res[r.rid].oom)

    def test_growth_preferred_over_preemption(self, params):
        ra = make_request("a", 1, n=4, steps=16, plen=4)
        rb = make_request("b", 2, n=4, steps=16, plen=4)
        sched, res = run_sched(params, [ra, rb], max_seqs=8, num_blocks=8)
        assert sched.stats.preemptions == 0 and sched.engine.num_blocks > 8
        for r in (ra, rb):
            assert torch.equal(res[r.rid].tokens, decoder_run(params, r).tokens)
            assert_bit_exact(res[r.rid], alone(params, r, 8))

    def test_shrink_on_complete_is_invisible(self, params):
        ra = make_request("a", 1, n=4, steps=6, plen=4)
        rb = make_request("b", 2, n=4, steps=16, plen=4)
        sched, res = run_sched(params, [ra, rb], max_seqs=8, num_blocks=64,
                               shrink_on_complete=True)
        assert sched.stats.compactions >= 1 and sched.engine.num_blocks < 64
        _, plain = run_sched(params, [ra, rb], max_seqs=8, num_blocks=64)
        for r in (ra, rb):
            assert_bit_exact(res[r.rid], plain[r.rid])


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------


def assert_stream_matches(events, results, reqs):
    for r in reqs:
        evs = [ev for ev in events if ev.rid == r.rid]
        finals = [ev for ev in evs if ev.final]
        assert len(finals) == 1 and evs[-1] is finals[0]
        assert finals[0].status == results[r.rid].status
        toks = [ev for ev in evs if not ev.final]
        assert [ev.t for ev in toks] == list(range(len(toks)))
        rec = stream_tokens(evs, n=r.n_particles, steps=r.steps)
        np.testing.assert_array_equal(rec, results[r.rid].tokens.numpy())


class TestStreaming:
    def test_stream_and_callback_match_run(self, params):
        reqs = [make_request("a", 1, n=6, steps=10, plen=6),
                make_request("b", 2, n=4, steps=13, plen=9, arrive_at=2)]
        _, ran = run_sched(params, reqs, max_seqs=10)
        sched = Scheduler(make_engine(params, 10))
        for r in reqs:
            sched.submit(r)
        events = list(sched.stream())
        assert_stream_matches(events, sched.results, reqs)
        seen = []
        cb = Scheduler(make_engine(params, 10))
        cb.on_token = lambda ev: seen.append((ev, len(cb.results)))
        for r in reqs:
            cb.submit(r)
        res = cb.run()
        assert [n for ev, n in seen if not ev.final and ev.t == 0 and ev.rid == "a"] == [0]
        assert_stream_matches([ev for ev, _ in seen], res, reqs)
        for r in reqs:
            assert_bit_exact(sched.results[r.rid], ran[r.rid])
            assert_bit_exact(res[r.rid], ran[r.rid])

    def test_preemption_and_faults_never_re_emit(self, params):
        req = make_request("a", 7, n=8, steps=12, plen=6)
        fired = []

        def force_once(sched):
            if sched._active and sched._active[0].t_done == 5 and not fired:
                fired.append(True)
                sched.preempt("a")

        inj = FaultInjector(faults_lib.chaos_schedule(7, 14, rate=0.4, max_repeats=2))
        sched = Scheduler(make_engine(params, 8), on_boundary=force_once, faults=inj)
        sched.submit(req)
        events = list(sched.stream())
        assert sched.stats.preemptions == 1 and sched.stats.retries >= 1
        assert_stream_matches(events, sched.results, [req])
        assert_bit_exact(sched.results["a"], decoder_run(params, req))


# ---------------------------------------------------------------------------
# crash consistency
# ---------------------------------------------------------------------------


class Kill(Exception):
    pass


class TestCheckpointRestore:
    @pytest.mark.parametrize("mode", [CopyMode.LAZY_SR, CopyMode.LAZY])
    def test_kill_and_restore_bit_exact(self, params, tmp_path, mode):
        reqs = [dataclasses.replace(make_request("a", 1, n=6, steps=8, plen=6), token_copy_mode=mode),
                make_request("b", 2, n=4, steps=10, plen=9)]
        _, ref = run_sched(params, reqs, max_seqs=10)
        saved = {}

        def hook(sched):
            if sched.tick == 4 and not saved:
                saved["state"] = sched.checkpoint()
                raise Kill

        eng = make_engine(params, 10)
        sched = Scheduler(eng, on_boundary=hook)
        for r in reqs:
            sched.submit(r)
        with pytest.raises(Kill):
            sched.run()
        path = tmp_path / "sched.ckpt"
        save_checkpoint(path, saved["state"])
        sched2 = Scheduler.restore(make_engine(params, 10), load_checkpoint(path), watchdog=True)
        res = sched2.run()
        for r in reqs:
            assert res[r.rid].status == "ok"
            assert_bit_exact(res[r.rid], ref[r.rid])
        assert sched2.check_invariants() == []

    def test_bf16_pool_round_trip(self, params):
        """A bfloat16 KV payload goes to the checkpoint as float32 and
        comes back as the cache's dtype, bit for bit."""
        cfg = SMOKE.scaled(dtype="bfloat16")
        ccfg = KVCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                             block_size=BS, max_seqs=6, max_blocks_per_seq=24, dtype=cfg.dtype)
        eng = ServeEngine(LanguageModel(cfg), params, ccfg, device="cpu")
        req = make_request("a", 3, n=4, steps=8, plen=4)
        saved = {}

        def hook(sched):
            if sched.tick == 5 and not saved:
                saved["state"] = sched.checkpoint()
                saved["cache"] = snapshot(sched.engine.cache)
                raise Kill

        sched = Scheduler(eng, on_boundary=hook)
        sched.submit(req)
        with pytest.raises(Kill):
            sched.run()
        eng2 = ServeEngine(LanguageModel(cfg), params, ccfg, device="cpu")
        sched2 = Scheduler.restore(eng2, saved["state"])
        assert eng2.cache.pool.data.dtype == torch.bfloat16
        assert same_leaves(eng2.cache, saved["cache"])
        ref = Scheduler(ServeEngine(LanguageModel(cfg), params, ccfg, device="cpu"))
        ref.submit(req)
        assert_bit_exact(sched2.run()["a"], ref.run()["a"])

    def test_device_loss_then_restore_last_checkpoint(self, params):
        req = make_request("a", 3, n=4, steps=8, plen=4)
        ref = alone(params, req, 6)
        last = {}
        inj = FaultInjector([FaultEvent(FaultKind.DEVICE_LOSS, tick=5)])
        sched = Scheduler(make_engine(params, 6), faults=inj,
                          on_boundary=lambda s: last.update(state=s.checkpoint()))
        sched.submit(req)
        with pytest.raises(DeviceLost):
            sched.run()
        assert_bit_exact(Scheduler.restore(make_engine(params, 6), last["state"]).run()["a"], ref)

    def test_restore_rejects_mismatched_engine(self, params):
        state = Scheduler(make_engine(params, 6)).checkpoint()
        with pytest.raises(ValueError, match="cache config"):
            Scheduler.restore(make_engine(params, 8), state)


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------


class Recording(Scheduler):
    """Copies the state at each tick's snapshot, and the payload after each
    decode of the tick, to hold the rollback to them."""

    def __init__(self, engine, **kw):
        super().__init__(engine, **kw)
        self.after_decode = []
        decode = engine.decode

        def recording(tokens, mask=None):
            out = decode(tokens, mask)
            self.after_decode.append(engine.cache.pool.data.clone())
            return out

        engine.decode = recording

    def _snapshot(self):
        self.before = {
            "cache": snapshot(self.engine.cache),
            "stores": {s.req.rid: snapshot(s.trace.store) for s in self._active},
            "gens": {s.req.rid: rnd.snapshot(s.gen) for s in self._active},
        }
        self.after_decode = []
        return super()._snapshot()


def fork_tick(res) -> int:
    """The first step at which a request admitted at tick 0 resampled."""
    return int(torch.nonzero(res.resampled)[0])


class TestFaults:
    def reqs(self):
        return [make_request("a", 1, n=6, steps=8, plen=6),
                make_request("b", 2, n=4, steps=10, plen=9)]

    def test_step_failure_then_oom_on_a_fork_tick_bit_exact(self, params):
        _, ref = run_sched(params, self.reqs(), max_seqs=10)
        t = fork_tick(ref["a"])
        inj = FaultInjector([FaultEvent(FaultKind.STEP_FAILURE, tick=t),
                             FaultEvent(FaultKind.OOM, tick=t, repeats=2)])
        log = SchedulerEventLog()
        sched, res = run_sched(params, self.reqs(), max_seqs=10, faults=inj, watchdog=True,
                               event_log=log)
        for rid in ("a", "b"):
            assert res[rid].status == "ok" and not bool(res[rid].oom)
            assert_bit_exact(res[rid], ref[rid])
        assert sched.stats.faults == 3 and sched.stats.retries == 2
        assert ("retry", t, 2) in log.decisions
        assert sched.check_invariants() == []

    def test_rolled_back_tick_restores_every_leaf(self, params):
        """Retries run out on a fork tick hit by STEP_FAILURE, then OOM:
        the typed error surfaces with every KV leaf, every trace-store leaf
        and every generator as they were before the tick, although the
        failed attempts wrote the payload in place."""
        _, ref = run_sched(params, self.reqs(), max_seqs=10)
        t = fork_tick(ref["a"])
        inj = FaultInjector([FaultEvent(FaultKind.STEP_FAILURE, tick=t),
                             FaultEvent(FaultKind.OOM, tick=t, repeats=5)])
        sched = Recording(make_engine(params, 10), faults=inj,
                          retry_policy=RetryPolicy(max_retries=2))
        for r in self.reqs():
            sched.submit(r)
        with pytest.raises(FaultRetriesExhausted) as exc:
            sched.run()
        assert exc.value.tick == t and exc.value.attempts == 3
        before = sched.before
        assert len(sched.after_decode) == 3
        assert all(not torch.equal(d, before["cache"].pool.data) for d in sched.after_decode)
        assert same_leaves(sched.engine.cache, before["cache"])
        assert [s.req.rid for s in sched._active] == ["a", "b"]
        for s in sched._active:
            assert same_leaves(s.trace.store, before["stores"][s.req.rid])
            assert torch.equal(rnd.uniform(s.gen, (5,)), rnd.uniform(before["gens"][s.req.rid], (5,)))
        assert sched.check_invariants() == []

    def test_device_loss_raises_before_any_mutation(self, params):
        inj = FaultInjector([FaultEvent(FaultKind.DEVICE_LOSS, tick=2)])
        sched = Recording(make_engine(params, 10), faults=inj)
        for r in self.reqs():
            sched.submit(r)
        with pytest.raises(DeviceLost):
            sched.run()
        assert sched.after_decode == []
        assert same_leaves(sched.engine.cache, sched.before["cache"])
        for s in sched._active:
            assert same_leaves(s.trace.store, sched.before["stores"][s.req.rid])
        assert sched.check_invariants() == []

    def test_rollback_copy_only_under_a_fault_injector(self, params):
        """Only an injected fault fails a tick: without an injector no tick
        takes the rollback snapshot; with one (even an empty one) every
        tick does, and the results are the same."""
        taken = []

        class Counting(Scheduler):
            def _snapshot(self):
                taken.append(self.tick)
                return super()._snapshot()

        out = {}
        for inj in (None, FaultInjector([])):
            taken.clear()
            sched = Counting(make_engine(params, 10), faults=inj)
            for r in self.reqs():
                sched.submit(r)
            out[inj is None] = sched.run()
            assert taken == ([] if inj is None else list(range(sched.stats.ticks)))
        for rid in ("a", "b"):
            assert_bit_exact(out[True][rid], out[False][rid])

    def test_latency_only_slows(self, params):
        req = make_request("a", 4, n=4, steps=6, plen=4)
        log = SchedulerEventLog()
        inj = FaultInjector([FaultEvent(FaultKind.LATENCY, tick=2, delay_s=0.05)])
        sched, res = run_sched(params, [req], max_seqs=6, faults=inj, event_log=log)
        assert_bit_exact(res["a"], alone(params, req, 6))
        assert sched.stats.retries == 0 and max(log.step_wall_s) >= 0.05


# ---------------------------------------------------------------------------
# typed terminations
# ---------------------------------------------------------------------------


class TestTerminations:
    def test_quarantine_keeps_the_prefix_of_a_shorter_run(self, params):
        """Poisoned at tick 3: the tokens of the fault-free run of the same
        request with ``steps=4``, zeros after; the co-resident request
        bit-exact."""
        ra, rb = make_request("a", 1, n=6, steps=8, plen=6), make_request("b", 2, n=4, steps=10, plen=9)
        _, ref = run_sched(params, [ra, rb], max_seqs=10)
        inj = FaultInjector([FaultEvent(FaultKind.NAN_LOGITS, tick=3, rid="a")])
        sched, res = run_sched(params, [ra, rb], max_seqs=10, faults=inj, watchdog=True)
        assert res["a"].status == RequestStatus.POISONED.value
        short = alone(params, dataclasses.replace(ra, steps=4), 10)
        toks = res["a"].tokens
        assert torch.equal(toks[:, :4], short.tokens) and not toks[:, 4:].any()
        assert_bit_exact(res["b"], ref["b"])
        assert sched.stats.poisoned == 1 and sched.check_invariants() == []

    def test_cancel_mid_flight(self, params):
        ra, rb = make_request("a", 1, n=6, steps=8, plen=6), make_request("b", 2, n=4, steps=10, plen=9)
        _, ref = run_sched(params, [ra, rb], max_seqs=10)

        def hook(sched):
            if sched.tick == 3 and "a" not in sched.results:
                sched.cancel("a")

        sched, res = run_sched(params, [ra, rb], max_seqs=10, hook=hook, watchdog=True)
        assert res["a"].status == RequestStatus.CANCELLED.value and res["b"].status == "ok"
        assert not res["a"].tokens[:, 3:].any()
        assert_bit_exact(res["b"], ref["b"])
        assert sched.stats.cancelled == 1 and sched.slots.used == 0
        with pytest.raises(KeyError):
            sched.cancel("a")

    def test_deadlines(self, params):
        sched, res = run_sched(params, [make_request("a", 7, n=4, steps=20, plen=4, deadline=5)],
                               max_seqs=6)
        assert res["a"].status == RequestStatus.EXPIRED.value and not res["a"].tokens[:, 5:].any()
        reqs = [make_request("long", 8, n=4, steps=14, plen=4),
                make_request("big", 9, n=4, steps=8, plen=4, arrive_at=1, deadline=4),
                make_request("small", 10, n=2, steps=4, plen=4, arrive_at=1)]
        sched, res = run_sched(params, reqs, max_seqs=6)
        assert [res[r].status for r in ("long", "big", "small")] == ["ok", "expired", "ok"]
        assert sched.stats.expired == 1

    def test_shed_policy_bounds_queue(self, params):
        reqs = [make_request(f"r{i}", 10 + i, n=4, steps=6, plen=4) for i in range(4)]
        sched, res = run_sched(params, reqs, max_seqs=4, admission="shed", queue_limit=1)
        assert [res[f"r{i}"].status for i in range(4)] == ["ok", "ok", "shed", "shed"]
        assert sched.stats.shed == 2
        with pytest.raises(ValueError, match="admission"):
            Scheduler(make_engine(params, 4), admission="lifo")


# ---------------------------------------------------------------------------
# the committed chaos schedules
# ---------------------------------------------------------------------------


def corpus():
    files = sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json")))
    assert len(files) == 3, files
    return [json.load(open(f)) for f in files]


@pytest.mark.parametrize("spec", corpus(), ids=lambda s: s["name"])
def test_chaos_corpus_bit_exact(params, spec):
    """Each schedule against the same requests without faults: a request
    that ends ``ok`` is bit-exact; a poisoned one holds the tokens of the
    fault-free run cut at its last step; the other statuses agree."""
    reqs = [make_request(**r) for r in spec["requests"]]
    max_seqs = spec["engine"]["max_seqs"]
    knobs = spec.get("knobs", {})
    _, clean = run_sched(params, reqs, max_seqs, **knobs)
    schedule = faults_lib.schedule_from_json(json.dumps(spec["schedule"]))
    sched, res = run_sched(params, reqs, max_seqs, faults=FaultInjector(schedule),
                           watchdog=True, **knobs)
    assert sched.stats.faults > 0
    for r in reqs:
        got = res[r.rid]
        if got.status == RequestStatus.POISONED.value:
            done = got.ess_trace.shape[0]
            short = alone(params, dataclasses.replace(r, steps=done), max_seqs)
            assert torch.equal(got.tokens[:, :done], short.tokens)
            assert not got.tokens[:, done:].any()
        elif clean[r.rid].status == "ok" and got.status == "ok":
            assert_bit_exact(got, clean[r.rid])
        else:
            assert got.status == clean[r.rid].status, r.rid
    assert sched.check_invariants() == []


def test_chaos_corpus_covers_every_recoverable_kind():
    kinds = {ev["kind"] for spec in corpus() for ev in spec["schedule"]}
    assert {k.value for k in faults_lib.RECOVERABLE} | {"nan_logits"} <= kinds
