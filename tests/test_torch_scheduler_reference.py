"""The port's scheduler under faults and checkpoint/restore, against the
JAX reference on replayed draws.

The committed chaos schedules (``tests/chaos_corpus/*.json``, read as
data) and a checkpoint/restore under STEP_FAILURE, OOM and NAN_LOGITS run
through ``repro.serving.Scheduler`` and through the port with the same
weights.  The port draws from a ``Replay`` of the uniforms the reference
drew (``test_torch_smc_decode.reference_draws``); a rolled-back tick
restores its generator, so each request's draws stay those of a
fault-free run.  Every result (integers bit-equal, floats to rtol 1e-5),
its status, ``SchedulerStats``, the event log's decisions, its
per-request records and its recorded trace (``to_json(to_trace())``) must
equal the reference's, with the reference's
smallest top-two sampling gap above 1e-3 (the margin that makes equal
tokens expected; see ``test_torch_smc_decode``).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_smc_decode import (  # noqa: E402,F401
    BS,
    GAP,
    PROPOSAL,
    TARGET,
    cache_kw,
    gaps,
    prompt,
    reference_draws,
    same_result,
    weights,
)

from repro.configs.starcoder2_3b import SMOKE as JSMOKE  # noqa: E402
from repro.models.model import LanguageModel as JLanguageModel  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving import traces as jtraces  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serving.kv_cache import KVCacheConfig as JKVCacheConfig  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.configs.starcoder2_3b import SMOKE  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving import traces as ttraces  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.kv_cache import KVCacheConfig  # noqa: E402

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "chaos_corpus")


class Kill(Exception):
    pass


def corpus():
    files = sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json")))
    assert len(files) == 3, files
    return [json.load(open(f)) for f in files]


def reference_request(r: dict):
    return jsched.DecodeRequest(
        rid=r["rid"], prompt=jnp.asarray(prompt(r["seed"], r["plen"])), n_particles=r["n"],
        steps=r["steps"], key=jax.random.PRNGKey(r["seed"]), target_temp=TARGET,
        proposal_temp=PROPOSAL, token_block_size=BS, arrive_at=r.get("arrive_at", 0),
        deadline=r.get("deadline"))


def port_request(r: dict, want):
    """The request on a Replay of what the reference drew for it: one
    uniform matrix per step it completed, one uniform per resample."""
    resampled = np.asarray(want.resampled)
    draws = reference_draws(jax.random.PRNGKey(r["seed"]), r["n"], len(resampled), resampled)
    return tsched.DecodeRequest(
        rid=r["rid"], prompt=torch.as_tensor(prompt(r["seed"], r["plen"])), n_particles=r["n"],
        steps=r["steps"], gen=rnd.Replay(draws), target_temp=TARGET, proposal_temp=PROPOSAL,
        token_block_size=BS, arrive_at=r.get("arrive_at", 0), deadline=r.get("deadline"))


def schedule(lib, make_engine, reqs, events: str, knobs: dict, tmp_path, checkpoint_at=None):
    """Run ``reqs`` through ``lib``'s scheduler under the fault schedule
    ``events`` (JSON), the watchdog on.  With ``checkpoint_at``, the run
    is killed at that tick's boundary and a scheduler restored from the
    checkpoint file on a fresh engine finishes it, under a fresh injector
    of the same schedule (its earlier events have passed)."""
    sched_lib, faults_lib = lib
    log = sched_lib.SchedulerEventLog()

    def kw():
        inj = faults_lib.FaultInjector(faults_lib.schedule_from_json(events))
        return dict(event_log=log, faults=inj, watchdog=True, **knobs)

    def kill(s):
        if s.tick == checkpoint_at:
            sched_lib.save_checkpoint(tmp_path / "sched.ckpt", s.checkpoint())
            raise Kill

    sched = sched_lib.Scheduler(make_engine(), on_boundary=kill if checkpoint_at else None, **kw())
    for r in reqs:
        sched.submit(r)
    if checkpoint_at is not None:
        with pytest.raises(Kill):
            sched.run()
        state = sched_lib.load_checkpoint(tmp_path / "sched.ckpt")
        sched = sched_lib.Scheduler.restore(make_engine(), state, **kw())
    return sched, sched.run(), log


def against_reference(weights, gaps, tmp_path, specs, max_seqs, events, knobs, checkpoint_at=None):
    jparams, tparams = weights
    js, want, jlog = schedule(
        (jsched, jfaults),
        lambda: JServeEngine(JLanguageModel(JSMOKE), jparams, JKVCacheConfig(**cache_kw(max_seqs))),
        [reference_request(r) for r in specs], events, knobs, tmp_path, checkpoint_at)
    assert min(gaps) > GAP, min(gaps)
    ts, got, tlog = schedule(
        (tsched, tfaults),
        lambda: ServeEngine(LanguageModel(SMOKE), tparams, KVCacheConfig(**cache_kw(max_seqs)),
                            device="cpu"),
        [port_request(r, want[r["rid"]]) for r in specs], events, knobs, tmp_path, checkpoint_at)
    assert sorted(got) == sorted(want)
    for r in specs:
        same_result(got[r["rid"]], want[r["rid"]])
    assert tlog.decisions == jlog.decisions
    assert tlog.requests == jlog.requests
    assert ttraces.to_json(tlog.to_trace()) == jtraces.to_json(jlog.to_trace())
    assert ts.stats.as_dict() == js.stats.as_dict()
    assert ts.check_invariants() == []
    return js


@pytest.mark.parametrize("spec", corpus(), ids=lambda s: s["name"])
def test_chaos_corpus_matches_reference(weights, gaps, tmp_path, spec):
    js = against_reference(weights, gaps, tmp_path, spec["requests"], spec["engine"]["max_seqs"],
                           json.dumps(spec["schedule"]), spec.get("knobs", {}))
    assert js.stats.faults > 0


def test_checkpoint_restore_under_faults_matches_reference(weights, gaps, tmp_path):
    """``recoverable_mix`` with a NAN_LOGITS on its late request, killed at
    tick 4 and restored from the checkpoint file: STEP_FAILURE before the
    checkpoint, OOM twice and the poisoning after it."""
    spec = next(s for s in corpus() if s["name"] == "recoverable_mix")
    events = spec["schedule"] + [dict(kind="nan_logits", tick=7, rid="r1", repeats=1, delay_s=0.0)]
    kinds = {ev["kind"] for ev in events if ev["tick"] < 4}, {ev["kind"] for ev in events if ev["tick"] >= 4}
    assert "step_failure" in kinds[0] and {"oom", "nan_logits"} <= kinds[1]
    js = against_reference(weights, gaps, tmp_path, spec["requests"], spec["engine"]["max_seqs"],
                           json.dumps(events), spec.get("knobs", {}), checkpoint_at=4)
    assert js.stats.checkpoints == 1 and js.stats.retries >= 3 and js.stats.poisoned == 1
