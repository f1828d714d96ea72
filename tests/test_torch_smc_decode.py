"""The port's SMC decoding against the JAX reference, on replayed draws.

starcoder2-3b's smoke config with the same weights on both sides
(``convert.params_from_numpy``).  The test walks each request's key chain
as the reference does (``key, k_samp, k_res = split(key, 3)`` per token)
and records ``uniform(k_samp, (N, V), minval=tiny, maxval=1)`` — the
uniforms behind ``jax.random.categorical``'s Gumbel noise — and, on each
step where the reference resampled, ``uniform(k_res)``; the port runs on a
``Replay`` of those draws.

Integers (tokens, ``resampled``, ``used_blocks_trace``, the event log's
decisions) must be bit-equal; floats (``ess_trace``, ``log_weights``,
``log_evidence``) agree to rtol 1e-5.  The engine's logits agree with the
reference's only to 1e-4 (``tests/test_torch_serving.py``), so each run
also asserts that the reference's smallest top-two gap of
``log_softmax(logits / proposal_temp) + gumbel`` exceeds 1e-3: that margin
is what makes equal tokens expected rather than lucky.

Particle counts are powers of two: the reference's jitted comb divides by
``n`` as a reciprocal multiply, which differs from IEEE division in the
last bit otherwise (ROADMAP.md queue 3).
"""

from __future__ import annotations

import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.starcoder2_3b import SMOKE as JSMOKE  # noqa: E402
from repro.models.model import LanguageModel as JLanguageModel  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.serving.kv_cache import KVCacheConfig as JKVCacheConfig  # noqa: E402
from repro.serving.smc_decode import SMCDecoder as JSMCDecoder  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.configs.starcoder2_3b import SMOKE  # noqa: E402
from repro_torch.core.config import CopyMode  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.serving import scheduler as tsched  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.kv_cache import KVCacheConfig  # noqa: E402
from repro_torch.serving.smc_decode import SMCDecoder, _TokenTrace, smc_token_update  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BS = 4
TARGET, PROPOSAL = 1.0, 4.0  # temperatures at which the smoke model resamples
TINY = np.finfo(np.float32).tiny
GAP = 1e-3


@pytest.fixture(scope="module")
def weights():
    params, _ = JLanguageModel(JSMOKE).init(jax.random.PRNGKey(0))
    return params, convert.params_from_numpy(jax.tree.map(np.asarray, params), SMOKE, "cpu")


@pytest.fixture
def gaps(monkeypatch):
    """The reference's smallest top-two gap of ``logp_prop + gumbel`` over
    every ``smc_token_update`` call the reference scheduler makes."""
    seen = []
    orig = jsched.smc_token_update

    def recording(key, logits, logw, logz, **kw):
        _, k_samp, _ = jax.random.split(key, 3)
        lp = jax.nn.log_softmax(logits / kw["proposal_temp"], axis=-1)
        u = jax.random.uniform(k_samp, lp.shape, minval=TINY, maxval=1.0)
        top2 = np.sort(np.asarray(lp - jnp.log(-jnp.log(u))), axis=-1)[:, -2:]
        seen.append(float((top2[:, 1] - top2[:, 0]).min()))
        return orig(key, logits, logw, logz, **kw)

    monkeypatch.setattr(jsched, "smc_token_update", recording)
    return seen


def reference_draws(key, n: int, steps: int, resampled) -> list:
    """The uniforms the reference draws for one request, in its order."""
    draws = []
    for t in range(steps):
        key, k_samp, k_res = jax.random.split(key, 3)
        u = jax.random.uniform(k_samp, (n, JSMOKE.padded_vocab), minval=TINY, maxval=1.0)
        draws.append(("uniform", np.asarray(u)))
        if resampled[t]:
            draws.append(("uniform", np.asarray(jax.random.uniform(k_res))))
    return draws


def prompt(seed: int, plen: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, SMOKE.vocab_size, plen).astype(np.int32)


def cache_kw(max_seqs: int, **over) -> dict:
    kw = dict(n_layers=SMOKE.n_layers, n_kv_heads=SMOKE.n_kv_heads, head_dim=SMOKE.hd,
              block_size=BS, max_seqs=max_seqs, max_blocks_per_seq=16, dtype="float32")
    kw.update(over)
    return kw


def same_result(got, want, *, integers_only=False):
    """A port result against the reference's: integers bit-equal, floats
    to rtol 1e-5."""
    for f in ("tokens", "resampled", "used_blocks_trace"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    assert bool(got.oom) == bool(want.oom) and int(got.grew) == int(want.grew)
    assert got.preemptions == want.preemptions and got.status == want.status
    if integers_only:
        return
    for f in ("ess_trace", "log_weights", "log_evidence"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=0, err_msg=f)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_gumbel_is_categoricals_noise():
    """``random.gumbel`` on the reference's uniforms is the noise
    ``jax.random.categorical`` adds (values to 1e-6), so the samples agree
    wherever the top-two gap is wider than that."""
    key = jax.random.PRNGKey(3)
    logits = jax.random.normal(jax.random.PRNGKey(4), (64, 256)) * 3
    want = np.asarray(jax.random.categorical(key, logits))
    u = np.asarray(jax.random.uniform(key, logits.shape, minval=TINY, maxval=1.0))
    noise = rnd.gumbel(rnd.Replay([("uniform", u)]), logits.shape)
    np.testing.assert_allclose(
        noise.numpy(), np.asarray(jax.random.gumbel(key, logits.shape)), rtol=1e-6, atol=1e-6
    )
    got = torch.argmax(torch.as_tensor(np.array(logits)) + noise, dim=-1).numpy()
    np.testing.assert_array_equal(got, want)
    # The clamp: a zero uniform (a torch.Generator can draw one) is finite.
    assert bool(torch.isfinite(rnd.gumbel(rnd.Replay([("uniform", np.zeros(3))]), (3,))).all())


def test_token_update_draws_the_resampling_uniform_once():
    """``k_res`` is the generator before the resampling uniform: the fused
    clone of the token store draws that same uniform and derives the same
    ancestors as ``resample_systematic``."""
    n, v = 8, 32
    rng = np.random.default_rng(5)
    logits = torch.as_tensor(rng.standard_normal((n, v)).astype(np.float32) * 4)
    logw = torch.full((n,), -np.log(n), dtype=torch.float32)
    draws = [("uniform", rng.random((n, v))), ("uniform", np.float32(0.37))]
    gen = rnd.Replay(draws)
    token, lw, logz, ess, do_res, anc, k_res = smc_token_update(
        gen, logits, logw, torch.zeros(()), n=n, target_temp=0.5, proposal_temp=1.0,
        ess_threshold=1.01,
    )
    assert do_res and gen.remaining == 0 and k_res.remaining == 1
    trace = _TokenTrace(n, 4, CopyMode.LAZY_SR, 4, device="cpu")
    trace.append(token.to(torch.int32))
    assert torch.equal(trace.clone_chain(k_res, lw), anc) and k_res.remaining == 0
    _, _, _, _, no_res, none, no_key = smc_token_update(
        rnd.Replay(draws[:1]), logits, logw, torch.zeros(()), n=n, target_temp=0.5,
        proposal_temp=1.0, ess_threshold=0.0,
    )
    assert not no_res and none is None and no_key is None


def test_token_trace_refuses_a_mesh():
    """A mesh that is not the port's ShardMesh is refused; the port's own
    shards the trace."""
    from repro_torch.distributed import ShardMesh

    with pytest.raises(TypeError, match="ShardMesh"):
        _TokenTrace(4, 4, CopyMode.LAZY_SR, 4, mesh=object(), device="cpu")
    tr = _TokenTrace(4, 4, CopyMode.LAZY_SR, 4, mesh=ShardMesh.in_process(2, "cpu"))
    assert len(tr.store.shards) == 2 and tr.append_need == 2


# ---------------------------------------------------------------------------
# whole runs against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [CopyMode.LAZY_SR, CopyMode.EAGER])
def test_decoder_matches_reference(weights, gaps, mode):
    """``SMCDecoder.run``: 8 particles, 12 tokens, growth on from the
    automatic pool."""
    jparams, tparams = weights
    n, steps, key = 8, 12, jax.random.PRNGKey(101)
    p = prompt(1, 6)
    kw = dict(max_len=48, block_size=BS, target_temp=TARGET, proposal_temp=PROPOSAL)
    from repro.core.config import CopyMode as JCopyMode

    jdec = JSMCDecoder(JLanguageModel(JSMOKE), jparams, n,
                       token_copy_mode=JCopyMode(mode.value), **kw)
    want = jdec.run(key, jnp.asarray(p), steps)
    assert np.asarray(want.resampled).any()  # the fork path runs
    assert min(gaps) > GAP, min(gaps)
    dec = SMCDecoder(LanguageModel(SMOKE), tparams, n, token_copy_mode=mode, device="cpu", **kw)
    gen = rnd.Replay(reference_draws(key, n, steps, np.asarray(want.resampled)))
    got = dec.run(gen, torch.as_tensor(p), steps)
    same_result(got, want)
    assert gen.remaining == len(gen._draws)  # the request's own copy drew
    assert dec.executor.stats.grow_events == jdec.executor.stats.grow_events


def test_two_requests_with_a_preemption_match_reference(weights, gaps):
    """A two-request schedule with one forced preemption: every result
    and the event log's decisions equal the reference's."""
    jparams, tparams = weights
    specs = [("a", 8, 10, 6, 201), ("b", 4, 9, 9, 202)]  # rid, n, steps, plen, key seed

    def hook(sched):
        if sched.tick == 3 and any(s.req.rid == "b" for s in sched._active):
            sched.preempt("b")

    jlog = jsched.SchedulerEventLog()
    jeng = JServeEngine(JLanguageModel(JSMOKE), jparams, JKVCacheConfig(**cache_kw(12)))
    js = jsched.Scheduler(jeng, on_boundary=hook, event_log=jlog)
    for rid, n, steps, plen, seed in specs:
        js.submit(jsched.DecodeRequest(
            rid=rid, prompt=jnp.asarray(prompt(seed, plen)), n_particles=n, steps=steps,
            key=jax.random.PRNGKey(seed), target_temp=TARGET, proposal_temp=PROPOSAL,
            token_block_size=BS))
    want = js.run()
    assert js.stats.preemptions == 1 and js.stats.replayed_tokens > 0
    assert min(gaps) > GAP, min(gaps)

    tlog = tsched.SchedulerEventLog()
    teng = ServeEngine(LanguageModel(SMOKE), tparams, KVCacheConfig(**cache_kw(12)), device="cpu")
    ts = tsched.Scheduler(teng, on_boundary=hook, event_log=tlog)
    for rid, n, steps, plen, seed in specs:
        draws = reference_draws(jax.random.PRNGKey(seed), n, steps, np.asarray(want[rid].resampled))
        ts.submit(tsched.DecodeRequest(
            rid=rid, prompt=torch.as_tensor(prompt(seed, plen)), n_particles=n, steps=steps,
            gen=rnd.Replay(draws), target_temp=TARGET, proposal_temp=PROPOSAL,
            token_block_size=BS))
    got = ts.run()
    for rid, *_ in specs:
        same_result(got[rid], want[rid])
    assert tlog.decisions == jlog.decisions
    assert tlog.requests == jlog.requests
    assert ts.stats.as_dict() == js.stats.as_dict()
    assert ts.check_invariants() == []


# ---------------------------------------------------------------------------
# within the port
# ---------------------------------------------------------------------------


def test_kv_delta_cow_is_bit_identical(weights):
    _, tparams = weights
    out, made = {}, []
    for delta in (False, True):
        eng = ServeEngine(LanguageModel(SMOKE), tparams,
                          KVCacheConfig(**cache_kw(8, delta_cow=delta)), device="cpu")
        sched = tsched.Scheduler(
            eng, on_boundary=lambda s: made.append(bool((s.engine.cache.pool.parent >= 0).any())))
        sched.submit(tsched.DecodeRequest(
            rid="a", prompt=torch.as_tensor(prompt(2, 7)), n_particles=8, steps=12,
            gen=rnd.generator(7, "cpu"), target_temp=TARGET, proposal_temp=PROPOSAL,
            token_block_size=BS))
        out[delta] = sched.run()["a"]
    assert any(made)  # the delta run made delta pages
    assert out[False].resampled.any()
    # Everything a reader sees; the page counts differ (a delta page keeps
    # its parent alive).
    for f in ("tokens", "log_weights", "log_evidence", "ess_trace", "resampled"):
        assert torch.equal(getattr(out[False], f), getattr(out[True], f)), f


def test_decoder_on_a_fixed_pool_surfaces_oom(weights):
    """``grow_stores=False`` on an undersized pool runs to the end and
    surfaces the sticky flag (``strict_admission=False``), as the
    reference's decoder does."""
    _, tparams = weights
    dec = SMCDecoder(LanguageModel(SMOKE), tparams, 8, max_len=48, block_size=BS,
                     kv_num_blocks=6, grow_stores=False, device="cpu")
    res = dec.run(rnd.generator(8, "cpu"), torch.as_tensor(prompt(3, 6)), 8)
    assert bool(res.oom) and int(res.grew) == 0


def test_device_policy(weights):
    _, tparams = weights
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SMCDecoder(LanguageModel(SMOKE), tparams, 4)
    with pytest.raises(TypeError, match="ShardMesh"):
        SMCDecoder(LanguageModel(SMOKE), tparams, 4, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_serve_smc_on_the_cpu(capsys):
    res = serve.main(["--smc", "--device", "cpu", "--particles", "8", "--prompt-len", "6",
                      "--steps", "5"])
    assert tuple(res.tokens.shape) == (8, 5) and not bool(res.oom)
    assert "SMC decode: 8 particles x 5 tokens" in capsys.readouterr().out


def test_example_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["torch_smc_decode.py", "--device", "cpu",
                                      "--particles", "4", "--steps", "6", "--prompt-len", "5"])
    runpy.run_path(str(ROOT / "examples" / "torch_smc_decode.py"), run_name="__main__")
    out = capsys.readouterr().out
    assert "decoded 4x6 tokens" in out and "peak KV blocks" in out and "best continuation" in out
