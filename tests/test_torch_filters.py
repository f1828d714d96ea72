"""The port's particle filter against the JAX reference, and against
itself across copy modes.

Whole runs against the reference replay its draws: the test walks the
reference filter's key chain (``key, init_key = split(key)``, then per
generation ``key, k_res, k_prop, k_alive = split(key, 4)``) and hands
the same uniforms and normals to the port through
:class:`repro_torch.random.Replay`.  Integer results (ancestors, block
counts, tables) must then be equal; ``log_evidence`` agrees to rtol
1e-5, the jax/torch float32 drift in ``exp``, ``cumsum`` and logsumexp.
The replayed runs cover the bootstrap filter, the adaptive gate, the
auxiliary filter's weight correction and conditional SMC.

Multinomial and residual resampling invert the CDF at ``N`` uniforms
where the reference draws Gumbel noise, so their draws cannot be
replayed; they are held to the reference's samplers in distribution.
The alive filter's redraw loop runs on the multinomial sampler and is
held only across copy modes.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import store as jstore  # noqa: E402
from repro.core.config import CopyMode as JMode  # noqa: E402
from repro.smc import filters as jfilters  # noqa: E402
from repro.smc import resampling as jresampling  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.core import pool as tpool  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.core.config import ALL_MODES, CopyMode  # noqa: E402
from repro_torch.smc import executor as texec  # noqa: E402
from repro_torch.smc import resampling as tresampling  # noqa: E402
from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef  # noqa: E402

A, Q, R = 0.9, 0.5, 0.3
CPU = torch.device("cpu")
N, T = 64, 16
# the path conditional SMC pins particle 0 to
REFERENCE = np.linspace(-1, 1, T, dtype=np.float32).reshape(T, 1)


def weight(y, x, log):
    return -0.5 * ((y - x) ** 2 / R + log(2 * math.pi * R))


def jax_ssm(lookahead: bool = False) -> jfilters.SSMDef:
    """The LGSSM, with a state that records each resampling's ancestors."""

    def init(key, n, params):
        return jax.random.normal(key, (n,)), jnp.zeros((T, n), jnp.int32), jnp.int32(0)

    def step(key, state, t, y, params):
        x, hist, k = state
        x = A * x + math.sqrt(Q) * jax.random.normal(key, x.shape)
        return (x, hist, k), weight(y, x, math.log), x[:, None]

    def clone_state(state, anc):
        x, hist, k = state
        return x[anc], hist.at[k].set(anc), k + 1

    def look(state, t, y, params):
        return weight(y, A * state[0], math.log)

    def set_reference(state, ref_t):
        x, hist, k = state
        return x.at[0].set(ref_t[0]), hist, k

    return jfilters.SSMDef(
        init=init,
        step=step,
        record_shape=(1,),
        clone_state=clone_state,
        lookahead=look if lookahead else None,
        set_reference=set_reference,
    )


def torch_ssm(record_ancestors: bool = True, lookahead: bool = False) -> SSMDef:
    def init(gen, n, params):
        x = rnd.normal(gen, (n,))
        if not record_ancestors:
            return x
        return x, torch.zeros((T, n), dtype=torch.int32, device=x.device), 0

    def step(gen, state, t, y, params):
        x = state[0] if record_ancestors else state
        x = A * x + math.sqrt(Q) * rnd.normal(gen, x.shape)
        new = (x, *state[1:]) if record_ancestors else x
        return new, weight(y, x, math.log), x[:, None]

    def clone_state(state, anc):
        x, hist, k = state
        hist = hist.clone()
        hist[k] = anc
        return x[anc.long()], hist, k + 1

    def look(state, t, y, params):
        x = state[0] if record_ancestors else state
        return weight(y, A * x, math.log)

    def set_reference(state, ref_t):
        x = (state[0] if record_ancestors else state).clone()
        x[0] = ref_t[0]
        return (x, *state[1:]) if record_ancestors else x

    return SSMDef(
        init=init,
        step=step,
        record_shape=(1,),
        clone_state=clone_state if record_ancestors else None,
        lookahead=look if lookahead else None,
        set_reference=set_reference,
    )


def reference_draws(key, resampler: str, resampled):
    """The uniforms and normals the reference filter draws, in order; a
    generation draws its resampling uniforms only where it resampled."""
    key, init_key = jax.random.split(key)
    draws = [("normal", jax.random.normal(init_key, (N,)))]
    for t in range(T):
        key, k_res, k_prop, _ = jax.random.split(key, 4)
        if resampled[t]:
            shape = () if resampler == "systematic" else (N,)
            draws.append(("uniform", jax.random.uniform(k_res, shape)))
        draws.append(("normal", jax.random.normal(k_prop, (N,))))
    return [(kind, np.asarray(a)) for kind, a in draws]


@pytest.fixture(scope="module")
def observations():
    return np.random.default_rng(0).standard_normal(T).astype(np.float32)


def case(mode, resampler, **extra):
    """A replayed-run case: ``adaptive`` (the ESS gate), ``lookahead``
    (the auxiliary filter) and ``csmc`` (a conditional sweep, its value
    being ``use_ref``)."""
    tags = [f"{k}" if v is True else f"{k}={v}" for k, v in extra.items()]
    name = "-".join([str(mode), resampler, *tags])
    return pytest.param(mode, resampler, extra, id=name)


@pytest.mark.parametrize(
    "mode, resampler, extra",
    [case(m, "systematic") for m in ALL_MODES]
    + [
        case(CopyMode.LAZY, "stratified"),
        case(CopyMode.LAZY_SR, "systematic", adaptive=True),
        case(CopyMode.EAGER, "stratified", adaptive=True),
        case(CopyMode.LAZY, "systematic", lookahead=True),
        case(CopyMode.LAZY_SR, "stratified", lookahead=True, adaptive=True),
        case(CopyMode.LAZY_SR, "systematic", csmc=True),
        case(CopyMode.LAZY, "systematic", csmc=False),
        case(CopyMode.EAGER, "stratified", csmc=True, lookahead=True),
    ],
)
def test_replayed_run_matches_reference(observations, mode, resampler, extra):
    key = jax.random.PRNGKey(11)
    adaptive, lookahead = extra.get("adaptive", False), extra.get("lookahead", False)
    kw = dict(
        n_particles=N, n_steps=T, resampler=resampler, always_resample=not adaptive
    )
    jpf = jfilters.ParticleFilter(
        jax_ssm(lookahead), jfilters.FilterConfig(mode=JMode(mode.value), **kw)
    )
    pf = ParticleFilter(
        torch_ssm(lookahead=lookahead), FilterConfig(mode=mode, **kw), device="cpu"
    )
    if "csmc" in extra:
        use_ref = extra["csmc"]
        ys, ref = jnp.asarray(observations), jnp.asarray(REFERENCE)
        want = jpf.csmc_sweep(key, None, ys, ref, use_ref)
        replay = rnd.Replay(reference_draws(key, resampler, np.asarray(want.resampled)))
        ref = torch.as_tensor(REFERENCE)
        got = pf.csmc_sweep(replay, None, observations, ref, use_ref)
        pinned = tstore.trajectory(pf.store_cfg, got.store, 0)[:T].numpy()
        assert np.array_equal(pinned, REFERENCE) == use_ref
    else:
        want = jpf.jitted()(key, None, jnp.asarray(observations))
        replay = rnd.Replay(reference_draws(key, resampler, np.asarray(want.resampled)))
        got = pf.run(replay, None, observations)
    assert replay.remaining == 0
    n_resampled = int(np.asarray(want.resampled).sum())
    if adaptive:  # the ESS gate both fired and held back
        assert 0 < n_resampled < T - 1, n_resampled
    else:
        assert n_resampled == T - 1

    # ancestors of every resampling step (recorded by clone_state)
    np.testing.assert_array_equal(got.state[1].numpy(), np.asarray(want.state[1]))
    np.testing.assert_allclose(
        got.log_weights.numpy(), np.asarray(want.log_weights), rtol=1e-5, atol=1e-6
    )
    assert int(got.store.peak_blocks) == int(want.store.peak_blocks)
    np.testing.assert_array_equal(
        got.used_blocks_trace.numpy(), np.asarray(want.used_blocks_trace)
    )
    np.testing.assert_array_equal(got.resampled.numpy(), np.asarray(want.resampled))
    np.testing.assert_array_equal(got.store.tables.numpy(), np.asarray(want.store.tables))
    np.testing.assert_array_equal(got.store.lengths.numpy(), np.asarray(want.store.lengths))
    np.testing.assert_allclose(
        float(got.log_evidence), float(want.log_evidence), rtol=1e-5
    )
    np.testing.assert_allclose(got.ess_trace.numpy(), np.asarray(want.ess_trace), rtol=1e-5)
    trajs = tstore.materialize_batch(pf.store_cfg, got.store, torch.arange(N))
    want_trajs = jstore.materialize_batch(jpf.store_cfg, want.store, jnp.arange(N))
    np.testing.assert_allclose(trajs.numpy(), np.asarray(want_trajs), rtol=1e-5, atol=1e-6)
    assert not bool(got.oom)


def run_port(mode, ys, seed=0, ssm=None, **kw):
    cfg = FilterConfig(n_particles=N, n_steps=T, mode=mode, **kw)
    pf = ParticleFilter(ssm or torch_ssm(False), cfg, device="cpu")
    return pf, pf.run(rnd.generator(seed, "cpu"), None, ys)


@pytest.mark.parametrize(
    "kw",
    [
        dict(resampler="systematic"),
        dict(resampler="stratified", always_resample=False),
        dict(resampler="residual"),
        dict(resampler="multinomial", block_size=1),
    ],
)
def test_log_evidence_bit_identical_across_modes(observations, kw):
    """The paper's correctness check: one seed, one log-evidence, whatever
    the copy mode (the fused clone_chain path included)."""
    runs = [run_port(mode, observations, **kw) for mode in ALL_MODES]
    logz = [float(r.log_evidence) for _, r in runs]
    assert logz[0] == logz[1] == logz[2] and math.isfinite(logz[0])
    eager_pf, eager = runs[0]
    dense = tstore.materialize_batch(eager_pf.store_cfg, eager.store, torch.arange(N))
    for pf, res in runs[1:]:
        assert not bool(res.oom)
        assert int(res.store.peak_blocks) < N * T // pf.config.block_size
        lazy = tstore.materialize_batch(pf.store_cfg, res.store, torch.arange(N))
        np.testing.assert_array_equal(lazy[:, :T].numpy(), dense[:, :T].numpy())
        assert tpool.check_invariants(res.store.pool, res.store.tables) == []


def test_auxiliary_and_alive_paths_agree_across_modes(observations):
    base = torch_ssm(False)

    def lookahead(x, t, y, params):
        return weight(y, A * x, math.log)

    def alive(dlogw):
        return dlogw < -6.0

    ssm = base._replace(lookahead=lookahead, alive=alive)
    runs = [run_port(m, observations, ssm=ssm, max_retries=2)[1] for m in ALL_MODES]
    logz = {float(r.log_evidence) for r in runs}
    assert len(logz) == 1 and math.isfinite(logz.pop())


def test_csmc_pins_reference_lineage(observations):
    reference = torch.linspace(-1, 1, T).reshape(T, 1)
    cfg = FilterConfig(n_particles=N, n_steps=T, mode=CopyMode.LAZY_SR)
    pf = ParticleFilter(torch_ssm(False), cfg, device="cpu")
    res = pf.csmc_sweep(rnd.generator(3, "cpu"), None, observations, reference, True)
    np.testing.assert_array_equal(
        tstore.trajectory(pf.store_cfg, res.store, 0)[:T].numpy(), reference.numpy()
    )


@pytest.mark.parametrize("resampler", ["multinomial", "residual"])
def test_random_resamplers_match_reference_in_distribution(resampler):
    """The port's multinomial and residual resamplers draw differently
    from the reference's by design; over many draws from fixed weights,
    each ancestor's mean and variance of copies must agree with the
    reference sampler's (within 5 standard errors of the mean, 20% in
    the variance), and residual resampling must keep its floor(N w)
    deterministic copies in every draw."""
    n, reps = 8, 4000
    rng = np.random.default_rng(7)
    logw = np.log(rng.dirichlet(np.ones(n))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), reps)
    jdraw = jax.vmap(lambda k: jresampling.RESAMPLERS[resampler](k, jnp.asarray(logw)))
    jcounts = np.stack([np.bincount(a, minlength=n) for a in np.asarray(jdraw(keys))])
    gen = rnd.generator(0, "cpu")
    tdraw = tresampling.RESAMPLERS[resampler]
    tlogw = torch.as_tensor(logw)
    tcounts = np.stack(
        [np.bincount(tdraw(gen, tlogw).numpy(), minlength=n) for _ in range(reps)]
    )
    w = np.exp(logw - np.logaddexp.reduce(logw))
    se = np.sqrt((jcounts.var(0) + tcounts.var(0)) / reps)
    np.testing.assert_array_less(np.abs(jcounts.mean(0) - tcounts.mean(0)), 5 * se)
    t_se = np.sqrt(tcounts.var(0) / reps)
    np.testing.assert_array_less(np.abs(tcounts.mean(0) - n * w), 5 * t_se)
    np.testing.assert_allclose(tcounts.var(0), jcounts.var(0), rtol=0.2)
    if resampler == "residual":
        floor = np.floor(n * w).astype(int)
        assert (jcounts >= floor).all() and (tcounts >= floor).all()


class TestGrowth:
    """tests/test_pool_lifecycle.py's acceptance scenario, on the port."""

    n, t, small = 32, 32, 40

    def run(self, ys, **kw):
        cfg = FilterConfig(
            n_particles=self.n, n_steps=self.t, mode=CopyMode.LAZY_SR, block_size=2, **kw
        )
        pf = ParticleFilter(torch_ssm(False), cfg, device="cpu")
        res = pf.run(rnd.generator(5, "cpu"), None, ys)
        return res, tstore.materialize_batch(pf.store_cfg, res.store, torch.arange(self.n))

    def test_growth_matches_oversized_pool_bit_exact(self):
        ys = np.random.default_rng(1).standard_normal(self.t).astype(np.float32)
        ref, ref_trajs = self.run(ys)
        grown, trajs = self.run(ys, pool_blocks=self.small, grow=True, grow_chunk=4)
        assert not bool(grown.oom) and int(grown.grew) >= 1
        assert float(grown.log_evidence) == float(ref.log_evidence)
        np.testing.assert_array_equal(grown.ess_trace.numpy(), ref.ess_trace.numpy())
        np.testing.assert_array_equal(
            grown.used_blocks_trace.numpy(), ref.used_blocks_trace.numpy()
        )
        np.testing.assert_array_equal(trajs.numpy(), ref_trajs.numpy())
        bad, bad_trajs = self.run(ys, pool_blocks=self.small)
        assert bool(bad.oom) and not np.array_equal(bad_trajs.numpy(), ref_trajs.numpy())


def test_rollback_retry_replays_from_a_clean_checkpoint():
    """The store is written in place, so the executor must snapshot the
    carry (tensors and generator position) before a chunk that may be
    retried: a retried chunk then equals a chunk run with room to spare."""

    def chunk_fn(carry, ts):
        gen, buf, cap = carry
        for t in ts:
            buf[t] += rnd.uniform(gen, ())  # in-place write, like cow_write
        return (gen, buf, cap), None

    def pool(oom_below):
        return texec.PoolView(
            free=lambda c: 0,
            num_blocks=lambda c: c[2],
            cap=100,
            grow_to=lambda c, nb: (c[0], c[1], nb),
            oom=lambda c: c[2] < oom_below,
        )

    policy = texec.GrowthPolicy(grow=True, chunk=3)
    results = []
    for cap0 in (1, 64):  # the first fails its chunks and retries; the second never does
        ex = texec.PopulationExecutor()
        carry = (rnd.generator(0, "cpu"), torch.zeros(7), cap0)
        carry, _, grew = ex.run(carry, n_steps=7, chunk_fn=chunk_fn, policy=policy, pool=pool(8))
        results.append((carry[1], ex.stats.retries))
    (retried, n_retries), (clean, none) = results
    assert n_retries >= 1 and none == 0
    np.testing.assert_array_equal(retried.numpy(), clean.numpy())
