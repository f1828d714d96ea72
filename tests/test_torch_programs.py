"""The paper's five programs in the port, against the JAX reference on
replayed draws and against themselves across copy modes.

Each program runs once in the reference (jitted, LAZY_SR, N = 64,
T = 24, shared by a module-scoped fixture) under a wrapper that records
every resampling's ancestors in the state.  The test walks the
reference's key chain — ``key, init_key = split(key)``, then per
generation ``key, k_res, k_prop, k_alive = split(key, 4)`` — and each
program's own splits inside ``init`` and ``step``, and replays the
uniforms, normals and Poisson counts into the port in all three copy
modes.  Categorical draws replay the uniforms on ``[tiny, 1)`` behind
``jax.random.categorical``'s Gumbel noise; PCFG's discarded token draw is
not made by the port and is skipped.  Integers (ancestors, ``resampled``,
lengths, the program's integer state; LAZY_SR's tables and block counts)
must be equal; log-weights and trajectories agree to rtol 1e-5 / atol
1e-6 and ``log_evidence`` to rtol 1e-5.  N is a power of two: the
reference's jitted comb divides by N as a reciprocal multiply
(ROADMAP.md queue 3).

CRBD's alive loop redraws through ``jax.random.categorical`` over N x N
Gumbel noise, which the port's multinomial sampler does not replay: CRBD
is held against the reference with ``max_retries=0`` and, with retries,
across the port's own modes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import store as jstore  # noqa: E402
from repro.core.config import CopyMode as JMode  # noqa: E402
from repro.smc import filters as jfilters  # noqa: E402
from repro.smc.programs import PROBLEMS as JPROBLEMS  # noqa: E402
from repro.smc.programs import crbd as jcrbd  # noqa: E402
from repro.smc.programs import pcfg as jpcfg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.core.config import ALL_MODES, CopyMode  # noqa: E402
from repro_torch.smc import executor as texec  # noqa: E402
from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef, _as_tensors  # noqa: E402
from repro_torch.smc.programs import PROBLEMS, crbd, mot, pcfg  # noqa: E402

N, T = 64, 24
KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")
TINY = float(np.finfo(np.float32).tiny)
# MOT's positions are sums of terms up to the arena's size (20), so their
# error is absolute, a few units in the last place at 20 (1.9e-6 each):
# the reference folds the noise's scale into its normal sampler's own
# constant under jit (``c * normal`` is one multiply by ``c * sqrt(2)``),
# which no replayed normal reproduces.  A position near 0 then carries an
# error of 1e-5 that rtol cannot cover.
TRAJ_ATOL = {"mot": 1e-5}


# -- the ancestry wrapper (same draws, the ancestors kept in the state) -----


def jax_ancestry(ssm: jfilters.SSMDef) -> jfilters.SSMDef:
    clone = ssm.clone_state or (lambda s, a: jax.tree.map(lambda x: x[a], s))

    def init(key, n, params):
        return ssm.init(key, n, params), jnp.zeros((T, n), jnp.int32), jnp.int32(0)

    def step(key, state, t, y, params):
        s, hist, k = state
        s, logw, record = ssm.step(key, s, t, y, params)
        return (s, hist, k), logw, record

    def clone_state(state, anc):
        s, hist, k = state
        return clone(s, anc), hist.at[k].set(anc), k + 1

    look = ssm.lookahead
    return ssm._replace(
        init=init,
        step=step,
        clone_state=clone_state,
        lookahead=None if look is None else (lambda st, t, y, p: look(st[0], t, y, p)),
        set_reference=None,
    )


def torch_ancestry(ssm: SSMDef) -> SSMDef:
    clone = ssm.clone_state or (
        lambda s, a: texec.tree_map(lambda x: x[a.long()], s)
    )

    def init(gen, n, params):
        s = ssm.init(gen, n, params)
        return s, torch.zeros((T, n), dtype=torch.int32, device=gen.device), 0

    def step(gen, state, t, y, params):
        s, hist, k = state
        s, logw, record = ssm.step(gen, s, t, y, params)
        return (s, hist, k), logw, record

    def clone_state(state, anc):
        s, hist, k = state
        hist = hist.clone()
        hist[k] = anc
        return clone(s, anc), hist, k + 1

    look = ssm.lookahead
    return ssm._replace(
        init=init,
        step=step,
        clone_state=clone_state,
        lookahead=None if look is None else (lambda st, t, y, p: look(st[0], t, y, p)),
        set_reference=None,
    )


# -- each program's draws, in the reference's key order ----------------------


def normal(key, shape):
    return ("normal", jax.random.normal(key, shape))


def uniform(key, shape, minval=0.0):
    return ("uniform", jax.random.uniform(key, shape, minval=minval, maxval=1.0))


def init_draws(name, key, n):
    if name == "rbpf":
        return [normal(key, (n,))]
    if name == "mot":
        k1, k2 = jax.random.split(key)
        return [uniform(k1, (n, mot.K, 2)), normal(k2, (n, mot.K, 2))]
    return []  # pcfg, vbd, crbd draw nothing at init


def step_draws(name, key, n, obs, t):
    if name == "rbpf":
        k_xi, _ = jax.random.split(key)
        return [normal(k_xi, (n,))]
    if name == "vbd":
        ks = jax.random.split(key, 6)
        return [normal(ks[i], (n,)) for i in range(5)]
    if name == "mot":
        ks = jax.random.split(key, 5)
        return [
            normal(ks[0], (n, mot.K, 2)),
            normal(ks[1], (n, mot.K, 2)),
            uniform(ks[2], (n, mot.K)),
            uniform(ks[3], (n,)),
            uniform(ks[4], (n, 2)),
        ]
    if name == "crbd":
        k1, k2 = jax.random.split(key)
        lam = crbd.LAMBDA * jnp.asarray(obs.dt[t])
        counts = jax.random.poisson(k1, lam, (n,))
        return [("poisson", counts), uniform(k2, (n, crbd.MAX_HIDDEN))]
    assert name == "pcfg"
    out = []
    for k in jax.random.split(key, pcfg.MAX_EXPAND):
        k_branch, _k_emit, k_l, k_r = jax.random.split(k, 4)
        out += [
            uniform(k_branch, (n,)),
            uniform(k_l, (n, pcfg.K), TINY),
            uniform(k_r, (n, pcfg.K), TINY),
        ]
    return out


def filter_draws(name, key, n, t_steps, obs, resampled):
    """A filter run's draws (``ParticleFilter._run``'s key chain)."""
    key, init_key = jax.random.split(key)
    draws = init_draws(name, init_key, n)
    for t in range(t_steps):
        key, k_res, k_prop, _ = jax.random.split(key, 4)
        if resampled[t]:
            draws.append(uniform(k_res, ()))
        draws += step_draws(name, k_prop, n, obs, t)
    return [(kind, np.asarray(a)) for kind, a in draws]


# -- the reference runs and the port's replays -------------------------------


def jbuild(name, mode=JMode.LAZY_SR):
    mod = JPROBLEMS[name]
    return mod.build(mode) if name == "pcfg" else mod.build()


def tbuild(name, mode):
    mod = PROBLEMS[name]
    return mod.build(mode) if name == "pcfg" else mod.build()


def numpy_tree(tree):
    return jax.tree.map(np.array, tree)


def int_state(name, state):
    """The program's integer state, as numpy."""
    inner = state[0]
    if name == "pcfg":
        return np.asarray(inner.sp)
    if name == "mot":
        return np.asarray(inner[1])
    if name == "crbd":
        return np.asarray(inner)
    return None


class Reference(NamedTuple):
    store_cfg: object
    obs: object
    params: object
    result: object


@pytest.fixture(scope="module")
def references():
    """One jitted LAZY_SR reference run per program, made on first use."""
    runs = {}

    def get(name):
        if name not in runs:
            ssm, params = jbuild(name)
            obs = numpy_tree(JPROBLEMS[name].gen_data(KEY, T))
            cfg = jfilters.FilterConfig(n_particles=N, n_steps=T, mode=JMode.LAZY_SR)
            pf = jfilters.ParticleFilter(jax_ancestry(ssm), cfg)
            res = pf.jitted()(KEY, params, obs)
            runs[name] = Reference(pf.store_cfg, obs, params, res)
        return runs[name]

    return get


def stack_cells(cells, sp):
    """Each stack's cells below its pointer (the rest are unspecified)."""
    cells, sp = np.asarray(cells), np.asarray(sp)
    return np.where(np.arange(cells.shape[1])[None, :] < sp[:, None], cells, 0)


@pytest.mark.parametrize("mode", ALL_MODES, ids=str)
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_replayed_program_matches_reference(references, name, mode):
    ref = references(name)
    want = ref.result
    resampled = np.asarray(want.resampled)
    replay = rnd.Replay(filter_draws(name, KEY, N, T, ref.obs, resampled))
    ssm, _ = tbuild(name, mode)
    params = convert.program_params_from_numpy(name, numpy_tree(ref.params))
    pf = ParticleFilter(torch_ancestry(ssm), FilterConfig(n_particles=N, n_steps=T, mode=mode), device="cpu")
    got = pf.run(replay, params, ref.obs)
    assert replay.remaining == 0
    assert resampled[1:].all() and not bool(got.oom)

    np.testing.assert_array_equal(got.resampled.numpy(), resampled)
    np.testing.assert_array_equal(got.state[1].numpy(), np.asarray(want.state[1]))  # ancestors
    np.testing.assert_array_equal(got.store.lengths.numpy(), np.asarray(want.store.lengths))
    want_int = int_state(name, want.state)
    if want_int is not None:
        np.testing.assert_array_equal(int_state(name, got.state), want_int)
    np.testing.assert_allclose(
        got.log_weights.numpy(), np.asarray(want.log_weights), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(float(got.log_evidence), float(want.log_evidence), rtol=1e-5)
    trajs = tstore.materialize_batch(pf.store_cfg, got.store, torch.arange(N))[:, :T]
    want_trajs = np.asarray(jstore.materialize_batch(ref.store_cfg, want.store, jnp.arange(N)))[:, :T]
    np.testing.assert_allclose(trajs.numpy(), want_trajs, rtol=1e-5, atol=TRAJ_ATOL.get(name, 1e-6))
    if mode is CopyMode.LAZY_SR:
        np.testing.assert_array_equal(got.store.tables.numpy(), np.asarray(want.store.tables))
        np.testing.assert_array_equal(
            got.used_blocks_trace.numpy(), np.asarray(want.used_blocks_trace)
        )
        assert int(got.store.peak_blocks) == int(want.store.peak_blocks)
    if name == "pcfg":
        jstate, tstate = want.state[0], got.state[0]
        scfg = pcfg._stack_cfg(N, mode)
        jscfg = jpcfg._stack_cfg(N, JMode.LAZY_SR)
        np.testing.assert_array_equal(
            stack_cells(tstore.materialize_batch(scfg, tstate.stack, torch.arange(N)), tstate.sp),
            stack_cells(jstore.materialize_batch(jscfg, jstate.stack, jnp.arange(N)), jstate.sp),
        )
        if mode is CopyMode.LAZY_SR:
            assert int(tstore.used_blocks(scfg, tstate.stack)) == int(
                jstore.used_blocks(jscfg, jstate.stack)
            )


# -- the port against itself -------------------------------------------------


def run_port(name, mode, n=N, t=T, seed=0, max_retries=None, data_seed=0):
    mod = PROBLEMS[name]
    ssm, params = tbuild(name, mode)
    obs = mod.gen_data(rnd.generator(data_seed, "cpu"), t)
    retries = (6 if mod.METHOD == "alive" else 0) if max_retries is None else max_retries
    cfg = FilterConfig(n_particles=n, n_steps=t, mode=mode, max_retries=retries)
    pf = ParticleFilter(ssm, cfg, device="cpu")
    return pf, pf.run(rnd.generator(seed, "cpu"), params, obs)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_log_evidence_bit_identical_across_modes(name):
    """The paper's check: one seed, one result, whatever the copy mode
    (CRBD with its alive loop's retries)."""
    runs = {mode: run_port(name, mode) for mode in ALL_MODES}
    eager_pf, eager = runs[CopyMode.EAGER]
    dense = eager.store.dense[:, :T]
    for mode, (pf, res) in runs.items():
        assert float(res.log_evidence) == float(eager.log_evidence), mode
        assert math.isfinite(float(res.log_evidence)) and not bool(res.oom)
        assert torch.equal(res.log_weights, eager.log_weights)
        trajs = tstore.materialize_batch(pf.store_cfg, res.store, torch.arange(N))[:, :T]
        assert torch.equal(trajs, dense), mode


@pytest.mark.parametrize("name", ["rbpf", "mot"])
def test_memory_separation_chain_models(name):
    """Models that keep chain history show the sparse/dense split."""
    peaks = {
        mode: int(run_port(name, mode, t=32)[1].store.peak_blocks)
        for mode in (CopyMode.EAGER, CopyMode.LAZY_SR)
    }
    assert peaks[CopyMode.LAZY_SR] < 0.7 * peaks[CopyMode.EAGER], peaks


def test_simulation_makes_no_copies():
    """The simulation task: no resampling, so every particle owns its
    blocks (the dense count)."""
    ssm, _ = tbuild("rbpf", CopyMode.LAZY_SR)
    obs = PROBLEMS["rbpf"].gen_data(rnd.generator(0, "cpu"), T)
    pf = ParticleFilter(ssm, FilterConfig(n_particles=N, n_steps=T), device="cpu")
    res = pf.simulate(rnd.generator(0, "cpu"), None, obs)
    assert not bool(res.resampled.any())
    assert int(res.store.peak_blocks) == N * -(-T // pf.config.block_size)


def test_pcfg_lookahead_keeps_the_ess():
    """The auxiliary filter's mean ESS is not much worse than the
    bootstrap filter's on the same grammar and data."""
    ssm, params = tbuild("pcfg", CopyMode.LAZY_SR)
    obs = pcfg.gen_data(rnd.generator(0, "cpu"), T)
    cfg = FilterConfig(n_particles=N, n_steps=T)
    apf = ParticleFilter(ssm, cfg, device="cpu").run(rnd.generator(0, "cpu"), params, obs)
    plain = ParticleFilter(ssm._replace(lookahead=None), cfg, device="cpu").run(
        rnd.generator(0, "cpu"), params, obs
    )
    assert float(apf.ess_trace.mean()) >= 0.5 * float(plain.ess_trace.mean())


def test_rbpf_kalman_covariances_stay_psd():
    p = run_port("rbpf", CopyMode.LAZY_SR)[1].state.p.numpy()
    assert np.all(p[:, 0, 0] > 0) and np.all(p[:, 1, 1] > 0)
    assert np.all(p[:, 0, 0] * p[:, 1, 1] - p[:, 0, 1] ** 2 > -1e-4)


def test_pcfg_stack_depths_vary_and_stack_memory_stays_flat():
    """The dynamic structure (random depths), and the latest-state-only
    memory: the stack pool is bounded by N x blocks per stack, not by T."""
    _, res = run_port("pcfg", CopyMode.LAZY_SR, t=32)
    sp = res.state.sp.numpy()
    assert sp.min() >= 0 and sp.max() <= pcfg.MAX_DEPTH and sp.std() > 0
    scfg = pcfg._stack_cfg(N, CopyMode.LAZY_SR)
    assert int(tstore.used_blocks(scfg, res.state.stack)) <= N * scfg.max_blocks


@pytest.mark.parametrize("seed", range(4))
def test_crbd_alive_retries_help(seed):
    """The reference's property on the reference's data (40 branches from
    ``PRNGKey(0)``): retries keep more of the population alive, so the
    smallest ESS and the mean ESS rise.  The minimum is one generation's
    reading, and on the port's own data it can fall while the mean rises
    (``scripts/torch_program_float_checks.py`` counts both over seeds)."""
    ssm, _ = crbd.build()
    obs = numpy_tree(jcrbd.gen_data(KEY, 40))
    outs = {}
    for retries in (0, 8):
        cfg = FilterConfig(n_particles=N, n_steps=40, max_retries=retries)
        outs[retries] = ParticleFilter(ssm, cfg, device="cpu").run(rnd.generator(seed, "cpu"), None, obs)
    assert float(outs[8].ess_trace.min()) >= float(outs[0].ess_trace.min())
    assert float(outs[8].ess_trace.mean()) > float(outs[0].ess_trace.mean())
    assert math.isfinite(float(outs[8].log_evidence))


def test_crbd_extinction_probability_limits():
    assert float(crbd.p_ext(torch.tensor(1e-6))) == pytest.approx(0.0, abs=1e-4)
    assert float(crbd.p_ext(torch.tensor(1e6))) == pytest.approx(crbd.MU / crbd.LAMBDA, abs=1e-3)
    s = np.linspace(0.01, 50.0, 64, dtype=np.float32)
    np.testing.assert_allclose(
        crbd.p_ext(torch.as_tensor(s)).numpy(), np.asarray(jcrbd.p_ext(jnp.asarray(s))), rtol=1e-6
    )


def test_mot_observations_and_object_counts():
    dets, masks = mot.gen_data(rnd.generator(0, "cpu"), 10)
    assert dets.shape == (10, mot.M, 2) and masks.shape == (10, mot.M) and masks.dtype == torch.bool
    exists = run_port("mot", CopyMode.LAZY_SR)[1].state[1]
    counts = exists.sum(1)
    assert counts.min() >= 0 and counts.max() <= mot.K


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_gen_data_shapes_and_device(name):
    """The port's data on its generator's device, shaped as the reference's."""
    got = PROBLEMS[name].gen_data(rnd.generator(3, "cpu"), 12)
    want = JPROBLEMS[name].gen_data(KEY, 12)
    got = list(got) if isinstance(got, tuple) else [got]
    for a, b in zip(jax.tree.leaves(want), got, strict=True):
        assert tuple(b.shape) == a.shape and b.device == CPU
        assert torch.isfinite(b.float()).all()


# -- parameters and constants -------------------------------------------------


def test_pcfg_default_params_equal_the_reference_bit_for_bit():
    want = numpy_tree(jpcfg.default_params())
    got = pcfg.default_params("cpu")
    for field in pcfg.PCFGParams._fields:
        a, b = getattr(want, field), getattr(got, field).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("name", ["pcfg", "vbd"])
def test_default_params_run_on_the_card_unless_asked_for_the_cpu(name):
    """An entry point: the card by default (raising without one), the CPU
    only when the caller asks."""
    mod = PROBLEMS[name]
    assert all(t.device == CPU for t in mod.default_params("cpu"))
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in mod.default_params())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.default_params()


def test_pcfg_rollout_equals_the_reference_gen_data():
    seed = int(jax.random.randint(KEY, (), 0, 2**31 - 1))
    np.testing.assert_array_equal(pcfg.rollout(seed, 200), np.asarray(jpcfg.gen_data(KEY, 200)))


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_program_params_from_numpy_round_trips(name):
    _, jparams = jbuild(name)
    got = convert.program_params_from_numpy(name, numpy_tree(jparams))
    if jparams is None:
        assert got is None
        return
    _, own = tbuild(name, CopyMode.LAZY_SR)
    assert type(got) is type(own)
    for field in own._fields:
        a, b = getattr(got, field), getattr(own, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
        np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jparams, field)))
    bad = numpy_tree(jparams)._replace(**{own._fields[0]: np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError):
        convert.program_params_from_numpy(name, bad)


# -- the observations' containers and the Poisson draw -------------------------


def test_namedtuple_observations_keep_their_type():
    obs = jcrbd.CRBDObs(*(np.arange(3, dtype=np.float32) + i for i in range(3)))
    got = _as_tensors(numpy_tree(obs), CPU)
    assert type(got) is jcrbd.CRBDObs
    assert all(isinstance(x, torch.Tensor) for x in got)
    ssm, _ = crbd.build()
    data = numpy_tree(jcrbd.gen_data(KEY, 8))
    cfg = FilterConfig(n_particles=16, n_steps=8)
    res = ParticleFilter(ssm, cfg, device="cpu").run(rnd.generator(0, "cpu"), None, data)
    assert math.isfinite(float(res.log_evidence))


def test_poisson_draws_shape_dtype_and_device():
    gen = rnd.generator(0, "cpu")
    counts = rnd.poisson(gen, torch.tensor(2.5), (4096,))
    assert counts.shape == (4096,) and counts.dtype == torch.int32 and counts.device == CPU
    assert (counts >= 0).all() and abs(counts.float().mean().item() - 2.5) < 0.15
    rates = rnd.poisson(rnd.generator(1, "cpu"), torch.tensor([0.0, 1e3]), (2,))
    assert rates[0] == 0 and 800 < int(rates[1]) < 1200
    again = rnd.poisson(rnd.generator(0, "cpu"), 2.5, (4096,))
    assert torch.equal(counts, again)


def test_replay_hands_back_recorded_poisson_counts_in_order():
    recorded = np.array([3, 0, 7], np.int32)
    replay = rnd.Replay([("poisson", recorded), ("uniform", np.zeros(3, np.float32))])
    with pytest.raises(ValueError):
        replay.uniform((3,))  # a poisson draw is next
    got = replay.poisson(0.5, (3,))
    assert got.dtype == torch.int32 and got.tolist() == [3, 0, 7]
    with pytest.raises(ValueError):
        replay.poisson(0.5, (3,))  # a uniform draw is next
    replay.uniform((3,))
    assert replay.remaining == 0


@settings(derandomize=True, database=None, max_examples=20, deadline=None)
@given(shape=st.lists(st.integers(1, 5), min_size=0, max_size=3), rate=st.floats(0.0, 20.0))
def test_poisson_replay_shapes_match_draw_shapes(shape, rate):
    drawn = rnd.poisson(rnd.generator(0, "cpu"), rate, shape)
    replay = rnd.Replay([("poisson", drawn.numpy())])
    assert torch.equal(replay.poisson(rate, shape), drawn)
    with pytest.raises(ValueError):
        rnd.Replay([("poisson", drawn.numpy())]).poisson(rate, (*shape, 2))
