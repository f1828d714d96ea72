"""The port's particle Gibbs on VBD, against the JAX reference on replayed
draws, and against itself across copy modes and pool lifecycles.

The reference's ``ParticleGibbs.run`` splits its key three ways per
iteration (``key, k_run, k_pick = split(key, 3)``): the conditional
sweep walks ``k_run`` as the filter does, and the retained particle is
``jax.random.categorical(k_pick, log_weights)``, whose Gumbel noise comes
from uniforms on ``[tiny, 1)``.  The test records those draws in that
order and replays them into the port (N = 64, a power of two, for the
comb's division; ROADMAP.md queue 3).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.config import CopyMode as JMode  # noqa: E402
from repro.smc import filters as jfilters  # noqa: E402
from repro.smc.pgibbs import ParticleGibbs as JParticleGibbs  # noqa: E402
from repro.smc.programs import vbd as jvbd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.core.config import ALL_MODES, CopyMode  # noqa: E402
from repro_torch.smc import ParticleGibbs, PGResult  # noqa: E402
from repro_torch.smc.filters import FilterConfig  # noqa: E402
from repro_torch.smc.programs import rbpf, vbd  # noqa: E402

N, T, ITERS = 64, 24, 3
KEY = jax.random.PRNGKey(0)
TINY = float(np.finfo(np.float32).tiny)


def sweep_draws(key, n, t_steps):
    """One conditional sweep's draws: VBD draws nothing at init and five
    normals per generation; every generation after the first resamples."""
    key, _ = jax.random.split(key)
    draws = []
    for t in range(t_steps):
        key, k_res, k_prop, _ = jax.random.split(key, 4)
        if t:
            draws.append(("uniform", jax.random.uniform(k_res, ())))
        ks = jax.random.split(k_prop, 6)
        draws += [("normal", jax.random.normal(ks[i], (n,))) for i in range(5)]
    return draws


def pg_draws(key, n, t_steps, n_iters):
    draws = []
    for _ in range(n_iters):
        key, k_run, k_pick = jax.random.split(key, 3)
        draws += sweep_draws(k_run, n, t_steps)
        draws.append(("uniform", jax.random.uniform(k_pick, (n,), minval=TINY, maxval=1.0)))
    return [(kind, np.asarray(a)) for kind, a in draws]


@pytest.fixture(scope="module")
def reference():
    ssm, params = jvbd.build()
    obs = np.array(jvbd.gen_data(KEY, T))
    cfg = jfilters.FilterConfig(n_particles=N, n_steps=T, mode=JMode.LAZY_SR)
    out = JParticleGibbs(ssm, cfg).run(KEY, params, obs, n_iters=ITERS)
    return obs, jax.tree.map(np.array, params), out


@pytest.mark.parametrize("mode", ALL_MODES, ids=str)
def test_replayed_particle_gibbs_matches_reference(reference, mode):
    obs, jparams, want = reference
    replay = rnd.Replay(pg_draws(KEY, N, T, ITERS))
    ssm, _ = vbd.build()
    params = convert.program_params_from_numpy("vbd", jparams)
    pg = ParticleGibbs(ssm, FilterConfig(n_particles=N, n_steps=T, mode=mode), device="cpu")
    got = pg.run(replay, params, obs, n_iters=ITERS)
    assert replay.remaining == 0 and not bool(got.oom) and int(got.grew) == 0
    np.testing.assert_allclose(got.log_evidences.numpy(), np.asarray(want.log_evidences), rtol=1e-5)
    # the same particle retained, its trajectory to the tolerance of the
    # frameworks' float32 drift
    np.testing.assert_allclose(got.reference.numpy(), np.asarray(want.reference), rtol=1e-5, atol=1e-6)
    if mode is CopyMode.LAZY_SR:
        assert int(got.peak_blocks) == int(want.peak_blocks)
        np.testing.assert_array_equal(got.used_blocks_trace.numpy(), np.asarray(want.used_blocks_trace))


def run_pg(mode=CopyMode.LAZY_SR, n=N, t=T, seed=0, **kw):
    ssm, params = vbd.build()
    obs = vbd.gen_data(rnd.generator(7, "cpu"), t)
    cfg = FilterConfig(n_particles=n, n_steps=t, mode=mode, **kw)
    return ParticleGibbs(ssm, cfg, device="cpu").run(rnd.generator(seed, "cpu"), params, obs, n_iters=ITERS)


def test_particle_gibbs_bit_identical_across_modes_and_physical():
    outs = {mode: run_pg(mode) for mode in ALL_MODES}
    eager = outs[CopyMode.EAGER]
    assert eager.log_evidences.shape == (ITERS,) and eager.reference.shape == (T, 7)
    assert torch.isfinite(eager.log_evidences).all()
    assert (eager.reference >= -1e-3).all()  # populations stay physical
    for mode, out in outs.items():
        assert torch.equal(out.log_evidences, eager.log_evidences), mode
        assert torch.equal(out.reference, eager.reference), mode
        assert not bool(out.oom)
    # the lazy sweeps share their prefixes: fewer blocks than the dense count
    assert int(outs[CopyMode.LAZY_SR].peak_blocks) < int(eager.peak_blocks)


class TestLifecycle:
    """tests/test_pgibbs_lifecycle.py's scenario on VBD in the port."""

    n, t, small = 32, 32, 40

    def run(self, **kw):
        return run_pg(n=self.n, t=self.t, block_size=2, **kw)

    def test_grow_from_tiny_matches_oversized_pool_bit_exact(self):
        ref = self.run()
        out = self.run(pool_blocks=self.small, grow=True, grow_chunk=4)
        assert not bool(ref.oom) and int(ref.grew) == 0
        assert not bool(out.oom) and int(out.grew) >= 1
        assert torch.equal(out.reference, ref.reference)
        assert torch.equal(out.log_evidences, ref.log_evidences)
        assert int(out.peak_blocks) == int(ref.peak_blocks)
        assert torch.equal(out.used_blocks_trace, ref.used_blocks_trace)

    def test_overflow_without_growth_surfaces_oom(self):
        assert bool(self.run(pool_blocks=self.small).oom)


def test_requires_set_reference_and_refuses_a_mesh():
    ssm, _ = vbd.build()
    with pytest.raises(ValueError):
        ParticleGibbs(ssm._replace(set_reference=None), FilterConfig(n_particles=4, n_steps=4), device="cpu")
    with pytest.raises(TypeError, match="ShardMesh"):
        ParticleGibbs(ssm, FilterConfig(n_particles=4, n_steps=4, mesh=object()), device="cpu")


def test_rbpf_particle_gibbs_pins_its_reference():
    """A model whose state is a NamedTuple: the reference record is pushed
    back into (xi, m, P) and kept by particle 0 through the sweep."""
    ssm, _ = rbpf.build()
    obs = rbpf.gen_data(rnd.generator(1, "cpu"), 12)
    pg = ParticleGibbs(ssm, FilterConfig(n_particles=16, n_steps=12), device="cpu")
    out = pg.run(rnd.generator(2, "cpu"), None, obs, n_iters=2)
    assert isinstance(out, PGResult) and math.isfinite(float(out.log_evidences[-1]))
    p = out.reference[:, 3:]
    assert (p[:, 0] > 0).all() and (p[:, 2] > 0).all()  # P00, P11 of a covariance
