"""The port's sharded store (``repro_torch.distributed``) and its three
callers against the JAX reference, and against the port itself.

* **Against the reference, bit for bit.**  One subprocess fakes four host
  devices (``--xla_force_host_platform_device_count=4``, as
  ``tests/test_sharded_store.py`` does), runs the reference's stacked store
  ops and its 4-shard filter, and dumps their leaves to an ``.npz``; the
  port runs the same ops on an in-process mesh on the CPU.  The store
  program (N = 8, block 2, 4 blocks a particle; S = 2 and 4; all three
  modes): appends, a clone whose ancestors all cross shards, a
  within-shard pair clone, ``write_at``, ``grow``, ``compact``; after each
  op every leaf of ``sharded_store.stacked``, the trajectories and the
  per-shard used and peak blocks equal the reference's.  One export slot
  a shard overflows and sets ``oom`` in both.  The 4-shard filter
  (N = 64, T = 16) replays the reference's draws (the shared resampling
  uniforms and each shard's folded-key normals): ancestors, tables and
  lengths equal, ``log_evidence`` to rtol 1e-5.  The same process runs
  the pool's ``alloc_scan``, ``read_blocks``, ``blocks_free`` and the
  store's ``import_trajectories`` on the inputs the port's tests use.
* **Against the port.**  One shard is bit-exact with the single-device
  filter, particle Gibbs sweep and decoder; four shards are
  bit-identical across the modes, and LAZY_SR's summed per-shard blocks
  stay below 0.6 × EAGER's (the reference's gate); lockstep growth is
  bit-exact with an oversized pool; the token trace's import-skew case
  grows once before the clone and keeps the histories; a two-shard
  ``SMCDecoder`` equals the unsharded one on the same engine; a 2-rank
  gloo process group (two processes, a ``file://`` store) equals the
  in-process 2-shard run bit for bit.
* **The card's repairs.**  ``ssd_scan``'s padded tail (``dt = 0``) leaves
  the plain scan's outputs and final state as they were at S = 1, 20 and
  40 (to 1e-5: sums over another chunk length); the ``cuda`` tests run
  the smoke SSM models at those prompt lengths on the card against the
  CPU at ``crosscheck.SSD_TOL``, and bf16 flash attention at head dims 16
  and 32 through ``check_flash``.

jax is imported only by the reference's subprocess (and, to read the
reference's own sizing, one test), so the ``cuda`` tests run on a host
without it.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import random as rnd  # noqa: E402
from repro_torch.core import pool as tpool  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.core.config import ALL_MODES, CopyMode  # noqa: E402
from repro_torch.distributed import ShardMesh, ShardStreams  # noqa: E402
from repro_torch.distributed import sharded_store as tss  # noqa: E402
from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef  # noqa: E402
from repro_torch.smc.pgibbs import ParticleGibbs  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
A, Q, R = 0.9, 0.5, 0.3
N_F, T_F = 64, 16  # the filter held against the reference

REFERENCE_SCRIPT = textwrap.dedent(
    """
    import math
    import os
    import sys

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.core.config import ALL_MODES, CopyMode
    from repro.core.store import StoreConfig
    from repro.distributed import sharded_store as ss
    from repro.smc.filters import FilterConfig, ParticleFilter, SSMDef

    A, Q, R = 0.9, 0.5, 0.3
    N_F, T_F = 64, 16
    out = {}

    def vals(t):
        return jnp.arange(8, dtype=jnp.float32) * 10 + t

    def program(S):
        yield "append0", lambda c, m, st: ss.append(c, m, st, vals(0))
        yield "append1", lambda c, m, st: ss.append(c, m, st, vals(1))
        yield "append2", lambda c, m, st: ss.append(c, m, st, vals(2))
        yield "cross", lambda c, m, st: ss.clone(c, m, st, jnp.array([7, 6, 5, 4, 3, 2, 1, 0], jnp.int32))
        yield "append3", lambda c, m, st: ss.append(c, m, st, vals(3))
        yield "pairs", lambda c, m, st: ss.clone(c, m, st, jnp.array([0, 0, 2, 2, 4, 4, 6, 6], jnp.int32))
        yield "write_at", lambda c, m, st: ss.write_at(
            c, m, st, jnp.array([0, 1, 2, 3, 3, 2, 1, 0], jnp.int32), -vals(0))
        yield "grow", lambda c, m, st: ss.grow(c, m, st, ss.local_num_blocks(st, S) + 3)
        yield "append4", lambda c, m, st: ss.append(c, m, st, vals(4))
        yield "compact", lambda c, m, st: ss.compact(c, m, st)
        yield "append5", lambda c, m, st: ss.append(c, m, st, vals(5))

    for S in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:S]), ("shards",))
        for mode in ALL_MODES:
            base = StoreConfig(mode=mode, n=8, block_size=2, max_blocks=4, item_shape=(), dtype="float32")
            cfg = ss.ShardedStoreConfig(base=base, num_shards=S)
            st = ss.create(cfg, mesh)
            for name, op in program(S):
                st = op(cfg, mesh, st)
                tag = f"store/{S}/{mode.value}/{name}"
                for i, leaf in enumerate(jax.tree.leaves(st)):
                    out[f"{tag}/leaf{i}"] = np.asarray(leaf)
                out[f"{tag}/traj"] = np.asarray(ss.trajectories(cfg, mesh, st))
                out[f"{tag}/used"] = np.asarray(ss.used_blocks_per_shard(cfg, st))
                out[f"{tag}/peak"] = np.asarray(ss.peak_blocks_per_shard(cfg, st))

    mesh = Mesh(np.array(jax.devices()), ("shards",))
    for mode in ALL_MODES:
        base = StoreConfig(mode=mode, n=8, block_size=2, max_blocks=4, item_shape=(), dtype="float32")
        cfg = ss.ShardedStoreConfig(base=base, num_shards=4, max_exports=1)
        st = ss.create(cfg, mesh)
        st = ss.append(cfg, mesh, st, vals(0))
        st = ss.clone(cfg, mesh, st, jnp.array([2, 3, 4, 5, 6, 7, 0, 1], jnp.int32))
        out[f"overflow/{mode.value}/oom"] = np.asarray(st.pool.oom)

    def lgssm():
        def init(key, n, params):
            return jax.random.normal(key, (n,)), jnp.zeros((n, T_F), jnp.int32), jnp.zeros((n,), jnp.int32)

        def step(key, state, t, y, params):
            x, hist, k = state
            x = A * x + math.sqrt(Q) * jax.random.normal(key, x.shape)
            return (x, hist, k), -0.5 * ((y - x) ** 2 / R + math.log(2 * math.pi * R)), x[:, None]

        def clone_state(state, anc):
            x, hist, k = state
            return x[anc], hist[anc].at[:, k[0]].set(anc), k[anc] + 1

        return SSMDef(init=init, step=step, record_shape=(1,), clone_state=clone_state)

    key = jax.random.PRNGKey(7)
    ys = np.asarray(jax.random.normal(jax.random.PRNGKey(8), (T_F,)))
    nl = N_F // 4
    cfg = FilterConfig(n_particles=N_F, n_steps=T_F, mode=CopyMode.LAZY_SR, block_size=2, mesh=mesh)
    pf = ParticleFilter(lgssm(), cfg)
    res = pf.jitted()(key, None, ys)
    # The draws of the sharded scan: init and propagation on keys folded
    # with the shard index, the resampling uniform on the shared key.
    k, init_key = jax.random.split(key)
    out["filter/init"] = np.stack(
        [np.asarray(jax.random.normal(jax.random.fold_in(init_key, s), (nl,))) for s in range(4)])
    uniforms, normals = [], []
    for t in range(T_F):
        k, k_res, k_prop, _ = jax.random.split(k, 4)
        uniforms.append(np.asarray(jax.random.uniform(k_res)))
        normals.append([np.asarray(jax.random.normal(jax.random.fold_in(k_prop, s), (nl,))) for s in range(4)])
    out["filter/uniforms"] = np.stack(uniforms)
    out["filter/normals"] = np.asarray(normals)
    out["filter/ys"] = ys
    out["filter/hist"] = np.asarray(res.state[1])
    out["filter/tables"] = np.asarray(res.store.tables)
    out["filter/lengths"] = np.asarray(res.store.lengths)
    out["filter/traj"] = np.asarray(ss.trajectories(pf.sharded_cfg, mesh, res.store))
    out["filter/log_evidence"] = np.asarray(res.log_evidence)
    out["filter/used"] = np.asarray(ss.used_blocks_per_shard(pf.sharded_cfg, res.store))
    out["filter/oom"] = np.asarray(res.oom)
    np.savez(sys.argv[1], **out)
    print("REFERENCE_OK")
    """
)


POOL_SCRIPT = textwrap.dedent(
    """
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core import pool as jpool
    from repro.core import store as jstore
    from repro.core.config import ALL_MODES

    out = {}
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        pool = jpool.init(12, (2,), jnp.float32)
        for _ in range(3):
            pool, ids = jpool.alloc(pool, 5, commit=jnp.asarray(rng.random(5) < 0.8))
            pool = jpool.sub_refs(pool, jnp.where(jnp.asarray(rng.random(5) < 0.4), ids, -1))
        pool = pool._replace(data=jnp.asarray(POOL_DATA(rng)))
        tag = f"pool/{seed}"
        for f in jpool.BlockPool._fields:
            out[f"{tag}/churned/{f}"] = np.asarray(getattr(pool, f))
        out[f"{tag}/blocks_free"] = np.asarray(jpool.blocks_free(pool))
        out[f"{tag}/read_blocks"] = np.asarray(jpool.read_blocks(pool, jnp.asarray(READ_IDS)))
        for case, (n, commit) in enumerate(ALLOC_CASES):
            q, ids = jpool.alloc_scan(pool, n, commit=None if commit is None else jnp.asarray(commit))
            out[f"{tag}/alloc_scan{case}/ids"] = np.asarray(ids)
            for f in jpool.BlockPool._fields:
                out[f"{tag}/alloc_scan{case}/{f}"] = np.asarray(getattr(q, f))

    for mode in ALL_MODES:
        cfg = jstore.StoreConfig(mode=mode, n=6, block_size=2, max_blocks=3, item_shape=(), dtype="float32")
        st = jstore.create(cfg)
        for t in range(4):
            st = jstore.append(cfg, st, jnp.arange(6, dtype=jnp.float32) + 10 * t)
        st = jstore.clone_partial(cfg, st, jnp.asarray(IMPORT_ANC), jnp.asarray(IMPORT_VALID))
        st = jstore.import_trajectories(cfg, st, jnp.asarray(IMPORT_TRAJS), jnp.asarray(IMPORT_LENGTHS),
                                        jnp.asarray(~IMPORT_VALID))
        for i, leaf in enumerate(jax.tree.leaves(st)):
            out[f"import/{mode.value}/leaf{i}"] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
    print("REFERENCE_OK")
    """
)


# Inputs of the pool and import checks, shared with the reference's script.
SHARED_INPUTS = textwrap.dedent(
    """
    import numpy as np

    def POOL_DATA(rng):
        data = rng.standard_normal((13, 2)).astype(np.float32)
        data[12] = 0
        return data

    READ_IDS = np.array([[3, -1, 0], [11, 5, 5]], np.int32)
    ALLOC_CASES = ((4, None), (7, np.array([1, 0, 1, 1, 0, 1, 1], bool)), (20, None))
    IMPORT_ANC = np.array([0, 0, 1, 2, 5, 5], np.int32)
    IMPORT_VALID = np.array([1, 0, 1, 0, 1, 0], bool)
    IMPORT_TRAJS = np.random.default_rng(1).standard_normal((6, 6)).astype(np.float32)
    IMPORT_LENGTHS = np.array([0, 3, 0, 5, 0, 0], np.int32)
    """
)
exec(SHARED_INPUTS)


def subprocess_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep * bool(env.get("PYTHONPATH")) + env.get("PYTHONPATH", "")
    env.setdefault("JAX_PLATFORMS", "cpu")
    return env


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's leaves and draws: the store program and the filter
    from one faked 4-device process, the pool and import checks from a
    one-device process beside it."""
    pytest.importorskip("jax")
    where = tmp_path_factory.mktemp("sharded_reference")
    procs = []
    for name, text in (("sharded", REFERENCE_SCRIPT), ("pool", POOL_SCRIPT)):
        script = where / f"{name}.py"
        script.write_text(SHARED_INPUTS + text)
        procs.append((where / f"{name}.npz", subprocess.Popen(
            [sys.executable, str(script), str(where / f"{name}.npz")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=subprocess_env())))
    out = {}
    for dump, proc in procs:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        assert proc.returncode == 0 and "REFERENCE_OK" in stdout, stdout + stderr
        with np.load(dump) as f:
            out.update(f)
    return out


# ---------------------------------------------------------------------------
# the store program
# ---------------------------------------------------------------------------


def vals(t):
    return torch.arange(8, dtype=torch.float32) * 10 + t


def store_program(S):
    """The reference script's store program, op for op."""
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32)  # noqa: E731
    yield "append0", lambda c, m, st: tss.append(c, m, st, vals(0))
    yield "append1", lambda c, m, st: tss.append(c, m, st, vals(1))
    yield "append2", lambda c, m, st: tss.append(c, m, st, vals(2))
    yield "cross", lambda c, m, st: tss.clone(c, m, st, i32([7, 6, 5, 4, 3, 2, 1, 0]))
    yield "append3", lambda c, m, st: tss.append(c, m, st, vals(3))
    yield "pairs", lambda c, m, st: tss.clone(c, m, st, i32([0, 0, 2, 2, 4, 4, 6, 6]))
    yield "write_at", lambda c, m, st: tss.write_at(c, m, st, i32([0, 1, 2, 3, 3, 2, 1, 0]), -vals(0))
    yield "grow", lambda c, m, st: tss.grow(c, m, st, tss.local_num_blocks(st) + 3)
    yield "append4", lambda c, m, st: tss.append(c, m, st, vals(4))
    yield "compact", lambda c, m, st: tss.compact(c, m, st)
    yield "append5", lambda c, m, st: tss.append(c, m, st, vals(5))


def store_config(mode, S, max_exports=0):
    base = tstore.StoreConfig(mode=mode, n=8, block_size=2, max_blocks=4)
    return tss.ShardedStoreConfig(base=base, num_shards=S, max_exports=max_exports)


def view_leaves(mesh, store):
    """The stacked view's leaves in the reference's tree order."""
    v = tss.stacked(mesh, store)
    return [*v.pool, v.dense, v.tables, v.lengths, v.peak_blocks]


def run_store_program(mesh, mode):
    """Each op's (name, stacked leaves, trajectories, used, peak)."""
    cfg = store_config(mode, mesh.num_shards)
    st = tss.create(cfg, mesh)
    out = []
    for name, op in store_program(mesh.num_shards):
        st = op(cfg, mesh, st)
        out.append((name, view_leaves(mesh, st), tss.trajectories(cfg, mesh, st),
                    tss.used_blocks_per_shard(cfg, mesh, st), tss.peak_blocks_per_shard(cfg, mesh, st)))
    return out


def assert_same(got: torch.Tensor, want: np.ndarray, what: str):
    got = got.cpu().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("mode", ALL_MODES, ids=lambda m: m.value)
@pytest.mark.parametrize("S", [2, 4])
def test_store_program_equals_reference_leaf_by_leaf(reference, S, mode):
    for name, leaves, traj, used, peak in run_store_program(ShardMesh.in_process(S, "cpu"), mode):
        tag = f"store/{S}/{mode.value}/{name}"
        for i, leaf in enumerate(leaves):
            assert_same(leaf, reference[f"{tag}/leaf{i}"], f"{tag} leaf {i}")
        assert_same(traj, reference[f"{tag}/traj"], f"{tag} trajectories")
        assert_same(used, reference[f"{tag}/used"], f"{tag} used blocks")
        assert_same(peak, reference[f"{tag}/peak"], f"{tag} peak blocks")


@pytest.mark.parametrize("mode", ALL_MODES, ids=lambda m: m.value)
def test_export_overflow_sets_oom_as_the_reference(reference, mode):
    """One export slot a shard, two demanded: both packages stick oom on
    every shard that could not export."""
    mesh = ShardMesh.in_process(4, "cpu")
    cfg = store_config(mode, 4, max_exports=1)
    st = tss.append(cfg, mesh, tss.create(cfg, mesh), vals(0))
    st = tss.clone(cfg, mesh, st, torch.tensor([2, 3, 4, 5, 6, 7, 0, 1], dtype=torch.int32))
    assert_same(tss.stacked(mesh, st).pool.oom, reference[f"overflow/{mode.value}/oom"], "oom")
    assert bool(tss.oom_flag(cfg, mesh, st))


def test_within_shard_clone_adds_no_blocks():
    """Within-shard ancestry stays lazy: cloning pairs inside every shard
    allocates nothing (the reference's multi-shard test, 1b)."""
    mesh = ShardMesh.in_process(4, "cpu")
    cfg = store_config(CopyMode.LAZY_SR, 4)
    st = tss.create(cfg, mesh)
    for _ in range(2):
        st = tss.append(cfg, mesh, st, vals(0))
    before = tss.used_blocks_per_shard(cfg, mesh, st)
    st = tss.clone(cfg, mesh, st, torch.tensor([0, 0, 2, 2, 4, 4, 6, 6], dtype=torch.int32))
    assert bool((tss.used_blocks_per_shard(cfg, mesh, st) <= before).all())


def test_local_config_sizes_as_the_reference():
    """``ShardedStoreConfig.local``: the single-device auto size at S = 1,
    the padded per-shard size above, a split fixed size."""
    pytest.importorskip("jax")
    from repro.core.config import CopyMode as JMode
    from repro.core.store import StoreConfig as JStoreConfig
    from repro.distributed.sharded_store import ShardedStoreConfig as JShardedStoreConfig

    for n, S, blocks in ((64, 1, 0), (64, 4, 0), (65_536, 4, 0), (256, 4, 1000), (48, 2, 0)):
        port = tss.ShardedStoreConfig(tstore.StoreConfig(CopyMode.LAZY, n, 4, 64, num_blocks=blocks), S)
        ref = JShardedStoreConfig(JStoreConfig(JMode.LAZY, n, 4, 64, num_blocks=blocks), S)
        assert (port.local.n, port.local.num_blocks, port.local.pool_blocks, port.n_local, port.exports) == (
            ref.local.n, ref.local.num_blocks, ref.local.pool_blocks, ref.n_local, ref.exports)


def test_export_slots_are_nonzero_padded():
    """The export list is ``nonzero(size=k, fill_value=-1)`` with no host
    sync, whatever the demand (derandomized masks, k below and above it)."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(1, 40))
        mask = rng.random(n) < rng.random()
        k = int(rng.integers(1, n + 3))
        want = np.full(k, -1, np.int32)
        hits = np.nonzero(mask)[0][:k]
        want[: hits.size] = hits
        np.testing.assert_array_equal(tss._export_slots(torch.as_tensor(mask), k).numpy(), want)


# ---------------------------------------------------------------------------
# the pool and store functions the exchange uses
# ---------------------------------------------------------------------------


def churned_pool(seed):
    """The reference script's pool after its allocations and frees."""
    rng = np.random.default_rng(seed)
    pool = tpool.init(12, (2,), torch.float32, device="cpu")
    for _ in range(3):
        pool, ids = tpool.alloc(pool, 5, commit=torch.as_tensor(rng.random(5) < 0.8))
        pool = tpool.sub_refs(pool, torch.where(torch.as_tensor(rng.random(5) < 0.4), ids, -1))
    return pool._replace(data=torch.as_tensor(POOL_DATA(rng)))


def assert_pool(pool, reference, tag):
    for f in tpool.BlockPool._fields:
        assert_same(getattr(pool, f), reference[f"{tag}/{f}"], f"{tag}: {f}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alloc_scan_read_blocks_blocks_free_match_reference(reference, seed):
    tag = f"pool/{seed}"
    pool = churned_pool(seed)
    assert_pool(pool, reference, f"{tag}/churned")
    assert_same(tpool.blocks_free(pool), reference[f"{tag}/blocks_free"], "blocks_free")
    assert_same(tpool.read_blocks(pool, torch.as_tensor(READ_IDS)), reference[f"{tag}/read_blocks"], "read_blocks")
    for case, (n, commit) in enumerate(ALLOC_CASES):
        q, ids = tpool.alloc_scan(pool, n, commit=None if commit is None else torch.as_tensor(commit))
        assert_same(ids, reference[f"{tag}/alloc_scan{case}/ids"], f"alloc_scan({n}) ids")
        assert_pool(q, reference, f"{tag}/alloc_scan{case}")
        assert tpool.check_invariants(q) == []


@pytest.mark.parametrize("mode", ALL_MODES, ids=lambda m: m.value)
def test_import_trajectories_matches_reference(reference, mode):
    """A clone_partial that leaves three slots empty, then their imports
    of dense trajectories of lengths 0, 3 and 5: every leaf equal."""
    cfg = tstore.StoreConfig(mode=mode, n=6, block_size=2, max_blocks=3)
    st = tstore.create(cfg, "cpu")
    for t in range(4):
        st = tstore.append(cfg, st, torch.arange(6, dtype=torch.float32) + 10 * t)
    st = tstore.clone_partial(cfg, st, torch.as_tensor(IMPORT_ANC), torch.as_tensor(IMPORT_VALID))
    st = tstore.import_trajectories(cfg, st, torch.as_tensor(IMPORT_TRAJS), torch.as_tensor(IMPORT_LENGTHS),
                                    torch.as_tensor(~IMPORT_VALID))
    for i, leaf in enumerate([*st.pool, st.dense, st.tables, st.lengths, st.peak_blocks]):
        assert_same(leaf, reference[f"import/{mode.value}/leaf{i}"], f"leaf {i}")


# ---------------------------------------------------------------------------
# the filter
# ---------------------------------------------------------------------------


def weight(y, x):
    return -0.5 * ((y - x) ** 2 / R + math.log(2 * math.pi * R))


def lgssm(t_steps=T_F) -> SSMDef:
    """The LGSSM with a state that records each resampling's ancestors
    (``hist[:, k]``; every leaf leads with the particle axis, as a sharded
    state must)."""

    def init(gen, n, params):
        x = rnd.normal(gen, (n,))
        return x, torch.zeros((n, t_steps), dtype=torch.int32, device=x.device), torch.zeros(
            n, dtype=torch.int32, device=x.device)

    def step(gen, state, t, y, params):
        x, hist, k = state
        x = A * x + math.sqrt(Q) * rnd.normal(gen, x.shape)
        return (x, hist, k), weight(y, x), x[:, None]

    def clone_state(state, anc):
        x, hist, k = state
        a = anc.long()
        hist = hist[a]
        hist[:, k[0]] = anc
        return x[a], hist, k[a] + 1

    def set_reference(state, ref_t):
        x, hist, k = state
        x = x.clone()
        x[0] = ref_t[0]
        return x, hist, k

    return SSMDef(init=init, step=step, record_shape=(1,), clone_state=clone_state, set_reference=set_reference)


def run_filter(mode, mesh=None, gen=None, n=N_F, t_steps=T_F, ys=None, **kw):
    cfg = FilterConfig(n_particles=n, n_steps=t_steps, mode=mode, block_size=2, mesh=mesh, **kw)
    pf = ParticleFilter(lgssm(t_steps), cfg, device=None if mesh is not None else "cpu")
    if ys is None:
        ys = np.random.default_rng(3).standard_normal(t_steps).astype(np.float32)
    return pf, pf.run(rnd.generator(11, "cpu") if gen is None else gen, None, ys)


@pytest.mark.parametrize("mode", ALL_MODES, ids=lambda m: m.value)
def test_one_shard_is_bit_exact_with_the_single_device_filter(mode):
    pf0, r0 = run_filter(mode)
    mesh = ShardMesh.in_process(1, "cpu")
    pf1, r1 = run_filter(mode, mesh)
    assert r0.log_evidence.view(torch.int32).item() == r1.log_evidence.view(torch.int32).item()
    for f in ("log_weights", "ess_trace", "resampled", "used_blocks_trace", "oom", "grew"):
        assert torch.equal(getattr(r0, f), getattr(r1, f)), f
    for a, b in zip(r0.state, r1.state, strict=True):
        assert torch.equal(a, b)  # ancestors in hist
    v = tss.stacked(mesh, r1.store)
    for a, b in zip([*r0.store.pool, r0.store.dense, r0.store.tables, r0.store.lengths, r0.store.peak_blocks],
                    [*v.pool, v.dense, v.tables, v.lengths, v.peak_blocks], strict=True):
        assert torch.equal(a.reshape(b.shape), b)
    ids = torch.arange(N_F, dtype=torch.int32)
    assert torch.equal(tstore.materialize_batch(pf0.store_cfg, r0.store, ids),
                       tss.trajectories(pf1.sharded_cfg, mesh, r1.store))


def replayed_streams(reference):
    uniforms, normals, init = reference["filter/uniforms"], reference["filter/normals"], reference["filter/init"]
    shared = rnd.Replay([("uniform", uniforms[t]) for t in range(1, T_F)])
    shards = [rnd.Replay([("normal", init[s])] + [("normal", normals[t][s]) for t in range(T_F)])
              for s in range(4)]
    return ShardStreams(shared, shards)


def test_four_shards_equal_the_reference_on_replayed_draws(reference):
    mesh = ShardMesh.in_process(4, "cpu")
    streams = replayed_streams(reference)
    pf, res = run_filter(CopyMode.LAZY_SR, mesh, gen=streams, ys=reference["filter/ys"])
    assert streams.shared.remaining == 0 and all(g.remaining == 0 for g in streams.shards)
    v = tss.stacked(mesh, res.store)
    assert_same(res.state[1], reference["filter/hist"], "ancestors")
    assert_same(v.tables, reference["filter/tables"], "tables")
    assert_same(v.lengths, reference["filter/lengths"], "lengths")
    assert_same(tss.used_blocks_per_shard(pf.sharded_cfg, mesh, res.store), reference["filter/used"], "used")
    np.testing.assert_allclose(tss.trajectories(pf.sharded_cfg, mesh, res.store).numpy(), reference["filter/traj"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.log_evidence.item(), reference["filter/log_evidence"], rtol=1e-5)
    assert not bool(res.oom) and not bool(reference["filter/oom"])


@pytest.fixture(scope="module")
def four_shard_runs():
    """The reference's multi-shard gate at its size: N = 256, T = 32,
    block 2, four shards, each mode from one seed."""
    mesh = ShardMesh.in_process(4, "cpu")
    ys = np.random.default_rng(0).standard_normal(32).astype(np.float32)
    return mesh, {m: run_filter(m, mesh, n=256, t_steps=32, ys=ys) for m in ALL_MODES}


def test_four_shards_bit_identical_across_modes(four_shard_runs):
    mesh, runs = four_shard_runs
    bits = {m: r.log_evidence.view(torch.int32).item() for m, (_, r) in runs.items()}
    assert len(set(bits.values())) == 1, bits
    (pf_e, eager), (pf_s, sr) = runs[CopyMode.EAGER], runs[CopyMode.LAZY_SR]
    assert torch.equal(tss.trajectories(pf_e.sharded_cfg, mesh, eager.store),
                       tss.trajectories(pf_s.sharded_cfg, mesh, sr.store))
    for m, (_, r) in runs.items():
        assert not bool(r.oom), m
        assert torch.equal(r.state[1], eager.state[1]) and torch.equal(r.ess_trace, eager.ess_trace)


def test_lazy_sr_occupancy_below_eager(four_shard_runs):
    mesh, runs = four_shard_runs
    used = {m: tss.used_blocks_per_shard(pf.sharded_cfg, mesh, r.store) for m, (pf, r) in runs.items()}
    assert int(used[CopyMode.LAZY_SR].sum()) < 0.6 * int(used[CopyMode.EAGER].sum()), used


@pytest.mark.parametrize("mode", [CopyMode.LAZY, CopyMode.LAZY_SR], ids=lambda m: m.value)
def test_lockstep_growth_is_bit_exact_with_an_oversized_pool(mode):
    mesh = ShardMesh.in_process(4, "cpu")
    pf_g, grown = run_filter(mode, mesh, pool_blocks=32, grow=True, grow_chunk=4)
    pf_b, big = run_filter(mode, mesh)
    assert int(grown.grew) > 0 and not bool(grown.oom)
    assert grown.log_evidence.view(torch.int32).item() == big.log_evidence.view(torch.int32).item()
    assert torch.equal(tss.trajectories(pf_g.sharded_cfg, mesh, grown.store),
                       tss.trajectories(pf_b.sharded_cfg, mesh, big.store))
    nb = tss.stacked(mesh, grown.store).pool.refcount.shape[0] // 4
    assert all(st.pool.num_blocks == nb for st in grown.store.shards)


def test_adaptive_resampling_on_the_gathered_ess():
    """Adaptive resampling reads the gathered weights' ESS: one shard
    equals the single-device run, and four shards resample on the same
    generations in every mode."""
    _, r0 = run_filter(CopyMode.LAZY_SR, always_resample=False)
    _, r1 = run_filter(CopyMode.LAZY_SR, ShardMesh.in_process(1, "cpu"), always_resample=False)
    assert torch.equal(r0.resampled, r1.resampled) and torch.equal(r0.log_evidence, r1.log_evidence)
    assert 0 < int(r0.resampled.sum()) < T_F
    mesh = ShardMesh.in_process(4, "cpu")
    runs = [run_filter(m, mesh, always_resample=False)[1] for m in ALL_MODES]
    assert all(torch.equal(r.resampled, runs[0].resampled) for r in runs)
    assert len({r.log_evidence.view(torch.int32).item() for r in runs}) == 1


def test_mesh_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardMesh.in_process(2)
    mesh = ShardMesh.in_process(2, "cpu")
    assert ParticleFilter(lgssm(), FilterConfig(n_particles=8, n_steps=4, mesh=mesh), device="cpu").device == mesh.device
    with pytest.raises(KeyError):
        ParticleFilter(lgssm(), FilterConfig(n_particles=8, n_steps=4, mesh=mesh, data_axes="other"))
    with pytest.raises(TypeError, match="ShardStreams"):
        run_filter(CopyMode.LAZY_SR, mesh, gen=rnd.Replay([]))


# ---------------------------------------------------------------------------
# particle Gibbs and the SMC decoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ALL_MODES, ids=lambda m: m.value)
def test_one_shard_particle_gibbs_is_bit_exact(mode):
    ys = np.random.default_rng(5).standard_normal(T_F).astype(np.float32)
    out = []
    for mesh in (None, ShardMesh.in_process(1, "cpu")):
        cfg = FilterConfig(n_particles=N_F, n_steps=T_F, mode=mode, block_size=2, mesh=mesh)
        pg = ParticleGibbs(lgssm(), cfg, device=None if mesh is not None else "cpu")
        out.append(pg.run(rnd.generator(4, "cpu"), None, ys, n_iters=3))
    a, b = out
    for f in ("reference", "log_evidences", "used_blocks_trace", "oom", "grew"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(a.peak_blocks.reshape(1), b.peak_blocks)


def test_four_shard_particle_gibbs_runs():
    ys = np.random.default_rng(5).standard_normal(T_F).astype(np.float32)
    cfg = FilterConfig(n_particles=N_F, n_steps=T_F, mode=CopyMode.LAZY_SR, block_size=2,
                       mesh=ShardMesh.in_process(4, "cpu"))
    res = ParticleGibbs(lgssm(), cfg).run(rnd.generator(4, "cpu"), None, ys, n_iters=2)
    assert res.reference.shape == (T_F, 1) and bool(torch.isfinite(res.log_evidences).all())
    assert res.peak_blocks.shape == (4,) and not bool(res.oom)


def test_token_trace_import_skew_grows_before_the_clone():
    """The reference's lifecycle case: every shard's pool shrunk to its
    live set, then every slot resampled onto one shard's particle.  The
    demand, sized from the replicated ancestors, grows the pools once in
    lockstep before the clone: no oom, the histories exact."""
    from repro_torch.serving.smc_decode import _TokenTrace

    mesh = ShardMesh.in_process(4, "cpu")
    tr = _TokenTrace(8, 16, CopyMode.LAZY_SR, 2, mesh)
    for t in range(8):
        tr.append(torch.full((8,), t, dtype=torch.int32))
    want = tr.tokens(8)
    live = int(tss.used_blocks_per_shard(tr.shcfg, mesh, tr.store).max())
    tr.store = tss.compact(tr.shcfg, mesh, tr.store, new_num_blocks=live)
    assert int(tss.free_blocks(tr.shcfg, mesh, tr.store)) == 0
    anc = torch.full((8,), 7, dtype=torch.int32)
    # Shards 0-2 each import two histories of 8 tokens, 4 blocks each.
    assert tr.clone_import_demand(anc) == 8
    grew = tr.ensure_clone_headroom(anc, 2.0)
    tr.clone(anc)
    assert grew == 1 and not tr.oom()
    assert torch.equal(tr.tokens(8), want[7].expand(8, 8))


def test_two_shard_decoder_equals_the_unsharded_one():
    """A 2-shard token store under the scheduler: tokens, log-weights,
    log-evidence, ESS and resampling steps bit-equal to the unsharded
    decoder (the KV cache is not sharded); the trace pools' invariants
    hold shard by shard."""
    from repro_torch.configs.starcoder2_3b import SMOKE
    from repro_torch.models.model import LanguageModel
    from repro_torch.serving.smc_decode import SMCDecoder

    lm = LanguageModel(SMOKE)
    params = lm.init(rnd.generator(0, "cpu"), device="cpu")
    prompt = torch.randint(0, SMOKE.vocab_size, (7,), generator=rnd.generator(1, "cpu"))
    out = []
    for mesh in (None, ShardMesh.in_process(2, "cpu")):
        dec = SMCDecoder(lm, params, 8, max_len=40, block_size=4, target_temp=1.0, proposal_temp=4.0,
                         mesh=mesh, device=None if mesh is not None else "cpu")
        out.append(dec.run(rnd.generator(5, "cpu"), prompt, 12))
    a, b = out
    assert int(a.resampled.sum()) > 0
    for f in ("tokens", "log_weights", "log_evidence", "ess_trace", "resampled", "oom"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------

RANK_SCRIPT = textwrap.dedent(
    """
    import math
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, sys.argv[4])
    import test_torch_sharded as T
    from repro_torch import random as rnd
    from repro_torch.core.config import ALL_MODES
    from repro_torch.distributed import ShardMesh
    from repro_torch.distributed import sharded_store as tss

    rank, world, where = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method=f"file://{where}/rendezvous", world_size=world, rank=rank)
    mesh = ShardMesh.process_group(device="cpu")
    out = T.sharded_results(mesh)
    if rank == 0:
        np.savez(f"{where}/group.npz", **{k: v.numpy() for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank)
    """
)


def sharded_results(mesh):
    """The store program's final stacked leaves and the 2-shard filter's
    results in every mode, gathered (the same on every rank)."""
    out = {}
    for mode in ALL_MODES:
        name, leaves, traj, used, peak = run_store_program(mesh, mode)[-1]
        for i, leaf in enumerate([*leaves, traj, used, peak]):
            out[f"store/{mode.value}/{i}"] = leaf
        pf, res = run_filter(mode, mesh)
        out[f"filter/{mode.value}/log_evidence"] = res.log_evidence.reshape(1)
        out[f"filter/{mode.value}/hist"] = res.state[1]
        out[f"filter/{mode.value}/traj"] = tss.trajectories(pf.sharded_cfg, mesh, res.store)
        for i, leaf in enumerate(view_leaves(mesh, res.store)):
            out[f"filter/{mode.value}/leaf{i}"] = leaf
    return out


def test_gloo_process_group_equals_in_process_two_shards(tmp_path):
    """Two gloo ranks (one process each, a ``file://`` rendezvous): the
    store program and the filter in every mode bit-equal to the in-process
    2-shard run."""
    env = subprocess_env()
    env.pop("JAX_PLATFORMS", None)
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    here = str(Path(__file__).resolve().parent)
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", str(tmp_path), here], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    logs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        finally:
            p.kill()
        logs.append((p.returncode, out, err))
    assert all(rc == 0 and "RANK_OK" in out for rc, out, _ in logs), logs
    with np.load(tmp_path / "group.npz") as f:
        group = dict(f)
    local = sharded_results(ShardMesh.in_process(2, "cpu"))
    assert set(group) == set(local)
    for key, want in local.items():
        assert_same(torch.as_tensor(group[key]), want.numpy(), key)


# ---------------------------------------------------------------------------
# the card's repairs: ssd_scan at any length, bf16 flash at d 16 and 32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 20, 40])
def test_padded_scan_tail_leaves_the_scan_unchanged(s):
    """The card's padding, run through the plain scan: a ``dt = 0`` tail
    to the chunk rounded up to 16 leaves every output up to S and the
    final state as the unpadded scan's (to 1e-5: the same sums over a
    longer chunk, in another order)."""
    from repro_torch.kernels.ssd_scan.ops import card_length, pad_tail
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    gen = rnd.generator(s, "cpu")
    x = rnd.normal(gen, (2, s, 3, 16))
    dt = torch.nn.functional.softplus(rnd.normal(gen, (2, s, 3)))
    a = -torch.exp(0.3 * rnd.normal(gen, (3,)))
    bm, cm = rnd.normal(gen, (2, s, 16)), rnd.normal(gen, (2, s, 16))
    s_pad, qc = card_length(s, min(64, s))
    assert qc % 16 == 0 and s_pad % qc == 0 and s_pad > s
    y, h = ssd_scan_ref(x, dt, a, bm, cm)
    xp, dtp, bp, cp = pad_tail(x, dt, bm, cm, s_pad)
    assert not dtp[:, s:].any()
    yp, hp = ssd_scan_ref(xp, dtp, a, bp, cp, chunk=qc)
    torch.testing.assert_close(yp[:, :s], y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hp, h, rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_7b"])
@pytest.mark.parametrize("s", [1, 20, 40])
def test_ssm_prompt_of_any_length_on_the_card(cuda_device, arch, s):
    """The smoke SSM models prefill prompts of 1, 20 and 40 tokens on the
    card (the scan's padded tail) and decode: every logit and cache leaf
    within ``crosscheck.SSD_TOL`` of the CPU's, one scan launch per SSM
    layer of the prefill."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import dispatch
    from repro_torch.serving import crosscheck

    before = dispatch.get_op("ssd_scan").launches
    readings = crosscheck.dense_cache_card_against_cpu(cuda_device, arch, prompt_len=s)
    assert readings["limit"] == crosscheck.SSD_TOL
    assert dispatch.get_op("ssd_scan").launches - before == smoke_config(arch).n_layers


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("window", [0, 45])
def test_bf16_flash_at_smoke_head_dims(cuda_device, d, window):
    """bf16 at head dims 16 and 32 runs the CUDA-core kernel (bf16 loads,
    f32 arithmetic), held to ``check_flash``'s bf16 tolerances."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_torch_boundaries import check_flash

    check_flash(rnd.generator(d + window, cuda_device), (2, 200, 6, 2, d), torch.bfloat16, window)
