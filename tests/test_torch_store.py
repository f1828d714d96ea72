"""The port's block pool and particle store against the JAX reference.

Every leaf — payload (dump row included: both sides keep it zero),
refcounts, frozen bits, free stack and top, oom, parent/dirty, tables,
lengths, peak — must be bit-exact with the reference after each
operation, on the CPU path (the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import pool as jpool  # noqa: E402
from repro.core import store as jstore  # noqa: E402
from repro.core.config import CopyMode as JMode  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.core import pool as tpool  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.core.config import ALL_MODES, CopyMode  # noqa: E402

CPU = torch.device("cpu")


class _Jitted:
    """A reference module's functions under ``jax.jit`` with the given
    static arguments: one compile per shape instead of one per
    primitive."""

    def __init__(self, module, static):
        self._module, self._static = module, static

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if callable(fn):
            fn = jax.jit(fn, static_argnums=self._static.get(name, self._static["*"]))
        setattr(self, name, fn)
        return fn


jit_store = _Jitted(jstore, {"grow": (0, 2), "compact": (0, 2), "*": (0,)})
jit_pool = _Jitted(jpool, {"alloc": (1,), "alloc_compact": (1,), "init": (0, 1), "*": ()})


def jmode(mode: CopyMode) -> JMode:
    return JMode(mode.value)


def configs(mode: CopyMode, **kw):
    jcfg = jstore.StoreConfig(mode=jmode(mode), **kw)
    return jcfg, tstore.StoreConfig(mode=mode, **kw)


def same_pool(jp, tp):
    got = convert.pool_to_numpy(tp)
    for name in tpool.BlockPool._fields:
        np.testing.assert_array_equal(
            getattr(got, name), np.asarray(getattr(jp, name)), err_msg=name
        )


def same_store(js, ts):
    same_pool(js.pool, ts.pool)
    got = convert.store_to_numpy(ts)
    for name in tstore.ParticleStore._fields[1:]:
        np.testing.assert_array_equal(
            getattr(got, name), np.asarray(getattr(js, name)), err_msg=name
        )


def both(x, dtype=None):
    arr = np.asarray(x, dtype=dtype)
    return jnp.asarray(arr), torch.as_tensor(arr.copy())


class TestPoolInterleavings:
    """Seeded alloc / add_refs / sub_refs programs, as
    tests/test_pool_freestack.py drives the reference."""

    @pytest.mark.parametrize("seed", range(8))
    def test_leaf_exact(self, seed):
        rng = np.random.default_rng(seed)
        nb = 12  # one pool shape for every seed: the reference compiles once
        jp = jpool.init(nb, (2,))
        tp = tpool.init(nb, (2,), device=CPU)
        live: dict[int, int] = {}
        for _ in range(30):
            op = rng.integers(0, 3)
            if op == 0:
                # Fixed shapes (5 candidates, picks padded with NULL) keep
                # the reference to one compile per op.
                k = int(rng.integers(1, 6))
                commit = np.zeros(5, bool)
                commit[:k] = rng.integers(0, 2, k).astype(bool)
                cj, ct = both(commit)
                jp, jids = jit_pool.alloc(jp, 5, commit=cj)
                tp, tids = tpool.alloc(tp, 5, commit=ct)
                np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
                for b in np.asarray(jids):
                    if b >= 0:
                        live[int(b)] = 1
            elif op == 1 and live:
                picks = rng.choice(list(live), size=rng.integers(1, 4))
                pj, pt = both(np.pad(picks, (0, 4 - len(picks)), constant_values=-1), np.int32)
                jp, tp = jit_pool.add_refs(jp, pj), tpool.add_refs(tp, pt)
                for b in picks:
                    live[int(b)] += 1
            elif op == 2 and live:
                picks = []
                budget = dict(live)
                for b in rng.permutation(list(live))[: rng.integers(1, 4)]:
                    take = int(rng.integers(1, budget[int(b)] + 1))
                    picks += [int(b)] * take
                    budget[int(b)] -= take
                pj, pt = both(picks + [-1] * max(0, 16 - len(picks)), np.int32)
                jp, tp = jit_pool.sub_refs(jp, pj), tpool.sub_refs(tp, pt)
                for b in picks:
                    live[b] -= 1
                    if live[b] == 0:
                        del live[b]
            same_pool(jp, tp)
            assert bool(tpool.free_stack_consistent(tp))
            assert int(tpool.blocks_in_use(tp)) == len(live)

    def test_alloc_compact_and_verify_path(self):
        jp = jpool.init(9, (3,))
        tp = tpool.init(9, (3,), device=CPU)
        jp, _ = jit_pool.alloc(jp, 4)
        tp, _ = tpool.alloc(tp, 4)
        cj, ct = both([False, True, False, True, True, False, True])
        jp, jids = jit_pool.alloc_compact(jp, 7, commit=cj)
        tp, tids = tpool.alloc_compact(tp, 7, commit=ct)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        same_pool(jp, tp)
        fj, ft = both([1, 2, 3, -1], np.int32)
        jp, tp = jit_pool.freeze(jp, fj), tpool.freeze(tp, ft)
        same_pool(jp, tp)
        same_pool(jit_pool.rebuild_free_stack(jp), tpool.rebuild_free_stack(tp))
        tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
        assert tpool.check_invariants(tp) == []
        assert tpool.check_invariants(tp, tables) == (
            jpool.check_invariants(jp, jnp.asarray(tables.numpy()))
        )
        freed_j, freed_t = both(np.arange(9) % 3 == 0)
        same_pool(jit_pool.release_parents(jp, freed_j), tpool.release_parents(tp, freed_t))
        ids_j, ids_t = both([0, -1, 4], np.int32)
        np.testing.assert_array_equal(
            tpool.parent_or_self(tp, ids_t).numpy(),
            np.asarray(jit_pool.parent_or_self(jp, ids_j)),
        )
        vals = np.arange(6, dtype=np.float32).reshape(2, 3)
        wid_j, wid_t = both([5, 6], np.int32)
        mj, mt = both([True, False])
        same_pool(
            jit_pool.write_blocks(jp, wid_j, jnp.asarray(vals), mj),
            tpool.write_blocks(tp, wid_t, torch.as_tensor(vals), mt),
        )
        assert tpool.next_capacity(10, 3, 100, 2.0) == jpool.next_capacity(10, 3, 100, 2.0)


def run_program(lib, cfg, s, arr, key):
    """tests/test_write_path.py's _run_program (COW, partial-mask
    write_at, NULL entries, clone-induced frees, batch materialization),
    extended with the fused clone_chain, compact and grow.  ``arr`` makes
    the framework's arrays; ``key`` is the reference's PRNG key or the
    port's replay of its one uniform.  Yields after every op."""
    n = cfg.n
    rows = arr(np.arange(n, dtype=np.float32))
    for t in range(5):  # short: trailing table entries stay NULL
        s = lib.append(cfg, s, rows * 10 + t)
        yield s
    s = lib.clone(cfg, s, arr(np.zeros(n, np.int32)))
    yield s
    s = lib.append(cfg, s, rows + 100)  # divergence -> COW
    yield s
    s = lib.write_at(
        cfg, s, arr(np.full(n, 1, np.int32)), -rows,
        mask=arr(np.arange(n) % 2 == 0),
    )
    yield s
    s = lib.clone(cfg, s, arr((np.arange(n) // 2).astype(np.int32)))
    yield s
    yield lib.materialize_batch(cfg, s, arr(np.arange(n, dtype=np.int32)))
    logw = arr(np.array([0.1, -2.0, 0.7, -0.3], np.float32)[:n])
    s, anc = lib.clone_chain(cfg, s, key, logw)
    yield anc
    yield s
    s = lib.append(cfg, s, rows + 200)
    yield s
    if cfg.mode.value != "eager":
        s = lib.grow(cfg, s, s.pool.num_blocks + 7)
        yield s
        s = lib.append(cfg, s, rows + 300)
        yield s
        s = lib.compact(cfg, s)
        yield s
        s = lib.compact(cfg, s, int(lib.used_blocks(cfg, s)) + 2)  # shrink to fit
        yield s
    yield lib.materialize_batch(cfg, s, arr(np.arange(n, dtype=np.int32)))
    yield lib.read_last(cfg, s)
    yield lib.trajectory(cfg, s, 1)


@pytest.mark.parametrize("mode", ALL_MODES)
def test_store_program_leaf_exact(mode):
    base = dict(n=4, block_size=3, max_blocks=4, num_blocks=30)
    jcfg, tcfg = configs(mode, **base)
    key = jax.random.PRNGKey(3)
    replay = rnd.Replay([("uniform", np.asarray(jax.random.uniform(key)))])
    ref = run_program(jit_store, jcfg, jstore.create(jcfg), jnp.asarray, key)
    port = run_program(
        tstore, tcfg, tstore.create(tcfg, CPU), lambda a: torch.as_tensor(a.copy()), replay
    )
    for step, (js, ts) in enumerate(zip(ref, port, strict=True)):
        if isinstance(ts, tstore.ParticleStore):
            same_store(js, ts)
            if mode.is_lazy:
                assert tpool.check_invariants(ts.pool, ts.tables) == [], step
        else:
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=str(step))
    assert replay.remaining == 0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode", [CopyMode.LAZY, CopyMode.LAZY_SR])
def test_random_store_programs_from_converted_state(seed, mode):
    """Seeded append / clone / write_at programs (as
    tests/test_pool_freestack.py runs them), starting the port from the
    reference's state brought across by ``convert``."""
    jcfg, tcfg = configs(mode, n=4, block_size=3, max_blocks=5, num_blocks=40)
    r = np.random.default_rng(seed)
    js = jstore.create(jcfg)
    for t in range(3):
        js = jstore.append(jcfg, js, jnp.full((4,), float(t)))
    js = jstore.clone(jcfg, js, jnp.asarray([0, 0, 2, 2], jnp.int32))
    ts = convert.store_from_numpy(jax.tree.map(np.asarray, js), CPU)
    same_store(js, ts)
    length = 3
    for step in range(14):
        op = r.integers(0, 3)
        if op == 0 and length < jcfg.capacity:
            vj, vt = both(np.full(4, float(step), np.float32))
            js, ts = jit_store.append(jcfg, js, vj), tstore.append(tcfg, ts, vt)
            length += 1
        elif op == 1:
            aj, at = both(r.integers(0, 4, 4), np.int32)
            js, ts = jit_store.clone(jcfg, js, aj), tstore.clone(tcfg, ts, at)
        else:
            pj, pt = both(np.full(4, int(r.integers(0, length))), np.int32)
            vj, vt = both(np.full(4, -float(step), np.float32))
            mj, mt = both(r.integers(0, 2, 4).astype(bool))
            js = jit_store.write_at(jcfg, js, pj, vj, mj)
            ts = tstore.write_at(tcfg, ts, pt, vt, mask=mt)
        same_store(js, ts)
        assert bool(tpool.free_stack_consistent(ts.pool))


def test_round_trip_and_accounting():
    jcfg, tcfg = configs(CopyMode.LAZY_SR, n=3, block_size=2, max_blocks=3, item_shape=(2,))
    js = jstore.create(jcfg)
    js = jstore.append(jcfg, js, jnp.ones((3, 2)))
    ts = convert.store_from_numpy(jax.tree.map(np.asarray, js), CPU)
    same_store(js, convert.store_from_numpy(convert.store_to_numpy(ts), CPU))
    assert int(tstore.used_bytes(tcfg, ts)) == int(jstore.used_bytes(jcfg, js))
    assert int(tstore.free_blocks(tcfg, ts)) == int(jstore.free_blocks(jcfg, js))
    assert bool(tstore.oom_flag(tcfg, ts)) == bool(jstore.oom_flag(jcfg, js))


def test_strict_oom_and_unported_options():
    cfg = tstore.StoreConfig(
        mode=CopyMode.LAZY_SR, n=4, block_size=1, max_blocks=4, num_blocks=2,
        strict_oom=True,
    )
    s = tstore.append(cfg, tstore.create(cfg, CPU), torch.zeros(4))
    assert bool(tstore.oom_flag(cfg, s))
    with pytest.raises(RuntimeError, match="exhausted pool"):
        tstore.materialize_batch(cfg, s, torch.arange(4))
    # delta_cow is ported: it builds, writes and reads back.
    dcfg = tstore.StoreConfig(mode=CopyMode.LAZY, n=2, block_size=2, max_blocks=2, delta_cow=True)
    ds = tstore.append(dcfg, tstore.create(dcfg, CPU), torch.tensor([1.0, 2.0]))
    ds = tstore.clone(dcfg, ds, torch.zeros(2, dtype=torch.int32))
    ds = tstore.append(dcfg, ds, torch.tensor([3.0, 4.0]))
    assert (ds.pool.parent >= 0).any()
    assert tstore.materialize_batch(dcfg, ds, torch.arange(2))[:, :2].tolist() == [[1.0, 3.0], [1.0, 4.0]]


def delta_program(lib, cfg, s, arr):
    """tests/test_delta_cow.py's _delta_program (a mid-block clone, the
    divergence that makes delta pages, a masked write_at, the appends
    that fill the tail block and degenerate the delta pages), extended
    with the reads, a second append round after a clone of delta pages,
    and the fused clone_chain; ``arr`` makes the framework's arrays.
    Yields after every op."""
    n = cfg.n
    rows = arr(np.arange(n, dtype=np.float32))
    for t in range(4):
        s = lib.append(cfg, s, rows * 10 + t)
        yield s
    s = lib.clone(cfg, s, arr(np.zeros(n, np.int32)))
    yield s
    s = lib.append(cfg, s, rows + 100)  # divergence -> delta COW
    yield s
    s = lib.write_at(
        cfg, s, arr(np.full(n, 1, np.int32)), -rows, mask=arr(np.arange(n) % 2 == 0)
    )
    yield s
    # Clone the delta pages themselves, then write into them again.
    s = lib.clone(cfg, s, arr(np.array([1, 1, 0, 3], np.int32)[:n]))
    yield s
    s = lib.append(cfg, s, rows + 150)
    yield s
    for pos in (0, 2, 4, 5):
        yield lib.read_at(cfg, s, arr(np.full(n, pos, np.int32)))
    yield lib.materialize_batch(cfg, s, arr(np.arange(n, dtype=np.int32)))
    for t in range(cfg.block_size):  # fill the tail block: degeneration
        s = lib.append(cfg, s, rows + 200 + t)
        yield s
    s = lib.clone(cfg, s, arr((np.arange(n) // 2).astype(np.int32)))
    yield s
    yield lib.materialize_batch(cfg, s, arr(np.arange(n, dtype=np.int32)))
    yield lib.trajectory(cfg, s, 1)


@pytest.mark.parametrize("mode", [CopyMode.LAZY, CopyMode.LAZY_SR])
def test_delta_program_leaf_exact(mode):
    """Under delta COW every leaf (data, refcount, frozen, free stack,
    parent, dirty, tables, lengths, peak) equals the reference's after
    each op, and the pool's invariants hold with parents in play."""
    base = dict(n=4, block_size=3, max_blocks=6, num_blocks=40, delta_cow=True)
    jcfg, tcfg = configs(mode, **base)
    ref = delta_program(jit_store, jcfg, jstore.create(jcfg), jnp.asarray)
    port = delta_program(tstore, tcfg, tstore.create(tcfg, CPU), lambda a: torch.as_tensor(a.copy()))
    made_delta = False
    for step, (js, ts) in enumerate(zip(ref, port, strict=True)):
        if isinstance(ts, tstore.ParticleStore):
            same_store(js, ts)
            assert tpool.check_invariants(ts.pool, ts.tables) == [], step
            made_delta |= bool((ts.pool.parent >= 0).any())
        else:
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js), err_msg=str(step))
    assert made_delta


@pytest.mark.parametrize("mode", [CopyMode.LAZY, CopyMode.LAZY_SR])
def test_delta_on_off_observationally_equal(mode):
    """Within the port, delta COW on and off read back the same: lengths,
    valid-prefix trajectories and point reads bit-equal (the pool leaves
    legitimately differ, as in the reference)."""
    base = dict(mode=mode, n=4, block_size=3, max_blocks=6, num_blocks=40)
    arr = lambda a: torch.as_tensor(a.copy())  # noqa: E731
    runs = []
    for delta in (False, True):
        cfg = tstore.StoreConfig(**base, delta_cow=delta)
        outs = list(delta_program(tstore, cfg, tstore.create(cfg, CPU), arr))
        final = [o for o in outs if isinstance(o, tstore.ParticleStore)][-1]
        valid = torch.arange(cfg.capacity)[None, :] < final.lengths[:, None]
        mats = tstore.materialize_batch(cfg, final, torch.arange(4))
        reads = [o for o in outs if not isinstance(o, tstore.ParticleStore)]
        runs.append((final.lengths, torch.where(valid, mats, 0.0), reads[:4]))
    (len0, mat0, reads0), (len1, mat1, reads1) = runs
    assert torch.equal(len0, len1) and torch.equal(mat0, mat1)
    assert all(torch.equal(a, b) for a, b in zip(reads0, reads1, strict=True))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("mode", [CopyMode.LAZY, CopyMode.LAZY_SR])
def test_random_delta_programs_leaf_exact(seed, mode):
    """Seeded append / clone / clone_chain / write_at programs under
    delta COW, leaf-exact with the reference after every op."""
    jcfg, tcfg = configs(mode, n=4, block_size=4, max_blocks=5, num_blocks=60, delta_cow=True)
    r = np.random.default_rng(seed)
    js, ts = jstore.create(jcfg), tstore.create(tcfg, CPU)
    length = 0
    for step in range(18):
        op = r.integers(0, 4) if length else 0
        if op == 0 and length < jcfg.capacity:
            vj, vt = both(r.standard_normal(4).astype(np.float32))
            js, ts = jit_store.append(jcfg, js, vj), tstore.append(tcfg, ts, vt)
            length += 1
        elif op == 1:
            aj, at = both(r.integers(0, 4, 4), np.int32)
            js, ts = jit_store.clone(jcfg, js, aj), tstore.clone(tcfg, ts, at)
        elif op == 2:
            key = jax.random.PRNGKey(int(r.integers(0, 1000)))
            replay = rnd.Replay([("uniform", np.asarray(jax.random.uniform(key)))])
            lj, lt = both(r.standard_normal(4).astype(np.float32))
            js, aj = jit_store.clone_chain(jcfg, js, key, lj)
            ts, at = tstore.clone_chain(tcfg, ts, replay, lt)
            np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
        elif length:
            pj, pt = both(r.integers(0, length, 4), np.int32)
            vj, vt = both(r.standard_normal(4).astype(np.float32))
            mj, mt = both(r.integers(0, 2, 4).astype(bool))
            js = jit_store.write_at(jcfg, js, pj, vj, mj)
            ts = tstore.write_at(tcfg, ts, pt, vt, mask=mt)
        same_store(js, ts)
        assert tpool.check_invariants(ts.pool, ts.tables) == [], step
    ids_j, ids_t = both(np.arange(4), np.int32)
    np.testing.assert_array_equal(
        tstore.materialize_batch(tcfg, ts, ids_t).numpy(),
        np.asarray(jit_store.materialize_batch(jcfg, js, ids_j)),
    )


@pytest.mark.parametrize("mode", [CopyMode.LAZY, CopyMode.LAZY_SR])
def test_delta_grow_and_compact_leaf_exact(mode):
    """grow and compact with delta blocks live (their parents remapped
    through compact's table), leaf-exact with the reference, and the
    trajectories unchanged by either."""
    base = dict(n=4, block_size=3, max_blocks=6, num_blocks=40, delta_cow=True, item_shape=(2,))
    jcfg, tcfg = configs(mode, **base)
    js, ts = jstore.create(jcfg), tstore.create(tcfg, CPU)
    r = np.random.default_rng(11)
    for t in range(7):
        if t in (2, 4, 5):
            aj, at = both(r.integers(0, 4, 4), np.int32)
            js, ts = jit_store.clone(jcfg, js, aj), tstore.clone(tcfg, ts, at)
        vj, vt = both(r.standard_normal((4, 2)).astype(np.float32))
        js, ts = jit_store.append(jcfg, js, vj), tstore.append(tcfg, ts, vt)
        same_store(js, ts)
    assert bool((ts.pool.parent >= 0).any())
    ids_j, ids_t = both(np.arange(4), np.int32)
    before = tstore.materialize_batch(tcfg, ts, ids_t)
    js, ts = jit_store.grow(jcfg, js, 55), tstore.grow(tcfg, ts, 55)
    same_store(js, ts)
    js, ts = jit_store.compact(jcfg, js), tstore.compact(tcfg, ts)
    same_store(js, ts)
    assert tpool.check_invariants(ts.pool, ts.tables) == []
    assert torch.equal(tstore.materialize_batch(tcfg, ts, ids_t), before)
    shrink = int(tstore.used_blocks(tcfg, ts)) + 1
    js, ts = jit_store.compact(jcfg, js, shrink), tstore.compact(tcfg, ts, shrink)
    same_store(js, ts)
    np.testing.assert_array_equal(
        tstore.materialize_batch(tcfg, ts, ids_t).numpy(),
        np.asarray(jit_store.materialize_batch(jcfg, js, ids_j)),
    )
    np.testing.assert_array_equal(
        tstore.trajectory(tcfg, ts, 2).numpy(), np.asarray(jstore.trajectory(jcfg, js, 2))
    )
