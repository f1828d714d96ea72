"""The port's paged KV cache and serving engine against the JAX reference.

The cache: the fork, COW and delta-COW sequences of
``tests/test_serving.py::TestPagedCache`` and
``tests/test_delta_cow.py::TestKVCacheDelta``, plus seeded random
programs, run through ``repro.serving.kv_cache`` and
``repro_torch.serving.kv_cache`` on the same numpy inputs.  Every leaf —
tables, lengths, refcounts, free stack and top, oom, parent, dirty and
the payload — must be bit-exact after every operation.

The engine: starcoder2-3b's smoke config with the same weights on both
sides; prefill, fork, eight decode steps, ``compact_cache`` and one more
step.  Logits agree to rtol/atol 1e-4 (float32 sums in other orders), the
integer leaves exactly; within the port, delta COW on and off give
bit-identical logits.
"""

from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.starcoder2_3b import SMOKE as JSMOKE  # noqa: E402
from repro.models.model import LanguageModel as JLanguageModel  # noqa: E402
from repro.serving import kv_cache as jkv  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.starcoder2_3b import SMOKE  # noqa: E402
from repro_torch.core import pool as tpool  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

# The reference's cache ops under jit (one compile per config and shape,
# not one dispatch per primitive); the configs and the layer are static.
J_ENSURE = jax.jit(jkv.ensure_writable, static_argnums=0)
J_WRITE = jax.jit(jkv.write_kv, static_argnums=(0, 4))
J_OPS = {name: jax.jit(getattr(jkv, name)) for name in ("fork", "free", "advance")}
J_OPS.update(grow=jax.jit(jkv.grow, static_argnums=1), compact=jkv.compact)

POOL_LEAVES = ("data", "refcount", "frozen", "free_stack", "free_top", "oom", "parent", "dirty")


def same_cache(jc, tc, data_tol=0.0):
    for leaf in POOL_LEAVES:
        want = np.asarray(getattr(jc.pool, leaf))
        got = np.array(getattr(tc.pool, leaf).float() if leaf == "data" else getattr(tc.pool, leaf))
        if leaf == "data" and data_tol:
            np.testing.assert_allclose(got, want, rtol=data_tol, atol=data_tol, err_msg=leaf)
        else:
            np.testing.assert_array_equal(got, want, err_msg=leaf)
    np.testing.assert_array_equal(np.array(tc.tables), np.asarray(jc.tables))
    np.testing.assert_array_equal(np.array(tc.lengths), np.asarray(jc.lengths))


class Both:
    """One KV-cache program driven through the reference and the port in
    lockstep, compared leaf for leaf after every operation."""

    def __init__(self, **cfg):
        self.jcfg = jkv.KVCacheConfig(**cfg)
        self.tcfg = tkv.KVCacheConfig(**cfg)
        self.j = jkv.create(self.jcfg)
        self.t = tkv.create(self.tcfg, device="cpu")
        self.check()

    def check(self):
        same_cache(self.j, self.t)

    def append(self, mask, k, v):
        """One token: ensure_writable, then every layer's K/V (``k``/``v``
        of shape [L, S, KVH, hd]), then advance."""
        mask = np.asarray(mask, bool)
        jm, tm = jnp.asarray(mask), torch.as_tensor(mask)
        self.j, jbid, jpos = J_ENSURE(self.jcfg, self.j, jm)
        self.t, tbid, tpos = tkv.ensure_writable(self.tcfg, self.t, tm)
        np.testing.assert_array_equal(np.asarray(tbid)[mask], np.asarray(jbid)[mask])
        np.testing.assert_array_equal(np.asarray(tpos), np.asarray(jpos))
        for layer in range(self.jcfg.n_layers):
            kj, vj = jnp.asarray(k[layer]), jnp.asarray(v[layer])
            kt, vt = torch.as_tensor(k[layer]), torch.as_tensor(v[layer])
            self.j = J_WRITE(self.jcfg, self.j, jbid, jpos, layer, kj, vj, jm)
            self.t = tkv.write_kv(self.tcfg, self.t, tbid, tpos, layer, kt, vt, tm)
        self.j = J_OPS["advance"](self.j, jm)
        self.t = tkv.advance(self.t, tm)
        self.check()

    def op(self, name, *args):
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
        self.j = J_OPS[name](self.j, *jargs)
        self.t = getattr(tkv, name)(self.t, *targs)
        self.check()


def payload(rng, cfg, s):
    shape = (cfg["n_layers"], s, cfg["n_kv_heads"], cfg["head_dim"])
    return rng.standard_normal(shape).astype(np.float32)


PAGED = dict(n_layers=2, n_kv_heads=2, head_dim=8, block_size=4, max_seqs=4,
             max_blocks_per_seq=8, num_blocks=32)
DELTA = dict(n_layers=2, n_kv_heads=1, head_dim=4, block_size=4, max_seqs=3,
             max_blocks_per_seq=4, num_blocks=16)


class TestPagedCacheSequences:
    """``tests/test_serving.py::TestPagedCache``'s sequences, leaf-exact."""

    def test_fork_is_zero_copy(self):
        b = Both(**PAGED)
        rng = np.random.default_rng(0)
        for _ in range(6):
            k = payload(rng, PAGED, 4)
            b.append([True, False, False, False], k, k)
        used = int(tkv.used_blocks(b.t))
        b.op("fork", np.zeros(4, np.int32))
        assert int(tkv.used_blocks(b.t)) == used

    def test_cow_on_shared_tail(self):
        b = Both(**PAGED)
        rng = np.random.default_rng(1)
        for _ in range(5):
            k = payload(rng, PAGED, 4)
            b.append([True, False, False, False], k, -k)
        b.op("fork", np.zeros(4, np.int32))
        used = int(tkv.used_blocks(b.t))
        k = payload(rng, PAGED, 4)
        b.append([True] * 4, k, -k)
        assert int(tkv.used_blocks(b.t)) == used + 3  # three COW copies

    def test_free_reclaims(self):
        b = Both(**PAGED)
        rng = np.random.default_rng(2)
        for _ in range(4):
            k = payload(rng, PAGED, 4)
            b.append([True] * 4, k, k)
        b.op("free", np.array([True, True, False, False]))
        assert int(tkv.used_blocks(b.t)) == 2


def kv_program(b: Both, cfg, rng, steps=5):
    """``tests/test_delta_cow.py``'s program: token-by-token writes with a
    mid-block fork and a row masked on odd steps."""
    s = cfg["max_seqs"]
    for step in range(steps):
        if step == 2:
            b.op("fork", np.zeros(s, np.int32))
        k = payload(rng, cfg, s)
        b.append([True] * (s - 1) + [step % 2 == 0], k, -k)


class TestKVCacheDeltaSequences:
    """``tests/test_delta_cow.py::TestKVCacheDelta``'s sequences, leaf-exact."""

    @pytest.mark.parametrize("delta_cow", [False, True])
    def test_program(self, delta_cow):
        b = Both(**DELTA, delta_cow=delta_cow)
        kv_program(b, DELTA, np.random.default_rng(3))
        if delta_cow:
            assert (b.t.pool.parent >= 0).any()
        assert not tpool.check_invariants(b.t.pool, b.t.tables)

    def test_boundary_straddle_and_dump_row(self):
        cfg = dict(DELTA, block_size=3)
        b = Both(**cfg, delta_cow=True)
        for step in range(2):
            k = np.full((2, 3, 1, 4), float(step + 1), np.float32)
            b.append([True] * 3, k, -k)
        b.op("fork", np.array([0, 0, 1], np.int32))
        k = np.full((2, 3, 1, 4), 9.0, np.float32)
        b.append([True, True, False], k, -k)
        assert not b.t.pool.data[b.t.pool.num_blocks].any()

    def test_free_cascade_reclaims_everything(self):
        b = Both(**DELTA, delta_cow=True)
        kv_program(b, DELTA, np.random.default_rng(4))
        b.op("free", np.ones(3, bool))
        assert int(tkv.used_blocks(b.t)) == 0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("delta_cow", [False, True])
def test_random_programs(seed, delta_cow):
    """Seeded mixes of appends (random masks), forks, frees, grow and
    compact, on a pool that starts small."""
    cfg = dict(n_layers=2, n_kv_heads=2, head_dim=4, block_size=3, max_seqs=5,
               max_blocks_per_seq=6, num_blocks=24)
    b = Both(**cfg, delta_cow=delta_cow)
    rng = np.random.default_rng(seed)
    for step in range(14):
        r = rng.random()
        if r < 0.15 and step:
            b.op("fork", rng.integers(0, 5, 5).astype(np.int32))
        elif r < 0.2:
            b.op("free", rng.random(5) < 0.3)
        elif step == 7:
            b.op("grow", 30)
        elif step == 10:
            b.op("compact")
        else:
            k = payload(rng, cfg, 5)
            live = np.asarray(b.t.lengths) < cfg["block_size"] * cfg["max_blocks_per_seq"]
            b.append((rng.random(5) < 0.8) & live, k, -k)
    assert not bool(tkv.oom_flag(b.t))
    assert not tpool.check_invariants(b.t.pool, b.t.tables)


def test_pool_sizes_match_the_reference():
    for kw in (dict(max_seqs=16, max_blocks_per_seq=41), dict(max_seqs=4, max_blocks_per_seq=8),
               dict(max_seqs=2, max_blocks_per_seq=3, num_blocks=9)):
        j = jkv.KVCacheConfig(n_layers=1, n_kv_heads=1, head_dim=2, **kw)
        t = tkv.KVCacheConfig(n_layers=1, n_kv_heads=1, head_dim=2, **kw)
        assert (t.pool_blocks, t.pool_blocks_cap) == (j.pool_blocks, j.pool_blocks_cap)
    # The auto size is the forked-population bound: too small for 16
    # independent 656-token rows (41 pages each), which need the cap.
    assert tkv.KVCacheConfig(1, 1, 2, max_seqs=16, max_blocks_per_seq=41).pool_blocks == 250


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    params, _ = JLanguageModel(JSMOKE).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def engines(weights, delta_cow, **overrides):
    jparams, np_params = weights
    kw = dict(n_layers=SMOKE.n_layers, n_kv_heads=SMOKE.n_kv_heads, head_dim=SMOKE.hd,
              block_size=4, max_seqs=8, max_blocks_per_seq=12, num_blocks=60,
              dtype="float32", delta_cow=delta_cow)
    kw.update(overrides)
    je = JServeEngine(JLanguageModel(JSMOKE), jparams, jkv.KVCacheConfig(**kw))
    tparams = convert.params_from_numpy(np_params, SMOKE, "cpu")
    te = ServeEngine(LanguageModel(SMOKE), tparams, tkv.KVCacheConfig(**kw), device="cpu")
    return je, te


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)


def serve_program(je, te, seed=0, steps=8):
    """Prefill two 10-token prompts (not a multiple of the page), fork them
    to eight rows, decode ``steps`` tokens, compact, decode once more;
    compare after every step.  Returns the port's logits."""
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, SMOKE.vocab_size, (2, 10)).astype(np.int32)
    ids = np.array([0, 1], np.int32)
    out = [te.prefill(torch.as_tensor(prompts), torch.as_tensor(ids))]
    close(out[-1], je.prefill(jnp.asarray(prompts), jnp.asarray(ids)))
    same_cache(je.cache, te.cache, data_tol=1e-4)
    anc = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.int32)
    je.fork(jnp.asarray(anc))
    te.fork(torch.as_tensor(anc))
    for step in range(steps + 1):
        if step == steps:
            je.compact_cache()
            te.compact_cache()
        tokens = rng.integers(0, SMOKE.vocab_size, (8, 1)).astype(np.int32)
        out.append(te.decode(torch.as_tensor(tokens)))
        close(out[-1], je.decode(jnp.asarray(tokens)))
        same_cache(je.cache, te.cache, data_tol=1e-4)
    assert not te.oom
    return out


@pytest.mark.parametrize("delta_cow", [False, True])
def test_engine_matches_reference(weights, delta_cow):
    je, te = engines(weights, delta_cow)
    serve_program(je, te)
    assert te.used_blocks == je.used_blocks and te.free_blocks == je.free_blocks


def test_engine_delta_on_off_bit_identical(weights):
    _, off = engines(weights, False)
    _, on = engines(weights, True)
    rng = np.random.default_rng(7)
    prompts = torch.as_tensor(rng.integers(0, SMOKE.vocab_size, (2, 10)))
    ids = torch.tensor([0, 1], dtype=torch.int32)
    assert torch.equal(off.prefill(prompts, ids), on.prefill(prompts, ids))
    for eng in (off, on):
        eng.fork(torch.tensor([0, 0, 0, 0, 1, 1, 1, 1]))
    for step in range(9):
        tokens = torch.as_tensor(rng.integers(0, SMOKE.vocab_size, (8, 1)))
        if step == 5:
            for eng in (off, on):
                eng.fork(torch.tensor([3, 3, 1, 0, 6, 6, 6, 2]))
        assert torch.equal(off.decode(tokens), on.decode(tokens))
    assert (on.cache.pool.parent >= 0).any()  # the delta path really ran


def test_engine_slot_ops_and_growth(weights):
    je, te = engines(weights, False, num_blocks=20)
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, SMOKE.vocab_size, (3, 6)).astype(np.int32)
    ids = np.array([0, 2, 4], np.int32)
    close(te.prefill(torch.as_tensor(prompts), torch.as_tensor(ids)),
          je.prefill(jnp.asarray(prompts), jnp.asarray(ids)))
    je.fork_slots(4, jnp.asarray([0, 0, 0], jnp.int32))
    te.fork_slots(4, torch.tensor([0, 0, 0]))
    je.grow_cache(40)
    te.grow_cache(40)
    same_cache(je.cache, te.cache, data_tol=1e-4)
    live = np.asarray(je.cache.lengths) > 0  # empty rows: 0 here, V's mean there
    for _ in range(3):
        tokens = rng.integers(0, SMOKE.vocab_size, (8, 1)).astype(np.int32)
        got, want = te.decode(torch.as_tensor(tokens)), je.decode(jnp.asarray(tokens))
        close(got[live], np.asarray(want)[live])
    je.free_slots(4, 2)
    te.free_slots(4, 2)
    same_cache(je.cache, te.cache, data_tol=1e-4)
    assert te.num_blocks == je.num_blocks == 40


def test_engine_kv_cache_from_reference_state(weights):
    """Both engines continue from the same cache state, carried over by
    the converter."""
    je, te = engines(weights, True)
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, SMOKE.vocab_size, (2, 7)).astype(np.int32)
    je.prefill(jnp.asarray(prompts), jnp.asarray([0, 1], jnp.int32))
    je.fork(jnp.asarray([0, 1, 0, 1, 0, 1, 0, 1], jnp.int32))
    te.cache = convert.kv_cache_from_numpy(jax.tree.map(np.asarray, je.cache), "cpu")
    same_cache(je.cache, te.cache)
    back = convert.kv_cache_to_numpy(te.cache)
    np.testing.assert_array_equal(back.tables, np.asarray(je.cache.tables))
    tokens = rng.integers(0, SMOKE.vocab_size, (8, 1)).astype(np.int32)
    close(te.decode(torch.as_tensor(tokens)), je.decode(jnp.asarray(tokens)))
    same_cache(je.cache, te.cache, data_tol=1e-4)


def test_engine_device_and_family_policy(weights):
    lm = LanguageModel(SMOKE)
    params = convert.params_from_numpy(weights[1], SMOKE, "cpu")
    ccfg = tkv.KVCacheConfig(SMOKE.n_layers, SMOKE.n_kv_heads, SMOKE.hd, max_seqs=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine(lm, params, ccfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tkv.create(tkv.KVCacheConfig(1, 1, 2))
    ssm = types.SimpleNamespace(cfg=SMOKE.scaled(family="ssm"))  # no port builds one yet
    with pytest.raises(NotImplementedError, match="dense-cache"):
        ServeEngine(ssm, params, ccfg, device="cpu")


def test_serve_entry_point_on_the_cpu(capsys):
    toks = serve.main(["--device", "cpu", "--batch", "3", "--prompt-len", "9", "--steps", "5"])
    assert toks.shape == (3, 6) and bool(((toks >= 0) & (toks < SMOKE.padded_vocab)).all())
    out = capsys.readouterr().out
    assert "served 3 requests x 5 tokens" in out
    assert len([line for line in out.splitlines() if line.startswith("   [")]) == 3
    res = serve.main(["--device", "cpu", "--smc", "--particles", "4", "--steps", "3"])
    assert tuple(res.tokens.shape) == (4, 3) and not bool(res.oom)
    with pytest.raises(NotImplementedError):
        serve.main(["--device", "cpu", "--arch", "mamba2_130m"])
