"""The port's MoE and audio families against the JAX reference, on the CPU.

At the smoke configs of deepseek-moe-16b (8 experts top-2, 1 shared
expert, dense layer 0), phi3.5-moe (4 experts top-2) and musicgen-large
(non-gated GELU MLP), the same numpy inputs and the same weights
(``convert.params_from_numpy``) go through ``repro`` and ``repro_torch``:

* the configs field for field, and the registry;
* ``moe_layer`` at capacity factor 8.0 and at 1.25, where pairs drop,
  and with the routing in chunks of 7 tokens: outputs to 1e-5 of the
  largest |output| (they reach ~100), and the
  dispatch buffer ``[E, cap, D]`` (which token sits in which expert's
  slot) bit-equal to the reference's, which makes expert ids, positions
  and the keep mask equal; the inputs are checked to hold no top-k tie
  within 1e-5 first;
* ``LanguageModel`` parameter specs and ``forward``, to 1e-5;
* ``ServeEngine`` prefill, fork, decode and compaction against the
  reference's engine, whole-page and delta COW, at
  ``tests/test_torch_serving.py``'s tolerances (1e-4, integer leaves
  exact), and the paged decode against the port's own forward
  (``tests/test_serving.py``'s tolerances);
* ``SMCDecoder`` on deepseek's smoke config on replayed draws
  (``tests/test_torch_smc_decode.py``'s method);
* the leaf-by-leaf drawing bit-equal to ``cast_matrices(lm.init(...))``,
  and the router kept in float32.

A ``cuda`` test holds the paged-attention kernel at one query head per
KV head (deepseek's and musicgen's G = 1) and head dims 128 and 64
against its plain version.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch.core.config import CopyMode  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import LanguageModel, layer_params  # noqa: E402
from repro_torch.serving import kv_cache as tkv  # noqa: E402
from repro_torch.serving.engine import ServeEngine, cast_matrices, draw_cast_params  # noqa: E402
from repro_torch.serving.smc_decode import SMCDecoder  # noqa: E402
from test_torch_boundaries import paged_case, paged_check, to_device  # noqa: E402

try:  # the card's machine has no jax: only the cuda test runs there (-m cuda)
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import smoke_config as jsmoke_config
    from repro.core.config import CopyMode as JCopyMode
    from repro.models import moe as jmoe
    from repro.models.model import LanguageModel as JLanguageModel
    from repro.serving import kv_cache as jkv
    from repro.serving.engine import ServeEngine as JServeEngine
    from repro.serving.smc_decode import SMCDecoder as JSMCDecoder
    from test_torch_serving import same_cache
except ImportError:
    jax = None

MOE_ARCHS = ("deepseek_moe_16b", "phi35_moe_42b")
SERVED = ("deepseek_moe_16b", "phi35_moe_42b", "musicgen_large")
NEW_ARCHS = SERVED + ("qwen25_32b", "command_r_plus_104b")
TIE = 1e-5  # the smallest gap between the k-th and (k+1)-th gate the inputs may hold


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def close_to_scale(got, want, tol=1e-5):
    """Each value within ``tol`` times the largest |value| of ``want``: the
    products' float32 sums run in other orders, and their error follows
    the terms' size (outputs reach ~100 here), not each value's."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


_weights = {}


def weights(arch):
    """The reference's smoke parameters of ``arch`` (seed 0): the jax tree
    and the port's, from the same numbers."""
    if arch not in _weights:
        params, _ = JLanguageModel(jsmoke_config(arch)).init(jax.random.PRNGKey(0))
        np_params = jax.tree.map(np.asarray, params)
        _weights[arch] = params, np_params, convert.params_from_numpy(
            np_params, configs.smoke_config(arch), "cpu")
    return _weights[arch]


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_the_reference(arch):
    for mine, ref in ((configs.get_config(arch), jget_config(arch)),
                      (configs.smoke_config(arch), jsmoke_config(arch))):
        assert vars(mine) == vars(ref)
        assert (mine.hd, mine.padded_vocab) == (ref.hd, ref.padded_vocab)
        assert mine.param_count() == ref.param_count()
        assert mine.active_param_count() == ref.active_param_count()
    assert configs.get_config(jget_config(arch).name) == configs.get_config(arch)


def test_deepseek_config_reads_as_published():
    cfg = configs.get_config("deepseek-moe-16b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd) == (28, 2048, 16, 16, 128)
    assert (cfg.n_experts, cfg.top_k, cfg.n_shared_experts, cfg.expert_d_ff) == (64, 6, 2, 1408)
    assert cfg.first_layer_dense and not cfg.tie_embeddings and cfg.capacity_factor == 1.25
    assert LanguageModel(cfg)._dense_ff == 11264
    specs = LanguageModel(cfg).param_specs()
    assert specs["blocks/moe/experts/w_gate"] == (27, 64, 2048, 1408)
    assert sum(int(np.prod(s)) for s in specs.values()) == 16_377_694_208
    assert tmoe.moe_capacity(cfg, 32) == 8


@pytest.mark.parametrize("arch", SERVED + ("qwen25_32b",))
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_specs_match_the_reference(arch, size):
    get, jget = ((configs.smoke_config, jsmoke_config) if size == "smoke"
                 else (configs.get_config, jget_config))
    ref, _ = JLanguageModel(jget(arch)).abstract_init()
    want = {"/".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    assert LanguageModel(get(arch)).param_specs() == want


@pytest.mark.parametrize("arch", ["mamba2_130m", "gemma3_12b", "llama32_vision_90b", "zamba2_7b"])
def test_unported_families_still_raise(arch):
    """The paged engine still refuses the families the reference's engine
    refuses; they decode through ``LanguageModel``'s dense caches
    (``tests/test_torch_families.py``)."""
    cfg = configs.smoke_config(arch)
    assert vars(cfg) == vars(jsmoke_config(arch))
    lm = LanguageModel(cfg)
    ccfg = tkv.KVCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                             block_size=4, max_seqs=2, max_blocks_per_seq=2, num_blocks=4, dtype=cfg.dtype)
    with pytest.raises(NotImplementedError, match="dense-cache"):
        ServeEngine(lm, lm.init(torch.Generator().manual_seed(0), device="cpu"), ccfg, device="cpu")


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


def moe_inputs(arch, n_tok_shape, seed, *, skew=0.0):
    """Layer 1's MoE parameters of the smoke model (jax and port) and
    activations [B, S, D]; ``skew`` adds a shared direction to every token
    so the router favours a few experts (pairs then drop under capacity)."""
    _, np_params, tparams = weights(arch)
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]), np_params["blocks"]["moe"])
    tp = layer_params(tparams["blocks"], 1)["moe"]
    rng = np.random.default_rng(seed)
    d = configs.smoke_config(arch).d_model
    x = rng.standard_normal((*n_tok_shape, d)).astype(np.float32)
    x += skew * rng.standard_normal(d).astype(np.float32)
    return jp, tp, x


def reference_dispatch(monkeypatch, jp, x, cfg):
    """The reference's moe_layer output and every ``[E, cap, D]`` dispatch
    buffer it built (captured where it pins the buffer's sharding)."""
    seen = []
    orig = jmoe.constrain

    def capture(a, axes):
        seen.append(np.asarray(a))
        return orig(a, axes)

    monkeypatch.setattr(jmoe, "constrain", capture)
    out = jmoe.moe_layer(jp, jnp.asarray(x), cfg)
    return np.asarray(out), seen


def port_dispatch(monkeypatch, tp, x, cfg):
    """The port's moe_layer output, every dispatch buffer and routing."""
    seen, routes = [], []
    orig_dispatch, orig_route = tmoe.dispatch, tmoe.route

    def capture(tokens, r, n_experts):
        buf, eid, slot = orig_dispatch(tokens, r, n_experts)
        seen.append(buf.numpy().copy())
        return buf, eid, slot

    def capture_route(router, tokens, c):
        routes.append(orig_route(router, tokens, c))
        return routes[-1]

    monkeypatch.setattr(tmoe, "dispatch", capture)
    monkeypatch.setattr(tmoe, "route", capture_route)
    out = tmoe.moe_layer(tp, torch.as_tensor(x), cfg)
    return out.numpy(), seen, routes


def smallest_tie_gap(routes, k):
    gaps = []
    for r in routes:
        top = torch.topk(r.gates, k + 1, dim=-1).values
        gaps.append((top[:, k - 1] - top[:, k]).min().item())
    return min(gaps)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("capacity", [8.0, 1.25])
def test_moe_layer_matches_reference(monkeypatch, arch, capacity):
    cfg = configs.smoke_config(arch).scaled(capacity_factor=capacity)
    jcfg = jsmoke_config(arch).scaled(capacity_factor=capacity)
    jp, tp, x = moe_inputs(arch, (2, 24), seed=11, skew=2.0)
    want, jbufs = reference_dispatch(monkeypatch, jp, x, jcfg)
    got, tbufs, routes = port_dispatch(monkeypatch, tp, x, cfg)
    assert smallest_tie_gap(routes, cfg.top_k) > TIE
    assert len(jbufs) == len(tbufs) == 1
    np.testing.assert_array_equal(tbufs[0], jbufs[0])  # ids, positions, keep: bit-exact
    close_to_scale(got, want)
    dropped = int((~routes[0].keep).sum())
    if capacity == 1.25:
        assert dropped > 0  # the capacity path really drops pairs
        assert not bool(routes[0].top_w[~routes[0].keep].any())
    else:
        assert dropped == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_chunked_routing_matches_reference(monkeypatch, arch):
    """``moe_route_chunk=7`` over 28 tokens: four chunks, each with its own
    capacity, as the reference's ``lax.scan`` routes them."""
    cfg = configs.smoke_config(arch).scaled(moe_route_chunk=7, capacity_factor=1.25)
    jcfg = jsmoke_config(arch).scaled(moe_route_chunk=7, capacity_factor=1.25)
    jp, tp, x = moe_inputs(arch, (2, 14), seed=12, skew=2.0)
    want = np.asarray(jmoe.moe_layer(jp, jnp.asarray(x), jcfg))
    got, tbufs, routes = port_dispatch(monkeypatch, tp, x, cfg)
    assert len(routes) == 4 and all(r.gates.shape[0] == 7 for r in routes)
    assert smallest_tie_gap(routes, cfg.top_k) > TIE
    close_to_scale(got, want)
    # Chunked equals routing each chunk alone.
    flat = x.reshape(4, 7, -1)
    for c in range(4):
        alone = np.asarray(jmoe.moe_layer(jp, jnp.asarray(flat[c][None]), jcfg))
        close_to_scale(got.reshape(4, 7, -1)[c], alone[0])


def test_routing_positions_are_the_reference_cumsum():
    """Each pair's place in its expert's queue counts the earlier pairs
    (row-major over (token, k)) routed to that expert."""
    cfg = configs.smoke_config("deepseek_moe_16b").scaled(capacity_factor=0.5)
    rng = np.random.default_rng(5)
    router = torch.as_tensor(rng.standard_normal((cfg.d_model, cfg.n_experts)).astype(np.float32))
    tokens = torch.as_tensor(rng.standard_normal((40, cfg.d_model)).astype(np.float32) + 1.5)
    r = tmoe.route(router, tokens, cfg)
    flat_e = r.top_e.reshape(-1).tolist()
    want = [flat_e[:i].count(e) for i, e in enumerate(flat_e)]
    assert r.pos.reshape(-1).tolist() == want
    assert torch.equal(r.keep, r.pos < r.cap) and r.cap == tmoe.moe_capacity(cfg, 40)
    assert r.pos.dtype == torch.int32 and not bool(r.keep.all())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", SERVED)
def test_forward_matches_reference(arch):
    jparams, _, tparams = weights(arch)
    tokens = np.random.default_rng(3).integers(0, jsmoke_config(arch).vocab_size, (2, 20)).astype(np.int32)
    want = JLanguageModel(jsmoke_config(arch)).forward(jparams, jnp.asarray(tokens))
    got = LanguageModel(configs.smoke_config(arch)).forward(tparams, torch.as_tensor(tokens))
    assert got.shape == want.shape and got.dtype == torch.float32
    close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "musicgen_large"])
def test_draw_cast_params_is_bit_equal_to_cast_after_init(arch):
    for cfg in (configs.smoke_config(arch), configs.smoke_config(arch).scaled(dtype="bfloat16")):
        lm = LanguageModel(cfg)
        want = cast_matrices(lm.init(torch.Generator().manual_seed(4), device="cpu"),
                             getattr(torch, cfg.dtype), torch.device("cpu"))
        got = draw_cast_params(lm, torch.Generator().manual_seed(4), device="cpu")
        flat_w = convert_flat(want)
        flat_g = convert_flat(got)
        assert flat_g.keys() == flat_w.keys() == lm.param_specs().keys()
        for path, leaf in flat_w.items():
            assert flat_g[path].dtype == leaf.dtype and torch.equal(flat_g[path], leaf), path


def convert_flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(convert_flat(leaf, f"{prefix}{name}/"))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


def test_cast_matrices_keeps_the_router_in_f32():
    cfg = configs.smoke_config("deepseek_moe_16b").scaled(dtype="bfloat16")
    lm = LanguageModel(cfg)
    flat = convert_flat(cast_matrices(lm.init(torch.Generator().manual_seed(0), device="cpu"),
                                      torch.bfloat16, torch.device("cpu")))
    f32 = {p for p, leaf in flat.items() if leaf.dtype == torch.float32}
    assert f32 == {"embed", "unembed", "final_norm/scale", "blocks/ln1/scale", "blocks/ln2/scale",
                   "blocks/moe/router", "block0/ln1/scale", "block0/ln2/scale"}
    assert flat["block0/mlp/w_gate"].dtype == torch.bfloat16
    assert flat["blocks/moe/experts/w_down"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def engines(arch, delta_cow, **overrides):
    jparams, _, tparams = weights(arch)
    cfg = configs.smoke_config(arch)
    kw = dict(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
              block_size=4, max_seqs=8, max_blocks_per_seq=12, num_blocks=60,
              dtype="float32", delta_cow=delta_cow)
    kw.update(overrides)
    je = JServeEngine(JLanguageModel(jsmoke_config(arch)), jparams, jkv.KVCacheConfig(**kw))
    te = ServeEngine(LanguageModel(cfg), tparams, tkv.KVCacheConfig(**kw), device="cpu")
    return je, te


def to_reference_cache(cache, like):
    """A port ``PagedKVCache`` as the reference's (jax leaves), typed as
    ``like``."""
    np_cache = convert.kv_cache_to_numpy(cache)
    pool_t = type(like.pool)
    pool = pool_t(**{f: jnp.asarray(getattr(np_cache.pool, f)) for f in pool_t._fields})
    return type(like)(pool=pool, tables=jnp.asarray(np_cache.tables),
                      lengths=jnp.asarray(np_cache.lengths))


def port_prefill(arch, tccfg):
    """A stand-in for the reference engine's jitted ``_prefill`` that runs
    the port's on the same cache state and hands the result back in the
    reference's types.  The reference's own ``_prefill`` cannot prefill a
    model with a dense layer 0 (``test_reference_prefill_fails_on_block0``);
    the port's prefill is held against the reference's forward and its
    dense-cache ``LanguageModel.prefill`` in ``test_engine_matches_reference``."""
    from repro_torch.serving import engine as tengine

    _, _, tparams = weights(arch)
    cfg = configs.smoke_config(arch)

    def run(_params, cache, tokens, seq_ids):
        tcache = convert.kv_cache_from_numpy(jax.tree.map(np.asarray, cache), "cpu")
        logits, tcache = tengine._prefill(cfg, tccfg, tparams, tcache,
                                          torch.as_tensor(np.array(tokens)),
                                          torch.as_tensor(np.array(seq_ids)))
        return jnp.asarray(logits.numpy()), to_reference_cache(tcache, cache)

    return run


def test_reference_prefill_fails_on_block0():
    """The reference's ``ServeEngine._prefill`` tests the family, not the
    layer, and asks deepseek's dense layer 0 for its ``moe`` parameters
    (``src/repro/serving/engine.py:247-249``).  If this stops failing, the
    stand-in of ``port_prefill`` can go."""
    je, _ = engines("deepseek_moe_16b", False)
    with pytest.raises(KeyError, match="moe"):
        je.prefill(jnp.zeros((1, 5), jnp.int32), jnp.zeros((1,), jnp.int32))


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("delta_cow", [False, True])
def test_engine_matches_reference(arch, delta_cow):
    """Prefill two 10-token prompts, fork to eight rows, decode eight
    tokens with a re-fork at four, compact, decode once more; logits and
    the cache compared after every step.  For deepseek the reference's
    engine cannot prefill (``test_reference_prefill_fails_on_block0``):
    the port's prefill is held against the reference's forward (logits)
    and its dense-cache ``LanguageModel.prefill`` (every layer's K/V, layer
    0 the dense one), and the reference's engine decodes on from the
    port's cache."""
    je, te = engines(arch, delta_cow)
    jcfg = jsmoke_config(arch)
    vocab = jcfg.vocab_size
    rng = np.random.default_rng(21)
    prompts = rng.integers(0, vocab, (2, 10)).astype(np.int32)
    ids = np.array([0, 1], np.int32)
    tol = dict(rtol=1e-4, atol=1e-4)
    got = te.prefill(torch.as_tensor(prompts), torch.as_tensor(ids)).numpy()
    if LanguageModel(te.lm.cfg).has_block0:
        jlm = JLanguageModel(jcfg)
        jparams = weights(arch)[0]
        np.testing.assert_allclose(got, np.asarray(jlm.forward(jparams, jnp.asarray(prompts)))[:, -1], **tol)
        _, dense = jlm.prefill(jparams, jnp.asarray(prompts), 12)
        bs = te.cache_cfg.block_size
        for b in range(2):
            pages = te.cache.tables[b, :3].long()
            kv = te.cache.pool.data[pages]  # [3, L, 2, bs, KVH, hd]
            kv = kv.permute(1, 2, 0, 3, 4, 5).reshape(jcfg.n_layers, 2, 3 * bs, jcfg.n_kv_heads, -1)
            for i, want in enumerate((dense.k, dense.v)):
                np.testing.assert_allclose(kv[:, i, :10].numpy(), np.asarray(want)[:, b, :10], **tol)
        je.cache = to_reference_cache(te.cache, je.cache)
    else:
        np.testing.assert_allclose(got, np.asarray(je.prefill(jnp.asarray(prompts), jnp.asarray(ids))), **tol)
    same_cache(je.cache, te.cache, data_tol=1e-4)
    anc = np.array([0, 0, 0, 0, 1, 1, 1, 1], np.int32)
    je.fork(jnp.asarray(anc))
    te.fork(torch.as_tensor(anc))
    for step in range(9):
        if step == 4:
            anc = rng.integers(0, 8, 8).astype(np.int32)
            je.fork(jnp.asarray(anc))
            te.fork(torch.as_tensor(anc))
        if step == 8:
            je.compact_cache()
            te.compact_cache()
        tokens = rng.integers(0, vocab, (8, 1)).astype(np.int32)
        np.testing.assert_allclose(te.decode(torch.as_tensor(tokens)).numpy(),
                                   np.asarray(je.decode(jnp.asarray(tokens))), **tol)
        same_cache(je.cache, te.cache, data_tol=1e-4)
    assert not te.oom
    assert te.used_blocks == je.used_blocks
    if delta_cow:
        assert (te.cache.pool.parent >= 0).any()


@pytest.mark.parametrize("arch", SERVED + ("qwen25_32b",))
def test_paged_decode_matches_forward(arch):
    """``tests/test_serving.py::test_paged_decode_matches_forward`` on the
    port: prefill then three decode steps against the port's own forward
    over the whole sequence."""
    cfg = configs.smoke_config(arch)
    lm = LanguageModel(cfg)
    params = lm.init(torch.Generator().manual_seed(1), device="cpu")
    b, s, extra = 2, 12, 3
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (b, s + extra)))
    full = lm.forward(params, tokens)
    ccfg = tkv.KVCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                             max_seqs=b, max_blocks_per_seq=4, dtype=cfg.dtype, num_blocks=16)
    eng = ServeEngine(lm, params, ccfg, device="cpu")
    lg = eng.prefill(tokens[:, :s], torch.arange(b, dtype=torch.int32))
    close(lg, full[:, s - 1], 1e-4)
    for i in range(extra):
        lg = eng.decode(tokens[:, s + i : s + i + 1])
        np.testing.assert_allclose(lg.numpy(), full[:, s + i].numpy(), rtol=1e-3, atol=2e-4,
                                   err_msg=f"{arch} step {i}")


def test_smc_decoder_on_deepseek_matches_reference():
    """``SMCDecoder.run`` on deepseek's smoke config: 8 particles, 10
    tokens, the reference's uniforms replayed into the port; tokens,
    resampling steps and page counts equal, floats to rtol 1e-5.  The
    reference's prompt prefill is the port's (``port_prefill``); every
    decode step, weight, resample and fork is the reference's own."""
    arch = "deepseek_moe_16b"
    jcfg, cfg = jsmoke_config(arch), configs.smoke_config(arch)
    jparams, _, tparams = weights(arch)
    n, steps, key = 8, 10, jax.random.PRNGKey(7)
    p = np.random.default_rng(8).integers(0, cfg.vocab_size, 6).astype(np.int32)
    kw = dict(max_len=40, block_size=4, target_temp=1.0, proposal_temp=4.0)
    jdec = JSMCDecoder(JLanguageModel(jcfg), jparams, n, token_copy_mode=JCopyMode.LAZY_SR, **kw)
    jdec.engine._prefill = port_prefill(arch, tkv.KVCacheConfig(**vars(jdec.engine.cache_cfg)))
    want = jdec.run(key, jnp.asarray(p), steps)
    assert np.asarray(want.resampled).any()  # the fork path runs
    tiny = np.finfo(np.float32).tiny
    draws, k = [], key
    for t in range(steps):
        k, k_samp, k_res = jax.random.split(k, 3)
        draws.append(("uniform", np.asarray(
            jax.random.uniform(k_samp, (n, cfg.padded_vocab), minval=tiny, maxval=1.0))))
        if np.asarray(want.resampled)[t]:
            draws.append(("uniform", np.asarray(jax.random.uniform(k_res))))
    dec = SMCDecoder(LanguageModel(cfg), tparams, n, token_copy_mode=CopyMode.LAZY_SR,
                     device="cpu", **kw)
    got = dec.run(rnd.Replay(draws), torch.as_tensor(p), steps)
    for f in ("tokens", "resampled", "used_blocks_trace"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    for f in ("ess_trace", "log_weights", "log_evidence"):
        np.testing.assert_allclose(np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
                                   rtol=1e-5, atol=0, err_msg=f)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("heads,d", [(16, 128), (32, 64)])
def test_paged_attention_one_head_per_kv_head_on_card(heads, d, delta, dtype):
    """The paged kernel at G = 1 (16 heads of 128 over 16 KV heads,
    deepseek; 32 of 64 over 32, musicgen) against its plain version: 32
    rows of up to 34 pages of 16, NULL pages, a zero-length row, delta
    pages over shared parents."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU route")
    q, data, _, tables, lengths, parent, dirty = paged_case(
        d, dtype, rows=160, layers=1, kvh=heads, d=d, h=heads, b=32, nb=34)
    q, data, tables, lengths, parent, dirty = to_device(
        torch.device("cuda"), q, data, tables, lengths, parent, dirty)
    kw = dict(parent=parent, dirty=dirty) if delta else {}
    args = (q, data[:, 0, 0], data[:, 0, 1], tables, lengths)
    got = paged_attention(*args, **kw)
    paged_check(got, paged_attention_ref(*args, **kw), dtype)
    assert torch.equal(got, paged_attention(*args, **kw))
