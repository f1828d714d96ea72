"""The port's model layers against the JAX reference, on the CPU.

At starcoder2-3b's smoke width (3 layers, d_model 96, 6 heads over 2 KV
heads), the same numpy inputs and the same weights go through
``repro.models`` and ``repro_torch.models``.  Float32 throughout; the two
frameworks sum and take transcendentals in other orders, so values agree
to stated tolerances (1e-5 for elementwise layers, 1e-4 for layers with
matrix products).
"""

from __future__ import annotations

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.starcoder2_3b import CONFIG as JCONFIG  # noqa: E402
from repro.configs.starcoder2_3b import SMOKE as JSMOKE  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import LanguageModel as JLanguageModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs.starcoder2_3b import CONFIG, SMOKE  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import LanguageModel, layer_params  # noqa: E402


def t(x):
    return torch.as_tensor(np.array(x))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def ref_params():
    params, _ = JLanguageModel(JSMOKE).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def test_configs_match_the_reference():
    for mine, ref in ((CONFIG, JCONFIG), (SMOKE, JSMOKE)):
        assert vars(mine) == vars(ref)
        assert (mine.hd, mine.padded_vocab) == (ref.hd, ref.padded_vocab)
    assert configs.get_config("starcoder2-3b") == CONFIG
    assert configs.smoke_config("starcoder2_3b") == SMOKE
    assert CONFIG.scaled(n_layers=2).n_layers == 2
    with pytest.raises(NotImplementedError, match="queue 1"):
        configs.get_config("qwen25_32b")
    with pytest.raises(NotImplementedError, match="item 6"):
        LanguageModel(CONFIG.scaled(family="moe"))


def test_rms_norm_gelu_and_rope():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 6, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    close(tlayers.rms_norm(t(x), t(w), 1e-5), jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-5)
    close(tlayers.act_fn("gelu")(t(x)), jlayers.act_fn("gelu")(jnp.asarray(x)), 1e-6)
    close(tlayers.act_fn("silu")(t(x)), jlayers.act_fn("silu")(jnp.asarray(x)), 1e-6)
    pos = rng.integers(0, 600, (2, 7)).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), SMOKE.rope_theta)
    close(tlayers.apply_rope(t(x), t(pos), SMOKE.rope_theta), want, 1e-5)


def test_rms_norm_scales_by_one_plus_weight_in_f32():
    x = torch.full((1, 4), 2.0, dtype=torch.bfloat16)
    out = tlayers.rms_norm(x, torch.zeros(4))
    assert out.dtype == torch.bfloat16 and torch.equal(out.float(), torch.ones(1, 4))
    assert torch.allclose(tlayers.rms_norm(x.float(), torch.ones(4)), torch.full((1, 4), 2.0))


@pytest.mark.parametrize("gated", [False, True])
def test_mlp(gated):
    rng = np.random.default_rng(1)
    p = {
        "w_up": rng.standard_normal((96, 192)).astype(np.float32) / 10,
        "w_down": rng.standard_normal((192, 96)).astype(np.float32) / 14,
    }
    if gated:
        p["w_gate"] = rng.standard_normal((96, 192)).astype(np.float32) / 10
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), "gelu")
    close(tlayers.mlp({k: t(v) for k, v in p.items()}, t(x), "gelu"), want, 1e-4)


@pytest.mark.parametrize("seq", [40, 512])
def test_attention_train(ref_params, seq):
    tp = params_from_numpy(ref_params, SMOKE, "cpu")
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, SMOKE.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq))
    jp = jax.tree.map(lambda a: jnp.asarray(a[1]), ref_params["blocks"]["attn"])
    want = jattn.attention_train(jp, jnp.asarray(x), JSMOKE, jnp.asarray(pos))
    got = tattn.attention_train(layer_params(tp["blocks"], 1)["attn"], t(x), SMOKE, t(pos))
    close(got, want, 1e-4)


def test_attention_chunked_keeps_the_chunk_assertion():
    q = torch.zeros(1, 520, 6, 16)
    k = torch.zeros(1, 520, 2, 16)
    pos = torch.arange(520)[None]
    with pytest.raises(AssertionError):
        tattn.attention_chunked(q, k, k, pos, pos)


def test_params_from_numpy_maps_every_leaf(ref_params):
    tp = params_from_numpy(ref_params, SMOKE, "cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(ref_params)
    specs = LanguageModel(SMOKE).param_specs()
    assert len(ref_leaves) == len(specs)
    for path, leaf in ref_leaves:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), leaf)
    broken = dict(ref_params, final_norm={})
    with pytest.raises(ValueError, match="differ"):
        params_from_numpy(broken, SMOKE, "cpu")
    wrong = dict(ref_params, embed=ref_params["embed"][:, :10])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(wrong, SMOKE, "cpu")


def test_init_follows_the_reference_law():
    """Normal with std 1/sqrt(fan-in) (first dimension of the per-layer
    shape; the embedding at scale 1), norm scales zero, f32, the same tree;
    reproducible from the generator's seed."""
    cfg = SMOKE.scaled(n_layers=4, d_model=192, d_ff=384)
    lm = LanguageModel(cfg)
    gen = torch.Generator().manual_seed(0)
    params = lm.init(gen, device="cpu")
    again = lm.init(torch.Generator().manual_seed(0), device="cpu")
    specs = lm.param_specs()
    stds = {
        "embed": 1.0,
        "blocks/attn/wq": 1 / math.sqrt(cfg.d_model),
        "blocks/attn/wo": 1 / math.sqrt(cfg.n_heads),
        "blocks/mlp/w_down": 1 / math.sqrt(cfg.d_ff),
    }
    for path, shape in specs.items():
        leaf = params
        other = again
        for key in path.split("/"):
            leaf, other = leaf[key], other[key]
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.float32
        assert torch.equal(leaf, other)
        if path.endswith("scale"):
            assert not leaf.any()
        if path in stds:
            assert abs(leaf.std().item() / stds[path] - 1) < 0.05, path
    assert specs["blocks/attn/wo"] == (cfg.n_layers, cfg.n_heads, cfg.hd, cfg.d_model)
