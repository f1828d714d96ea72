"""The port's model families on the dense decode caches against the JAX
reference, on the CPU.

At the smoke configs of mamba2-130m (ssm), zamba2-7b (hybrid: 6 SSM
layers, the shared attention block after layers 2 and 5), gemma3-12b
(local_global: 2 units of 2 local layers of window 8 and a global one),
llama-3.2-vision-90b (vlm: one unit of 4 self blocks, an anchor and a
cross-attention to 16 image tokens), starcoder2-3b (dense) and
deepseek-moe-16b (moe, with its dense layer 0), the same numpy inputs and
the same weights (``convert.params_from_numpy`` of the reference's
``init``) go through ``repro`` and ``repro_torch``:

* the configs field for field, the registry by module name and canonical
  id, the parameter specs against the reference's tree (smoke and full);
* ``forward`` and ``loss``; ``prefill``'s logits and every leaf of its
  ``DecodeCache``; three ``decode_step``s, logits and every cache leaf
  after each: float32 values to 1e-5 of the largest |value| (the two
  frameworks sum in other orders; the readings lie below 2e-6), integer
  leaves and the image features equal;
* the reference's own contract (``tests/test_models.py``), on the port:
  ``prefill``'s logits equal ``forward``'s (here bit for bit: one code
  path), and each decode step equals ``forward`` at its position (rtol
  1e-3, atol 2e-4, the reference's tolerances);
* gemma3's ring cache at prompts of 5, 8 and 13 tokens (below, at and
  above the window of 8), each followed by 4 decode steps;
* ``attention_decode`` (with and without a window) and
  ``cross_attention`` on their own;
* ``serving.engine.is_cast_leaf`` on every family's tree: the norm
  scales, the router and the SSM's ``a_log``, ``dt_bias``, ``d_skip`` and
  ``norm_scale`` stay float32, hybrid's ``shared_attn`` matrices are cast.

``dense_cache_card_against_cpu`` runs here with both sides on the CPU
(they must agree exactly); its ``cuda`` tests run it on the card, with
``flash_attention`` at the smoke widths' head dims 16 and 32 (f32).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import DecodeCache, LanguageModel, layer_params  # noqa: E402
from repro_torch.serving import crosscheck as cc  # noqa: E402
from repro_torch.serving.engine import F32_LEAVES, cast_matrices, draw_cast_params, is_cast_leaf  # noqa: E402
from test_torch_boundaries import check_flash  # noqa: E402

try:  # the card's machine has no jax: only the cuda tests run there (-m cuda)
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.configs import smoke_config as jsmoke_config
    from repro.models import attention as jattn
    from repro.models.model import LanguageModel as JLanguageModel
except ImportError:
    jax = None

NEW_ARCHS = ("mamba2_130m", "zamba2_7b", "gemma3_12b", "llama32_vision_90b")
ARCHS = NEW_ARCHS + ("starcoder2_3b", "deepseek_moe_16b")
CANONICAL = {"mamba2_130m": "mamba2-130m", "zamba2_7b": "zamba2-7b", "gemma3_12b": "gemma3-12b",
             "llama32_vision_90b": "llama-3.2-vision-90b"}
B, PROMPT, STEPS = 2, 13, 3
reference = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


def close_to_scale(got, want, tol=1e-5):
    """Each value within ``tol`` times the largest |value| of ``want``."""
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max() if want.size else 0.0
    got = got.float() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol * scale)


def flat(tree, prefix=""):
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out.update(flat(leaf, f"{prefix}{name}/"))
        else:
            out[f"{prefix}{name}"] = leaf
    return out


class Case:
    """One arch's smoke model on both sides: weights, tokens, image
    features, and the reference's jitted entry points."""

    def __init__(self, arch):
        self.arch = arch
        self.cfg = configs.smoke_config(arch)
        self.lm = LanguageModel(self.cfg)
        self.jlm = JLanguageModel(jsmoke_config(arch))
        params, _ = self.jlm.init(jax.random.PRNGKey(0))
        self.jparams = params
        self.tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params), self.cfg, "cpu")
        rng = np.random.default_rng(21)
        self.tokens = rng.integers(0, self.cfg.vocab_size, (B, PROMPT + STEPS)).astype(np.int32)
        self.img = None
        if self.cfg.family == "vlm":
            self.img = rng.standard_normal((B, self.cfg.n_img_tokens, self.cfg.d_model)).astype(np.float32)
        self.j_forward = jax.jit(self.jlm.forward)
        self.j_prefill = jax.jit(self.jlm.prefill, static_argnums=2)
        self.j_step = jax.jit(self.jlm.decode_step)

    def jimg(self):
        return None if self.img is None else jnp.asarray(self.img)

    def timg(self):
        return None if self.img is None else torch.as_tensor(self.img)

    def reference_forward(self, tokens):
        return np.asarray(self.j_forward(self.jparams, jnp.asarray(tokens), self.jimg()))

    def forward(self, tokens):
        return self.lm.forward(self.tparams, torch.as_tensor(tokens), self.timg())


_cases = {}


def case(arch) -> Case:
    if arch not in _cases:
        _cases[arch] = Case(arch)
    return _cases[arch]


def same_cache(got: DecodeCache, want, tol=1e-5):
    """Every leaf of the port's cache against the reference's: float32 to
    ``tol`` of the leaf's largest |value|, the positions and the image
    features equal."""
    for field in DecodeCache._fields:
        g, w = getattr(got, field), np.asarray(getattr(want, field))
        assert tuple(g.shape) == w.shape, (field, tuple(g.shape), w.shape)
        if field in ("position", "img_feats"):
            if g.is_floating_point():
                g, w = g.float(), w.astype(np.float32)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
        else:
            close_to_scale(g, w, tol)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@reference
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_the_reference(arch):
    for mine, ref in ((configs.get_config(arch), jget_config(arch)),
                      (configs.smoke_config(arch), jsmoke_config(arch))):
        assert vars(mine) == vars(ref)
        assert (mine.hd, mine.padded_vocab, mine.d_inner, mine.n_ssm_heads) == (
            ref.hd, ref.padded_vocab, ref.d_inner, ref.n_ssm_heads)
        assert mine.param_count() == ref.param_count()
    assert configs.get_config(CANONICAL[arch]) == configs.get_config(arch)
    assert configs.get_config(jget_config(arch).name) == configs.get_config(arch)


@reference
@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_specs_match_the_reference(arch, size):
    get, jget = ((configs.smoke_config, jsmoke_config) if size == "smoke"
                 else (configs.get_config, jget_config))
    ref, _ = JLanguageModel(jget(arch)).abstract_init()
    want = {"/".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    assert LanguageModel(get(arch)).param_specs() == want


def test_full_widths_read_as_published():
    z = configs.get_config("zamba2-7b")
    assert (z.n_layers, z.d_model, z.hd, z.n_ssm_heads, z.ssm_head_dim, z.ssm_state) == (81, 3584, 112, 112, 64, 64)
    assert z.n_layers // z.attn_every == 13
    m = configs.get_config("mamba2-130m")
    assert (m.n_layers, m.d_inner, m.n_ssm_heads, m.ssm_state, m.padded_vocab) == (24, 1536, 24, 128, 50432)
    g = configs.get_config("gemma3-12b")
    assert (g.n_layers, g.hd, g.n_heads, g.n_kv_heads, g.window, g.local_ratio) == (48, 256, 16, 8, 1024, 5)
    v = configs.get_config("llama-3.2-vision-90b")
    assert (v.n_layers, v.hd, v.n_heads, v.n_kv_heads, v.cross_every, v.n_img_tokens) == (100, 128, 64, 8, 5, 1024)
    cut = LanguageModel(v.scaled(n_layers=20)).param_specs()
    assert cut["blocks/self0/attn/wq"][0] == 4  # 20 layers are 4 units


def test_unknown_arch_raises():
    with pytest.raises(ValueError, match="unknown architecture"):
        configs.get_config("gpt-5")
    with pytest.raises(ValueError, match="unknown architecture"):
        configs.smoke_config("mamba3_130m")


# ---------------------------------------------------------------------------
# forward, loss, prefill and decode against the reference
# ---------------------------------------------------------------------------


@reference
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    c = case(arch)
    got = c.forward(c.tokens)
    want = c.reference_forward(c.tokens)
    assert got.shape == want.shape == (B, PROMPT + STEPS, c.cfg.padded_vocab) and got.dtype == torch.float32
    close_to_scale(got, want)


@reference
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch):
    c = case(arch)
    labels = np.roll(c.tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :3] = -1
    want, wm = c.jlm.loss(c.jparams, jnp.asarray(c.tokens), jnp.asarray(labels), c.jimg())
    got, gm = c.lm.loss(c.tparams, torch.as_tensor(c.tokens), torch.as_tensor(labels), c.timg())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert gm["tokens"].item() == int(wm["tokens"]) == B * (PROMPT + STEPS) - B - 3
    np.testing.assert_allclose(gm["accuracy"].item(), float(wm["accuracy"]), rtol=1e-6)


@reference
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 13 tokens into caches of 16, then three decode steps; logits
    and every cache leaf after each."""
    c = case(arch)
    max_len = PROMPT + STEPS
    want, jcache = c.j_prefill(c.jparams, jnp.asarray(c.tokens[:, :PROMPT]), max_len, c.jimg())
    got, tcache = c.lm.prefill(c.tparams, torch.as_tensor(c.tokens[:, :PROMPT]), max_len, c.timg())
    close_to_scale(got, want)
    same_cache(tcache, jcache)
    for i in range(STEPS):
        tok = c.tokens[:, PROMPT + i : PROMPT + i + 1]
        want, jcache = c.j_step(c.jparams, jnp.asarray(tok), jcache)
        got, tcache = c.lm.decode_step(c.tparams, torch.as_tensor(tok), tcache)
        assert got.shape == (B, c.cfg.padded_vocab)
        close_to_scale(got, want)
        same_cache(tcache, jcache)
    assert tcache.position.tolist() == [max_len] * B


# The SSM families in bf16 activations: each package's bf16 rounding
# lands at other points (XLA's fused ops against PyTorch's), so the two
# part by ~1-2.5e-2 of the largest |logit| after a 13-token prefill
# (scripts/torch_bf16_decode_gap.py), and each drifts from its own forward
# by ~1-1.5e-2.
BF16_TOL = 5e-2


@reference
@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_7b"])
def test_bf16_prefill_and_decode_match_reference(arch):
    """Both packages' prefill and three decode steps at bf16 activations
    on the same float32 weights: logits and every cache leaf within
    BF16_TOL of the reference's scale, and the port's decode no further
    from its own forward than twice the reference's is from its own."""
    cfg = configs.smoke_config(arch).scaled(dtype="bfloat16")
    jlm, lm = JLanguageModel(jsmoke_config(arch).scaled(dtype="bfloat16")), LanguageModel(cfg)
    c = case(arch)
    tokens, max_len = c.tokens, PROMPT + STEPS
    jfull = np.asarray(jax.jit(jlm.forward)(c.jparams, jnp.asarray(tokens), None), np.float32)
    tfull = lm.forward(c.tparams, torch.as_tensor(tokens))
    want, jcache = jax.jit(jlm.prefill, static_argnums=2)(c.jparams, jnp.asarray(tokens[:, :PROMPT]), max_len, None)
    got, tcache = lm.prefill(c.tparams, torch.as_tensor(tokens[:, :PROMPT]), max_len)
    close_to_scale(got, want, BF16_TOL)
    same_cache(tcache, jcache, BF16_TOL)
    assert tcache.ssm_conv.dtype == torch.bfloat16 and tcache.ssm_state.dtype == torch.float32
    step = jax.jit(jlm.decode_step)
    gap = {"reference": 0.0, "port": 0.0}
    for i in range(STEPS):
        tok = tokens[:, PROMPT + i : PROMPT + i + 1]
        want, jcache = step(c.jparams, jnp.asarray(tok), jcache)
        got, tcache = lm.decode_step(c.tparams, torch.as_tensor(tok), tcache)
        assert got.dtype == torch.float32
        close_to_scale(got, want, BF16_TOL)
        same_cache(tcache, jcache, BF16_TOL)
        jf, tf = jfull[:, PROMPT + i], tfull[:, PROMPT + i].numpy()
        gap["reference"] = max(gap["reference"], np.abs(np.asarray(want, np.float32) - jf).max() / np.abs(jf).max())
        gap["port"] = max(gap["port"], np.abs(got.numpy() - tf).max() / np.abs(tf).max())
    assert 0 < gap["port"] <= 2 * gap["reference"], gap


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_forward(arch):
    """The reference's contract (``tests/test_models.py``) on the port
    alone: prefill's logits are forward's (bit for bit: the same pass), and
    decode at every position equals the forward there."""
    cfg = configs.smoke_config(arch)
    lm = LanguageModel(cfg)
    params = lm.init(torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(4)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, 16)))
    img = None
    if cfg.family == "vlm":
        img = torch.as_tensor(rng.standard_normal((B, cfg.n_img_tokens, cfg.d_model)), dtype=torch.float32)
    full = lm.forward(params, tokens, img)
    prompt = 16 - STEPS
    logits, cache = lm.prefill(params, tokens[:, :prompt], 16, img)
    assert torch.equal(logits, lm.forward(params, tokens[:, :prompt], img))
    torch.testing.assert_close(logits, full[:, :prompt], rtol=1e-4, atol=1e-4)
    for i in range(STEPS):
        lg, cache = lm.decode_step(params, tokens[:, prompt + i : prompt + i + 1], cache)
        torch.testing.assert_close(lg, full[:, prompt + i], rtol=1e-3, atol=2e-4)


@reference
@pytest.mark.parametrize("prompt", [5, 8, 13])
def test_ring_cache_around_the_window(prompt):
    """gemma3's local layers (window 8): a prompt shorter than, equal to
    and longer than the window, then four steps, each wrapping further."""
    c = case("gemma3_12b")
    assert c.cfg.window == 8
    tokens = np.random.default_rng(prompt).integers(0, c.cfg.vocab_size, (B, prompt + 4)).astype(np.int32)
    want, jcache = c.j_prefill(c.jparams, jnp.asarray(tokens[:, :prompt]), prompt + 4, None)
    got, tcache = c.lm.prefill(c.tparams, torch.as_tensor(tokens[:, :prompt]), prompt + 4)
    same_cache(tcache, jcache)
    full = c.reference_forward(tokens)
    for i in range(4):
        tok = tokens[:, prompt + i : prompt + i + 1]
        want, jcache = c.j_step(c.jparams, jnp.asarray(tok), jcache)
        got, tcache = c.lm.decode_step(c.tparams, torch.as_tensor(tok), tcache)
        close_to_scale(got, want)
        same_cache(tcache, jcache)
        np.testing.assert_allclose(got.numpy(), full[:, prompt + i], rtol=1e-3, atol=2e-4)


@reference
@pytest.mark.parametrize("window", [0, 5])
def test_attention_decode_matches_reference(window):
    """One token at per-row positions 3 and 9 against a cache of 12
    (entries past the position hold garbage the mask must hide)."""
    c = case("gemma3_12b")
    cfg = c.cfg
    p = layer_params(c.tparams["blocks"], 0)["global"]["attn"]
    jp = jax.tree.map(lambda a: a[0], c.jparams["blocks"]["global"]["attn"])
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kc = rng.standard_normal((2, 12, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    vc = rng.standard_normal((2, 12, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    pos = np.array([3, 9], np.int32)
    want = jattn.attention_decode(jp, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(pos),
                                  jsmoke_config("gemma3_12b"), window=window)
    got = tattn.attention_decode(p, torch.as_tensor(x), torch.as_tensor(kc), torch.as_tensor(vc),
                                 torch.as_tensor(pos), cfg, window=window)
    for g, w in zip(got, want, strict=True):
        close_to_scale(g, w)


@reference
def test_cross_attention_matches_reference():
    c = case("llama32_vision_90b")
    p = layer_params(c.tparams["blocks"], 0)["cross"]
    jp = jax.tree.map(lambda a: a[0], c.jparams["blocks"]["cross"])
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 7, c.cfg.d_model)).astype(np.float32)
    feats = rng.standard_normal((2, 16, c.cfg.d_model)).astype(np.float32)
    want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(feats), jsmoke_config("llama32_vision_90b"))
    close_to_scale(tattn.cross_attention(p, torch.as_tensor(x), torch.as_tensor(feats), c.cfg), want)


def test_vlm_needs_image_features():
    lm = LanguageModel(configs.smoke_config("llama32_vision_90b"))
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="img_feats"):
        lm.forward(params, torch.zeros((1, 4), dtype=torch.int64))


@reference
def test_decode_cache_round_trips_through_numpy():
    c = case("zamba2_7b")
    _, jcache = c.j_prefill(c.jparams, jnp.asarray(c.tokens[:, :PROMPT]), PROMPT + STEPS, None)
    cache = convert.decode_cache_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert cache.ssm_state.dtype == torch.float32 and cache.position.dtype == torch.int32
    back = convert.decode_cache_to_numpy(cache)
    for field in DecodeCache._fields:
        np.testing.assert_array_equal(getattr(back, field), np.asarray(getattr(jcache, field)))


# ---------------------------------------------------------------------------
# the cast policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_is_cast_leaf_per_family(arch):
    """``cast_matrices`` at bf16 keeps exactly the embedding tables and the
    :data:`F32_LEAVES` in float32; ``draw_cast_params`` is bit-equal to it."""
    cfg = configs.smoke_config(arch).scaled(dtype="bfloat16")
    lm = LanguageModel(cfg)
    leaves = flat(cast_matrices(lm.init(torch.Generator().manual_seed(0), device="cpu"),
                                torch.bfloat16, torch.device("cpu")))
    keep = {p for p in leaves if p in ("embed", "unembed") or p.split("/")[-1] in F32_LEAVES}
    assert {p for p, leaf in leaves.items() if leaf.dtype == torch.float32} == keep
    assert all(is_cast_leaf(p) == (p not in keep) for p in leaves)
    if cfg.uses_ssm:
        assert {"blocks/ssm/a_log", "blocks/ssm/dt_bias", "blocks/ssm/d_skip", "blocks/ssm/norm_scale",
                "blocks/ln/scale"} <= keep
        assert leaves["blocks/ssm/conv_w"].dtype == torch.bfloat16
    if cfg.family == "hybrid":
        assert leaves["shared_attn/attn/wq"].dtype == leaves["shared_attn/mlp/w_down"].dtype == torch.bfloat16
        assert {"shared_attn/pre/scale", "shared_attn/mid/scale"} <= keep
    drawn = flat(draw_cast_params(lm, torch.Generator().manual_seed(0), device="cpu"))
    assert drawn.keys() == leaves.keys()
    for path, leaf in leaves.items():
        assert drawn[path].dtype == leaf.dtype and torch.equal(drawn[path], leaf), path


# ---------------------------------------------------------------------------
# the dense-cache program on the card against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_dense_crosscheck_on_the_cpu(arch):
    """Both sides on the CPU: the program runs, and the two agree exactly."""
    readings = cc.dense_cache_card_against_cpu("cpu", arch)
    assert readings["worst_abs_diff"] == 0.0
    assert readings["logits"] == (cc.DENSE_STEPS + 1) * cc.PROMPTS * configs.smoke_config(arch).padded_vocab
    assert set(readings["worst_cache_diff_over_max"].values()) == {0.0}


def test_dense_tolerance_follows_the_ssm_layers():
    assert cc.dense_tolerance("gemma3_12b") == cc.LOGIT_TOL
    assert cc.dense_tolerance("llama32_vision_90b") == cc.LOGIT_TOL
    assert cc.dense_tolerance("mamba2_130m") == cc.SSD_TOL
    assert cc.dense_tolerance("zamba2_7b") == cc.SSD_TOL
    assert cc.SSD_TOL < 2e-4  # below ssd_scan's own rtol/atol


@pytest.mark.parametrize("arch", ["mamba2_130m", "zamba2_7b"])
def test_dense_tolerance_rejects_planted_scan_faults(arch):
    """Each of the crosscheck's planted scan faults, on the CPU against the
    CPU's clean run, reads above the SSM families' limit."""
    readings = cc.dense_cache_rejects_planted_faults("cpu", arch)
    assert set(readings) == set(cc.SCAN_FAULTS)
    assert min(readings.values()) > cc.dense_tolerance(arch)
    assert tssm.ssd_scan is ssd_scan  # the fault is taken out again


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_dense_cache_card_matches_cpu(cuda_device, arch):
    """Prefill on the card goes through flash_attention and ssd_scan; the
    logits and caches within ``dense_tolerance`` of the CPU path's."""
    from repro_torch.kernels import dispatch

    dispatch.reset_launch_counts()
    readings = cc.dense_cache_card_against_cpu(cuda_device, arch)
    cfg = configs.smoke_config(arch)
    launches = dispatch.launch_counts()
    attn = {"ssm": 0, "hybrid": cfg.n_layers // max(cfg.attn_every, 1)}.get(cfg.family, cfg.n_layers)
    assert launches["flash_attention"] == attn
    assert launches["ssd_scan"] == (cfg.n_layers if cfg.uses_ssm else 0)
    assert readings["worst_diff_over_step_max"] <= cc.dense_tolerance(arch)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_attention_at_smoke_head_dims(cuda_device, d, window):
    """The CUDA-core kernel at head dims 16 and 32 (f32), S = 200, 4 heads
    over 2: atol and rtol 2e-5 against the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + window)
    check_flash(gen, (2, 200, 4, 2, d), torch.float32, window)


@pytest.mark.cuda
def test_flash_attention_refuses_bf16_at_smoke_head_dims(cuda_device):
    q = torch.zeros((1, 64, 2, 16), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="bf16"):
        flash_attention(q, q, q)


@pytest.mark.cuda
def test_attention_train_on_card_launches_flash(cuda_device):
    """``attention_train`` on CUDA tensors is one flash launch, its output
    and K/V within 2e-5 of the CPU path's (``attention_chunked``) at
    gemma3's smoke width."""
    from repro_torch.kernels import dispatch

    cfg = configs.smoke_config("gemma3_12b")
    params = LanguageModel(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    p = layer_params(params["blocks"], 0)["local0"]["attn"]
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want = tattn.attention_train(p, x, cfg, window=cfg.window)
    before = dispatch.get_op("flash_attention").launches
    got = tattn.attention_train({k: v.to(cuda_device) for k, v in p.items()}, x.to(cuda_device), cfg,
                                window=cfg.window)
    assert dispatch.get_op("flash_attention").launches == before + 1
    for g, w in zip(got, want, strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-5, atol=2e-5)
