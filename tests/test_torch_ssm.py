"""The port's SSM mixer against the JAX reference, on the CPU.

At the smoke configs of mamba2-130m (d_model 64, 4 heads of P = 32,
N = 16) and zamba2-7b (d_model 128, 8 heads of 32, N = 16), the same
numpy inputs and layer 1's weights (``convert.params_from_numpy`` of the
reference's ``init``) go through ``repro.models.ssm`` and
``repro_torch.models.ssm``:

* ``_conv1d``, to 1e-6 of the largest |output| (four products a value);
* ``ssm_layer`` at S = 40 (chunk 64: one chunk), 128 (two chunks) and 3
  (shorter than the conv), and the decode cache it returns against the
  reference's ``_ssm_prefill_cache``: conv tail (the last three input
  projections), state and output to 1e-5 of the largest |value|;
* ``ssm_decode`` for 4 steps from that cache, output and state to 1e-5;
* the layer on bf16 activations, where the float32 leaves (``a_log``,
  ``dt_bias``, ``d_skip``, ``norm_scale``) stay float32, against the
  reference on the same bf16 input, to 2e-2 of the largest |output|
  (bf16 matrices, rounded in other orders).

A ``cuda`` test holds ``ssm_layer`` on the card (through ``ssd_scan``)
against the CPU path, and the card's refusal of a prompt length its
chunk rules exclude.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import layer_params  # noqa: E402

try:  # the card's machine has no jax: only the cuda tests run there (-m cuda)
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jsmoke_config
    from repro.models import model as jmodel
    from repro.models import ssm as jssm
    from repro.models.model import LanguageModel as JLanguageModel
except ImportError:
    jax = None

ARCHS = ("mamba2_130m", "zamba2_7b")
reference = pytest.mark.skipif(jax is None, reason="needs the JAX reference")


def close_to_scale(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def layers():
    """Layer 1's SSM parameters of each smoke model: (jax, port)."""
    out = {}
    for arch in ARCHS:
        params, _ = JLanguageModel(jsmoke_config(arch)).init(jax.random.PRNGKey(0))
        np_params = jax.tree.map(np.asarray, params)
        tparams = convert.params_from_numpy(np_params, configs.smoke_config(arch), "cpu")
        jp = jax.tree.map(lambda a: jnp.asarray(a[1]), np_params["blocks"]["ssm"])
        # zero-initialised leaves: give them values so every term is exercised
        rng = np.random.default_rng(7)
        for name in ("a_log", "dt_bias", "conv_b", "norm_scale"):
            jp[name] = jnp.asarray(0.3 * rng.standard_normal(jp[name].shape).astype(np.float32))
        tp = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
        out[arch] = jp, tp
    return out


def inputs(arch, s, seed, b=2):
    d = configs.smoke_config(arch).d_model
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@reference
@pytest.mark.parametrize("arch", ARCHS)
def test_conv1d_matches_reference(layers, arch):
    jp, tp = layers[arch]
    c = tp["conv_w"].shape[1]
    x = np.random.default_rng(1).standard_normal((2, 9, c)).astype(np.float32)
    want = jssm._conv1d(jnp.asarray(x), jp["conv_w"], jp["conv_b"])
    close_to_scale(tssm._conv1d(torch.as_tensor(x), tp["conv_w"], tp["conv_b"]), want, 1e-6)


@reference
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [40, 128, 3])
def test_ssm_layer_and_prefill_cache_match_reference(layers, arch, s):
    jp, tp = layers[arch]
    cfg, jcfg = configs.smoke_config(arch), jsmoke_config(arch)
    x = inputs(arch, s, seed=s)
    want = jssm.ssm_layer(jp, jnp.asarray(x), jcfg)
    conv, state = jmodel._ssm_prefill_cache(jp, jnp.asarray(x), jcfg)
    got, cache = tssm.ssm_layer(tp, torch.as_tensor(x), cfg)
    assert got.shape == want.shape and cache.state.dtype == torch.float32
    close_to_scale(got, want, 1e-5)
    close_to_scale(cache.conv, conv, 1e-5)
    close_to_scale(cache.state, state, 1e-5)


@reference
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_matches_reference(layers, arch):
    """Four decode steps from the prefill cache of 40 tokens."""
    jp, tp = layers[arch]
    cfg, jcfg = configs.smoke_config(arch), jsmoke_config(arch)
    x = inputs(arch, 44, seed=5)
    conv, state = jmodel._ssm_prefill_cache(jp, jnp.asarray(x[:, :40]), jcfg)
    jcache = jssm.SSMCache(conv, state)
    _, tcache = tssm.ssm_layer(tp, torch.as_tensor(x[:, :40]), cfg)
    for t in range(40, 44):
        want, jcache = jssm.ssm_decode(jp, jnp.asarray(x[:, t : t + 1]), jcache, jcfg)
        got, tcache = tssm.ssm_decode(tp, torch.as_tensor(x[:, t : t + 1]), tcache, cfg)
        close_to_scale(got, want, 1e-5)
        close_to_scale(tcache.state, jcache.state, 1e-5)
        np.testing.assert_allclose(tcache.conv.numpy(), np.asarray(jcache.conv), rtol=1e-6, atol=1e-6)


@reference
def test_init_ssm_cache_matches_reference():
    cfg = configs.smoke_config("zamba2_7b")
    want = jssm.init_ssm_cache(jsmoke_config("zamba2_7b"), 3, jnp.bfloat16)
    got = tssm.init_ssm_cache(cfg, 3, torch.bfloat16, device="cpu")
    assert tuple(got.conv.shape) == want.conv.shape and got.conv.dtype == torch.bfloat16
    assert tuple(got.state.shape) == want.state.shape and got.state.dtype == torch.float32
    assert not got.conv.any() and not got.state.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tssm.init_ssm_cache(cfg, 3, torch.bfloat16)


@reference
@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_layer_in_bf16_matches_reference(layers, arch):
    """bf16 activations and matrices, the f32-read leaves kept f32 (as
    ``serving.engine.cast_matrices`` keeps them)."""
    jp, tp = layers[arch]
    f32 = ("a_log", "dt_bias", "d_skip", "norm_scale")
    tp16 = {k: v if k in f32 else v.to(torch.bfloat16) for k, v in tp.items()}
    jp16 = {k: v if k in f32 else v.astype(jnp.bfloat16) for k, v in jp.items()}
    x = inputs(arch, 64, seed=9)
    want = jssm.ssm_layer(jp16, jnp.asarray(x, jnp.bfloat16), jsmoke_config(arch).scaled(dtype="bfloat16"))
    got, _ = tssm.ssm_layer(tp16, torch.as_tensor(x).to(torch.bfloat16),
                            configs.smoke_config(arch).scaled(dtype="bfloat16"))
    assert got.dtype == torch.bfloat16
    close_to_scale(got.float(), np.asarray(want.astype(jnp.float32)), 2e-2)


def test_ssm_layer_hands_the_scan_float32(monkeypatch):
    """``ssm_layer`` gives the registry's scan x, B and C in float32 and
    contiguous (the card's TF32 path) whatever the activation dtype, and
    the chunk min(64, S)."""
    cfg = configs.smoke_config("mamba2_130m").scaled(dtype="bfloat16")
    seen = []

    def spy(x, dt, a, bmat, cmat, *, chunk):
        seen.append((x.dtype, bmat.dtype, cmat.dtype, dt.dtype, a.dtype, chunk,
                     all(t.is_contiguous() for t in (x, bmat, cmat))))
        return ssd_scan(x, dt, a, bmat, cmat, chunk=chunk)

    monkeypatch.setattr(tssm, "ssd_scan", spy)
    from repro_torch.models.model import LanguageModel

    lm = LanguageModel(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((2, 48, cfg.d_model), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    tssm.ssm_layer(layer_params(params["blocks"], 0)["ssm"], x, cfg)
    assert seen == [(torch.float32,) * 5 + (64, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [16, 48, 64, 192])
def test_ssm_layer_on_card_matches_cpu(cuda_device, arch, s):
    """Through ``ssd_scan`` on the card (one launch), against the CPU path
    on the same weights: 2e-4 of the largest |value| (TF32 products)."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import LanguageModel

    cfg = configs.smoke_config(arch)
    params = LanguageModel(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    p = layer_params(params["blocks"], 1)["ssm"]
    x = torch.as_tensor(inputs(arch, s, seed=s))
    want, wcache = tssm.ssm_layer(p, x, cfg)
    before = dispatch.get_op("ssd_scan").launches
    got, gcache = tssm.ssm_layer({k: v.to(cuda_device) for k, v in p.items()}, x.to(cuda_device), cfg)
    assert dispatch.get_op("ssd_scan").launches == before + 1
    close_to_scale(got.cpu(), want, 2e-4)
    close_to_scale(gcache.state.cpu(), wcache.state, 2e-4)


@pytest.mark.cuda
def test_ssm_layer_on_card_refuses_a_length_the_chunk_rules_exclude(cuda_device):
    """S = 40: the chunk min(64, 40) is no multiple of 16, so the card
    raises rather than padding or running the plain version."""
    cfg = configs.smoke_config("mamba2_130m")
    from repro_torch.models.model import LanguageModel

    params = LanguageModel(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    p = {k: v.to(cuda_device) for k, v in layer_params(params["blocks"], 0)["ssm"].items()}
    x = torch.randn((1, 40, cfg.d_model), device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 16"):
        tssm.ssm_layer(p, x, cfg)
