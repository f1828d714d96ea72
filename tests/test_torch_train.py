"""The port's training path against the JAX reference, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``:

* ``adamw_update``, ``schedule`` and ``clip_by_global_norm`` on the same
  params and gradients, over warm-up and decay, with the clip active and
  not: params, moments, grad norm and learning rate to rtol 1e-6;
* ``TokenPipeline``: the Markov transition matrix and the entropy rate
  bit-equal to the reference's (the token stream is the port's own),
  batches a function of the step alone, world sizes re-slicing one global
  batch, labels the next tokens;
* loss and gradients of each family at smoke width (one arch a family),
  weights carried by ``convert.params_from_numpy``: the reference's
  ``jax.value_and_grad(lm.loss)`` against the port's ``loss.backward()``,
  the loss to rtol 1e-6 and each gradient leaf within 1e-4 of its largest
  magnitude (measured: at most 1e-5, the two frameworks sum in other
  orders);
* ``make_train_step`` at 1 and 2 microbatches against the reference's
  (``param_shardings=None``), accumulating in f32 and in bf16: loss and
  grad norm to rtol 1e-5, the first moment (0.1 x the clipped gradient)
  within 1e-4 of its largest magnitude (2^-7 where 2 microbatches add up
  in bf16); the updated params within 1e-3 of the learning rate wherever
  the gradient is above 1e-2 of its largest (the first Adam step moves
  every param by about lr whatever |g| is);
* checkpoints: a round trip, async saves with garbage collection and no
  ``.tmp`` left, and the format shared both ways: a reference-written
  checkpoint restores into the port's state and a port-written one into
  the reference's, bit-equal;
* the ``Trainer`` contract in the port: a crash and a relaunch equal the
  uninterrupted run step for step, and the loss falls at smoke width.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.launch.steps import make_train_step as j_make_train_step  # noqa: E402
from repro.models.model import LanguageModel as JLanguageModel  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.steps import make_train_step, pick_microbatches  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402
from repro_torch.train.train_loop import InjectedFailure, TrainConfig, Trainer  # noqa: E402

FAMILIES = ("starcoder2_3b", "mamba2_130m", "zamba2_7b", "gemma3_12b", "deepseek_moe_16b",
            "musicgen_large", "llama32_vision_90b")


def to_torch(tree):
    return topt.tree_map(lambda x: torch.as_tensor(np.array(x)), tree)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def opt_case(seed, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "blocks": {"b": (3, 4), "a": (2, 2, 3)}, "s": (7,)}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda p: (grad_scale * rng.standard_normal(p.shape)).astype(np.float32), params)
             for _ in range(4)]
    return params, grads


@pytest.mark.parametrize("grad_scale", [0.01, 3.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(grad_scale):
    """Four steps over warm-up (2 steps) and cosine decay (to step 5)."""
    params, grads = opt_case(1, grad_scale)
    jcfg = jopt.AdamWConfig(learning_rate=1e-2, warmup_steps=2, total_steps=5)
    tcfg = topt.AdamWConfig(learning_rate=1e-2, warmup_steps=2, total_steps=5)
    jp, js = params, jopt.adamw_init(params)
    tp = to_torch(params)
    ts = topt.adamw_init(tp)
    for g in grads:
        jp, js, jm = jopt.adamw_update(jcfg, jp, g, js)
        tp, ts, tm = topt.adamw_update(tcfg, tp, to_torch(g), ts)
        for name in ("grad_norm", "learning_rate"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-6)
        for got, want in zip(topt.tree_leaves((tp, ts.mu, ts.nu)), jax.tree.leaves((jp, js.mu, js.nu)), strict=True):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
        assert int(ts.step) == int(js.step)
    assert (float(jm["grad_norm"]) > 1.0) == (grad_scale > 1)


def test_schedule_matches_reference():
    cfg = dict(learning_rate=3e-4, warmup_steps=3, total_steps=10, min_lr_ratio=0.1)
    for step in range(13):
        got = float(topt.schedule(topt.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32)))
        want = float(jopt.schedule(jopt.AdamWConfig(**cfg), jnp.int32(step)))
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = opt_case(2, 1.0)
    jg, jn = jopt.clip_by_global_norm(grads[0], max_norm)
    tg, tn = topt.clip_by_global_norm(to_torch(grads[0]), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in zip(topt.tree_leaves(tg), jax.tree.leaves(jg), strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_update_works_in_slices(monkeypatch):
    """A leaf longer than a slice is worked in pieces, with the same values."""
    params, grads = opt_case(3, 3.0)
    cfg = topt.AdamWConfig(learning_rate=1e-2, warmup_steps=2, total_steps=5)
    whole = topt.adamw_update(cfg, to_torch(params), to_torch(grads[0]), topt.adamw_init(to_torch(params)))
    monkeypatch.setattr(topt, "SLICE", 4)
    sliced = topt.adamw_update(cfg, to_torch(params), to_torch(grads[0]), topt.adamw_init(to_torch(params)))
    for a, b in zip(topt.tree_leaves(whole[:2]), topt.tree_leaves(sliced[:2]), strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------

DATA = dict(vocab_size=48, seq_len=24, global_batch=8, seed=3)


def test_transition_matrix_and_entropy_rate_equal_the_reference():
    ref = JTokenPipeline(JDataConfig(**DATA))
    port = TokenPipeline(DataConfig(**DATA), device="cpu")
    assert port.entropy_rate == ref.entropy_rate
    logits = np.log(port.transition + 1e-9).astype(np.float32)
    assert np.array_equal(logits, np.asarray(ref._logits))


def test_batches_are_deterministic_and_resumable():
    a = TokenPipeline(DataConfig(**DATA), device="cpu")
    b = TokenPipeline(DataConfig(**DATA), device="cpu")
    for step in (0, 5, 5, 11):
        x, y = a.batch(step), b.batch(step)
        assert torch.equal(x["tokens"], y["tokens"]) and torch.equal(x["labels"], y["labels"])
    assert not torch.equal(a.batch(5)["tokens"], a.batch(6)["tokens"])
    other = TokenPipeline(DataConfig(**{**DATA, "seed": 4}), device="cpu")
    assert not torch.equal(a.batch(5)["tokens"], other.batch(5)["tokens"])
    assert a.state(7) == {"data_step": 7, "seed": DATA["seed"]}


@pytest.mark.parametrize("world", [2, 4])
def test_world_sizes_reslice_one_global_batch(world):
    cfg = DataConfig(**DATA)
    full = TokenPipeline(cfg, device="cpu").global_batch(9)
    parts = [TokenPipeline(cfg, rank=r, world=world, device="cpu").batch(9) for r in range(world)]
    for key in ("tokens", "labels"):
        assert torch.equal(torch.cat([p[key] for p in parts]), full[key])
    with pytest.raises(ValueError):
        TokenPipeline(DataConfig(**{**DATA, "global_batch": 6}), world=4, device="cpu")


def test_labels_are_the_next_tokens():
    pipe = TokenPipeline(DataConfig(**DATA), device="cpu")
    batch = pipe.batch(2)
    assert batch["tokens"].shape == batch["labels"].shape == (DATA["global_batch"], DATA["seq_len"])
    assert batch["tokens"].dtype == torch.int32
    assert torch.equal(batch["tokens"][:, 1:], batch["labels"][:, :-1])
    assert 0 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < DATA["vocab_size"]
    # Each step follows the chain: no transition the matrix gives no mass.
    probs = pipe.transition[batch["tokens"].long().numpy(), batch["labels"].long().numpy()]
    assert (probs > 0).all()


# ---------------------------------------------------------------------------
# loss and gradients of each family
# ---------------------------------------------------------------------------


class Model:
    """One arch's smoke model on both sides, the same weights: the port's
    draw (the reference's law), handed to the reference as its own tree
    (the two trees have the same paths, ``convert.params_from_numpy``)."""

    def __init__(self, arch, seed=0):
        self.cfg = configs.smoke_config(arch)
        self.lm = LanguageModel(self.cfg)
        self.jlm = JLanguageModel(jsmoke_config(arch))
        drawn = self.lm.init(torch.Generator().manual_seed(seed), device="cpu")
        self.np_params = topt.tree_map(lambda x: x.numpy().copy(), drawn)
        self.jparams = jax.tree.map(jnp.asarray, self.np_params)

    def tparams(self):
        return convert.params_from_numpy(self.np_params, self.cfg, "cpu")

    def batch(self, b, s, seed=5):
        rng = np.random.default_rng(seed)
        seq = rng.integers(0, self.cfg.vocab_size, (b, s + 1)).astype(np.int32)
        labels = seq[:, 1:].copy()
        labels[0, :3] = -1  # masked positions
        out = {"tokens": seq[:, :-1], "labels": labels}
        if self.cfg.family == "vlm":
            out["img"] = rng.standard_normal((b, self.cfg.n_img_tokens, self.cfg.d_model)).astype(np.float32)
        return out


def quick_jit(fn, *args):
    """``fn`` compiled for ``args`` with XLA's CPU backend optimizations
    off: the reference's smoke models compile in a fraction of the time,
    and the values agree with the optimized build within the tolerances
    here (f32 arithmetic either way)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})


def leaf_ratio(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_reference(arch):
    m = Model(arch)
    batch = m.batch(2, 32)
    img = batch.get("img")
    args = (m.jparams, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]),
            None if img is None else jnp.asarray(img))
    (jloss, jmetrics), jgrads = quick_jit(jax.value_and_grad(m.jlm.loss, has_aux=True), *args)(*args)
    params = m.tparams()
    leaves = topt.tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss, metrics = m.lm.loss(params, torch.as_tensor(batch["tokens"]), torch.as_tensor(batch["labels"]),
                              None if img is None else torch.as_tensor(img))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert int(metrics["tokens"]) == int(jmetrics["tokens"])
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(leaves)
    worst = max(leaf_ratio(x.grad.numpy(), g) for x, g in zip(leaves, jleaves, strict=True))
    assert worst <= 1e-4, worst


def test_remat_changes_no_gradient():
    """``cfg.remat`` recomputes each layer in the backward: the same
    gradients, bit for bit, as without it."""
    m = Model("zamba2_7b")
    batch = m.batch(2, 32)
    grads = []
    for remat in (False, True):
        lm = LanguageModel(m.cfg.scaled(remat=remat))
        params = m.tparams()
        leaves = topt.tree_leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        lm.loss(params, torch.as_tensor(batch["tokens"]), torch.as_tensor(batch["labels"]))[0].backward()
        grads.append([x.grad for x in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*grads, strict=True))


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_micro,comm", [
    ("starcoder2_3b", 1, "bfloat16"), ("starcoder2_3b", 2, "float32"), ("starcoder2_3b", 2, "bfloat16"),
    ("mamba2_130m", 2, "bfloat16"),
])
def test_make_train_step_matches_reference(arch, n_micro, comm):
    m = Model(arch)
    batch = m.batch(4, 16)
    jcfg, tcfg = jopt.AdamWConfig(), topt.AdamWConfig()
    args = (m.jparams, jopt.adamw_init(m.jparams), {k: jnp.asarray(v) for k, v in batch.items()})
    jp, js, jm = quick_jit(j_make_train_step(m.jlm, jcfg, n_micro, param_shardings=None, grad_comm_dtype=comm),
                           *args)(*args)
    params = m.tparams()
    tp, ts, tm = make_train_step(m.lm, tcfg, n_micro, grad_comm_dtype=comm)(
        params, topt.adamw_init(params), {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    jmu = [np.asarray(x) for x in jax.tree.leaves(js.mu)]
    tmu = [x.numpy() for x in topt.tree_leaves(ts.mu)]
    largest = max(np.abs(x).max() for x in jmu)
    # f32 gradients to 1e-4 of the largest.  Two microbatches added up in
    # bf16 (the smoke configs compute in f32) round each partial sum to
    # bf16, and f32 values a hair apart may round to neighbouring bf16
    # values: up to half a bf16 step (2^-8 relative) of each of the two
    # partial gradients, 2^-7 of the largest.
    tol = 2.0**-7 if n_micro > 1 and comm == "bfloat16" else 1e-4
    worst = max(np.abs(got - want).max() for got, want in zip(tmu, jmu, strict=True)) / largest
    assert worst <= tol, worst
    for got, want, mu in zip(topt.tree_leaves(tp), jax.tree.leaves(jp), jmu, strict=True):
        sure = np.abs(mu) > 1e-2 * largest
        diff = np.abs(got.numpy() - np.asarray(want))[sure]
        assert diff.size == 0 or diff.max() <= 1e-3 * tcfg.learning_rate


def test_prefill_and_serve_steps():
    """``make_prefill_step`` hands over the last position's logits and the
    filled cache; ``make_serve_step`` steps it as ``decode_step`` does."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    m = Model("mamba2_130m")
    params = m.tparams()
    tokens = torch.as_tensor(m.batch(2, 12)["tokens"])
    last, cache = make_prefill_step(m.lm, 16)(params, {"tokens": tokens})
    logits, want_cache = m.lm.prefill(params, tokens, 16)
    assert torch.equal(last, logits[:, -1]) and int(cache.position[0]) == 12
    nxt = last.argmax(-1)[:, None]
    got, cache = make_serve_step(m.lm)(params, cache, nxt)
    want, _ = m.lm.decode_step(params, nxt, want_cache)
    assert torch.equal(got, want) and int(cache.position[0]) == 13


def test_pick_microbatches():
    from repro.configs.registry import SHAPES as JSHAPES
    from repro.launch.steps import pick_microbatches as j_pick
    from repro_torch.configs import SHAPES

    class OneDevice:  # the reference's mesh, as pick_microbatches reads it
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 1}

    for name, shape in SHAPES.items():
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) == (
            JSHAPES[name].name, JSHAPES[name].seq_len, JSHAPES[name].global_batch, JSHAPES[name].kind)
        assert pick_microbatches(None, shape) == j_pick(None, JSHAPES[name], OneDevice())


def test_shape_cells_match_reference():
    from repro.configs import shape_cells as j_cells
    from repro_torch.configs import shape_cells

    for arch in configs.ARCHS:
        assert shape_cells(arch) == j_cells(arch)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def small_state():
    m = Model("starcoder2_3b")
    params = m.tparams()
    opt = topt.adamw_init(params)
    g = topt.tree_map(lambda p: torch.full_like(p, 0.5), params)
    params, opt, _ = topt.adamw_update(topt.AdamWConfig(), params, g, opt)
    return m, params, opt


def test_checkpoint_round_trip(tmp_path):
    _, params, opt = small_state()
    ck = Checkpointer(tmp_path)
    assert ck.latest_step() is None
    ck.save(3, (params, opt), extra={"data_step": 3, "seed": 0})
    like = topt.tree_map(torch.zeros_like, (params, opt))
    (p2, o2), step, extra = ck.restore(like, device="cpu")
    assert step == 3 and extra == {"data_step": 3, "seed": 0} and ck.latest_step() == 3
    assert isinstance(o2, topt.OptState) and o2.step.dtype == torch.int32
    assert all(torch.equal(a, b) for a, b in zip(topt.tree_leaves((params, opt)), topt.tree_leaves((p2, o2)),
                                                 strict=True))
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(like, device="cpu")


def test_async_saves_collect_old_checkpoints(tmp_path):
    _, params, opt = small_state()
    ck = Checkpointer(tmp_path, keep=2)
    for step in range(1, 5):
        ck.save_async(step, (params, opt), extra={"data_step": step})
    ck.wait()
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_0000000003", "step_0000000004"]
    assert not list(tmp_path.glob("*.tmp"))
    assert ck.latest_step() == 4


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A reference-written checkpoint restores into the port's (params,
    OptState) and a port-written one into the reference's, bit-equal."""
    m, params, opt = small_state()
    rng = np.random.default_rng(8)
    moment = lambda p: jnp.asarray(rng.random(p.shape, np.float32))  # noqa: E731
    jparams = jax.tree.map(moment, m.jparams)
    jstate = jopt.OptState(step=jnp.int32(7), mu=jax.tree.map(moment, jparams), nu=jax.tree.map(moment, jparams))
    JCheckpointer(tmp_path / "ref").save(7, (jparams, jstate), extra={"data_step": 7})
    like = topt.tree_map(torch.zeros_like, (params, opt))
    (tp, ts), step, extra = Checkpointer(tmp_path / "ref").restore(like, device="cpu")
    assert step == 7 and extra == {"data_step": 7}
    for got, want in zip(topt.tree_leaves((tp, ts)), jax.tree.leaves((jparams, jstate)), strict=True):
        assert np.array_equal(got.numpy(), np.asarray(want))
    Checkpointer(tmp_path / "port").save(9, (params, opt), extra={"data_step": 9})
    (jp2, js2), step, _ = JCheckpointer(tmp_path / "port").restore((jparams, jstate))
    assert step == 9
    for got, want in zip(jax.tree.leaves((jp2, js2)), topt.tree_leaves((params, opt)), strict=True):
        assert np.array_equal(np.asarray(got), want.numpy())


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------


def trainer(tmp, micro, crash_at=None, steps=6):
    cfg = configs.smoke_config("starcoder2_3b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    tcfg = TrainConfig(total_steps=steps, log_every=1, checkpoint_every=3, checkpoint_dir=str(tmp),
                       crash_at=crash_at, microbatches=micro)
    return Trainer(cfg, data, topt.AdamWConfig(learning_rate=3e-3, warmup_steps=2, total_steps=steps), tcfg,
                   device="cpu")


@pytest.mark.parametrize("micro", [1, 2])
def test_crash_and_relaunch_equal_the_uninterrupted_run(tmp_path, micro):
    full = trainer(tmp_path / "a", micro)
    want = full.run()
    with pytest.raises(InjectedFailure):
        trainer(tmp_path / "b", micro, crash_at=4).run()
    resumed = trainer(tmp_path / "b", micro)
    got = resumed.run()
    assert got["step"] == want["step"][3:] == [3, 4, 5]
    assert got["loss"] == want["loss"][3:]
    assert all(torch.equal(a, b) for a, b in zip(topt.tree_leaves(full.final_state),
                                                 topt.tree_leaves(resumed.final_state), strict=True))
    assert resumed.ckpt.latest_step() == 6


def test_loss_falls_at_smoke_width(tmp_path, capsys):
    tr = train_cli.main(["--device", "cpu", "--arch", "starcoder2_3b", "--steps", "20", "--seq-len", "32",
                         "--checkpoint-dir", str(tmp_path), "--log-every", "5"])
    hist = tr.history
    assert hist["step"] == [0, 4, 9, 14, 19]
    assert hist["loss"][-1] < 0.5 * hist["loss"][0]
    out = capsys.readouterr().out
    assert "step 20/20 loss=" in out and "final loss" in out
