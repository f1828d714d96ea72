"""The PyTorch port's boundaries: what it imports, where it runs, that
the plain versions never see a CUDA tensor, and that each CUDA kernel
equals its plain version on the card.

This file imports no jax, so the ``cuda``-marked tests run on a GPU host
that has none:
``python -m pytest -q --noconftest -m cuda tests/test_torch_boundaries.py``.
"""

from __future__ import annotations

import ast
import inspect
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import random as rnd  # noqa: E402
from repro_torch.core import store as tstore  # noqa: E402
from repro_torch.core.config import ALL_MODES, CopyMode  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.clone_chain import clone_chain_kernel, weights_cdf  # noqa: E402
from repro_torch.kernels.cow_gather import cow_gather, pool_compact  # noqa: E402
from repro_torch.kernels.cow_write import cow_write, cow_write_delta  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS, WGMMA_HEAD_DIMS  # noqa: E402
from repro_torch.kernels.refcount_update import refcount_delta  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ops import (  # noqa: E402
    MIN_CTAS,
    SLOT_TILE,
    check_kernel_inputs,
    split_plan,
)
from repro_torch.kernels.resample import (  # noqa: E402
    PLANTED,
    planted_cdfs,
    resample_systematic_kernel,
    systematic_comb,
)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd  # noqa: E402
from repro_torch.serving import crosscheck as cc  # noqa: E402
from repro_torch.serving.crosscheck import LOGIT_TOL, card_against_cpu, smoke_program  # noqa: E402
from repro_torch.kernels.cow_write import cow_write_ref  # noqa: E402
from repro_torch.kernels.refcount_update import refcount_delta_ref  # noqa: E402
from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef  # noqa: E402
from repro_torch.smc.programs import pcfg  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    *sorted((ROOT / "examples").glob("torch_*.py")),
]


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    roots = {name.split(".")[0] for name in imported_modules(path)}
    assert not roots & {"jax", "jaxlib", "repro"}, (path, sorted(roots))


def test_scan_covers_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"pool.py", "store.py", "filters.py", "ops.py", "chip_smoke.py"} <= names
    assert {"faults.py", "smc_decode.py", "scheduler.py", "torch_smc_decode.py"} <= names
    assert {"pgibbs.py", "pcfg.py", "crbd.py", "torch_particle_gibbs.py"} <= names
    assert {"optimizer.py", "checkpoint.py", "train_loop.py", "pipeline.py", "steps.py", "train.py",
            "registry.py", "torch_train_lm.py"} <= names


def lgssm() -> SSMDef:
    def init(gen, n, params):
        return rnd.normal(gen, (n,))

    def step(gen, x, t, y, params):
        x = 0.9 * x + math.sqrt(0.5) * rnd.normal(gen, x.shape)
        return x, -0.5 * (y - x) ** 2 / 0.3, x[:, None]

    return SSMDef(init=init, step=step, record_shape=(1,))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU refusal")
    cfg = tstore.StoreConfig(mode=CopyMode.LAZY, n=4, block_size=2, max_blocks=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstore.create(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParticleFilter(lgssm(), FilterConfig(n_particles=4, n_steps=4))
    assert tstore.create(cfg, device="cpu").tables.device.type == "cpu"
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import TrainConfig, Trainer

    data = DataConfig(vocab_size=16, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(smoke_config("mamba2_130m"), data, AdamWConfig(), TrainConfig(checkpoint_dir="unused"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TokenPipeline(data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--steps", "1"])


def test_unported_options_raise():
    """A mesh that is not the port's ShardMesh is refused; the port's own
    builds both mesh entry points (the filter, the SMC decoder) on the CPU."""
    from repro_torch.configs.starcoder2_3b import SMOKE
    from repro_torch.distributed import ShardMesh
    from repro_torch.models.model import LanguageModel
    from repro_torch.serving.smc_decode import SMCDecoder

    with pytest.raises(TypeError, match="ShardMesh"):
        ParticleFilter(lgssm(), FilterConfig(n_particles=4, n_steps=4, mesh=object()), device="cpu")
    mesh = ShardMesh.in_process(2, "cpu")
    pf = ParticleFilter(lgssm(), FilterConfig(n_particles=4, n_steps=4, mesh=mesh))
    assert pf.device.type == "cpu" and pf.sharded_cfg.num_shards == 2
    lm = LanguageModel(SMOKE)
    dec = SMCDecoder(lm, lm.init(rnd.generator(0, "cpu"), device="cpu"), 4, max_len=16, mesh=mesh)
    assert dec.engine.device.type == "cpu" and dec.mesh is mesh
    with pytest.raises(ValueError):
        tstore.create(tstore.StoreConfig(mode=CopyMode.LAZY, n=2, block_size=2, max_blocks=2), device="meta")


# The plain version each ops module routes CPU tensors to.
REF_NAMES = {
    "refcount_update": "refcount_delta_ref",
    "paged_attention_delta": "paged_attention_ref",
    "resample": "resample_systematic_ref",
}


def delta_store_program(device, mode):
    """A small delta-COW store program: appends, a mid-block clone, the
    divergent appends that make delta blocks, a clone of those, and the
    reads that resolve through the parents."""
    cfg = tstore.StoreConfig(mode=mode, n=64, block_size=4, max_blocks=6, delta_cow=True)
    s = tstore.create(cfg, device=device)
    gen = rnd.generator(1, device)
    for t in range(14):
        if t % 3 == 2:
            s, _ = tstore.clone_chain(cfg, s, gen, rnd.normal(gen, (64,)))
        s = tstore.append(cfg, s, rnd.normal(gen, (64,)))
    return cfg, s, tstore.materialize_batch(cfg, s, torch.arange(64, device=device))


def ssd_inputs(gen, b, s, h, p, n, dtype, device):
    x = torch.randn((b, s, h, p), generator=gen, device=device).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen, device=device))
    a = -torch.exp(0.3 * torch.randn(h, generator=gen, device=device))
    bm = torch.randn((b, s, n), generator=gen, device=device).to(dtype)
    cm = torch.randn((b, s, n), generator=gen, device=device).to(dtype)
    return x, dt, a, bm, cm


def test_delta_store_program_on_the_cpu():
    for mode in (CopyMode.LAZY, CopyMode.LAZY_SR):
        cfg, s, _ = delta_store_program("cpu", mode)
        assert bool((s.pool.parent >= 0).any()) and not bool(s.pool.oom)


def test_crosscheck_on_the_cpu():
    """The card-against-CPU check, run with the CPU in the card's place:
    the same program twice on one path agrees to the bit."""
    readings, engines = card_against_cpu("cpu")
    assert readings["worst_abs_diff"] == 0.0
    assert readings["logits"] == (cc.PROMPTS + cc.STEPS * cc.ROWS) * cc.SMOKE.padded_vocab
    assert all(not e.oom for e in engines.values())


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "musicgen_large"])
def test_crosscheck_of_the_moe_and_audio_smoke_on_the_cpu(arch):
    """The same check on deepseek's and musicgen's smoke configs: the
    routing is recorded and held (deepseek), no row is left out."""
    readings, engines = card_against_cpu("cpu", arch)
    vocab = cc.smoke_config(arch).padded_vocab
    assert readings["worst_abs_diff"] == 0.0
    assert readings["logits"] == (cc.PROMPTS + cc.STEPS * cc.ROWS) * vocab
    if arch == "deepseek_moe_16b":
        layers = cc.smoke_config(arch).n_layers - 1  # layer 0 is dense
        rows = layers * (cc.PROMPTS * cc.PROMPT_LEN + cc.STEPS * cc.ROWS)
        assert readings["routing_rows"] == rows and readings["rows_left_out"] == 0
    assert all(not e.oom for e in engines.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tensors_never_reach_a_plain_version(cuda_device, monkeypatch):
    """Every ops module's plain version refuses CUDA tensors for this run,
    and the filter's path still completes — through the kernels, as the
    launch counters show."""
    import importlib

    def refuse(fn):
        def guarded(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
                raise AssertionError(f"{fn.__name__} reached with a CUDA tensor")
            return fn(*args, **kwargs)

        return guarded

    for name, (module, _) in dispatch.KNOWN_OPS.items():
        ops = importlib.import_module(module + ".ops")
        ref_name = REF_NAMES.get(name, f"{name}_ref")
        monkeypatch.setattr(ops, ref_name, refuse(getattr(ops, ref_name)))
    dispatch.reset_launch_counts()
    ys = torch.randn(12)
    for mode in ALL_MODES:
        for resampler in ("systematic", "stratified"):
            cfg = FilterConfig(n_particles=256, n_steps=12, mode=mode, resampler=resampler)
            pf = ParticleFilter(lgssm(), cfg, device=cuda_device)
            res = pf.run(rnd.generator(0, cuda_device), None, ys)
            tstore.materialize_batch(pf.store_cfg, res.store, torch.arange(256, device=cuda_device))
            if mode.is_lazy:
                tstore.compact(pf.store_cfg, res.store)
        for delta_cow in (False, True):
            smoke_program(cuda_device, delta_cow)
    for mode in (CopyMode.LAZY, CopyMode.LAZY_SR):
        delta_store_program(cuda_device, mode)
    gen = rnd.generator(2, cuda_device)
    resample_systematic_kernel(gen, rnd.normal(gen, (4096,)))
    q = torch.randn((1, 130, 4, 64), generator=gen, device=cuda_device, requires_grad=True)
    kv = torch.randn((1, 130, 2, 64), generator=gen, device=cuda_device, requires_grad=True)
    flash_attention(q, kv, kv, window=32).sum().backward()
    x, *rest = ssd_inputs(gen, 1, 128, 2, 16, 32, torch.float32, cuda_device)
    y, h_last = ssd_scan(x.requires_grad_(), *rest)
    (y.sum() + h_last.sum()).backward()
    torch.cuda.synchronize()
    assert all(count > 0 for count in dispatch.launch_counts().values())


def genealogy_tables(rng, n, mb, nb):
    """Block tables as resampling leaves them: each column a sorted (so
    run-structured) sequence of block ids down the particle axis, one hot
    block over the first half of column 0, NULL tails past each row's
    length; the new tables are the rows of sorted ancestors."""
    old = np.sort(rng.integers(0, nb, (n, mb)), axis=0).astype(np.int32)
    old[: n // 2, :1] = 7
    lengths = rng.integers(0, mb + 1, n)
    old[np.arange(mb)[None, :] >= lengths[:, None]] = -1
    anc = np.sort(rng.integers(0, max(n, 1), n))
    return old[anc], old


def write_routing(rng, nb, n, bs, item):
    """A COW write's routing as ``store._write_impl`` builds it over a pool
    of ``nb`` blocks of ``bs`` items: copy rows (several per shared
    source), in-place rows, masked rows on the dump row (zero)."""
    data = torch.as_tensor(rng.standard_normal((nb + 1, bs, *item)).astype(np.float32))
    data[nb] = 0
    ids = torch.as_tensor(rng.permutation(nb).astype(np.int32))
    kind = torch.as_tensor(rng.integers(0, 3, n))  # copy / in place / masked
    shared = ids[n : n + 5][torch.as_tensor(rng.integers(0, 5, n))]
    src = torch.where(kind == 0, shared, ids[:n])
    src = torch.where(kind == 2, nb, src).int()
    dst = torch.where(kind == 2, nb, ids[:n]).int()
    pos = torch.as_tensor(rng.integers(0, bs, n).astype(np.int32))
    values = torch.as_tensor(rng.standard_normal((n, *item)).astype(np.float32))
    return data, src, dst, pos, values


def delta_routing(rng, nb, n, bs, item):
    """A delta COW write's routing as ``store._write_impl`` builds it: copy
    rows keeping a random half of their slots, copy rows keeping none
    (their source on the dump row), in-place rows keeping all, masked rows
    on the dump row."""
    data = torch.as_tensor(rng.standard_normal((nb + 1, bs, *item)).astype(np.float32))
    data[nb] = 0
    ids = torch.as_tensor(rng.permutation(nb).astype(np.int32))
    kind = torch.as_tensor(rng.integers(0, 4, n))  # copy / empty copy / in place / masked
    shared = ids[n : n + 5][torch.as_tensor(rng.integers(0, 5, n))]
    src = torch.where(kind == 0, shared, ids[:n])
    src = torch.where((kind == 1) | (kind == 3), nb, src).int()
    dst = torch.where(kind == 3, nb, ids[:n]).int()
    keep = torch.as_tensor(rng.random((n, bs)) < 0.5)
    keep = torch.where((kind == 2)[:, None], True, keep)
    keep = torch.where((kind == 1)[:, None], False, keep)
    pos = torch.as_tensor(rng.integers(0, bs, n).astype(np.int32))
    values = torch.as_tensor(rng.standard_normal((n, *item)).astype(np.float32))
    return data, src, dst, pos, values, keep


def check_flash(gen, shape, dtype, window):
    """flash_attention on the card against its plain version.  f32: atol
    and rtol 2e-5.  bf16: atol and rtol 2e-2, and each element within
    1.25 times the rounding the tensor-core kernel does of the plain
    version in f32: P and the output are rounded to bf16, each a relative
    2^-8 at most, so |out - plain| <= 2^-8 (|plain| + sum_j p_j |v_j|)."""
    b, s, h, kvh, d = shape
    device = gen.device
    q = torch.randn((b, s, h, d), generator=gen, device=device).to(dtype)
    k = torch.randn((b, s, kvh, d), generator=gen, device=device).to(dtype)
    v = torch.randn((b, s, kvh, d), generator=gen, device=device).to(dtype)
    got = flash_attention(q, k, v, window=window)
    want = flash_attention(q.cpu(), k.cpu(), v.cpu(), window=window)
    assert got.dtype == dtype
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=atol, rtol=atol)
    if dtype == torch.bfloat16:
        q, k, v = q.float().cpu(), k.float().cpu(), v.float().cpu()
        want = flash_attention(q, k, v, window=window)
        bound = 2.0**-8 * (want.abs() + flash_attention(q, k, v.abs(), window=window))
        assert ((got.float().cpu() - want).abs() <= 1.25 * bound).all()


@pytest.mark.cuda
class TestKernelsOnCard:
    """Each CUDA kernel against its plain version on the same inputs:
    integer and data-movement results, so exact equality.  NULL entries,
    masked rows and duplicate ids included."""

    def test_cow_write(self, cuda_device):
        rng = np.random.default_rng(0)
        nb, n = 3000, 900
        data = torch.as_tensor(rng.standard_normal((nb + 1, 4, 1)).astype(np.float32))
        ids = torch.as_tensor(rng.permutation(nb).astype(np.int32))
        kind = torch.as_tensor(rng.integers(0, 3, n))  # copy / in place / masked
        shared = ids[n : n + 5][torch.as_tensor(rng.integers(0, 5, n))]
        src = torch.where(kind == 0, shared, ids[:n])
        src = torch.where(kind == 2, nb, src).int()
        dst = torch.where(kind == 2, nb, ids[:n]).int()
        pos = torch.as_tensor(rng.integers(0, 4, n).astype(np.int32))
        values = torch.as_tensor(rng.standard_normal((n, 1)).astype(np.float32))
        want = cow_write(data.clone(), src, dst, pos, values)
        args = [x.to(cuda_device) for x in (data, src, dst, pos, values)]
        assert torch.equal(cow_write(*args).cpu(), want)

    @pytest.mark.parametrize(
        "bs,item,n",
        [(4, (1,), 4096), (8, (1,), 1000), (4, (3,), 257), (4, (2,), 300), (3, (1,), 333), (2, (), 77)],
    )
    def test_cow_write_shapes(self, cuda_device, bs, item, n):
        """4 and 8 words per block with one-word items (the kernel's own
        instantiations, 16-byte chunks), items of 2 and 3 words and blocks
        of 3 and 2 words (runtime sizes, 4-byte words); N off the 256-row
        CTA.  Exact, and the dump row zero after the call."""
        data, src, dst, pos, values = write_routing(np.random.default_rng(n), n + 500, n, bs, item)
        want = cow_write(data.clone(), src, dst, pos, values)
        got = cow_write(*[x.to(cuda_device) for x in (data, src, dst, pos, values)]).cpu()
        assert torch.equal(got, want) and not got[-1].any()

    def test_cow_write_every_row_masked(self, cuda_device):
        """Every row routed to the dump row: the pool is left as it was."""
        data, _, _, pos, values = write_routing(np.random.default_rng(7), 3000, 700, 4, (1,))
        dump = torch.full((700,), 3000, dtype=torch.int32)
        got = cow_write(*[x.to(cuda_device) for x in (data, dump, dump, pos, values)]).cpu()
        assert torch.equal(got, data)

    def test_cow_write_clears_a_dirty_dump_row(self, cuda_device):
        """A dump row that holds data on entry is zero after the call, in
        the same launch, and the other rows equal the plain version's."""
        data, src, dst, pos, values = write_routing(np.random.default_rng(8), 3000, 900, 4, (1,))
        data[-1] = 5.0
        want = cow_write(data.clone(), src, dst, pos, values)
        before = cow_write.launches
        got = cow_write(*[x.to(cuda_device) for x in (data, src, dst, pos, values)]).cpu()
        assert cow_write.launches == before + 1
        assert torch.equal(got, want) and not got[-1].any()

    def test_cow_write_delta(self, cuda_device):
        """Copy rows keeping some slots, copy rows keeping none (source
        routed to the dump row), in-place rows, masked rows."""
        rng = np.random.default_rng(5)
        nb, n, bs = 3000, 900, 8
        data = torch.as_tensor(rng.standard_normal((nb + 1, bs, 1)).astype(np.float32))
        data[nb] = 0
        ids = torch.as_tensor(rng.permutation(nb).astype(np.int32))
        kind = torch.as_tensor(rng.integers(0, 4, n))  # copy / empty copy / in place / masked
        shared = ids[n : n + 5][torch.as_tensor(rng.integers(0, 5, n))]
        src = torch.where(kind == 0, shared, ids[:n])
        src = torch.where((kind == 1) | (kind == 3), nb, src).int()
        dst = torch.where(kind == 3, nb, ids[:n]).int()
        keep = torch.as_tensor(rng.random((n, bs)) < 0.5)
        keep = torch.where((kind == 2)[:, None], True, keep)
        keep = torch.where((kind == 1)[:, None], False, keep)
        pos = torch.as_tensor(rng.integers(0, bs, n).astype(np.int32))
        values = torch.as_tensor(rng.standard_normal((n, 1)).astype(np.float32))
        for k in (keep, keep.to(torch.uint8)):
            want = cow_write_delta(data.clone(), src, dst, pos, values, k)
            args = [x.to(cuda_device) for x in (data, src, dst, pos, values, k)]
            assert torch.equal(cow_write_delta(*args).cpu(), want)

    @pytest.mark.parametrize("bs,item", [(4, (1,)), (8, (1,)), (16, (1,)), (4, (2,))])
    def test_cow_write_delta_shapes(self, cuda_device, bs, item):
        """Block/item words 4/1 and 8/1 (16-byte chunks), 16/1 and 8/2
        (runtime sizes, a thread per word); N off the 256-thread CTA.
        Exact, and the dump row zero after the call."""
        data, src, dst, pos, values, keep = delta_routing(np.random.default_rng(bs), 2500, 999, bs, item)
        want = cow_write_delta(data.clone(), src, dst, pos, values, keep)
        args = [x.to(cuda_device) for x in (data, src, dst, pos, values, keep)]
        got = cow_write_delta(*args).cpu()
        assert torch.equal(got, want) and not got[-1].any()

    @pytest.mark.parametrize("bs", [4, 8])
    def test_cow_write_delta_chunk_keeps_none(self, cuda_device, bs):
        """Chunks that keep none of their slots: whole rows on the dump row
        as their source (which holds data on entry, so a read would show),
        and, at 8 words, rows whose first chunk keeps nothing while their
        second keeps some.  Only the written item and the kept slots are
        non-zero."""
        data, src, dst, pos, values, keep = delta_routing(np.random.default_rng(20 + bs), 2000, 700, bs, (1,))
        data[-1] = 3.0
        if bs == 8:
            keep[:, :4] = False
        want = cow_write_delta(data.clone(), src, dst, pos, values, keep)
        got = cow_write_delta(*[x.to(cuda_device) for x in (data, src, dst, pos, values, keep)]).cpu()
        assert torch.equal(got[:-1], want[:-1]) and not got[-1].any()
        rows = (src == 2000) & (dst != 2000)
        written = torch.zeros_like(keep)
        written[torch.arange(700), pos.long()] = True
        assert rows.any() and not got[dst[rows].long()][~written[rows]].any()

    def test_cow_write_delta_chunk_keeps_some(self, cuda_device):
        """Every chunk keeps exactly one of its four slots (a different one
        per row): the chunk's other slots are zeroed in registers."""
        data, src, dst, pos, values, keep = delta_routing(np.random.default_rng(30), 2000, 800, 8, (1,))
        slot = torch.arange(8)[None, :] % 4 == torch.arange(800)[:, None] % 4
        keep = torch.where((src == dst)[:, None], keep, slot & (src != 2000)[:, None])
        want = cow_write_delta(data.clone(), src, dst, pos, values, keep)
        got = cow_write_delta(*[x.to(cuda_device) for x in (data, src, dst, pos, values, keep)]).cpu()
        assert torch.equal(got, want)

    def test_cow_write_delta_one_launch_clears_a_dirty_dump_row(self, cuda_device):
        """A dump row that holds data on entry is zero after the call, in
        the call's one counted launch, the other rows equal to the plain
        version's; bool and uint8 keep masks alike."""
        data, src, dst, pos, values, keep = delta_routing(np.random.default_rng(40), 3000, 900, 8, (1,))
        data[-1] = 5.0
        for k in (keep, keep.to(torch.uint8)):
            want = cow_write_delta(data.clone(), src, dst, pos, values, k)
            args = [x.to(cuda_device) for x in (data, src, dst, pos, values, k)]
            before = cow_write_delta.launches
            got = cow_write_delta(*args).cpu()
            assert cow_write_delta.launches == before + 1
            assert torch.equal(got[:-1], want[:-1]) and not got[-1].any()

    @pytest.mark.parametrize("n", [1, 255, 1000, 4096, 65536, 65537, 1048576])
    @pytest.mark.parametrize("case", ["random", *PLANTED])
    def test_resample(self, cuda_device, case, n):
        """Bit-equal to the plain version in one launch a call: log-normal
        weights, and ``planted_cdfs``' edges (one particle holding all the
        weight, zero-weight runs wider than the kernel's shared stage, a
        last entry below 1, u = 0 and the largest float32 below 1, ties);
        n off the kernel's 512-output tile and up to 2^20."""
        if case == "random":
            rng = np.random.default_rng(n)
            w = np.exp(3 * rng.standard_normal(n)).astype(np.float32)
            cum = torch.as_tensor(np.cumsum(w, dtype=np.float32))
            cum = cum / cum[-1]
            u = torch.as_tensor(np.array([rng.random()], np.float32))
        else:
            cum, u = planted_cdfs(n, seed=n)[case]
        want = systematic_comb(cum, u)
        before = systematic_comb.launches
        got = systematic_comb(cum.to(cuda_device), u.to(cuda_device)).cpu()
        assert systematic_comb.launches == before + 1
        assert torch.equal(got, want)

    def test_resample_unaligned_cdf(self, cuda_device):
        """A CDF 4 bytes off 16-byte alignment (a view one entry into its
        storage) is staged without vector loads, with the same result."""
        cum, u = planted_cdfs(65537, seed=3)["zero_runs"]
        padded = torch.cat([torch.zeros(1), cum]).to(cuda_device)
        assert padded[1:].data_ptr() % 16 == 4
        got = systematic_comb(padded[1:], u.to(cuda_device)).cpu()
        assert torch.equal(got, systematic_comb(cum, u))

    @pytest.mark.parametrize("d", WGMMA_HEAD_DIMS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("window", [0, 45])
    def test_flash_attention(self, cuda_device, d, dtype, window):
        """Against the plain version on the card: S = 200 (a partial last
        tile), 6 heads over 2 KV heads; bf16 atol 2e-2 and each element
        within its rounding bound, f32 2e-5 (sums in another order)."""
        check_flash(rnd.generator(d + window, cuda_device), (2, 200, 6, 2, d), dtype, window)

    @pytest.mark.parametrize("d", WGMMA_HEAD_DIMS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("window", [0, 45, 1000])
    @pytest.mark.parametrize("b,s,h,kvh", [(1, 1, 4, 4), (3, 63, 3, 1), (1, 300, 8, 1), (3, 130, 16, 2)])
    def test_flash_attention_tiling(self, cuda_device, d, dtype, window, b, s, h, kvh):
        """The tensor-core kernel's tiling: S of 1, 63, 130 and 300 (none
        a multiple of its 128 query rows), a window inside one 64-key tile
        and one longer than S, query heads per KV head 1, 3 and 8, B up to
        3; tolerances as above."""
        check_flash(rnd.generator(d + window + s, cuda_device), (b, s, h, kvh, d), dtype, window)

    def test_flash_attention_without_keys(self, cuda_device):
        """No key (Sk = 0): every row writes 0, as the plain version does."""
        q = torch.randn((1, 5, 2, 64), device=cuda_device).to(torch.bfloat16)
        kv = torch.zeros((1, 0, 2, 64), dtype=torch.bfloat16, device=cuda_device)
        got = flash_attention(q, kv, kv)
        want = flash_attention(q.cpu(), kv.cpu(), kv.cpu())
        assert torch.equal(got.cpu(), want) and not want.any()

    def test_flash_attention_refuses_unaligned_views(self, cuda_device):
        """TMA takes 16-byte aligned bases only: a bf16 view two bytes into
        its storage raises rather than falling back."""
        flat = torch.zeros(2 * 64 * 2 * 64 + 1, dtype=torch.bfloat16, device=cuda_device)
        q = flat[1:].view(2, 64, 2, 64)
        with pytest.raises(ValueError, match="TMA"):
            flash_attention(q, q, q)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_ssd_scan(self, cuda_device, dtype):
        """mamba2-130m's head widths (P = 64, N = 128, chunk 64) against the
        plain version on the card, 2e-4 (both compute in f32)."""
        args = ssd_inputs(rnd.generator(3, cuda_device), 2, 256, 3, 64, 128, dtype, cuda_device)
        y, h = ssd_scan(*args)
        yr, hr = ssd_scan(*[a.cpu() for a in args])
        torch.testing.assert_close(y.cpu(), yr, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h.cpu(), hr, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("s,q", [(64, 64), (320, 64), (16, 16), (144, 16)])
    def test_ssd_scan_chunks(self, cuda_device, dtype, s, q):
        """One chunk (S = Q) and many, at Q = 64 and Q = 16; P 32 and N 48
        (multiples of 16, N not a power of two), 5 heads (a partial head
        group).  y and the final state within 2e-4 of the plain version."""
        args = ssd_inputs(rnd.generator(s + q, cuda_device), 2, s, 5, 32, 48, dtype, cuda_device)
        y, h = ssd_scan(*args, chunk=q)
        yr, hr = ssd_scan(*[a.cpu() for a in args], chunk=q)
        torch.testing.assert_close(y.cpu(), yr, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h.cpu(), hr, rtol=2e-4, atol=2e-4)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_ssd_scan_repeat_bit_equal(self, cuda_device, dtype):
        """No atomics, chunks summed in order: a repeat call is bit-equal."""
        args = ssd_inputs(rnd.generator(11, cuda_device), 2, 512, 4, 64, 128, dtype, cuda_device)
        y1, h1 = ssd_scan(*args)
        y2, h2 = ssd_scan(*args)
        assert torch.equal(y1, y2) and torch.equal(h1, h2)

    @pytest.mark.parametrize("p,n,chunk", [(24, 32, 64), (32, 40, 64), (32, 32, 24)])
    def test_ssd_scan_refuses_unaligned_widths(self, cuda_device, p, n, chunk):
        """P or N not a multiple of 16 raises on the card; the plain version
        is never run in its place.  A chunk that is not (24) runs rounded up
        to 32 (over a ``dt = 0`` tail where S needs one), one launch, within
        2e-4 of the CPU path at the chunk asked for."""
        args = ssd_inputs(rnd.generator(12, cuda_device), 1, 192, 2, p, n, torch.float32, cuda_device)
        before = ssd_scan.launches
        if p % 16 or n % 16:
            with pytest.raises(ValueError, match="multiples of 16"):
                ssd_scan(*args, chunk=chunk)
            assert ssd_scan.launches == before
            return
        y, h = ssd_scan(*args, chunk=chunk)
        assert ssd_scan.launches == before + 1
        yr, hr = ssd_scan(*[a.cpu() for a in args], chunk=chunk)
        torch.testing.assert_close(y.cpu(), yr, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h.cpu(), hr, rtol=2e-4, atol=2e-4)

    def test_refcount_delta(self, cuda_device):
        rng = np.random.default_rng(1)
        old = torch.as_tensor(rng.integers(-1, 500, 20000).astype(np.int32))
        new = old[torch.as_tensor(rng.integers(0, 20000, 20000))]
        want = refcount_delta(new, old, 500)
        got = refcount_delta(new.to(cuda_device), old.to(cuda_device), 500)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a.cpu(), b)

    @pytest.mark.parametrize(
        "case", ["1000x256", "777x37", "5000x1", "130x129", "0x16", "300x64 unaligned"]
    )
    def test_refcount_delta_genealogy(self, cuda_device, case):
        """Genealogy-shaped tables: each column a run-structured block
        sequence down the particle axis, resampled by sorted ancestors,
        with a hot block over half a column and NULL tails; N and the row
        length off the kernel's 128-row segments and 128-column groups, a
        row of 1, no entries, and a base that is not 16-byte aligned.
        Exact, with the row length given and without."""
        rng = np.random.default_rng(1)
        nb = 500
        n, row = (int(x) for x in case.split()[0].split("x"))
        new, old = genealogy_tables(rng, n, row, nb)
        new, old = torch.as_tensor(new).reshape(-1), torch.as_tensor(old).reshape(-1)
        want = refcount_delta(new, old, nb)
        for r in (row, None):
            a, b = new.to(cuda_device), old.to(cuda_device)
            if case.endswith("unaligned"):  # a view 4 bytes into its storage
                a = torch.cat([a[:1], a])[1:]
                b = torch.cat([b[:1], b])[1:]
            got = refcount_delta(a, b, nb, row=r)
            for x, y in zip(got, want, strict=True):
                assert torch.equal(x.cpu(), y)

    def test_cow_gather_and_compact(self, cuda_device):
        rng = np.random.default_rng(2)
        for shape in ((4, 1), (3,)):
            pool = torch.as_tensor(rng.standard_normal((700, *shape)).astype(np.float32))
            table = torch.as_tensor(rng.integers(-1, 700, 5000).astype(np.int32))
            want = cow_gather(pool, table)
            assert torch.equal(cow_gather(pool.to(cuda_device), table.to(cuda_device)).cpu(), want)
            perm = table[:300]
            want = pool_compact(pool, perm)
            assert torch.equal(pool_compact(pool.to(cuda_device), perm.to(cuda_device)).cpu(), want)

    @pytest.mark.parametrize(
        "case", ["1000x256", "777x37", "5000x1", "130x129", "0x16", "300x64 unaligned"]
    )
    def test_clone_chain_genealogy(self, cuda_device, case):
        """test_refcount_delta_genealogy's tables through the fused chain:
        runs down the particle axis, a hot block over half a column, NULL
        tails; N off the kernel's segments, row lengths of 1, 37 and 129
        (4-byte loads), no rows, and tables whose base is not 16-byte
        aligned (4-byte loads).  Exact against the plain version."""
        rng = np.random.default_rng(2)
        nb = 500
        n, mb = (int(x) for x in case.split()[0].split("x"))
        _, old = genealogy_tables(rng, n, mb, nb)
        logw = torch.as_tensor((3 * rng.standard_normal(n)).astype(np.float32))
        cum = weights_cdf(logw) if n else torch.zeros(0)
        u = torch.as_tensor(np.float32(rng.random()))
        tables = torch.as_tensor(old)
        want = clone_chain_kernel(cum, u, tables, nb)
        t_dev = tables.to(cuda_device)
        if case.endswith("unaligned"):  # a view 4 bytes into its storage
            t_dev = torch.cat([t_dev.reshape(-1)[:1], t_dev.reshape(-1)])[1:].view(n, mb)
        got = clone_chain_kernel(cum.to(cuda_device), u.to(cuda_device), t_dev, nb)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a.cpu(), b)

    @pytest.mark.parametrize("n", [37, 4096, 65536])
    def test_clone_chain(self, cuda_device, n):
        rng = np.random.default_rng(n)
        logw = torch.as_tensor((3 * rng.standard_normal(n)).astype(np.float32))
        tables = torch.as_tensor(rng.integers(-1, 900, (n, 5)).astype(np.int32))
        u = torch.as_tensor(np.float32(rng.random()))
        cum = weights_cdf(logw.to(cuda_device))  # one CDF, fed to both
        want = clone_chain_kernel(cum.cpu(), u, tables, 900)
        got = clone_chain_kernel(cum, u.to(cuda_device), tables.to(cuda_device), 900)
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a.cpu(), b)

    def test_weights_cdf_is_deterministic(self, cuda_device):
        """A 1-D CUDA cumsum sums in a timing-dependent order; the CDF the
        comb searches must come out the same on every call."""
        logw = torch.randn(1 << 20, generator=rnd.generator(0, cuda_device), device=cuda_device)
        first = weights_cdf(logw)
        assert all(torch.equal(first, weights_cdf(logw)) for _ in range(20))


def paged_case(seed, dtype, rows=40, layers=3, bs=16, kvh=2, d=128, h=24, b=7, nb=6):
    """Paged-attention inputs on strided layer views of a
    ``[rows + 1, L, 2, bs, KVH, d]`` pool: NULL pages inside a row, a
    zero-length row, ragged lengths, and delta pages whose clean slots
    resolve through a shared parent.  Also returns the same pages as full
    blocks (``flat_*``), which the whole-block variant reads."""
    rng = np.random.default_rng(seed)
    data = torch.as_tensor(rng.standard_normal((rows + 1, layers, 2, bs, kvh, d)).astype(np.float32))
    tables = torch.as_tensor(rng.integers(0, rows // 2, (b, nb)).astype(np.int32))
    tables[1, 2] = -1  # a NULL page inside the length
    lengths = torch.as_tensor(rng.integers(1, nb * bs + 1, b).astype(np.int32))
    lengths[0] = 0
    lengths[2] = nb * bs
    # Pages rows//2.. are delta children of the pages in the first half.
    parent = torch.full((rows,), -1, dtype=torch.int32)
    dirty = torch.zeros((rows, bs), dtype=torch.bool)
    flat = data.clone()
    for child in range(rows // 2, rows):
        par = int(rng.integers(0, rows // 2))
        parent[child] = par
        dirty[child] = torch.as_tensor(rng.random(bs) < 0.3)
        flat[child] = torch.where(dirty[child][None, None, :, None, None], data[child], data[par])
        data[child] = torch.where(dirty[child][None, None, :, None, None], data[child], 0.0)
    tables[3:, 3:] += rows // 2  # rows 3.. read delta pages in their tail
    q = torch.as_tensor(rng.standard_normal((b, h, d)).astype(np.float32))
    cast = [x.to(dtype) for x in (q, data, flat)]
    return cast[0], cast[1], cast[2], tables, lengths, parent, dirty


@pytest.mark.cuda
def grads_within(got, want, frac):
    """Each gradient within ``frac`` of its plain version's largest
    magnitude, or of a hundredth of the call's largest gradient where
    that is more: a gradient that is 0 in exact arithmetic (dQ at S = 1)
    reads the rounding of the forward's output, from which the kernel
    forms rowsum(dO o O); returns the worst ratio."""
    want = [w.float().cpu() for w in want]
    largest = max(w.abs().max().item() for w in want if w.numel())
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        g = g.float().cpu()
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        if not w.numel():
            continue
        scale = max(w.abs().max().item(), 1e-2 * largest)
        worst = max(worst, (g - w).abs().max().item() / scale)
    assert worst <= frac, worst
    return worst


def flash_bwd_case(gen, shape, dtype, window):
    b, s, h, kvh, d = shape
    dev = gen.device
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(dtype)
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    return q, k, v, flash_attention(q, k, v, window=window), dout


#: The backward kernels against their plain versions (autograd of the
#: plain forward on the CPU): f32 within 1e-4 of each gradient's largest
#: magnitude (sums of up to S terms in another order), bf16 within 2e-2
#: (the inputs and outputs rounded to bf16, as the forward's check).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.cuda
class TestBackwardKernelsOnCard:
    """``flash_attention_bwd`` and ``ssd_scan_bwd`` against their plain
    versions, bit-equal repeats, and autograd through the forward kernels
    launching them once a call."""

    @pytest.mark.parametrize("d", HEAD_DIMS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("window", [0, 45])
    def test_flash_attention_bwd(self, cuda_device, d, dtype, window):
        q, k, v, out, dout = flash_bwd_case(rnd.generator(d + window, cuda_device), (2, 200, 6, 2, d),
                                            dtype, window)
        got = flash_attention_bwd(q, k, v, out, dout, window=window)
        want = flash_attention_bwd(*(t.cpu() for t in (q, k, v, out, dout)), window=window)
        grads_within(got, want, BWD_TOL[dtype])

    @pytest.mark.parametrize("d", [32, 128, 256])
    @pytest.mark.parametrize("window", [0, 45, 1000])
    @pytest.mark.parametrize("b,s,h,kvh", [(1, 1, 4, 4), (3, 63, 3, 1), (1, 300, 8, 1), (2, 130, 16, 2)])
    def test_flash_attention_bwd_tiling(self, cuda_device, d, window, b, s, h, kvh):
        """Partial tiles (S of 1, 63, 130, 300), a window inside one tile
        and one longer than S, G of 1, 3 and 8; f32."""
        q, k, v, out, dout = flash_bwd_case(rnd.generator(d + s + window, cuda_device), (b, s, h, kvh, d),
                                            torch.float32, window)
        got = flash_attention_bwd(q, k, v, out, dout, window=window)
        want = flash_attention_bwd(*(t.cpu() for t in (q, k, v, out, dout)), window=window)
        grads_within(got, want, BWD_TOL[torch.float32])

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_flash_attention_bwd_repeat_bit_equal(self, cuda_device, dtype):
        args = flash_bwd_case(rnd.generator(5, cuda_device), (2, 384, 8, 2, 128), dtype, 0)
        first = flash_attention_bwd(*args)
        second = flash_attention_bwd(*args)
        assert all(torch.equal(x, y) for x, y in zip(first, second, strict=True))

    def test_flash_attention_autograd(self, cuda_device):
        """``loss.backward()`` through the forward kernel runs the backward
        kernel once, with the gradients of a direct call."""
        q, k, v, _, dout = flash_bwd_case(rnd.generator(6, cuda_device), (2, 130, 4, 2, 64),
                                          torch.bfloat16, 0)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        dispatch.reset_launch_counts()
        out = flash_attention(*leaves)
        (out.float() * dout.float()).sum().backward()
        counts = dispatch.launch_counts()
        assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
        want = flash_attention_bwd(q, k, v, out.detach(), dout)
        assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want, strict=True))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("with_dh", [False, True])
    def test_ssd_scan_bwd(self, cuda_device, dtype, with_dh):
        """mamba2-130m's head widths (P 64, N 128, chunk 64), 3 heads."""
        gen = rnd.generator(7, cuda_device)
        args = ssd_inputs(gen, 2, 256, 3, 64, 128, dtype, cuda_device)
        dy = torch.randn((2, 256, 3, 64), generator=gen, device=cuda_device)
        dh = torch.randn((2, 3, 64, 128), generator=gen, device=cuda_device) if with_dh else None
        got = ssd_scan_bwd(*args, dy, dh)
        want = ssd_scan_bwd(*(t.cpu() for t in args), dy.cpu(), None if dh is None else dh.cpu())
        grads_within(got, want, 1e-4 if dtype == torch.float32 else 2e-2)

    @pytest.mark.parametrize("s,q,p,n", [(64, 64, 32, 48), (320, 64, 32, 48), (16, 16, 16, 16),
                                         (144, 16, 48, 32), (40, 64, 32, 16), (20, 64, 64, 128)])
    def test_ssd_scan_bwd_chunks(self, cuda_device, s, q, p, n):
        """One chunk and many, chunk 16 and 64, P tiles of 16 and 32, and
        lengths whose chunk runs over a dt = 0 tail (40, 20); f32, with
        the final state's gradient."""
        gen = rnd.generator(s + q + p, cuda_device)
        args = ssd_inputs(gen, 2, s, 5, p, n, torch.float32, cuda_device)
        dy = torch.randn((2, s, 5, p), generator=gen, device=cuda_device)
        dh = torch.randn((2, 5, p, n), generator=gen, device=cuda_device)
        got = ssd_scan_bwd(*args, dy, dh, chunk=q)
        want = ssd_scan_bwd(*(t.cpu() for t in args), dy.cpu(), dh.cpu(), chunk=q)
        grads_within(got, want, 1e-4)

    def test_ssd_scan_bwd_repeat_bit_equal(self, cuda_device):
        gen = rnd.generator(8, cuda_device)
        args = ssd_inputs(gen, 2, 512, 4, 64, 128, torch.float32, cuda_device)
        dy = torch.randn((2, 512, 4, 64), generator=gen, device=cuda_device)
        first = ssd_scan_bwd(*args, dy)
        second = ssd_scan_bwd(*args, dy)
        assert all(torch.equal(x, y) for x, y in zip(first, second, strict=True))

    def test_ssd_scan_autograd(self, cuda_device):
        """``backward()`` through the forward kernel runs the backward
        kernel once; dt and a receive their gradients through the f32
        casts ``ssd_scan`` makes."""
        gen = rnd.generator(9, cuda_device)
        x, dt, a, bm, cm = (t.clone().requires_grad_() for t in
                            ssd_inputs(gen, 1, 128, 2, 32, 32, torch.float32, cuda_device))
        dispatch.reset_launch_counts()
        y, h_last = ssd_scan(x, dt, a, bm, cm)
        (y.square().sum() + h_last.sum()).backward()
        counts = dispatch.launch_counts()
        assert counts["ssd_scan"] == 1 and counts["ssd_scan_bwd"] == 1
        leaves = [t.detach().cpu().requires_grad_() for t in (x, dt, a, bm, cm)]
        yr, hr = ssd_scan(*leaves)
        (yr.square().sum() + hr.sum()).backward()
        grads_within([t.grad for t in (x, dt, a, bm, cm)], [t.grad for t in leaves], 1e-4)


class TestPagedAttentionOnCard:
    """The paged-attention kernel against its plain version on the card, on
    strided views of a starcoder2-3b-width pool (hd 128, G = 12); bf16 to
    atol 1e-2, f32 to atol 1e-5 (sums in another order)."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("delta", [False, True])
    def test_matches_plain_version(self, cuda_device, dtype, delta):
        q, data, flat, tables, lengths, parent, dirty = paged_case(0, dtype)
        q, data, tables, lengths, parent, dirty = (
            x.to(cuda_device) for x in (q, data, tables, lengths, parent, dirty)
        )
        k_pool, v_pool = data[:, 1, 0], data[:, 1, 1]
        kw = dict(parent=parent, dirty=dirty) if delta else {}
        dispatch.reset_launch_counts()
        got = paged_attention(q, k_pool, v_pool, tables, lengths, **kw)
        want = paged_attention_ref(q, k_pool, v_pool, tables, lengths, **kw)
        torch.cuda.synchronize()
        op = "paged_attention_delta" if delta else "paged_attention"
        assert dispatch.launch_counts()[op] == 1
        atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
        assert not got[0].any()  # the zero-length row writes 0

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_variants_bit_identical_on_the_same_bytes(self, cuda_device, dtype):
        q, data, flat, tables, lengths, parent, dirty = paged_case(1, dtype)
        q, data, flat, tables, lengths, parent, dirty = (
            x.to(cuda_device) for x in (q, data, flat, tables, lengths, parent, dirty)
        )
        delta = paged_attention(
            q, data[:, 2, 0], data[:, 2, 1], tables, lengths, parent=parent, dirty=dirty
        )
        whole = paged_attention(q, flat[:, 2, 0], flat[:, 2, 1], tables, lengths)
        assert torch.equal(delta, whole)

    def test_engine_matches_cpu_path(self, cuda_device):
        """The smoke engine on the card (kernels) against the CPU path
        (plain versions), through the check ``chip_smoke.py`` runs: equal
        tables, refcounts and lengths; logits within ``LOGIT_TOL`` of the
        step's largest logit; delta on and off bit-identical on the card."""
        readings, _ = card_against_cpu(cuda_device)
        assert readings["worst_diff_over_step_max"] <= LOGIT_TOL

    @pytest.mark.parametrize("arch", ["deepseek_moe_16b", "musicgen_large"])
    def test_moe_and_audio_engines_match_cpu_path(self, cuda_device, arch):
        """The same check on deepseek's smoke config (routing equal where
        clear of ties) and musicgen's (G = 1, head dim 16)."""
        readings, _ = card_against_cpu(cuda_device, arch)
        assert readings["worst_diff_over_step_max"] <= LOGIT_TOL

    def test_compact_moves_bf16_pages_exactly(self, cuda_device):
        """pool_compact at the serving block size: [L, 2, bs, KVH, hd] bf16
        pages (491,520 bytes at starcoder2-3b) gathered as 32-bit words."""
        rng = np.random.default_rng(4)
        pool = torch.as_tensor(rng.standard_normal((9, 30, 2, 16, 2, 128)).astype(np.float32))
        pool = pool.to(torch.bfloat16)
        perm = torch.as_tensor(np.array([5, -1, 0, 7, 2], np.int32))
        want = pool_compact(pool, perm)
        got = pool_compact(pool.to(cuda_device), perm.to(cuda_device))
        assert torch.equal(got.cpu(), want)


def to_device(device, *xs):
    return tuple(x.to(device) for x in xs)


def paged_check(got, want, dtype):
    atol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), atol=atol, rtol=0)


def renumbered(data, tables, parent, dirty, seed):
    """The same pages under other ids, as ``compact_cache`` leaves them:
    pool rows permuted (the dump row stays last), tables and parents
    renumbered to match."""
    rows = parent.shape[0]
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(rows))
    new_data = data.clone()
    new_data[perm] = data[:rows]
    new_tables = torch.where(tables >= 0, perm[tables.clamp(min=0).long()].to(torch.int32), -1)
    new_parent = torch.full_like(parent, -1)
    new_parent[perm] = torch.where(parent >= 0, perm[parent.clamp(min=0).long()].to(torch.int32), -1)
    new_dirty = torch.zeros_like(dirty)
    new_dirty[perm] = dirty
    return new_data, new_tables, new_parent, new_dirty


# (b, KVH, nb, bs) the split plan meets: the serve cell, the smoke config,
# paged_case, one long row, block sizes 8 and 32, no pages, and more rows
# than the card needs splits for.
PLAN_SHAPES = [
    (16, 2, 41, 16),
    (4, 2, 9, 4),
    (7, 2, 6, 16),
    (1, 1, 2200, 16),
    (3, 8, 100, 8),
    (5, 2, 33, 32),
    (2, 2, 0, 16),
    (300, 2, 50, 16),
]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "b{}-kvh{}-nb{}-bs{}".format(*s))
def test_split_plan_covers_each_page_once(shape):
    b, kvh, nb, bs = shape
    pages, splits = split_plan(b, kvh, nb, bs)
    owners = [[sp for sp in range(splits) if sp * pages <= j < (sp + 1) * pages] for j in range(nb)]
    assert all(len(o) == 1 for o in owners)  # every page index in exactly one split
    assert splits == max(1, len({o[0] for o in owners}))  # no split past the pages
    assert pages * bs % SLOT_TILE == 0  # whole 16-slot tiles
    units = -(-nb // max(1, SLOT_TILE // bs))
    if units >= -(-MIN_CTAS // (b * kvh)):  # pages enough: two CTAs per SM
        assert b * kvh * splits >= MIN_CTAS
    assert split_plan(b, kvh, nb, bs) == (pages, splits)


def test_split_plan_reads_shapes_only():
    """The plan takes the shapes and nothing else (never tables, lengths or
    the pool), and at the serve cell's shape it puts 4 pages in each of 11
    splits: 352 CTAs on 132 SMs."""
    assert list(inspect.signature(split_plan).parameters) == ["b", "kvh", "nb", "bs"]
    assert split_plan(16, 2, 41, 16) == (4, 11)
    with pytest.raises(ValueError, match="block size"):
        split_plan(1, 1, 4, 12)


@pytest.mark.parametrize("case", ["head_dim", "group", "stride", "base"])
def test_kernel_input_checks_refuse(case):
    """What the CUDA route refuses (it checks before any launch)."""
    q, data, _, tables, lengths, _, _ = paged_case(0, torch.bfloat16, rows=4, layers=1, b=3, nb=3)
    k_pool, v_pool = data[:, 0, 0], data[:, 0, 1]
    check_kernel_inputs(q, k_pool, v_pool)
    if case == "head_dim":
        q, k_pool = q[..., :48].contiguous(), k_pool[..., :48].contiguous()
        v_pool = k_pool
    elif case == "group":
        q = torch.zeros((3, 34, 128), dtype=torch.bfloat16)
    elif case == "stride":
        k_pool = v_pool = torch.zeros((5, 16, 2, 130), dtype=torch.bfloat16)[..., :128]
    else:
        flat = torch.zeros(5 * 16 * 2 * 128 + 8, dtype=torch.bfloat16)
        k_pool = v_pool = flat[1 : 1 + 5 * 16 * 2 * 128].view(5, 16, 2, 128)
    with pytest.raises(ValueError):
        check_kernel_inputs(q, k_pool, v_pool)


# (G, d) the repository's dense configs give (G 5: qwen2.5-32b).
GROUP_DIMS = [(1, 128), (2, 128), (12, 128), (5, 128), (2, 64), (2, 256)]


@pytest.mark.cuda
class TestPagedAttentionSplits:
    """The split kernel against its plain version on the card: split
    edges, NULL splits, every (G, d) of the dense configs, repeat calls and
    renumbered pools.  bf16 to atol 1e-2, f32 to atol 1e-5."""

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("delta", [False, True])
    def test_split_edges(self, cuda_device, dtype, delta):
        """The serve cell's shape (16 rows of 41 pages of 16, G 12, d 128:
        4 pages a split): lengths at a split edge, one past and one short of
        it, shorter than one split, zero and full; a split made only of
        NULL pages; a row whose pages past its first split are all NULL."""
        b, nb, bs = 16, 41, 16
        q, data, _, tables, lengths, parent, dirty = paged_case(
            7, dtype, rows=80, layers=1, b=b, nb=nb
        )
        pages, _ = split_plan(b, 2, nb, bs)
        edge = pages * bs
        lengths = torch.tensor(
            [0, 1, 5, edge - 1, edge, edge + 1, 2 * edge, 2 * edge + 1, 3 * edge - 1,
             7 * edge + 3, nb * bs - 1, nb * bs, 3 * edge + 5, nb * bs, edge + 2, 9 * edge],
            dtype=torch.int32,
        )
        tables[12, pages : 2 * pages] = -1  # split 1 of row 12: NULL pages only
        tables[13, pages:] = -1  # row 13: nothing past split 0
        q, data, tables, lengths, parent, dirty = to_device(
            cuda_device, q, data, tables, lengths, parent, dirty
        )
        kw = dict(parent=parent, dirty=dirty) if delta else {}
        args = (q, data[:, 0, 0], data[:, 0, 1], tables, lengths)
        got = paged_attention(*args, **kw)
        paged_check(got, paged_attention_ref(*args, **kw), dtype)
        assert not got[0].any()

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("delta", [False, True])
    @pytest.mark.parametrize("group,d", GROUP_DIMS)
    def test_group_and_head_dim(self, cuda_device, group, d, delta, dtype):
        q, data, _, tables, lengths, parent, dirty = paged_case(
            8, dtype, layers=1, d=d, h=2 * group
        )
        q, data, tables, lengths, parent, dirty = to_device(
            cuda_device, q, data, tables, lengths, parent, dirty
        )
        kw = dict(parent=parent, dirty=dirty) if delta else {}
        args = (q, data[:, 0, 0], data[:, 0, 1], tables, lengths)
        paged_check(paged_attention(*args, **kw), paged_attention_ref(*args, **kw), dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_long_rows_use_the_ring(self, cuda_device, dtype):
        """3 rows of 600 pages: 13 pages a split, so each warp takes three
        to seven tiles through its two-stage ring; then a repeat call."""
        q, data, _, tables, lengths, parent, dirty = paged_case(
            9, dtype, layers=1, b=3, nb=600
        )
        assert split_plan(3, 2, 600, 16) == (13, 47)
        lengths = torch.tensor([600 * 16, 5003, 17], dtype=torch.int32)
        q, data, tables, lengths, parent, dirty = to_device(
            cuda_device, q, data, tables, lengths, parent, dirty
        )
        args = (q, data[:, 0, 0], data[:, 0, 1], tables, lengths)
        kw = dict(parent=parent, dirty=dirty)
        got = paged_attention(*args, **kw)
        paged_check(got, paged_attention_ref(*args, **kw), dtype)
        assert torch.equal(got, paged_attention(*args, **kw))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("delta", [False, True])
    def test_two_calls_bit_equal(self, cuda_device, dtype, delta):
        q, data, _, tables, lengths, parent, dirty = paged_case(
            10, dtype, rows=80, layers=1, b=16, nb=41
        )
        q, data, tables, lengths, parent, dirty = to_device(
            cuda_device, q, data, tables, lengths, parent, dirty
        )
        kw = dict(parent=parent, dirty=dirty) if delta else {}
        args = (q, data[:, 0, 0], data[:, 0, 1], tables, lengths)
        first = paged_attention(*args, **kw)
        assert all(torch.equal(first, paged_attention(*args, **kw)) for _ in range(5))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("delta", [False, True])
    def test_renumbered_pool_bit_equal(self, cuda_device, dtype, delta):
        """Pool rows permuted, tables (and parents) renumbered to match:
        the same bytes in the same order, so the same bits."""
        q, data, _, tables, lengths, parent, dirty = paged_case(
            11, dtype, rows=80, layers=1, b=16, nb=41
        )
        moved = renumbered(data, tables, parent, dirty, seed=11)
        outs = []
        for d_, t_, p_, dy in ((data, tables, parent, dirty), moved):
            qd, d_, t_, ld, p_, dy = to_device(cuda_device, q, d_, t_, lengths, p_, dy)
            kw = dict(parent=p_, dirty=dy) if delta else {}
            outs.append(paged_attention(qd, d_[:, 0, 0], d_[:, 0, 1], t_, ld, **kw))
        assert torch.equal(outs[0], outs[1])


def shared_stacks(device, n=256):
    """PCFG stacks with every cell written, each cloned to two rows (LAZY
    freezes the shared blocks), and a masked write's arguments: even rows
    at depth MAX_DEPTH - 1, every third row masked off."""
    scfg = pcfg._stack_cfg(n, CopyMode.LAZY)
    gen = rnd.generator(3, "cpu")  # one stream of values on every device
    stack = tstore.create(scfg, device)
    ids = torch.arange(n, device=device)
    for depth in range(pcfg.MAX_DEPTH):
        values = rnd.uniform(gen, (n,)).to(device)
        stack = tstore.write_at(scfg, stack, torch.full((n,), depth, device=device), values)
    stack = tstore.clone(scfg, stack, (ids // 2).to(torch.int32))
    positions = torch.where(ids % 2 == 0, pcfg.MAX_DEPTH - 1, ids % pcfg.MAX_DEPTH).to(torch.int32)
    return scfg, stack, positions, rnd.uniform(gen, (n,)).to(device), ids % 3 != 0


def test_masked_stack_write_at_the_top_on_the_cpu():
    """A masked write_at at MAX_DEPTH - 1 on shared LAZY stacks: written
    rows copy their block and change one cell, masked rows change nothing,
    the dump row stays zero."""
    scfg, stack, positions, values, mask = shared_stacks("cpu")
    before = tstore.materialize_batch(scfg, stack, torch.arange(scfg.n))
    after = tstore.write_at(scfg, stack, positions, values, mask=mask)
    cells = tstore.materialize_batch(scfg, after, torch.arange(scfg.n))
    rows = torch.arange(scfg.n)
    want = before.clone()
    want[rows[mask], positions[mask].long()] = values[mask]
    assert torch.equal(cells, want) and not after.pool.data[-1].any() and not bool(after.pool.oom)


@pytest.mark.cuda
class TestProgramsOnCard:
    """PCFG's stack on the card: its masked writes and its clone against
    the plain versions on the path's own inputs."""

    def test_pcfg_stack_writes_and_clone_match_plain(self, cuda_device, monkeypatch):
        kept = {"writes": [], "clones": []}
        write, refcount = tstore.cow_write, tstore.refcount_update

        def keep_write(data, src, dst, pos, values):
            if data.dim() == 2:  # the stack's pool: [blocks + 1, 8] cells
                kept["writes"].append((data.clone(), src.clone(), dst.clone(), pos.clone(), values.clone()))
            return write(data, src, dst, pos, values)

        def keep_refcount(rc, frozen, new, old, *, do_freeze):
            kept["clones"].append((new.clone(), old.clone(), rc.shape[0]))
            return refcount(rc, frozen, new, old, do_freeze=do_freeze)

        monkeypatch.setattr(tstore, "cow_write", keep_write)
        monkeypatch.setattr(tstore, "refcount_update", keep_refcount)
        ssm, _ = pcfg.build(CopyMode.LAZY)
        obs = pcfg.gen_data(rnd.generator(0, cuda_device), 12)
        cfg = FilterConfig(n_particles=256, n_steps=12, mode=CopyMode.LAZY)
        res = ParticleFilter(ssm, cfg, device=cuda_device).run(
            rnd.generator(1, cuda_device), pcfg.default_params(cuda_device), obs
        )
        assert not bool(res.oom) and kept["writes"] and kept["clones"]
        for data, src, dst, pos, values in kept["writes"]:
            got = cow_write(data.clone(), src, dst, pos, values)
            assert torch.equal(got[:-1], cow_write_ref(data.clone(), src, dst, pos, values)[:-1])
            assert not got[-1].any()
        for new, old, nb in kept["clones"]:
            flat = new.reshape(-1).contiguous(), old.reshape(-1).contiguous()
            got = refcount_delta(*flat, nb, row=new.shape[-1])
            assert all(torch.equal(a, b) for a, b in zip(got, refcount_delta_ref(*flat, nb), strict=True))

    def test_masked_stack_write_at_the_top_equals_the_cpu(self, cuda_device):
        card = shared_stacks(cuda_device)
        cpu = shared_stacks("cpu")
        got = tstore.write_at(card[0], *card[1:4], mask=card[4])
        want = tstore.write_at(cpu[0], *cpu[1:4], mask=cpu[4])
        assert torch.equal(got.pool.data[:-1].cpu(), want.pool.data[:-1]) and not got.pool.data[-1].any()
        assert torch.equal(got.tables.cpu(), want.tables)
        assert torch.equal(got.pool.refcount.cpu(), want.pool.refcount)
