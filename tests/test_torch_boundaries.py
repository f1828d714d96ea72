"""The PyTorch port's boundaries: what it imports, where it runs, that
the plain versions never see a CUDA tensor, and that each CUDA kernel
equals its plain version on the card.

This file imports no jax, so the ``cuda``-marked tests run on a GPU host
that has none:
``python -m pytest -q --noconftest -m cuda tests/test_torch_boundaries.py``.
"""

from __future__ import annotations

import ast
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
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.refcount_update import refcount_delta  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref  # noqa: E402
from repro_torch.kernels.resample import resample_systematic_kernel, systematic_comb  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.serving import crosscheck as cc  # noqa: E402
from repro_torch.serving.crosscheck import LOGIT_TOL, card_against_cpu, smoke_program  # noqa: E402
from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        ParticleFilter(lgssm(), FilterConfig(n_particles=4, n_steps=4, mesh=object()), device="cpu")
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
    q = torch.randn((1, 130, 4, 64), generator=gen, device=cuda_device)
    kv = torch.randn((1, 130, 2, 64), generator=gen, device=cuda_device)
    flash_attention(q, kv, kv, window=32)
    ssd_scan(*ssd_inputs(gen, 1, 128, 2, 16, 32, torch.float32, cuda_device))
    torch.cuda.synchronize()
    assert all(count > 0 for count in dispatch.launch_counts().values())


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

    @pytest.mark.parametrize("n", [1000, 4096, 65536])
    def test_resample(self, cuda_device, n):
        rng = np.random.default_rng(n)
        w = np.exp(3 * rng.standard_normal(n)).astype(np.float32)
        cum = torch.as_tensor(np.cumsum(w, dtype=np.float32))
        cum = cum / cum[-1]
        u = torch.as_tensor(np.array([rng.random()], np.float32))
        want = systematic_comb(cum, u)
        assert torch.equal(systematic_comb(cum.to(cuda_device), u.to(cuda_device)).cpu(), want)

    @pytest.mark.parametrize("d", HEAD_DIMS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("window", [0, 45])
    def test_flash_attention(self, cuda_device, d, dtype, window):
        """Against the plain version on the card: S = 200 (a partial last
        tile), 6 heads over 2 KV heads; bf16 atol 2e-2, f32 2e-5 (sums in
        another order)."""
        gen = rnd.generator(d + window, cuda_device)
        q = torch.randn((2, 200, 6, d), generator=gen, device=cuda_device).to(dtype)
        k = torch.randn((2, 200, 2, d), generator=gen, device=cuda_device).to(dtype)
        v = torch.randn((2, 200, 2, d), generator=gen, device=cuda_device).to(dtype)
        got = flash_attention(q, k, v, window=window)
        want = flash_attention(q.cpu(), k.cpu(), v.cpu(), window=window)
        assert got.dtype == dtype
        atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        torch.testing.assert_close(got.float().cpu(), want.float(), atol=atol, rtol=atol)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_ssd_scan(self, cuda_device, dtype):
        """mamba2-130m's head widths (P = 64, N = 128, chunk 64) against the
        plain version on the card, 2e-4 (both compute in f32)."""
        args = ssd_inputs(rnd.generator(3, cuda_device), 2, 256, 3, 64, 128, dtype, cuda_device)
        y, h = ssd_scan(*args)
        yr, hr = ssd_scan(*[a.cpu() for a in args])
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
