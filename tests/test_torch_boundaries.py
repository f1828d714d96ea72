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
from repro_torch.kernels.cow_write import cow_write  # noqa: E402
from repro_torch.kernels.refcount_update import refcount_delta  # noqa: E402
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
        ref_name = f"{name if name != 'refcount_update' else 'refcount_delta'}_ref"
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
