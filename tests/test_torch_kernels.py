"""The port's kernel ops against the JAX reference, on the CPU.

Each of the four ported ops runs its plain PyTorch version here (CPU
tensors) and must equal, bit for bit, both the reference's jnp oracle
and its Pallas kernel in interpret mode, on the same numpy inputs —
NULL entries, masked rows and duplicate ids included.  The CUDA kernels
themselves are compared with these plain versions on the card by
``chip_smoke.py`` and by the ``cuda``-marked tests in
``test_torch_boundaries.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.clone_chain.kernel import clone_chain_pallas  # noqa: E402
from repro.kernels.clone_chain.ref import clone_chain_ref as jax_clone_chain_ref  # noqa: E402
from repro.kernels.cow_gather import cow_gather as jax_cow_gather  # noqa: E402
from repro.kernels.cow_gather import pool_compact as jax_pool_compact  # noqa: E402
from repro.kernels.cow_write import cow_write as jax_cow_write  # noqa: E402
from repro.kernels.refcount_update import refcount_update as jax_refcount_update  # noqa: E402
from repro.kernels.refcount_update.kernel import refcount_delta_pallas  # noqa: E402
from repro.kernels.refcount_update.ref import refcount_delta_ref as jax_delta_ref  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.clone_chain import (  # noqa: E402
    clone_chain_kernel,
    comb_positions,
)
from repro_torch.kernels.cow_gather import cow_gather, pool_compact  # noqa: E402
from repro_torch.kernels.cow_write import cow_write  # noqa: E402
from repro_torch.kernels.refcount_update import (  # noqa: E402
    refcount_delta,
    refcount_update,
)


def t(x):
    return torch.as_tensor(np.array(x))


def eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def write_case(seed, nb=24, n=10, item_shape=(1,), block_size=4):
    """COW-write routing as store._write_impl builds it: copy rows
    (several sharing one source), in-place rows, masked rows on the
    dump row."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((nb + 1, block_size, *item_shape)).astype(np.float32)
    data[nb] = 0
    ids = rng.permutation(nb).astype(np.int32)
    shared = ids[:3]  # copy sources
    fresh = ids[3 : 3 + n]  # distinct destinations
    kind = rng.integers(0, 3, n)  # 0 copy, 1 in place, 2 masked
    src = np.where(kind == 0, rng.choice(shared, n), fresh).astype(np.int32)
    dst = fresh.copy()
    src[kind == 2] = nb
    dst[kind == 2] = nb
    pos = rng.integers(0, block_size, n).astype(np.int32)
    values = rng.standard_normal((n, *item_shape)).astype(np.float32)
    return data, src, dst, pos, values


class TestCowWrite:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("item_shape", [(1,), (), (3,)])
    def test_matches_reference(self, seed, item_shape):
        data, src, dst, pos, values = write_case(seed, item_shape=item_shape)
        args = [jnp.asarray(x) for x in (data, src, dst, pos, values)]
        want_ref = np.asarray(jax_cow_write(*args, use_kernel=False))
        want_kernel = np.asarray(jax_cow_write(*args, use_kernel=True, interpret=True))
        got_data = t(data)
        out = cow_write(got_data, t(src), t(dst), t(pos), t(values))
        assert out is got_data  # in place, as the TPU kernel's aliased output
        nb = data.shape[0] - 1
        eq(out[:nb], want_ref[:nb])
        eq(out[:nb], want_kernel[:nb])
        assert not out[nb].any()  # dump row re-zeroed

    def test_rejects_bad_inputs(self):
        data, src, dst, pos, values = write_case(0)
        with pytest.raises(TypeError):
            cow_write(t(data), t(src).long(), t(dst), t(pos), t(values))
        with pytest.raises(ValueError):
            cow_write(t(data), t(src)[:-1], t(dst), t(pos), t(values))


def table_case(seed, nb=40, e=300):
    rng = np.random.default_rng(seed)
    old = rng.integers(-1, nb, e).astype(np.int32)
    new = old[rng.integers(0, e, e)]  # resampled: duplicates and NULLs
    return new, old


class TestRefcountUpdate:
    @pytest.mark.parametrize("seed", range(4))
    def test_delta_matches_reference(self, seed):
        nb = 40
        new, old = table_case(seed, nb)
        d_ref, m_ref = jax_delta_ref(jnp.asarray(new), jnp.asarray(old), nb)
        d_k, m_k = refcount_delta_pallas(
            jnp.asarray(new), jnp.asarray(old), num_blocks=nb, interpret=True
        )
        delta, member = refcount_delta(t(new), t(old), nb)
        assert delta.dtype == torch.int32 and member.dtype == torch.bool
        for want_d, want_m in ((d_ref, m_ref), (d_k, m_k)):
            eq(delta, want_d)
            eq(member, want_m)

    @pytest.mark.parametrize("do_freeze", [False, True])
    def test_update_matches_reference(self, do_freeze):
        nb = 40
        rng = np.random.default_rng(7)
        new, old = table_case(3, nb)
        refcount = np.bincount(old[old >= 0], minlength=nb).astype(np.int32)
        frozen = rng.integers(0, 2, nb).astype(bool)
        want = jax_refcount_update(
            jnp.asarray(refcount), jnp.asarray(frozen), jnp.asarray(new),
            jnp.asarray(old), do_freeze=do_freeze, use_kernel=True, interpret=True,
        )
        got = refcount_update(
            t(refcount), t(frozen), t(new).reshape(20, 15), t(old).reshape(20, 15),
            do_freeze=do_freeze,
        )
        for a, b in zip(got, want, strict=True):
            eq(a, b)


class TestCowGather:
    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("block_shape", [(4, 1), (3,), (2, 3)])
    def test_matches_reference(self, seed, block_shape):
        rng = np.random.default_rng(seed)
        rows = 17
        pool = rng.standard_normal((rows, *block_shape)).astype(np.float32)
        table = rng.integers(-1, rows, 50).astype(np.int32)
        got = cow_gather(t(pool), t(table))
        eq(got, jax_cow_gather(jnp.asarray(pool), jnp.asarray(table), use_kernel=False))
        eq(got, jax_cow_gather(jnp.asarray(pool), jnp.asarray(table), interpret=True))

    @pytest.mark.parametrize("target", [8, 12, 20])
    def test_pool_compact_matches_reference(self, target):
        rng = np.random.default_rng(target)
        data = rng.standard_normal((13, 4, 1)).astype(np.float32)
        perm = np.full(target, -1, np.int32)
        live = np.sort(rng.choice(12, min(target, 7), replace=False)).astype(np.int32)
        perm[: live.size] = live
        want = jax_pool_compact(jnp.asarray(data), jnp.asarray(perm), interpret=True)
        got = pool_compact(t(data), t(perm))
        eq(got, want)
        assert got.shape == (target + 1, 4, 1) and not got[target].any()


def chain_case(seed, n, mb=5, nb=60):
    rng = np.random.default_rng(seed)
    logw = (3 * rng.standard_normal(n)).astype(np.float32)
    logw[rng.integers(0, n, max(1, n // 8))] = -30.0  # near-zero weights
    w = np.exp(logw - logw.max())
    cum = np.cumsum(w, dtype=np.float32)
    cum = (cum / cum[-1]).astype(np.float32)
    u = np.float32(rng.random())
    tables = rng.integers(-1, nb, (n, mb)).astype(np.int32)
    return cum, u, tables, nb


class TestCloneChain:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("n", [5, 37, 100])
    def test_matches_reference_oracle(self, seed, n):
        """Against the eager oracle, which divides as the port does."""
        cum, u, tables, nb = chain_case(seed, n)
        want = jax_clone_chain_ref(jnp.asarray(cum), jnp.float32(u), jnp.asarray(tables), nb)
        got = clone_chain_kernel(t(cum), t(u), t(tables), nb)
        for a, b in zip(got, want, strict=True):
            eq(a, b)

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("n", [8, 64])
    def test_matches_reference_kernel(self, seed, n):
        """Against the Pallas kernel.  XLA's jit rewrites ``x / n`` as
        ``x * (1 / n)``, which is exact only for a power-of-two ``n``; the
        port (and the card's kernel) divide, as the eager oracle does."""
        cum, u, tables, nb = chain_case(seed, n)
        want = clone_chain_pallas(
            jnp.asarray(cum), jnp.asarray([u]), jnp.asarray(tables),
            num_blocks=nb, interpret=True,
        )
        got = clone_chain_kernel(t(cum), t(np.array([u])), t(tables), nb)
        for a, b in zip(got, want, strict=True):
            eq(a, b)

    @pytest.mark.parametrize("n", [3, 37, 1000, 65535])
    def test_comb_positions_are_ieee_division(self, n):
        u = np.float32(0.7)
        want = (np.arange(n, dtype=np.float32) + u) / np.float32(n)
        eq(comb_positions(torch.tensor(u), n), want)
        eq(comb_positions(torch.tensor(u), n), (jnp.arange(n) + u) / n)  # eager jnp


class TestDispatch:
    def test_registry_resolves_wrappers(self):
        for name in dispatch.KNOWN_OPS:
            assert isinstance(dispatch.get_op(name).launches, int)
        with pytest.raises(ValueError):
            dispatch.get_op("paged_attention")

    def test_route_policy(self):
        cpu = torch.zeros(2)
        assert dispatch.route(cpu, cpu) == "cpu"
        with pytest.raises(ValueError):
            dispatch.route(torch.zeros(2, device="meta"))
        with pytest.raises(ValueError):
            cow_gather(torch.zeros((3, 4), device="meta"), torch.zeros(2, dtype=torch.int32, device="meta"))

    def test_cpu_path_counts_no_launch(self):
        dispatch.reset_launch_counts()
        data, src, dst, pos, values = write_case(1)
        cow_write(t(data), t(src), t(dst), t(pos), t(values))
        new, old = table_case(1)
        refcount_delta(t(new), t(old), 40)
        cow_gather(t(data), t(src))
        cum, u, tables, nb = chain_case(1, 16)
        clone_chain_kernel(t(cum), t(u), t(tables), nb)
        assert dispatch.launch_counts() == {name: 0 for name in dispatch.KNOWN_OPS}
