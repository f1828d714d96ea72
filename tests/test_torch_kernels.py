"""The port's kernel ops against the JAX reference, on the CPU.

Each COW op (``cow_write_delta`` included) and ``resample`` runs its
plain PyTorch version here (CPU tensors) and must equal, bit for bit,
both the reference's jnp oracle and its Pallas kernel in interpret mode,
on the same numpy inputs — NULL entries, masked rows and duplicate ids
included.  The float kernels' plain versions (paged attention, flash
attention, the SSD scan) are held to the TPU kernels to stated
tolerances.  The CUDA kernels
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

from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.kernels.clone_chain.kernel import clone_chain_pallas  # noqa: E402
from repro.kernels.clone_chain.ref import clone_chain_ref as jax_clone_chain_ref  # noqa: E402
from repro.kernels.cow_gather import cow_gather as jax_cow_gather  # noqa: E402
from repro.kernels.cow_gather import pool_compact as jax_pool_compact  # noqa: E402
from repro.kernels.cow_write import cow_write as jax_cow_write  # noqa: E402
from repro.kernels.cow_write.kernel import cow_write_delta_pallas  # noqa: E402
from repro.kernels.cow_write.ref import cow_write_delta_ref as jax_cow_write_delta_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash_attention  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.paged_attention import paged_attention as jax_paged_attention  # noqa: E402
from repro.kernels.refcount_update import refcount_update as jax_refcount_update  # noqa: E402
from repro.kernels.refcount_update.kernel import refcount_delta_pallas  # noqa: E402
from repro.kernels.refcount_update.ref import refcount_delta_ref as jax_delta_ref  # noqa: E402
from repro.kernels.resample.kernel import resample_systematic_pallas  # noqa: E402
from repro.kernels.resample.ref import resample_systematic_ref as jax_resample_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref  # noqa: E402
from repro_torch import random as rnd  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.clone_chain import (  # noqa: E402
    clone_chain_kernel,
    comb_positions,
)
from repro_torch.kernels.cow_gather import cow_gather, pool_compact  # noqa: E402
from repro_torch.kernels.cow_write import cow_write, cow_write_delta  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.ops import HEAD_DIMS as FLASH_HEAD_DIMS  # noqa: E402
from repro_torch.kernels.flash_attention.ops import _lse_buffer, tensor_core_route  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention  # noqa: E402
from repro_torch.kernels.refcount_update import (  # noqa: E402
    refcount_delta,
    refcount_update,
)
from repro_torch.kernels.resample import (  # noqa: E402
    PLANTED,
    planted_cdfs,
    resample_systematic_kernel,
    systematic_comb,
)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import bwd_plan, card_plan  # noqa: E402

pytest.importorskip("hypothesis", reason="property tests need hypothesis (dev extra)")
from hypothesis import given, settings, strategies as st  # noqa: E402


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


def delta_case(seed, nb=24, n=12, item_shape=(1,), block_size=4, keep_dtype=bool):
    """Delta-COW routing as store._write_impl builds it: write_case's copy,
    in-place and masked rows, with a keep mask that is all set on in-place
    rows, random on copy rows, and clear on copy rows that read the dump
    row instead of their source (nothing to keep)."""
    data, src, dst, pos, values = write_case(seed, nb, n, item_shape, block_size)
    rng = np.random.default_rng(seed + 100)
    copy = (src != dst) & (dst != nb)
    keep = np.where(copy[:, None], rng.random((n, block_size)) < 0.5, True)
    empty = copy & (rng.random(n) < 0.3)
    empty[np.flatnonzero(copy)[:1]] = True  # at least one row reads nothing
    keep[empty] = False
    src = np.where(copy & ~keep.any(1), nb, src).astype(np.int32)
    return data, src, dst, pos, values, keep.astype(keep_dtype)


class TestCowWriteDelta:
    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("item_shape", [(1,), (), (3,)])
    def test_matches_reference(self, seed, item_shape):
        """Bit-exact with the reference's jnp oracle and its Pallas kernel
        in interpret mode, dump row (re-zeroed) and rows with nothing to
        keep included."""
        data, src, dst, pos, values, keep = delta_case(seed, item_shape=item_shape)
        assert (src == data.shape[0] - 1).sum() > (dst == data.shape[0] - 1).sum()
        args = [jnp.asarray(x) for x in (data, src, dst, pos, values)]
        want_ref = np.asarray(jax_cow_write(*args, keep=jnp.asarray(keep), use_kernel=False))
        want_kernel = np.asarray(
            jax_cow_write(*args, keep=jnp.asarray(keep), use_kernel=True, interpret=True)
        )
        got_data = t(data)
        out = cow_write_delta(got_data, t(src), t(dst), t(pos), t(values), t(keep))
        assert out is got_data  # in place
        eq(out, want_ref)
        eq(out, want_kernel)
        nb = data.shape[0] - 1
        eq(out[:nb], np.asarray(jax_cow_write_delta_ref(*args, jnp.asarray(keep)))[:nb])
        assert not out[nb].any()

    def test_uint8_keep_and_pallas_entry(self):
        data, src, dst, pos, values, keep = delta_case(7, keep_dtype=np.uint8)
        flat = jnp.asarray(data.reshape(data.shape[0], -1))
        want = np.asarray(cow_write_delta_pallas(
            flat, *[jnp.asarray(x) for x in (src, dst, pos)],
            jnp.asarray(values.reshape(values.shape[0], -1)), jnp.asarray(keep.astype(np.int32)),
            interpret=True,
        )).reshape(data.shape)
        out = cow_write_delta(t(data), t(src), t(dst), t(pos), t(values), t(keep))
        nb = data.shape[0] - 1
        eq(out[:nb], want[:nb])

    def test_keep_all_is_the_whole_block_write(self):
        data, src, dst, pos, values = write_case(3)
        keep = np.ones((src.shape[0], data.shape[1]), bool)
        whole = cow_write(t(data), t(src), t(dst), t(pos), t(values))
        delta = cow_write_delta(t(data), t(src), t(dst), t(pos), t(values), t(keep))
        assert torch.equal(whole, delta)

    @settings(max_examples=25, deadline=None, derandomize=True, database=None)
    @given(
        st.integers(0, 2**31 - 1),
        st.sampled_from([(), (1,), (2,)]),
        st.integers(1, 6),
    )
    def test_random_routing(self, seed, item_shape, block_size):
        data, src, dst, pos, values, keep = delta_case(
            seed, item_shape=item_shape, block_size=block_size
        )
        args = [jnp.asarray(x) for x in (data, src, dst, pos, values)]
        want = np.asarray(jax_cow_write(*args, keep=jnp.asarray(keep), use_kernel=False))
        eq(cow_write_delta(t(data), t(src), t(dst), t(pos), t(values), t(keep)), want)

    def test_rejects_bad_inputs(self):
        data, src, dst, pos, values, keep = delta_case(0)
        with pytest.raises(TypeError):
            cow_write_delta(t(data), t(src), t(dst), t(pos), t(values), t(keep).int())
        with pytest.raises(ValueError):
            cow_write_delta(t(data), t(src), t(dst), t(pos), t(values), t(keep)[:, :-1])


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


    @pytest.mark.parametrize("shape", [(20, 15), (300,), (1, 300), (300, 1), (60, 5)])
    @pytest.mark.parametrize("with_row", [False, True])
    def test_delta_row_keyword_matches_reference(self, shape, with_row):
        """The row length changes no result: 2-D and 1-D tables, with and
        without the keyword, equal the oracle and the Pallas kernel."""
        nb = 40
        new, old = table_case(11, nb, e=int(np.prod(shape)))
        row = shape[-1] if with_row else None
        want = [jax_delta_ref(jnp.asarray(new), jnp.asarray(old), nb),
                refcount_delta_pallas(jnp.asarray(new), jnp.asarray(old), num_blocks=nb, interpret=True)]
        got = refcount_delta(t(new), t(old), nb, row=row)
        for want_d, want_m in want:
            eq(got[0], want_d)
            eq(got[1], want_m)

    @pytest.mark.parametrize("shape", [(64, 9), (576,)])
    @pytest.mark.parametrize("do_freeze", [False, True])
    def test_update_on_genealogy_tables(self, shape, do_freeze):
        """Tables as resampling leaves them (runs of one block down the
        particle axis, NULL tails), 2-D and flat: ``refcount_update``
        equals the reference's, through its Pallas kernel."""
        nb = 30
        rng = np.random.default_rng(5)
        old = np.sort(rng.integers(0, nb, (64, 9)), axis=0).astype(np.int32)
        old[np.arange(9)[None, :] >= rng.integers(0, 10, 64)[:, None]] = -1
        new = old[np.sort(rng.integers(0, 64, 64))]
        new, old = new.reshape(shape), old.reshape(shape)
        refcount = np.bincount(old[old >= 0], minlength=nb).astype(np.int32)
        frozen = rng.integers(0, 2, nb).astype(bool)
        want = jax_refcount_update(
            jnp.asarray(refcount), jnp.asarray(frozen), jnp.asarray(new),
            jnp.asarray(old), do_freeze=do_freeze, use_kernel=True, interpret=True,
        )
        got = refcount_update(t(refcount), t(frozen), t(new), t(old), do_freeze=do_freeze)
        for a, b in zip(got, want, strict=True):
            eq(a, b)

    @pytest.mark.parametrize("row", [0, 7, -3])
    def test_delta_rejects_a_row_that_does_not_divide(self, row):
        new, old = table_case(0, 40, e=300)
        with pytest.raises(ValueError, match="row length"):
            refcount_delta(t(new), t(old), 40, row=row)


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

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_pool_compact_at_kv_page_size(self, dtype):
        """Pages of the serving pool, [L, 2, bs, KVH, hd] (491,520 bytes at
        starcoder2-3b in bf16): bf16 pages move as 32-bit words."""
        rng = np.random.default_rng(3)
        data = rng.standard_normal((7, 30, 2, 16, 2, 128)).astype(np.float32)
        data[6] = 0
        jdata = jnp.asarray(data, dtype=dtype)
        perm = np.array([4, -1, 0, 5, 2], np.int32)
        want = jax_pool_compact(jdata, jnp.asarray(perm), use_kernel=False)
        got = pool_compact(convert._tensor(np.asarray(jdata), "cpu"), t(perm))
        assert got.dtype == getattr(torch, dtype)
        eq(got.float(), np.asarray(want).astype(np.float32))


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


def genealogy_chain_case(n, mb, nb=500):
    """A weight CDF peaked enough for long runs of one ancestor, and old
    tables with each column sorted down the particle axis, block 7 over
    the first half of column 0, and NULL past each row's length."""
    rng = np.random.default_rng(n * 1000 + mb)
    logw = (3 * rng.standard_normal(n)).astype(np.float32)
    w = np.exp(logw - logw.max())
    cum = np.cumsum(w, dtype=np.float32)
    cum = (cum / cum[-1]).astype(np.float32)
    u = np.float32(rng.random())
    tables = np.sort(rng.integers(0, nb, (n, mb)), axis=0).astype(np.int32)
    tables[: max(1, n // 2), 0] = 7
    lengths = rng.integers(mb // 2, mb + 1, n)
    tables[np.arange(mb)[None, :] >= lengths[:, None]] = -1
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

    @pytest.mark.parametrize("case", ["1x37", "130x129", "777x1", "777x256", "64x37", "256x256"])
    def test_genealogy_tables(self, case):
        """Tables as resampling leaves them, the inputs the card's kernel
        follows in runs: each column a sorted block sequence down the
        particle axis, a hot block over half of column 0, NULL tails; the
        comb's ancestors sorted.  N off the kernel's segments (1, 130,
        777) and row lengths of 1, 37, 129 and 256.  Exact against the
        eager oracle and, for a power-of-two N, the Pallas kernel."""
        n, mb = (int(x) for x in case.split("x"))
        cum, u, tables, nb = genealogy_chain_case(n, mb)
        got = clone_chain_kernel(t(cum), t(np.array([u])), t(tables), nb)
        wants = [jax_clone_chain_ref(jnp.asarray(cum), jnp.float32(u), jnp.asarray(tables), nb)]
        if n & (n - 1) == 0:
            wants.append(clone_chain_pallas(
                jnp.asarray(cum), jnp.asarray([u]), jnp.asarray(tables), num_blocks=nb, interpret=True,
            ))
        for want in wants:
            for a, b in zip(got, want, strict=True):
                eq(a, b)
        if n > 100:  # the premise: the new table repeats a block down each column
            new = got[1].numpy()
            assert (new[1:] == new[:-1]).mean() > 0.5

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
        # Every op of the reference's registry has its port.
        assert set(jax_dispatch.KNOWN_OPS) <= set(dispatch.KNOWN_OPS)
        with pytest.raises(ValueError):
            dispatch.get_op("no_such_op")

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
        q, k_pool, v_pool, ptables, lengths, parent, dirty = paged_case(0)
        pargs = [t(x) for x in (q, k_pool, v_pool, ptables, lengths)]
        paged_attention(*pargs)
        paged_attention(*pargs, parent=t(parent), dirty=t(dirty))
        data, src, dst, pos, values, keep = delta_case(1)
        cow_write_delta(t(data), t(src), t(dst), t(pos), t(values), t(keep))
        systematic_comb(t(cum), t(np.array([u])))
        q, k, v = attention_case(0, 2, 32, 4, 2, 16, np.float32)
        flash_attention(t(q), t(k), t(v))
        ssd_scan(*[t(x) for x in ssd_case(0, 1, 16, 2, 4, 8)], chunk=8)
        assert dispatch.launch_counts() == {name: 0 for name in dispatch.KNOWN_OPS}


def paged_case(seed, b=6, h=6, kvh=2, d=16, bs=4, nb=5, rows=24):
    """Paged-attention inputs at the smoke width: NULL entries (one inside
    a row's length), a zero-length row, ragged lengths, and delta pages
    (the second half of the pool) whose clean slots read a parent that
    other rows' tables also name."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k_pool = rng.standard_normal((rows + 1, bs, kvh, d)).astype(np.float32)
    v_pool = rng.standard_normal((rows + 1, bs, kvh, d)).astype(np.float32)
    tables = rng.integers(0, rows, (b, nb)).astype(np.int32)
    tables[1, 1] = -1
    tables[4, 3:] = -1
    tables[2, 0] = tables[3, 0] = rows // 2  # a delta page, twice
    tables[3, 1] = 3  # ... and its parent, read directly
    lengths = rng.integers(1, nb * bs + 1, b).astype(np.int32)
    lengths[0] = 0
    lengths[5] = nb * bs
    parent = np.full(rows, -1, np.int32)
    parent[rows // 2 :] = rng.integers(0, rows // 2, rows - rows // 2)
    parent[rows // 2] = 3
    dirty = rng.random((rows, bs)) < 0.4
    dirty[: rows // 2] = False
    return q, k_pool, v_pool, tables, lengths, parent, dirty


class TestPagedAttention:
    """The plain version against the JAX oracle (rows with length > 0; the
    oracle returns V's mean on an empty row, the TPU kernels 0) and against
    both Pallas kernels in interpret mode on every row.  Float sums in
    another order: atol 1e-5."""

    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("delta", [False, True])
    def test_matches_reference(self, seed, delta):
        q, k_pool, v_pool, tables, lengths, parent, dirty = paged_case(seed)
        jargs = [jnp.asarray(x) for x in (q, k_pool, v_pool, tables, lengths)]
        targs = [t(x) for x in (q, k_pool, v_pool, tables, lengths)]
        jkw = dict(parent=jnp.asarray(parent), dirty=jnp.asarray(dirty)) if delta else {}
        tkw = dict(parent=t(parent), dirty=t(dirty)) if delta else {}
        got = paged_attention(*targs, **tkw).numpy()
        oracle = np.asarray(jax_paged_attention(*jargs, **jkw, use_kernel=False))
        kernel = np.asarray(jax_paged_attention(*jargs, **jkw, use_kernel=True, interpret=True))
        live = lengths > 0
        np.testing.assert_allclose(got[live], oracle[live], atol=1e-5, rtol=0)
        np.testing.assert_allclose(got, kernel, atol=1e-5, rtol=0)
        assert not got[0].any()  # zero-length row

    def test_variants_agree_on_full_pages(self):
        """With every parent NULL the delta variant reads what the whole-page
        variant reads, so the two are bit-identical."""
        q, k_pool, v_pool, tables, lengths, _, dirty = paged_case(5)
        args = [t(x) for x in (q, k_pool, v_pool, tables, lengths)]
        parent = torch.full((k_pool.shape[0] - 1,), -1, dtype=torch.int32)
        delta = paged_attention(*args, parent=parent, dirty=t(dirty))
        assert torch.equal(delta, paged_attention(*args))

    def test_strided_pool_views(self):
        """The engine passes one layer's slice of the [rows, L, 2, bs, KVH, d]
        pool; the result is that of the same pages made contiguous."""
        q, k_pool, v_pool, tables, lengths, _, _ = paged_case(6)
        pool = torch.stack([t(k_pool), t(v_pool)], dim=1)[:, None].repeat(1, 3, 1, 1, 1, 1)
        views = paged_attention(t(q), pool[:, 1, 0], pool[:, 1, 1], t(tables), t(lengths))
        dense = paged_attention(t(q), t(k_pool), t(v_pool), t(tables), t(lengths))
        assert torch.equal(views, dense)

    def test_rejects_bad_inputs(self):
        q, k_pool, v_pool, tables, lengths, parent, dirty = paged_case(0)
        args = [t(x) for x in (q, k_pool, v_pool, tables, lengths)]
        with pytest.raises(TypeError):
            paged_attention(args[0].double(), *args[1:])
        with pytest.raises(ValueError):
            paged_attention(*args[:3], args[3][:-1], args[4])
        with pytest.raises(ValueError):
            paged_attention(args[0], args[1][..., :8], args[2][..., :8], *args[3:])
        with pytest.raises(TypeError):
            paged_attention(*args, parent=t(parent).long(), dirty=t(dirty))


class TestResample:
    """The comb against the reference's oracle and its Pallas kernel, given
    the same CDF and uniform: bit for bit (power-of-two n: the jitted
    reference divides by n as a reciprocal multiply)."""

    @pytest.mark.parametrize("seed", range(3))
    @pytest.mark.parametrize("n", [128, 256, 1024])
    def test_matches_reference(self, seed, n):
        cum, u, _, _ = chain_case(seed, n)
        got = systematic_comb(t(cum), t(np.array([u])))
        eq(got, jax_resample_ref(jnp.asarray(cum), jnp.asarray([u])))
        eq(got, resample_systematic_pallas(jnp.asarray(cum), jnp.asarray([u]), interpret=True))
        assert got.dtype == torch.int32

    @pytest.mark.parametrize("n", [256, 2048])
    @pytest.mark.parametrize("case", PLANTED)
    def test_planted_cdfs(self, case, n):
        """The CDFs the card tests hold the kernel to (one particle holding
        all the weight, zero-weight runs, a last entry below 1, u = 0 and
        the largest float32 below 1, ties): the plain version against the
        reference's oracle and its Pallas kernel, bit for bit.  The oracle
        does not clip to n - 1 (the Pallas kernel does), so it is clipped
        here."""
        cum, u = planted_cdfs(n, seed=n)[case]
        got = systematic_comb(cum, u)
        jc, ju = jnp.asarray(cum.numpy()), jnp.asarray(u.numpy())
        eq(got, np.minimum(np.asarray(jax_resample_ref(jc, ju)), n - 1))
        eq(got, resample_systematic_pallas(jc, ju, interpret=True))
        if case == "clip":
            assert int((got == n - 1).sum()) > 1

    def test_weight_path_draws_one_uniform(self):
        """Softmax, fixed-order CDF, ``cum / cum[-1]``, one uniform of shape
        (1,) from the generator, then the comb; sorted valid ancestors."""
        logw = torch.as_tensor((3 * np.random.default_rng(0).standard_normal(256)).astype(np.float32))
        replay = rnd.Replay([("uniform", np.array([0.25], np.float32))])
        anc = resample_systematic_kernel(replay, logw)
        assert replay.remaining == 0
        cum = torch.cumsum(torch.softmax(logw, 0), 0)
        eq(anc, systematic_comb(cum / cum[-1], torch.tensor([0.25])))
        assert anc.min() >= 0 and anc.max() < 256 and bool((anc.diff() >= 0).all())

    def test_degenerate_weight(self):
        logw = torch.full((128,), -float("inf"))
        logw[37] = 0.0
        anc = resample_systematic_kernel(rnd.generator(0, "cpu"), logw)
        assert bool((anc == 37).all())


def attention_case(seed, b, s, h, kvh, d, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (
        rng.standard_normal((b, s, heads, d)).astype(np.float32) for heads in (h, kvh, kvh)
    )
    return q, k, v


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


class TestFlashAttention:
    """The plain version against the reference's Pallas kernel in interpret
    mode over ``tests/test_kernels.py``'s sweep (window included), to that
    file's ``tol(dtype)``; inputs rounded to bf16 the same way on both
    sides."""

    @pytest.mark.parametrize(
        "s,h,kvh,d,window,bq,bk",
        [
            (128, 4, 4, 64, 0, 64, 64),  # MHA
            (128, 8, 2, 64, 0, 32, 64),  # GQA 4x
            (256, 4, 1, 32, 0, 128, 128),  # MQA
            (128, 4, 2, 64, 32, 32, 32),  # sliding window (gemma local)
            (192, 6, 2, 64, 0, 64, 64),  # starcoder-like head count
        ],
    )
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_reference_kernel(self, s, h, kvh, d, window, bq, bk, dtype):
        q, k, v = attention_case(s + h, 2, s, h, kvh, d, dtype)
        jargs = [jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in (q, k, v)]
        targs = [t(x).to(getattr(torch, dtype)) for x in (q, k, v)]
        want = jax_flash_attention(*jargs, window=window, block_q=bq, block_k=bk, interpret=True)
        got = flash_attention(*targs, window=window)
        assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol(dtype))

    @pytest.mark.parametrize("window", [0, 17])
    def test_matches_reference_oracle(self, window):
        q, k, v = attention_case(1, 2, 80, 6, 3, 16, "float32")
        want = jax_flash_ref(*[jnp.asarray(x).swapaxes(1, 2) for x in (q, k, v)], window=window)
        got = flash_attention(t(q), t(k), t(v), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.swapaxes(1, 2)), rtol=2e-5, atol=2e-5)

    @pytest.mark.parametrize("window", [0, 17])
    def test_gradient_matches_reference(self, window):
        """``flash_attention_bwd``'s plain version (autograd of the plain
        forward) against ``jax.vjp`` of the reference's oracle, f32, 2e-5
        of each gradient's largest magnitude; ``backward()`` through
        ``flash_attention`` on CPU tensors gives the same gradients."""
        q, k, v = attention_case(2, 2, 80, 6, 3, 16, "float32")
        dout = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
        swap = lambda x: x.swapaxes(1, 2)  # noqa: E731
        _, vjp = jax.vjp(lambda *a: swap(jax_flash_ref(*map(swap, a), window=window)),
                         *[jnp.asarray(x) for x in (q, k, v)])
        want = vjp(jnp.asarray(dout))
        got = flash_attention_bwd(t(q), t(k), t(v), t(q), t(dout), window=window)
        leaves = [t(x).requires_grad_() for x in (q, k, v)]
        (flash_attention(*leaves, window=window) * t(dout)).sum().backward()
        for g, a, w in zip(got, leaves, want, strict=True):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max())
            np.testing.assert_allclose(a.grad.numpy(), g.numpy(), rtol=1e-6, atol=1e-7)
        assert dispatch.launch_counts()["flash_attention_bwd"] == 0

    def test_tensor_core_route(self):
        """The (dtype, head dim) pairs whose forward and backward run on the
        tensor cores: bf16 at 64, 112, 128 and 256; f32 everywhere and bf16
        at 16 and 32 stay on the CUDA cores.  The backward's row
        log-sum-exp buffer is padded to whole 64-row tiles."""
        pairs = [(dt, d) for dt in (torch.float32, torch.bfloat16) for d in FLASH_HEAD_DIMS
                 if tensor_core_route(dt, d)]
        assert pairs == [(torch.bfloat16, 64), (torch.bfloat16, 112), (torch.bfloat16, 128), (torch.bfloat16, 256)]
        assert not tensor_core_route(torch.float16, 128)
        q = torch.zeros((2, 130, 6, 64), dtype=torch.bfloat16)
        assert _lse_buffer(q).shape == (2, 6, 192) and _lse_buffer(q).dtype == torch.float32

    def test_rejects_bad_inputs(self):
        q, k, v = attention_case(0, 1, 16, 4, 2, 8, "float32")
        with pytest.raises(TypeError):
            flash_attention(t(q), t(k).double(), t(v))
        with pytest.raises(ValueError):
            flash_attention(t(q), t(k)[:, :, :1], t(v))


def ssd_case(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)  # softplus
    a = (-np.exp(0.3 * rng.standard_normal(h))).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


class TestSSDScan:
    """The plain version (the port's copy of ``ssd_chunked``) against the
    reference's oracle and its Pallas kernel in interpret mode: 2e-4 on
    f32 inputs, 5e-2 on bf16 inputs (against the reference on the same
    values in f32), as ``tests/test_kernels.py`` holds the kernel."""

    @pytest.mark.parametrize(
        "s,q,h,p,n",
        [(64, 16, 2, 8, 16), (64, 64, 3, 8, 16), (128, 32, 2, 16, 32), (32, 8, 1, 4, 8)],
    )
    def test_matches_reference(self, s, q, h, p, n):
        args = ssd_case(s + q + h, 2, s, h, p, n)
        yk, hk = jax_ssd_scan(*[jnp.asarray(x) for x in args], chunk=q, interpret=True)
        yr, hr = jax_ssd_scan_ref(*[jnp.asarray(x) for x in args], chunk=q)
        y, hf = ssd_scan(*[t(x) for x in args], chunk=q)
        assert y.dtype == hf.dtype == torch.float32
        for got, want in ((y, yk), (y, yr), (hf, hk), (hf, hr)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)

    def test_bf16_inputs(self):
        x, dt, a, bm, cm = ssd_case(5, 1, 32, 2, 8, 8)
        x, bm, cm = (t(v).to(torch.bfloat16) for v in (x, bm, cm))
        y, hf = ssd_scan(x, t(dt), t(a), bm, cm, chunk=8)
        yr, hr = jax_ssd_scan_ref(
            *[jnp.asarray(v.float().numpy()) for v in (x,)], jnp.asarray(dt), jnp.asarray(a),
            jnp.asarray(bm.float().numpy()), jnp.asarray(cm.float().numpy()), chunk=8,
        )
        np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=5e-2, atol=5e-2)
        np.testing.assert_allclose(hf.numpy(), np.asarray(hr), rtol=5e-2, atol=5e-2)

    @pytest.mark.parametrize("s,q,with_dh", [(64, 16, True), (64, 64, False), (96, 32, True)])
    def test_gradient_matches_reference(self, s, q, with_dh):
        """``ssd_scan_bwd``'s plain version against ``jax.vjp`` of the
        reference's oracle for the output's gradient and, where given, the
        final state's: every input's gradient within 2e-5 of its largest
        magnitude (f32 sums in other orders)."""
        args = ssd_case(s + q, 2, s, 3, 8, 16)
        rng = np.random.default_rng(s)
        dy = rng.standard_normal((2, s, 3, 8)).astype(np.float32)
        dh = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
        _, vjp = jax.vjp(lambda *a: jax_ssd_scan_ref(*a, chunk=q), *[jnp.asarray(x) for x in args])
        want = vjp((jnp.asarray(dy), jnp.asarray(dh if with_dh else np.zeros_like(dh))))
        got = ssd_scan_bwd(*[t(x) for x in args], t(dy), t(dh) if with_dh else None, chunk=q)
        for g, w in zip(got, want, strict=True):
            w = np.asarray(w)
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max())

    def test_bwd_plan_at_mamba2_widths(self):
        """The backward's plan at mamba2-130m's training shape (B = 2, S =
        4,096, H 24, P 64, N 128, chunk 64): both chunk-parallel launches a
        CTA per (group of 4 heads, chunk, batch), 768 of them, more than the
        card's 132 SMs (the kernel it replaced ran 96 in all); a thread per
        four state elements for the recurrences; shared memory within the
        227 KB a CTA may take; scratch for the chunk states and increments
        (100.7 MB apiece) and the partials; a chunk above 64, P no multiple
        of 16 or tiles beyond a CTA's shared memory raise."""
        plan = bwd_plan(2, 4096, 24, 64, 128, 64)
        assert (plan["heads"], plan["groups"]) == (4, 6)
        assert plan["states_ctas"] == plan["grads_ctas"] == 2 * 64 * 6 >= 132
        assert plan["recur_threads"] == 2 * 24 * 64 * 128 // 4
        assert (plan["states_smem"], plan["grads_smem"]) == (106_752, 226_336)
        assert max(plan["states_smem"], plan["grads_smem"]) < 232_448
        assert plan["state_floats"] == 2 * 24 * 64 * 64 * 128 and plan["state_floats"] * 4 == 100_663_296
        assert plan["tot_floats"] == 2 * 24 * 64 and plan["da_floats"] == 2 * 64 * 24
        assert plan["part_floats"] == 6 * 2 * 4096 * 128
        assert bwd_plan(1, 64, 5, 48, 32, 16)["groups"] == 2
        for shape in ((1, 128, 2, 64, 128, 128), (1, 64, 2, 24, 32, 64), (1, 64, 2, 32, 512, 64)):
            with pytest.raises(ValueError):
                bwd_plan(*shape)

    @pytest.mark.parametrize(
        "shape",
        [(64, 24, 32, 64), (64, 32, 40, 64), (72, 32, 32, 24), (64, 32, 32, 0),
         (128, 64, 128, 128), (64, 64, 512, 64), (64, 64, 128, 80)],
    )
    def test_bwd_plan_refuses(self, shape):
        """The backward's refusals, before any launch: P, N or the chunk not
        a multiple of 16 (or 0), or tiles beyond a CTA's shared memory
        (chunk 128 or 80 at N 128; N 512): ValueError."""
        s, p, n, q = shape
        with pytest.raises(ValueError):
            bwd_plan(1, s, 2, p, n, q)

    def test_card_plan_at_mamba2_widths(self):
        """The card's launch plan at mamba2-130m's widths (B = 4, S = 2,048,
        H = 24, P 64, N 128, chunk 64): 896 chunk-parallel CTAs (the kernel
        it replaced ran 96 in all), the pass one CTA per (b, head) with all
        of P, within the shared memory a CTA may take, and the scratch the
        wrapper allocates."""
        plan = card_plan(4, 2048, 24, 64, 128, 64, torch.float32)
        assert (plan["chunk_ctas"], plan["pass_ctas"], plan["p_tile"]) == (896, 96, 64)
        assert (plan["chunk_smem"], plan["pass_smem"]) == (70_656, 207_872)
        assert plan["cb_floats"] == 4 * 32 * 64 * 64 and plan["sc_floats"] == 4 * 24 * 32 * 64 * 128
        bf16 = card_plan(4, 2048, 24, 64, 128, 64, torch.bfloat16, p_tile=16)
        assert bf16["pass_ctas"] == 384 and bf16["pass_smem"] < plan["pass_smem"]
        assert card_plan(4, 2048, 24, 64, 128, 64, torch.float32, heads=24)["chunk_ctas"] == 4 * 32 * 2
        assert [card_plan(1, 64, 2, p, 32, 64, torch.float32)["p_tile"] for p in (16, 32, 48, 96)] == [
            16, 32, 16, 32]

    @pytest.mark.parametrize(
        "shape,kw",
        [((64, 24, 32, 64), {}), ((64, 32, 40, 64), {}), ((72, 32, 32, 24), {}),
         ((64, 48, 32, 64), {"p_tile": 32}), ((64, 32, 32, 64), {"p_tile": 8}),
         ((64, 32, 32, 64), {"p_tile": 64}),
         ((128, 64, 128, 128), {}), ((64, 32, 32, 64), {"heads": 0})],
    )
    def test_card_plan_refuses(self, shape, kw):
        """P, N or the chunk not a multiple of 16, a P tile that is not 16,
        32 or 64 or does not divide P, no heads, or tiles beyond a CTA's
        shared memory (chunk 128 at N 128 in f32): ValueError, before any
        launch."""
        s, p, n, q = shape
        with pytest.raises(ValueError):
            card_plan(1, s, 2, p, n, q, torch.float32, **kw)

    def test_chunk_invariance(self):
        args = [t(x) for x in ssd_case(9, 1, 64, 2, 8, 16)]
        y1, h1 = ssd_scan(*args, chunk=16)
        y2, h2 = ssd_scan(*args, chunk=64)
        torch.testing.assert_close(y1, y2, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h1, h2, rtol=2e-4, atol=2e-4)
