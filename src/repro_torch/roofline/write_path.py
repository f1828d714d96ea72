"""Analytic HBM-traffic model for the COW write path (the port's copy of
``repro.roofline.write_path``: arithmetic only, no device).

The paper's bound (Algorithms 3/5, Remark 1) is that a write moves at
most one block (the COW copy) and a clone moves none — everything else
is bookkeeping.  This module prices three implementations of that
contract in bytes moved and HBM passes, so benchmarks and tests can
compare them on hosts with no card.  The path names are the reference's,
kept so that both packages' benches read the same table:

``legacy``
    the reference's first array path: an O(num_blocks) ``nonzero``
    free-scan per alloc, a dense gather of *every* row's source block,
    a masked block-copy scatter, a separate item scatter, and separate
    refcount passes — six round-trips over pool state per append.
``fused_jnp``
    the composed array path (the port's plain versions in
    ``kernels/*/ref.py``): free-stack alloc (O(n) pops), one fused
    gather + one scatter over all n rows (masked rows self-copy the
    dump row), single-pass clone bookkeeping.
``kernel``
    the hand-written kernels: one block read + one block write per
    *touched* row (cow_write), tables read once per clone
    (refcount_update); skipped rows cost a cache-resident dump-row
    self-copy, charged 0 HBM bytes.

The model is the charitable in-place one: scatters are charged for the
rows they write, not for their full operand.  All callers of the model
pass ``touched``/``copies`` counts, so masked ``write_at`` sweeps price
correctly.
"""

from __future__ import annotations

import dataclasses

WRITE_PATHS = ("legacy", "fused_jnp", "kernel")

_ID = 4  # int32 bookkeeping entry bytes


@dataclasses.dataclass(frozen=True)
class WriteCost:
    """Bytes moved and HBM passes for one store operation.

    ``passes`` counts round-trips over pool/block-shaped state (the
    "six HBM round-trips" of the legacy path); ``bytes`` is the total
    traffic under the in-place model above.
    """

    passes: int
    bytes: int

    def speedup_over(self, other: "WriteCost") -> float:
        """How much less traffic ``self`` moves than ``other``."""
        return other.bytes / max(self.bytes, 1)


def append_cost(
    path: str,
    *,
    n: int,
    touched: int,
    copies: int,
    num_blocks: int,
    block_bytes: int,
    item_bytes: int,
    delta: bool = False,
    dirty_items: int = 0,
) -> WriteCost:
    """One ``append``/``write_at`` over ``n`` rows.

    ``touched``: rows that actually write (unmasked, non-OOM);
    ``copies``: the subset that COWs a shared block.  For the paper's
    motivating append-heavy pattern ``touched == n`` and ``copies`` is
    the post-resampling divergence front.

    ``delta`` (kernel path only) prices the sub-block delta COW of
    DESIGN.md §3.2: a COW moves only the ``dirty_items`` slots the
    writer has materialized — touched-slice bytes plus the dirty-bitmask
    and parent-pointer bookkeeping — instead of ``block_bytes``.  A
    single-element write to a freshly shared full block has
    ``dirty_items == 0``: the copy reads the (cache-resident, charged 0)
    dump row and moves no payload at all.  A write that fills the mask
    (``dirty_items == block_size - 1``) degenerates the page back to a
    full block: it pays the near-whole-block slice but sheds the
    mask/parent overhead, so a dense delta COW never exceeds the
    whole-block kernel cost.
    """
    if path == "legacy":
        scan = 2 * num_blocks * _ID  # nonzero over the free mask
        gather = 2 * n * block_bytes  # every row's source block, dense
        copy_scatter = n * block_bytes + copies * block_bytes
        item_scatter = n * item_bytes + touched * item_bytes
        bookkeeping = 3 * 2 * n * _ID  # alloc refcount+frozen, release
        return WriteCost(
            passes=6, bytes=scan + gather + copy_scatter + item_scatter + bookkeeping
        )
    if path == "fused_jnp":
        gather = 2 * n * block_bytes  # src rows (dump rows included)
        scatter = n * block_bytes  # one fused write, item pre-merged
        bookkeeping = 3 * 2 * n * _ID + 2 * n * _ID  # alloc pops + claim push
        return WriteCost(passes=3, bytes=gather + scatter + bookkeeping)
    if path == "kernel":
        scalars = 3 * n * _ID + n * item_bytes  # prefetched src/dst/pos + values
        bookkeeping = 3 * 2 * n * _ID
        if delta:
            block_size = max(block_bytes // max(item_bytes, 1), 1)
            di = min(dirty_items, block_size - 1)
            # The COW copy streams only the materialized slice.
            data = 2 * copies * di * item_bytes
            # Dirty-bitmask row + parent pointer, read and rewritten per
            # touched row — unless this write fills the mask, in which
            # case the page degenerates and the bookkeeping is cleared
            # rather than carried.
            mask_bytes = -(-block_size // 8)
            overhead = (
                0 if di + 1 >= block_size else 2 * touched * (mask_bytes + _ID)
            )
            return WriteCost(passes=2, bytes=data + overhead + scalars + bookkeeping)
        data = 2 * touched * block_bytes  # one read + one write per touched row
        return WriteCost(passes=2, bytes=data + scalars + bookkeeping)
    raise ValueError(f"unknown write path {path!r}; want one of {WRITE_PATHS}")


def grow_cost(*, old_blocks: int, block_bytes: int) -> WriteCost:
    """One pool ``grow`` (DESIGN.md §3.1): every retained payload row is
    read once and written once into the larger allocation (fresh rows are
    zero-fill, charged nothing under the in-place model), plus one pass
    over the int32 bookkeeping (refcount + frozen + free stack).  The
    lifecycle policy doubles capacity per event, so total growth traffic
    for a run that ends at ``B`` blocks telescopes to < ``4·B·block_bytes``
    — amortized O(1) bytes per block ever allocated, which is why growth
    at generation boundaries does not disturb the paper's O(DT + DN log DN)
    steady state."""
    data = 2 * old_blocks * block_bytes
    bookkeeping = 3 * 2 * old_blocks * _ID
    return WriteCost(passes=1, bytes=data + bookkeeping)


def compact_cost(
    *, live: int, num_blocks: int, table_entries: int, block_bytes: int
) -> WriteCost:
    """One pool ``compact`` + table rewrite (DESIGN.md §3.1): the
    ``cow_gather``-based relocation streams each *live* block once
    (read + write at its dense slot); the remap build and bookkeeping
    rewrite are one pass over the int32 pool state, and every table
    entry is read and rewritten through the remap."""
    data = 2 * live * block_bytes
    bookkeeping = 3 * 2 * num_blocks * _ID
    tables = 2 * table_entries * _ID
    return WriteCost(passes=2, bytes=data + bookkeeping + tables)


def clone_cost(
    path: str,
    *,
    table_entries: int,
    num_blocks: int,
) -> WriteCost:
    """One resampling ``clone`` (``table_entries = n * max_blocks``).

    Lazy clones move zero payload in every implementation; the model
    prices the bookkeeping passes: legacy walks the tables three times
    (``add_refs``/``sub_refs``/``freeze``) with a refcount round-trip
    each, the fused paths walk them once and apply one delta.
    """
    if path == "legacy":
        tables = 3 * table_entries * _ID
        refcount = 3 * 2 * num_blocks * _ID
        return WriteCost(passes=3, bytes=tables + refcount)
    if path in ("fused_jnp", "kernel"):
        tables = 2 * table_entries * _ID  # new + old, read once
        refcount = 2 * num_blocks * _ID  # one delta apply
        push = 2 * num_blocks * _ID  # newly-freed mask -> stack
        return WriteCost(passes=1, bytes=tables + refcount + push)
    raise ValueError(f"unknown write path {path!r}; want one of {WRITE_PATHS}")


def chain_cost(
    path: str,
    *,
    n: int,
    table_entries: int,
    num_blocks: int,
) -> WriteCost:
    """One full resampling step: systematic resample -> table gather ->
    clone bookkeeping (``table_entries = n * max_blocks``).

    ``legacy``/``fused_jnp`` is the composed path — three dispatches,
    each re-reading its operands from HBM: the inverse-CDF search (CDF
    build + ancestor write), the ancestor-indexed table gather, and the
    single-pass clone bookkeeping over new + old tables.  ``kernel`` is
    the fused :mod:`repro_torch.kernels.clone_chain` op: the tables are read
    **once** and the ancestors never round-trip through HBM between
    stages — one pass instead of three.
    """
    if path in ("legacy", "fused_jnp"):
        resample = 3 * n * _ID  # logw/CDF read + ancestor write
        gather = 2 * table_entries * _ID  # ancestors' rows read, new written
        bookkeeping = 2 * table_entries * _ID + 2 * num_blocks * _ID
        return WriteCost(passes=3, bytes=resample + gather + bookkeeping)
    if path == "kernel":
        resample = 2 * n * _ID  # CDF read once, ancestors written once
        tables = 2 * table_entries * _ID  # old read once, new written once
        refcount = 2 * num_blocks * _ID  # one delta apply
        return WriteCost(passes=1, bytes=resample + tables + refcount)
    raise ValueError(f"unknown write path {path!r}; want one of {WRITE_PATHS}")
