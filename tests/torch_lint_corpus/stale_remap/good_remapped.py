"""GOOD: remap applied to every capture; views re-read after grow."""

from repro_torch.core import pool as pool_lib


def refresh_tables(pool):
    t = pool.tables
    pool, remap = pool_lib.compact(pool)
    t = pool_lib.remap_tables(t, remap)
    return pool, t.sum()


def reread_view(pool, extra):
    pool = pool_lib.grow(pool, extra)
    data = pool.data  # captured *after* the grow: fresh alias
    return pool, data.sum()


def shrink_to_fit(pool, tables, live):
    pool, remap = pool_lib.compact(pool, live)
    return pool, pool_lib.remap_tables(tables, remap)
