"""BAD: remap discarded; captures read stale across compact/grow."""

from repro_torch.core import pool as pool_lib


def drop_remap(pool):
    pool, _ = pool_lib.compact(pool)  # remap bound to '_': tables now stale
    return pool


def never_read(pool):
    pool, remap = pool_lib.compact(pool)  # remap never read afterwards
    return pool


def stale_tables(pool, consume):
    t = pool.tables
    pool, remap = pool_lib.compact(pool)
    consume(remap)
    return pool, t.sum()  # 't' holds pre-relocation ids


def stale_view(pool, extra):
    data = pool.data
    pool = pool_lib.grow(pool, extra)
    return pool, data.sum()  # 'data' aliases the pre-grow tensor


def stale_free_stack(pool, extra):
    stack = pool.free_stack[: int(pool.free_top)]
    pool = pool_lib.grow(pool, extra)  # grow builds a new free stack
    return pool, stack.tolist()
