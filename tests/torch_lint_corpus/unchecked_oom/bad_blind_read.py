"""BAD: results materialized after allocation with no exhaustion check."""

from repro_torch.core import pool as pool_lib
from repro_torch.core import store as store_lib


def blind(cfg, store, vals):
    store = store_lib.append(cfg, store, vals)
    return store_lib.read_last(cfg, store)  # dump-row garbage under OOM


def blind_blocks(pool, n):
    pool, bids = pool_lib.alloc(pool, n)
    return pool_lib.read_blocks(pool, bids)  # NULL ids read block 0
