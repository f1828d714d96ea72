"""BAD: block-id arrays leak into value arithmetic/concat/payload."""

import torch

from repro_torch.core import pool as pool_lib
from repro_torch.kernels.cow_write import cow_write
from repro_torch.serving import kv_cache as kvc


def ids_into_math(pool, values):
    pool, bids = pool_lib.alloc(pool, 4)
    return pool, values + bids  # ids are addresses, not operands


def ids_into_concat(pool, values):
    pool, bids = pool_lib.alloc(pool, 4)
    return pool, torch.cat([values, bids.to(values.dtype)])


def ids_as_payload(pool, mask, tables):
    pool, bids = pool_lib.alloc(pool, 4)
    pool = pool_lib.write_blocks(pool, mask, bids)  # ids written as values
    return pool, tables


def ids_through_view(tables, values):
    flat = tables.view(-1).long()
    return values * flat  # still ids after view/long


def ids_as_kv(cfg, cache, bids, pos, v, mask):
    k = bids[:, None, None].expand(-1, cfg.n_kv_heads, cfg.head_dim)  # ids as K
    return kvc.write_kv(cfg, cache, bids, pos, 0, k, v, mask)


def ids_through_cow_write(data, src, dst, pos, tables):
    return cow_write(data, src, dst, pos, tables[:, 0])  # ids as the item
