"""GOOD: ids used as indices (gather) and for address arithmetic only."""

import torch

from repro_torch.core import pool as pool_lib


def gather_payload(pool, tables, step):
    bids = tables[:, step]
    payload = pool.data[bids.long()]  # ids as index: gathers values
    return payload * 2.0


def address_offsets(tables):
    nxt = tables + 1  # int-literal offset: address arithmetic, allowed
    return torch.where(nxt >= 0, nxt, 0)


def id_to_id(pool, tables, remap):
    fresh = pool_lib.remap_tables(tables, remap)
    return torch.cat([fresh, tables])  # ids with ids: consistent


def index_select_payload(pool, tables):
    rows = pool.data.index_select(0, tables.reshape(-1).long())  # values
    return rows * 0.5


def gather_values(values, tables):
    picked = torch.gather(values, 1, tables.long())  # ids as the index
    return picked + values
