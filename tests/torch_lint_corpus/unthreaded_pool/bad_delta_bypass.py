"""BAD: delta-COW token writes that bypass ``ensure_writable`` threading.

Under ``delta_cow`` the sub-block copy, the dirty-mask marking, and the
parent refcount all happen inside ``kvc.ensure_writable``.  Dropping its
returned cache — or writing K/V through the pre-call binding — skips the
COW bookkeeping and writes into a shared page (or a delta parent every
sibling still resolves through).
"""

from repro_torch.serving import kv_cache as kvc


def discarded_ensure(cfg, cache, mask):
    kvc.ensure_writable(cfg, cache, mask)  # result discarded: no COW happened
    return cache


def write_through_stale_cache(cfg, cache, k, v, mask):
    cache2, bid, pos = kvc.ensure_writable(cfg, cache, mask)
    # stale 'cache': the delta page, dirty bits and parent refs live in
    # cache2 — this write lands in the still-shared source page
    return kvc.write_kv(cfg, cache, bid, pos, 0, k, v, mask), cache2
