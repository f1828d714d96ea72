"""BAD: threading-API results discarded or stale bindings re-entered."""

from repro_torch.core import pool as pool_lib
from repro_torch.core import store as store_lib


def leak_refs(pool, tables):
    pool_lib.add_refs(pool, tables)  # result discarded: refcounts lost
    return pool


def underscore_discard(pool, tables):
    _ = pool_lib.sub_refs(pool, tables)  # '_' is still a discard
    return pool


def lost_update(pool, ids):
    pool2 = pool_lib.sub_refs(pool, ids)
    pool3 = pool_lib.add_refs(pool, ids)  # stale 'pool': loses the sub_refs
    return pool2, pool3


def dropped_cascade(pool, freed):
    pool_lib.release_parents(pool, freed)  # the parents keep their refs
    return pool


def stale_after_chain(cfg, store, gen, logw):
    chained, anc = store_lib.clone_chain(cfg, store, gen, logw)
    # stale 'store': the clone's refcounts and freeze bits are in 'chained'
    return store_lib.append(cfg, store, logw[:, None]), anc, chained
