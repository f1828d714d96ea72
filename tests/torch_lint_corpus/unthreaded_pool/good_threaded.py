"""GOOD: successors threaded; checkpoints held but never re-entered."""

from repro_torch.core import pool as pool_lib
from repro_torch.core import store as store_lib


def threaded(pool, ids):
    pool = pool_lib.add_refs(pool, ids)
    pool = pool_lib.sub_refs(pool, ids)
    return pool


def checkpoint(pool, ids):
    saved = pool  # rollback handle: held, never passed back to the API
    pool = pool_lib.add_refs(pool, ids)
    if int(pool.free_top) < 0:
        return saved
    return pool


def store_threaded(cfg, store, pos, vals):
    store = store_lib.write_at(cfg, store, pos, vals)
    if bool(store_lib.oom_flag(cfg, store)):
        raise MemoryError("store exhausted")
    return store_lib.read_at(cfg, store, pos)


def chained(cfg, store, gen, logw):
    store, anc = store_lib.clone_chain(cfg, store, gen, logw)
    return store_lib.append(cfg, store, logw[:, None]), anc


def cascade(pool, freed):
    stack, top = pool_lib.push_free_mask(pool.free_stack, pool.free_top, freed)
    pool = pool._replace(free_stack=stack, free_top=top)
    return pool_lib.release_parents(pool, freed)
