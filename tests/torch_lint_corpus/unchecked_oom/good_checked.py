"""GOOD: the exhaustion signal is consulted between alloc and read."""

from repro_torch.core import store as store_lib


def checked(cfg, store, pos, vals):
    store = store_lib.write_at(cfg, store, pos, vals)
    if bool(store_lib.oom_flag(cfg, store)):
        raise MemoryError("pool exhausted")
    return store_lib.read_at(cfg, store, pos)


def strict(cfg, store, vals):
    store = store_lib.append(cfg, store, vals)
    store_lib._check_oom(cfg, store, "read_last")  # raises under strict_oom
    return store_lib.read_last(cfg, store)


def read_only(cfg, store, pos):
    return store_lib.read_at(cfg, store, pos)  # no alloc: nothing to gate
