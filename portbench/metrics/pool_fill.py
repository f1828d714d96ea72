"""The largest ``store.peak_blocks`` of the window's runs over the pool's
capacity (%): the program's own counters."""


def read(ctx):
    peak, pool = ctx.counters.get("peak_blocks"), ctx.counters.get("pool_blocks", 0)
    if not peak or pool <= 0:
        return None
    return 100.0 * max(peak) / pool
