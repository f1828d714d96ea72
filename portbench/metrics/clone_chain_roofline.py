"""``clone_chain_kernel``'s least time (``rooflines/clone_chain.py``)
over its mean measured time in the profiled block (%).  The block's
clones start generations ``first + 1 .. first + generations``."""


def read(ctx):
    b = ctx.block
    if b is None or ctx.peaks is None:
        return None
    times = [k.dur_us / 1e6 for k in b.kernels if "clone_chain_kernel" in k.name]
    if not times:
        return None
    roof = ctx.roofline("clone_chain")
    ts = range(b.first_generation + 1, b.first_generation + b.generations + 1)
    least = sum(roof.least_seconds(ctx.config, t, ctx.peaks) for t in ts) / len(ts)
    return 100.0 * least / (sum(times) / len(times))
