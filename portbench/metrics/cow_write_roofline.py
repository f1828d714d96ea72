"""``cow_write_kernel``'s least time (``rooflines/cow_write.py``) over
its mean measured time in the profiled block (%)."""


def read(ctx):
    b = ctx.block
    if b is None or ctx.peaks is None:
        return None
    times = [k.dur_us / 1e6 for k in b.kernels if "cow_write_kernel" in k.name]
    if not times:
        return None
    least = ctx.roofline("cow_write").least_seconds(ctx.config, ctx.peaks)
    return 100.0 * least / (sum(times) / len(times))
