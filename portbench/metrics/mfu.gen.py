"""A generation's least time at the card's peaks
(``rooflines/generation.py``) over its measured time: the profiled
block's device span over its generations (%)."""


def read(ctx):
    b = ctx.block
    if b is None or ctx.peaks is None or b.window_s <= 0:
        return None
    least = ctx.roofline("generation").least_seconds(ctx.config, ctx.peaks)
    return 100.0 * least / (b.window_s / b.generations)
