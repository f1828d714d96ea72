"""Share of the profiled block's device span with no operation running (%)."""


def read(ctx):
    b = ctx.block
    if b is None or b.window_s <= 0:
        return None
    return 100.0 * (1.0 - b.busy_s / b.window_s)
