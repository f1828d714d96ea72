"""Share of the profiled block's kernel time that the model step launched (%)."""


def read(ctx):
    b = ctx.block
    if b is None:
        return None
    total = sum(k.dur_us for k in b.kernels)
    step = sum(k.dur_us for k in b.kernels if k.in_step)
    if total <= 0 or step <= 0:
        return None
    return 100.0 * step / total
