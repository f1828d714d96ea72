"""Kernels on the card per generation over the profiled block."""


def read(ctx):
    b = ctx.block
    if b is None or not b.kernels:
        return None
    return len(b.kernels) / b.generations
