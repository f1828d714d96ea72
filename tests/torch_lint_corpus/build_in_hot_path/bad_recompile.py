"""BAD: compiled/captured/loaded objects built per iteration or per call.

Counterparts of the reference's ``jit_in_hot_path/bad_recompile.py``,
one function each, under the same names, and the port's other builders.
"""

from ctypes import CDLL

import torch


def loop_rebuild(kernel, xs):
    total = 0.0
    for x in xs:
        f = torch.compile(kernel)  # a fresh compile cache every iteration
        total = total + f(x)
    return total


def immediate(kernel, x):
    return torch.compile(kernel)(x)  # built and discarded in one expression


class Runner:
    def step(self, x):
        f = torch.compile(self._kernel)  # rebuilt (and recompiled) every call
        return f(x)


def capture_per_call(fn, x):
    g = torch.cuda.CUDAGraph()  # captured again on every call
    with torch.cuda.graph(g):
        y = fn(x)
    g.replay()
    return y


def load_per_item(paths):
    out = []
    for p in paths:
        out.append(CDLL(p).entry())  # dlopen per item
    return out


def register_per_call(x):
    @torch.library.custom_op("torch_lint_corpus::per_call", mutates_args=())
    def per_call(t: torch.Tensor) -> torch.Tensor:
        return t * 2

    return per_call(x)  # registered again on every call
