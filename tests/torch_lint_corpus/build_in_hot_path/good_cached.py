"""GOOD: the sanctioned idioms for building once.

Counterparts of the reference's ``jit_in_hot_path/good_cached.py``, one
function each, under the same names, and the port's own: the kernel
library behind ``functools.cache`` (``kernels/_build.py``) and the
custom ops registered at module level (``kernels/*/ops.py``).
"""

import ctypes
import functools

import torch


def _kernel(x):
    return x * 2


STEP = torch.compile(_kernel)  # module level: compiled once per process


class Model:
    def __init__(self, kernel):
        self._step = torch.compile(kernel)  # once per object

    def run(self, x):
        return self._step(x)


@functools.lru_cache(maxsize=None)
def jitted_for(static_arg):
    return torch.compile(functools.partial(_kernel, static_arg))  # memoized factory


def builder(fn):
    return torch.compile(fn)  # explicit builder: the caller caches


def aot(fn, x, path):
    torch.jit.trace(fn, (x,)).save(path)  # deliberate export: traced once, written out


@functools.cache
def library(path):
    return ctypes.CDLL(path)  # loaded once per path


@torch.library.custom_op("torch_lint_corpus::scaled", mutates_args=(), device_types="cuda")
def scaled(x: torch.Tensor, s: float) -> torch.Tensor:
    return x * s  # registered once, at import


class Graphs:
    def __init__(self):
        self._graphs = {}

    def get(self, key, fn, x):
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = torch.cuda.CUDAGraph()  # an instance cache
            with torch.cuda.graph(g):
                fn(x)
        return g
