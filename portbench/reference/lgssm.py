"""The linear-Gaussian state-space model of the repository's quickstart,
in plain PyTorch and NumPy:

    x_0 ~ N(0, 1),   x_t = A x_{t-1} + sqrt(Q) w_t,   y_t = x_t + sqrt(R) v_t,

with the record ``[x_t]``.  ``params`` holds ``A``, ``Q`` and ``R``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RECORD_ELEMS = 1


class Model:
    """The model at ``params``, computed in ``dtype``."""

    def __init__(self, params: dict, device: torch.device | str, dtype: torch.dtype):
        self.params, self.dtype = params, dtype

    def init(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return torch.randn((n,), generator=gen, device=gen.device, dtype=torch.float32).to(self.dtype)

    def step(self, gen, x, t, y):
        a, q, r = self.params["A"], self.params["Q"], self.params["R"]
        noise = torch.randn(x.shape, generator=gen, device=gen.device, dtype=torch.float32)
        x = a * x + math.sqrt(q) * noise.to(self.dtype)
        logw = -0.5 * ((y - x) ** 2 / r + math.log(2 * math.pi * r))
        return x, logw, x[:, None]


def simulate(params: dict, n_steps: int, rng: np.random.Generator) -> np.ndarray:
    """Observations ``[T]`` float32 drawn from the model."""
    a, q, r = params["A"], params["Q"], params["R"]
    w = rng.standard_normal((n_steps, 2))
    x, ys = rng.standard_normal(), np.empty(n_steps)
    for t in range(n_steps):
        x = a * x + math.sqrt(q) * w[t, 0]
        ys[t] = x + math.sqrt(r) * w[t, 1]
    return ys.astype(np.float32)
