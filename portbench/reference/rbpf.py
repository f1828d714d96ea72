"""The mixed linear/nonlinear model of Lindsten & Schön (2010) with its
Rao-Blackwellized filter step, in plain PyTorch and NumPy:

    xi_{t+1} = 0.5 xi + 25 xi / (1 + xi^2) + 8 cos(1.2 t) + c^T z_t + v,
    z_{t+1}  = A z_t + w,
    y_t      = 0.05 xi_t^2 + b^T z_t + e,

with ``v ~ N(0, Q_XI)``, ``w ~ N(0, QZ I)``, ``e ~ N(0, R_Y)``.  Each
particle samples ``xi`` from its marginal predictive and keeps a Kalman
filter (mean ``m``, covariance ``p``) over ``z``; its weight is the exact
predictive likelihood of ``y_t``.  The record is
``[xi, m0, m1, P00, P01, P11]``.

The contractions are written as matrix products and ``c^T p c`` as one
multiply-add chain over ``p``'s entries in row-major order, so that the
float32 results are those of the program's step, as the exact
comparison needs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

RECORD_ELEMS = 6


class State(NamedTuple):
    xi: torch.Tensor  # [N]
    m: torch.Tensor  # [N, 2]
    p: torch.Tensor  # [N, 2, 2]


def _quad(p: torch.Tensor, vv: torch.Tensor) -> torch.Tensor:
    """``v^T p v`` per particle: ``p``'s entries times ``v_i v_j``."""
    p4 = p.reshape(-1, 4)
    acc = p4[:, 0] * vv[0]
    for k in range(1, 4):
        acc = torch.addcmul(acc, p4[:, k], vv[k])
    return acc


def _f(xi: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return 0.5 * xi + 25.0 * xi / (1.0 + xi * xi) + 8.0 * torch.cos(1.2 * t)


class Model:
    """The model at ``params`` on ``device``, computed in ``dtype``."""

    def __init__(self, params: dict, device: torch.device | str, dtype: torch.dtype):
        dev = torch.device(device)
        self.params, self.dtype = params, dtype
        a = torch.tensor(params["A"], dtype=torch.float32, device=dev)
        c = torch.tensor(params["C"], dtype=torch.float32, device=dev)
        b = torch.tensor(params["B"], dtype=torch.float32, device=dev)
        cc = (c[:, None] * c[None, :]).T.reshape(4)
        bb = (b[:, None] * b[None, :]).T.reshape(4)
        qz = params["QZ"] * torch.eye(2, dtype=torch.float32, device=dev)
        self.consts = tuple(x.to(dtype) for x in (a, qz, c, b, cc, bb))

    def init(self, gen: torch.Generator, n: int) -> State:
        dtype = self.dtype
        xi = torch.randn((n,), generator=gen, device=gen.device, dtype=torch.float32).to(dtype)
        m = torch.zeros((n, 2), dtype=dtype, device=xi.device)
        p = torch.eye(2, dtype=dtype, device=xi.device).expand(n, 2, 2).contiguous()
        return State(xi, m, p)

    def step(self, gen, state, t, y):
        return _step(gen, state, t, y, self.params, self.dtype, *self.consts)


def _step(gen, state, t, y, params, dtype, a, qz, c, b, cc, bb):
    xi, m, p = state
    f = _f(xi, torch.full((), float(t), dtype=dtype, device=xi.device))
    mean_xi = f + m @ c
    var_xi = params["Q_XI"] + _quad(p, cc)
    noise = torch.randn(xi.shape, generator=gen, device=gen.device, dtype=torch.float32).to(dtype)
    xi_new = mean_xi + torch.sqrt(var_xi) * noise
    # Kalman update of z from the pseudo-observation xi_new.
    innov = xi_new - f - m @ c
    pc = torch.einsum("nij,j->ni", p, c)
    gain = pc / var_xi[:, None]
    m = m + gain * innov[:, None]
    p = p - gain[:, :, None] * pc[:, None, :]
    # Time update.
    m = m @ a.T
    p = torch.einsum("ij,njk,lk->nil", a, p, a) + qz
    # Weight: the predictive likelihood of y.
    y_mean = 0.05 * xi_new * xi_new + m @ b
    y_var = params["R_Y"] + _quad(p, bb)
    logw = -0.5 * ((y - y_mean) ** 2 / y_var + torch.log(2 * math.pi * y_var))
    # Measurement update from y.
    pb = torch.einsum("nij,j->ni", p, b)
    gain = pb / y_var[:, None]
    m = m + gain * (y - y_mean)[:, None]
    p = p - gain[:, :, None] * pb[:, None, :]
    record = torch.cat([xi_new[:, None], m, p[:, 0, 0:1], p[:, 0, 1:2], p[:, 1, 1:2]], dim=1)
    return State(xi_new, m, p), logw, record


def simulate(params: dict, n_steps: int, rng: np.random.Generator) -> np.ndarray:
    """Observations ``[T]`` float32 drawn from the model."""
    a, c, b = (np.asarray(params[k], dtype=np.float64) for k in ("A", "C", "B"))
    xi, z, ys = rng.standard_normal(), np.zeros(2), np.empty(n_steps)
    for t in range(n_steps):
        xi = (0.5 * xi + 25.0 * xi / (1.0 + xi * xi) + 8.0 * math.cos(1.2 * t) + c @ z
              + math.sqrt(params["Q_XI"]) * rng.standard_normal())
        z = a @ z + math.sqrt(params["QZ"]) * rng.standard_normal(2)
        ys[t] = 0.05 * xi * xi + b @ z + math.sqrt(params["R_Y"]) * rng.standard_normal()
    return ys.astype(np.float32)
