"""RBPF: mixed linear/nonlinear state-space model (Lindsten & Schön 2010)
with a Rao-Blackwellized particle filter, in PyTorch.

The port of ``repro.smc.programs.rbpf`` (whose docstring gives the
model).  A scalar nonlinear state ``xi`` is sampled; the linear-Gaussian
``z in R^2`` is marginalized per particle by a conditional Kalman filter
with mean ``m`` and covariance ``P``:

    xi_{t+1} = 0.5 xi + 25 xi/(1+xi^2) + 8 cos(1.2 t) + c^T z_t + v,
    z_{t+1}  = A z_t + w,
    y_t      = 0.05 xi_t^2 + b^T z_t + e.

The reference's contractions are written as the operations that give
its float32 results on the CPU: matrix products for ``m @ c``, ``p c``
and ``A p A^T``, and ``c^T p c`` as the fused multiply-add chain over
``p``'s four entries that XLA's dot emits.

record = [xi, m0, m1, P00, P01, P11]  (6,)
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import random as rnd
from repro_torch.smc.filters import SSMDef

NAME = "rbpf"
METHOD = "pf"
PAPER_N = 2048
PAPER_T = 500

_A = ((0.8, 0.1), (-0.1, 0.8))
_QZ = 0.1  # z's process noise, times the 2x2 identity
_C = (0.3, -0.2)  # xi-transition coupling to z
_B = (1.0, 0.5)  # observation coupling to z
Q_XI = 0.5
R_Y = 0.5


class RBPFState(NamedTuple):
    xi: torch.Tensor  # [N]
    m: torch.Tensor  # [N, 2]
    p: torch.Tensor  # [N, 2, 2]


class _Consts(NamedTuple):
    a: torch.Tensor  # [2, 2]
    qz: torch.Tensor  # [2, 2]
    c: torch.Tensor  # [2]
    b: torch.Tensor  # [2]
    cc: torch.Tensor  # [4]: c c^T, flattened in the order c^T p c sums
    bb: torch.Tensor  # [4]: b b^T, likewise


def _consts(dev: torch.device) -> _Consts:
    a = torch.tensor(_A, dtype=torch.float32, device=dev)
    c = torch.tensor(_C, dtype=torch.float32, device=dev)
    b = torch.tensor(_B, dtype=torch.float32, device=dev)

    def outer(v):
        return (v[:, None] * v[None, :]).T.reshape(4)

    qz = _QZ * torch.eye(2, dtype=torch.float32, device=dev)
    return _Consts(a, qz, c, b, outer(c), outer(b))


def _quad(p: torch.Tensor, vv: torch.Tensor) -> torch.Tensor:
    """``einsum("i,nij,j->n", v, p, v)`` with ``vv`` from :func:`_consts`:
    ``p``'s entries times ``v_i v_j``, summed as one fused multiply-add
    chain in row-major order."""
    p4 = p.reshape(-1, 4)
    acc = p4[:, 0] * vv[0]
    for k in range(1, 4):
        acc = torch.addcmul(acc, p4[:, k], vv[k])
    return acc


def _f(xi: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return 0.5 * xi + 25.0 * xi / (1.0 + xi * xi) + 8.0 * torch.cos(1.2 * t)


def build() -> Tuple[SSMDef, None]:
    consts: Dict[torch.device, _Consts] = {}

    def k_of(dev: torch.device) -> _Consts:
        if dev not in consts:
            consts[dev] = _consts(dev)
        return consts[dev]

    def init(gen, n, params):
        xi = rnd.normal(gen, (n,))
        m = torch.zeros((n, 2), device=xi.device)
        p = torch.eye(2, device=xi.device).expand(n, 2, 2).contiguous()
        return RBPFState(xi, m, p)

    def step(gen, state, t, y_t, params):
        xi, m, p = state
        k = k_of(xi.device)
        # --- propagate xi from its marginal predictive ------------------
        f = _f(xi, torch.full((), float(t), device=xi.device))
        mean_xi = f + m @ k.c
        var_xi = Q_XI + _quad(p, k.cc)
        xi_new = mean_xi + torch.sqrt(var_xi) * rnd.normal(gen, xi.shape)
        # --- Kalman update of z from the xi pseudo-observation ----------
        innov = xi_new - f - m @ k.c
        s = var_xi
        pc = torch.einsum("nij,j->ni", p, k.c)
        k_gain = pc / s[:, None]
        m = m + k_gain * innov[:, None]
        p = p - k_gain[:, :, None] * pc[:, None, :]
        # --- Kalman time update -----------------------------------------
        m = m @ k.a.T
        p = torch.einsum("ij,njk,lk->nil", k.a, p, k.a) + k.qz
        # --- weight by exact predictive likelihood of y_t ---------------
        y_mean = 0.05 * xi_new * xi_new + m @ k.b
        y_var = R_Y + _quad(p, k.bb)
        logw = -0.5 * ((y_t - y_mean) ** 2 / y_var + torch.log(2 * math.pi * y_var))
        # --- Kalman measurement update from y_t --------------------------
        pb = torch.einsum("nij,j->ni", p, k.b)
        k_gain = pb / y_var[:, None]
        m = m + k_gain * (y_t - y_mean)[:, None]
        p = p - k_gain[:, :, None] * pb[:, None, :]
        record = torch.cat(
            [xi_new[:, None], m, p[:, 0, 0:1], p[:, 0, 1:2], p[:, 1, 1:2]], dim=1
        )
        return RBPFState(xi_new, m, p), logw, record

    def set_reference(state, ref_t):
        xi, m, p = (x.clone() for x in state)
        xi[0] = ref_t[0]
        m[0] = ref_t[1:3]
        p[0] = torch.stack([ref_t[3:5], ref_t[4:6]])
        return RBPFState(xi, m, p)

    return SSMDef(
        init=init, step=step, record_shape=(6,), set_reference=set_reference
    ), None


def gen_data(gen: Any, t_steps: int) -> torch.Tensor:
    """Observations ``[T]`` simulated from the model on ``gen``'s device.
    ``z``'s noise is the Cholesky factor of its covariance times
    normals, so only the distribution of the reference's draws is kept."""
    dev = gen.device
    k = _consts(dev)
    chol = torch.linalg.cholesky(k.qz)
    xi = rnd.normal(gen, ())
    z = torch.zeros(2, device=dev)
    ys = []
    for t in range(t_steps):
        xi = (
            _f(xi, torch.full((), float(t), device=dev))
            + z @ k.c
            + math.sqrt(Q_XI) * rnd.normal(gen, ())
        )
        z = k.a @ z + chol @ rnd.normal(gen, (2,))
        ys.append(0.05 * xi * xi + z @ k.b + math.sqrt(R_Y) * rnd.normal(gen, ()))
    return torch.stack(ys)
