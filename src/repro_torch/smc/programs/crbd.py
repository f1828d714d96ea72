"""CRBD: constant-rate birth-death model over a phylogeny with an alive
particle filter (paper Section 4; Kudlicka et al. 2019), in PyTorch.

The port of ``repro.smc.programs.crbd`` (whose docstring gives the
model).  A particle processes one branch of an 87-tip tree per step
(T = 173 branches): it draws the number of hidden speciation events on
the branch, Poisson(lambda * dt), and every hidden side lineage must go
extinct before the present (a Bernoulli check with the closed-form
extinction probability :func:`p_ext`).  A surviving hidden lineage
contradicts the tree: the weight is -inf, and the alive filter's
rejection loop (``FilterConfig.max_retries``) redraws the particle from
the living.

record = [cumulative hidden events, branch index]  (2,)
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import random as rnd
from repro_torch.smc.filters import SSMDef

NAME = "crbd"
METHOD = "alive"
PAPER_N = 5000
PAPER_T = 173  # 87-tip cetacean tree: 2*87 - 1 branches

LAMBDA = 0.2  # speciation rate (events / lineage / Myr)
MU = 0.1  # extinction rate
TREE_AGE = 35.0  # Myr, cetacean-like
MAX_HIDDEN = 8  # Poisson tail truncation for survival checks


def p_ext(s: torch.Tensor) -> torch.Tensor:
    """P(a lineage alive at time-before-present ``s`` is extinct by 0)."""
    lam, mu = LAMBDA, MU
    e = torch.exp(-(lam - mu) * s)
    return mu * (1 - e) / (lam - mu * e)


class CRBDObs(NamedTuple):
    dt: torch.Tensor  # branch length (Myr)
    time: torch.Tensor  # time before present at branch midpoint
    branch: torch.Tensor  # 1.0 if the branch ends in an observed speciation


def build() -> Tuple[SSMDef, None]:
    def init(gen, n, params):
        return torch.zeros((n,), device=gen.device)  # cumulative hidden-event counter

    def step(gen, hidden_total, t, obs_t, params):
        dt, time_bp, branch = obs_t
        n = hidden_total.shape[0]
        # hidden speciations on this branch (single lineage)
        n_hidden = rnd.poisson(gen, LAMBDA * dt, (n,))
        n_hidden = torch.clamp(n_hidden, max=MAX_HIDDEN)
        # each hidden side lineage must go extinct before the present
        u = rnd.uniform(gen, (n, MAX_HIDDEN))
        pe = p_ext(torch.clamp(time_bp, min=1e-3))
        checks = u < pe  # True = extinct (consistent with the data)
        idx = torch.arange(MAX_HIDDEN, device=u.device)[None, :]
        relevant = idx < n_hidden[:, None]
        survived = torch.any(relevant & ~checks, dim=1)
        # weight: the branch's observed lineage neither went extinct
        # (e^{-mu dt}) nor speciated visibly except at its end; each
        # hidden event contributes the factor 2 of planted-tree counting.
        logw = -MU * dt + branch * math.log(LAMBDA) + n_hidden.float() * math.log(2.0)
        logw = torch.where(survived, -math.inf, logw)
        hidden_total = hidden_total + n_hidden
        record = torch.stack(
            [hidden_total.float(), torch.full((n,), float(t), device=u.device)], dim=1
        )
        return hidden_total, logw, record

    def alive(logw_incr):
        return ~torch.isfinite(logw_incr)

    return SSMDef(init=init, step=step, record_shape=(2,), alive=alive), None


def gen_data(gen: Any, t_steps: int) -> CRBDObs:
    """A synthetic ultrametric phylogeny reduced to its branches, on
    ``gen``'s device: exponential branch lengths of mean 2.5 Myr clipped
    to [0.05, 8] (tree length ~500 Myr over 173 branches), midpoints
    uniform in [1, TREE_AGE), half the branches internal."""
    dts = torch.clamp(-torch.log1p(-rnd.uniform(gen, (t_steps,))) * 2.5, 0.05, 8.0)
    times = torch.clamp(rnd.uniform(gen, (t_steps,)) * (TREE_AGE - 1.0) + 1.0, min=1.0)
    branch = rnd.uniform(gen, (t_steps,)) < 0.5
    return CRBDObs(dt=dts, time=times, branch=branch.float())
