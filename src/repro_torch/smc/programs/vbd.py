"""VBD: vector-borne disease model (SEIR humans + SEI mosquitoes) with
marginalized particle Gibbs — the paper's dengue experiment, in PyTorch.

The port of ``repro.smc.programs.vbd`` (whose docstring gives the
model): a discrete-time stochastic compartment model whose binomial
transition counts are moment-matched Gaussians, observed through
reported new human infections ~ Poisson(rho * newI_h).  Method: particle
Gibbs, 3 iterations, the retained reference deep-copied eagerly between
iterations (:class:`repro_torch.smc.pgibbs.ParticleGibbs`).

The reference's arithmetic is kept where its float32 results on the CPU
show it: a division by a constant is a multiply by its reciprocal (XLA
under ``jit``), ``mean + std * z`` one fused multiply-add.

record = state (7,) = [Sh, Eh, Ih, Rh, Sm, Em, Im]
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import random as rnd
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.smc.filters import SSMDef

NAME = "vbd"
METHOD = "pg"
PAPER_N = 4096
PAPER_T = 182
PAPER_T_SIM = 400
PG_ITERS = 3

N_H = 5000.0  # human population (Yap-like)
N_M = 20000.0  # mosquito population
INIT = (N_H - 10.0, 5.0, 5.0, 0.0, N_M - 50.0, 30.0, 20.0)


class VBDParams(NamedTuple):
    beta_hm: torch.Tensor  # mosquito -> human transmission
    beta_mh: torch.Tensor  # human -> mosquito transmission
    sigma_h: torch.Tensor  # human incubation rate
    gamma_h: torch.Tensor  # human recovery rate
    sigma_m: torch.Tensor  # mosquito incubation rate
    rho: torch.Tensor  # reporting fraction


def default_params(device: torch.device | str = "cuda") -> VBDParams:
    """The reference's constants, as float32 scalars on ``device`` (the
    card unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    values = (0.35, 0.30, 1 / 5.0, 1 / 6.0, 1 / 10.0, 0.35)
    return VBDParams(*(torch.tensor(v, dtype=torch.float32, device=dev) for v in values))


def _binom_approx(gen: Any, n: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Moment-matched Gaussian approximation of Binomial(n, p), clipped
    to ``[0, n]``."""
    mean = n * p
    std = torch.sqrt(torch.clamp(n * p * (1 - p), min=1e-6))
    draw = torch.addcmul(mean, std, rnd.normal(gen, mean.shape))
    return torch.minimum(torch.clamp(draw, min=0.0), n)


def build() -> Tuple[SSMDef, VBDParams]:
    def init(gen, n, params):
        row = torch.tensor(INIT, dtype=torch.float32, device=gen.device)
        return row.repeat(n, 1)

    def step(gen, state, t, y_t, params):
        sh, eh, ih, rh, sm, em, im = state.unbind(1)
        # forces of infection; 1 - exp(-x) at x ~ 1e-3 cancels, so exp is
        # taken in float64 and rounded (correctly rounded there, as XLA's is)
        foi_h = 1 - torch.exp((-params.beta_hm * im * (1 / N_M)).double()).float()
        foi_m = 1 - torch.exp((-params.beta_mh * ih * (1 / N_H)).double()).float()
        new_eh = _binom_approx(gen, sh, foi_h)
        new_ih = _binom_approx(gen, eh, 1 - torch.exp(-params.sigma_h))
        new_rh = _binom_approx(gen, ih, 1 - torch.exp(-params.gamma_h))
        new_em = _binom_approx(gen, sm, foi_m)
        new_im = _binom_approx(gen, em, 1 - torch.exp(-params.sigma_m))
        # mosquito birth/death keeps N_M constant in expectation
        sh, eh = sh - new_eh, eh + new_eh - new_ih
        ih, rh = ih + new_ih - new_rh, rh + new_rh
        sm, em, im = sm - new_em, em + new_em - new_im, im + new_im
        state = torch.stack([sh, eh, ih, rh, sm, em, im], dim=1)
        # observation: reported new infections ~ Poisson(rho * new_ih)
        lam = torch.clamp(params.rho * new_ih, min=1e-3)
        logw = y_t * torch.log(lam) - lam - torch.lgamma(y_t + 1.0)
        return state, logw, state

    def set_reference(state, ref_t):
        state = state.clone()
        state[0] = ref_t
        return state

    return SSMDef(
        init=init, step=step, record_shape=(7,), set_reference=set_reference
    ), default_params("cpu")


def gen_data(gen: Any, t_steps: int) -> torch.Tensor:
    """Simulate an outbreak on ``gen``'s device and return the reported
    case counts ``[T]`` (float32)."""
    params = default_params(gen.device)
    ssm, _ = build()
    state = ssm.init(gen, 1, params)
    ys = []
    for t in range(t_steps):
        ih_before = state[:, 2]
        zero = torch.zeros((), device=gen.device)
        state, _, _ = ssm.step(gen, state, t, zero, params)
        new_cases = torch.clamp(state[:, 2] - ih_before + 1.0, min=0.5)  # proxy for incidence
        ys.append(rnd.poisson(gen, params.rho * new_cases[0], ()).float())
    return torch.stack(ys)
