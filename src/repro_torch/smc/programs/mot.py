"""MOT: multi-object tracking with an unknown number of objects and
linear-Gaussian dynamics (paper Section 4, Murray & Schön 2018 model), in
PyTorch.

The port of ``repro.smc.programs.mot`` (whose docstring gives the model).
Each particle carries a *ragged* set of objects: at most K, with an
existence mask, each a 4-dim state [x, y, vx, vy].  Dynamics: constant
velocity plus noise, survival, one Bernoulli birth into the first free
slot.  Weighting: greedy nearest-detection association against up to M
detections with missed-detection terms.

Uniforms on ``[lo, hi)`` are ``max(lo, u * (hi - lo) + lo)`` on
:func:`repro_torch.random.uniform`'s draws with the multiply-add fused,
the reference's own arithmetic (bit-equal to ``jax.random.uniform`` with
``minval``/``maxval`` on the CPU); the first free slot is the first
maximum of the free mask.

record = [K objects x (exists, x, y, vx, vy)]  (K*5,)
"""

from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch import random as rnd
from repro_torch.smc.filters import SSMDef

NAME = "mot"
METHOD = "pf"
PAPER_N = 4096
PAPER_T = 100
PAPER_T_SIM = 300

K = 8  # max objects per particle
M = 8  # max detections per frame
DT = 1.0
Q_POS, Q_VEL = 0.05, 0.1
R_OBS = 0.25
P_SURVIVE = 0.95
P_BIRTH = 0.25  # per-step probability of one birth
P_DETECT = 0.9
CLUTTER_RATE = 1.0
ARENA = 20.0


def _uniform_in(gen: Any, shape: Tuple[int, ...], lo: float, hi: float) -> torch.Tensor:
    u = rnd.uniform(gen, shape)
    return torch.clamp(torch.add(torch.full_like(u, lo), u, alpha=hi - lo), min=lo)


def _first_true(mask: torch.Tensor, dim: int) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 where there is none)."""
    return torch.argmax(mask.to(torch.int32), dim=dim)


def _logaddexp(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``log(exp(x1) + exp(x2))`` as the reference computes it."""
    amax = torch.maximum(x1, x2)
    delta = x1 - x2
    return torch.where(
        torch.isnan(delta), x1 + x2, amax + torch.log1p(torch.exp(-torch.abs(delta)))
    )


def build() -> Tuple[SSMDef, None]:
    def init(gen, n, params):
        # start with 2 objects per particle
        pos = _uniform_in(gen, (n, K, 2), -ARENA, ARENA)
        vel = 0.5 * rnd.normal(gen, (n, K, 2))
        state = torch.cat([pos, vel], dim=-1)  # [n, K, 4]
        exists = torch.zeros((n, K), dtype=torch.bool, device=state.device)
        exists[:, :2] = True
        return (state, exists)

    def step(gen, state_tuple, t, obs_t, params):
        state, exists = state_tuple
        n = state.shape[0]
        # --- dynamics ---------------------------------------------------
        pos = state[..., :2] + DT * state[..., 2:]
        vel = state[..., 2:]
        pos = pos + math.sqrt(Q_POS) * rnd.normal(gen, pos.shape)
        vel = vel + math.sqrt(Q_VEL) * rnd.normal(gen, vel.shape)
        state = torch.cat([pos, vel], dim=-1)
        # --- survival / birth (the ragged-size dynamics) ------------------
        survive = rnd.uniform(gen, (n, K)) < P_SURVIVE
        exists = exists & survive
        birth = rnd.uniform(gen, (n,)) < P_BIRTH
        free = ~exists
        first_free = _first_true(free, 1)  # [n]
        do_birth = birth & free.any(dim=1)
        new_pos = _uniform_in(gen, (n, 2), -ARENA, ARENA)
        born_state = torch.cat([new_pos, torch.zeros((n, 2), device=state.device)], dim=1)
        rows = torch.arange(n, device=state.device)
        state[rows, first_free] = torch.where(
            do_birth[:, None], born_state, state[rows, first_free]
        )
        exists[rows, first_free] = exists[rows, first_free] | do_birth
        # --- weight: greedy nearest-detection association -----------------
        dets, det_mask = obs_t  # [M, 2], [M]
        d2 = torch.sum((pos[:, :, None, :] - dets[None, None, :, :]) ** 2, dim=-1)  # [n, K, M]
        d2 = torch.where(det_mask[None, None, :], d2, math.inf)
        best = torch.amin(d2, dim=-1)  # [n, K]
        log_det = -0.5 * (best / R_OBS + 2 * math.log(2 * math.pi * R_OBS))
        log_miss = math.log(1 - P_DETECT)
        per_obj = _logaddexp(math.log(P_DETECT) + log_det, torch.full_like(log_det, log_miss))
        logw = torch.sum(torch.where(exists, per_obj, 0.0), dim=1)
        # clutter normalization (constant across particles; kept for scale)
        n_det = torch.sum(det_mask)
        logw = logw - CLUTTER_RATE + n_det * math.log(
            CLUTTER_RATE / (2 * ARENA) ** 2 + 1e-9
        ) * 0.0
        record = torch.cat([exists[..., None].float(), state], dim=-1).reshape(n, K * 5)
        return (state, exists), logw, record

    return SSMDef(init=init, step=step, record_shape=(K * 5,)), None


def gen_data(gen: Any, t_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulated detections on ``gen``'s device: ``[T, M, 2]`` positions
    and ``[T, M]`` validity."""
    dev = gen.device
    pos0 = _uniform_in(gen, (K, 2), -ARENA, ARENA)
    state = torch.cat([pos0, 0.5 * rnd.normal(gen, (K, 2))], dim=-1)
    exists = torch.zeros((K,), dtype=torch.bool, device=dev)
    exists[:2] = True
    dets, masks = [], []
    for _ in range(t_steps):
        pos = state[..., :2] + DT * state[..., 2:]
        pos = pos + math.sqrt(Q_POS) * rnd.normal(gen, pos.shape)
        vel = state[..., 2:] + math.sqrt(Q_VEL) * rnd.normal(gen, (K, 2))
        state = torch.cat([pos, vel], dim=-1)
        exists = exists & (rnd.uniform(gen, (K,)) < P_SURVIVE)
        birth = (rnd.uniform(gen, ()) < P_BIRTH) & (~exists).any()
        slot = _first_true(~exists, 0)
        born = torch.cat([_uniform_in(gen, (2,), -ARENA, ARENA), torch.zeros(2, device=dev)])
        state[slot] = torch.where(birth, born, state[slot])
        exists[slot] = exists[slot] | birth
        detected = exists & (rnd.uniform(gen, (K,)) < P_DETECT)
        noise = math.sqrt(R_OBS) * rnd.normal(gen, (K, 2))
        dets.append(torch.where(detected[:, None], pos + noise, 0.0)[:M])
        masks.append(detected[:M])
    return torch.stack(dets), torch.stack(masks)
