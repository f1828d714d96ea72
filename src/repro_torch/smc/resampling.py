"""Resampling schemes for particle methods, in PyTorch.

Each scheme takes log-weights ``logw: [N]`` and a generator (see
:mod:`repro_torch.random`) and returns ancestor indices ``[N] int32``.
Systematic and stratified resampling share the weight -> CDF -> comb
path with the fused ``clone_chain`` kernel
(:func:`repro_torch.kernels.clone_chain.weights_cdf` /
:func:`~repro_torch.kernels.clone_chain.comb_positions`), so given the
same weights and uniforms their ancestors equal the reference's and the
fused path's bit for bit.

Multinomial and residual draws differ from the reference's
``jax.random.categorical`` (Gumbel-max over an ``[N, N]`` noise tensor):
here they invert the CDF at ``N`` uniforms, which samples the same
distribution with ``N`` draws instead of ``N²``.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import random as rnd
from repro_torch.kernels.clone_chain.ref import comb_positions, weights_cdf

__all__ = [
    "normalize",
    "ess",
    "should_resample",
    "resample_multinomial",
    "resample_systematic",
    "resample_stratified",
    "resample_residual",
    "RESAMPLERS",
]


def normalize(logw: torch.Tensor) -> torch.Tensor:
    """Normalize log-weights to logsumexp == 0."""
    return logw - torch.logsumexp(logw, 0)


def ess(logw: torch.Tensor) -> torch.Tensor:
    """Effective sample size 1 / sum(w^2) of normalized weights."""
    w = torch.exp(normalize(logw))
    return 1.0 / torch.sum(w * w)


def should_resample(logw: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Adaptive-resampling predicate: ESS below ``threshold * N``."""
    return ess(logw) < threshold * logw.shape[0]


def _inverse_cdf(cum: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    anc = torch.searchsorted(cum, positions, side="left")
    return anc.clamp(max=cum.shape[0] - 1).to(torch.int32)


def resample_multinomial(gen: Any, logw: torch.Tensor) -> torch.Tensor:
    n = logw.shape[0]
    cum = weights_cdf(logw)
    return _inverse_cdf(cum, rnd.uniform(gen, (n,)).to(cum.device))


def resample_systematic(gen: Any, logw: torch.Tensor) -> torch.Tensor:
    """Systematic resampling: one uniform, stratified comb."""
    n = logw.shape[0]
    cum = weights_cdf(logw)
    u = rnd.uniform(gen, ()).to(cum.device)
    return _inverse_cdf(cum, comb_positions(u, n))


def resample_stratified(gen: Any, logw: torch.Tensor) -> torch.Tensor:
    """Stratified resampling: one uniform per stratum."""
    n = logw.shape[0]
    cum = weights_cdf(logw)
    u = rnd.uniform(gen, (n,)).to(cum.device)
    return _inverse_cdf(cum, comb_positions(u, n))


def resample_residual(gen: Any, logw: torch.Tensor) -> torch.Tensor:
    """Residual resampling: ``floor(N w_i)`` deterministic copies of each
    ancestor, the remaining slots drawn from the residual distribution."""
    n = logw.shape[0]
    w = torch.exp(normalize(logw))
    counts = torch.floor(n * w).to(torch.int32)
    n_det = counts.sum()
    slots = torch.arange(n, device=logw.device)
    det = torch.searchsorted(torch.cumsum(counts, 0), slots, right=True)
    det = det.clamp(0, n - 1).to(torch.int32)
    resid = n * w - counts
    resid = torch.where(resid.sum() > 0, resid, torch.ones_like(resid))
    rand = resample_multinomial(gen, torch.log(resid + 1e-38))
    return torch.where(slots < n_det, det, rand)


RESAMPLERS = {
    "multinomial": resample_multinomial,
    "systematic": resample_systematic,
    "stratified": resample_stratified,
    "residual": resample_residual,
}
