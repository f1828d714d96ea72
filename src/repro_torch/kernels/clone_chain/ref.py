"""Plain PyTorch version of the fused resample->clone->refcount chain,
and the weight -> CDF -> comb path it shares with the resamplers.

:func:`weights_cdf` and :func:`comb_positions` are the one place the
systematic comb is formed: :func:`repro_torch.smc.resampling.resample_systematic`
(the EAGER path) and :func:`repro_torch.kernels.clone_chain.clone_chain`
(the lazy modes' fused path) both call them, so the two paths see the
same ``cum`` bit for bit, and ``csrc/clone_chain.cu`` forms the same
positions in-kernel.  That is what keeps ``log_evidence`` identical
across copy modes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.refcount_update.ref import refcount_delta_ref


def fixed_order_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of a 1-D tensor, summed in the same order on
    every call.  A 1-D CUDA cumsum runs CUB's decoupled look-back scan,
    whose float association depends on timing, so a CDF (and an ancestor
    at a comb boundary) could change from run to run and from copy mode
    to copy mode.  A row of a 2-D scan runs in a fixed order."""
    return torch.cumsum(torch.stack([x, x]), 1)[0]


def weights_cdf(logw: torch.Tensor) -> torch.Tensor:
    """Normalized log-weights -> weights -> inclusive CDF, with the tail
    guarded against rounding (``cum[-1] == 1``)."""
    logw = logw - torch.logsumexp(logw, 0)
    cum = fixed_order_cumsum(torch.exp(logw))
    return cum / cum[-1]


def comb_positions(u: torch.Tensor, n: int) -> torch.Tensor:
    """``(float(j) + u) / n`` for ``j < n`` in float32, with an IEEE
    division.  ``n`` goes in as a 0-dim tensor on ``u``'s device: CUDA
    PyTorch turns a division by a host scalar into a multiply by its
    reciprocal, which can round differently from the kernel's divide."""
    j = torch.arange(n, dtype=torch.float32, device=u.device)
    return (j + u) / torch.full((), n, dtype=torch.float32, device=u.device)


def clone_chain_ref(
    cum: torch.Tensor,  # [n] inclusive weight CDF, cum[-1] == 1
    u: torch.Tensor,  # one uniform in [0, 1) (0-dim or [1])
    tables: torch.Tensor,  # [n, mb] int32 block tables (NULL = -1 allowed)
    num_blocks: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(ancestors [n], new_tables [n, mb], delta [nb], member [nb])``."""
    n = cum.shape[0]
    positions = comb_positions(u.reshape(()), n)
    ancestors = torch.searchsorted(cum, positions, side="left")
    ancestors = ancestors.clamp(max=n - 1).to(torch.int32)
    new_tables = tables[ancestors.long()]
    delta, member = refcount_delta_ref(
        new_tables.reshape(-1), tables.reshape(-1), num_blocks
    )
    return ancestors, new_tables, delta, member
