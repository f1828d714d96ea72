"""Plain PyTorch version of systematic resampling from a CDF — the CPU
path and the yardstick ``csrc/resample.cu`` is held against.

``anc[j] = min(#{i : cum[i] < (j + u) / n}, n - 1)``: the inverse-CDF
lookup of the systematic comb, by ``torch.searchsorted`` (``side="left"``)
at the comb positions :func:`comb_positions` forms with an IEEE division.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.clone_chain.ref import comb_positions


def resample_systematic_ref(cum: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """cum: [n] inclusive CDF (cum[-1] == 1); u: one uniform ([1] or
    0-dim).  Returns the ancestors, [n] int32."""
    n = cum.shape[0]
    positions = comb_positions(u.reshape(()), n)
    anc = torch.searchsorted(cum, positions, side="left")
    return anc.clamp(max=n - 1).to(torch.int32)
