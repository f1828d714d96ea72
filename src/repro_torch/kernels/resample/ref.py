"""Plain PyTorch version of systematic resampling from a CDF — the CPU
path and the yardstick ``csrc/resample.cu`` is held against.

``anc[j] = min(#{i : cum[i] < (j + u) / n}, n - 1)``: the inverse-CDF
lookup of the systematic comb, by ``torch.searchsorted`` (``side="left"``)
at the comb positions :func:`comb_positions` forms with an IEEE division.

:func:`planted_cdfs` makes the CDFs at the comb's edges, on which the
tests and ``chip_smoke.py`` hold the kernel against this version.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.clone_chain.ref import comb_positions

# Zero-weight runs of planted_cdfs' "zero_runs": more than four times the
# 4,096-entry source range that csrc/resample.cu stages in shared memory,
# so a tile whose ancestors straddle one searches `cum` itself.
ZERO_RUN = 20_000
PLANTED = ("one_particle", "zero_runs", "clip", "u_zero", "u_max", "uniform_ties")


def resample_systematic_ref(cum: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """cum: [n] inclusive CDF (cum[-1] == 1); u: one uniform ([1] or
    0-dim).  Returns the ancestors, [n] int32."""
    n = cum.shape[0]
    positions = comb_positions(u.reshape(()), n)
    anc = torch.searchsorted(cum, positions, side="left")
    return anc.clamp(max=n - 1).to(torch.int32)


def planted_cdfs(n: int, seed: int = 0) -> dict:
    """``case -> (cum [n] f32, u [1] f32)``, CPU tensors made with numpy
    from ``seed``, one per name of :data:`PLANTED`:

    * ``one_particle``: particle ``n // 3`` holds all the weight;
    * ``zero_runs``: log-normal weights with runs of :data:`ZERO_RUN` zero
      weights (a quarter of ``n`` where that is shorter) every third of
      the population;
    * ``clip``: its last entry 0.97, so the last positions clip to n - 1;
    * ``u_zero`` and ``u_max``: u = 0 and the largest float32 below 1;
    * ``uniform_ties``: equal weights and u = 0, positions j / n against
      entries (i + 1) / n rounded.
    """
    rng = np.random.default_rng(seed)
    w = np.exp(3 * rng.standard_normal(n))
    u = np.float32(rng.random())
    cases = {}

    def add(name, weights, uu=u, scale=1.0):
        cum = np.cumsum(weights.astype(np.float32), dtype=np.float32)
        cum = (cum / cum[-1] * np.float32(scale)).astype(np.float32)
        cases[name] = (torch.from_numpy(cum), torch.tensor([uu], dtype=torch.float32))

    one = np.zeros(n)
    one[n // 3] = 1.0
    add("one_particle", one)
    runs = w.copy()
    run = min(ZERO_RUN, n // 4)
    for start in range(n // 10, n, max(1, n // 3)):
        runs[start : start + run] = 0.0
    add("zero_runs", runs)
    add("clip", w, scale=0.97)
    add("u_zero", w, uu=np.float32(0.0))
    add("u_max", w, uu=np.nextafter(np.float32(1.0), np.float32(0.0)))
    add("uniform_ties", np.ones(n), uu=np.float32(0.0))
    return cases
