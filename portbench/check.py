"""The comparison that decides ``correct``.

Each filter run of the window leaves its outputs (:class:`RunOutputs`):
the log-evidence, the final normalized log-weights, the ``oom`` flag,
and the digests (:mod:`portbench.reference.digest`) of the trajectories
of a sample of particles drawn from the seed; the last run also leaves
the digests of all N trajectories and their smoothing means under its
final weights.  After the window the plain reference filters the same
inputs.  The numbers that decide, each held to the limit that the
configuration's file states (``limits``):

``logz_gap``
    the largest ``|log Z - log Z_ref| / |log Z_ref|`` over the runs;
``smooth_gap``
    the last run's largest ``|M - M_ref| / sqrt(V + V_ref + (REL M_ref)^2)``
    over generations ``t`` and record elements ``e``, where ``M[t, e]``
    is the smoothing mean ``sum_i w_i r_{t,e}^(i)`` of the final weighted
    trajectories, read back from the store, and ``V[t, e]`` their
    weighted variance (the reference's from its dense records and
    ancestors): a gap in units of the two posteriors' spread at that
    generation, with a floor of :data:`REL` of the mean for an element
    that every particle shares;
``oom_runs``
    the runs whose store's sticky ``oom`` flag is set.

A sound change of the order of the float32 operations moves an ancestor
at a comb boundary and the populations part, so these read Monte Carlo
gaps and not 0; their limits sit above what such a change reads and
below the control.  Two more numbers are printed beside them and decide
nothing, since any such change reads them far from 0: ``logw_gap``, the
largest ``|log w_i - log w_ref,i|``, and ``traj_mismatch``, the
particles whose trajectory digest differs (every run's sample, and all
N of the last run).  While the program keeps the reference's order they
read 0, and a nonzero reading says where the two parted.

NaN fails every limit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch

DECISIVE = ("logz_gap", "smooth_gap", "oom_runs")
#: the floor of ``smooth_gap``'s scale, relative to the reference's mean:
#: far above the float32 rounding of an element every particle shares
REL = 1e-3
DIAGNOSTIC = ("logw_gap", "traj_mismatch")

Digests = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class RunOutputs:
    """What one filter run produced, kept past the window."""

    log_evidence: torch.Tensor  # 0-dim
    log_weights: torch.Tensor  # [N]
    oom: torch.Tensor  # 0-dim bool
    ids: torch.Tensor  # [S] int64: the sampled particles
    sample: Digests  # [S] each: their trajectories' digests
    full: Optional[Digests] = None  # [N] each, for the last run
    smooth: Optional[torch.Tensor] = None  # [T, E] float64, for the last run
    var: Optional[torch.Tensor] = None  # [T, E] float64, for the last run


def _mismatch(got: Digests, want: Digests) -> int:
    diff = (got[0] != want[0]) | (got[1] != want[1])
    return int(diff.sum())


def smooth_gap(got: Tuple[torch.Tensor, torch.Tensor], want: Tuple[torch.Tensor, torch.Tensor]) -> float:
    """The largest gap of the smoothing means ``got = (M, V)`` from
    ``want = (M_ref, V_ref)`` (each ``[T, E]``), in units of
    ``sqrt(V + V_ref + (REL M_ref)^2)`` (0 where the means are equal)."""
    m_ref, v_ref = want
    m, v = (x.double().to(m_ref.device) for x in got)
    diff = (m - m_ref).abs()
    scale = torch.sqrt(v.clamp(min=0) + v_ref + (REL * m_ref) ** 2)
    return float(torch.where(diff == 0, 0.0, diff / scale).max())


def numbers(outs: Sequence[RunOutputs], refs: Sequence) -> dict:
    """The numbers of the runs ``outs`` against the reference's results
    ``refs`` (:class:`portbench.reference.filter.Result`), decisive and
    diagnostic."""
    logz_gap = logw_gap = smooth = 0.0
    mismatch = oom = 0
    for out, ref in zip(outs, refs, strict=True):
        lz, lz_ref = float(out.log_evidence), float(ref.log_evidence)
        logz_gap = max(logz_gap, abs(lz - lz_ref) / max(abs(lz_ref), 1e-30), key=_nan_first)
        got, want = out.log_weights.float(), ref.log_weights.to(out.log_weights.device)
        gap = torch.where(got == want, 0.0, (got - want).abs())
        logw_gap = max(logw_gap, float(gap.max()), key=_nan_first)
        ids = out.ids.to(ref.digests[0].device)
        mismatch += _mismatch(out.sample, (ref.digests[0][ids], ref.digests[1][ids]))
        if out.full is not None:
            mismatch += _mismatch(out.full, ref.digests)
        if out.smooth is not None:
            smooth = max(smooth, smooth_gap((out.smooth, out.var), (ref.smooth, ref.var)), key=_nan_first)
        oom += int(bool(out.oom))
    return {"logz_gap": logz_gap, "smooth_gap": smooth, "oom_runs": oom,
            "logw_gap": logw_gap, "traj_mismatch": mismatch}


def _nan_first(x: float) -> float:
    return math.inf if math.isnan(x) else x


def judge(values: dict, limits: dict) -> Tuple[bool, List[dict]]:
    """``(correct, [{"name", "value", "limit"}, ...])`` over the decisive
    numbers."""
    rows = [{"name": k, "value": values[k], "limit": limits[k]} for k in DECISIVE]
    ok = all(not math.isnan(r["value"]) and r["value"] <= r["limit"] for r in rows)
    return ok, rows
