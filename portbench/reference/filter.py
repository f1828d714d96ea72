"""The plain reference: a dense bootstrap particle filter in PyTorch.

It runs the paper's inference task (Section 4) on the inputs the
benchmark hands to the program: the same observations, and a generator
seeded alike, drawn in the order the program's filter fixes (the
model's init draws; then each generation one uniform for systematic
resampling, from generation 1 on and only where it resamples, and the
model step's draws).  It keeps every particle's state densely and
gathers it by ancestor at each resampling, and keeps every generation's
records and ancestors, as dense copying does.  Nothing here is shared
with the program: no store, no block pool, no kernel.

What it gives (:class:`Result`):

* the log-evidence and the final normalized log-weights;
* the smoothing means ``M[t, e] = sum_i w_i r_{t,e}^(i)`` of the final
  weighted trajectories and their weighted variances ``V[t, e]``, by a
  backward pass that carries each generation's particles' descendant
  weight to their ancestors;
* every lineage's digest (:mod:`.digest`).

Systematic resampling forms the weights' CDF in one of two float32
orders: ``cdf="rows"``, the program's own fixed-order row scan of a
``[2, N]`` tensor, with which the float32 results equal the program's
bit for bit; or ``cdf="flat"``, a plain scan, which stands for a sound
change of order.  At ``dtype=bfloat16`` the filter is the control: the
reference put in the program's place one precision lower.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from .digest import Digest


class Result(NamedTuple):
    log_evidence: torch.Tensor  # 0-dim float32
    log_weights: torch.Tensor  # [N] float32, normalized
    digests: Tuple[torch.Tensor, torch.Tensor]  # [N] int64 each
    smooth: torch.Tensor  # [T, E] float64: smoothing means
    var: torch.Tensor  # [T, E] float64: their weighted variances


def systematic_ancestors(gen: torch.Generator, logw: torch.Tensor, cdf: str = "rows") -> torch.Tensor:
    """Ancestors ``[N] int64`` by systematic resampling of ``logw``: one
    uniform ``u``, positions ``(j + u) / N``, each taking the first
    particle whose CDF entry reaches it."""
    n = logw.shape[0]
    w = torch.exp(logw - torch.logsumexp(logw, 0))
    if cdf == "rows":
        cum = torch.cumsum(torch.stack([w, w]), 1)[0]
    elif cdf == "flat":
        cum = torch.cumsum(w, 0)
    else:
        raise ValueError(f"cdf {cdf!r}: 'rows' or 'flat'")
    cum = cum / cum[-1]
    u = torch.rand((), generator=gen, device=gen.device, dtype=torch.float32).to(cum.dtype)
    positions = (torch.arange(n, dtype=cum.dtype, device=cum.device) + u) / torch.full(
        (), n, dtype=cum.dtype, device=cum.device
    )
    anc = torch.searchsorted(cum.float(), positions.float(), side="left")
    return anc.clamp(max=n - 1)


def gather(state: Any, anc: torch.Tensor) -> Any:
    if isinstance(state, torch.Tensor):
        return state[anc]
    return type(state)(*(gather(x, anc) for x in state))


def ess(logw: torch.Tensor) -> torch.Tensor:
    w = torch.exp(logw - torch.logsumexp(logw, 0))
    return 1.0 / torch.sum(w * w)


def run(
    model: Any,
    elems: int,
    n: int,
    observations: torch.Tensor,
    gen: torch.Generator,
    ess_threshold: Optional[float] = None,
    cdf: str = "rows",
) -> Result:
    """Filter ``observations [T]`` with ``n`` particles of ``model`` (a
    model module's ``Model``: ``init(gen, n)`` and ``step(gen, state, t,
    y) -> (state, logw, record)``, computed in ``model.dtype``), whose
    records have ``elems`` elements.  Resamples every generation, or,
    with ``ess_threshold``, where the ESS falls below it times ``n``."""
    dev, dtype = gen.device, model.dtype
    n_steps = observations.shape[0]
    digest = Digest(n_steps, elems, dev)
    records = torch.empty((n_steps, n, elems), dtype=torch.float32, device=dev)
    ancestors = torch.empty((n_steps, n), dtype=torch.int32, device=dev)
    state = model.init(gen, n)
    uniform = torch.full((n,), -math.log(n), dtype=dtype, device=dev)
    logw = uniform
    logz = torch.zeros((), dtype=dtype, device=dev)
    h = digest.empty(n, dev)
    for t in range(n_steps):
        resample = t > 0 and (ess_threshold is None or bool(ess(logw) < ess_threshold * n))
        if resample:
            anc = systematic_ancestors(gen, logw, cdf)
            state, h, logw = gather(state, anc), (h[0][anc], h[1][anc]), uniform
            ancestors[t] = anc.to(torch.int32)
        else:
            ancestors[t] = torch.arange(n, dtype=torch.int32, device=dev)
        y = observations[t].to(dtype)
        state, dlogw, record = model.step(gen, state, t, y)
        lw = logw + dlogw
        logz = logz + torch.logsumexp(lw, 0)
        logw = lw - torch.logsumexp(lw, 0)
        record = record.reshape(n, elems)
        h = digest.step(h, record)
        records[t] = record.to(torch.float32)
    smooth, var = smoothing(records, ancestors, logw)
    return Result(logz.float(), logw.float(), h, smooth, var)


def smoothing(records: torch.Tensor, ancestors: torch.Tensor, logw: torch.Tensor):
    """``(M, V)``, each ``[T, E]``, of ``records [T, N, E]`` under the
    final ``logw``, with ``ancestors[t]`` the generation-``t`` particles'
    ancestors among generation ``t - 1``'s."""
    n_steps, n, elems = records.shape
    w = torch.exp(logw.double() - torch.logsumexp(logw.double(), 0))
    smooth = torch.empty((n_steps, elems), dtype=torch.float64, device=records.device)
    var = torch.empty_like(smooth)
    for t in range(n_steps - 1, -1, -1):
        r = records[t].double()
        smooth[t] = w @ r
        var[t] = w @ (r - smooth[t]) ** 2
        if t > 0:
            w = torch.zeros_like(w).index_add_(0, ancestors[t].long(), w)
    return smooth, var
