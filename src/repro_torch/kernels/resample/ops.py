"""Public entry points for systematic resampling (log-weights ->
ancestors).

:func:`resample_systematic_kernel` is the reference's
``repro.kernels.resample.ops.resample_systematic_kernel``: softmax of the
log-weights, their CDF, ``cum / cum[-1]``, one uniform, then the comb.
The CDF is a fixed-order row scan (:func:`fixed_order_cumsum`): a 1-D
CUDA ``cumsum`` sums in a timing-dependent order.

:func:`systematic_comb` is the kernel wrapper: CUDA tensors launch
``csrc/resample.cu``, CPU tensors run :func:`resample_systematic_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch

from repro_torch import random as rnd
from repro_torch.kernels import _build
from repro_torch.kernels.clone_chain.ref import fixed_order_cumsum
from repro_torch.kernels.dispatch import check, route
from repro_torch.kernels.resample.ref import resample_systematic_ref

_P, _I = ctypes.c_void_p, ctypes.c_int64


def systematic_comb(cum: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Ancestors ``[n] int32`` of the comb ``(j + u) / n`` against the
    inclusive CDF ``cum: [n] f32`` (``cum[-1] == 1``); ``u`` holds one
    float32 uniform.  On the card, one launch: a CTA per 512 outputs
    finds their source range once and searches it in shared memory."""
    n = cum.shape[0]
    check(cum, "cum", torch.float32, (n,))
    if u.dtype != torch.float32 or u.numel() != 1:
        raise ValueError("u must hold one float32 uniform")
    if route(cum, u) == "cpu":
        return resample_systematic_ref(cum, u)
    anc = torch.empty(n, dtype=torch.int32, device=cum.device)
    if n > 0:
        _build.launch(
            "resample_systematic", (_P, _P, _I, _P), cum.device,
            _build.ptr(cum), _build.ptr(u.contiguous()), n, _build.ptr(anc),
        )
        systematic_comb.launches += 1
    return anc


systematic_comb.launches = 0


def resample_systematic_kernel(gen: Any, logw: torch.Tensor) -> torch.Tensor:
    """Drop-in for :func:`repro_torch.smc.resampling.resample_systematic`
    with the reference kernel package's weight path; ``gen`` is a
    ``torch.Generator`` or a :class:`repro_torch.random.Replay`."""
    w = torch.softmax(logw, 0)
    cum = fixed_order_cumsum(w)
    cum = cum / cum[-1]
    u = rnd.uniform(gen, (1,)).to(cum.device)
    return systematic_comb(cum, u)
