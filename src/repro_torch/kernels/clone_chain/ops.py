"""Public entry points for the fused resample->clone->refcount chain.

:func:`clone_chain` takes log-weights and the current tables and returns
the ancestors, the cloned tables, and the refcount delta / freeze
membership — everything ``store.clone`` needs, with the tables read
once.  Its weight math is :func:`weights_cdf` plus one scalar uniform,
the same path :func:`repro_torch.smc.resampling.resample_systematic`
takes, so fused and composed paths are ancestor-bit-exact.

:func:`clone_chain_kernel` is the kernel wrapper: CUDA tensors launch
``csrc/clone_chain.cu``, CPU tensors run :func:`clone_chain_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Any, Tuple

import torch

from repro_torch import random as rnd
from repro_torch.kernels import _build
from repro_torch.kernels.clone_chain.ref import clone_chain_ref, weights_cdf
from repro_torch.kernels.dispatch import check, route

_P, _I = ctypes.c_void_p, ctypes.c_int64

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def clone_chain_kernel(
    cum: torch.Tensor,  # [n] f32 inclusive CDF, cum[-1] == 1
    u: torch.Tensor,  # one f32 uniform (0-dim or [1])
    tables: torch.Tensor,  # [n, mb] int32
    num_blocks: int,
) -> Out:
    """Returns ``(ancestors [n], new_tables [n, mb], delta [nb], member [nb])``."""
    n = cum.shape[0]
    check(cum, "cum", torch.float32, (n,))
    check(tables, "tables", torch.int32, (n, None))
    if u.dtype != torch.float32 or u.numel() != 1:
        raise ValueError("u must hold one float32 uniform")
    if route(cum, u, tables) == "cpu":
        return clone_chain_ref(cum, u, tables, num_blocks)
    dev = cum.device
    mb = tables.shape[1]
    anc = torch.empty(n, dtype=torch.int32, device=dev)
    new_tables = torch.empty((n, mb), dtype=torch.int32, device=dev)
    delta = torch.zeros(num_blocks, dtype=torch.int32, device=dev)
    member = torch.zeros(num_blocks, dtype=torch.bool, device=dev)
    if n > 0:
        _build.launch(
            "clone_chain",
            (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
            dev,
            _build.ptr(cum),
            _build.ptr(u),
            _build.ptr(tables),
            n,
            mb,
            num_blocks,
            _build.ptr(anc),
            _build.ptr(new_tables),
            _build.ptr(delta),
            _build.ptr(member),
        )
        clone_chain_kernel.launches += 1
    return anc, new_tables, delta, member


clone_chain_kernel.launches = 0


def clone_chain(
    gen: Any,
    logw: torch.Tensor,  # [n] log-weights (any normalization)
    tables: torch.Tensor,  # [n, mb] int32 block tables (NULL = -1 allowed)
    *,
    num_blocks: int,
) -> Out:
    """Draw one uniform from ``gen`` and run the fused chain.

    Returns ``(ancestors [n], new_tables [n, mb], delta [nb], member [nb])``.
    """
    cum = weights_cdf(logw)
    u = rnd.uniform(gen, ()).to(cum.device)
    return clone_chain_kernel(cum, u, tables, num_blocks)
