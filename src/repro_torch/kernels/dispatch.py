"""Kernel registry and the port's device policy.

Mirrors ``repro.kernels.dispatch``: every op of its ``KNOWN_OPS`` has a
CUDA kernel here, and so do the gradients of ``flash_attention`` and
``ssd_scan`` (``*_bwd``), which the reference takes with ``jax.grad``
through plain code and the port, whose forward runs the kernels, takes
through kernels of their own.  The JAX package picks a path through
``use_kernel``/``interpret`` switches; the port has none.  The device of the tensors decides:

* CUDA tensors go to the hand-written kernel.  Its wrapper launches it
  or raises — there is no ``try`` that falls back to the plain version.
* CPU tensors go to the plain PyTorch version in the op's ``ref.py``.
* Anything else (``meta``, another accelerator, mixed devices) raises.

Each wrapper carries a plain integer ``launches`` that it bumps where it
launches its kernel and nowhere else, so a run can show that its main
path went through the kernels (:func:`launch_counts`).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch

__all__ = [
    "KNOWN_OPS",
    "get_op",
    "route",
    "resolve_device",
    "check",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel-op registry: public op name -> (subpackage, wrapper that
#: launches the kernel).  Each wrapper has a ``launches`` counter.  The
#: reference's ``cow_write`` and ``paged_attention`` entries are two here
#: each, one per TPU kernel they dispatch to, so each variant's launches
#: are counted.
KNOWN_OPS = {
    "cow_write": ("repro_torch.kernels.cow_write", "cow_write"),
    "cow_write_delta": ("repro_torch.kernels.cow_write", "cow_write_delta"),
    "refcount_update": ("repro_torch.kernels.refcount_update", "refcount_delta"),
    "cow_gather": ("repro_torch.kernels.cow_gather", "cow_gather"),
    "clone_chain": ("repro_torch.kernels.clone_chain", "clone_chain_kernel"),
    "paged_attention": ("repro_torch.kernels.paged_attention", "paged_attention_kernel"),
    "paged_attention_delta": (
        "repro_torch.kernels.paged_attention",
        "paged_attention_delta_kernel",
    ),
    "resample": ("repro_torch.kernels.resample", "systematic_comb"),
    "flash_attention": ("repro_torch.kernels.flash_attention", "flash_attention"),
    "ssd_scan": ("repro_torch.kernels.ssd_scan", "ssd_scan"),
    "flash_attention_bwd": ("repro_torch.kernels.flash_attention", "flash_attention_bwd"),
    "ssd_scan_bwd": ("repro_torch.kernels.ssd_scan", "ssd_scan_bwd"),
}


def get_op(name: str) -> Callable:
    """Resolve a registered kernel op to the wrapper that launches it."""
    if name not in KNOWN_OPS:
        raise ValueError(
            f"unknown kernel op {name!r}; expected one of {tuple(KNOWN_OPS)}"
        )
    module, attr = KNOWN_OPS[name]
    return getattr(importlib.import_module(module), attr)


def route(*tensors: torch.Tensor) -> str:
    """``"cuda"`` or ``"cpu"``: where an op on ``tensors`` runs.

    Raises on mixed devices and on any device other than CUDA or CPU.
    """
    kinds = {t.device.type for t in tensors}
    if len(kinds) != 1:
        raise ValueError(f"tensors on mixed devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no kernel route for device type {kind!r}")
    return kind


def resolve_device(device: torch.device | str) -> torch.device:
    """Validate an entry point's ``device``.  CUDA without a GPU raises:
    the port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check(
    t: torch.Tensor,
    name: str,
    dtype: torch.dtype | Iterable[torch.dtype],
    shape: Optional[Sequence[Optional[int]]] = None,
) -> None:
    """Raise unless ``t`` is contiguous, of ``dtype`` (one of, for an
    iterable) and of ``shape`` (``None`` entries match any size)."""
    dtypes = (dtype,) if isinstance(dtype, torch.dtype) else tuple(dtype)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None:
        ok = t.dim() == len(shape) and all(
            want is None or got == want for got, want in zip(t.shape, shape, strict=True)
        )
        if not ok:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def require_aligned(op: str, *, strides: int = 0, **tensors: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless each tensor's base, and its first
    ``strides`` strides in bytes, are multiples of 16: the card kernels
    load rows 16 bytes at a time or by TMA.  A kernel copies no input to
    align it; the caller does (``None`` entries are skipped)."""
    for name, t in tensors.items():
        if t is not None and (t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in t.stride()[:strides])):
            raise ValueError(f"{op}: {name} needs a 16-byte aligned base{' and strides' if strides else ''} "
                             f"(address {t.data_ptr()}, strides {t.stride()})")


def launch_counts() -> Dict[str, int]:
    """Kernel launches per op since the last :func:`reset_launch_counts`."""
    return {name: get_op(name).launches for name in KNOWN_OPS}


def reset_launch_counts() -> None:
    for name in KNOWN_OPS:
        get_op(name).launches = 0
