"""Public entry points for the fused COW write.

:func:`cow_write` is ``cow_write_pallas``'s port (whole-block COW);
:func:`cow_write_delta` is ``cow_write_delta_pallas``'s (sub-block delta
COW: only the ``keep`` slots are copied, the rest are zeroed).  Each has
its own ``launches`` counter.  CUDA tensors launch ``csrc/cow_write.cu``
(one template for both variants, one launch a call); CPU tensors run
:func:`cow_write_ref` / :func:`cow_write_delta_ref`.  Both write into
``data`` in place (the TPU kernel's ``input_output_aliases``) and are
bit-exact on every non-dump row; the dump row is zero after either
(the kernel zeroes it in its own launch, the CPU path with ``zero_()``
after the write).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cow_write.ref import cow_write_delta_ref, cow_write_ref
from repro_torch.kernels.dispatch import check, route

_P, _I = ctypes.c_void_p, ctypes.c_int64
_WORD_DTYPES = (torch.float32, torch.int32)


def _check_write(data, src, dst, pos, values) -> torch.Tensor:
    n = src.shape[0]
    check(data, "data", _WORD_DTYPES)
    for name, t in (("src", src), ("dst", dst), ("pos", pos)):
        check(t, name, torch.int32, (n,))
    values = values.to(data.dtype).contiguous()
    check(values, "values", data.dtype, (n, *data.shape[2:]))
    return values


def cow_write(
    data: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    pos: torch.Tensor,
    values: torch.Tensor,
) -> torch.Tensor:
    """Fused copy-on-write + item write, in place.

    data: [num_blocks + 1, block_size, *item_shape] (trailing dump row);
    src/dst/pos: [n] int32 (dump-routed rows are skipped);
    values: [n, *item_shape].  Returns ``data``.
    """
    values = _check_write(data, src, dst, pos, values)
    n = src.shape[0]
    if route(data, src, dst, pos, values) == "cpu":
        cow_write_ref(data, src, dst, pos, values)
    elif n > 0:
        # The kernel skips masked rows and zeroes the dump row itself.
        _launch(data, src, dst, pos, values, None)
        cow_write.launches += 1
        return data
    # Masked rows self-copied the dump row; re-zero it so pools compare
    # leaf-for-leaf across paths.
    data[-1].zero_()
    return data


cow_write.launches = 0


def cow_write_delta(
    data: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    pos: torch.Tensor,
    values: torch.Tensor,
    keep: torch.Tensor,
) -> torch.Tensor:
    """Sub-block delta COW + item write, in place.

    As :func:`cow_write`, plus ``keep: [n, block_size]`` bool or uint8:
    slot s of row i is copied from ``src`` only where ``keep[i, s]``, the
    written item lands at ``pos``, every other slot is zeroed.  A copy
    row with nothing to keep should carry the dump row as ``src``: the
    kernel then reads no source word.  Returns ``data``.
    """
    values = _check_write(data, src, dst, pos, values)
    n = src.shape[0]
    check(keep, "keep", (torch.bool, torch.uint8), (n, data.shape[1]))
    if route(data, src, dst, pos, values, keep) == "cpu":
        cow_write_delta_ref(data, src, dst, pos, values, keep)
    elif n > 0:
        # The kernel skips masked rows and zeroes the dump row itself.
        _launch(data, src, dst, pos, values, keep)
        cow_write_delta.launches += 1
        return data
    data[-1].zero_()
    return data


cow_write_delta.launches = 0


def _launch(data, src, dst, pos, values, keep) -> None:
    _build.launch(
        "cow_write",
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I),
        data.device,
        _build.ptr(data),
        _build.ptr(src),
        _build.ptr(dst),
        _build.ptr(pos),
        _build.ptr(values),
        None if keep is None else _build.ptr(keep),
        src.shape[0],
        math.prod(data.shape[1:]),
        math.prod(values.shape[1:]),
        data.shape[0] - 1,
    )
