"""Public entry point for the fused COW write.

CUDA tensors launch ``csrc/cow_write.cu``; CPU tensors run
:func:`cow_write_ref`.  Both write into ``data`` in place (the TPU
kernel's ``input_output_aliases``) and are bit-exact on every non-dump
row; the dump row is re-zeroed after either.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cow_write.ref import cow_write_ref
from repro_torch.kernels.dispatch import check, route

_P, _I = ctypes.c_void_p, ctypes.c_int64
_WORD_DTYPES = (torch.float32, torch.int32)


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
    n = src.shape[0]
    check(data, "data", _WORD_DTYPES)
    for name, t in (("src", src), ("dst", dst), ("pos", pos)):
        check(t, name, torch.int32, (n,))
    values = values.to(data.dtype).contiguous()
    check(values, "values", data.dtype, (n, *data.shape[2:]))
    if route(data, src, dst, pos, values) == "cpu":
        cow_write_ref(data, src, dst, pos, values)
    elif n > 0:
        block_words = math.prod(data.shape[1:])
        item_words = math.prod(values.shape[1:])
        _build.launch(
            "cow_write",
            (_P, _P, _P, _P, _P, _I, _I, _I),
            data.device,
            _build.ptr(data),
            _build.ptr(src),
            _build.ptr(dst),
            _build.ptr(pos),
            _build.ptr(values),
            n,
            block_words,
            item_words,
        )
        cow_write.launches += 1
    # Skipped rows self-copied the dump row in no fixed order; re-zero
    # it so pools compare leaf-for-leaf across paths.
    data[-1].zero_()
    return data


cow_write.launches = 0
