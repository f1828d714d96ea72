"""Plain PyTorch version of cow_write — the CPU path and the yardstick
the CUDA kernel is held against.

Same routing contract as the kernel (``csrc/cow_write.cu``): gather the
source blocks, merge each row's item, scatter to the destinations.  It
writes into ``data`` in place, as the kernel does, so the CPU tests see
the same aliasing.  Masked rows carry ``src = dst = num_blocks`` (the
dump row); only the dump row ever sees duplicate destinations, and the
wrapper re-zeroes it.
"""

from __future__ import annotations

import torch


def cow_write_ref(
    data: torch.Tensor,  # [num_blocks + 1, *block_shape]
    src: torch.Tensor,  # [n] int32
    dst: torch.Tensor,  # [n] int32
    pos: torch.Tensor,  # [n] int32
    values: torch.Tensor,  # [n, *item_shape]
) -> torch.Tensor:
    n = src.shape[0]
    blocks = data[src.long()]  # [n, block_size, *item]
    rows = torch.arange(n, device=data.device)
    blocks[rows, pos.long()] = values.to(data.dtype)
    data[dst.long()] = blocks
    return data
