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


def cow_write_delta_ref(
    data: torch.Tensor,  # [num_blocks + 1, *block_shape]
    src: torch.Tensor,  # [n] int32
    dst: torch.Tensor,  # [n] int32
    pos: torch.Tensor,  # [n] int32
    values: torch.Tensor,  # [n, *item_shape]
    keep: torch.Tensor,  # [n, block_size] bool or uint8: slots copied from src
) -> torch.Tensor:
    """Sub-block delta variant: slots whose ``keep`` bit is clear are
    zeroed rather than copied (the delta-COW zero fill), and the written
    item lands at ``pos`` whatever its keep bit.  ``keep`` all set is
    :func:`cow_write_ref`."""
    n = src.shape[0]
    blocks = data[src.long()]  # [n, block_size, *item]
    kexp = keep.bool().reshape(keep.shape + (1,) * (blocks.dim() - 2))
    blocks = torch.where(kexp, blocks, torch.zeros((), dtype=data.dtype, device=data.device))
    rows = torch.arange(n, device=data.device)
    blocks[rows, pos.long()] = values.to(data.dtype)
    data[dst.long()] = blocks
    return data
