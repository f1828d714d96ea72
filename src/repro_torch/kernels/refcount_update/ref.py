"""Plain PyTorch version of the clone-bookkeeping histogram.

The signed histogram and membership that ``csrc/refcount_update.cu``
produces, as two scatters into accumulators one slot longer than the
pool (the extra slot takes NULL and out-of-range ids, JAX's
``mode="drop"``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def refcount_delta_ref(
    new_tables: torch.Tensor,  # [e] int32 (NULL = -1 allowed)
    old_tables: torch.Tensor,  # [e] int32
    num_blocks: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(delta [num_blocks] int32, member [num_blocks] bool)``."""
    dev = new_tables.device

    def sids(ids: torch.Tensor) -> torch.Tensor:
        ok = (ids >= 0) & (ids < num_blocks)
        return torch.where(ok, ids, num_blocks).long()

    new_ids, old_ids = sids(new_tables), sids(old_tables)
    delta = torch.zeros(num_blocks + 1, dtype=torch.int32, device=dev)
    delta.index_add_(0, new_ids, torch.ones_like(new_ids, dtype=torch.int32))
    delta.index_add_(0, old_ids, torch.full_like(old_ids, -1, dtype=torch.int32))
    member = torch.zeros(num_blocks + 1, dtype=torch.bool, device=dev)
    member[new_ids] = True
    return delta[:num_blocks], member[:num_blocks]
