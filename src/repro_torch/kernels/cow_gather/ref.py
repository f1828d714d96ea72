"""Plain PyTorch version of cow_gather."""

from __future__ import annotations

import torch


def cow_gather_ref(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[i] = pool[table[i]]``; NULL (negative) entries give zero
    blocks, ids past the last row clamp to it (as an XLA gather does)."""
    out = pool[table.clamp(0, max(pool.shape[0] - 1, 0)).long()]
    valid = (table >= 0).reshape((-1,) + (1,) * (pool.dim() - 1))
    return torch.where(valid, out, torch.zeros((), dtype=pool.dtype, device=pool.device))
