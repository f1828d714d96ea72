"""Exact fingerprints of particle trajectories.

A trajectory is the sequence of records a particle's lineage appended,
generation by generation.  Its digest is the pair of polynomial hashes

    h_j = sum_k v_k * B_j^(L-1-k)  mod M_j        (j = 0, 1)

over the float32 bit patterns ``v_k`` of its ``L = T * E`` record
elements in time order (``E`` elements a record).  ``M_j`` are primes
below 2^31, so every product of a bit pattern (< 2^32) and a power
(< 2^31) fits in int64 and nothing overflows.

Two ways reach the same value, exactly:

* :meth:`Digest.step`, forward and dense, as a filter runs: each
  particle carries its lineage's hash, gathered with its ancestor at a
  resampling and extended by its record each generation (Horner's rule).
  The reference filter keeps ``[N]`` hashes instead of ``[N, T]``
  trajectories, so it holds every particle's ancestry in O(N) memory.
* :meth:`Digest.whole`, over materialized trajectories ``[k, T, E]``,
  as read back from the program's store.

Equal digests mean equal trajectories up to a collision of both hashes
(about 2^-62 a pair).
"""

from __future__ import annotations

from typing import Tuple

import torch

MODS = (2147483647, 2147483587)
BASES = (1000003, 999331)


def bits(values: torch.Tensor) -> torch.Tensor:
    """float32 bit patterns as int64 in ``[0, 2^32)``; other float types
    are widened to float32 first (a widening is exact)."""
    v = values.to(torch.float32).contiguous()
    return v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _powers(length: int, base: int, mod: int) -> list:
    """``base^(length-1-k) mod mod`` for ``k < length``."""
    out = [1] * length
    for k in range(length - 2, -1, -1):
        out[k] = out[k + 1] * base % mod
    return out


class Digest:
    """Digests of trajectories of ``n_steps`` records of ``elems`` elements."""

    def __init__(self, n_steps: int, elems: int, device: torch.device | str):
        self.n_steps, self.elems = n_steps, elems
        dev = torch.device(device)
        self._whole = [
            torch.tensor(_powers(n_steps * elems, b, m), dtype=torch.int64, device=dev)
            for b, m in zip(BASES, MODS, strict=True)
        ]
        self._record = [
            torch.tensor(_powers(elems, b, m), dtype=torch.int64, device=dev)
            for b, m in zip(BASES, MODS, strict=True)
        ]
        self._shift = [pow(b, elems, m) for b, m in zip(BASES, MODS, strict=True)]

    def empty(self, n: int, device: torch.device | str) -> Tuple[torch.Tensor, torch.Tensor]:
        """The digests of ``n`` empty trajectories."""
        z = torch.zeros(n, dtype=torch.int64, device=device)
        return z, z.clone()

    def step(
        self, h: Tuple[torch.Tensor, torch.Tensor], record: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Extend each digest by one record (``record: [n, E]`` or ``[n]``)."""
        v = bits(record).reshape(record.shape[0], self.elems)
        out = []
        for hj, pw, shift, m in zip(h, self._record, self._shift, MODS, strict=True):
            c = ((v * pw) % m).sum(1)
            out.append((hj * shift + c) % m)
        return out[0], out[1]

    def whole(self, trajectories: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Digests of ``[k, T, *item]`` trajectories (the first ``T``
        records of each, ``T = n_steps``)."""
        k = trajectories.shape[0]
        v = bits(trajectories[:, : self.n_steps]).reshape(k, self.n_steps * self.elems)
        return tuple(((v * pw) % m).sum(1) % m for pw, m in zip(self._whole, MODS, strict=True))
