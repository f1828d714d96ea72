"""Deterministic synthetic token pipeline: sharded, resumable, elastic
(the port of ``repro.data.pipeline``).

Batches are a pure function of ``(seed, step)``: the *global* batch of a
step is drawn statelessly, and each data-parallel rank takes its slice,
so resuming needs only the step counter (kept in the checkpoint's
``extra``) and another world size re-slices the same global batch.

The tokens follow a fixed random first-order Markov chain, whose
transition matrix comes from the reference's own draw
(``np.random.default_rng(seed).dirichlet``), so the matrix and the
cross-entropy floor (:attr:`TokenPipeline.entropy_rate`) equal the
reference's bit for bit.  The token stream is the port's own: the
reference's threefry stream is not ported.  A step's global batch is
drawn on the CPU from a ``torch.Generator`` seeded from ``(seed, step)``
(the first tokens uniform, then each next token by the inverse CDF of its
row at a uniform draw) and moved to the pipeline's device, so the stream
is the same whichever device trains.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.dispatch import resolve_device

__all__ = ["DataConfig", "TokenPipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_alpha: float = 0.3  # concentration: lower = more predictable


class TokenPipeline:
    def __init__(self, cfg: DataConfig, rank: int = 0, world: int = 1, *,
                 device: torch.device | str = "cuda"):
        if cfg.global_batch % world:
            raise ValueError(f"global batch {cfg.global_batch} is not a multiple of the world size {world}")
        self.cfg = cfg
        self.rank = rank
        self.world = world
        self.device = resolve_device(device)
        rng = np.random.default_rng(cfg.seed)
        # fixed Markov transition matrix (row-stochastic), the reference's draw
        probs = rng.dirichlet(np.full(cfg.vocab_size, cfg.markov_alpha), size=cfg.vocab_size)
        self.transition = probs
        self._entropy_rate = float(-np.mean(np.sum(probs * np.log(probs + 1e-9), -1)))
        cdf = torch.as_tensor(np.cumsum(probs, axis=-1))
        self._cdf = cdf / cdf[:, -1:]

    @property
    def entropy_rate(self) -> float:
        """The CE floor a perfect model reaches (nats/token)."""
        return self._entropy_rate

    def _generate(self, step: int) -> torch.Tensor:
        """The global batch of ``step`` as tokens [B, S + 1] (int64, CPU)."""
        cfg = self.cfg
        seed = int(np.random.SeedSequence([cfg.seed, step]).generate_state(1, np.uint64)[0] >> 1)
        gen = torch.Generator().manual_seed(seed)
        first = torch.randint(0, cfg.vocab_size, (cfg.global_batch,), generator=gen)
        u = torch.rand((cfg.seq_len, cfg.global_batch), generator=gen, dtype=torch.float64)
        out = torch.empty((cfg.seq_len + 1, cfg.global_batch), dtype=torch.int64)
        out[0] = tok = first
        for t in range(cfg.seq_len):
            rows = self._cdf[tok]
            tok = torch.searchsorted(rows, u[t, :, None], right=True)[:, 0].clamp_(max=cfg.vocab_size - 1)
            out[t + 1] = tok
        return out.T

    def _split(self, full: torch.Tensor) -> Dict[str, torch.Tensor]:
        full = full.to(torch.int32).to(self.device)
        return {"tokens": full[:, :-1].contiguous(), "labels": full[:, 1:].contiguous()}

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Tokens and labels of this rank at ``step`` (labels = the next
        token), int32 on the pipeline's device."""
        per = self.cfg.global_batch // self.world
        return self._split(self._generate(step)[self.rank * per : (self.rank + 1) * per])

    def global_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return self._split(self._generate(step))

    def state(self, step: int) -> Dict:
        return {"data_step": step, "seed": self.cfg.seed}
