"""Particle Gibbs (conditional SMC) on the lazy-copy store, in PyTorch.

The port of ``repro.smc.pgibbs``.  Each iteration runs one conditional
SMC sweep (:meth:`repro_torch.smc.filters.ParticleFilter.csmc_sweep`:
particle 0 keeps the reference lineage), picks one particle by its
final weight, and deep-copies that trajectory *eagerly*
(:func:`repro_torch.core.store.materialize`) as the next iteration's
reference: the paper's VBD note, a copy outside the tree-structured
pattern, since the reference must outlive the population it came from.

The sweep is the filter's, so particle Gibbs inherits its host loop:
``FilterConfig.grow`` runs each sweep in chunks with pool growth and
rollback-retry, bit-exact with an oversized pool; ``FilterConfig.mesh``
runs each sweep over the shards, and the retained trajectory is read
through ``sharded_store.trajectories`` (a 1-shard sweep is bit-exact with
the single-device one).

Draws come from one generator, in the reference's order: each
iteration's sweep, then the pick's Gumbel noise over the N weights (the
noise ``jax.random.categorical`` adds).  Under a mesh ``gen`` may be a
:class:`~repro_torch.distributed.ShardStreams`, whose shared stream draws
the pick.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import random as rnd
from repro_torch.core import store as store_lib
from repro_torch.distributed import sharded_store as sharded_lib
from repro_torch.distributed.mesh import ShardStreams
from repro_torch.smc import executor as executor_lib
from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef

__all__ = ["ParticleGibbs", "PGResult"]


class PGResult(NamedTuple):
    reference: torch.Tensor  # [T, *record] retained trajectory
    log_evidences: torch.Tensor  # [n_iters]
    peak_blocks: torch.Tensor  # int32, max over iterations (under a mesh [S])
    used_blocks_trace: torch.Tensor  # [n_iters, T]
    # ``oom``: some sweep's store stuck its allocation-failure flag (the
    # retained trajectory is then NOT trustworthy); ``grew`` counts pool
    # growth events across all sweeps.
    oom: torch.Tensor  # 0-dim bool
    grew: torch.Tensor  # 0-dim int32


class ParticleGibbs:
    """``device`` defaults to the GPU and raises when none is present;
    pass ``device="cpu"`` for the plain PyTorch path."""

    def __init__(self, ssm: SSMDef, config: FilterConfig, device: torch.device | str | None = None):
        if ssm.set_reference is None:
            raise ValueError("particle Gibbs requires SSMDef.set_reference")
        self.ssm = ssm
        self.config = config
        self._pf = ParticleFilter(ssm, config, device)
        self.device = self._pf.device
        self.store_cfg = self._pf.store_cfg
        self.sharded_cfg = self._pf.sharded_cfg

    @property
    def executor(self) -> executor_lib.PopulationExecutor:
        return self._pf.executor

    def run(self, gen: Any, params: Any, observations: Any, n_iters: int = 3) -> PGResult:
        cfg, dev = self.config, self.device
        t_steps = cfg.n_steps
        ref = torch.zeros((t_steps, *self.ssm.record_shape), dtype=getattr(torch, cfg.dtype), device=dev)
        logzs, traces = [], []
        peak = torch.zeros((), dtype=torch.int32, device=dev)
        oom = torch.zeros((), dtype=torch.bool, device=dev)
        grew = 0
        pick_gen = gen.shared if isinstance(gen, ShardStreams) else gen
        for it in range(n_iters):
            result = self._pf.csmc_sweep(gen, params, observations, ref, it > 0)
            idx = torch.argmax(result.log_weights + rnd.gumbel(pick_gen, (cfg.n_particles,)))
            # The eager deep copy between iterations (paper, Section 4 VBD).
            ref = self._materialize(result.store, idx)[:t_steps]
            logzs.append(result.log_evidence)
            traces.append(result.used_blocks_trace)
            peak = torch.maximum(peak, self._peak(result.store))
            oom = oom | result.oom
            grew += int(result.grew)
        return PGResult(
            reference=ref,
            log_evidences=torch.stack(logzs),
            peak_blocks=peak,
            used_blocks_trace=torch.stack(traces),
            oom=oom,
            grew=torch.tensor(grew, dtype=torch.int32, device=dev),
        )

    def _materialize(self, store: Any, idx: torch.Tensor) -> torch.Tensor:
        if self.sharded_cfg is not None:
            return sharded_lib.trajectories(self.sharded_cfg, self.config.mesh, store)[idx]
        return store_lib.materialize(self.store_cfg, store, idx)

    def _peak(self, store: Any) -> torch.Tensor:
        if self.sharded_cfg is not None:
            return sharded_lib.peak_blocks_per_shard(self.sharded_cfg, self.config.mesh, store)
        return store.peak_blocks
