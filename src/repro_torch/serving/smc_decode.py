"""Population-based (SMC) decoding with O(1) KV forks, in PyTorch (the
port of ``repro.serving.smc_decode``).

N continuations ("particles") of one prompt evolve token by token; each
step reweights them (likelihood under the *target* temperature over the
*proposal* temperature); when the effective sample size collapses, the
population is resampled — a fork of the paged KV cache that moves no KV
data (refcount bookkeeping only).  Token histories live in a
:class:`repro_torch.core.store.ParticleStore` of int32 items, so a
resampling step clones them by refcount through the fused
``clone_chain`` kernel instead of gathering a dense token matrix.

A decode is a one-request schedule of the continuous-batching
:class:`~repro_torch.serving.scheduler.Scheduler`, as in the reference.

Differences from the reference:

* Draws come from a generator (:mod:`repro_torch.random`): a
  ``torch.Generator`` or a :class:`~repro_torch.random.Replay`.  With one
  stateful generator, :func:`smc_token_update` hands back a snapshot
  taken before the resampling uniform, so the fused clone of the token
  histories draws that same uniform (the reference hands both the same
  key).
* ``mesh=`` takes a :class:`~repro_torch.distributed.ShardMesh` on the
  decoder's device (a ``TypeError`` for anything else).  It shards the
  token-history store (per-shard block pools, the boundary-only exchange
  of :mod:`repro_torch.distributed.sharded_store`); the KV cache is not
  sharded, as in the reference.  A sharded trace's clone is the
  systematic draw followed by the exchange, not the fused kernel.
* There is no ``use_store_kernels`` switch: the device decides.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core import store as store_lib
from repro_torch.core.config import CopyMode
from repro_torch.core.store import StoreConfig
from repro_torch.distributed import sharded_store as sharded_lib
from repro_torch.distributed.mesh import entry_device, require_mesh
from repro_torch.models.layers import Params
from repro_torch.models.model import LanguageModel
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.kv_cache import KVCacheConfig
from repro_torch.smc import executor as executor_lib
from repro_torch.smc import resampling

__all__ = ["SMCDecodeResult", "SMCDecoder", "smc_token_update"]


class _TokenTrace:
    """Population token histories in a ParticleStore of int32 items, or
    with a ``mesh`` in a sharded one (per-shard pools on the mesh)."""

    def __init__(
        self,
        n: int,
        steps: int,
        mode: CopyMode,
        block_size: int,
        mesh: Optional[Any] = None,
        *,
        device: torch.device | str | None = None,
    ):
        self.mesh = require_mesh(mesh)
        device = entry_device(self.mesh, device)
        block_size = min(block_size, max(steps, 1))
        self.cfg = StoreConfig(
            mode=mode,
            n=n,
            block_size=block_size,
            max_blocks=-(-max(steps, 1) // block_size),
            item_shape=(),
            dtype="int32",
        )
        if self.mesh is not None:
            self.shcfg = sharded_lib.ShardedStoreConfig(
                base=self.cfg, num_shards=self.mesh.num_shards, axis_name=self.mesh.axis_name
            )
            self.store = sharded_lib.create(self.shcfg, self.mesh)
        else:
            self.store = store_lib.create(self.cfg, device)

    def append(self, token: torch.Tensor) -> None:
        if self.mesh is not None:
            self.store = sharded_lib.append(self.shcfg, self.mesh, self.store, token)
        else:
            self.store = store_lib.append(self.cfg, self.store, token)

    def clone(self, ancestors: torch.Tensor) -> None:
        if self.mesh is not None:
            self.store = sharded_lib.clone(self.shcfg, self.mesh, self.store, ancestors)
        else:
            self.store = store_lib.clone(self.cfg, self.store, ancestors)

    def clone_chain(self, gen: Any, logw: torch.Tensor) -> torch.Tensor:
        """Fused resample -> clone (``kernels/clone_chain``): draw one
        uniform from ``gen``, derive the systematic ancestors and clone the
        histories in one pass over the tables; returns the ancestors.  A
        sharded trace draws the same ancestors
        (``resampling.resample_systematic``) and clones through the
        exchange."""
        if self.mesh is not None:
            ancestors = resampling.resample_systematic(gen, logw)
            self.clone(ancestors)
            return ancestors
        self.store, ancestors = store_lib.clone_chain(self.cfg, self.store, gen, logw)
        return ancestors

    def oom(self) -> bool:
        if self.mesh is not None:
            return bool(sharded_lib.oom_flag(self.shcfg, self.mesh, self.store))
        return bool(store_lib.oom_flag(self.cfg, self.store))

    @property
    def append_need(self) -> int:
        """Worst-case blocks one append pops (per shard): one block per
        (local) particle."""
        return self.shcfg.n_local if self.mesh is not None else self.cfg.n

    def pool_view(self) -> executor_lib.PoolView:
        """The executor's growth port over this trace: host-mutable (the
        store lives on ``self``), per-shard lockstep for a sharded trace,
        capped at the dense bound (``cap=0`` under EAGER: there is no
        pool)."""
        if self.mesh is not None:
            shcfg, mesh = self.shcfg, self.mesh

            def grow_sharded(carry, new_nb):
                self.store = sharded_lib.grow(shcfg, mesh, self.store, new_nb)
                return carry

            return executor_lib.PoolView(
                free=lambda _: sharded_lib.free_blocks(shcfg, mesh, self.store),
                num_blocks=lambda _: sharded_lib.local_num_blocks(self.store),
                cap=sharded_lib.lifecycle_cap(shcfg),
                grow_to=grow_sharded,
                oom=lambda _: sharded_lib.oom_flag(shcfg, mesh, self.store),
            )
        cap = 0 if self.cfg.mode is CopyMode.EAGER else self.cfg.pool_blocks_cap

        def grow_to(carry, new_nb):
            self.store = store_lib.grow(self.cfg, self.store, new_nb)
            return carry

        return executor_lib.PoolView(
            free=lambda _: store_lib.free_blocks(self.cfg, self.store),
            num_blocks=lambda _: self.store.pool.num_blocks,
            cap=cap,
            grow_to=grow_to,
            oom=lambda _: store_lib.oom_flag(self.cfg, self.store),
        )

    def ensure_clone_headroom(
        self,
        ancestors: torch.Tensor,
        factor: float,
        ex: Optional[executor_lib.PopulationExecutor] = None,
        extra: int = 0,
    ) -> int:
        """Grow so the coming clone's cross-shard imports cannot run out
        of blocks: :meth:`clone_import_demand` sizes the demand, the
        executor's ``ensure`` applies the growth policy.  ``extra`` folds
        the coming append's watermark into the same growth event; ``ex``
        routes the event into a caller's stats.  Returns the growth events
        (0 or 1)."""
        demand = self.clone_import_demand(ancestors)
        if demand <= 0:
            return 0
        ex = ex if ex is not None else executor_lib.PopulationExecutor()
        start = ex.stats.grow_events
        ex.ensure(self.pool_view(), None, demand + extra, factor)
        return ex.stats.grow_events - start

    def clone_import_demand(self, ancestors: torch.Tensor) -> int:
        """The worst shard's block demand of the coming clone's imports:
        0 unsharded (a clone moves refcounts, never allocates) and under
        EAGER; else, per shard, the blocks of the trajectories its
        boundary crossers import, from the replicated ancestors and the
        current lengths, before the clone runs (the clone releases the old
        generation first, so there is at least as much room then)."""
        if self.mesh is None or self.cfg.mode is CopyMode.EAGER:
            return 0
        S, nl, bs = self.shcfg.num_shards, self.shcfg.n_local, self.cfg.block_size
        anc = ancestors.cpu().numpy()
        lengths = sharded_lib.gather_global(
            self.mesh, [st.lengths for st in self.store.shards]
        ).cpu().numpy()
        slot_shard = np.arange(self.cfg.n) // nl
        cross = (anc // nl) != slot_shard
        blocks = -(-np.maximum(lengths[anc], 0) // bs)
        return int(max(blocks[cross & (slot_shard == s)].sum() for s in range(S)))

    def tokens(self, steps: int) -> torch.Tensor:
        """Materialize all histories: ``[N, steps]`` int32."""
        if self.mesh is not None:
            return sharded_lib.trajectories(self.shcfg, self.mesh, self.store)[:, :steps]
        ids = torch.arange(self.cfg.n, dtype=torch.int32, device=self.store.tables.device)
        return store_lib.materialize_batch(self.cfg, self.store, ids)[:, :steps]


class SMCDecodeResult(NamedTuple):
    tokens: torch.Tensor  # [N, steps] sampled continuations
    log_weights: torch.Tensor  # [N]
    log_evidence: torch.Tensor  # scalar: log E_proposal[target/proposal]
    ess_trace: torch.Tensor  # [steps]
    used_blocks_trace: torch.Tensor  # [steps]
    resampled: torch.Tensor  # [steps] bool
    # The sticky allocation-failure flag of the KV page pool OR the
    # token-history store (if True, ``tokens`` is not trustworthy), and
    # the pool growth events across both.
    oom: torch.Tensor  # scalar bool
    grew: torch.Tensor  # scalar int32
    # How often the scheduler preempted this request (0 for a private run).
    preemptions: int = 0
    # "ok", or the ``RequestStatus`` value of a request the scheduler
    # cancelled, expired, quarantined or shed; ``tokens`` then holds the
    # completed prefix, zero-padded to ``steps``.
    status: str = "ok"


def smc_token_update(
    gen: Any,
    logits: torch.Tensor,  # [N, V] for this population
    logw: torch.Tensor,  # [N] normalized
    logz: torch.Tensor,  # scalar accumulator
    *,
    n: int,
    target_temp: float,
    proposal_temp: float,
    ess_threshold: float,
):
    """One population's per-token SMC math (sample -> reweight ->
    resample decision), shared by :meth:`SMCDecoder.run` and the
    scheduler.

    Draws the Gumbel noise of the token sample from ``gen``, then, if the
    ESS falls under the threshold, the systematic resampling uniform.
    Returns ``(token, logw, logz, ess, do_resample, ancestors, k_res)``;
    ``ancestors`` and ``k_res`` are ``None`` unless ``do_resample``.
    ``k_res`` is a snapshot of ``gen`` taken just before the resampling
    uniform: the fused :meth:`_TokenTrace.clone_chain` draws from it the
    same uniform and so derives the same ancestors.
    """
    logp_prop = torch.log_softmax(logits / proposal_temp, dim=-1)
    logp_tgt = torch.log_softmax(logits / target_temp, dim=-1)
    noise = rnd.gumbel(gen, logp_prop.shape).to(logp_prop.device)
    token = torch.argmax(logp_prop + noise, dim=-1)  # [N]
    rows = token[:, None]
    inc = logp_tgt.gather(1, rows)[:, 0] - logp_prop.gather(1, rows)[:, 0]
    lw = logw + inc
    logz = logz + torch.logsumexp(lw, 0)
    logw = resampling.normalize(lw)
    ess = resampling.ess(logw)
    do_resample = bool(ess < ess_threshold * n)
    ancestors = k_res = None
    if do_resample:
        k_res = rnd.snapshot(gen)
        ancestors = resampling.resample_systematic(gen, logw)
    return token, logw, logz, ess, do_resample, ancestors, k_res


class SMCDecoder:
    def __init__(
        self,
        lm: LanguageModel,
        params: Params,
        n_particles: int,
        *,
        max_len: int = 256,
        target_temp: float = 0.7,
        proposal_temp: float = 1.0,
        ess_threshold: float = 0.5,
        block_size: int = 16,
        token_copy_mode: CopyMode = CopyMode.LAZY_SR,
        mesh: Optional[Any] = None,
        kv_num_blocks: int = 0,
        grow_stores: bool = True,
        grow_factor: float = 2.0,
        kv_delta_cow: bool = False,
        device: torch.device | str | None = None,
    ):
        mesh = require_mesh(mesh)
        device = entry_device(mesh, device)
        cfg = lm.cfg
        cache_cfg = KVCacheConfig(
            n_layers=cfg.n_layers,
            n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd,
            block_size=block_size,
            max_seqs=n_particles,
            max_blocks_per_seq=-(-max_len // block_size),
            num_blocks=kv_num_blocks,
            dtype=cfg.dtype,
            delta_cow=kv_delta_cow,
        )
        self.engine = ServeEngine(lm, params, cache_cfg, device=device)
        self.n = n_particles
        self.t_target = target_temp
        self.t_prop = proposal_temp
        self.ess_threshold = ess_threshold
        self.token_copy_mode = token_copy_mode
        self.mesh = mesh
        self.token_block_size = block_size
        # The boundary hook grows both pools (KV pages and token history)
        # pre-emptively; the sticky oom flags surface in the result.
        self.grow_stores = grow_stores
        self.grow_factor = grow_factor
        self._exec = executor_lib.PopulationExecutor()

    @property
    def executor(self) -> executor_lib.PopulationExecutor:
        """This decoder's executor (token loop + growth stats)."""
        return self._exec

    def request(self, gen: Any, prompt: torch.Tensor, steps: int, rid: str = "r0"):
        """This decoder's SMC configuration as a schedulable request."""
        from repro_torch.serving.scheduler import DecodeRequest

        return DecodeRequest(
            rid=rid,
            prompt=prompt,
            n_particles=self.n,
            steps=steps,
            gen=gen,
            target_temp=self.t_target,
            proposal_temp=self.t_prop,
            ess_threshold=self.ess_threshold,
            token_copy_mode=self.token_copy_mode,
            token_block_size=self.token_block_size,
            mesh=self.mesh,
        )

    def run(self, gen: Any, prompt: torch.Tensor, steps: int) -> SMCDecodeResult:
        """Decode one population as a one-request schedule over this
        decoder's engine and executor.  ``strict_admission=False`` keeps
        the historical contract: an undersized fixed pool
        (``grow_stores=False``) runs to completion and surfaces the sticky
        ``oom`` flag instead of refusing admission.  ``gen`` is not
        consumed (the scheduler draws from its own copy)."""
        from repro_torch.serving.scheduler import Scheduler

        sched = Scheduler(
            self.engine,
            grow=self.grow_stores,
            grow_factor=self.grow_factor,
            strict_admission=False,
            executor=self._exec,
        )
        sched.submit(self.request(gen, prompt, steps))
        return sched.run()["r0"]

    def dense_equivalent_blocks(self, steps: int, prompt_len: int) -> int:
        """Blocks a per-sequence dense cache would hold at the end."""
        bs = self.engine.cache_cfg.block_size
        per = -(-(prompt_len + steps) // bs)
        return self.n * per

