"""Particle filters over the lazy-copy particle store, in PyTorch.

The port of ``repro.smc.filters`` for one device: bootstrap and
auxiliary filters, adaptive resampling, the alive filter's bounded
rejection loop, the simulation task (no resampling, hence no copies),
and conditional SMC (:meth:`ParticleFilter.csmc_sweep`).  The storage
strategy (EAGER / LAZY / LAZY_SR) is a config switch; the filter code is
the same for all three.

Differences from the reference:

* ``lax.scan`` is a Python loop over generations, ``lax.cond`` a Python
  ``if``: with ``always_resample`` the loop never waits for the device;
  the adaptive path reads the ESS on the host each generation.
* Randomness comes from one generator (a ``torch.Generator`` or a replay
  object, :mod:`repro_torch.random`) in the same order in every copy
  mode — init normals, then per generation the resampling uniforms, the
  SSM's draws, and any alive-filter redraws — so ``log_evidence`` is
  bit-identical across modes.  SSM callables take that generator where
  the reference's take a key.
* ``FilterConfig.mesh`` raises ``NotImplementedError`` (the sharded
  store is not ported), and there is no ``use_kernels``: the device
  decides.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import store as store_lib
from repro_torch.core.config import CopyMode
from repro_torch.core.store import ParticleStore, StoreConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.smc import executor as executor_lib
from repro_torch.smc import resampling
from repro_torch.smc.executor import tree_map

__all__ = ["SSMDef", "FilterConfig", "FilterResult", "ParticleFilter"]


class SSMDef(NamedTuple):
    """A vectorized state-space program (all callables act on the whole
    population, leading dim N).

    Attributes:
      init: ``(gen, n, params) -> state``.
      step: ``(gen, state, t, obs_t, params) -> (state, logw, record)``;
        ``record: [N, *record_shape]`` is what the store appends.
      record_shape: shape of one trajectory item.
      clone_state: optional ``(state, ancestors) -> state``; default
        gathers every tensor leaf.
      lookahead: optional ``(state, t, obs_t, params) -> logmu`` for the
        auxiliary filter's pre-weights.
      alive: optional ``(logw) -> dead_mask`` for the alive filter.
      set_reference: ``(state, ref_record_t) -> state`` for conditional
        SMC (pins particle 0).
    """

    init: Callable[..., Any]
    step: Callable[..., Tuple[Any, torch.Tensor, torch.Tensor]]
    record_shape: Tuple[int, ...]
    clone_state: Optional[Callable[[Any, torch.Tensor], Any]] = None
    lookahead: Optional[Callable[..., torch.Tensor]] = None
    alive: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    set_reference: Optional[Callable[[Any, torch.Tensor], Any]] = None


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    n_particles: int
    n_steps: int
    mode: CopyMode = CopyMode.LAZY_SR
    resampler: str = "systematic"
    ess_threshold: float = 0.5  # resample when ESS < threshold * N
    always_resample: bool = True  # the paper's motivating pattern
    block_size: int = 4  # store COW granularity (items per block)
    pool_blocks: int = 0  # 0 = auto
    max_retries: int = 0  # alive-filter retries (0 = plain PF)
    dtype: str = "float32"
    mesh: Any = None  # multi-device scaling: not ported (raises)
    # Pool lifecycle: run the generations in chunks with a host-side
    # headroom / OOM check between them, growing the pool instead of
    # sticking its oom flag; capped at StoreConfig.pool_blocks_cap.
    grow: bool = False
    grow_chunk: int = 8  # generations per chunk between host checks
    grow_factor: float = 2.0  # capacity multiplier per growth event

    def store_config(self, record_shape: Tuple[int, ...]) -> StoreConfig:
        return StoreConfig(
            mode=self.mode,
            n=self.n_particles,
            block_size=self.block_size,
            max_blocks=-(-self.n_steps // self.block_size),
            item_shape=tuple(record_shape),
            dtype=self.dtype,
            num_blocks=self.pool_blocks,
        )

    def growth_policy(self) -> executor_lib.GrowthPolicy:
        return executor_lib.GrowthPolicy(
            grow=self.grow, chunk=self.grow_chunk, factor=self.grow_factor
        )


class FilterResult(NamedTuple):
    store: ParticleStore
    state: Any
    log_weights: torch.Tensor  # [N], normalized
    log_evidence: torch.Tensor  # 0-dim estimate of log p(y_{1:T})
    ess_trace: torch.Tensor  # [T]
    resampled: torch.Tensor  # [T] bool
    used_blocks_trace: torch.Tensor  # [T] memory over time (Figure 7)
    # Sticky allocation failure: if True the trajectories are NOT
    # trustworthy.  ``grew`` counts pool growth events.
    oom: torch.Tensor  # 0-dim bool
    grew: torch.Tensor  # 0-dim int32


def _default_clone(state: Any, ancestors: torch.Tensor) -> Any:
    anc = ancestors.long()
    return tree_map(lambda x: x[anc] if isinstance(x, torch.Tensor) else x, state)


class ParticleFilter:
    """Bootstrap / auxiliary / alive / conditional particle filter over
    the COW store, driven by a :class:`PopulationExecutor`.

    ``device`` defaults to the GPU and raises when none is present; pass
    ``device="cpu"`` for the plain PyTorch path.
    """

    def __init__(
        self, ssm: SSMDef, config: FilterConfig, device: torch.device | str = "cuda"
    ):
        if config.mesh is not None:
            raise NotImplementedError(
                "sharded filtering (FilterConfig.mesh) is not ported yet"
            )
        self.device = resolve_device(device)
        self.ssm = ssm
        self.config = config
        self.store_cfg = config.store_config(ssm.record_shape)
        self._resample = resampling.RESAMPLERS[config.resampler]
        self._exec = executor_lib.PopulationExecutor()

    @property
    def executor(self) -> executor_lib.PopulationExecutor:
        return self._exec

    def run(self, gen: Any, params: Any, observations: Any) -> FilterResult:
        """Inference task: filter against observations ``[T, ...]``."""
        return self._run(gen, params, observations, simulate=False)

    def simulate(self, gen: Any, params: Any, dummy_obs: Any) -> FilterResult:
        """Simulation task: no conditioning, so no resampling and no copies."""
        return self._run(gen, params, dummy_obs, simulate=True)

    def csmc_sweep(
        self,
        gen: Any,
        params: Any,
        observations: Any,
        reference: torch.Tensor,
        use_ref: Any,
    ) -> FilterResult:
        """One conditional-SMC sweep: particle 0 keeps the reference
        lineage (ancestor forced to 0, record overwritten by
        ``reference[t]``) when ``use_ref`` is true."""
        if self.ssm.set_reference is None:
            raise ValueError("conditional SMC requires SSMDef.set_reference")
        reference = torch.as_tensor(reference, device=self.device)
        return self._run(
            gen, params, observations, simulate=False, csmc=(reference, bool(use_ref))
        )

    # -- internals ----------------------------------------------------------

    def _run(
        self,
        gen: Any,
        params: Any,
        observations: Any,
        simulate: bool,
        csmc: Optional[Tuple[torch.Tensor, bool]] = None,
    ) -> FilterResult:
        cfg, ssm, scfg = self.config, self.ssm, self.store_cfg
        n, dev = cfg.n_particles, self.device
        observations = tree_map(_float32, _as_tensors(observations, dev))

        state0 = ssm.init(gen, n, params)
        store0 = store_lib.create(scfg, dev)
        logw0 = torch.full((n,), -math.log(n), dtype=torch.float32, device=dev)
        init_carry = (gen, state0, store0, logw0, torch.zeros((), device=dev))

        chunk = self._exec.jit_chunk(
            ("local", bool(simulate), csmc is not None),
            lambda: self._build_chunk(simulate),
        )
        chunk_fn = lambda c, ts: chunk(c, ts, params, observations, csmc)  # noqa: E731

        # Carry layout: (gen, state, store, logw, logz).
        pool = executor_lib.PoolView(
            free=lambda c: store_lib.free_blocks(scfg, c[2]),
            num_blocks=lambda c: c[2].pool.num_blocks,
            cap=scfg.pool_blocks_cap,
            grow_to=lambda c, nb: (c[0], c[1], store_lib.grow(scfg, c[2], nb), c[3], c[4]),
            oom=lambda c: store_lib.oom_flag(scfg, c[2]),
        )
        carry, outs, grew = self._exec.run(
            init_carry,
            n_steps=cfg.n_steps,
            chunk_fn=chunk_fn,
            policy=cfg.growth_policy(),
            need_per_step=n,
            pool=pool,
        )
        _, state, store, logw, logz = carry
        ess_trace, resampled, used_trace = executor_lib.concat_chunk_outs(
            outs, executor_lib.filter_empty_outs(dev)
        )
        return FilterResult(
            store=store,
            state=state,
            log_weights=logw,
            log_evidence=logz,
            ess_trace=ess_trace,
            resampled=resampled,
            used_blocks_trace=used_trace,
            oom=store_lib.oom_flag(scfg, store),
            grew=torch.tensor(grew, dtype=torch.int32, device=dev),
        )

    def _build_chunk(self, simulate: bool):
        """The generation chunk ``(carry, ts, params, observations, csmc)
        -> (carry, (ess [g], resampled [g], used [g]))``."""

        def chunk(carry, ts, params, observations, csmc):
            step = self._make_step(params, observations, simulate, csmc)
            outs = []
            for t in ts:
                carry, out = step(carry, t)
                outs.append(out)
            dev = carry[3].device
            if not outs:
                return carry, executor_lib.filter_empty_outs(dev)
            ess_t, did_t, used_t = zip(*outs, strict=True)
            did = torch.tensor(did_t, dtype=torch.bool, device=dev)
            return carry, (torch.stack(ess_t), did, torch.stack(used_t))

        return chunk

    def _make_step(self, params, observations, simulate, csmc=None):
        """The per-generation step; ``csmc`` is ``(reference, use_ref)``."""
        cfg, ssm, scfg = self.config, self.ssm, self.store_cfg
        n, dev = cfg.n_particles, self.device
        clone_state = ssm.clone_state or _default_clone
        # Fused resample->clone (kernels/clone_chain): only the plain
        # systematic path fuses — cSMC rewrites the ancestors between
        # resample and clone, and EAGER has no tables to fuse over.
        fuse_chain = (
            cfg.resampler == "systematic"
            and csmc is None
            and scfg.mode is not CopyMode.EAGER
        )
        uniform_logw = torch.full((n,), -math.log(n), dtype=torch.float32, device=dev)

        def obs_at(t):
            return tree_map(lambda o: o[t], observations)

        def maybe_resample(gen, t, state, store, logw):
            if simulate or t == 0:
                return state, store, logw, False
            if not cfg.always_resample and not bool(
                resampling.should_resample(logw, cfg.ess_threshold)
            ):
                return state, store, logw, False
            lw = logw
            if ssm.lookahead is not None:
                lw = resampling.normalize(logw + ssm.lookahead(state, t, obs_at(t), params))
            if fuse_chain:
                store, ancestors = store_lib.clone_chain(scfg, store, gen, lw)
            else:
                ancestors = self._resample(gen, lw)
                if csmc is not None and csmc[1]:
                    # Conditional SMC: particle 0 keeps the reference lineage.
                    ancestors = ancestors.clone()
                    ancestors[0] = 0
                store = store_lib.clone(scfg, store, ancestors)
            state = clone_state(state, ancestors)
            new_logw = uniform_logw
            if ssm.lookahead is not None:
                anc = ancestors.long()
                new_logw = resampling.normalize(logw[anc] - lw[anc])
            return state, store, new_logw, True

        def propagate(gen, state, t):
            state, dlogw, record = ssm.step(gen, state, t, obs_at(t), params)
            if simulate:
                dlogw = torch.zeros_like(dlogw)
            return state, dlogw, record

        def alive_loop(gen, state, t, logw, dlogw, record, prev_state):
            """Bounded rejection loop: dead particles redraw an ancestor
            among the living and re-propagate, up to ``max_retries``."""
            if ssm.alive is None or cfg.max_retries == 0 or simulate:
                return state, dlogw, record
            rows = torch.arange(n, dtype=torch.int32, device=dev)
            i = 0
            while i < cfg.max_retries and bool(ssm.alive(dlogw).any()):
                dead = ssm.alive(dlogw)
                alive_w = torch.where(dead, -math.inf, logw)
                anc = resampling.resample_multinomial(gen, alive_w)
                anc = torch.where(dead, anc, rows)
                re_state = clone_state(prev_state, anc)
                new_state, new_dlogw, new_record = propagate(gen, re_state, t)

                def pick(a, b):
                    return torch.where(dead.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

                state = tree_map(pick, new_state, state)
                dlogw = torch.where(dead, new_dlogw, dlogw)
                record = pick(new_record, record)
                i += 1
            return state, dlogw, record

        def step(carry, t):
            gen, state, store, logw, logz = carry
            state, store, logw, did = maybe_resample(gen, t, state, store, logw)
            prev_state = state
            state, dlogw, record = propagate(gen, state, t)
            state, dlogw, record = alive_loop(
                gen, state, t, logw, dlogw, record, prev_state
            )
            if csmc is not None and csmc[1]:
                # Pin particle 0 to the reference record.
                ref_t = csmc[0][t]
                record = record.clone()
                record[0] = ref_t
                state = ssm.set_reference(state, ref_t)
            lw = logw + dlogw
            logz = logz + torch.logsumexp(lw, 0)
            logw = resampling.normalize(lw)
            store = store_lib.append(scfg, store, record)
            out = (resampling.ess(logw), did, store_lib.used_blocks(scfg, store))
            return (gen, state, store, logw, logz), out

        return step


def _as_tensors(tree: Any, dev: torch.device) -> Any:
    """Observations as tensors on ``dev`` (numpy leaves are accepted;
    tuples, NamedTuples, lists and dicts keep their type)."""
    return tree_map(lambda x: torch.as_tensor(x, device=dev), tree)


def _float32(o: torch.Tensor) -> torch.Tensor:
    """Float64 observations become float32, the reference's default."""
    return o.float() if o.dtype == torch.float64 else o
