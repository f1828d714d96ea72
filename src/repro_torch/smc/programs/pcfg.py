"""PCFG: probabilistic context-free grammar with an auxiliary particle
filter and a custom (lookahead) proposal, in PyTorch.

The port of ``repro.smc.programs.pcfg`` (whose docstring gives the
model).  Each particle carries a *stack* of grammar symbols held in its
own lazy-copy :class:`~repro_torch.core.store.ParticleStore`, mutated by
masked COW ``write_at`` mid-stack (push) and pointer moves (pop), and
cloned with the population at every resampling step.  The model keeps
only the latest state (the stacks), the paper's constant-factor regime.

Grammar (Chomsky normal form): K nonterminals, V terminals.
  NT_k -> NT_i NT_j   with prob (1 - emit_p[k]) * left[k, i] * right[k, j]
  NT_k -> term v      with prob emit_p[k] * emit[k, v]

Differences from the reference:

* :func:`default_params` are the reference's values written out (the
  reference draws them from a Dirichlet under ``PRNGKey(42)``), so both
  packages run the same grammar.
* A categorical draw is ``argmax(logits + gumbel)`` on
  :func:`repro_torch.random.gumbel`, the noise the reference's
  ``jax.random.categorical`` adds.  The emitted token's draw, which the
  reference discards, is not made.
* The stack store lives on the device of the generator ``init`` is
  given; ``params`` must be on that device.

record = [emitted, depth]  (2,)
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch.core import store as store_lib
from repro_torch.core.config import CopyMode
from repro_torch.core.store import ParticleStore, StoreConfig
from repro_torch.kernels.dispatch import resolve_device
from repro_torch.smc.filters import SSMDef

NAME = "pcfg"
METHOD = "apf"
PAPER_N = 16384
PAPER_T = 3262
PAPER_T_SIM = 2000

K = 4  # nonterminals
V = 8  # terminals
MAX_DEPTH = 64
MAX_EXPAND = 6  # nonterminal expansions attempted per emitted token
START = 0

# The reference's default_params(): Dirichlet(1) rows drawn under
# jax.random.PRNGKey(42), as float32.
_EMIT_P = (0.6, 0.6, 0.6, 0.6)
_EMIT = (
    (0.12744535505771637, 0.003980096895247698, 0.19966261088848114, 0.20071347057819366,
     0.08944697678089142, 0.00510590523481369, 0.07660388946533203, 0.2970416843891144),
    (0.15045101940631866, 0.10347343981266022, 0.3451841175556183, 0.017618993297219276,
     0.06593924760818481, 0.15810467302799225, 0.08654198050498962, 0.072686567902565),
    (0.06946633756160736, 0.21192666888237, 0.06386446952819824, 0.19353574514389038,
     0.17945629358291626, 0.06937431544065475, 0.13899767398834229, 0.07337839901447296),
    (0.028777161613106728, 0.4402208924293518, 0.11636912077665329, 0.06288853287696838,
     0.07069192081689835, 0.060420259833335876, 0.05175239220261574, 0.16887980699539185),
)
_LEFT = (
    (0.6760982275009155, 0.01907850056886673, 0.1997384876012802, 0.10508476942777634),
    (0.7027516961097717, 0.12318199127912521, 0.1737552434206009, 0.00031103924266062677),
    (0.06432244926691055, 0.4978879988193512, 0.4014309048652649, 0.03635869920253754),
    (0.33858776092529297, 0.08498515188694, 0.4863473176956177, 0.09007971733808517),
)
_RIGHT = (
    (0.0832584872841835, 0.4235948920249939, 0.11006771773099899, 0.3830789029598236),
    (0.013161213137209415, 0.08321109414100647, 0.5958713889122009, 0.3077562749385834),
    (0.059385597705841064, 0.046497542411088943, 0.14665119349956512, 0.7474656105041504),
    (0.23809383809566498, 0.1478843241930008, 0.5467226505279541, 0.06729916483163834),
)


class PCFGParams(NamedTuple):
    emit_p: torch.Tensor  # [K] prob of emitting vs branching
    emit: torch.Tensor  # [K, V] terminal distribution
    left: torch.Tensor  # [K, K] left-child distribution
    right: torch.Tensor  # [K, K] right-child distribution


class PCFGState(NamedTuple):
    stack: ParticleStore  # stack cells live in a COW pool
    sp: torch.Tensor  # [N] int32 stack pointer (depth)


def default_params(device: torch.device | str = "cuda") -> PCFGParams:
    """The reference's grammar, as float32 tensors on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    return PCFGParams(
        *(torch.tensor(v, dtype=torch.float32, device=dev) for v in (_EMIT_P, _EMIT, _LEFT, _RIGHT))
    )


def _stack_cfg(n: int, mode: CopyMode) -> StoreConfig:
    return StoreConfig(
        mode=mode,
        n=n,
        block_size=8,  # 8 stack cells per COW block
        max_blocks=MAX_DEPTH // 8,
        item_shape=(),
        dtype="float32",
        num_blocks=0,
    )


def _categorical(gen: Any, logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits + rnd.gumbel(gen, logits.shape), dim=-1)


def _top(scfg: StoreConfig, stack: ParticleStore, sp: torch.Tensor) -> torch.Tensor:
    """The symbol on top of each stack (int64, clipped to a nonterminal)."""
    top = store_lib.read_at(scfg, stack, torch.clamp(sp - 1, min=0))
    return torch.clamp(top.to(torch.int32), 0, K - 1).long()


def build(mode: CopyMode = CopyMode.LAZY_SR) -> Tuple[SSMDef, PCFGParams]:
    def init(gen, n, params):
        scfg = _stack_cfg(n, mode)
        stack = store_lib.create(scfg, gen.device)
        # push START on every stack
        zeros = torch.zeros((n,), dtype=torch.int32, device=gen.device)
        stack = store_lib.write_at(scfg, stack, zeros, torch.full((n,), float(START), device=gen.device))
        return PCFGState(stack=stack, sp=torch.ones((n,), dtype=torch.int32, device=gen.device))

    def step(gen, state, t, y_t, params):
        stack, sp = state.stack, state.sp
        n = sp.shape[0]
        scfg = _stack_cfg(n, mode)
        dev = sp.device
        y = y_t.long()
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        logw = torch.zeros((n,), device=dev)
        emitted = torch.full((n,), -1.0, device=dev)
        for _ in range(MAX_EXPAND):
            top_pos = torch.clamp(sp - 1, min=0)
            top = _top(scfg, stack, sp)
            empty = sp <= 0
            active = ~done & ~empty
            # decide emit vs branch for active particles
            u = rnd.uniform(gen, (n,))
            do_emit = active & (u < params.emit_p[top])
            do_branch = active & ~do_emit & (sp < MAX_DEPTH - 1)
            # --- emission: pop, weight by the observed token's prob -------
            logw = logw + torch.where(do_emit, torch.log(params.emit[top, y] + 1e-30), 0.0)
            emitted = torch.where(do_emit, y_t.float(), emitted)
            # --- branch: pop NT, push right then left --------------------
            lsym = _categorical(gen, torch.log(params.left[top] + 1e-30))
            rsym = _categorical(gen, torch.log(params.right[top] + 1e-30))
            # pop (sp-1), write right child at sp-1, left child at sp
            stack = store_lib.write_at(scfg, stack, top_pos, rsym.float(), mask=do_branch)
            stack = store_lib.write_at(
                scfg, stack, torch.clamp(sp, max=MAX_DEPTH - 1), lsym.float(), mask=do_branch
            )
            sp = torch.where(do_emit, sp - 1, torch.where(do_branch, sp + 1, sp))
            done = done | do_emit | empty
        # particles that failed to emit within the budget die
        logw = torch.where(done & (emitted >= 0), logw, -torch.inf)
        # exhausted stacks also die (string not yet finished)
        logw = torch.where(sp <= 0, -torch.inf, logw)
        record = torch.stack([emitted, sp.float()], dim=1)
        return PCFGState(stack, sp), logw, record

    def clone_state(state, ancestors):
        scfg = _stack_cfg(state.sp.shape[0], mode)
        return PCFGState(
            stack=store_lib.clone(scfg, state.stack, ancestors),
            sp=state.sp[ancestors.long()],
        )

    def lookahead(state, t, y_t, params):
        top = _top(_stack_cfg(state.sp.shape[0], mode), state.stack, state.sp)
        mu = params.emit_p[top] * params.emit[top, y_t.long()]
        return torch.log(mu + 1e-6)

    return SSMDef(
        init=init,
        step=step,
        record_shape=(2,),
        clone_state=clone_state,
        lookahead=lookahead,
    ), default_params("cpu")


def rollout(seed: int, t_steps: int) -> np.ndarray:
    """A terminal string ``[T]`` (float32) sampled from the grammar on the
    host by numpy's generator seeded with ``seed``; the reference's
    ``gen_data`` is this rollout at the seed it draws from its key."""
    emit_p, emit, left, right = (x.numpy() for x in default_params("cpu"))
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < t_steps:
        stack = [START]
        while stack and len(out) < t_steps:
            top = stack.pop()
            if rng.random() < emit_p[top] or len(stack) > MAX_DEPTH - 2:
                out.append(rng.choice(V, p=emit[top]))
            else:
                lsym = rng.choice(K, p=left[top])
                rsym = rng.choice(K, p=right[top])
                stack.extend([rsym, lsym])
    return np.asarray(out[:t_steps], np.float32)


def gen_data(gen: Any, t_steps: int) -> torch.Tensor:
    """Observed terminals ``[T]`` on ``gen``'s device: :func:`rollout` at
    a seed drawn from ``gen``."""
    seed = int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))
    return torch.as_tensor(rollout(seed, t_steps), device=gen.device)
