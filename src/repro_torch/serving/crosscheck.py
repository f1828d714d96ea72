"""The smoke engine on the card against the same engine on the CPU.

One small program: a smoke config (float32; starcoder2-3b's by default,
also deepseek-moe-16b's and musicgen-large's), two prompts of 21 tokens
prefilled, forked to eight rows, twelve decode steps with a re-fork at
step 6 and ``compact_cache`` before step 10.  It runs on the card (the
kernels) and on the CPU (their plain versions) from the same weights and
tokens.  :func:`card_against_cpu` holds the runs to each other and
returns what it measured; the ``cuda``-marked test and ``chip_smoke.py``
both call it.

For a MoE model the routing is held too: each layer's expert ids, and
where no row of the call is near a tie its capacity positions and keep
mask, equal on the card and the CPU wherever the gap between the k-th
and (k+1)-th gate exceeds ``ROUTE_GAP``.  A row past a near tie (and its
forked copies) may take other experts on the two sides, so its logits
are left out of the logit check and counted.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.starcoder2_3b import SMOKE
from repro_torch.models import moe as moe_lib
from repro_torch.models.model import LanguageModel
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.engine import ServeEngine

# |card - CPU| per logit, in units of the step's largest |logit|.  The
# logits are float32 sums taken in another order on each side (cuBLAS
# against the host's BLAS, the kernel against the plain softmax), so the
# difference scales with the size of the terms, not with the logit.
LOGIT_TOL = 1e-5
# A routing row whose k-th and (k+1)-th gates lie closer than this may
# pick another expert on the other side.
ROUTE_GAP = 1e-4
PROMPTS, PROMPT_LEN, ROWS, STEPS, REFORK_AT, COMPACT_AT = 2, 21, 8, 12, 6, 10
SEED = 0  # the weights' generator; the tokens come from numpy's SEED + 9


@contextlib.contextmanager
def _recording_routes(steps: Optional[List[list]]):
    """While open, every ``moe.route`` call appends its routing (on the
    host) to ``steps[-1]``."""
    if steps is None:
        yield
        return
    route = moe_lib.route

    def recording(router, tokens, cfg):
        r = route(router, tokens, cfg)
        steps[-1].append(moe_lib.Routing(*(x.cpu() if torch.is_tensor(x) else x for x in r)))
        return r

    moe_lib.route = recording
    try:
        yield
    finally:
        moe_lib.route = route


def smoke_program(
    device: torch.device | str,
    delta_cow: bool,
    arch: str = "starcoder2_3b",
    routes: Optional[List[list]] = None,
) -> Tuple[ServeEngine, List[torch.Tensor]]:
    """Run the program on ``device`` with ``arch``'s smoke config; returns
    the engine and the logits of the prefill and of every decode step.
    With ``routes`` (a list), each step (the prefill, then each decode
    step) appends the list of its MoE layers' routings."""
    dev = torch.device(device)
    cfg = smoke_config(arch)
    lm = LanguageModel(cfg)
    params = lm.init(torch.Generator().manual_seed(SEED), device="cpu")
    ccfg = kvc.KVCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        block_size=4, max_seqs=ROWS, max_blocks_per_seq=9, num_blocks=80,
        dtype=cfg.dtype, delta_cow=delta_cow,
    )
    eng = ServeEngine(lm, params, ccfg, device=dev)
    prompts, feed, first, refork = program_tokens(cfg.vocab_size)
    seq_ids = torch.arange(PROMPTS, dtype=torch.int32, device=dev)
    with _recording_routes(routes):
        if routes is not None:
            routes.append([])
        logits = [eng.prefill(torch.as_tensor(prompts, device=dev), seq_ids)]
        eng.fork(torch.as_tensor(first, device=dev))
        for step in range(STEPS):
            if step == REFORK_AT:
                eng.fork(torch.as_tensor(refork, device=dev))
            if step == COMPACT_AT:
                eng.compact_cache()
            if routes is not None:
                routes.append([])
            logits.append(eng.decode(torch.as_tensor(feed[step], device=dev)))
    if eng.oom:
        raise RuntimeError(f"smoke program on {dev}: the KV pool ran out of pages")
    return eng, logits


def program_tokens(vocab: int):
    """The program's prompts [PROMPTS, PROMPT_LEN], fed tokens
    [STEPS, ROWS, 1], first fork and re-fork ancestors."""
    rng = np.random.default_rng(SEED + 9)
    prompts = rng.integers(0, vocab, (PROMPTS, PROMPT_LEN))
    feed = rng.integers(0, vocab, (STEPS, ROWS, 1))
    refork = rng.integers(0, ROWS, ROWS)
    return prompts, feed, np.repeat(np.arange(PROMPTS), ROWS // PROMPTS), refork


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"card against CPU: {what}")


def _route_rows(cpu: List[moe_lib.Routing], card: List[moe_lib.Routing], k: int) -> np.ndarray:
    """Hold one step's routings on the card to the CPU's; returns which
    routing rows lay within ``ROUTE_GAP`` of a tie in any layer."""
    _require(len(cpu) == len(card), f"{len(card)} routing calls on the card, {len(cpu)} on the CPU")
    near = np.zeros(cpu[0].gates.shape[0], bool) if cpu else np.zeros(0, bool)
    for a, b in zip(cpu, card, strict=True):
        top = torch.topk(a.gates, k + 1, dim=-1).values
        tie = ((top[:, k - 1] - top[:, k]) <= ROUTE_GAP).numpy()
        clear = torch.as_tensor(~tie)
        _require(torch.equal(a.top_e[clear], b.top_e[clear]), "expert ids differ on a row clear of ties")
        if not tie.any():
            _require(torch.equal(a.pos, b.pos) and torch.equal(a.keep, b.keep),
                     "capacity positions or the keep mask differ")
        near |= tie
    return near


def card_against_cpu(
    device: torch.device | str = "cuda", arch: str = "starcoder2_3b",
) -> Tuple[Dict[str, float], Dict[bool, ServeEngine]]:
    """The program on the CPU, and on ``device`` with whole-page and with
    delta COW.  Raises unless tables, refcounts and lengths are equal, every
    logit is within ``LOGIT_TOL`` times its step's largest |logit| of the
    CPU's, delta on and off are bit-identical on the card, and (MoE) the
    routing agrees where it is clear of ties.  Returns the readings and the
    card's engines by ``delta_cow``."""
    cfg = smoke_config(arch)
    moe = cfg.family == "moe"
    cpu_routes: Optional[List[list]] = [] if moe else None
    card_routes: Optional[List[list]] = [] if moe else None
    cpu, cpu_logits = smoke_program("cpu", False, arch, cpu_routes)
    card, card_logits = {}, {}
    for delta_cow in (False, True):
        card[delta_cow], card_logits[delta_cow] = smoke_program(
            device, delta_cow, arch, card_routes if not delta_cow else None)
    for leaf in ("tables", "lengths"):
        _require(torch.equal(getattr(cpu.cache, leaf), getattr(card[False].cache, leaf).cpu()),
                 f"{leaf} differ")
    _require(torch.equal(cpu.cache.pool.refcount, card[False].cache.pool.refcount.cpu()),
             "refcounts differ")
    readings = {"largest_logit": 0.0, "worst_abs_diff": 0.0, "logit_at_worst": 0.0,
                "worst_diff_over_step_max": 0.0, "logits_off_by_more_than_1e-5": 0,
                "logits": 0}
    if moe:
        readings.update(routing_rows=0, near_tie_rows=0, rows_left_out=0)
    _, _, first, refork = program_tokens(cfg.vocab_size)
    tainted = np.zeros(PROMPTS, bool)
    for step, (a, b, c) in enumerate(zip(cpu_logits, card_logits[False], card_logits[True], strict=True)):
        _require(torch.equal(b, c), "delta COW on and off differ on the card")
        if step == 1:
            tainted = tainted[first]
        if step == REFORK_AT + 1:
            tainted = tainted[refork]
        if moe:
            near = _route_rows(cpu_routes[step], card_routes[step], cfg.top_k)
            readings["routing_rows"] += near.size * len(cpu_routes[step])
            readings["near_tie_rows"] += int(near.sum())
            # The prefill routes every prompt token: a tie taints its prompt.
            tainted |= near.reshape(tainted.size, -1).any(axis=1)
            readings["rows_left_out"] += int(tainted.sum())
        keep = torch.as_tensor(~tainted)
        a, b = a[keep], b.cpu()[keep]
        if not a.numel():
            continue
        diff = (b - a).abs()
        scale = a.abs().max().item()
        worst = diff.max().item()
        _require(worst <= LOGIT_TOL * scale,
                 f"|card - CPU| {worst} above {LOGIT_TOL} x the step's largest logit {scale}")
        readings["largest_logit"] = max(readings["largest_logit"], scale)
        readings["logits_off_by_more_than_1e-5"] += int((diff > 1e-5).sum())
        readings["logits"] += diff.numel()
        readings["worst_diff_over_step_max"] = max(readings["worst_diff_over_step_max"], worst / scale)
        if worst > readings["worst_abs_diff"]:
            readings["worst_abs_diff"] = worst
            readings["logit_at_worst"] = a.flatten()[diff.argmax()].item()
    return readings, card
