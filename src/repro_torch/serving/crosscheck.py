"""The smoke engine on the card against the same engine on the CPU.

One small program: the smoke config (float32), two prompts of 21 tokens
prefilled, forked to eight rows, twelve decode steps with a re-fork at
step 6 and ``compact_cache`` before step 10.  It runs on the card (the
kernels) and on the CPU (their plain versions) from the same weights and
tokens.  :func:`card_against_cpu` holds the runs to each other and
returns what it measured; the ``cuda``-marked test and ``chip_smoke.py``
both call it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs.starcoder2_3b import SMOKE
from repro_torch.models.model import LanguageModel
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.engine import ServeEngine

# |card - CPU| per logit, in units of the step's largest |logit|.  The
# logits are float32 sums taken in another order on each side (cuBLAS
# against the host's BLAS, the kernel against the plain softmax), so the
# difference scales with the size of the terms, not with the logit.
LOGIT_TOL = 1e-5
PROMPTS, PROMPT_LEN, ROWS, STEPS, REFORK_AT, COMPACT_AT = 2, 21, 8, 12, 6, 10
SEED = 0  # the weights' generator; the tokens come from numpy's SEED + 9


def smoke_program(
    device: torch.device | str, delta_cow: bool
) -> Tuple[ServeEngine, List[torch.Tensor]]:
    """Run the program on ``device``; returns the engine and the logits of
    the prefill and of every decode step."""
    dev = torch.device(device)
    lm = LanguageModel(SMOKE)
    params = lm.init(torch.Generator().manual_seed(SEED), device="cpu")
    ccfg = kvc.KVCacheConfig(
        n_layers=SMOKE.n_layers, n_kv_heads=SMOKE.n_kv_heads, head_dim=SMOKE.hd,
        block_size=4, max_seqs=ROWS, max_blocks_per_seq=9, num_blocks=80,
        dtype=SMOKE.dtype, delta_cow=delta_cow,
    )
    eng = ServeEngine(lm, params, ccfg, device=dev)
    rng = np.random.default_rng(SEED + 9)
    prompts = rng.integers(0, SMOKE.vocab_size, (PROMPTS, PROMPT_LEN))
    feed = rng.integers(0, SMOKE.vocab_size, (STEPS, ROWS, 1))
    refork = rng.integers(0, ROWS, ROWS)
    seq_ids = torch.arange(PROMPTS, dtype=torch.int32, device=dev)
    logits = [eng.prefill(torch.as_tensor(prompts, device=dev), seq_ids)]
    eng.fork(torch.as_tensor(np.repeat(np.arange(PROMPTS), ROWS // PROMPTS), device=dev))
    for step in range(STEPS):
        if step == REFORK_AT:
            eng.fork(torch.as_tensor(refork, device=dev))
        if step == COMPACT_AT:
            eng.compact_cache()
        logits.append(eng.decode(torch.as_tensor(feed[step], device=dev)))
    if eng.oom:
        raise RuntimeError(f"smoke program on {dev}: the KV pool ran out of pages")
    return eng, logits


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"card against CPU: {what}")


def card_against_cpu(
    device: torch.device | str = "cuda",
) -> Tuple[Dict[str, float], Dict[bool, ServeEngine]]:
    """The program on the CPU, and on ``device`` with whole-page and with
    delta COW.  Raises unless tables, refcounts and lengths are equal, every
    logit is within ``LOGIT_TOL`` times its step's largest |logit| of the
    CPU's, and delta on and off are bit-identical on the card.  Returns the
    readings and the card's engines by ``delta_cow``."""
    cpu, cpu_logits = smoke_program("cpu", False)
    card, card_logits = {}, {}
    for delta_cow in (False, True):
        card[delta_cow], card_logits[delta_cow] = smoke_program(device, delta_cow)
    for leaf in ("tables", "lengths"):
        _require(torch.equal(getattr(cpu.cache, leaf), getattr(card[False].cache, leaf).cpu()),
                 f"{leaf} differ")
    _require(torch.equal(cpu.cache.pool.refcount, card[False].cache.pool.refcount.cpu()),
             "refcounts differ")
    readings = {"largest_logit": 0.0, "worst_abs_diff": 0.0, "logit_at_worst": 0.0,
                "worst_diff_over_step_max": 0.0, "logits_off_by_more_than_1e-5": 0,
                "logits": 0}
    for a, b, c in zip(cpu_logits, card_logits[False], card_logits[True], strict=True):
        _require(torch.equal(b, c), "delta COW on and off differ on the card")
        b = b.cpu()
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
