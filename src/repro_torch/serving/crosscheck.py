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

:func:`dense_cache_card_against_cpu` does the same for the model's dense
decode caches (``LanguageModel.prefill`` and ``decode_step``), for any
family: two prompts of ``DENSE_PROMPT_LEN`` tokens prefilled, then
``DENSE_STEPS`` decode steps on fed tokens, on the card (prefill through
``flash_attention`` and ``ssd_scan``) and on the CPU.
:func:`dense_cache_rejects_planted_faults` shows where the SSM families'
limit sits: each of ``SCAN_FAULTS``, planted into the scan, reads above it.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.configs.starcoder2_3b import SMOKE
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import torch_dtype
from repro_torch.models.model import DecodeCache, LanguageModel
from repro_torch.serving import kv_cache as kvc
from repro_torch.serving.engine import ServeEngine, cast_matrices

# |card - CPU| per logit, in units of the step's largest |logit|.  The
# logits are float32 sums taken in another order on each side (cuBLAS
# against the host's BLAS, the kernel against the plain softmax), so the
# difference scales with the size of the terms, not with the logit.
LOGIT_TOL = 1e-5
# A routing row whose k-th and (k+1)-th gates lie closer than this may
# pick another expert on the other side.
ROUTE_GAP = 1e-4
PROMPTS, PROMPT_LEN, ROWS, STEPS, REFORK_AT, COMPACT_AT = 2, 21, 8, 12, 6, 10
# The dense-cache program: its prompt length is one the card's SSD scan
# takes (its chunk min(64, S) a multiple of 16).
DENSE_PROMPT_LEN, DENSE_STEPS = 32, 16
# The SSM families' limit, in units of the step's largest |logit| (and of
# each cache leaf's largest |value|).  ssd_scan on the card is held to its
# plain version at rtol/atol 2e-4 (TF32 products, csrc/ssd_scan.cu); the
# smoke runs read 1.05e-6 (mamba2) and 3.0e-6 (zamba2) on an H100, their
# caches at most 1.7e-6, so one flat limit of 2e-5 sits 6.7x above the
# larger reading and below the kernel's own.  Each planted fault of
# SCAN_FAULTS reads above it (dense_cache_rejects_planted_faults).  The
# attention-only families keep LOGIT_TOL.
SSD_TOL = 2e-5
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


def dense_program(device: torch.device | str, arch: str) -> Tuple[List[torch.Tensor], DecodeCache]:
    """The dense-cache program on ``device`` with ``arch``'s smoke config
    (float32, weights from ``SEED`` on the CPU): ``prefill`` of two
    prompts, then ``DENSE_STEPS`` decode steps on fed tokens, all from
    numpy's ``SEED + 10`` (and, vlm, image features).  Returns the
    prefill's last-position logits and each step's, and the final cache."""
    dev = torch.device(device)
    cfg = smoke_config(arch)
    lm = LanguageModel(cfg)
    params = cast_matrices(lm.init(torch.Generator().manual_seed(SEED), device="cpu"),
                           torch_dtype(cfg.dtype), dev)
    rng = np.random.default_rng(SEED + 10)
    tokens = rng.integers(0, cfg.vocab_size, (PROMPTS, DENSE_PROMPT_LEN + DENSE_STEPS))
    img = None
    if cfg.family == "vlm":
        img = torch.as_tensor(rng.standard_normal((PROMPTS, cfg.n_img_tokens, cfg.d_model)),
                              dtype=torch.float32, device=dev)
    tokens = torch.as_tensor(tokens, device=dev)
    logits, cache = lm.prefill(params, tokens[:, :DENSE_PROMPT_LEN], DENSE_PROMPT_LEN + DENSE_STEPS, img)
    out = [logits[:, -1]]
    for step in range(DENSE_STEPS):
        at = DENSE_PROMPT_LEN + step
        logits, cache = lm.decode_step(params, tokens[:, at : at + 1], cache)
        out.append(logits)
    return out, cache


def dense_tolerance(arch: str) -> float:
    """The limit of :func:`dense_cache_card_against_cpu` for ``arch``:
    ``SSD_TOL`` for the ssm and hybrid families, else ``LOGIT_TOL``."""
    return SSD_TOL if smoke_config(arch).uses_ssm else LOGIT_TOL


def dense_readings(
    cpu_run: Tuple[List[torch.Tensor], DecodeCache], run: Tuple[List[torch.Tensor], DecodeCache]
) -> Dict:
    """How far ``run`` (on any device) lies from ``cpu_run``: the worst
    |difference| of a step's logits over the step's largest |logit|, each
    float cache leaf's over its largest |value|, and whether the logits and
    caches are finite and the positions and image features equal."""
    readings = {"worst_diff_over_step_max": 0.0, "worst_abs_diff": 0.0, "largest_logit": 0.0,
                "logits": 0, "worst_cache_diff_over_max": {}, "finite": True, "exact_leaves_equal": True}
    for a, b in zip(cpu_run[0], run[0], strict=True):
        b = b.cpu()
        readings["finite"] &= bool(torch.isfinite(b).all())
        diff = (b - a).abs().max().item()
        scale = a.abs().max().item()
        readings["worst_diff_over_step_max"] = max(readings["worst_diff_over_step_max"], diff / scale)
        readings["worst_abs_diff"] = max(readings["worst_abs_diff"], diff)
        readings["largest_logit"] = max(readings["largest_logit"], scale)
        readings["logits"] += a.numel()
    for field in DecodeCache._fields:
        a, b = getattr(cpu_run[1], field), getattr(run[1], field).cpu()
        _require(a.shape == b.shape and a.dtype == b.dtype, f"cache {field}: shape or dtype differ")
        if not a.numel():
            continue
        if field in ("position", "img_feats"):
            readings["exact_leaves_equal"] &= torch.equal(a, b)
            continue
        readings["finite"] &= bool(torch.isfinite(b).all())
        scale = a.abs().max().item()
        readings["worst_cache_diff_over_max"][field] = (b - a).abs().max().item() / scale if scale else 0.0
    return readings


def dense_cache_card_against_cpu(device: torch.device | str = "cuda", arch: str = "gemma3_12b") -> Dict:
    """The dense-cache program on the CPU and on ``device``.  Raises unless
    every logit is within :func:`dense_tolerance` times its step's largest
    |logit| of the CPU's, every float cache leaf within the same times its
    largest |value|, the image features equal and the positions equal.
    Returns the readings."""
    tol = dense_tolerance(arch)
    card = dense_program(device, arch)
    readings = {"limit": tol, **dense_readings(dense_program("cpu", arch), card)}
    _require(bool((card[1].position.cpu() == DENSE_PROMPT_LEN + DENSE_STEPS).all()), "the position after the program")
    _require(readings["finite"], "finite logits and caches on the card")
    _require(readings["exact_leaves_equal"], "positions and image features equal")
    _require(readings["worst_diff_over_step_max"] <= tol,
             f"|card - CPU| {readings['worst_diff_over_step_max']} of the step's largest logit, above {tol}")
    for field, ratio in readings["worst_cache_diff_over_max"].items():
        _require(ratio <= tol, f"cache {field}: |card - CPU| {ratio} of its largest |value|, above {tol}")
    return readings


def _late_outputs_off(scan):
    def faulty(x, dt, a, bmat, cmat, chunk):
        y, h = scan(x, dt, a, bmat, cmat, chunk=chunk)
        return torch.cat([y[:, : y.shape[1] // 2], y[:, y.shape[1] // 2 :] * (1 + 1e-4)], dim=1), h

    return faulty


# Faults a scan could make, planted into every ssm_layer's scan of the
# run under test: B and C rounded to bf16 on the way in, and the outputs
# of the second half of the positions 1e-4 (relative) off, as a decay
# wrong across a chunk boundary would leave them.
SCAN_FAULTS = {
    "bc_rounded_to_bf16": lambda scan: lambda x, dt, a, bmat, cmat, chunk: scan(
        x, dt, a, bmat.bfloat16().float(), cmat.bfloat16().float(), chunk=chunk),
    "late_outputs_off_1e-4": _late_outputs_off,
}


@contextlib.contextmanager
def _planted(fault: str):
    scan = ssm_lib.ssd_scan
    ssm_lib.ssd_scan = SCAN_FAULTS[fault](scan)
    try:
        yield
    finally:
        ssm_lib.ssd_scan = scan


def dense_cache_rejects_planted_faults(device: torch.device | str = "cuda", arch: str = "mamba2_130m") -> Dict[str, float]:
    """The dense-cache program on ``device`` with each of ``SCAN_FAULTS``
    planted, against the CPU's clean run.  Raises unless each reads above
    :func:`dense_tolerance` (in units of the step's largest |logit|);
    returns the readings."""
    tol = dense_tolerance(arch)
    clean = dense_program("cpu", arch)
    readings = {}
    for fault in SCAN_FAULTS:
        with _planted(fault):
            run = dense_program(device, arch)
        readings[fault] = dense_readings(clean, run)["worst_diff_over_step_max"]
        _require(readings[fault] > tol, f"planted fault {fault} reads {readings[fault]}, not above {tol}")
    return readings
