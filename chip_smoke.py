#!/usr/bin/env python3
"""Drive the PyTorch port of the lazy-copy platform on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises, and the script exits non-zero):

1. Build the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one
   process per source, in parallel).
2. The particle filter's path, with every kernel's launch counter set to
   0 just before and read just after: the LGSSM particle filter of
   ``examples/quickstart.py`` (A=0.9, Q=0.5, R=0.3, record ``(1,)``,
   block_size 4, auto pool, N = 65,536, T = 1,024) in EAGER, LAZY and
   LAZY_SR with the systematic resampler from one generator seed —
   ``log_evidence`` must be bit-identical across modes, ``oom`` False,
   and the lazy peak below the dense block count; LAZY_SR's
   ``materialize_batch`` of all N must equal EAGER's dense trajectories
   before and after ``compact``; then one LAZY run with the stratified
   resampler (``refcount_update`` through ``store.clone``).  Each of the
   four COW kernels must have launched.
3. Each COW kernel against its plain PyTorch version on the card, at the
   filter's shapes and on its state: exact equality (NULL entries, masked
   rows and duplicate ids included); then each one's time, its plain
   version's time, the time of one PyTorch call computing the same
   function where there is one, and the least time the card could take
   (bytes moved over the memory rate).  Times are device time per call
   between CUDA events, the calls queued behind a spin kernel.
4. A small filter run on the card against the same run on the CPU path,
   fed the same draws: equal tables, log-evidence to rtol 1e-5.
5. One more LAZY_SR run under ``torch.profiler`` (CUDA activity only),
   run last, after phases 6-9.  A profile's device numbers are null unless
   its trace holds a record of every launch of a kernel whose wrapper
   counts them (``cow_write`` here, ``paged_attention`` in phase 6).
6. The serving path, with the counters set to 0 just before and read
   just after: ``ServeEngine`` on starcoder2-3b at its published widths
   (30 layers, d_model 3072, 24 heads over 2 KV heads, d_ff 12288, vocab
   49152; bf16 activations, f32 params; random weights from seed 0).
   Prefill 4 prompts of 500 tokens into a 16-slot engine (pages of 16
   tokens, ``num_blocks = pool_blocks_cap``), fork to 16 rows, decode 128
   sampled tokens with a re-fork at token 64, ``compact_cache`` and one
   more token — once with whole-page COW and once with delta COW.
   Checks: ``oom`` False; the copies' first logits bit-equal to their
   siblings'; live pages below the dense count; the step after
   ``compact_cache`` equal to the same step on an uncompacted copy; the
   two runs bit-identical in every logit and token; ``paged_attention``,
   ``paged_attention_delta`` and ``cow_gather`` launched.  Then eight
   decode steps under ``torch.profiler``.
7. Both paged-attention kernels against their plain version on the final
   caches (layers 0 and 29, bf16, atol 1e-2), with their times, the
   plain version's, and the bound (the live K/V slots, tables, q and out
   over the memory rate); ``pool_compact`` on the 491,520-byte pages.
8. The smoke config (3 layers, d_model 96, f32) on the card against the
   CPU path, through ``repro_torch.serving.crosscheck``: equal tables,
   refcounts and lengths, logits within 1e-5 of the step's largest logit,
   delta on/off bit-identical; both kernels within atol 1e-5 of the plain
   version on its f32 pools.
9. The serve entry point as a user runs it, ``python -m
   repro_torch.launch.serve --full`` (starcoder2-3b at full width, 4
   requests x 32 greedy tokens), with the counters set to 0 just before:
   ``paged_attention`` launched, 4 continuations of 33 tokens returned.

Output: a line per run, the ``{"profile": ...}``, ``{"serve_profile": ...}``
and ``{"kernels": [...]}`` JSON lines, the card's name and power limit
from ``nvidia-smi``, and last ``{"ok": true, "device": {...}}``.  Without
a CUDA device, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
A, Q, R = 0.9, 0.5, 0.3
SEED = 0
N_PARTICLES = 65_536
N_STEPS = 1_024

# Memory rate of each part (NVIDIA data sheets), bytes/s; the name from
# torch.cuda.get_device_name picks the row.
MEMORY_RATE = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12), ("H100", 3.35e12))
# The kernels the particle filter's path runs (the serving path's are
# checked in serve_phases).
FILTER_OPS = ("cow_write", "refcount_update", "cow_gather", "clone_chain")
# Dense float32 peak outside the tensor cores, and dense bf16 tensor-core
# peak, H100 SXM.
F32_RATE = 67e12
BF16_RATE = 989e12


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def lgssm(rnd, SSMDef):
    def init(gen, n, params):
        return rnd.normal(gen, (n,))

    def step(gen, x, t, y, params):
        x = A * x + math.sqrt(Q) * rnd.normal(gen, x.shape)
        logw = -0.5 * ((y - x) ** 2 / R + math.log(2 * math.pi * R))
        return x, logw, x[:, None]

    return SSMDef(init=init, step=step, record_shape=(1,))


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# Cycles of the spin kernel that holds the card while device_ms enqueues
# its calls (about 0.1 s at the H100's clock).
SPIN_CYCLES = 200_000_000


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call between CUDA events, with the calls queued
    behind a spin kernel so that the host's launch gaps do not show (a call
    that waits on the host still counts its wait).  Not torch.profiler:
    once a process has traced ~1e5 kernels, CUPTI loses some of the kernel
    records of later sessions, and in some processes delivers none."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_events(prof) -> dict:
    """Each CUDA kernel's name in a finished profile: (device µs, count)."""
    out = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us, count = out.get(ev.key, (0.0, 0))
            out[ev.key] = (us + ev.self_device_time_total, count + ev.count)
    return out


def profile_summary(prof, wall_ms: float, per: int, unit: str, kernel: str, launched: int) -> dict:
    """Device busy time, idle share, launches and the top kernels per
    ``unit``.  The trace is complete when it holds a record of each of the
    ``launched`` launches of ``kernel`` (from its wrapper's counter); the
    device numbers are None when it is not, as CUPTI may drop records."""
    events = kernel_events(prof)
    busy_ms = sum(us for us, _ in events.values()) / 1e3
    top = sorted(events.items(), key=lambda kv: -kv[1][0])[:8]
    recorded = sum(c for k, (_, c) in events.items() if kernel in k)
    complete = recorded == launched > 0
    return {
        "records_complete": complete,
        f"{kernel}_records": recorded, f"{kernel}_launches": launched,
        f"traced_wall_ms_per_{unit}": wall_ms / per,
        f"device_busy_ms_per_{unit}": busy_ms / per if complete else None,
        "device_idle_share": 1 - busy_ms / wall_ms if complete else None,
        f"device_launches_per_{unit}": sum(c for _, c in events.values()) / per if complete else None,
        f"top_kernels_ms_per_{unit}": {k[:72]: us / 1e3 / per for k, (us, _) in top} if complete else None,
    }


def memory_rate(name: str) -> float:
    for key, rate in MEMORY_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


# starcoder2-3b at its published widths (the repo's ModelConfig reading:
# 30 layers, d_model 3072, 24 heads over 2 KV heads, d_ff 12288, vocab
# 49152, bf16 activations, f32 params), random weights from seed 0.
SERVE_PROMPTS = 4
SERVE_PROMPT_LEN = 500  # not a multiple of the page: every tail page is part full
SERVE_SLOTS = 16
SERVE_BLOCK = 16
SERVE_MAX_LEN = 656
SERVE_TOKENS = 128
SERVE_REFORK_AT = 64
SERVE_PROFILE_TOKENS = 8


def gumbel_sample(logits, gen):
    """One token per row from softmax(logits), by Gumbel-max on the
    generator's uniforms: the same logits and generator state give the
    same tokens."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device).clamp_(min=1e-20)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def clone_cache(cache):
    pool = type(cache.pool)(*(t.clone() for t in cache.pool))
    return type(cache)(pool, cache.tables.clone(), cache.lengths.clone())


def paged_bytes(cache, delta: bool, n_heads: int) -> int:
    """Bytes paged attention must move on ``cache``: each distinct K/V slot
    the rows read (a shared page counted once), each row's table entries up
    to its length, lengths, q and out, and under delta the parent and
    dirty entries of the pages read."""
    bs, kvh, hd = cache.pool.data.shape[3:]
    lengths = cache.lengths.long()
    pos = torch.arange(cache.tables.shape[1] * bs, device=lengths.device)
    live = pos[None, :] < lengths[:, None]  # [B, nb * bs]
    page = cache.tables.long().repeat_interleave(bs, dim=1)
    slot = (pos % bs)[None, :].expand_as(page)
    src = page
    if delta:
        par = cache.pool.parent.long()[page.clamp(min=0)]
        clean = ~cache.pool.dirty[page.clamp(min=0), slot]
        src = torch.where(clean & (par >= 0), par, page)
    ok = live & (page >= 0)
    n_slots = int(torch.unique(src[ok] * bs + slot[ok]).numel())
    elem = cache.pool.data.element_size()
    b, h = cache.tables.shape[0], n_heads
    pages_read = int(((lengths + bs - 1) // bs).sum())
    meta = pages_read * 4 + b * 4
    if delta:
        meta += int(torch.unique(page[ok]).numel()) * (4 + bs)
    return n_slots * kvh * hd * 2 * elem + meta + 2 * b * h * hd * elem


def serve_phases(dev, rate):
    """Phases 6-9: the COW-paged serving engine on starcoder2-3b at full
    width (whole-page and delta COW, bit-identical), each paged-attention
    kernel against its plain version on the final cache, the smoke config
    on the card against the CPU path, and the serve entry point at full
    width.  Returns the kernels' rows."""
    from repro_torch.configs.starcoder2_3b import CONFIG, SMOKE
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.cow_gather import cow_gather_ref, pool_compact
    from repro_torch.kernels.paged_attention import paged_attention, paged_attention_ref
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import LanguageModel
    from repro_torch.serving import kv_cache as kvc
    from repro_torch.serving.crosscheck import LOGIT_TOL, card_against_cpu
    from repro_torch.serving.engine import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = CONFIG
    lm = LanguageModel(cfg)
    t = time.perf_counter()
    params = lm.init(torch.Generator(device=dev).manual_seed(SEED), device=dev)
    base = kvc.KVCacheConfig(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        block_size=SERVE_BLOCK, max_seqs=SERVE_SLOTS,
        max_blocks_per_seq=-(-SERVE_MAX_LEN // SERVE_BLOCK), dtype=cfg.dtype,
    )
    # Independent prompts: the auto size (the forked-population bound,
    # base.pool_blocks) would run out of pages; take the cap.
    base = kvc.KVCacheConfig(**{**vars(base), "num_blocks": base.pool_blocks_cap})
    eng = ServeEngine(lm, params, base, device=dev)
    weights = eng.params  # matrices cast to bf16 once; shared by both runs
    del params
    torch.cuda.synchronize()
    print(f"serve: starcoder2-3b weights drawn and cast in {time.perf_counter() - t:.1f} s; "
          f"pool {base.pool_blocks} pages of {eng.cache.pool.data[0].numel() * 2} bytes "
          f"(auto size would be {kvc.KVCacheConfig(**{**vars(base), 'num_blocks': 0}).pool_blocks})",
          flush=True)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_PROMPTS, SERVE_PROMPT_LEN),
                            generator=torch.Generator(device=dev).manual_seed(SEED + 5), device=dev)
    groups = SERVE_SLOTS // SERVE_PROMPTS

    def serve(delta_cow: bool, engine=None):
        ccfg = kvc.KVCacheConfig(**{**vars(base), "delta_cow": delta_cow})
        engine = engine or ServeEngine(lm, weights, ccfg, device=dev)
        gen = torch.Generator(device=dev).manual_seed(SEED + 6)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = engine.prefill(prompts, torch.arange(SERVE_PROMPTS, dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        out = {"logits": [logits], "tokens": [], "prefill_s": prefill_s}
        anc = torch.arange(SERVE_SLOTS, device=dev) // groups
        tok = gumbel_sample(logits, gen)[anc][:, None]
        engine.fork(anc)
        used = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for step in range(SERVE_TOKENS):
            if step == SERVE_REFORK_AT:
                anc = torch.randint(0, SERVE_SLOTS, (SERVE_SLOTS,), generator=gen, device=dev)
                engine.fork(anc)
                tok = tok[anc]
            logits = engine.decode(tok)
            tok = gumbel_sample(logits, gen)[:, None]
            out["logits"].append(logits)
            out["tokens"].append(tok)
            used.append(kvc.used_blocks(engine.cache))
        torch.cuda.synchronize()
        out["decode_s"] = time.perf_counter() - t
        first = out["logits"][1].view(SERVE_PROMPTS, groups, -1)
        require(torch.equal(first, first[:, :1].expand_as(first)),
                "after the fork, the copies' first-step logits are bit-equal to their siblings'")
        used = torch.stack(used).cpu()
        steps = torch.arange(1, SERVE_TOKENS + 1)
        dense = SERVE_SLOTS * ((SERVE_PROMPT_LEN + steps + SERVE_BLOCK - 1) // SERVE_BLOCK)
        require(bool((used < dense).all()), "live pages stay below the dense count")
        # compact_cache, against the same step on an uncompacted copy
        uncompacted = clone_cache(engine.cache)
        engine.compact_cache()
        after = engine.decode(tok)
        compacted_cache = engine.cache
        engine.cache = uncompacted
        require(torch.equal(after, engine.decode(tok)),
                "the step after compact_cache gives the uncompacted copy's logits")
        engine.cache = compacted_cache
        out["logits"].append(after)
        require(not engine.oom, f"delta_cow={delta_cow}: oom is False")
        for lg in out["logits"]:
            require(bool(torch.isfinite(lg).all()) and lg.shape[-1] == cfg.padded_vocab,
                    "finite logits over the padded vocabulary")
        out["used_peak"] = int(used.max())
        out["dense_final"] = int(dense[-1])
        out["engine"] = engine
        print(
            f"serve delta_cow={delta_cow}: prefill {SERVE_PROMPTS} x {SERVE_PROMPT_LEN} tokens "
            f"{prefill_s:.3f} s; {SERVE_TOKENS} tokens x {SERVE_SLOTS} rows in "
            f"{out['decode_s']:.3f} s ({out['decode_s'] / SERVE_TOKENS * 1e3:.2f} ms per token); "
            f"peak live pages {out['used_peak']} (dense {out['dense_final']}); "
            f"after compact {int(kvc.used_blocks(engine.cache))} pages; oom=False",
            flush=True,
        )
        return out

    dispatch.reset_launch_counts()
    whole = serve(False, eng)
    delta = serve(True)
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    print(f"serve launches (both runs): {json.dumps(launches)}", flush=True)
    for op in ("paged_attention", "paged_attention_delta", "cow_gather"):
        require(launches[op] > 0, f"kernel {op} launched on the serving path ({launches[op]})")
    for a, b in zip(whole["logits"], delta["logits"], strict=True):
        require(torch.equal(a, b), "delta COW on and off give bit-identical logits at every step")
    for a, b in zip(whole["tokens"], delta["tokens"], strict=True):
        require(torch.equal(a, b), "delta COW on and off sample the same tokens")
    print(f"serve: delta COW on and off bit-identical over {len(whole['logits'])} logit sets "
          f"and {len(whole['tokens'])} token steps", flush=True)

    # Where a decode step's time goes (whole-page run, traced).
    engine = whole["engine"]
    tok = whole["tokens"][-1]
    torch.cuda.synchronize()
    before = dispatch.launch_counts()["paged_attention"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(SERVE_PROFILE_TOKENS):
            engine.decode(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    traced = dispatch.launch_counts()["paged_attention"] - before
    print(json.dumps({"serve_profile": {
        "tokens": SERVE_PROFILE_TOKENS, "rows": SERVE_SLOTS,
        **profile_summary(prof, wall * 1e3, SERVE_PROFILE_TOKENS, "token",
                          "paged_attention_kernel", traced),
    }}), flush=True)

    # -- 7. each paged-attention kernel against its plain version ----------
    rows = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    q = torch.randn((SERVE_SLOTS, cfg.n_heads, cfg.hd), generator=gen, device=dev).to(torch.bfloat16)
    for op, run, replaces in (
        ("paged_attention", whole, "src/repro/kernels/paged_attention/kernel.py:210"),
        ("paged_attention_delta", delta, "src/repro/kernels/paged_attention/kernel.py:142"),
    ):
        cache = run["engine"].cache
        kw = dict(parent=cache.pool.parent, dirty=cache.pool.dirty) if op.endswith("delta") else {}
        errs = []
        for layer in (0, cfg.n_layers - 1):
            k_pool, v_pool = kvc.layer_views(cache, layer)
            got = paged_attention(q, k_pool, v_pool, cache.tables, cache.lengths, **kw)
            want = paged_attention_ref(q, k_pool, v_pool, cache.tables, cache.lengths, **kw)
            errs.append((got.float() - want.float()).abs().max().item())
        err = max(errs)
        require(err <= 1e-2, f"{op}: bf16 kernel within atol 1e-2 of its plain version ({err})")
        k_pool, v_pool = kvc.layer_views(cache, cfg.n_layers - 1)
        args = (q, k_pool, v_pool, cache.tables, cache.lengths)
        ms = device_ms(lambda: paged_attention(*args, **kw))
        plain_ms = device_ms(lambda: paged_attention_ref(*args, **kw))
        call_ms = time_ms(lambda: paged_attention(*args, **kw))
        moved = paged_bytes(cache, bool(kw), cfg.n_heads)
        bytes_ms = moved / rate * 1e3
        # QK and PV: 4 flops per (query head, slot, element), bf16 inputs.
        ops_ms = 4 * cfg.n_heads * cfg.hd * int(cache.lengths.sum()) / BF16_RATE * 1e3
        rows.append({
            "name": op, "route": "cuda", "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": replaces, "launches": launches[op], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "library_note": "no single PyTorch call reads K/V through a block table",
            "call_ms": call_ms,
        })
        print(f"kernel {op}: max |kernel - plain| {err!r} (layers 0 and {cfg.n_layers - 1}, bf16); "
              f"{ms:.4f} ms on the device, {call_ms:.4f} ms per call, plain {plain_ms:.4f} ms, "
              f"bound {max(bytes_ms, ops_ms):.4f} ms ({moved} bytes; operations {ops_ms:.4f} ms)",
              flush=True)

    # pool_compact at the serving page size (491,520-byte bf16 pages)
    data = whole["engine"].cache.pool.data
    perm = torch.randperm(data.shape[0] - 1, generator=gen, device=dev)[:64].to(torch.int32)
    require(torch.equal(pool_compact(data, perm)[:-1], cow_gather_ref(data, perm)),
            "cow_gather moves bf16 KV pages exactly")
    del whole, delta, engine, eng, weights, data
    torch.cuda.empty_cache()

    # -- 8. the smoke config on the card against the CPU path --------------
    readings, card = card_against_cpu(dev)
    # Both kernels on the smoke run's f32 pools, against the plain version.
    f32_err = 0.0
    for delta_cow, e in card.items():
        cache = e.cache
        kw = dict(parent=cache.pool.parent, dirty=cache.pool.dirty) if delta_cow else {}
        qs = torch.randn((cache.tables.shape[0], SMOKE.n_heads, SMOKE.hd), generator=gen, device=dev)
        for layer in range(SMOKE.n_layers):
            k_pool, v_pool = kvc.layer_views(cache, layer)
            got = paged_attention(qs, k_pool, v_pool, cache.tables, cache.lengths, **kw)
            want = paged_attention_ref(qs, k_pool, v_pool, cache.tables, cache.lengths, **kw)
            f32_err = max(f32_err, (got - want).abs().max().item())
    require(f32_err <= 1e-5, f"paged attention on f32 pools within atol 1e-5 ({f32_err})")
    print(f"smoke f32 run: card equals the CPU path (tables, refcounts, lengths); delta on/off "
          f"bit-identical; logits within {LOGIT_TOL} x the step's largest logit: "
          f"{json.dumps(readings)}; both kernels within {f32_err!r} of the plain version on "
          f"the f32 pools", flush=True)

    # -- 9. the serve entry point at full width ------------------------------
    dispatch.reset_launch_counts()
    toks = serve_cli.main(["--full"])
    torch.cuda.synchronize()
    cli_launches = dispatch.launch_counts()
    print(f"serve CLI --full launches: {json.dumps(cli_launches)}", flush=True)
    require(cli_launches["paged_attention"] > 0, "the serve CLI went through paged_attention")
    require(toks.shape == (4, 33) and bool(((toks >= 0) & (toks < CONFIG.padded_vocab)).all()),
            f"the serve CLI returns 4 continuations of 33 tokens in the vocabulary ({tuple(toks.shape)})")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch import random as rnd
    from repro_torch.core import store as store_lib
    from repro_torch.core.config import ALL_MODES, CopyMode
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.clone_chain import clone_chain_kernel, clone_chain_ref, weights_cdf
    from repro_torch.kernels.cow_gather import cow_gather, cow_gather_ref
    from repro_torch.kernels.cow_write import cow_write, cow_write_ref
    from repro_torch.kernels.refcount_update import refcount_delta, refcount_delta_ref
    from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    rate = memory_rate(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}", flush=True)

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.relative_to(ROOT)}", flush=True)
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or line.startswith("=="):
            print("  ptxas", line.strip(), flush=True)

    # -- 2. the main path ---------------------------------------------------
    n, steps = N_PARTICLES, N_STEPS
    ys = np.random.default_rng(SEED).standard_normal(steps).astype(np.float32)
    ssm = lgssm(rnd, SSMDef)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    phase_counts = {}
    results = {}

    def run(mode, resampler="systematic"):
        cfg = FilterConfig(n_particles=n, n_steps=steps, mode=mode, resampler=resampler)
        pf = ParticleFilter(ssm, cfg, device=dev)
        before = dispatch.launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pf.run(rnd.generator(SEED, dev), None, ys)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        after = dispatch.launch_counts()
        phase_counts[f"{mode.value}/{resampler}"] = {k: after[k] - before[k] for k in after}
        logz = float(res.log_evidence)
        print(
            f"run mode={mode.value} resampler={resampler} N={n} T={steps} "
            f"wall_s={wall:.3f} log_evidence={logz!r} "
            f"peak_blocks={int(res.store.peak_blocks)} pool_blocks={res.store.pool.num_blocks} "
            f"oom={bool(res.oom)}",
            flush=True,
        )
        require(math.isfinite(logz), f"{mode.value}: finite log_evidence")
        require(not bool(res.oom), f"{mode.value}: oom is False")
        require(res.ess_trace.shape == (steps,), "ess trace shape")
        return pf, res

    for mode in ALL_MODES:
        results[mode] = run(mode)
    logz_bits = {m: results[m][1].log_evidence.view(torch.int32).item() for m in ALL_MODES}
    require(len(set(logz_bits.values())) == 1, f"log_evidence bit-identical across modes {logz_bits}")
    dense_blocks = n * steps // 4
    for mode in (CopyMode.LAZY, CopyMode.LAZY_SR):
        peak = int(results[mode][1].store.peak_blocks)
        require(peak < dense_blocks, f"{mode.value} peak {peak} < dense {dense_blocks}")

    eager_pf, eager = results[CopyMode.EAGER]
    sr_pf, sr = results[CopyMode.LAZY_SR]
    ids = torch.arange(n, device=dev)
    dense = eager.store.dense[:, :steps]
    trajs = store_lib.materialize_batch(sr_pf.store_cfg, sr.store, ids)
    require(torch.equal(trajs[:, :steps], dense), "LAZY_SR materialize_batch == EAGER dense")
    compacted = store_lib.compact(sr_pf.store_cfg, sr.store)
    trajs = store_lib.materialize_batch(sr_pf.store_cfg, compacted, ids)
    require(torch.equal(trajs[:, :steps], dense), "after compact: materialize_batch == EAGER dense")
    require(not bool(compacted.pool.oom), "compact keeps oom False")
    print(
        f"materialize_batch: {n} x {steps} trajectories equal EAGER's before and after "
        f"compact (live blocks {int(store_lib.used_blocks(sr_pf.store_cfg, compacted))})",
        flush=True,
    )
    del trajs, compacted, dense, eager, results[CopyMode.EAGER], results[CopyMode.LAZY_SR]
    run(CopyMode.LAZY, "stratified")
    torch.cuda.synchronize()
    launches = dispatch.launch_counts()
    print(f"launches per run: {json.dumps(phase_counts)}", flush=True)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for op in FILTER_OPS:
        require(launches[op] > 0, f"kernel {op} launched on the filter's path ({launches[op]})")

    # -- 3. kernels against their plain versions ---------------------------
    lazy_pf, lazy = results[CopyMode.LAZY]
    tables = lazy.store.tables
    pool = lazy.store.pool
    nb, mb = pool.num_blocks, tables.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    rows = []
    # The path's final tables are full; a copy with 1/16 of the entries
    # NULL holds the kernels to the NULL case as well.
    null_tables = torch.where(
        torch.rand(tables.shape, generator=gen, device=dev) < 1 / 16, -1, tables
    ).to(torch.int32)

    def exact(got, want, what):
        for a, b in zip(got, want, strict=True):
            require(torch.equal(a, b), f"{what}: kernel equals its plain version")

    def report(op, replaces, source, got, want, fn, plain_fn, bytes_moved,
               ops=0.0, library_fn=None):
        diffs = [
            (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
            for a, b in zip(got, want, strict=True)
        ]
        err = max(diffs)
        require(err == 0.0, f"{op}: kernel equals its plain version (max |diff| {err})")
        # Device time per call of the wrapper, of the plain version and of
        # the library call; call_ms is the wrapper's time per call between
        # CUDA events with the host's launch gaps included.
        ms = device_ms(fn)
        plain_ms = device_ms(plain_fn)
        library_ms = device_ms(library_fn) if library_fn is not None else None
        call_ms = time_ms(fn)
        bytes_ms = bytes_moved / rate * 1e3
        ops_ms = ops / F32_RATE * 1e3
        rows.append({
            "name": op,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[op],
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "call_ms": call_ms,
        })
        print(f"kernel {op}: exact; {ms:.4f} ms on the device, {call_ms:.4f} ms per call "
              f"(plain {plain_ms:.4f} ms)", flush=True)

    # cow_write: an append's routing at N rows — copy rows (several per
    # shared source), in-place rows, masked rows on the dump row.
    data = pool.data.clone()
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    fresh, shared = perm[:n], perm[n : n + 4096]
    kind = torch.randint(0, 3, (n,), generator=gen, device=dev)
    pick = torch.randint(0, shared.numel(), (n,), generator=gen, device=dev)
    src = torch.where(kind == 0, shared[pick], fresh)
    dst = fresh.clone()
    src = torch.where(kind == 2, nb, src).to(torch.int32)
    dst = torch.where(kind == 2, nb, dst).to(torch.int32)
    pos = torch.randint(0, 4, (n,), generator=gen, device=dev, dtype=torch.int32)
    values = torch.randn((n, 1), generator=gen, device=dev)
    got = cow_write(data.clone(), src, dst, pos, values)
    want = cow_write_ref(data.clone(), src, dst, pos, values)
    require(not got[nb].any(), "cow_write re-zeroes the dump row")
    live_rows = int((kind != 2).sum())
    scratch_k, scratch_p = data.clone(), data.clone()

    def plain_write():
        cow_write_ref(scratch_p, src, dst, pos, values)
        scratch_p[-1].zero_()

    report(
        "cow_write", "src/repro/kernels/cow_write/kernel.py:123",
        "src/repro_torch/csrc/cow_write.cu", [got[:nb]], [want[:nb]],
        lambda: cow_write(scratch_k, src, dst, pos, values), plain_write,
        bytes_moved=n * (3 * 4 + 4) + 2 * (live_rows + 1) * 16,
    )
    del data, scratch_k, scratch_p, got, want

    # refcount_update: a resampling step's clone of the LAZY run's final
    # tables (stratified ancestors from its final weights).
    logw = lazy.log_weights
    cum = weights_cdf(logw)
    anc = torch.searchsorted(cum, (torch.arange(n, device=dev) + torch.rand(n, generator=gen, device=dev)) / n)
    old = tables.reshape(-1).contiguous()
    new = tables[anc.clamp(max=n - 1)].reshape(-1).contiguous()
    got = refcount_delta(new, old, nb)
    want = refcount_delta_ref(new, old, nb)
    print(f"refcount_update: share of entries whose new and old block agree "
          f"{(new == old).float().mean().item()!r}", flush=True)
    null_old = null_tables.reshape(-1).contiguous()
    null_new = null_tables[anc.clamp(max=n - 1)].reshape(-1).contiguous()
    exact(refcount_delta(null_new, null_old, nb), refcount_delta_ref(null_new, null_old, nb),
          "refcount_update with NULL entries")
    new1, old1 = (new + 1).long(), (old + 1).long()
    report(
        "refcount_update", "src/repro/kernels/refcount_update/kernel.py:50",
        "src/repro_torch/csrc/refcount_update.cu", got, want,
        lambda: refcount_delta(new, old, nb), lambda: refcount_delta_ref(new, old, nb),
        bytes_moved=2 * old.numel() * 4 + nb * 5,
        library_fn=lambda: torch.bincount(new1, minlength=nb + 1) - torch.bincount(old1, minlength=nb + 1),
    )
    del new, new1, old1, null_new, null_old, got, want

    # cow_gather: materialize_batch of all N over the LAZY run's pool.
    table = tables.reshape(-1).contiguous()
    got = cow_gather(pool.data, table)
    want = cow_gather_ref(pool.data, table)
    null_table = null_tables.reshape(-1).contiguous()
    exact([cow_gather(pool.data, null_table)], [cow_gather_ref(pool.data, null_table)],
          "cow_gather with NULL entries")
    distinct = int(torch.unique(table[table >= 0]).numel())
    flat_pool = pool.data.reshape(nb + 1, -1)
    safe_table = table.clamp(min=0).long()
    report(
        "cow_gather", "src/repro/kernels/cow_gather/kernel.py:35",
        "src/repro_torch/csrc/cow_gather.cu", [got], [want],
        lambda: cow_gather(pool.data, table), lambda: cow_gather_ref(pool.data, table),
        bytes_moved=table.numel() * 4 + distinct * 16 + table.numel() * 16,
        library_fn=lambda: torch.index_select(flat_pool, 0, safe_table),
    )
    del got, want, safe_table

    # clone_chain: the fused resample of the LAZY run's final weights and tables.
    u = torch.rand((), generator=gen, device=dev)
    exact(clone_chain_kernel(cum, u, null_tables, nb), clone_chain_ref(cum, u, null_tables, nb),
          "clone_chain with NULL entries")
    got = clone_chain_kernel(cum, u, tables, nb)
    want = clone_chain_ref(cum, u, tables, nb)
    print(f"clone_chain: share of entries whose new and old block agree "
          f"{(got[1] == tables).float().mean().item()!r}", flush=True)
    report(
        "clone_chain", "src/repro/kernels/clone_chain/kernel.py:96",
        "src/repro_torch/csrc/clone_chain.cu", got, want,
        lambda: clone_chain_kernel(cum, u, tables, nb), lambda: clone_chain_ref(cum, u, tables, nb),
        bytes_moved=n * 4 + 4 + 2 * tables.numel() * 4 + n * 4 + nb * 5,
        ops=n * (math.ceil(math.log2(n)) + 2),
    )
    del got, want, results, lazy

    # -- 4. the card against the CPU path, same draws ---------------------
    small_n, small_t = 256, 32
    draws = [("normal", np.random.default_rng(1).standard_normal(small_n))]
    rng = np.random.default_rng(2)
    for t in range(small_t):
        if t:
            draws.append(("uniform", np.float32(rng.random())))
        draws.append(("normal", rng.standard_normal(small_n)))
    small = {}
    for where in ("cpu", "cuda"):
        cfg = FilterConfig(n_particles=small_n, n_steps=small_t, mode=CopyMode.LAZY_SR)
        pf = ParticleFilter(ssm, cfg, device=where)
        res = pf.run(rnd.Replay(draws, where), None, ys[:small_t])
        small[where] = (
            res.store.tables.cpu(), float(res.log_evidence),
            store_lib.materialize_batch(pf.store_cfg, res.store, torch.arange(small_n, device=where)).cpu(),
        )
    require(torch.equal(small["cpu"][0], small["cuda"][0]), "small run: tables equal on card and CPU")
    require(math.isclose(small["cpu"][1], small["cuda"][1], rel_tol=1e-5), "small run: log_evidence")
    require(torch.allclose(small["cpu"][2], small["cuda"][2], rtol=1e-5, atol=1e-6), "small run: trajectories")
    print(f"small run N={small_n} T={small_t}: card agrees with the CPU path "
          f"(log_evidence {small['cuda'][1]!r} vs {small['cpu'][1]!r})", flush=True)

    # -- 6-9. serving starcoder2-3b at full width -------------------------
    rows += serve_phases(dev, rate)

    # -- 5. where a generation's time goes (a traced LAZY_SR run), last: a
    # trace of ~4e5 kernels costs later traces some of their records.
    prof_t = steps
    cfg = FilterConfig(n_particles=n, n_steps=prof_t, mode=CopyMode.LAZY_SR)
    pf = ParticleFilter(ssm, cfg, device=dev)
    torch.cuda.synchronize()
    before = dispatch.launch_counts()["cow_write"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pf.run(rnd.generator(SEED, dev), None, ys[:prof_t])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    traced = dispatch.launch_counts()["cow_write"] - before
    print(json.dumps({"profile": {
        "mode": "lazy_sr", "N": n, "T": prof_t,
        **profile_summary(prof, wall * 1e3, prof_t, "generation", "cow_write_kernel", traced),
    }}), flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    # The one card this run used.
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
