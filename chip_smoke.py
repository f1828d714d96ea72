#!/usr/bin/env python3
"""Drive the PyTorch port of the lazy-copy platform on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py      # N = 65,536 particles, T = 1,024 generations

Phases (any failed check raises, and the script exits non-zero):

1. Build the four CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one
   process per source, in parallel).
2. The main path, with every kernel's launch counter set to 0 just
   before and read just after: the LGSSM particle filter of
   ``examples/quickstart.py`` (A=0.9, Q=0.5, R=0.3, record ``(1,)``,
   block_size 4, auto pool) in EAGER, LAZY and LAZY_SR with the
   systematic resampler from one generator seed — ``log_evidence`` must
   be bit-identical across modes, ``oom`` False, and the lazy peak below
   the dense block count; LAZY_SR's ``materialize_batch`` of all N must
   equal EAGER's dense trajectories before and after ``compact``; then
   one LAZY run with the stratified resampler (``refcount_update``
   through ``store.clone``).  Every kernel must have launched.
3. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes and on its state: integer and data-movement
   results, so exact equality (NULL entries, masked rows and duplicate
   ids included); then each one's time, its plain version's time, the
   time of one PyTorch call computing the same function where there is
   one, and the least time the card could take (bytes moved over the
   memory rate).  For the two histogram kernels it also prints the
   share of table entries whose new and old block agree (the entries
   whose atomics the kernels skip).
4. A small run on the card against the same run on the CPU path, fed
   the same draws: equal tables, log-evidence to rtol 1e-5.
5. One more LAZY_SR run under ``torch.profiler`` (CUDA activity only):
   device busy time, idle share and launches per generation, and the
   kernels that take the most device time.

Output: a line per run, the ``{"profile": ...}`` and ``{"kernels": [...]}``
JSON lines, the card's
name and power limit from ``nvidia-smi``, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the rest of the repository beside it, it exits non-zero and prints no
result.
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
# Dense float32 peak outside the tensor cores, H100 SXM.
F32_RATE = 67e12


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


def device_ms(fn, kernels=None, reps: int = 20) -> float:
    """Device time per call from torch.profiler's CUDA kernel events:
    the kernels whose names contain one of ``kernels``, or every kernel
    the call launched when ``kernels`` is None."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        if kernels is None or any(k in ev.key for k in kernels):
            total_us += ev.self_device_time_total
    if total_us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total_us / reps / 1e3


def memory_rate(name: str) -> float:
    for key, rate in MEMORY_RATE:
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


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
    for op, count in launches.items():
        require(count > 0, f"kernel {op} launched on the main path ({count})")

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

    def report(op, kernels, replaces, source, got, want, fn, plain_fn, bytes_moved,
               ops=0.0, library_fn=None):
        diffs = [
            (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
            for a, b in zip(got, want, strict=True)
        ]
        err = max(diffs)
        require(err == 0.0, f"{op}: kernel equals its plain version (max |diff| {err})")
        # Device time of the kernel itself, of every kernel the plain
        # version launches, and of the library call; call_ms is the
        # wrapper's time per call between CUDA events (host included).
        ms = device_ms(fn, kernels)
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
        "cow_write", ["cow_write_kernel"], "src/repro/kernels/cow_write/kernel.py:123",
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
        "refcount_update", ["refcount_delta_kernel"], "src/repro/kernels/refcount_update/kernel.py:50",
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
        "cow_gather", ["cow_gather_kernel"], "src/repro/kernels/cow_gather/kernel.py:35",
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
        "clone_chain", ["comb_kernel", "gather_hist_kernel"], "src/repro/kernels/clone_chain/kernel.py:96",
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

    # -- 5. where a generation's time goes (a traced LAZY_SR run) ----------
    prof_t = steps
    cfg = FilterConfig(n_particles=n, n_steps=prof_t, mode=CopyMode.LAZY_SR)
    pf = ParticleFilter(ssm, cfg, device=dev)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        pf.run(rnd.generator(SEED, dev), None, ys[:prof_t])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels_us = {}
    launches_n = 0
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels_us[ev.key] = kernels_us.get(ev.key, 0.0) + ev.self_device_time_total
            launches_n += ev.count
    busy_ms = sum(kernels_us.values()) / 1e3
    top = sorted(kernels_us.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "profile": {
            "mode": "lazy_sr", "N": n, "T": prof_t,
            "traced_wall_ms_per_generation": wall * 1e3 / prof_t,
            "device_busy_ms_per_generation": busy_ms / prof_t,
            "device_idle_share": 1 - busy_ms / (wall * 1e3),
            "device_launches_per_generation": launches_n / prof_t,
            "top_kernels_ms_per_generation": {k[:72]: v / 1e3 / prof_t for k, v in top},
        }
    }), flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
