#!/usr/bin/env python3
"""Where ``clone_chain``'s time goes on the card, and its tuning.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/torch_clone_chain_split.py

It runs ``chip_smoke.py``'s filter in LAZY mode (the LGSSM, systematic
resampling, N = 65,536, T = 1,024) and takes its final weights and block
tables, the inputs of ``chip_smoke.py`` phase 3 (with a uniform of its
own).  On them it times, with ``chip_smoke.device_ms`` (CUDA events,
calls queued behind a spin kernel):

* the parts of a call: the two ``torch.zeros`` of the wrapper (``delta``
  and ``member``), the comb alone (``comb.cuh``, one thread per row), and
  the walk alone (``column_runs.cuh`` over the given ancestors, as the
  fused kernel walks them, from zeroed ``delta`` and ``member``), from
  kernels built here for the purpose;
* ``csrc/clone_chain.cu`` built at each rows-per-warp segment (SEG) and
  rows-in-flight (UNROLL) pair, each call exact against the plain
  version; and the wrapper as it ships;
* from one ``torch.profiler`` pass over the wrapper, each device kernel's
  time and launches per call (empty when CUPTI delivers no records).

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

SEGS = (32, 64, 128)
UNROLLS = (2, 4, 8)
CALLS = 10  # wrapper calls in the profiler pass

PARTS = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "column_runs.cuh"
#include "comb.cuh"

__global__ void comb_only(const float* cum, const float* u, int64_t n, int32_t* anc) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r < n) anc[r] = comb_ancestor(cum, u[0], n, r);
}

// The fused kernel's walk (at its kept SEG and UNROLL) with the ancestors
// read from `anc`.
__global__ void walk_only(const int32_t* __restrict__ tables, const int32_t* __restrict__ anc,
                          int64_t n, int64_t mb, int32_t nb, int32_t* __restrict__ new_tables,
                          int32_t* delta, uint8_t* member) {
  constexpr int SEG = 64, UNROLL = 4;
  const int64_t n_cg = (mb + 127) / 128;
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int64_t c0 = warp % n_cg * 128 + threadIdx.x % 32 * 4;
  const int64_t r0 = warp / n_cg * SEG;
  if (r0 >= n || c0 >= mb) return;
  const int64_t r1 = r0 + SEG < n ? r0 + SEG : n;
  ColumnRuns<4> runs;
  for (int64_t r = r0; r < r1; r += UNROLL) {
    int32_t a[UNROLL][4], b[UNROLL][4];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k)
      if (r + k < r1) {
        load_ids<4>(tables + static_cast<int64_t>(anc[r + k]) * mb + c0, a[k]);
        load_ids<4>(tables + (r + k) * mb + c0, b[k]);
      }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      if (r + k >= r1) break;
      store_ids<4>(new_tables + (r + k) * mb + c0, a[k]);
      runs.add(a[k], b[k], nb, delta, member);
    }
  }
  runs.finish(delta);
}

extern "C" int comb(const void* cum, const void* u, int64_t n, void* anc, void* stream) {
  comb_only<<<static_cast<unsigned>((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cum), static_cast<const float*>(u), n, static_cast<int32_t*>(anc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int walk(const void* tables, const void* anc, int64_t n, int64_t mb, int64_t nb,
                    void* new_tables, void* delta, void* member, void* stream) {
  const int64_t warps = (n + 63) / 64 * ((mb + 127) / 128);
  walk_only<<<static_cast<unsigned>((warps * 32 + 255) / 256), 256, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tables), static_cast<const int32_t*>(anc), n, mb,
      static_cast<int32_t>(nb), static_cast<int32_t*>(new_tables), static_cast<int32_t*>(delta),
      static_cast<uint8_t*>(member));
  return static_cast<int>(cudaGetLastError());
}
"""


def build_all(out: Path) -> tuple:
    """The parts library and clone_chain.cu at each (SEG, UNROLL), one nvcc
    each, all started together; returns (name -> loaded library, name ->
    ptxas' registers of each kernel it holds)."""
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    (out / "parts.cu").write_text(PARTS)
    flags = [*_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared"]
    jobs = {"parts": [*flags, "-o", str(out / "parts.so"), str(out / "parts.cu")]}
    for seg, unroll in itertools.product(SEGS, UNROLLS):
        jobs[f"seg{seg}_unroll{unroll}"] = [
            *flags, f"-DCLONE_CHAIN_SEG={seg}", f"-DCLONE_CHAIN_UNROLL={unroll}",
            "-o", str(out / f"seg{seg}_unroll{unroll}.so"), str(_build.CSRC / "clone_chain.cu"),
        ]

    def run(item):
        name, args = item
        res = subprocess.run([_build._nvcc(), *args], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", res.stdout + res.stderr)]
        return name, regs

    with ThreadPoolExecutor(len(jobs)) as pool:
        registers = dict(pool.map(run, jobs.items()))
    libs = {name: ctypes.CDLL(str(out / f"{name}.so")) for name in jobs}
    return libs, registers


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_clone_chain_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import random as rnd
    from repro_torch.core.config import CopyMode
    from repro_torch.kernels.clone_chain import clone_chain_kernel, clone_chain_ref, weights_cdf
    from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef

    dev = torch.device("cuda")
    n, steps = smoke.N_PARTICLES, smoke.N_STEPS
    ys = np.random.default_rng(smoke.SEED).standard_normal(steps).astype(np.float32)
    cfg = FilterConfig(n_particles=n, n_steps=steps, mode=CopyMode.LAZY)
    pf = ParticleFilter(smoke.lgssm(rnd, SSMDef), cfg, device=dev)
    res = pf.run(rnd.generator(smoke.SEED, dev), None, ys)
    tables, nb = res.store.tables, res.store.pool.num_blocks
    mb = tables.shape[1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED + 1)
    cum = weights_cdf(res.log_weights)
    u = torch.rand((1,), generator=gen, device=dev)
    want = clone_chain_ref(cum, u, tables, nb)

    libs, registers = build_all(ROOT / "build" / "clone_chain_split")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    P, I = ctypes.c_void_p, ctypes.c_int64
    for lib in libs.values():
        for name, args in (("clone_chain", [P, P, P, I, I, I, P, P, P, P, P]),
                           ("comb", [P, P, I, P, P]), ("walk", [P, P, I, I, I, P, P, P, P])):
            if hasattr(lib, name):
                getattr(lib, name).argtypes = args
                getattr(lib, name).restype = ctypes.c_int

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: cudaError {err}")

    def variant(lib):
        def call():
            anc = torch.empty(n, dtype=torch.int32, device=dev)
            new = torch.empty((n, mb), dtype=torch.int32, device=dev)
            delta = torch.zeros(nb, dtype=torch.int32, device=dev)
            member = torch.zeros(nb, dtype=torch.bool, device=dev)
            check(lib.clone_chain(cum.data_ptr(), u.data_ptr(), tables.data_ptr(), n, mb, nb,
                                  anc.data_ptr(), new.data_ptr(), delta.data_ptr(), member.data_ptr(),
                                  stream), "clone_chain variant")
            return anc, new, delta, member
        return call

    out = {"N": n, "row": mb, "num_blocks": nb, "mean_run_old": smoke.mean_run(tables),
           "mean_run_new": smoke.mean_run(want[1]), "registers": registers}
    # The parts.
    parts = libs["parts"]
    anc = torch.empty(n, dtype=torch.int32, device=dev)
    new = torch.empty((n, mb), dtype=torch.int32, device=dev)
    delta = torch.zeros(nb, dtype=torch.int32, device=dev)
    member = torch.zeros(nb, dtype=torch.bool, device=dev)

    def comb():
        check(parts.comb(cum.data_ptr(), u.data_ptr(), n, anc.data_ptr(), stream), "comb")

    def zero():
        delta.zero_()
        member.zero_()

    def walk():
        check(parts.walk(tables.data_ptr(), anc.data_ptr(), n, mb, nb, new.data_ptr(), delta.data_ptr(),
                         member.data_ptr(), stream), "walk")

    def zero_and_walk():
        zero()
        walk()

    comb()
    zero_and_walk()
    parts_ok = all(torch.equal(x, y) for x, y in zip((anc, new, delta, member), want, strict=True))
    smoke.require(parts_ok, "the comb and walk parts reproduce the plain version")
    out["memsets_ms"] = smoke.device_ms(
        lambda: (torch.zeros(nb, dtype=torch.int32, device=dev), torch.zeros(nb, dtype=torch.bool, device=dev)))
    out["comb_ms"] = smoke.device_ms(comb)
    # Each walk starts from zeroed delta and member, as in a call (a member
    # already set would skip the walk's stores); the zeroing is subtracted.
    out["zeroing_ms"] = smoke.device_ms(zero)
    out["walk_ms"] = smoke.device_ms(zero_and_walk) - out["zeroing_ms"]
    # SEG x UNROLL, each exact.
    grid = {}
    for seg, unroll in itertools.product(SEGS, UNROLLS):
        call = variant(libs[f"seg{seg}_unroll{unroll}"])
        exact = all(torch.equal(x, y) for x, y in zip(call(), want, strict=True))
        smoke.require(exact, f"SEG {seg} UNROLL {unroll}: exact")
        grid[f"seg{seg}_unroll{unroll}"] = smoke.device_ms(call)
    out["seg_unroll_ms"] = grid
    out["wrapper_ms"] = smoke.device_ms(lambda: clone_chain_kernel(cum, u, tables, nb))
    rate = smoke.memory_rate(torch.cuda.get_device_name(0))
    out["bound_ms"] = (n * 4 + 4 + 2 * tables.numel() * 4 + n * 4 + nb * 5) / rate * 1e3
    # Launches per call and device time per kernel, traced.
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            clone_chain_kernel(cum, u, tables, nb)
        torch.cuda.synchronize()
    out["traced_per_call"] = {
        k[:72]: {"us": us / CALLS, "launches": count / CALLS}
        for k, (us, count) in smoke.kernel_events(prof).items()
    }
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"clone_chain_split": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
