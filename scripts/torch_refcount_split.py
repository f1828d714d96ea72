#!/usr/bin/env python3
"""Where a per-entry ``refcount_update`` kernel's time goes, on the card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/torch_refcount_split.py

It runs ``chip_smoke.py``'s filter (the LGSSM, LAZY with the stratified
resampler, N = 65,536, T = 1,024) and clones its final tables by
stratified ancestors from its final weights, as ``chip_smoke.py`` phase 3
does (with draws of its own).  On those inputs it times, with
``chip_smoke.device_ms`` (CUDA events, calls queued behind a spin
kernel), a one-thread-per-entry kernel in row-major order, the
design ``csrc/refcount_update.cu`` replaced, in four forms: the table
loads alone; loads with the guarded ``member`` store; loads with the
atomics of entries whose ids differ; the whole update
(``refcount_hist_entry`` of ``csrc/refcount_hist.cuh``).  Beside them:
``refcount_delta`` with and without the row length, and two
``torch.bincount`` calls.  Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

PER_ENTRY = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "refcount_hist.cuh"

// mode 0: loads; 1: loads + guarded member store; 2: loads + atomics;
// 3: the whole update.
__global__ void per_entry(const int32_t* a_ids, const int32_t* b_ids, int64_t e, int32_t nb,
                          int32_t* delta, uint8_t* member, int mode) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= e) return;
  const int32_t a = a_ids[t], b = b_ids[t];
  const bool a_ok = a >= 0 && a < nb;
  if (mode == 0 && a == -7) delta[0] = b;  // keeps the loads
  if (mode == 1 && a_ok && member[a] == 0) member[a] = 1;
  if (mode == 2 && a != b) {
    if (a_ok) atomicAdd(delta + a, 1);
    if (b >= 0 && b < nb) atomicAdd(delta + b, -1);
  }
  if (mode == 3) refcount_hist_entry(a, b, nb, delta, member);
}

extern "C" int run(const void* a, const void* b, int64_t e, int64_t nb, void* delta,
                   void* member, int mode, void* stream) {
  per_entry<<<static_cast<unsigned>((e + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b), e, static_cast<int32_t>(nb),
      static_cast<int32_t*>(delta), static_cast<uint8_t*>(member), mode);
  return static_cast<int>(cudaGetLastError());
}
"""

MODES = ("loads", "loads_member", "loads_atomics", "per_entry_full")


def build_per_entry() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = ROOT / "build" / "refcount_split"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "per_entry.cu", out / "libper_entry.so"
    src.write_text(PER_ENTRY)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared", "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.run.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 2 + [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    dll.run.restype = ctypes.c_int
    return dll


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_refcount_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import random as rnd
    from repro_torch.core.config import CopyMode
    from repro_torch.kernels.clone_chain import weights_cdf
    from repro_torch.kernels.refcount_update import refcount_delta, refcount_delta_ref
    from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef

    dev = torch.device("cuda")
    n, steps = smoke.N_PARTICLES, smoke.N_STEPS
    ys = np.random.default_rng(smoke.SEED).standard_normal(steps).astype(np.float32)
    cfg = FilterConfig(n_particles=n, n_steps=steps, mode=CopyMode.LAZY, resampler="stratified")
    pf = ParticleFilter(smoke.lgssm(rnd, SSMDef), cfg, device=dev)
    res = pf.run(rnd.generator(smoke.SEED, dev), None, ys)
    tables, nb = res.store.tables, res.store.pool.num_blocks
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED + 1)
    cum = weights_cdf(res.log_weights)
    anc = torch.searchsorted(cum, (torch.arange(n, device=dev) + torch.rand(n, generator=gen, device=dev)) / n)
    new2 = tables[anc.clamp(max=n - 1)].contiguous()
    old, new = tables.reshape(-1).contiguous(), new2.reshape(-1).contiguous()
    mb = tables.shape[1]

    dll = build_per_entry()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    delta = torch.zeros(nb, dtype=torch.int32, device=dev)
    member = torch.zeros(nb, dtype=torch.bool, device=dev)

    def zero():
        delta.zero_()
        member.zero_()

    def per_entry(mode):
        def fn():
            zero()
            err = dll.run(new.data_ptr(), old.data_ptr(), new.numel(), nb, delta.data_ptr(),
                          member.data_ptr(), mode, stream)
            if err:
                raise RuntimeError(f"per-entry kernel, mode {mode}: cudaError {err}")
        return fn

    want = refcount_delta_ref(new, old, nb)
    per_entry(3)()
    full_ok = torch.equal(delta, want[0]) and torch.equal(member, want[1])
    runs_ok = all(torch.equal(x, y) for x, y in zip(refcount_delta(new, old, nb, row=mb), want, strict=True))
    smoke.require(full_ok and runs_ok, f"per-entry exact {full_ok}, run-following exact {runs_ok}")

    zero_ms = smoke.device_ms(zero)
    out = {"N": n, "row": mb, "entries": new.numel(), "num_blocks": nb,
           "equal_share": (new == old).float().mean().item(),
           "distinct_blocks": int(torch.unique(new).numel()),
           "mean_run_new": smoke.mean_run(new2), "mean_run_old": smoke.mean_run(tables),
           "zeroing_ms": zero_ms}
    for mode, name in enumerate(MODES):
        out[f"{name}_ms"] = smoke.device_ms(per_entry(mode)) - zero_ms
    out["runs_kernel_ms"] = smoke.device_ms(lambda: refcount_delta(new, old, nb, row=mb))
    out["runs_kernel_one_row_ms"] = smoke.device_ms(lambda: refcount_delta(new, old, nb))
    new1, old1 = (new + 1).long(), (old + 1).long()
    out["two_bincount_ms"] = smoke.device_ms(
        lambda: torch.bincount(new1, minlength=nb + 1) - torch.bincount(old1, minlength=nb + 1))
    rate = smoke.memory_rate(torch.cuda.get_device_name(0))
    out["bound_ms"] = (2 * new.numel() * 4 + nb * 5) / rate * 1e3  # tables in, delta and member out
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"refcount_split": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
