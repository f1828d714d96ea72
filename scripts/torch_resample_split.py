#!/usr/bin/env python3
"""Where ``resample``'s time goes on the card, and its tile size.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/torch_resample_split.py

It runs ``chip_smoke.py``'s filter in LAZY mode (the LGSSM, systematic
resampling, N = 65,536, T = 1,024) for its final weights, whose CDF is
``chip_smoke.py`` phase 11's input, and makes log-normal CDFs
(``planted_cdfs``' weights) at N = 4,096, 65,536 and 1,048,576 and two
degenerate ones at 65,536 and 1,048,576 (one particle holding all the
weight; zero-weight runs wider than the shared stage).  On each it times,
with ``chip_smoke.device_ms`` (CUDA events, calls queued behind a spin
kernel), each of these builds, all ``nvcc``s started together into
``build/resample_split/``:

* ``per_output``: the kernel this one replaced, a thread per output searching
  the whole CDF (``comb.cuh``'s ``comb_ancestor``), 256 threads a CTA;
* ``tile512``, ``tile1024``, ``tile2048``: ``csrc/resample.cu`` at that many outputs
  a CTA (``-DRESAMPLE_TILE``; the shipped kernel is ``tile512``);
* a part taken out, by replacing source lines of ``resample.cu`` or
  ``comb_range.cuh`` (``PARTS``): ``slack250`` and ``slack1000`` (the
  first guess's slack, 122 and 488 entries against the shipped 244),
  ``bounded_search`` (the staged range searched with bound checks,
  ``count_below``, instead of over its padding), ``without_guess``
  (every tile's range found by the probe rounds), all four checked;
  ``without_range_search`` (a missed guess replaced by the tile's own
  indices), ``without_search`` (the range staged but not searched),
  ``without_stage`` (the range searched in ``cum`` itself, as a tile
  wider than the stage is), ``without_stage_and_search`` (the loads of
  the guess, the probes and u, and the stores); the last four's results
  are not checked, their times read what the part costs;

every checked variant exact against the plain version on every input.
Beside them: the wrapper as it ships, the plain version,
``torch.searchsorted`` alone on precomputed positions, the launch floor
(a 4-byte ``zero_()`` and an empty kernel between the same events), the
byte bound, each input's tiles (``chip_smoke.comb_tiles``: spans, guesses
that hold), and one ``torch.profiler`` pass
over the wrapper.  The grid runs twice, in reverse order the second
time.  Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
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

TILES = (512, 1024, 2048)
SIZES = (4096, 65536, 1048576)

PER_OUTPUT = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "comb.cuh"

__global__ void per_output_kernel(const float* __restrict__ cum, const float* __restrict__ u, int64_t n,
                            int32_t* __restrict__ anc) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j < n) anc[j] = comb_ancestor(cum, u[0], n, j);
}

__global__ void empty_kernel() {}

extern "C" int resample_systematic(const void* cum, const void* u, int64_t n, void* anc, void* stream) {
  per_output_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cum), static_cast<const float*>(u), n, static_cast<int32_t*>(anc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""

# resample.cu with one part taken out: name -> [(source text, replacement)];
# each time reads what the part costs.  The first, a correct kernel, is
# this kernel's first design; the others' results are not checked.
GUESS_TEST = "  if ((a == 0 || !(stage[a - 1 - base] >= p_first)) && (b == n || stage[b - base] >= p_last))"
RANGE_CALL = "  comb_tile_range<THREADS>(cum, n, p_first, p_last, STAGE / 2 - 4, first, a, b);"
STAGE_SEARCH = "    count_below_staged<E>(stage + (a - base), static_cast<int>(b - a), p, ks);"
GLOBAL_SEARCH = """  } else {
    count_below<E>(cum + a, b - a, p, k);
  }"""
SLACK = "constexpr int kSlack = TILE / 2 - 12;"
PARTS = {
    "slack250": [(SLACK, "constexpr int kSlack = TILE / 4 - 6;")],
    "slack1000": [(SLACK, "constexpr int kSlack = TILE - 24;")],
    "bounded_search": [(STAGE_SEARCH, """    int64_t kk[E];
    count_below<E>(stage + (a - base), b - a, p, kk);
    for (int e = 0; e < E; ++e) ks[e] = static_cast<int>(kk[e]);""")],
    "without_guess": [(GUESS_TEST, "  if (a == 0 && b == n)")],
    "without_range_search": [(RANGE_CALL, "  a = j0;\n  b = j1;")],
    "without_search": [(STAGE_SEARCH, "    for (int e = 0; e < E; ++e) ks[e] = 0;")],
    "without_stage": [("  if (staged) {", "  if (false) {")],
    "without_stage_and_search": [("  int64_t k[E];", "  int64_t k[E] = {};"),
                                 ("  if (staged) {", "  if (false) {"), (GLOBAL_SEARCH, "  }")],
}
CHECKED = ("per_output", *(f"tile{t}" for t in TILES), "slack250", "slack1000", "bounded_search",
           "without_guess")


def build_variants(out: Path) -> tuple:
    """PER_OUTPUT, each tile size and each of PARTS (in a directory of its own
    holding resample.cu and comb_range.cuh, each edited where it holds the
    line), one nvcc each, all started together; returns (name -> loaded
    library, name -> ptxas' registers)."""
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    flags = [*_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-shared"]
    sources = {name: (_build.CSRC / name).read_text() for name in ("resample.cu", "comb_range.cuh")}
    (out / "per_output.cu").write_text(PER_OUTPUT)
    jobs = {"per_output": [*flags, "-o", str(out / "per_output.so"), str(out / "per_output.cu")]}
    for tile in TILES:
        jobs[f"tile{tile}"] = [*flags, f"-DRESAMPLE_TILE={tile}", "-o", str(out / f"tile{tile}.so"),
                               str(_build.CSRC / "resample.cu")]
    for name, edits in PARTS.items():
        texts = dict(sources)
        for line, by in edits:
            holders = [f for f, text in texts.items() if line in text]
            if len(holders) != 1:
                raise RuntimeError(f"{name}: the sources hold {line!r} {len(holders)} times")
            texts[holders[0]] = texts[holders[0]].replace(line, by)
        (out / name).mkdir(exist_ok=True)
        for file, text in texts.items():
            (out / name / file).write_text(text)
        jobs[name] = [*flags, "-o", str(out / f"{name}.so"), str(out / name / "resample.cu")]

    def run(item):
        name, args = item
        res = subprocess.run([_build._nvcc(), *args], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{res.stdout}{res.stderr}")
        return name, [int(x) for x in re.findall(r"Used (\d+) registers", res.stdout + res.stderr)]

    with ThreadPoolExecutor(len(jobs)) as pool:
        registers = dict(pool.map(run, jobs.items()))
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in jobs}, registers


@contextlib.contextmanager
def using(lib):
    """Route the wrapper's launches to ``lib`` (a build of resample.cu)."""
    from repro_torch.kernels import _build

    saved = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = saved


def filter_cdf(dev):
    """Phase 2's final LAZY weights, as chip_smoke.py phase 11 takes them."""
    from repro_torch import random as rnd
    from repro_torch.core.config import CopyMode
    from repro_torch.kernels.clone_chain import fixed_order_cumsum
    from repro_torch.smc.filters import FilterConfig, ParticleFilter, SSMDef

    ys = np.random.default_rng(smoke.SEED).standard_normal(smoke.N_STEPS).astype(np.float32)
    cfg = FilterConfig(n_particles=smoke.N_PARTICLES, n_steps=smoke.N_STEPS, mode=CopyMode.LAZY)
    pf = ParticleFilter(smoke.lgssm(rnd, SSMDef), cfg, device=dev)
    res = pf.run(rnd.generator(smoke.SEED, dev), None, ys)
    cum = fixed_order_cumsum(torch.softmax(res.log_weights, 0))
    return cum / cum[-1]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_resample_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.clone_chain.ref import comb_positions
    from repro_torch.kernels.resample import planted_cdfs, resample_systematic_ref, systematic_comb

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 11)
    inputs = {"filter_65536": (filter_cdf(dev), torch.rand((1,), generator=gen, device=dev))}
    for n in SIZES:
        u = torch.rand((1,), generator=gen, device=dev)
        inputs[f"lognormal_{n}"] = planted_cdfs(n, seed=n)["u_zero"][0], u
    for n in SIZES[1:]:
        cases = planted_cdfs(n, seed=n)
        for case in ("one_particle", "zero_runs"):
            inputs[f"{case}_{n}"] = cases[case]
    inputs = {k: (c.to(dev), u.to(dev)) for k, (c, u) in inputs.items()}
    libs, registers = build_variants(ROOT / "build" / "resample_split")
    rate = smoke.memory_rate(torch.cuda.get_device_name(0))

    out = {"registers": registers, "inputs": {}}
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    out["launch_floor_ms"] = {"zero_4_bytes": smoke.device_ms(lambda: tiny.zero_()),
                              "empty_kernel": smoke.device_ms(lambda: libs["per_output"].empty(stream))}
    for key, (cum, u) in inputs.items():
        n = cum.shape[0]
        want = resample_systematic_ref(cum, u)
        for name in CHECKED:
            with using(libs[name]):
                smoke.require(torch.equal(systematic_comb(cum, u), want), f"{name} exact on {key}")
        positions = comb_positions(u.reshape(()), n)
        out["inputs"][key] = {
            "N": n, "bound_ms": (8 * n + 4) / rate * 1e3, **smoke.comb_tiles(cum, u),
            "wrapper_ms": smoke.device_ms(lambda: systematic_comb(cum, u)),
            "plain_ms": smoke.device_ms(lambda: resample_systematic_ref(cum, u)),
            "searchsorted_ms": smoke.device_ms(lambda: torch.searchsorted(cum, positions, side="left")),
            "variants_ms": {name: [] for name in libs},
        }
    # Each variant on each input, twice: forward, then in reverse order.
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            with using(libs[name]):
                for key, (cum, u) in inputs.items():
                    out["inputs"][key]["variants_ms"][name].append(
                        smoke.device_ms(lambda: systematic_comb(cum, u)))
    cum, u = inputs["filter_65536"]
    out["traced_per_call"] = smoke.traced_per_call(lambda: systematic_comb(cum, u), 10)
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"resample_split": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
