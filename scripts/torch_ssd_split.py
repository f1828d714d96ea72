#!/usr/bin/env python3
"""Where ``ssd_scan``'s time goes on the card, and its launch shape.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/torch_ssd_split.py

On ``chip_smoke.py`` phase 11's inputs (mamba2-130m's widths: B = 4,
S = 2,048, 24 heads, P 64, N 128, chunk 64, f32; the same generator and
draws) it times, with ``chip_smoke.device_ms`` (CUDA events, calls
queued behind a spin kernel):

* each launch alone: ``csrc/ssd_scan.cu`` built here with
  ``-DSSD_SCAN_PHASES=1`` (the chunk-parallel kernel) and ``=2`` (the
  pass over the chunks, on the scratch a full call left); and each with
  one part taken out (``VARIANTS``: the pass's products, its next
  chunk's loads, its h update; the chunk kernel's products), whose time
  reads what that part costs; and the shipped kernel with TF32 rounding
  by ``cvt.rna`` (the same bits, checked); all ``nvcc``s started
  together, into ``build/ssd_split/``;
* the pass's P tile (16, 32, 64) by the chunk kernel's heads per CTA (1, 2,
  4, 8, 24), each call held to rtol/atol 2e-4 of the plain version;
* the wrapper as it ships, a repeat call bit-equal, and the same in bf16;
* the largest error of the kernel and of the plain version against the
  same sums in f64;
* from one ``torch.profiler`` pass over the wrapper, each device kernel's
  time and launches per call (empty when CUPTI delivers no records).

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import itertools
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

P_TILES = (16, 32, 64)
HEADS = (1, 2, 4, 8, 24)


# Builds of ssd_scan.cu beside the shipped one: each launch alone, and
# the pass or the chunk kernel with one part taken out (its time then
# reads what that part costs; results are not checked), by -D flag and by
# replacing a line of the source.  name -> (SSD_SCAN_PHASES, [(line, by)]).
MMA_LOOP = "for (int u = warp; u < (Q / 16) * UNITS_PER_ROW; u += WARPS) {"
VARIANTS = {
    "chunk_kernel": (1, []),
    "pass": (2, []),
    "pass_without_products": (2, [(MMA_LOOP, MMA_LOOP.replace("u < (Q / 16) * UNITS_PER_ROW", "u < 0"))]),
    "pass_without_scores_x": (2, [
        ("      warp_mma_with<NT, false, kExact<T>>(diag, score, st.xs, ldx, 1, m0, n0, m0 + 16);", "")]),
    "pass_without_c_h": (2, [
        ("      warp_mma<NT, kExact<T>, false>(off, st.cs, ldc, 1, hs, 1, ldh, m0, n0, N);", "")]),
    "pass_without_next_loads": (2, [("if (c + 1 < nc) issue(", "if (false) issue("),
                                    ("    copy_rows(ss, ldh * 4,", "    if (false) copy_rows(ss, ldh * 4,")]),
    "pass_without_h_update": (2, [("      *h = make_float4(", "      if (false) *h = make_float4(")]),
    "chunk_kernel_without_products": (1, [("    if (N % 32 == 0)\n      state_tiles<4>", "    if (false)\n      state_tiles<4>"),
                                          ("    else\n      state_tiles<2>(xd", "    else if (false)\n      state_tiles<2>(xd")]),
    # Rounding to TF32 with the conversion instruction (the same bits).
    "with_cvt": (3, [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                      '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n  return r;')]),
}


def build_variants(out: Path) -> tuple:
    """Each of VARIANTS, one nvcc each, all started together; returns (name
    -> loaded library, name -> ptxas' registers of each kernel it holds)."""
    from repro_torch.kernels import _build

    out.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "ssd_scan.cu").read_text()
    jobs = {}
    for name, (phases, edits) in VARIANTS.items():
        text = source
        for line, by in edits:
            if line not in text:
                raise RuntimeError(f"{name}: ssd_scan.cu no longer holds {line!r}")
            text = text.replace(line, by)
        (out / f"{name}.cu").write_text(text)
        jobs[name] = [*_build.NVCC_FLAGS, "-shared", f"-DSSD_SCAN_PHASES={phases}",
                      "-o", str(out / f"{name}.so"), str(out / f"{name}.cu")]

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
    """Route the wrapper's launches to ``lib`` (a build of ssd_scan.cu)."""
    from repro_torch.kernels import _build

    saved = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = saved


def ssd_f64(x, dt, a, bm, cm, q):
    """The plain version's sums (``ssd_scan/ref.py``) in float64."""
    b, s, h, p = x.shape
    n, nc = bm.shape[-1], s // q
    xc = x.double().reshape(b, nc, q, h, p)
    dtc = dt.double().reshape(b, nc, q, h)
    bc, cc = bm.double().reshape(b, nc, q, n), cm.double().reshape(b, nc, q, n)
    cum = torch.cumsum(dtc * a.double(), dim=2)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    l_mat = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y = torch.einsum("bcij,bcijh,bcjh,bcjhp->bcihp", cb, l_mat, dtc, xc)
    del l_mat, diff
    decay = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcjh,bcjh,bcjhp,bcjn->bchpn", decay, dtc, xc, bc)
    hstate = torch.zeros((b, h, p, n), dtype=torch.float64, device=x.device)
    for c in range(nc):
        y[:, c] += torch.einsum("bin,bhpn,bih->bihp", cc[:, c], hstate, torch.exp(cum[:, c]))
        hstate = hstate * torch.exp(cum[:, c, -1])[:, :, None, None] + states[:, c]
    return y.reshape(b, s, h, p), hstate


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ssd_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
    from repro_torch.kernels.ssd_scan.ops import card_call, card_plan

    dev = torch.device("cuda")
    _, _, ssd_in = smoke.registry_inputs(dev)
    sb, ss, sh, sp, sn, sq = smoke.SSD_SHAPE
    x, dt, a, bm, cm = ssd_in
    libs, registers = build_variants(ROOT / "build" / "ssd_split")
    yr, hr = ssd_scan_ref(*ssd_in, chunk=sq)

    def close(out, want=(yr, hr)):
        for got, w in zip(out, want, strict=True):
            torch.testing.assert_close(got, w, rtol=2e-4, atol=2e-4)

    out = {"shape": dict(zip("B S H P N chunk".split(), smoke.SSD_SHAPE, strict=True)),
           "registers": registers, "plan": card_plan(sb, ss, sh, sp, sn, sq, x.dtype)}
    # The wrapper as it ships; errors against f64.
    y, hf = ssd_scan(*ssd_in, chunk=sq)
    close((y, hf))
    y2, hf2 = ssd_scan(*ssd_in, chunk=sq)
    out["repeat_bit_equal"] = bool(torch.equal(y, y2) and torch.equal(hf, hf2))
    smoke.require(out["repeat_bit_equal"], "a repeat call is bit-equal")
    y64, h64 = ssd_f64(*ssd_in, sq)
    out["max_err_vs_f64"] = {
        "kernel": max((y.double() - y64).abs().max().item(), (hf.double() - h64).abs().max().item()),
        "plain": max((yr.double() - y64).abs().max().item(), (hr.double() - h64).abs().max().item()),
    }
    out["tolerance_share"] = {  # largest |kernel - plain| / (2e-4 + 2e-4 |plain|)
        "y": ((y - yr).abs() / (2e-4 + 2e-4 * yr.abs())).max().item(),
        "state": ((hf - hr).abs() / (2e-4 + 2e-4 * hr.abs())).max().item(),
    }
    del y64, h64, y2, hf2
    out["wrapper_ms"] = smoke.device_ms(lambda: ssd_scan(*ssd_in, chunk=sq))
    # Each variant at the shipped plan; a pass alone reads the scratch that
    # the full call before it left (the allocator hands the same block).
    variants = {}
    for name, lib in libs.items():
        ssd_scan(*ssd_in, chunk=sq)
        with using(lib):
            variants[name] = smoke.device_ms(lambda: card_call(*ssd_in, sq))
            if name == "with_cvt":
                smoke.require(all(torch.equal(u, v) for u, v in zip(card_call(*ssd_in, sq), (y, hf))),
                              "rounding by the conversion instruction gives the same bits")
    out["variants_ms"] = variants
    # P tile x heads per CTA, each checked.
    grid = {}
    for p_tile, heads in itertools.product(P_TILES, HEADS):
        close(card_call(*ssd_in, sq, heads=heads, p_tile=p_tile))
        grid[f"pt{p_tile}_heads{heads}"] = smoke.device_ms(
            lambda: card_call(*ssd_in, sq, heads=heads, p_tile=p_tile))
    out["p_tile_heads_ms"] = grid
    # bf16 x, B and C (the plain version on the same values).
    bf = (x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16())
    yb, hb = ssd_scan(*bf, chunk=sq)
    close((yb, hb), ssd_scan_ref(*bf, chunk=sq))
    out["bf16_ms"] = smoke.device_ms(lambda: ssd_scan(*bf, chunk=sq))
    rate = smoke.memory_rate(torch.cuda.get_device_name(0))
    moved = 4 * (sum(t.numel() for t in ssd_in) + y.numel() + hf.numel())
    scratch = 4 * (out["plan"]["cb_floats"] + out["plan"]["sc_floats"])
    out["bound_ms"] = moved / rate * 1e3
    out["scratch_round_trip_ms"] = 2 * scratch / rate * 1e3
    out["traced_per_call"] = smoke.traced_per_call(lambda: ssd_scan(*ssd_in, chunk=sq), 5)
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"ssd_split": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
