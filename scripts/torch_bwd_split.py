#!/usr/bin/env python3
"""Where the backward kernels' time goes on the card, and how close SSD's
gradients come to exact ones.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/torch_bwd_split.py

* each device kernel's time per call from one ``torch.profiler`` pass over
  ``flash_attention_bwd`` and ``ssd_scan_bwd`` at phase 18's shapes of
  ``chip_smoke.py`` (starcoder2-3b's attention, given the forward's row
  log-sum-exp as training passes it, and mamba2-130m's scan), and the
  calls' times between CUDA events; an empty ``kernel_us`` means CUPTI
  delivered no records;
* each gradient of ``ssd_scan_bwd`` and of its plain version (f32) against
  the plain version in f64, as a share of that gradient's largest
  magnitude (a hundredth of the call's largest gradient where more, as
  the ``cuda`` tests read it), at the inputs of
  ``tests/test_torch_boundaries.py::TestBackwardKernelsOnCard::test_ssd_scan_bwd``
  with 64 chunks and one head, whose da sums terms that cancel.

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "tests")]


def ssd_ref64():
    """``ssd_scan_ref`` computed in f64: ``ref.py``'s text with f64 casts."""
    from repro_torch.kernels.ssd_scan import ref

    text = Path(ref.__file__).read_text().replace(".float()", ".double()")
    ns: dict = {}
    exec(compile(text.replace("dtype=torch.float32", "dtype=torch.float64"), "ref64", "exec"), ns)
    return ns["ssd_scan_ref"]


def shares(got, want) -> dict:
    want = [w.double().cpu() for w in want]
    largest = max(w.abs().max().item() for w in want)
    return {name: (g.double().cpu() - w).abs().max().item() / max(w.abs().max().item(), 1e-2 * largest)
            for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, want, strict=True)}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bwd_split: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from test_torch_boundaries import ssd_inputs

    from repro_torch import random as rnd
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ops import forward_lse
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd, ssd_scan_bwd_ref

    _build.build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    b, s, h, kvh, d = cs.TRAIN_FLASH_CASES[0][1]
    q = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, kvh, d), generator=gen, device=dev).bfloat16() for _ in range(2))
    dout = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
    out, lse = forward_lse(q, k, v)
    b2, s2, h2, p2, n2 = cs.TRAIN_SSD_SHAPE
    ssd = list(ssd_inputs(gen, b2, s2, h2, p2, n2, torch.float32, dev))
    ssd += [torch.randn((b2, s2, h2, p2), generator=gen, device=dev),
            torch.randn((b2, h2, p2, n2), generator=gen, device=dev)]
    calls = {"flash_attention_bwd": lambda: flash_attention_bwd(q, k, v, out, dout, lse=lse),
             "ssd_scan_bwd": lambda: ssd_scan_bwd(*ssd)}
    report = {"call_ms": {name: cs.device_ms(fn, reps=10) for name, fn in calls.items()}, "kernel_us": {}}
    reps = 5
    for name, fn in calls.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        report["kernel_us"][name] = {e.key: e.device_time_total / reps for e in prof.key_averages()
                                     if e.device_time_total > 0}

    s3, h3 = 4096, 1
    g3 = rnd.generator(7 + s3 + h3, dev)
    args = ssd_inputs(g3, 2, s3, h3, 64, 128, torch.float32, dev)
    dy = torch.randn((2, s3, h3, 64), generator=g3, device=dev)
    dh = torch.randn((2, h3, 64, 128), generator=g3, device=dev)
    cpu = [t.cpu() for t in (*args, dy, dh)]
    with torch.enable_grad():
        leaves = [t.double().requires_grad_() for t in cpu[:5]]
        y, h_last = ssd_ref64()(*leaves)
        exact = torch.autograd.grad([y, h_last], leaves, [cpu[5].double(), cpu[6].double()])
    report["ssd_grad_error_vs_f64"] = {"shape": [2, s3, h3, 64, 128], "chunk": 64,
                                       "kernel": shares(ssd_scan_bwd(*args, dy, dh), exact),
                                       "plain_f32": shares(ssd_scan_bwd_ref(*cpu), exact)}
    report["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                    capture_output=True, text=True).stdout.strip()
    print(json.dumps({"bwd_split": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
