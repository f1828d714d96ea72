#!/usr/bin/env python3
"""Two read-only checks of PyTorch's float32 bits on the host's CPU, for
the port's plain (CPU) path.

1. ``first-call``: does the first call in a process of a function the SMC
   update runs on the CPU return other bits than a later call?  (On an
   H100 host's CPU, MKL's VML ``exp`` did so for one thread's share of a
   tensor in 3 of 40 processes; ``kernels/ssd_scan/ref.py`` moved to
   ``torch.exp2`` for it.)  For each function, ``--procs`` fresh Python
   processes (``--jobs`` at a time) each call it first, on inputs drawn
   with numpy from a fixed seed, then again; the script counts the
   processes whose first call differs from their later one, the most
   elements differing, and the processes whose first call differs from
   the first process's.
2. ``row-count``: does one row's float32 GEMM output depend on how many
   rows the batch has?  Row 0 of ``x[:m] @ w`` for m = 1..40 at the
   starcoder2-3b smoke model's unembedding (96 -> 256) and MLP
   up-projection (96 -> 192) widths, grouped into classes of equal bits.

Run from the repository root: ``python3 scripts/torch_cpu_bit_checks.py
[--procs 40] [--jobs 4]``.  Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# One fresh process: the named case's first call (nothing else has
# computed in the process), then a later one.
CHILD = r"""
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels.clone_chain.ref import weights_cdf
from repro_torch.smc import resampling

rng = np.random.default_rng(0)
def t(*shape, scale=1.0):
    return torch.as_tensor((rng.standard_normal(shape) * scale).astype(np.float32))

CASES = {
    "normalize[16]": (resampling.normalize, (16,), 3),
    "normalize[65536]": (resampling.normalize, (65536,), 3),
    "ess[16]": (resampling.ess, (16,), 3),
    "ess[65536]": (resampling.ess, (65536,), 3),
    "weights_cdf[16]": (weights_cdf, (16,), 3),
    "weights_cdf[65536]": (weights_cdf, (65536,), 3),
    "log_softmax[16,49152]": (lambda x: torch.log_softmax(x / 0.7, dim=-1), (16, 49152), 1),
    "log_softmax[8,256]": (lambda x: torch.log_softmax(x, dim=-1), (8, 256), 4),
    "logsumexp[16]": (lambda x: torch.logsumexp(x, 0), (16,), 3),
    "logsumexp[16,49152]": (lambda x: torch.logsumexp(x, -1), (16, 49152), 1),
}
if sys.argv[2] == "--list":
    print(json.dumps(list(CASES)))
    sys.exit(0)
fn, shape, scale = CASES[sys.argv[2]]
x = t(*shape, scale=scale)
first = fn(x)
later = fn(x)
print(json.dumps([hashlib.sha256(first.numpy().tobytes()).hexdigest(),
                  int((first.view(torch.int32) != later.view(torch.int32)).sum())]))
"""


def _child(*args: str) -> list:
    done = subprocess.run([sys.executable, "-c", CHILD, str(ROOT / "src"), *args],
                          capture_output=True, text=True, check=True, timeout=300)
    return json.loads(done.stdout.strip().splitlines()[-1])


def first_call(procs: int, jobs: int) -> dict:
    report = {"procs_per_function": procs, "threads": torch.get_num_threads(), "functions": {}}
    with ThreadPoolExecutor(jobs) as pool:
        for name in _child("--list"):
            runs = list(pool.map(lambda _: _child(name), range(procs)))
            report["functions"][name] = {
                "procs_first_differs_from_later": sum(d > 0 for _, d in runs),
                "elements_differing_max": max(d for _, d in runs),
                "procs_differing_from_the_first": sum(h != runs[0][0] for h, _ in runs),
            }
    return report


def row_count() -> dict:
    from repro_torch.configs.starcoder2_3b import SMOKE
    from repro_torch.models.model import LanguageModel

    params = LanguageModel(SMOKE).init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn((40, SMOKE.d_model), generator=torch.Generator().manual_seed(1))
    mats = {
        "unembed (96 -> 256)": params["embed"].float().T,  # as models/layers.unembed
        "mlp w_up (96 -> 192)": params["blocks"]["mlp"]["w_up"][0].float(),
    }
    out = {}
    for name, w in mats.items():
        classes, labels = [], []
        for m in range(1, 41):
            row = (x[:m] @ w)[0]
            for i, c in enumerate(classes):
                if torch.equal(c, row):
                    labels.append(i)
                    break
            else:
                classes.append(row)
                labels.append(len(classes) - 1)
        out[name] = {"class_of_rows_1_to_40": labels}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=40)
    ap.add_argument("--jobs", type=int, default=4)
    args = ap.parse_args()
    print(json.dumps({"first_call": first_call(args.procs, args.jobs), "row_count": row_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
