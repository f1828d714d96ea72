#!/usr/bin/env python3
"""Where the split paged-attention kernel's time goes, on the card.

Run from the repository root on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/torch_paged_split.py

It builds a pool at the serve cell's shapes (starcoder2-3b: 30 layers, 2
KV heads of d 128, bf16, pages of 16 slots, 673 pages) with random
contents, and 16 rows as phase 6 of ``chip_smoke.py`` leaves them: 4
prompts of 500 tokens, each shared by 4 rows, and 128 tokens of each
row's own (629 slots with the one being decoded, in 40 of 41 table
entries).
Under delta COW, each row's first own page is a child of its prompt's
part-full last page, dirty from slot 4 on.  For each variant it times,
with ``chip_smoke.device_ms`` (CUDA events, calls queued behind a spin
kernel), ``paged_attention`` on layer 29 with ``split_plan`` set to
several runs of pages per split (the plan's own choice among them), and
reads from one ``torch.profiler`` pass the device time of the split
kernel and of its merge.  Prints one JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as smoke  # noqa: E402

ROWS, PROMPTS, KVH, HEADS, D, BS, LAYERS = 16, 4, 2, 24, 128, 16, 30
PROMPT_LEN, OWN, MAX_LEN = 500, 128, 656
PAGES_PER_SPLIT = (1, 2, 4, 8, 41)
REPS = 200


def serve_like(dev, gen):
    """Pool, tables, lengths, parent and dirty of the serve cell's shape."""
    nb = -(-MAX_LEN // BS)
    prompt_pages = -(-PROMPT_LEN // BS)
    live = -(-(PROMPT_LEN + OWN + 1) // BS)
    blocks = 672
    pool = torch.randn((blocks + 1, LAYERS, 2, BS, KVH, D), generator=gen, device=dev).to(torch.bfloat16)
    tables = torch.full((ROWS, nb), -1, dtype=torch.int32, device=dev)
    nxt = PROMPTS * prompt_pages
    for r in range(ROWS):
        p = r // (ROWS // PROMPTS)
        tables[r, : prompt_pages - 1] = torch.arange(p * prompt_pages, (p + 1) * prompt_pages - 1)
        own = live - (prompt_pages - 1)
        tables[r, prompt_pages - 1 : live] = torch.arange(nxt, nxt + own)
        nxt += own
    lengths = torch.full((ROWS,), PROMPT_LEN + OWN + 1, dtype=torch.int32, device=dev)
    parent = torch.full((blocks,), -1, dtype=torch.int32, device=dev)
    dirty = torch.ones((blocks, BS), dtype=torch.bool, device=dev)
    for r in range(ROWS):
        child = int(tables[r, prompt_pages - 1])
        parent[child] = (r // (ROWS // PROMPTS) + 1) * prompt_pages - 1
        dirty[child, : PROMPT_LEN % BS] = False
    return pool, tables, lengths, parent, dirty


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_paged_split: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels.paged_attention import ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    pool, tables, lengths, parent, dirty = serve_like(dev, gen)
    k_pool, v_pool = pool[:, LAYERS - 1, 0], pool[:, LAYERS - 1, 1]
    q = torch.randn((ROWS, HEADS, D), generator=gen, device=dev).to(torch.bfloat16)
    chosen = ops.split_plan(ROWS, KVH, tables.shape[1], BS)
    plan = ops.split_plan
    out = {"device": torch.cuda.get_device_name(0), "plan": chosen, "variants": {}}
    try:
        for name, kw in (("whole", {}), ("delta", dict(parent=parent, dirty=dirty))):
            want = ops.paged_attention_ref(q, k_pool, v_pool, tables, lengths, **kw)
            for pages in PAGES_PER_SPLIT:
                ops.split_plan = lambda b, kvh, nb, bs, pages=pages: (pages, -(-nb // pages))

                def call():
                    return ops.paged_attention(q, k_pool, v_pool, tables, lengths, **kw)

                err = (call().float() - want.float()).abs().max().item()
                ms = smoke.device_ms(call, reps=REPS)
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        call()
                    torch.cuda.synchronize()
                events = smoke.kernel_events(prof)
                split_us = {key.split("<")[0].split("::")[-1]: us / count
                            for key, (us, count) in events.items() if "paged_attention" in key}
                out["variants"][f"{name} pages_per_split={pages}"] = {
                    "splits": -(-tables.shape[1] // pages), "ms": ms, "max_abs_err": err,
                    "kernel_us": split_us,
                }
                print(f"{name} pages_per_split={pages}: {ms:.4f} ms, traced {json.dumps(split_us)}, "
                      f"err {err!r}", flush=True)
            ops.split_plan = plan
            out["variants"][f"{name} plain"] = {
                "ms": smoke.device_ms(lambda: ops.paged_attention_ref(q, k_pool, v_pool, tables, lengths, **kw))
            }
    finally:
        ops.split_plan = plan
    out["smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"paged_split": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
