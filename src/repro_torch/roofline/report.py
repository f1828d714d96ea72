"""Roofline report: ``results/dryrun_torch/*.json`` -> markdown tables (the
port of ``repro.roofline.report``).

Re-derives the ideal and the roofline fraction from the stored terms at
the card's peaks (:data:`~repro_torch.roofline.analysis.H100_SXM`), so a
change of metric needs no new trace, and names for each cell the lever
that moves its dominant term on the card.

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [--results DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.roofline.analysis import H100_SXM, model_bytes_for, model_flops_for

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

__all__ = ["dryrun_table", "enrich", "lever_for", "load", "main", "roofline_table"]


def enrich(d: dict) -> dict:
    cfg = get_config(d["arch"])
    shape = SHAPES[d["shape"]]
    rf = dict(d["roofline"])
    n = d["n_chips"]
    mf = model_flops_for(cfg, shape.kind, shape.global_batch, shape.seq_len)
    mb = model_bytes_for(cfg, shape.kind, shape.global_batch, shape.seq_len)
    ideal = max(mf / (n * H100_SXM.peak_flops), mb / (n * H100_SXM.hbm_bw))
    bound = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    rf["ideal_s"] = ideal
    rf["roofline_fraction"] = min(1.0, ideal / bound) if bound else 0.0
    return {**d, "roofline": rf}


def load(mesh: str, results: Path = RESULTS) -> list:
    out = []
    for f in sorted(glob.glob(str(Path(results) / f"*__{mesh}.json"))):
        d = json.loads(Path(f).read_text())
        if d.get("shape") not in SHAPES:  # the paged cell's own shape
            continue
        out.append(enrich(d) if d.get("ok") else d)
    return out


def fmt_bytes(b) -> str:
    return "-" if b is None else f"{b / 1e9:.2f}"


def lever_for(d: dict) -> str:
    """What moves the dominant term on an H100."""
    dom = d["roofline"]["dominant"]
    kind = d.get("kind", "")
    if dom == "memory" and kind in ("train", "prefill"):
        return "fuse the elementwise chains between GEMMs (one pass over HBM a layer)"
    if dom == "memory" and kind == "decode":
        return "paged attention over bf16 pages (read each shared page once) and fewer weight reads"
    if dom == "collective":
        return "weight-gather FSDP, and keep the model axis inside one 8-card NVLink domain"
    return "larger per-card GEMMs on the tensor cores (bigger microbatch, less replicated work)"


def roofline_table(mesh: str = "single", results: Path = RESULTS) -> str:
    lines = [
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "ideal s | fraction | useful | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for d in load(mesh, results):
        if not d.get("ok"):
            lines.append(f"| {d['arch']} | {d['shape']} | FAILED: {d.get('error', '')[:120]} |")
            continue
        rf = d["roofline"]
        lines.append(
            f"| {d['arch']} | {d['shape']} | {rf['compute_s']:.3e} | "
            f"{rf['memory_s']:.3e} | {rf['collective_s']:.3e} | "
            f"{rf['dominant']} | {rf['ideal_s']:.3e} | "
            f"{rf['roofline_fraction']:.3f} | {rf['useful_ratio']:.3f} | "
            f"{lever_for(d)} |"
        )
    return "\n".join(lines)


def dryrun_table(mesh: str, results: Path = RESULTS) -> str:
    lines = [
        "| arch | shape | args GB/card | flops/card | bytes/card | coll bytes/card | trace s |",
        "|---|---|---|---|---|---|---|",
    ]
    for d in load(mesh, results):
        if not d.get("ok"):
            lines.append(f"| {d['arch']} | {d['shape']} | FAILED |")
            continue
        ma, rf = d["memory_analysis"], d["roofline"]
        lines.append(
            f"| {d['arch']} | {d['shape']} | "
            f"{fmt_bytes(ma.get('estimated_argument_bytes_per_device'))} | "
            f"{rf['flops_per_card']:.3e} | {rf['bytes_per_card']:.3e} | "
            f"{rf['collective_bytes_per_card']:.3e} | {d['trace_s']} |"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", type=Path, default=RESULTS)
    args = ap.parse_args(argv)
    res = args.results
    out = res.parent
    (out / "roofline_torch_single.md").write_text(roofline_table("single", res))
    (out / "dryrun_torch_single.md").write_text(dryrun_table("single", res))
    (out / "dryrun_torch_multi.md").write_text(dryrun_table("multi", res))
    singles = [d for d in load("single", res) if d.get("ok")]
    multis = [d for d in load("multi", res) if d.get("ok")]
    failed = [f"{d['arch']} {d['shape']} {d['mesh']}" for m in ("single", "multi")
              for d in load(m, res) if not d.get("ok")]
    print(f"single-pod ok: {len(singles)}  multi-pod ok: {len(multis)}  failed: {len(failed)}")
    for f in failed:
        print(f"  failed: {f}")
    print("worst fractions:")
    for d in sorted(singles, key=lambda d: d["roofline"]["roofline_fraction"])[:5]:
        print(f"  {d['arch']} {d['shape']}: {d['roofline']['roofline_fraction']:.4f}")
    print("most collective-bound:")
    for d in sorted(singles, key=lambda d: -d["roofline"]["collective_s"] / max(d["roofline"]["compute_s"], 1e-12))[:5]:
        rf = d["roofline"]
        print(f"  {d['arch']} {d['shape']}: coll/comp = {rf['collective_s'] / max(rf['compute_s'], 1e-12):.1f}")


if __name__ == "__main__":
    main()
