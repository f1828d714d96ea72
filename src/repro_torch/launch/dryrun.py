"""Multi-pod dry run: trace every (arch x shape x mesh) cell's per-rank
program on the host (the port of ``repro.launch.dryrun``).

Per cell this script:
  1. sets a fake process group of 256 or 512 ranks (this process is rank
     0; collectives are traced, never run) and builds the production mesh
     on it (16 x 16 single-pod or 2 x 16 x 16 multi-pod),
  2. assembles the step function, ``meta`` stand-ins for its arguments
     and their shardings (:func:`repro_torch.launch.steps.build_cell`: no
     allocation anywhere),
  3. traces rank 0's program over fake local shards with the card's
     routing, kernels as their custom ops
     (:func:`repro_torch.distributed.costs.traced_costs`), dropping the
     dead code (XLA's DCE),
  4. walks the graph for FLOPs, bytes and collective bytes
     (:func:`~repro_torch.distributed.costs.graph_costs`), and prices
     them on the card (:func:`repro_torch.roofline.analysis.analyze_traced`),
  5. writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.

A train cell's microbatches repeat one body, so its step is traced on one
microbatch (one forward and backward, then the optimizer) and the
optimizer alone; the cell's costs are ``n_micro`` bodies plus one
optimizer (``hlo.py`` weights a loop body by its trip count likewise).
The counterpart of XLA's ``memory_analysis`` is
``estimated_argument_bytes_per_device``, from the shardings alone.  A cell
that fails to trace records its error in its JSON, as the reference's
does.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen25_32b --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] [--force] [--arch A]
  (``--all --arch A``: every shape of one arch; ``--out DIR``: elsewhere)
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

__all__ = ["RESULTS_DIR", "cell_costs", "cell_path", "main", "run_cell"]

COST_KEYS = ("flops", "matmul_flops", "kernel_flops", "bytes", "collective_bytes")


def _combine(body: dict, once: dict, trips: int) -> dict:
    """``trips`` bodies plus one ``once`` (both :func:`graph_costs` dicts)."""
    out = {k: trips * body[k] + once[k] for k in COST_KEYS}
    kinds = set(body["collective_breakdown"]) | set(once["collective_breakdown"])
    out["collective_breakdown"] = {
        k: trips * body["collective_breakdown"].get(k, 0) + once["collective_breakdown"].get(k, 0) for k in kinds
    }
    out["nodes"] = body["nodes"] + once["nodes"]
    return out


def cell_costs(cell, mesh) -> dict:
    """One card's costs of ``cell``'s step (see the module docstring for a
    train cell's microbatches)."""
    import torch

    from repro_torch.distributed.costs import traced_costs
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.steps import _bspec, make_train_step
    from repro_torch.models.model import LanguageModel
    from repro_torch.train.optimizer import AdamWConfig, adamw_update

    kind = cell.shape.kind
    if kind != "train":
        return traced_costs(cell.step_fn, cell.args, cell.in_shardings, mesh,
                            mode="decode" if kind == "decode" else "train")
    params, opt_state, batch = cell.args
    param_sh, opt_sh, _ = cell.in_shardings
    n = cell.n_microbatches
    b = batch["tokens"].shape[0] // n
    micro = {k: torch.empty((b, *v.shape[1:]), dtype=v.dtype, device="meta") for k, v in batch.items()}
    micro_sh = {k: NamedSharding(mesh, _bspec(mesh, b, v.dim())) for k, v in micro.items()}
    step = make_train_step(LanguageModel(cell.cfg), AdamWConfig(), 1, param_shardings=param_sh)
    one = traced_costs(step, (params, opt_state, micro), (param_sh, opt_sh, micro_sh), mesh)

    def update(p, o, g):
        return adamw_update(AdamWConfig(), p, g, o)

    # The optimizer alone, its f32 gradients standing in as the params' shapes.
    opt = traced_costs(update, (params, opt_state, params), (param_sh, opt_sh, param_sh), mesh)
    body = {k: one[k] - opt[k] for k in COST_KEYS}
    body["collective_breakdown"] = {
        k: v - opt["collective_breakdown"].get(k, 0) for k, v in one["collective_breakdown"].items()
    }
    body["nodes"] = one["nodes"]
    return _combine(body, opt, n)


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.roofline.analysis import analyze_traced

    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    n_cards = mesh.size()
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh)
    out: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "n_chips": n_cards,
        "kind": cell.shape.kind,
        "n_microbatches": cell.n_microbatches,
        "sharding_fallbacks": sorted(set(cell.fallbacks)),
    }
    t1 = time.time()
    costs = cell_costs(cell, mesh)
    out["build_s"] = round(t1 - t0, 2)
    out["trace_s"] = round(time.time() - t1, 2)
    out["memory_analysis"] = {
        "estimated_argument_bytes_per_device": _estimate_arg_bytes(cell.args, cell.in_shardings, mesh),
    }
    out["costs"] = costs
    print(f"memory_analysis: {out['memory_analysis']}")
    rf = analyze_traced(
        costs, n_cards=n_cards, cfg=cell.cfg, kind=cell.shape.kind,
        batch=cell.shape.global_batch, seq=cell.shape.seq_len,
    )
    out["roofline"] = rf.as_dict()
    print(
        f"roofline: compute={rf.compute_s:.4e}s memory={rf.memory_s:.4e}s "
        f"collective={rf.collective_s:.4e}s dominant={rf.dominant} "
        f"fraction={rf.roofline_fraction:.3f} useful={rf.useful_ratio:.3f}"
    )
    out["ok"] = True
    return out


def _estimate_arg_bytes(args, shardings, mesh) -> int:
    """Bytes of the arguments one device holds: each leaf's bytes over the
    pieces its sharding cuts it into (the reference's estimate)."""
    from repro_torch.distributed.costs import _leaves
    from repro_torch.distributed.sharding import NamedSharding, shard_count

    total = 0
    for a, s in zip(_leaves(args), _leaves(shardings), strict=False):
        if not hasattr(a, "shape"):
            continue
        size = a.numel() * a.element_size() if a.dim() else a.element_size()
        if isinstance(s, NamedSharding):
            size //= max(shard_count(mesh, s.spec), 1)
        total += size
    return total


def cell_path(arch: str, shape: str, mesh_name: str, results: Path = RESULTS_DIR) -> Path:
    return Path(results) / f"{arch}__{shape}__{mesh_name}.json"


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS, shape_cells

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR, help="where the JSONs go")
    args = ap.parse_args(argv)

    args.out.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    cells = []
    if args.all:
        for arch in ARCHS:
            if args.arch and arch != args.arch:
                continue
            for shape in shape_cells(arch):
                for m in meshes:
                    cells.append((arch, shape, m))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        for m in meshes:
            cells.append((args.arch, args.shape, m))

    if args.list:
        for c in cells:
            print(*c)
        return 0

    failures = 0
    for arch, shape, mesh_name in cells:
        path = cell_path(arch, shape, mesh_name, args.out)
        if path.exists() and not args.force:
            print(f"[skip] {arch} {shape} {mesh_name} (cached)")
            continue
        print(f"[run ] {arch} {shape} {mesh_name}", flush=True)
        t0 = time.time()
        try:
            result = run_cell(arch, shape, mesh_name == "multi")
        except Exception as e:
            traceback.print_exc()
            result = {
                "arch": arch,
                "shape": shape,
                "mesh": mesh_name,
                "ok": False,
                "error": f"{type(e).__name__}: {e}"[:2000],
            }
            failures += 1
        result["total_s"] = round(time.time() - t0, 2)
        path.write_text(json.dumps(result, indent=2))
        print(f"[done] {arch} {shape} {mesh_name} in {result['total_s']}s "
              f"ok={result.get('ok')}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
