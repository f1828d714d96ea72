"""One run of one cell of the port's benchmark.

``run.py`` is the command; this module finds the cell's files by name
and turns what its task measured into the result's line.

* The cell: its entry in ``BENCHMARK.json``, the configuration's file
  ``portbench/configs/<config>.json`` and the traffic's parameters
  ``portbench/traffic/<traffic>.json``.
* The task: ``portbench/tasks/<task>.py``, named by the traffic's
  ``task``.  Its ``run(cell, dev, seed, seconds, trace, t_start)`` sets
  up, measures for ``seconds``, checks what the timed path produced
  against the plain reference, and returns an :class:`Outcome`.
* The per-layer metrics: one reader a metric,
  ``portbench/metrics/<metric>.py``, whose ``read(ctx)`` takes a
  :class:`Context`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable, List, Optional

import torch

from portbench import tracing

BENCH = "portbench"
#: top-level module names a run must not have loaded (compared whole:
#: the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_module(path: Path, name: str) -> Any:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    root: Path
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def path(self, *parts: str) -> Path:
        return self.root.joinpath(BENCH, *parts)


def load_cell(root: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / BENCH / "traffic" / f"{entry['traffic']}.json").read_text())

    def applies(metric: dict) -> bool:
        return workload in metric.get("workloads", [workload])

    return Cell(root, workload, entry["chips"], config, traffic,
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


def task_module(cell: Cell) -> Any:
    """``portbench/tasks/<task>.py`` for the cell's traffic."""
    task = cell.traffic.get("task")
    path = cell.path("tasks", f"{task}.py")
    if not isinstance(task, str) or not path.is_file():
        raise ValueError(f"traffic of {cell.name!r}: task {task!r} has no portbench/tasks/<task>.py")
    return load_module(path, f"portbench_task_{task}")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Context:
    """What a per-layer reader (``portbench/metrics/<name>.py``) reads."""

    config: dict
    block: Optional[tracing.Block]  # the profiled block, or None
    counters: dict  # the program's own counters, by name
    peaks: Optional[dict]  # the card's row of portbench/peaks.json
    roofline: Callable[[str], Any]  # portbench/rooflines/<name>.py


@dataclasses.dataclass
class Outcome:
    """What a task's run measured and checked."""

    attempted: int
    failed: int
    values: dict  # the end-to-end metrics' values, by name
    peak_bytes: int
    checks: List[dict]  # the decisive numbers: {"name", "value", "limit"}
    diagnostics: dict  # numbers printed beside them that decide nothing
    counters: dict
    block: Optional[tracing.Block] = None


def card_peaks(root: Path, kind: str) -> Optional[dict]:
    rows = json.loads((root / BENCH / "peaks.json").read_text())
    return next((r for r in rows if r["match"] in kind), None)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str, t_start: float) -> dict:
    """One run: the result's fields, with ``diagnostics`` and, last,
    ``checks``, the numbers that decide ``correct`` beside their limits."""
    dev = torch.device(device)
    cell = load_cell(root, workload)
    out = task_module(cell).run(cell, dev, seed, seconds, trace, t_start)
    result = {
        "correct": all(r["value"] <= r["limit"] for r in out.checks),
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": {},
        "device": device_info(dev, out.peak_bytes),
    }
    if not trace:
        result["metrics"] = {m["name"]: {"value": out.values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
    else:
        ctx = Context(cell.config, out.block, out.counters, card_peaks(root, result["device"]["kind"]),
                      lambda name: load_module(cell.path("rooflines", f"{name}.py"),
                                               f"portbench_roofline_{name}"))
        for m in cell.per_layer:
            reader = load_module(cell.path("metrics", f"{m['name']}.py"), f"portbench_metric_{m['name']}")
            v = reader.read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        if out.block is not None:
            result["device"].update(busy_s=out.block.busy_s, window_s=out.block.window_s)
            result["breakdown"] = tracing.breakdown(out.block)
    result["diagnostics"] = out.diagnostics
    result["checks"] = {r["name"]: {"value": r["value"], "limit": r["limit"]} for r in out.checks}
    return result


def device_info(dev: torch.device, peak_bytes: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak_bytes}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": peak_bytes}
