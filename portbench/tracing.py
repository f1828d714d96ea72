"""The profiled block of a ``--trace 1`` run, read from the profiler's trace.

The harness profiles a block of consecutive generations in the middle of
the window's first filter run (``torch.profiler``, CPU and CUDA
activities), marking the block and every model step with
``record_function`` spans, and the store's and resampling's calls with
spans of their own (:data:`SPANS`).  :func:`read_block` turns the
exported Chrome trace into the device operations launched inside the
block, each with its duration, whether the model step launched it, and
what the host was doing when it was launched.  The per-layer readers
(``portbench/metrics/*.py``) take their numbers from that.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional

BLOCK = "portbench.block"
STEP = "portbench.model_step"
#: program functions wrapped in spans of these names in a traced run
#: (module, attribute): the filter looks each up at call time.
SPANS = (
    ("repro_torch.core.store", "clone_chain"),
    ("repro_torch.core.store", "append"),
    ("repro_torch.core.store", "used_blocks"),
    ("repro_torch.smc.resampling", "normalize"),
    ("repro_torch.smc.resampling", "ess"),
)
DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # kernel | memcpy | memset
    start_us: float
    dur_us: float
    in_step: bool  # launched inside a model step
    host: str  # what the host was running at the launch


@dataclasses.dataclass
class Block:
    """The device operations launched inside the profiled block."""

    ops: List[DeviceOp]
    generations: int
    first_generation: int
    busy_s: float  # union of the operations' intervals
    window_s: float  # first operation's start to last one's end
    untraced_launches: int  # operations whose launch the trace lacks

    @property
    def kernels(self) -> List[DeviceOp]:
        return [op for op in self.ops if op.kind == "kernel"]


def _label(stack: list) -> str:
    span = next((s["name"] for s in reversed(stack)
                 if s["name"].startswith("portbench.") and s["name"] != BLOCK), "filter loop")
    op = stack[-1]["name"] if stack and stack[-1]["cat"] == "cpu_op" else ""
    return f"{span} / {op}" if op else span


def read_block(trace: dict, generations: int, first_generation: int) -> Optional[Block]:
    """The block in a Chrome trace (``export_chrome_trace``'s JSON), or
    None when the trace holds no block span or no device operation."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    blocks = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == BLOCK]
    if not blocks:
        return None
    blk = blocks[0]
    b0, b1, tid = blk["ts"], blk["ts"] + blk["dur"], blk["tid"]
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e["ts"]
    host = sorted((e for e in events if e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e is not blk), key=lambda e: (e["ts"], -e["dur"]))
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in host if e["name"] == STEP)
    step_starts = [s for s, _ in steps]

    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    traced, untraced = [], []
    for e in device:
        at = launches.get(e.get("args", {}).get("correlation"))
        (traced if at is not None else untraced).append((at, e))
    inside = sorted(((at, e) for at, e in traced if b0 <= at <= b1), key=lambda x: x[0])
    if not inside:
        return None

    # What the host was running at each launch: the innermost open span.
    ops, stack, i = [], [], 0
    for at, e in inside:
        while i < len(host) and host[i]["ts"] <= at:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < host[i]["ts"]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < at:
            stack.pop()
        k = bisect.bisect_right(step_starts, at) - 1
        in_step = k >= 0 and at <= steps[k][1]
        ops.append(DeviceOp(e["name"], DEVICE_CATS[e["cat"]], e["ts"], e["dur"], in_step, _label(stack)))

    # Operations whose launch the trace lacks count where they ran inside
    # the block's device span; no model step is credited with them.
    lo = min(op.start_us for op in ops)
    hi = max(op.start_us + op.dur_us for op in ops)
    extra = [e for _, e in untraced if lo <= e["ts"] <= hi]
    ops += [DeviceOp(e["name"], DEVICE_CATS[e["cat"]], e["ts"], e["dur"], False, "(launch not traced)")
            for e in extra]
    ops.sort(key=lambda op: op.start_us)
    busy, end = 0.0, -float("inf")
    for op in ops:
        s, f = op.start_us, op.start_us + op.dur_us
        if f > end:
            busy += f - max(s, end)
            end = f
    window = max(op.start_us + op.dur_us for op in ops) - ops[0].start_us
    return Block(ops, generations, first_generation, busy / 1e6, window / 1e6, len(extra))


def by_span(block: Block) -> Dict[str, float]:
    """Device seconds of the block's operations by the span that launched them."""
    out: Dict[str, float] = defaultdict(float)
    for op in block.ops:
        out[op.host.split(" / ")[0]] += op.dur_us / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def breakdown(block: Block, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle gaps
    summed by what the host was doing when the gap ended, in seconds."""
    busy: Dict[str, float] = defaultdict(float)
    for op in block.ops:
        busy[op.name[:96]] += op.dur_us / 1e6
    gaps: Dict[str, float] = defaultdict(float)
    end = block.ops[0].start_us
    for op in block.ops:
        if op.start_us > end:
            gaps[op.host] += (op.start_us - end) / 1e6
        end = max(end, op.start_us + op.dur_us)
    def first(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": first(busy), "idle_gaps": first(gaps)}
