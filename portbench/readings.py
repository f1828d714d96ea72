"""The readings a comparison's limits are set from, at a cell's own size.

    python3 portbench/readings.py --workload <cell> --seeds 12 --control-seeds 3 [--first-seed S]

For each of ``--seeds`` seeds, one filter run of the program, as a
window runs it (its sample and all N trajectories read back), and the
plain reference on the same inputs; then, in the program's place:

``program``
    the program itself;
``flat``
    the reference in float32 with the CDF in another order (a plain
    scan): a sound change of the order of the float32 operations;
``float64``
    the reference in float64: a sound change of every rounding;
``control``
    the reference in bfloat16, on the first ``--control-seeds`` seeds.

``program``, ``flat`` and ``float64`` are sound: the largest of their
readings is a number's lower reading.  The control's smallest is its
upper reading.  One process, so the set-up is paid once.  Prints one
JSON line a reading, and the largest sound and smallest control reading
of each number last; the benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: what stands in the program's place: (kind, dtype name, CDF order)
STAND_INS = (("flat", "float32", "flat"), ("float64", "float64", "rows"))
SOUND = ("program", "flat", "float64")


def reference_outputs(prog, seed: int, k: int, dtype, cdf: str = "rows"):
    """Run ``k``'s outputs as the reference in ``dtype`` gives them."""
    import torch

    from portbench import check

    res = prog.reference_run(seed, k, dtype, cdf)
    _, _, ids = prog.inputs(seed, k)
    return check.RunOutputs(res.log_evidence, res.log_weights, torch.zeros((), dtype=torch.bool),
                            ids, (res.digests[0][ids], res.digests[1][ids]), res.digests, res.smooth,
                            res.var)


def readings(root: Path, workload: str, seeds, control_seeds, device: str):
    """Yields ``(kind, seed, numbers)``: for each seed ``program``, then
    ``flat`` and ``float64``; ``control`` for the control seeds."""
    import torch

    from portbench import check, harness

    dev = torch.device(device)
    cell = harness.load_cell(root, workload)
    prog = harness.task_module(cell).Program(cell, dev)
    prog.warm_up(seeds[0])
    for seed in seeds:
        out, res = prog.run(seed, 0, [])
        prog.read_back(out, res)
        res = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = prog.reference_run(seed, 0)
        yield "program", seed, check.numbers([out], [ref])
        for kind, dtype, cdf in STAND_INS:
            got = reference_outputs(prog, seed, 0, getattr(torch, dtype), cdf)
            yield kind, seed, check.numbers([got], [ref])
        if seed in control_seeds:
            yield "control", seed, check.numbers([reference_outputs(prog, seed, 0, torch.bfloat16)], [ref])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1_000_003)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    controls = seeds[: args.control_seeds]
    worst = {"sound": {}, "control": {}}
    for kind, seed, nums in readings(ROOT, args.workload, seeds, controls, "cuda"):
        print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed, **nums}), flush=True)
        side, pick = ("sound", max) if kind in SOUND else ("control", min)
        for k, v in nums.items():
            worst[side][k] = pick(worst[side].get(k, v), v)
    print(json.dumps({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                      "largest_sound": worst["sound"], "smallest_control": worst["control"],
                      "seconds": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
