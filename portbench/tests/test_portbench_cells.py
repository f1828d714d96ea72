"""A cell found by name and run end to end on the CPU (tiny sizes)."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
from conftest import ROOT, TINY

from portbench import harness

SEED = 2**31 + 12345  # larger than 32 signed bits hold


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_new_cell_files_are_found_and_run(tiny_root, cell, trace):
    result = harness.run_cell(tiny_root, cell, SEED, 0.2, bool(trace), "cpu", time.perf_counter())
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "diagnostics", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    if trace:
        # No device trace on the CPU: only the program's counter reads.
        assert set(result["metrics"]) == {"pool_fill"}
        assert 0 < result["metrics"]["pool_fill"]["value"] <= 100
    else:
        assert set(result["metrics"]) == {m["name"] for m in bench["end_to_end"]}
        assert all(v["value"] > 0 for k, v in result["metrics"].items() if k != "peak_mem_GiB")
    assert set(result["checks"]) == {"logz_gap", "smooth_gap", "oom_runs"}
    assert result["diagnostics"] == {"logw_gap": 0.0, "traj_mismatch": 0}
    json.dumps(result)


def test_same_seed_same_inputs(tiny_root):
    cell = harness.load_cell(tiny_root, "tiny_lgssm.infer")
    prog = harness.task_module(cell).Program(cell, harness.torch.device("cpu"))
    a, b = prog.inputs(SEED, 3), prog.inputs(SEED, 3)
    assert a[0].equal(b[0]) and a[2].equal(b[2])
    assert harness.torch.rand(4, generator=a[1]).equal(harness.torch.rand(4, generator=b[1]))
    assert not prog.inputs(SEED, 4)[0].equal(a[0])


def test_unknown_traffic_is_refused(tmp_path):
    from conftest import write_tiny_root

    root = write_tiny_root(tmp_path)
    path = root / "portbench" / "traffic" / "closed_infer.json"
    traffic = json.loads(path.read_text())
    path.write_text(json.dumps({**traffic, "task": "simulate"}))
    with pytest.raises(ValueError, match="task"):
        harness.task_module(harness.load_cell(root, "tiny_lgssm.infer"))


def _add_cell(root, cell, config, traffic):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "test"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_traffic_file_sets_the_filter(tmp_path):
    """A mix of adaptive resampling is a traffic file and an entry alone."""
    from conftest import write_tiny_root

    root = write_tiny_root(tmp_path)
    traffic = json.loads((root / "portbench" / "traffic" / "closed_infer.json").read_text())
    traffic["filter"] = {"always_resample": False, "ess_threshold": 0.5, "block_size": 2}
    (root / "portbench" / "traffic" / "adaptive.json").write_text(json.dumps(traffic))
    _add_cell(root, "tiny_lgssm.adaptive", "tiny_lgssm", "adaptive")
    cell = harness.load_cell(root, "tiny_lgssm.adaptive")
    fcfg = harness.task_module(cell).Program(cell, harness.torch.device("cpu")).fcfg
    assert (fcfg.always_resample, fcfg.ess_threshold, fcfg.block_size) == (False, 0.5, 2)
    result = harness.run_cell(root, "tiny_lgssm.adaptive", SEED, 0.1, False, "cpu", time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["diagnostics"] == {"logw_gap": 0.0, "traj_mismatch": 0}


def test_a_task_file_is_found_by_name(tmp_path):
    from conftest import write_tiny_root

    root = write_tiny_root(tmp_path)
    (root / "portbench" / "tasks" / "canned.py").write_text(
        "from portbench import harness\n\n\n"
        "def run(cell, dev, seed, seconds, trace, t_start):\n"
        "    values = {m['name']: 1.0 + seed for m in cell.end_to_end}\n"
        "    return harness.Outcome(1, 0, values, 0, [{'name': 'same', 'value': 0, 'limit': 0}], {}, {})\n")
    (root / "portbench" / "traffic" / "canned.json").write_text(json.dumps({"task": "canned"}))
    _add_cell(root, "tiny_lgssm.canned", "tiny_lgssm", "canned")
    result = harness.run_cell(root, "tiny_lgssm.canned", 2, 1.0, False, "cpu", time.perf_counter())
    assert result["correct"] is True and result["metrics"]["setup_s"]["value"] == 3.0


def _cli(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_prints_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would run")
    proc = _cli(ROOT, "--workload", "lgssm.infer", "--seed", str(SEED), "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_cli_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _cli(tmp_path, "--workload", "lgssm.infer", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert proc.returncode != 0 and proc.stdout == ""


def test_benchmark_json_keeps_to_its_schema():
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

    def line(text):
        return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text

    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert line(c["source"]) and line(c["why"]) and (ROOT / c["file"]).is_file()
        assert all(name.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and name.match(w["name"])
        assert w["chips"] in (1, 4) and line(w["why"]) and name.match(w["traffic"])
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert line(m["layer"]) and m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
