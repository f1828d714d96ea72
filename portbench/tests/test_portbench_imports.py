"""What the benchmark loads: no JAX, no JAX package (top-level names
compared whole: the port's own name begins with ``repro``), and a
reference that loads nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest
from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _run(code: str) -> dict:
    env_path = f"{ROOT}:{ROOT / 'src'}"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin"}, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_whole_run_loads_no_jax_nor_the_jax_package(tmp_path):
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'portbench' / 'tests')!r}]
from pathlib import Path
from conftest import write_tiny_root
from portbench import harness
root = write_tiny_root(Path({str(tmp_path)!r}))
for cell in ("tiny_lgssm.infer", "tiny_rbpf.infer"):
    for trace in (False, True):
        harness.run_cell(root, cell, 7, 0.05, trace, "cpu", time.perf_counter())
print(json.dumps({{"top": sorted({{m.split(".")[0] for m in sys.modules}}),
                   "forbidden": harness.forbidden_modules()}}))
"""
    got = _run(code)
    assert got["forbidden"] == [] and not BANNED & set(got["top"])
    assert "repro_torch" in got["top"]  # the port itself was loaded


def test_the_reference_loads_nothing_of_the_port():
    code = """
import json, sys
import portbench.reference.filter, portbench.reference.digest
from portbench import harness
for name in ("lgssm", "rbpf"):
    harness.load_module(harness.Path("portbench/reference") / f"{name}.py", name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    top = set(_run(code))
    assert not (BANNED | {"repro_torch"}) & top


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_nothing_of_the_port(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        assert not {n.split(".")[0] for n in names} & (BANNED | {"repro_torch"}), (path.name, names)
