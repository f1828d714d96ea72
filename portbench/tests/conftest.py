"""Fixtures of the benchmark's own tests (CPU; ``cuda``-marked tests
decide in a fixture whether there is a card)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: tiny cells, one a configuration: (cell, configuration file, N, T)
TINY = {"tiny_lgssm.infer": ("lgssm", 64, 16), "tiny_rbpf.infer": ("rbpf", 128, 200)}


def write_tiny_root(root: Path, cells=TINY) -> Path:
    """A copy of the benchmark's files with tiny cells added as new files
    and entries only."""
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (config, n, t) in cells.items():
        name = cell.split(".")[0]
        cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
        cfg.update(name=name, n_particles=n, n_steps=t)
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "file": f"portbench/configs/{name}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": cell, "config": name, "traffic": "closed_infer",
                                   "chips": 1, "why": "test"})
        for m in bench["per_layer"]:
            m.setdefault("workloads", []).append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return write_tiny_root(tmp_path_factory.mktemp("portbench_root"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
