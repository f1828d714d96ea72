"""The per-layer readers on a canned profiler trace, and the frozen work
counts pinned to hand-computed values."""

import json
import pytest
from conftest import ROOT

from portbench import harness, tracing

CONFIG = {"n_particles": 65536, "filter": {"block_size": 4}, "record_elems": 1, "state_floats": 1, "step_flops": 8}
PEAKS = {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12}


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def canned_trace():
    """Two generations: a model-step kernel each, an index kernel, a
    clone, an append; one kernel launched before the block."""
    return {"traceEvents": [
        _x("user_annotation", tracing.BLOCK, 1000, 1000),
        _x("user_annotation", tracing.STEP, 1100, 50),
        _x("user_annotation", tracing.STEP, 1600, 50),
        _x("cpu_op", "aten::mul", 1110, 10),
        _x("cpu_op", "aten::index", 1300, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 900, 2, correlation=4),
        _x("cuda_runtime", "cudaLaunchKernel", 1112, 2, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 1305, 2, correlation=2),
        _x("cuda_driver", "cuLaunchKernel", 1400, 2, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 1605, 2, correlation=5),
        _x("kernel", "mul_kernel", 1000, 50, tid=7, correlation=4),
        _x("kernel", "mul_kernel", 1200, 100, tid=7, correlation=1),
        _x("kernel", "index_kernel", 1300, 200, tid=7, correlation=2),
        _x("kernel", "void (anonymous namespace)::clone_chain_kernel<4>(float const*)", 1600, 100, tid=7,
           correlation=3),
        _x("kernel", "void cow_write_kernel<4, 1>(unsigned int*)", 1750, 50, tid=7, correlation=5),
    ]}


def context(block, peak_blocks=(30, 45), pool=100, peaks=PEAKS):
    def roofline(name):
        return harness.load_module(ROOT / "portbench" / "rooflines" / f"{name}.py", f"roof_{name}")

    return harness.Context(CONFIG, block, {"peak_blocks": list(peak_blocks), "pool_blocks": pool}, peaks, roofline)


def reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", f"metric_{name}").read


def test_block_from_a_canned_trace():
    b = tracing.read_block(canned_trace(), generations=2, first_generation=10)
    assert [op.name[:12] for op in b.ops] == ["mul_kernel", "index_kernel", "void (anonym", "void cow_wri"]
    assert [op.in_step for op in b.ops] == [True, False, False, True]
    assert b.busy_s == pytest.approx(450e-6) and b.window_s == pytest.approx(600e-6)
    assert b.ops[1].host == "filter loop / aten::index"
    assert tracing.by_span(b) == {"filter loop": pytest.approx(300e-6),
                                  "portbench.model_step": pytest.approx(150e-6)}
    bd = tracing.breakdown(b)
    assert bd["device_ops"][0] == ["index_kernel", pytest.approx(200e-6)]
    assert bd["idle_gaps"] == [["filter loop", pytest.approx(100e-6)],
                               ["portbench.model_step", pytest.approx(50e-6)]]


def test_readers_on_a_canned_trace():
    ctx = context(tracing.read_block(canned_trace(), generations=2, first_generation=10))
    assert reader("step_share")(ctx) == pytest.approx(100 * 150 / 450)
    assert reader("launches_per_gen")(ctx) == 2.0
    assert reader("device_idle")(ctx) == pytest.approx(25.0)
    assert reader("pool_fill")(ctx) == pytest.approx(45.0)
    # clones start generations 11 and 12: 3 live blocks each
    least = 65536 * (8 + 8 * 3) / 3.35e12
    assert reader("clone_chain_roofline")(ctx) == pytest.approx(100 * least / 100e-6)
    assert reader("cow_write_roofline")(ctx) == pytest.approx(100 * 65536 * 16 / 3.35e12 / 50e-6)
    assert reader("mfu.gen")(ctx) == pytest.approx(100 * 65536 * 28 / 3.35e12 / 300e-6)


@pytest.mark.parametrize("name", ["step_share", "launches_per_gen", "device_idle", "clone_chain_roofline",
                                  "cow_write_roofline", "mfu.gen"])
def test_readers_find_nothing_without_a_trace(name):
    assert reader(name)(context(None)) is None


def test_rooflines_need_the_cards_peaks():
    ctx = context(tracing.read_block(canned_trace(), 2, 10), peaks=None)
    assert all(reader(n)(ctx) is None for n in ("clone_chain_roofline", "cow_write_roofline", "mfu.gen"))


def test_every_per_layer_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def _roof(name):
    return harness.load_module(ROOT / "portbench" / "rooflines" / f"{name}.py", f"pin_{name}")


def test_frozen_work_counts():
    # 4 B of CDF + 4 B of ancestor a particle, and 128 live ids read and written
    assert _roof("clone_chain").least_bytes(65536, 128) == 67_633_152
    assert _roof("cow_write").least_bytes(4_194_304, 4) == 67_108_864
    # lgssm: state 4+4, log-weight 4+4, ancestor 4+4, record 4
    assert _roof("generation").least_bytes(4_194_304, 1, 1) == 117_440_512
    # rbpf: state 28+28, log-weight 8, ancestor 8, record 24
    assert _roof("generation").least_bytes(4_194_304, 7, 6) == 402_653_184
    cfg = json.loads((ROOT / "portbench" / "configs" / "lgssm.json").read_text())
    assert _roof("clone_chain").least_seconds(cfg, 481, PEAKS) == pytest.approx(
        4_194_304 * (8 + 8 * 121) / 3.35e12)
    assert _roof("generation").least_seconds(cfg, PEAKS) == pytest.approx(117_440_512 / 3.35e12)


def test_peaks_table_matches_the_card_name():
    assert harness.card_peaks(ROOT, "NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert harness.card_peaks(ROOT, "NVIDIA H100 PCIe")["hbm_bytes_per_s"] == 2.0e12
    assert harness.card_peaks(ROOT, "NVIDIA A100-SXM4-80GB") is None
