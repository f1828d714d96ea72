"""The comparison that decides ``correct``: the plain reference against
the port's CPU path, the control, and planted faults (tiny sizes)."""

import time

import pytest
import torch
from conftest import TINY

from portbench import check, harness, readings
from portbench.reference.digest import Digest

SEED = 3_000_000_019


@pytest.mark.parametrize("cell", sorted(TINY))
def test_reference_matches_port_and_the_control_fails(tiny_root, cell):
    limits = harness.load_cell(tiny_root, cell).config["limits"]
    got = list(readings.readings(tiny_root, cell, [SEED, SEED + 1], [SEED, SEED + 1], "cpu"))
    assert {kind for kind, _, _ in got} == {"program", "flat", "float64", "control"}
    for kind, _, nums in got:
        if kind == "program":  # the reference's own order: 0 up to the order of a sum
            assert check.judge(nums, limits)[0] and _same(nums), nums
        if kind == "control":
            assert not check.judge(nums, limits)[0], nums
            assert nums["logz_gap"] > 0 and nums["traj_mismatch"] > 0


def _same(nums):
    """The program and the reference in one order: equal log Z, weights and
    trajectories; the smoothing means differ only by how a sum is ordered."""
    return (nums["logz_gap"] == nums["logw_gap"] == nums["traj_mismatch"] == nums["oom_runs"] == 0
            and nums["smooth_gap"] < 1e-9)


def _break_step(monkeypatch, fault):
    """Wrap every filter's model step with ``fault(state, (state', dlogw, record))``."""
    from repro_torch.smc import filters

    init = filters.ParticleFilter.__init__

    def patched(self, ssm, config, device=None):
        step = ssm.step

        def broken(gen, state, t, y, params):
            return fault(state, step(gen, state, t, y, params))

        init(self, ssm._replace(step=broken), config, device)

    monkeypatch.setattr(filters.ParticleFilter, "__init__", patched)


def _state_unchanged(state, out):
    return (state, *out[1:])


def _half_batch(state, out):
    new, dlogw, record = out
    n = dlogw.shape[0]
    dlogw = dlogw.clone()
    dlogw[n // 2 :] = dlogw[: n - n // 2]  # the second half stands in for the mean of the first
    return new, dlogw, record


def _lineage_broken(monkeypatch):
    """The state is gathered by other ancestors than the store's tables
    are cloned by: every lineage read back is spliced."""
    from repro_torch.smc import filters

    clone = filters._default_clone

    def other(state, ancestors):
        return clone(state, torch.roll(ancestors, ancestors.shape[0] // 2))

    monkeypatch.setattr(filters, "_default_clone", other)


def _answer_altered(monkeypatch, cell):
    """Every particle's record of one generation altered as it is written."""
    from repro_torch.core import store

    append = store.append
    at = TINY[cell][2] // 2

    def altered(cfg, st, values):
        if int(st.lengths[0]) == at:
            values = values + 1.0
        return append(cfg, st, values)

    monkeypatch.setattr(store, "append", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered", "lineage_broken"])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_planted_faults_are_not_correct(tiny_root, cell, fault, monkeypatch):
    if fault == "answer_altered":
        _answer_altered(monkeypatch, cell)
    elif fault == "lineage_broken":
        _lineage_broken(monkeypatch)
    else:
        _break_step(monkeypatch, {"state_unchanged": _state_unchanged, "half_batch": _half_batch}[fault])
    result = harness.run_cell(tiny_root, cell, SEED, 0.05, False, "cpu", time.perf_counter())
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("elems", [1, 6])
def test_forward_digest_equals_whole_trajectory_digest(elems):
    gen = torch.Generator().manual_seed(5)
    n, t = 32, 9
    records = torch.randn((t, n, elems), generator=gen)
    d = Digest(t, elems, "cpu")
    h = d.empty(n, "cpu")
    for r in records:
        h = d.step(h, r)
    whole = d.whole(records.permute(1, 0, 2))
    assert h[0].equal(whole[0]) and h[1].equal(whole[1])
    flipped = records.clone()
    flipped[4, 7, 0] = torch.nextafter(flipped[4, 7, 0], torch.tensor(float("inf")))
    w2 = d.whole(flipped.permute(1, 0, 2))
    assert (w2[0] != whole[0]).tolist() == [i == 7 for i in range(n)]


def test_nan_fails_every_limit():
    ok, rows = check.judge({"logz_gap": float("nan"), "smooth_gap": 0.0, "oom_runs": 0},
                           {"logz_gap": 1.0, "smooth_gap": 1.0, "oom_runs": 0})
    assert ok is False and rows[0]["name"] == "logz_gap"


def test_diagnostics_decide_nothing():
    ok, rows = check.judge({"logz_gap": 0.0, "smooth_gap": 0.0, "oom_runs": 0, "logw_gap": 3.0,
                            "traj_mismatch": 7}, {"logz_gap": 0.0, "smooth_gap": 0.0, "oom_runs": 0})
    assert ok is True and [r["name"] for r in rows] == list(check.DECISIVE)


def test_smooth_gap_in_units_of_the_spread():
    m = torch.tensor([[1.0, 5.0], [2.0, 5.0]], dtype=torch.float64)
    v = torch.tensor([[0.02, 0.0], [0.08, 0.0]], dtype=torch.float64)
    assert check.smooth_gap((m.clone(), v), (m, v)) == 0.0
    got = m.clone()
    got[1, 0] += 0.1  # sqrt(0.08 + 0.08 + (2e-3)^2)
    assert check.smooth_gap((got, v), (m, v)) == pytest.approx(0.1 / (0.16 + 4e-6) ** 0.5)
    got[0, 1] += 1e-2  # an element every particle shares: its floor, 1e-3 of its mean
    assert check.smooth_gap((got, v), (m, v)) == pytest.approx(1e-2 / 5e-3)


def test_smoothing_means_follow_the_ancestry():
    from portbench.reference import filter as reference_filter

    records = torch.tensor([[[1.0], [2.0]], [[3.0], [4.0]]])  # [T 2, N 2, E 1]
    ancestors = torch.tensor([[0, 1], [1, 1]], dtype=torch.int32)  # both descend from particle 1
    logw = torch.log(torch.tensor([0.25, 0.75]))
    smooth, var = reference_filter.smoothing(records, ancestors, logw)
    assert smooth[:, 0].tolist() == pytest.approx([2.0, 0.25 * 3 + 0.75 * 4])
    assert var[:, 0].tolist() == pytest.approx([0.0, 0.25 * 0.75])


@pytest.mark.cuda
def test_port_against_reference_on_the_card(card, tmp_path):
    """At N = 2^16 on the card: the program reads 0 against the
    reference, and the control fails."""
    from conftest import write_tiny_root

    root = write_tiny_root(tmp_path, {"card_lgssm.infer": ("lgssm", 65536, 256),
                                      "card_rbpf.infer": ("rbpf", 65536, 500)})
    for cell in ("card_lgssm.infer", "card_rbpf.infer"):
        limits = harness.load_cell(root, cell).config["limits"]
        for kind, _, nums in readings.readings(root, cell, [SEED], [SEED], "cuda"):
            if kind == "program":
                assert check.judge(nums, limits)[0] and _same(nums), (cell, nums)
            if kind == "control":
                assert not check.judge(nums, limits)[0], (cell, nums)
