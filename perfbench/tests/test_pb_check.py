"""The check passes the program and fails its control and every planted
fault, on a tiny cell on the CPU; on the card the same, through
``run.py``."""

import json
import os
import subprocess
import sys
import time

import pytest

from perfbench import check, control, harness

from conftest import ROOT, TINY, make_tiny_root


@pytest.mark.parametrize("mode", control.MODES)
def test_sound_passes_control_and_faults_fail(tiny_root, mode):
    res, info = harness.run_cell(TINY, 21, 0.01, False,
                                 t_start=time.monotonic(), device="cpu",
                                 root=tiny_root,
                                 **control.cell_hooks(TINY, mode, tiny_root))
    assert res["correct"] is (mode == "sound"), res["check"]
    assert list(res["check"]) == list(check.NUMBERS)
    if mode == "sound":
        # the plain versions on the CPU are the reference's arithmetic
        assert all(v == 0.0 for v, _ in res["check"].values())
    if mode in ("control", "lagged"):
        # the statistics' own number fails them
        assert res["check"]["stats_disagree"][0] == 1.0


def test_no_checked_chunk_is_not_correct():
    cfg = {"beta": 4.0, "Mt_lat": 8, "Mx_lat": 8,
           "multilevelmc": {"n_level": 2}, "check": {"steps": 1}}
    numbers, levels = check.judge(cfg, [8, 8], {}, [10, 10], [10, 10])
    assert numbers["sweep0_departed"] == 1.0
    ok, table, failed = check.verdict(
        numbers, levels, dict.fromkeys(check.NUMBERS, 0.0))
    assert not ok and failed == 2
    numbers, levels = check.judge(cfg, [8, 8], {}, [5, 10], [10, 10])
    assert numbers["samples_missing"] == 0.5


def test_verdict_reads_every_limit():
    numbers = {"a": 0.0, "b": 0.5}
    levels = [dict(numbers), {"a": 0.0, "b": 0.0}]
    ok, table, failed = check.verdict(numbers, levels, {"b": 0.1, "a": 0.0})
    assert not ok and failed == 1 and list(table) == ["b", "a"]
    # a number that the limits name and the judge omits, overall or on a
    # level, and a number with no limit, pass unread: refused
    for nums, lvs, limits in (
            ({"a": 0.0}, [{"a": 0.0}], {"a": 0.0, "b": 0.0}),
            (numbers, [{"a": 0.0}], {"a": 0.0, "b": 0.0}),
            (numbers, levels, {"a": 0.0})):
        with pytest.raises(harness.CellError):
            check.verdict(nums, lvs, limits)


@pytest.mark.chip
def test_run_on_the_card(card, tmp_path):
    root = make_tiny_root(tmp_path)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", TINY,
         "--seed", "4000000001", "--seconds", "1", "--trace", "1"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["check"]
    assert res["device"]["platform"] == "gpu"
    assert 0.0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert "k4_roofline" in res["metrics"]
    assert 0.0 < res["metrics"]["other_kernels_share"]["value"] < 100.0
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.chip
@pytest.mark.parametrize("mode", ["control", "half", "lagged"])
def test_control_fails_on_the_card(card, tmp_path, mode):
    root = make_tiny_root(tmp_path)
    res, _ = harness.run_cell(TINY, 4000000002, 0.01, False,
                              t_start=time.monotonic(), device="cuda",
                              root=root,
                              **control.cell_hooks(TINY, mode, root))
    assert res["correct"] is False
