"""A configuration, a traffic mix or a per-layer metric dropped into a
copy of the benchmark as a file is found by its name."""

import json
import time

import pytest

from perfbench import harness

from conftest import TINY


def test_cell_files_found_by_name(tiny_root):
    work, cfg, traffic, e2e, per_layer = harness.load_cell(TINY, tiny_root)
    assert work["config"] == "tiny" and cfg["name"] == "tiny"
    assert cfg["multilevelmc"]["chunk_size"] == 8
    assert traffic == {"chains": 8}
    assert [m["name"] for m in e2e] == ["samples_per_s", "time_to_eps_s",
                                        "setup_s"]
    # level_us.mid names its cell: the tiny cell does not report it
    assert "level_us.mid" not in [m["name"] for m in per_layer]
    with pytest.raises(harness.CellError):
        harness.load_cell("tiny.none", tiny_root)


def test_metric_file_found_by_name(tiny_root):
    (tiny_root / "perfbench/metrics/rounds_seen.py").write_text(
        "def read(run):\n    return float(run.rounds)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "rounds_seen", "unit": "rounds", "better": "higher",
        "source": "host_clock", "layer": "device", "moves": "samples_per_s",
        "workloads": [TINY]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    res, info = harness.run_cell(TINY, 3, 0.01, True,
                                 t_start=time.monotonic(), device="cpu",
                                 root=tiny_root)
    m = res["metrics"]
    assert m["rounds_seen"] == {"value": float(info["rounds"]),
                                "unit": "rounds"}
    assert m["tau_int.fine"]["value"] >= 1.0
    assert m["level_us.fine"]["unit"] == "us/sample"
    # the CPU runs no kernel: the rooflines find nothing to read
    assert "k4_roofline" not in m and "k3_roofline" not in m
    assert res["correct"] is True
    assert list(res)[-1] == "check"
