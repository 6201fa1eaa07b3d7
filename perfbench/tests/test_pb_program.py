"""The readers of the program's own spans and counters (``program.py``):
each new metric on a hand-made trace and hand-made spans, window
selection, and the tiny cell's runs (the traced one reports every new
metric, the untraced one none); on the card the same through ``run.py``,
and the clock check: each K3 and K4 launch's device interval starts after
the host span of its launch, on the one clock."""

import bisect
import json
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from perfbench import harness, program
from perfbench.trace import Trace

from conftest import ROOT, TINY, make_tiny_root

#: the new metrics and the cells that report them
NEW = ("accept.fine", "accept.mid", "k4_rounds_per_draw",
       "k3_rounds_per_draw", "k4_round_yield", "k3_round_yield",
       "host_us.launch", "host_us.stats", "idle_in_launch_share",
       "idle_in_stats_share")


def _span(name, start, end, **attrs):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end,
                           attrs=attrs)


#: device busy [10, 30], [40, 60], [95, 100] of the window [0, 100];
#: gaps [0, 10] (middle 5), [30, 40] (35), [60, 95] (77.5)
EVENTS = [("k4", 10, 30), ("k3", 40, 60), ("x", 95, 130)]
SPANS = [
    _span("level1.chunk", 0, 20),
    _span("k3.launch", 2, 8, rounds=[[10, 14, 20]]),
    _span("level1.stats", 8, 20),
    _span("level0.chunk", 20, 90, accepts=3.0, screens=8),
    _span("k4.launch", 30, 36, rounds=[[4, 6, 8], [2, 2, 4], [0, 0, 0]]),
    _span("level0.stats", 70, 90),
    # outside the window: left out
    _span("k4.launch", 105, 110, rounds=[[100, 900, 900]] * 3),
    _span("level0.chunk", -10, 5, accepts=8.0, screens=8),
]


@pytest.fixture
def run(monkeypatch):
    monkeypatch.setattr(program, "recorded", lambda: SPANS)
    return harness.Run(chains=4, window_s=100e-9, rounds=1, levels=[],
                       trace=Trace(EVENTS, 0, 100, []))


def test_window_selection(run):
    sel = program.window_spans(run, ("k4.launch", "level0.chunk"))
    assert [(s.name, s.start_ns) for s in sel] == [("level0.chunk", 20),
                                                   ("k4.launch", 30)]
    assert program.window_spans(run, program.is_stats)[0].name \
        == "level1.stats"
    assert program.window_spans(harness.Run(4, 1.0, 1, []), ("k4.launch",)) \
        == []


def test_readers_by_hand(run):
    read = {n: harness.metric_reader(n)(run) for n in NEW}
    assert read["accept.fine"] == 100.0 * 3 / 8
    assert read["accept.mid"] is None          # level 1 screens nothing
    assert read["k4_rounds_per_draw"] == 8 / 6
    assert read["k4_round_yield"] == 100.0 * 8 / 12
    assert read["k3_rounds_per_draw"] == 14 / 10
    assert read["k3_round_yield"] == 100.0 * 14 / 20
    assert read["host_us.launch"] == 1e-3 * (6 + 6) / 2
    assert read["host_us.stats"] == 1e-3 * (12 + 20) / 2
    # the gap [0, 10] (middle 5) in k3.launch [2, 8]; [30, 40] (35) in
    # k4.launch [30, 36]; [60, 95] (77.5) in level0.stats [70, 90]
    assert abs(read["idle_in_launch_share"] - 20.0) < 1e-9
    assert abs(read["idle_in_stats_share"] - 35.0) < 1e-9


def test_readers_find_nothing_without_a_record(monkeypatch):
    monkeypatch.setattr(program, "recorded", lambda: None)
    run = harness.Run(4, 1e-7, 1, [], trace=Trace(EVENTS, 0, 100, []))
    assert all(harness.metric_reader(n)(run) is None for n in NEW)


def test_tiny_cell_reports_the_new_metrics_traced_only(tiny_root):
    new = [n for n in NEW if n != "accept.mid"]
    res, _ = harness.run_cell(TINY, 5, 0.01, True, t_start=time.monotonic(),
                              device="cpu", root=tiny_root)
    m = res["metrics"]
    assert res["correct"] is True
    assert all(n in m for n in new), sorted(m)
    assert "accept.mid" not in m
    assert 0.0 < m["accept.fine"]["value"] < 100.0
    assert m["k4_rounds_per_draw"]["value"] > 1.0
    assert m["k3_round_yield"]["unit"] == "%"
    res, _ = harness.run_cell(TINY, 5, 0.01, False,
                              t_start=time.monotonic(), device="cpu",
                              root=tiny_root)
    assert not any(n in res["metrics"] for n in NEW)


@pytest.mark.chip
def test_new_metrics_on_the_card(card, tmp_path):
    root = make_tiny_root(tmp_path)
    lines = {}
    for trace in (1, 0):
        out = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", TINY,
             "--seed", "4000000003", "--seconds", "1", "--trace",
             str(trace)], cwd=root, capture_output=True, text=True,
            timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
        assert out.returncode == 0, out.stderr[-2000:]
        lines[trace] = json.loads(out.stdout.strip().splitlines()[-1])
    m = lines[1]["metrics"]
    assert lines[1]["correct"] is True
    assert all(n in m for n in NEW if n != "accept.mid"), sorted(m)
    assert m["idle_in_launch_share"]["value"] \
        + m["idle_in_stats_share"]["value"] <= m["idle_share"]["value"]
    assert not any(n in lines[0]["metrics"] for n in NEW)


#: the earliest a launch's device interval may start before its span
CLOCK_SLACK_NS = 20_000


def _kernels_and_calls(prof, names):
    """(start_ns of each kernel whose name holds one of ``names``, start_ns
    of the host call that launched it), paired by the profiler's
    correlation id."""
    import torch
    calls, kernels = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if any(k in e.name() for k in names):
                kernels.append((e.start_ns(), e.correlation_id()))
        elif e.name().startswith("cudaLaunchKernel"):
            calls[e.correlation_id()] = e.start_ns()
    return [(s, calls.get(c)) for s, c in sorted(kernels)]


@pytest.mark.chip
def test_launch_spans_precede_their_kernels(card, monkeypatch):
    """A traced 8x8 c1024 window: every K4 (K3) kernel starts no earlier
    than CLOCK_SLACK_NS before the ``k4.launch`` (``k3.launch``) span
    around the host call that launched it; that call lies inside the
    span."""
    from mlmcpathintegral_tpu_torch.utils import timer
    timer.clear()
    got = {}
    read = harness.device_events

    def keep(prof):
        got["k4.launch"] = _kernels_and_calls(prof, ("schwinger_twolevel",))
        got["k3.launch"] = _kernels_and_calls(prof,
                                              ("schwinger_sweep_kernel",))
        return read(prof)
    monkeypatch.setattr(harness, "device_events", keep)
    res, _ = harness.run_cell("schwinger_mlmc_8x8.c1024", 4000000004, 3.0,
                              True, t_start=time.monotonic())
    assert res["correct"] is True
    rec = program.recorded()
    report = {}
    for launch, pairs in got.items():
        spans = sorted((s.start_ns, s.end_ns) for s in rec
                       if s.name == launch)
        starts = [a for a, _ in spans]
        lead, outside = [], 0
        for k, call in pairs:
            i = bisect.bisect_right(starts, call) - 1 if call else -1
            if i < 0 or call > spans[i][1]:
                outside += 1
                continue
            lead.append(spans[i][0] - k)
        report[launch] = {"kernels": len(pairs), "spans": len(spans),
                          "calls_outside_spans": outside,
                          "largest_lead_us": max(lead) / 1e3,
                          "median_latency_us":
                              -statistics.median(lead) / 1e3}
    print(json.dumps({"clock_check": report}))
    for r in report.values():
        assert r["kernels"] == r["spans"] > 0 and r["calls_outside_spans"] \
            == 0, report
        assert r["largest_lead_us"] * 1e3 <= CLOCK_SLACK_NS, report
