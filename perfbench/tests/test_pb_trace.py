"""The trace reading: busy time as the union of device intervals, device
time by kernel, and idle gaps by the host span around them."""

import numpy as np

from perfbench.trace import Trace, merged, short_name

EVENTS = [("k1", 10, 20), ("k2", 15, 30), ("k1", 40, 50),
          ("void k3<true>(float*)", 49, 60), ("x", 95, 130), ("y", -5, 0)]
SPANS = [(0, 12, "perfbench.level0.dispatch"),
         (12, 35, "perfbench.level0.sync"),
         (35, 100, "perfbench.level1.dispatch")]


def test_union_of_intervals():
    s, e = merged(np.array([40, 10, 15, 49]), np.array([50, 20, 30, 60]))
    assert s.tolist() == [10, 40] and e.tolist() == [30, 60]


def test_trace_by_hand():
    t = Trace(EVENTS, 0, 100, SPANS)
    assert t.window_s == 100e-9
    # [10, 30] + [40, 60] + [95, 100] (clipped to the window); y is outside
    assert abs(t.busy_s - 45e-9) < 1e-18
    assert abs(t.device_s - 51e-9) < 1e-18
    assert t.kernel_s(["k1"]) == (20e-9, 2)
    assert t.device_ops()[0] == ["k1", 20e-9]
    assert short_name("void k3<true>(float*)") == "k3<true>"
    # gaps [0, 10] in level0.dispatch, [30, 40] and [60, 95] in level1's
    gaps = dict(t.idle_gaps())
    assert abs(gaps["level0.dispatch"] - 10e-9) < 1e-18
    assert abs(gaps["level1.dispatch"] - 45e-9) < 1e-18


def test_empty_trace():
    t = Trace([], 0, 100, [])
    assert t.busy_s == 0.0 and t.idle_gaps() == [["host", 100e-9]]
