"""The trace reading: busy time as the union of device intervals, device
time by kernel, and idle gaps by the host span around them."""

import numpy as np
import pytest

from perfbench.harness import Run
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


@pytest.mark.parametrize("traced, want", [(2000, 50.0), (1999, 50.0),
                                          (1998, 50.0), (1997, None),
                                          (2001, None)])
def test_roofline_over_the_traced_launches(traced, want):
    """The bound over the traced share of the launches: a launch or one
    in a thousand may lack its record, with time and work over the same
    launches; more lost, or more traced than run, read nothing."""
    events = [("k", 10 * i, 10 * i + 4) for i in range(traced)]
    run = Run(chains=1, window_s=1.0, rounds=1, levels=[],
              trace=Trace(events, 0, 10 * 2001, []))
    # each launch takes 4 ns on the device and is bound at 2 ns
    got = run.roofline(["k"], 2000 * 2e-9, 2000)
    assert got == pytest.approx(want) if want else got is None
    assert bool(run.notes) is (traced != 2000)
