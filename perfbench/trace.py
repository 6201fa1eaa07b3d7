"""Reading the profiler's record of the window: the device's busy
intervals, each kernel's device time, and the idle gaps by what the host
was doing.  The arithmetic of ``perf_probe.py`` (``union_ms``), copied so
that the yardstick does not move with the program.

The profiler records the device's activity alone (``ProfilerActivity.
CUDA``): recording every PyTorch operator on the host as well multiplies
the events by ten and the reading by as much.  Its times are the host's
wall clock in nanoseconds (``time.time_ns``), so the harness's own spans,
taken with that clock, say what the host was doing when the device idled.
"""

from __future__ import annotations

import numpy as np
import torch

#: the harness's span names start so; the window is the whole
SPAN_PREFIX = "perfbench."


def merged(starts, ends):
    """The union of intervals [starts, ends) as sorted disjoint
    (starts, ends) arrays."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:], len(s)) - 1
    return s[first], reach[last]


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type
    (``void k<true>(float*, ...)`` -> ``k<true>``)."""
    name = name.split("(")[0]
    return name[5:] if name.startswith("void ") else name


def device_events(prof):
    """(name, start_ns, end_ns) of every operation the profiler saw on a
    CUDA device: kernels, copies and fills."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


class Trace:
    """The device events of the window ``(t0_ns, t1_ns)``, clipped to it,
    beside the harness's host spans ``[(start_ns, end_ns, name), ...]``,
    which follow one another without overlap."""

    def __init__(self, events, t0_ns: int, t1_ns: int, host_spans):
        self.t0, self.t1 = t0_ns, t1_ns
        self.window_s = (t1_ns - t0_ns) / 1e9
        names = [n for n, _, _ in events]
        s = np.clip(np.array([a for _, a, _ in events], np.int64),
                    t0_ns, t1_ns)
        e = np.clip(np.array([b for _, _, b in events], np.int64),
                    t0_ns, t1_ns)
        keep = e > s
        s, e = s[keep], e[keep]
        names = [n for n, k in zip(names, keep) if k]
        #: device seconds and launches by operation name
        self.by_name = {}
        for n, d in zip(names, (e - s).tolist()):
            t, c = self.by_name.get(n, (0, 0))
            self.by_name[n] = (t + d, c + 1)
        self.device_s = float((e - s).sum()) / 1e9
        self.busy_starts, self.busy_ends = (merged(s, e) if len(s)
                                            else (s, e))
        self.busy_s = float((self.busy_ends - self.busy_starts).sum()) / 1e9
        self.host_spans = sorted(host_spans)

    def kernel_s(self, names) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds one
        of ``names``."""
        sel = [v for n, v in self.by_name.items()
               if any(k in n for k in names)]
        return sum(t for t, _ in sel) / 1e9, sum(c for _, c in sel)

    def device_ops(self, top: int = 10):
        """[[kernel, seconds], ...] of the device operations that took the
        most time, summed by name."""
        by = {}
        for n, (t, _) in self.by_name.items():
            k = short_name(n)
            by[k] = by.get(k, 0.0) + t / 1e9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10):
        """[[host span, seconds], ...]: the window's idle device time summed
        by the harness span the host was in at each gap's middle ("host"
        outside every span)."""
        g0 = np.concatenate(([self.t0], self.busy_ends))
        g1 = np.concatenate((self.busy_starts, [self.t1]))
        gap = g1 > g0
        g0, g1 = g0[gap], g1[gap]
        mid = 0.5 * (g0 + g1)
        hs = np.array([a for a, _, _ in self.host_spans], np.float64)
        he = np.array([b for _, b, _ in self.host_spans], np.float64)
        i = np.searchsorted(hs, mid, side="right") - 1
        inside = (i >= 0) & (he[np.maximum(i, 0)] >= mid) if len(hs) \
            else np.zeros(len(mid), bool)
        labels = ["host"] + [n[len(SPAN_PREFIX):] for _, _, n in
                             self.host_spans]
        idx = np.where(inside, i + 1, 0)
        secs = np.bincount(idx, weights=(g1 - g0) / 1e9,
                           minlength=len(labels))
        by = {}
        for k, v in zip(labels, secs.tolist()):
            if v > 0.0:
                by[k] = by.get(k, 0.0) + v
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:top]]
