"""The program's own spans and counters, for the metric readers.

While a ``torch.profiler`` session is active the program records spans on
the profiler's clock (``mlmcpathintegral_tpu_torch/utils/timer.py``):
``level{l}.chunk`` around each fused level chunk (on a fine level with
the screen's ``accepts`` and ``screens``), ``k4.launch`` and ``k3.launch``
around each kernel launch (their ``rounds``: draws, rounds needed and
rounds evaluated of each rejection loop, counted in the kernels) and
``level{l}.stats`` around the statistics' update.  The traced run's window
runs under a profiler, so its chunks record them; the untraced run
records nothing.  This file is the readers' one way to the record.  Each
reader keeps the spans inside the traced window and returns None where
there are none, as a program without the recorder gives.
"""

from __future__ import annotations

import numpy as np

LAUNCHES = ("k3.launch", "k4.launch")


def recorded():
    """The program's record of spans, or None where the program has no
    recorder."""
    try:
        from mlmcpathintegral_tpu_torch.utils import timer
    except ImportError:
        return None
    read = getattr(timer, "spans", None)
    return None if read is None else read()


def window_spans(run, names, record=None):
    """The recorded spans named in ``names`` (a tuple, or a test on a
    name) that lie inside the traced window; [] without a trace or a
    record."""
    if run.trace is None:
        return []
    record = recorded() if record is None else record
    if not record:
        return []
    keep = names if callable(names) else (lambda n: n in names)
    return [s for s in record if keep(s.name)
            and run.trace.t0 <= s.start_ns and s.end_ns <= run.trace.t1]


def is_stats(name: str) -> bool:
    return name.startswith("level") and name.endswith(".stats")


def accept_share(run, chunk: str):
    """100 x the screen's accepts over its screens in the window's
    ``chunk`` spans; None where none carries them."""
    sel = [s for s in window_spans(run, (chunk,)) if "screens" in s.attrs]
    screens = sum(s.attrs["screens"] for s in sel)
    if not screens:
        return None
    return 100.0 * sum(s.attrs["accepts"] for s in sel) / screens


def rounds(run, launch: str):
    """(draws, rounds needed, rounds evaluated) of the window's ``launch``
    spans, summed over their rejection loops; None where no span counted
    a draw."""
    tot = np.zeros(3, np.int64)
    for s in window_spans(run, (launch,)):
        r = s.attrs.get("rounds")
        if r is not None:
            tot += np.asarray(r, np.int64).reshape(-1, 3).sum(axis=0)
    return None if tot[0] == 0 else tuple(int(x) for x in tot)


def mean_host_us(run, names):
    """Mean host microseconds of the window's spans ``names``."""
    sel = window_spans(run, names)
    if not sel:
        return None
    return 1e-3 * sum(s.end_ns - s.start_ns for s in sel) / len(sel)


def idle_share_in(run, names):
    """100 x the window's device idle time whose gap (between the union
    of the device's intervals, and the window's ends) has its middle
    inside one of the spans ``names``, over the window."""
    sel = window_spans(run, names)
    if not sel:
        return None
    t = run.trace
    g0 = np.concatenate(([t.t0], t.busy_ends)).astype(np.float64)
    g1 = np.concatenate((t.busy_starts, [t.t1])).astype(np.float64)
    gap = g1 > g0
    g0, g1 = g0[gap], g1[gap]
    mid = 0.5 * (g0 + g1)
    sel.sort(key=lambda s: s.start_ns)
    hs = np.array([s.start_ns for s in sel], np.float64)
    he = np.array([s.end_ns for s in sel], np.float64)
    i = np.searchsorted(hs, mid, side="right") - 1
    inside = (i >= 0) & (he[np.maximum(i, 0)] >= mid)
    return 100.0 * float(((g1 - g0) * inside).sum()) / 1e9 / t.window_s
