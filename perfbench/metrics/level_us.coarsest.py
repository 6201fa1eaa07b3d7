"""Microseconds a recorded sample of the coarsest level (K3 and the Y
statistics), from the harness's synchronised span of each of its
batches."""


def read(run):
    lv = run.levels[-1]
    return 1e6 * lv["span_s"] / lv["samples"]
