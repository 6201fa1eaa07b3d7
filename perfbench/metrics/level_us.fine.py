"""Microseconds a recorded sample of the finest level (K4 and the Y
statistics), from the harness's synchronised host-clock span of each of
the level's batches, summed over the window."""


def read(run):
    lv = run.levels[0]
    return 1e6 * lv["span_s"] / lv["samples"]
