"""Microseconds a recorded sample of level 1, a fine level between the
finest and the coarsest (K4 on the middle lattice), from the harness's
synchronised span of each of its batches.  Nothing to read in a
hierarchy of fewer than three levels."""


def read(run):
    if len(run.levels) < 3:
        return None
    lv = run.levels[1]
    return 1e6 * lv["span_s"] / lv["samples"]
