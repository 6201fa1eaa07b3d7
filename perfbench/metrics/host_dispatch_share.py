"""Share of the window the host spent inside the level chunk calls before
each level's synchronisation: launching K3/K4 and the statistics' small
kernels (``mc/multilevel.py``'s chunk functions).  From the harness's
host-clock spans."""


def read(run):
    return 100.0 * sum(lv["dispatch_s"] for lv in run.levels) / run.window_s
