"""K4's share of its roofline over the window: the sum of each launch's
bound (``work.work_k4`` at one rejection round a draw, over the card's
peaks) over the sum of K4's device time in the profiler trace."""

from perfbench import work

#: K4's kernels: the warp design and the block (team) design
KERNELS = ("schwinger_twolevel_kernel", "schwinger_twolevel_team_kernel")


def read(run):
    bound = sum(lv["launches"] * work.bound_s(*work.work_k4(
        run.chains, lv["Mx"], lv["Mt"], lv["chunk"], lv["t_sub"]))
        for lv in run.levels if lv["kind"] == "k4")
    n = sum(lv["launches"] for lv in run.levels if lv["kind"] == "k4")
    return run.roofline(KERNELS, bound, n)
