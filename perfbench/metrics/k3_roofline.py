"""K3's share of its roofline over the window: the sum of each launch's
bound (``work.work_k3`` at one rejection round a draw, over the card's
peaks) over the sum of K3's device time in the profiler trace."""

from perfbench import work

#: K3's kernel (warp and block design in one template)
KERNELS = ("schwinger_sweep_kernel",)


def read(run):
    bound = sum(lv["launches"] * work.bound_s(*work.work_k3(
        run.chains, lv["Mx"], lv["Mt"], lv["chunk"] * lv["t_sub"]))
        for lv in run.levels if lv["kind"] == "k3")
    n = sum(lv["launches"] for lv in run.levels if lv["kind"] == "k3")
    return run.roofline(KERNELS, bound, n)
