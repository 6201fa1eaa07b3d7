"""The whole window's share of the card's float32 peak: the operations
of every K3 and K4 launch of the window at the t_sub it ran (the counts
of the rooflines, ``work.py``), over the window's seconds times 67
TFLOP/s."""

from perfbench import work


def read(run):
    ops = 0
    for lv in run.levels:
        if lv["kind"] == "k4":
            _, n = work.work_k4(run.chains, lv["Mx"], lv["Mt"], lv["chunk"],
                                lv["t_sub"])
        else:
            _, n = work.work_k3(run.chains, lv["Mx"], lv["Mt"],
                                lv["chunk"] * lv["t_sub"])
        ops += lv["launches"] * n
    return 100.0 * ops / (run.window_s * work.H100_F32_OPS_PER_S)
