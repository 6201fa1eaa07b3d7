"""Share of the device's busy time spent in operations other than K3 and
K4: the Y, Q and energy statistics (``utils/statistics.py``), reductions,
copies and fills."""

#: K3's and K4's kernels
KERNELS = ("schwinger_sweep_kernel", "schwinger_twolevel_kernel",
           "schwinger_twolevel_team_kernel")


def read(run):
    if run.trace is None or run.trace.busy_s <= 0.0:
        return None
    k, _ = run.trace.kernel_s(KERNELS)
    return 100.0 * (run.trace.device_s - k) / run.trace.busy_s
