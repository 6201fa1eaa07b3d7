"""Mean host microseconds of a kernel launch: the window's ``k3.launch``
and ``k4.launch`` spans (the wrapper's allocations and the ctypes
launch), on the host clock."""

from perfbench import program


def read(run):
    return program.mean_host_us(run, program.LAUNCHES)
