"""Share of the traced window in which the device idled while the host
was inside a kernel launch: idle gaps (the window less the union of the
device's intervals) whose middle falls inside a ``k3.launch`` or
``k4.launch`` span."""

from perfbench import program


def read(run):
    return program.idle_share_in(run, program.LAUNCHES)
