"""The share of K4's evaluated rejection rounds that the sequential
loop needs: rounds needed over rounds evaluated (rounds tried W at a time
after an earlier one accepted are evaluated, not needed), summed over its
coarse heat bath, BesselProduct draws and ExpCos fill in the window's
``k4.launch`` spans (program counters)."""

from perfbench import program


def read(run):
    r = program.rounds(run, "k4.launch")
    return None if r is None or r[2] == 0 else 100.0 * r[1] / r[2]
