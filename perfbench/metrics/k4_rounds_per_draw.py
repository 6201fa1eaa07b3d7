"""K4's rejection rounds a draw: the rounds the sequential loop needs
(the first accepting round + 1, or k) over the draws, summed over its
coarse heat bath, BesselProduct draws and ExpCos fill, as the counted
kernel counts them in the window's ``k4.launch`` spans (program
counters)."""

from perfbench import program


def read(run):
    r = program.rounds(run, "k4.launch")
    return None if r is None else r[1] / r[0]
