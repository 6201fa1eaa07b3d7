"""The share of K3's evaluated rejection rounds that the sequential
loop needs: rounds needed over rounds evaluated (rounds tried W at a time
after an earlier one accepted are evaluated, not needed) of its heat
bath in the window's ``k3.launch`` spans (program counters)."""

from perfbench import program


def read(run):
    r = program.rounds(run, "k3.launch")
    return None if r is None or r[2] == 0 else 100.0 * r[1] / r[2]
