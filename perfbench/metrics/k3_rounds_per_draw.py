"""K3's rejection rounds a draw: the rounds the sequential loop needs
(the first accepting round + 1, or k) over the draws of its heat bath,
as the counted kernel counts them in the window's ``k3.launch`` spans
(program counters)."""

from perfbench import program


def read(run):
    r = program.rounds(run, "k3.launch")
    return None if r is None else r[1] / r[0]
