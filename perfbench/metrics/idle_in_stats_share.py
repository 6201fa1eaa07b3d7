"""Share of the traced window in which the device idled while the host
was inside a chunk's statistics: idle gaps whose middle falls inside a
``level{l}.stats`` span."""

from perfbench import program


def read(run):
    return program.idle_share_in(run, program.is_stats)
