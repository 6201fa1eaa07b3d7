"""Mean host microseconds of a chunk's statistics: the window's
``level{l}.stats`` spans (``record_block``, both ``record_many`` and the
Y mean), on the host clock."""

from perfbench import program


def read(run):
    return program.mean_host_us(run, program.is_stats)
