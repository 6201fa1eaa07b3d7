"""The delayed-acceptance screen's acceptance on the finest level: the
accepts over the screens (steps x chains) of the window's
``level0.chunk`` spans, counted from K4's accept bits (program
counters)."""

from perfbench import program


def read(run):
    return program.accept_share(run, "level0.chunk")
