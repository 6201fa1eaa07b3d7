"""The screen's acceptance on level 1 where it is a fine level (a
hierarchy of three levels or more): accepts over screens of the window's
``level1.chunk`` spans (program counters)."""

from perfbench import program


def read(run):
    return program.accept_share(run, "level1.chunk")
