"""The windowed integrated autocorrelation time of Y on the finest level,
in samples (``estimate.level_moments`` on the window's own statistics):
the delayed-acceptance screen and t_sub set it."""


def read(run):
    return run.levels[0]["tau"]
