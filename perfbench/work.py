"""Operations and bytes of the Schwinger kernels' launches, and the card's
peaks: the yardstick of the rooflines and of ``mfu``.

A frozen copy of the counts in ``chip_smoke.py`` (``OPS_*``,
``sweep_ops``, ``work_k3``, ``work_k4``) and of the peaks in
``perf_probe.py``.  Each float or integer add, multiply, compare, select,
shift, bit operation and transcendental counts one operation.

The rejection loops run a number of rounds that depends on the draws.
``chip_smoke.py`` counts them by running the port's plain version, which
ties the count to an implementation and to its random numbers.  Here
every rejection draw counts one round (``ROUNDS``): the least work a draw
can take, a count that follows from the launch's shape alone, so a
roofline share reads the same work whatever runs it, and can only read
low, never above 100%.
"""

from __future__ import annotations

#: the card's published peaks (NVIDIA H100 SXM data sheet, at its 700 W
#: limit): HBM bytes/s and float32 operations/s outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12

#: rejection rounds counted a draw (see the module docstring)
ROUNDS = 1

#: a counter-RNG word (3 fmix32, 2 multiply-adds, the float bits), a
#: (site, step) stream's set-up, mod_2pi, one ExpCos rejection round (3
#: words, the proposal and the test), an ExpCos draw's set-up, a link's two
#: staples, one BesselProduct round (4 words, the proposal and the test)
OPS_WORD, OPS_RNG_INIT, OPS_MOD2PI = 32, 30, 6
OPS_EXPCOS_ROUND, OPS_EXPCOS_SETUP, OPS_STAPLES = 3 * 32 + 19, 20, 16
OPS_BESSEL_ROUND, OPS_BESSEL_SETUP = 4 * 32 + 40, 25


def sweep_ops(n_links, n_plaq, r=ROUNDS, n_overrelax=1, n_heatbath=1):
    """Operations of one Schwinger sweep-chain step of one chain."""
    return (n_overrelax * n_links * (OPS_STAPLES + 2 + OPS_MOD2PI)
            + n_heatbath * n_links * (OPS_STAPLES + OPS_RNG_INIT
                                      + OPS_EXPCOS_SETUP
                                      + r * OPS_EXPCOS_ROUND)
            + n_plaq * (6 + OPS_MOD2PI))


def work_k3(C, Mx, Mt, n_steps, r=ROUNDS):
    """(bytes, operations) of a sweep-chain launch with Q and E traces."""
    n_links = 2 * Mx * Mt
    nbytes = 4 * (2 * C * n_links + 2 * n_steps * C)
    return nbytes, C * n_steps * sweep_ops(n_links, Mx * Mt, r)


def work_k4(C, Mx, Mt, n_steps, t_sub, r=ROUNDS, r_bessel=ROUNDS):
    """(bytes, operations) of a two-level launch: per step t_sub coarse
    sweeps, then per coarse cell the fill (perimeter, BesselProduct,
    vertical split, two ExpCos links), its four fine plaquettes in S_fine
    and Q, S_cond and the restriction."""
    n_f, n_c, n_cells = 2 * Mx * Mt, Mx * Mt // 2, Mx * Mt // 4
    per_cell = (OPS_RNG_INIT + 2 * OPS_WORD + 4 * (1 + OPS_MOD2PI)
                + OPS_BESSEL_SETUP + r_bessel * OPS_BESSEL_ROUND
                + OPS_WORD + 2 * (2 + OPS_MOD2PI)
                + 2 * (OPS_STAPLES + OPS_EXPCOS_SETUP
                       + r * OPS_EXPCOS_ROUND)
                + 4 * (6 + OPS_MOD2PI) + 46 + 2 * (1 + OPS_MOD2PI) + 12)
    per_step = t_sub * sweep_ops(n_c, n_cells, r) + n_cells * per_cell + 15
    nbytes = 4 * (2 * C * (n_f + n_c + 2) + 2 * n_steps * C
                  + 2 * n_steps * t_sub * C)
    return nbytes, C * n_steps * per_step


def bound_s(nbytes, nops):
    """The least seconds the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 rate."""
    return max(nbytes / H100_BYTES_PER_S, nops / H100_F32_OPS_PER_S)
