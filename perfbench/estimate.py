"""The MLMC arithmetic the benchmark reads from a window: each level's
variance and windowed integrated autocorrelation time of Y, and the
sampling time the estimator needs to reach an RMS error epsilon.

A copy of the estimators of the port's ``utils/statistics.py`` (after
statistics.cc:30-98) and of the sample allocation of its adaptive loop
(``mc/multilevel.py``, after montecarlomultilevel.cc:113-169), in float64
on the host, read from the per-chain sums of a statistics state that was
started empty at the window's start.
"""

from __future__ import annotations

import math

import numpy as np


def level_moments(avg_lt, S_k, n_lt):
    """(variance, tau_int, samples) of one level from its statistics sums:
    ``avg_lt`` [C] the chains' running means, ``S_k`` [C, k_max] their
    running lagged products (1/N_k) sum_i Q_i Q_{i-k}, ``n_lt`` the
    samples each chain recorded.  Chains are pooled as the reference pools
    MPI ranks: C_k = <S_k> - <Q>^2, Var = n/(n-1) C_0 with n = C n_lt, and
    tau_int = max(1, 1 + 2 sum_{k>=1} (1 - k/n) C_k / C_0)."""
    avg_lt = np.asarray(avg_lt, np.float64)
    S_k = np.asarray(S_k, np.float64)
    C, k_max = S_k.shape
    n = int(n_lt) * C
    if int(n_lt) < 2:
        return 0.0, 1.0, n
    a1 = avg_lt.mean()
    C_k = S_k.mean(axis=0) - a1 * a1
    var = n / (n - 1.0) * C_k[0]
    if C_k[0] <= 0.0:
        return max(var, 0.0), 1.0, n
    k = np.arange(1, k_max, dtype=np.float64)
    tau = 1.0 + 2.0 * np.sum((1.0 - k / n) * C_k[1:]) / C_k[0]
    return max(var, 0.0), max(tau, 1.0), n


def time_to_eps(epsilon, V, tau, cost):
    """Seconds of sampling that reach RMS error ``epsilon`` with the
    optimal per-level sample counts, given each level's variance V,
    integrated autocorrelation time tau and seconds per sample ``cost``.

    The adaptive loop's allocation is N_l = 2/eps^2 * S * sqrt(V_l /
    C_l) * tau_l with C_l = tau_l c_l the cost of an independent sample
    and S = sum_l sqrt(V_l C_l), so sum_l N_l c_l = 2/eps^2 * S^2.  The
    loop rounds tau up in C_l; here it is not rounded, so that the time
    moves smoothly with tau and does not jump by up to 2x where a level's
    tau crosses a whole number."""
    S = sum(math.sqrt(v * t * c) for v, t, c in zip(V, tau, cost))
    return 2.0 / (epsilon * epsilon) * S * S


def eps_time_shares(V, tau, cost):
    """The share of ``time_to_eps``'s seconds that each level takes: with
    the optimal N_l, level l spends N_l c_l, in proportion to
    sqrt(V_l tau_l c_l)."""
    w = [math.sqrt(v * t * c) for v, t, c in zip(V, tau, cost)]
    total = sum(w)
    return [x / total if total > 0.0 else 0.0 for x in w]


def effective_samples_per_s(n0, tau0, seconds):
    """n_0 / (tau_int(Y_0) * seconds): the north star's metric (bench.py,
    the C++ baseline)."""
    return n0 / (tau0 * seconds)
