"""The benchmark's tau, variance and time-to-epsilon arithmetic against
hand-worked cases and against the port's statistics."""

import math

import numpy as np
import pytest
import torch

from perfbench import estimate


def sums(series, k_max):
    """(avg_lt [C], S_k [C, k_max], n) of chains' series [C, n] by the
    definitions: S_k = (1/(n-k)) sum_i Q_i Q_{i-k}."""
    q = np.asarray(series, np.float64)
    C, n = q.shape
    S = np.zeros((C, k_max))
    for k in range(k_max):
        S[:, k] = (q[:, k:] * q[:, :n - k]).sum(axis=1) / (n - k)
    return q.mean(axis=1), S, n


def test_tau_by_hand():
    # 1, 1, -1, -1: C_0 = 1, C_1 = (1 - 1 + 1) / 3 = 1/3
    var, tau, n = estimate.level_moments(*sums([[1, 1, -1, -1]], 2))
    assert n == 4
    assert var == pytest.approx(4.0 / 3.0)
    assert tau == pytest.approx(1.0 + 2.0 * (1.0 - 1.0 / 4.0) / 3.0)


def test_tau_floor_and_empty():
    # alternating: C_1 = -1, so 1 + 2 (3/4)(-1) < 1 -> 1
    assert estimate.level_moments(*sums([[1, -1, 1, -1]], 2))[1] == 1.0
    assert estimate.level_moments(np.zeros(3), np.zeros((3, 4)), 1) \
        == (0.0, 1.0, 3)


def test_tau_pools_chains():
    # two chains: C_k from the mean over chains of S_k, n = C n_lt
    q = [[1, 1, -1, -1], [2, 0, 0, 2]]
    avg, S, n = sums(q, 2)
    var, tau, total = estimate.level_moments(avg, S, n)
    a1 = avg.mean()
    C0, C1 = S[:, 0].mean() - a1 ** 2, S[:, 1].mean() - a1 ** 2
    assert total == 8
    assert var == pytest.approx(8.0 / 7.0 * C0)
    assert tau == pytest.approx(max(1.0, 1.0 + 2.0 * (1 - 1 / 8) * C1 / C0))


def test_tau_matches_the_ports_statistics():
    from mlmcpathintegral_tpu_torch.utils import statistics as st
    g = np.random.default_rng(5)
    x = np.zeros((16, 400))
    for t in range(1, 400):
        x[:, t] = 0.7 * x[:, t - 1] + g.normal(size=16)
    stats = st.Statistics("y", 20)
    state = stats.init(16, torch.float64, "cpu")
    state = st.record_block(state, torch.as_tensor(x.T))
    var, tau, n = estimate.level_moments(state.avg_lt, state.S_k,
                                         int(state.n_lt))
    assert n == stats.samples(state)
    assert var == pytest.approx(stats.variance(state), rel=1e-9)
    assert tau == pytest.approx(stats.tau_int(state), rel=1e-9)


def test_time_to_eps_by_hand():
    # S = sqrt(1*1*1) + sqrt(4*1*1) = 3; 2/eps^2 S^2 = 18
    assert estimate.time_to_eps(1.0, [1.0, 4.0], [1.0, 1.0],
                                [1.0, 1.0]) == pytest.approx(18.0)
    # the optimal N_l = 2/eps^2 S sqrt(V_l/(tau_l c_l)) tau_l spend it
    V, tau, c, eps = [2.0, 0.5, 0.1], [3.0, 1.5, 1.0], [4e-6, 1e-6, 1e-6], \
        1e-2
    S = sum(math.sqrt(v * t * k) for v, t, k in zip(V, tau, c))
    N = [2 / eps ** 2 * S * math.sqrt(v / (t * k)) * t
         for v, t, k in zip(V, tau, c)]
    assert estimate.time_to_eps(eps, V, tau, c) == pytest.approx(
        sum(n * k for n, k in zip(N, c)))
    # and it reaches eps: sum_l tau_l V_l / N_l = eps^2 / 2
    assert sum(t * v / n for t, v, n in zip(tau, V, N)) == pytest.approx(
        eps ** 2 / 2)


def test_effective_samples():
    assert estimate.effective_samples_per_s(1000, 2.0, 5.0) == 100.0


def test_eps_time_shares_by_hand():
    # the optimal N_l c_l over their sum: sqrt(V_l tau_l c_l) / S
    V, tau, c = [2.0, 0.5, 0.1], [3.0, 1.5, 1.0], [4e-6, 1e-6, 1e-6]
    S = sum(math.sqrt(v * t * k) for v, t, k in zip(V, tau, c))
    N = [S * math.sqrt(v / (t * k)) * t for v, t, k in zip(V, tau, c)]
    spent = [n * k for n, k in zip(N, c)]
    assert estimate.eps_time_shares(V, tau, c) == pytest.approx(
        [x / sum(spent) for x in spent])
    assert estimate.eps_time_shares([0.0, 0.0], [1.0, 1.0],
                                    [1.0, 1.0]) == [0.0, 0.0]
