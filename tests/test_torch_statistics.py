"""The port's statistics accumulators (mlmcpathintegral_tpu_torch/utils/
statistics.py) against the JAX ones (mlmcpathintegral_tpu/utils/
statistics.py) on the same numpy series, f64, to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.utils import statistics as js
from mlmcpathintegral_tpu_torch.utils import statistics as ts

# the port's tests run small tensors: one thread per worker process
# avoids oversubscribing the cores the parallel test workers share
torch.set_num_threads(1)

C, K_MAX = 6, 10
TOL = 1e-12


def _series(T, seed=0):
    """AR(1) chains: a real autocorrelation for the window sums."""
    rs = np.random.default_rng(seed)
    x = np.empty((T, C))
    x[0] = rs.normal(size=C)
    for t in range(1, T):
        x[t] = 0.8 * x[t - 1] + rs.normal(size=C)
    return x + 0.3


def _close(t_state, j_state):
    for name, a, b in zip(js.StatsState._fields, t_state, j_state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL, err_msg=name)


def _both(blocks):
    """Feed the same [T, C] blocks to both packages; entries of ``blocks``
    are (array, n_valid) or "reset"."""
    jst = js.init(C, K_MAX, jnp.float64)
    tst = ts.init(C, K_MAX, torch.float64, device="cpu")
    for b in blocks:
        if b == "reset":
            jst, tst = js.soft_reset(jst), ts.soft_reset(tst)
            continue
        x, n_valid = b
        if n_valid is None:
            jst = js.record_many(jst, jnp.asarray(x))
            tst = ts.record_many(tst, torch.from_numpy(x))
        else:
            jst = js.record_block(jst, jnp.asarray(x),
                                  n_valid=jnp.asarray(n_valid, jnp.int32))
            tst = ts.record_block(tst, torch.from_numpy(x), n_valid=n_valid)
    return tst, jst


#: the statistics kernel's edge cases: one sample at a time (T = 1), a
#: block shorter than the window on a fresh state and on a short history,
#: n_valid 0, partial and the whole block, a block longer than the window
EDGE_BLOCKS = [
    [(_series(1), None), (_series(1, 1), None), (_series(1, 2), None)],
    [(_series(4), None)],
    [(_series(3), None), (_series(7, 1), None)],
    [(_series(9), 0), (_series(9, 1), 4), (_series(9, 2), 9)],
    [(_series(40), 33), (_series(15, 3), None)],
]
EDGE_IDS = ["one_sample", "fresh_short", "short_history", "n_valid_0_part_all",
            "past_window"]


@pytest.mark.parametrize("blocks", [
    [(_series(3), None)],
    [(_series(25), None), (_series(4, 1), None)],
    [(_series(12), 5), (_series(12, 2), 0), (_series(12, 3), 12)],
    [(_series(30), None), "reset", (_series(16, 4), 9)],
] + EDGE_BLOCKS, ids=["short", "two_blocks", "n_valid", "soft_reset"]
    + EDGE_IDS)
def test_accumulators_match(blocks):
    tst, jst = _both(blocks)
    _close(tst, jst)


@pytest.mark.parametrize("blocks", EDGE_BLOCKS, ids=EDGE_IDS)
def test_block_equals_sequential_records(blocks):
    """The float64 oracle: each block's valid samples recorded one at a
    time (``record``; ``record_masked`` for the rest, which records none)
    give the state ``record_block`` gives in one update."""
    blk = ts.init(C, K_MAX, torch.float64, device="cpu")
    seq = ts.init(C, K_MAX, torch.float64, device="cpu")
    for x, n_valid in blocks:
        x = torch.from_numpy(x)
        blk = ts.record_block(blk, x, n_valid)
        v = x.shape[0] if n_valid is None else n_valid
        for t in range(x.shape[0]):
            seq = ts.record_masked(seq, x[t], torch.tensor(t < v))
    for name, a, b in zip(ts.StatsState._fields, blk, seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL,
                                   err_msg=name)


def test_getters_match():
    tst, jst = _both([(_series(200), None), "reset",
                      (_series(300, 5), 250)])
    jg, tg = js.Statistics("Y", K_MAX), ts.Statistics("Y", K_MAX)
    for name in ("average", "variance", "variance_error", "tau_int",
                 "error"):
        np.testing.assert_allclose(getattr(tg, name)(tst),
                                   getattr(jg, name)(jst), rtol=0, atol=TOL,
                                   err_msg=name)
    assert tg.samples(tst) == jg.samples(jst) == 250 * C
    np.testing.assert_allclose(tg.auto_corr(tst), jg.auto_corr(jst),
                               rtol=0, atol=TOL)
    assert tg.window_capped(tst) == jg.window_capped(jst)


def test_window_capped_matches():
    """A slowly decorrelating series caps the window in both packages."""
    rs = np.random.default_rng(9)
    x = np.cumsum(rs.normal(size=(400, C)), axis=0) * 0.05
    tst, jst = _both([(x, None)])
    jg, tg = js.Statistics("Y", K_MAX), ts.Statistics("Y", K_MAX)
    with pytest.warns(UserWarning):
        assert tg.tau_int(tst) > 1.0
    assert tg.window_capped(tst) and jg.window_capped(jst)
    np.testing.assert_allclose(tg.tau_int(tst), jg.tau_int(jst), rtol=0,
                               atol=TOL)


@pytest.mark.parametrize("n", [50, 1000, 4097])
def test_tau_binning_matches(n):
    rs = np.random.default_rng(n)
    x = np.empty(n)
    x[0] = 0.0
    for t in range(1, n):
        x[t] = 0.9 * x[t - 1] + rs.normal()
    np.testing.assert_allclose(ts.tau_binning(x), js.tau_binning(x),
                               rtol=TOL, atol=TOL)
