"""Plain PyTorch versions of the rotor kernels
(mlmcpathintegral_tpu_torch/ops/rotor.py) against the Pallas kernels of
mlmcpathintegral_tpu/ops/pallas_rotor.py run in interpret mode, on equal
inputs (numpy seeds) and equal kernel seeds, in f64, with two chain
blocks (C = 256, block_chains = 128) so that global chain ids count.
Equal RNG bits make the two agree to rounding; the tolerance is 1e-9."""

import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.ops import pallas_rotor as jpr
from mlmcpathintegral_tpu_torch import ops
from mlmcpathintegral_tpu_torch.ops import rotor as tpr

# the port's tests run small tensors: one thread per worker process
# avoids oversubscribing the cores the parallel test workers share
torch.set_num_threads(1)

C, BLOCK, N_STEPS, N_UPDATES = 256, 128, 3, 5
SEED = np.array([123456, -98765], np.int32)
TOL = 1e-9


def _x(M, seed=0):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (C, M))


def _kappa(M, m0=0.25, T=4.0):
    return m0 / (T / M)


@pytest.mark.parametrize("M", [16, 32])
def test_cluster_chain_plain_matches_pallas(M):
    x = _x(M, M)
    kappa2 = 2.0 * _kappa(M)
    jx, jw = jpr.rotor_cluster_chain(
        jnp.asarray(x), jnp.asarray(SEED), kappa2=kappa2, M=M,
        n_steps=N_STEPS, n_updates=N_UPDATES, block_chains=BLOCK,
        interpret=True)
    tx, tw = tpr.rotor_cluster_chain(
        torch.from_numpy(x), torch.from_numpy(SEED), kappa2=kappa2, M=M,
        n_steps=N_STEPS, n_updates=N_UPDATES)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=TOL)
    # the updates moved the paths, and the trace is the final path's
    # winding sum
    assert (tx.numpy() != x).any(axis=1).mean() > 0.9
    np.testing.assert_allclose(tw[-1].numpy(),
                               tpr.winding_sum(tx).numpy(), atol=1e-12)


@pytest.mark.parametrize("M,n_or,n_hb", [(16, 1, 1), (32, 1, 1),
                                         (32, 2, 0)])
def test_sweep_chain_plain_matches_pallas(M, n_or, n_hb):
    x = _x(M, 100 + M)
    kappa = _kappa(M)
    jx, jw = jpr.rotor_sweep_chain(
        jnp.asarray(x), jnp.asarray(SEED), kappa=kappa, M=M,
        n_steps=N_STEPS, n_overrelax=n_or, n_heatbath=n_hb,
        block_chains=BLOCK, interpret=True)
    tx, tw = tpr.rotor_sweep_chain(
        torch.from_numpy(x), torch.from_numpy(SEED), kappa=kappa, M=M,
        n_steps=N_STEPS, n_overrelax=n_or, n_heatbath=n_hb)
    if n_hb == 0:
        # overrelaxation alone is elementwise arithmetic: exact
        np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    else:
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                                   atol=TOL)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=TOL)


def test_single_sweep_is_step_zero_of_the_chain():
    """rotor_sweep matches the Pallas rotor_sweep and ignores step_offset,
    as the JAX package does: N single sweeps are not one N-step chain."""
    M = 16
    x = _x(M, 7)
    kappa = _kappa(M)
    want = np.asarray(jpr.rotor_sweep(
        jnp.asarray(x), jnp.asarray(SEED), kappa=kappa, M=M,
        block_chains=BLOCK, interpret=True))
    got = tpr.rotor_sweep(torch.from_numpy(x), torch.from_numpy(SEED),
                          kappa=kappa, M=M, step_offset=5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    t = torch.from_numpy(x)
    for s in range(2):
        t = tpr.rotor_sweep(t, torch.from_numpy(SEED), kappa=kappa, M=M,
                            step_offset=s)
    chain, _ = tpr.rotor_sweep_chain(torch.from_numpy(x),
                                     torch.from_numpy(SEED), kappa=kappa,
                                     M=M, n_steps=2)
    assert not torch.equal(t, chain)


def test_wrappers_run_plain_versions_on_cpu_only():
    ops.reset_counters()
    x = torch.zeros(2, 8, dtype=torch.float32)
    out, w = tpr.rotor_cluster_chain(x, 1, kappa2=1.0, M=8, n_steps=2,
                                     n_updates=1)
    assert out.dtype == torch.float32 and w.shape == (2, 2)
    out, w = tpr.rotor_sweep_chain(x, 1, kappa=1.0, M=8, n_steps=3)
    assert w.shape == (3, 2) and torch.isfinite(out).all()
    assert (out.abs() <= math.pi + 1e-6).all()
    assert all(c.launches == 0 and c.plain_cuda_calls == 0
               for c in ops.counters())
    with pytest.raises(ValueError, match="unsupported device"):
        tpr.rotor_cluster_chain(x.to("meta"), 1, kappa2=1.0, M=8,
                                n_steps=1)
    with pytest.raises(ValueError, match="even M_lat"):
        tpr.rotor_sweep_chain(torch.zeros(2, 7), 1, kappa=1.0, M=7,
                              n_steps=1)


def test_rejection_tally_counts_rounds_of_the_plain_loops():
    """The tally chip_smoke.py takes to count a launch's work: one draw
    per heat-bath site per sweep, between 1 and k_rej rounds each; the
    same result with and without it, and the plain loops unwrapped again
    once it closes."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from mlmcpathintegral_tpu_torch.ops import schwinger
    before = schwinger._first_accepted
    M, Cs, steps = 16, 4, 3
    x = torch.from_numpy(_x(M, 3)[:Cs])
    with smoke.rejection_tally() as tally:
        out, w = tpr.rotor_sweep_chain(x, 5, kappa=_kappa(M), M=M,
                                       n_steps=steps)
    draws, rounds = tally["expcos"]
    assert draws == steps * Cs * M
    assert draws <= float(rounds) <= 8 * draws
    assert schwinger._first_accepted is before
    out2, w2 = tpr.rotor_sweep_chain(x, 5, kappa=_kappa(M), M=M,
                                     n_steps=steps)
    assert torch.equal(out, out2) and torch.equal(w, w2)
    assert set(tally) == {"expcos"}


@pytest.mark.parametrize("M,C,want", [
    # path A (half-warp chains, two a warp), path B1 (8 sites a lane)
    (16, 1024, (16, 1, 8, 8 * 8 * 16)),
    (256, 4096, (32, 8, 4, 4 * 8 * 256)),
    # ragged: idle lanes, and a last pass over some lanes only
    (24, 64, (32, 1, 4, 4 * 8 * 24)),
    (100, 4096, (32, 4, 4, 4 * 8 * 100)),
    # few chains: one warp a block; a path beyond 48 KB: one chain a block
    (16, 3, (16, 1, 4, 4 * 8 * 16)),
    (20_000, 8, (32, 625, 1, 8 * 20_000)),
])
def test_cluster_launch_layout(M, C, want):
    """(lanes per chain, sites per lane, chains per block, shared bytes)
    of the cluster kernel: whole warps a block, every site on a lane, the
    path and its cosines (8 bytes a site) in each chain's slice."""
    lanes, sites, cpb, smem = got = tpr.cluster_launch(M, C)
    assert got == want
    assert lanes * sites >= M > lanes * (sites - 1) or lanes > M
    assert (lanes * cpb) % 32 == 0 and lanes * cpb <= 128
    assert smem == 8 * M * cpb
