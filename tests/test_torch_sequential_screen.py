"""The sequential two-level screen (``mc/twolevel.py``
``make_sequential_screen``), the path of fills that read the current fine
state: the counterpart of ``tests/test_twolevel.py``'s batched-against-
sequential test on the harmonic oscillator with exact coarse draws (the
Gaussian fill forced through the sequential screen), in
``MonteCarloTwoLevel`` and in an unfused ``MonteCarloMultiLevel`` level:
each path within 4 sigma of ``Xsquared_analytical``, the two paths within
4 combined sigma of each other with acceptance rates within 0.03, and the
port's sequential run within 4 combined sigma of the JAX package's at the
same size (f64, CPU)."""

import math

import jax
import jax.numpy as jnp
import pytest
import torch

from mlmcpathintegral_tpu.conditioned import (
    GaussianConditionedFineAction as JGaussian,
)
from mlmcpathintegral_tpu.lattice import Lattice1D as JLattice1D
from mlmcpathintegral_tpu.mc import MonteCarloTwoLevel as JTwoLevel
from mlmcpathintegral_tpu.models import (
    HarmonicOscillatorAction as JHarmonic,
)
from mlmcpathintegral_tpu.models import RenormalisationType as JRT
from mlmcpathintegral_tpu.qoi import qoi_x_squared as j_qoi
from mlmcpathintegral_tpu.samplers.exact import ExactSampler as JExact
from mlmcpathintegral_tpu_torch.conditioned.qm import (
    GaussianConditionedFineAction,
)
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.mc import (
    MonteCarloMultiLevel, MonteCarloTwoLevel,
)
from mlmcpathintegral_tpu_torch.models import (
    HarmonicOscillatorAction, RenormalisationType,
)
from mlmcpathintegral_tpu_torch.qoi import qoi_x_squared
from mlmcpathintegral_tpu_torch.samplers import ExactSampler

torch.set_num_threads(1)

N_SAMPLES, N_CHAINS, CHUNK = 20000, 64, 50


class _Sequential(GaussianConditionedFineAction):
    independent_fill = False


class _JSequential(JGaussian):
    independent_fill = False


def _action():
    return HarmonicOscillatorAction(Lattice1D(32, 4.0),
                                    RenormalisationType.NONPERTURBATIVE,
                                    m0=1.0, mu2=1.0)


@pytest.fixture(scope="module")
def twolevel_runs():
    """(avg, err, p_accept) of the batched and the sequential port runs."""
    act = _action()
    out = {}
    for name, cond, seed in (("batched", GaussianConditionedFineAction, 101),
                             ("sequential", _Sequential, 102)):
        mc = MonteCarloTwoLevel(act, qoi_x_squared, ExactSampler, cond,
                                n_burnin=200, n_samples=N_SAMPLES,
                                chunk_size=CHUNK)
        stats = mc.evaluate_difference(torch.Generator().manual_seed(seed),
                                       N_CHAINS, torch.float64, "cpu")
        out[name] = (mc.stats_fine.average(stats["fine"]),
                     mc.stats_fine.error(stats["fine"]), mc.p_accept)
    return out


def test_twolevel_batched_matches_sequential(twolevel_runs):
    oracle = _action().Xsquared_analytical()
    (a_b, e_b, p_b), (a_s, e_s, p_s) = (twolevel_runs["batched"],
                                        twolevel_runs["sequential"])
    assert abs(a_b - oracle) < 4 * e_b, (a_b, e_b, oracle)
    assert abs(a_s - oracle) < 4 * e_s, (a_s, e_s, oracle)
    assert abs(a_b - a_s) < 4 * math.hypot(e_b, e_s)
    # the two paths realise the same Markov kernel
    assert abs(p_b - p_s) < 0.03, (p_b, p_s)


def test_twolevel_sequential_chunk_is_the_sequential_screen():
    mc = MonteCarloTwoLevel(_action(), qoi_x_squared, ExactSampler,
                            _Sequential, n_samples=64, chunk_size=8)
    assert mc._chunk.__qualname__.startswith(
        "MonteCarloTwoLevel._make_sequential_chunk")


def test_twolevel_sequential_matches_jax(twolevel_runs):
    """JAX's sequential scan at the same size, held in 4 combined sigma."""
    act = JHarmonic(JLattice1D(32, 4.0), JRT.NONPERTURBATIVE, m0=1.0,
                    mu2=1.0)
    mc = JTwoLevel(act, j_qoi, coarse_sampler_factory=JExact,
                   conditioned_fine_action_factory=_JSequential,
                   n_burnin=200, n_samples=N_SAMPLES, chunk_size=CHUNK)
    stats = mc.evaluate_difference(jax.random.PRNGKey(102),
                                   n_chains=N_CHAINS, dtype=jnp.float64)
    a_j = mc.stats_fine.average(stats["fine"])
    e_j = mc.stats_fine.error(stats["fine"])
    a_s, e_s, p_s = twolevel_runs["sequential"]
    assert abs(a_s - a_j) < 4 * math.hypot(e_s, e_j), (a_s, a_j)
    assert abs(p_s - mc.p_accept) < 0.03, (p_s, mc.p_accept)


def test_multilevel_level_batched_matches_sequential():
    """One unfused MLMC level (harmonic, two levels, exact coarse draws)
    screened batched and sequentially: level 0's mean Y and the estimate
    agree within 4 combined sigma and with the oracle."""
    act = _action()
    oracle = act.Xsquared_analytical()
    res = {}
    for name, cond, seed in (("batched", GaussianConditionedFineAction, 7),
                             ("sequential", _Sequential, 8)):
        mc = MonteCarloMultiLevel(act, qoi_x_squared, ExactSampler, cond,
                                  n_level=2, n_burnin=200,
                                  n_samples=N_SAMPLES, chunk_size=CHUNK,
                                  use_pallas=False)
        assert sorted(mc._unfused) == [0, 1]
        assert mc._unfused[0].__qualname__.startswith(
            "MonteCarloMultiLevel._make_sequential_chunk"
            if name == "sequential"
            else "MonteCarloMultiLevel._make_unfused_chunk")
        stats = mc.evaluate(torch.Generator().manual_seed(seed), N_CHAINS,
                            torch.float64, "cpu")
        res[name] = (mc.stats_qoi[0].average(stats[0]),
                     mc.stats_qoi[0].error(stats[0]))
        num, err = mc.numerical_result(), mc.statistical_error()
        assert abs(num - oracle) < 4 * err, (name, num, err, oracle)
    (y_b, e_b), (y_s, e_s) = res["batched"], res["sequential"]
    assert abs(y_b - y_s) < 4 * math.hypot(e_b, e_s), (y_b, y_s)
