"""The port's Gaussian and semi-coarsened Schwinger fills
(conditioned/schwinger.py) and GaussianFillinDistribution against the JAX
package, on the CPU in f64, on the same numpy-made link fields: the
Gaussian fill fed JAX's uniforms and normals (the perimeter split, then
the mixture's choice, the eta normals and the gauge shift), the semi
fills (temporal and spatial coarsening) fed JAX's split uniforms with the
ExpCos draw replaced in both packages by the same function of its
staples, and every evaluate, to 1e-12; the factory by coarsening type;
then the two-level method on a temporally coarsened lattice against
chit_exact (4 sigma)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.conditioned import schwinger as jschw
from mlmcpathintegral_tpu.distributions.gaussianfillin import (
    GaussianFillinDistribution as JGaussianFillin,
)
from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCT
from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
from mlmcpathintegral_tpu.models.qft.schwinger import (
    QuenchedSchwingerAction as JAction,
)
from mlmcpathintegral_tpu_torch.conditioned import schwinger as tschw
from mlmcpathintegral_tpu_torch.distributions import gaussianfillin
from mlmcpathintegral_tpu_torch.distributions.gaussianfillin import (
    GaussianFillinDistribution,
)
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.mc import MonteCarloTwoLevel
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
from mlmcpathintegral_tpu_torch.samplers import OverrelaxedHeatBathSampler

torch.set_num_threads(1)

C = 4
TOL = 1e-12
PI = math.pi


def _pair(ct, beta=4.0, Mt=8, Mx=6):
    return (JAction(JLattice2D(Mt, Mx, JCT[ct]), beta=beta),
            QuenchedSchwingerAction(Lattice2D(Mt, Mx, CoarseningType[ct]),
                                    beta=beta))


def _links(n, seed, shape=(C,)):
    return np.random.default_rng(seed).uniform(-PI, PI, shape + (n,))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


class _Queue:
    """Stands in for ``uniform`` / ``normal``: hands over the given arrays
    in order, checking each requested shape."""

    def __init__(self, arrays):
        self.arrays = arrays

    def __call__(self, generator, shape, dtype, device, *bounds):
        z = torch.from_numpy(np.array(self.arrays.pop(0)))
        assert tuple(shape) == tuple(z.shape), (shape, z.shape)
        return z.to(dtype)


@pytest.mark.parametrize("beta", [2.0, 100.0])
def test_gaussian_fillin_distribution_matches_jax(monkeypatch, beta):
    """Draw on JAX's noise and the mixture density, with (beta <= 72) and
    without the periodic copies of the peaks."""
    jd, td = JGaussianFillin(beta), GaussianFillinDistribution(beta)
    _close(td.main_peaks, jd.main_peaks, 0.0)
    _close(td.secondary_peaks, jd.secondary_peaks, 0.0)
    phis = _links(4, 1, (3, 5)).transpose(2, 0, 1)
    key = jax.random.PRNGKey(2)
    k1, k2, k3 = jax.random.split(key, 3)
    q = [jax.random.uniform(k1, (3, 5), jnp.float64),
         jax.random.normal(k2, (3, 5, 3), jnp.float64),
         jax.random.uniform(k3, (3, 5), jnp.float64)]
    feed = _Queue(q)
    monkeypatch.setattr(gaussianfillin, "uniform", feed)
    monkeypatch.setattr(gaussianfillin, "normal", feed)
    got = td.draw(None, *(torch.from_numpy(p) for p in phis))
    want = jd.draw(key, *(jnp.asarray(p) for p in phis))
    for a, b in zip(got, want):
        _close(a, b)
    th = _links(4, 3, (3, 5)).transpose(2, 0, 1)
    args = [torch.from_numpy(a) for a in (*th, *phis)]
    jargs = [jnp.asarray(a) for a in (*th, *phis)]
    _close(td.evaluate(*args), jd.evaluate(*jargs))
    _close(td.log_evaluate(*args), jd.log_evaluate(*jargs))
    with pytest.raises(ValueError, match="broken in the reference"):
        GaussianFillinDistribution(beta, add_gaussian_noise=False)


def test_gaussian_fill_matches_jax_on_injected_noise(monkeypatch):
    ja, ta = _pair("BOTH")
    jc = jschw.QuenchedSchwingerGaussianConditionedFineAction(ja)
    tc = tschw.QuenchedSchwingerGaussianConditionedFineAction(ta)
    th = _links(ta.ndof, 4)
    _close(tc.evaluate(torch.from_numpy(th)), jc.evaluate(jnp.asarray(th)))
    key = jax.random.PRNGKey(5)
    k1, k2, k3 = jax.random.split(key, 3)
    cshape = (C, 3, 4)
    g1, g2, g3 = jax.random.split(k3, 3)
    feed = _Queue([jax.random.uniform(k1, cshape, jnp.float64, -PI, PI),
                   jax.random.uniform(k2, cshape, jnp.float64, -PI, PI),
                   jax.random.uniform(g1, cshape, jnp.float64),
                   jax.random.normal(g2, cshape + (3,), jnp.float64),
                   jax.random.uniform(g3, cshape, jnp.float64)])
    for mod in (tschw, gaussianfillin):
        monkeypatch.setattr(mod, "uniform", feed)
    monkeypatch.setattr(gaussianfillin, "normal", feed)
    got = tc.fill_fine_points(None, torch.from_numpy(th))
    want = jc.fill_fine_points(key, jnp.asarray(th))
    _close(got, want)
    assert not feed.arrays
    _close(tc.evaluate(got), jc.evaluate(want))
    # the coarse links' sums stay
    _close(torch.remainder(ta.restrict(got) - ta.restrict(torch.from_numpy(
        th)) + PI, 2 * PI) - PI, np.zeros((C, ta.coarse_action().ndof)),
        1e-12)


def _staple_draw(xp):
    """A deterministic stand-in for ExpCos draws: a function of the two
    staples, in the array library ``xp``."""
    def draw(generator_or_key, beta, tp, tm, *a, **k):
        return xp.sin(0.7 * tp - 0.2 * tm + 0.1 * beta)
    return draw


@pytest.mark.parametrize("ct", ["TEMPORAL", "SPATIAL"])
def test_semi_fill_matches_jax(monkeypatch, ct):
    ja, ta = _pair(ct)
    jc = jschw.QuenchedSchwingerSemiConditionedFineAction(ja)
    tc = tschw.QuenchedSchwingerSemiConditionedFineAction(ta)
    assert tc.case == jc.case == ct.lower()
    th = _links(ta.ndof, 6, (2, C))
    _close(tc.evaluate(torch.from_numpy(th)), jc.evaluate(jnp.asarray(th)))
    key = jax.random.PRNGKey(7)
    k1, _ = jax.random.split(key)
    ushape = (2, C, 6, 4) if ct == "TEMPORAL" else (2, C, 3, 8)
    feed = _Queue([jax.random.uniform(k1, ushape, jnp.float64, -PI, PI)])
    monkeypatch.setattr(tschw, "uniform", feed)
    for mod, xp in ((tschw, torch), (jschw, jnp)):
        stub = type("ExpCos", (), {"draw": staticmethod(_staple_draw(xp)),
                                   "log_evaluate": staticmethod(
                                       mod.ExpCosDistribution.log_evaluate)})
        monkeypatch.setattr(mod, "ExpCosDistribution", stub)
    got = tc.fill_fine_points(None, torch.from_numpy(th))
    want = jc.fill_fine_points(key, jnp.asarray(th))
    _close(got, want)
    assert not feed.arrays
    _close(tc.evaluate(got), jc.evaluate(want))


def test_factory_by_coarsening_type():
    for ct, cls in (("BOTH", "QuenchedSchwingerConditionedFineAction"),
                    ("TEMPORAL", "QuenchedSchwingerSemiConditionedFineAction"),
                    ("SPATIAL", "QuenchedSchwingerSemiConditionedFineAction"),
                    ("ALTERNATE",
                     "QuenchedSchwingerSemiConditionedFineAction")):
        ja, ta = _pair(ct, Mt=8, Mx=8)
        got = tschw.make_schwinger_conditioned_fine_action(ta)
        want = jschw.make_schwinger_conditioned_fine_action(ja)
        assert type(got).__name__ == type(want).__name__ == cls
        if ct != "BOTH":
            assert got.case == want.case
    # the semi fill refuses both-direction coarsening, as JAX's does
    for mod, act in zip((jschw, tschw), _pair("BOTH")):
        with pytest.raises(ValueError, match="temporal/spatial"):
            mod.QuenchedSchwingerSemiConditionedFineAction(act)


def test_temporal_twolevel_against_chit_exact():
    """Two-level on an 8x8 lattice coarsened in time only (heat-bath
    coarse chains on 4 x 8), beta = 2, against chit_exact (4 sigma)."""
    act = QuenchedSchwingerAction(Lattice2D(8, 8, CoarseningType.TEMPORAL),
                                  beta=2.0)
    mc = MonteCarloTwoLevel(
        act, qoi_2d_susceptibility,
        lambda a: OverrelaxedHeatBathSampler(a, n_burnin=50),
        tschw.make_schwinger_conditioned_fine_action, n_burnin=64,
        n_samples=64 * 128, chunk_size=128)
    st = mc.evaluate_difference(3, 64, torch.float64, "cpu")
    num, err = mc.stats_fine.average(st["fine"]), mc.stats_fine.error(
        st["fine"])
    assert 0.1 < mc.p_accept < 1.0, mc.p_accept
    assert abs(num - act.chit_exact()) < 4.0 * err, (num, err)
