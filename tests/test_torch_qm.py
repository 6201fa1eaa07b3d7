"""The port's QM models, conditioned fills and QoI against the JAX package
(f64, 1e-12): harmonic and quartic evaluate, force, W geometry, the
renormalised coarse actions and analytics; the forces against autograd of
evaluate; the spectral exact draw, the Gaussian heat-bath site draw and
both conditioned fills on injected noise (JAX's normals, or one injected
ExpSin2 draw on both sides), and the fills' evaluate; qoi_x_squared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.conditioned.qm import (
    make_conditioned_fine_action as j_make_cond,
)
from mlmcpathintegral_tpu.distributions.expsin2 import (
    ExpSin2Distribution as JExpSin2,
)
from mlmcpathintegral_tpu.lattice import Lattice1D as JLattice1D
from mlmcpathintegral_tpu.models import (
    HarmonicOscillatorAction as JHarmonic,
)
from mlmcpathintegral_tpu.models import (
    QuarticOscillatorAction as JQuartic,
)
from mlmcpathintegral_tpu.models import RenormalisationType as JRenorm
from mlmcpathintegral_tpu.models import RotorAction as JRotor
from mlmcpathintegral_tpu.qoi import qoi_x_squared as j_qoi_x2
from mlmcpathintegral_tpu_torch.conditioned import qm as cqm
from mlmcpathintegral_tpu_torch.conditioned.qm import (
    GaussianConditionedFineAction, RotorConditionedFineAction,
    make_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.distributions.expsin2 import (
    ExpSin2Distribution,
)
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.models import (
    HarmonicOscillatorAction, QuarticOscillatorAction, RenormalisationType,
    RotorAction,
)
from mlmcpathintegral_tpu_torch.models import base as mbase
from mlmcpathintegral_tpu_torch.models import harmonic as mharm
from mlmcpathintegral_tpu_torch.qoi import qoi_x_squared

torch.set_num_threads(1)

TOL = 1e-12
M, T, C = 16, 4.0, 6


def _pair(kind, renorm="NONE"):
    jl, tl = JLattice1D(M, T), Lattice1D(M, T)
    jr, tr = JRenorm[renorm], RenormalisationType[renorm]
    if kind == "harmonic":
        return (JHarmonic(jl, jr, m0=1.3, mu2=0.7),
                HarmonicOscillatorAction(tl, tr, m0=1.3, mu2=0.7))
    if kind == "quartic":
        kw = dict(m0=0.9, mu2=-1.0, lam=1.2, x0=0.3)
        return JQuartic(jl, jr, **kw), QuarticOscillatorAction(tl, tr, **kw)
    return JRotor(jl, jr, m0=0.25), RotorAction(tl, tr, m0=0.25)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("kind", ["harmonic", "quartic"])
def test_action_matches_jax_and_autograd(kind):
    ja, ta = _pair(kind)
    rs = np.random.default_rng(1)
    x = rs.normal(size=(C, M))
    xm, xp = rs.normal(size=(C, M // 2)), rs.normal(size=(C, M // 2))
    tx = torch.from_numpy(x)
    _close(ta.evaluate(tx), ja.evaluate(jnp.asarray(x)))
    _close(ta.force(tx), ja.force(jnp.asarray(x)))
    for name in ("getWminimum", "getWcurvature"):
        _close(getattr(ta, name)(torch.from_numpy(xm), torch.from_numpy(xp)),
               getattr(ja, name)(jnp.asarray(xm), jnp.asarray(xp)))
    _close(ta.overrelax_site(tx[:, ::2], torch.from_numpy(xm),
                             torch.from_numpy(xp)),
           ja.overrelax_site(jnp.asarray(x[:, ::2]), jnp.asarray(xm),
                             jnp.asarray(xp)))
    # the hand-written force is the gradient of evaluate
    xg = tx.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(ta.evaluate(xg).sum(), xg)
    _close(ta.force(tx), grad)
    assert ta.info_string() == ja.info_string()
    assert torch.equal(ta.initialise_state(None, 3, torch.float64, "cpu"),
                       torch.zeros(3, M, dtype=torch.float64))


@pytest.mark.parametrize("kind, renorm", [
    ("harmonic", "NONE"), ("harmonic", "PERTURBATIVE"),
    ("harmonic", "NONPERTURBATIVE"), ("quartic", "NONE")])
def test_coarse_actions_match_jax(kind, renorm):
    ja, ta = _pair(kind, renorm)
    jc, tc = ja.coarse_action(), ta.coarse_action()
    assert tc.M_lat == jc.M_lat == M // 2
    for attr in ("m0", "mu2", "lam", "x0"):
        if hasattr(jc, attr):
            assert getattr(tc, attr) == pytest.approx(getattr(jc, attr),
                                                      abs=TOL)
    x = np.random.default_rng(2).normal(size=(C, M // 2))
    _close(tc.evaluate(torch.from_numpy(x)), jc.evaluate(jnp.asarray(x)))


def test_harmonic_analytics_and_spectral_draw_match_jax(monkeypatch):
    ja, ta = _pair("harmonic")
    assert ta.Xsquared_analytical() == pytest.approx(
        ja.Xsquared_analytical(), rel=1e-14)
    assert ta.Xsquared_analytical_continuum() == pytest.approx(
        ja.Xsquared_analytical_continuum(), rel=1e-14)
    _close(ta.precision_symbol(torch.float64, "cpu"),
           ja.precision_symbol(jnp.float64))
    key = jax.random.PRNGKey(4)
    z = np.array(jax.random.normal(key, (64, M), jnp.float64))
    monkeypatch.setattr(mharm, "normal",
                        lambda g, shape, dtype, device: torch.from_numpy(z))
    got = ta.exact_draw(None, 64, torch.float64, "cpu")
    _close(got, ja.exact_draw(key, 64, jnp.float64))


def test_gaussian_heatbath_site_matches_jax(monkeypatch):
    ja, ta = _pair("quartic")
    rs = np.random.default_rng(5)
    xm, xp = rs.normal(size=(C, 8)), rs.normal(size=(C, 8))
    key = jax.random.PRNGKey(6)
    z = np.array(jax.random.normal(key, (C, 8), jnp.float64))
    monkeypatch.setattr(mbase, "normal",
                        lambda g, shape, dtype, device: torch.from_numpy(z))
    _close(ta.heatbath_site(None, torch.from_numpy(xm), torch.from_numpy(xp)),
           ja.heatbath_site(key, jnp.asarray(xm), jnp.asarray(xp)))


@pytest.mark.parametrize("kind", ["harmonic", "quartic"])
def test_gaussian_fill_matches_jax(monkeypatch, kind):
    ja, ta = _pair(kind)
    jcond, tcond = j_make_cond(ja), make_conditioned_fine_action(ta)
    assert type(tcond) is GaussianConditionedFineAction
    x = np.random.default_rng(7).normal(size=(C, M))
    key = jax.random.PRNGKey(8)
    z = np.array(jax.random.normal(key, (C, M // 2), jnp.float64))
    monkeypatch.setattr(cqm, "normal",
                        lambda g, shape, dtype, device: torch.from_numpy(z))
    want = jcond.fill_fine_points(key, jnp.asarray(x))
    got = tcond.fill_fine_points(None, torch.from_numpy(x))
    _close(got, want)
    # the even sites are kept
    assert torch.equal(got[:, ::2], torch.from_numpy(x[:, ::2]))
    _close(tcond.evaluate(got), jcond.evaluate(want))
    _close(tcond.evaluate(torch.from_numpy(x)), jcond.evaluate(
        jnp.asarray(x)))


def test_rotor_fill_matches_jax(monkeypatch):
    ja, ta = _pair("rotor")
    jcond, tcond = j_make_cond(ja), make_conditioned_fine_action(ta)
    assert type(tcond) is RotorConditionedFineAction
    rs = np.random.default_rng(9)
    x = rs.uniform(-np.pi, np.pi, (C, M))
    xi = rs.uniform(-1.0, 1.0, (C, M // 2))
    sig = {}

    def j_draw(key, sigma, *a, **k):
        sig["jax"] = np.asarray(sigma)
        return jnp.asarray(xi)

    def t_draw(generator, sigma, *a, **k):
        sig["port"] = sigma.numpy()
        return torch.from_numpy(xi)

    monkeypatch.setattr(JExpSin2, "draw", staticmethod(j_draw))
    monkeypatch.setattr(ExpSin2Distribution, "draw", staticmethod(t_draw))
    want = jcond.fill_fine_points(jax.random.PRNGKey(0), jnp.asarray(x))
    got = tcond.fill_fine_points(None, torch.from_numpy(x))
    _close(sig["port"], sig["jax"])
    _close(got, want)
    _close(tcond.evaluate(got), jcond.evaluate(want))


def test_qoi_x_squared_matches_jax():
    x = np.random.default_rng(10).normal(size=(3, C, M))
    _close(qoi_x_squared(Lattice1D(M, T))(torch.from_numpy(x)),
           j_qoi_x2(JLattice1D(M, T))(jnp.asarray(x)))
