"""The port's Schwinger model, distributions and conditioned fill
(mlmcpathintegral_tpu_torch/models, distributions, conditioned) against
the JAX package on equal numpy inputs in f64 (1e-10), and KS checks of the
port's own fill draws against the distributions' densities."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import integrate, stats

from mlmcpathintegral_tpu.conditioned.schwinger import (
    QuenchedSchwingerConditionedFineAction as JCond,
)
from mlmcpathintegral_tpu.distributions.approxbesselproduct import (
    ApproximateBesselProductDistribution as JApprox,
)
from mlmcpathintegral_tpu.distributions.besselproduct import (
    BesselProductDistribution as JBessel,
)
from mlmcpathintegral_tpu.distributions.expcos import (
    ExpCosDistribution as JExpCos,
)
from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCT
from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
from mlmcpathintegral_tpu.models.base import RenormalisationType as JRT
from mlmcpathintegral_tpu.models.qft.schwinger import (
    QuenchedSchwingerAction as JAction,
)
from mlmcpathintegral_tpu.qoi import qoi_2d_susceptibility as j_qoi
from mlmcpathintegral_tpu.utils import special as jsp
from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
    QuenchedSchwingerConditionedFineAction,
)
from mlmcpathintegral_tpu_torch.distributions import (
    ApproximateBesselProductDistribution, BesselProductDistribution,
    ExpCosDistribution,
)
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
from mlmcpathintegral_tpu_torch.utils import special as tsp

# the port's tests run small tensors: one thread per worker process
# avoids oversubscribing the cores the parallel test workers share
torch.set_num_threads(1)

TOL = 1e-10
C = 5


def _pair(beta=4.0, ct="BOTH", Mt=8, Mx=6, renorm="NONE"):
    j = JAction(JLattice2D(Mt, Mx, JCT[ct]), beta=beta,
                renormalisation=JRT[renorm])
    t = QuenchedSchwingerAction(Lattice2D(Mt, Mx, CoarseningType[ct]),
                                beta=beta,
                                renormalisation=RenormalisationType[renorm])
    return j, t


def _links(n, seed=0, C=C):
    return np.random.default_rng(seed).uniform(-np.pi, np.pi, (C, n))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=tol)


def test_plaquettes_staples_evaluate_overrelax_qoi():
    ja, ta = _pair()
    th = _links(ja.ndof)
    jt, tt = jnp.asarray(th), torch.from_numpy(th)
    _close(ta.plaquette_angles(tt), ja.plaquette_angles(jt))
    _close(ta.evaluate(tt), ja.evaluate(jt))
    for a, b in zip(ta.staple_angles(tt), ja.staple_angles(jt)):
        _close(a, b)
    _close(ta.overrelaxation_sweep(tt), ja.overrelaxation_sweep(jt))
    _close(qoi_2d_susceptibility(ta)(tt), j_qoi(ja)(jt))
    assert ta.ndof == ja.ndof and ta.n_plaq == ja.n_plaq


@pytest.mark.parametrize("ct", ["BOTH", "TEMPORAL", "SPATIAL"])
def test_prolongate_restrict(ct):
    ja, ta = _pair(ct=ct)
    n_c = ja.lattice.coarse_lattice().nedges
    fine, coarse = _links(ja.ndof, 1), _links(n_c, 2)
    _close(ta.restrict(torch.from_numpy(fine)),
           ja.restrict(jnp.asarray(fine)))
    _close(ta.prolongate(torch.from_numpy(coarse), torch.from_numpy(fine)),
           ja.prolongate(jnp.asarray(coarse), jnp.asarray(fine)))
    assert ta._coarsen_case() == ja._coarsen_case()


@pytest.mark.parametrize("beta,renorm", [(4.0, "NONPERTURBATIVE"),
                                         (6.0, "NONPERTURBATIVE"),
                                         (6.0, "PERTURBATIVE"),
                                         (6.0, "NONE")])
def test_beta_coarse_and_chit(beta, renorm):
    ja, ta = _pair(beta=beta, Mt=8, Mx=8, renorm=renorm)
    assert abs(ta.beta_coarse() - ja.beta_coarse()) <= TOL
    assert abs(ta.chit_exact() - ja.chit_exact()) <= TOL
    assert ta.coarse_action().lattice.Mt_lat == 4


def test_special_functions():
    z = np.concatenate([np.linspace(0.0, 60.0, 301), [19.999, 20.0, 20.001]])
    _close(tsp.fast_i0_scaled(torch.from_numpy(z)),
           jsp.fast_i0_scaled(jnp.asarray(z)), 1e-13)
    _close(tsp.log_i0(torch.from_numpy(z)), jsp.log_i0(jnp.asarray(z)),
           1e-12)
    _close(tsp.i0_scaled(torch.from_numpy(z)), jsp.i0_scaled(jnp.asarray(z)),
           1e-13)
    x = np.linspace(-20.0, 20.0, 401)
    _close(tsp.mod_2pi(torch.from_numpy(x)), jsp.mod_2pi(jnp.asarray(x)), 0)
    assert tsp.log_nCk(10, 3) == jsp.log_nCk(10, 3)
    assert tsp.Sigma_hat(0.7, 4) == jsp.Sigma_hat(0.7, 4)
    assert tsp.Phi_chit(3.0, 16) == jsp.Phi_chit(3.0, 16)


def test_distribution_log_densities_and_alphas():
    rs = np.random.default_rng(4)
    x, xp, xm = (rs.uniform(-np.pi, np.pi, 64) for _ in range(3))
    tx, tp, tm = (torch.from_numpy(a) for a in (x, xp, xm))
    jx, jp, jm = (jnp.asarray(a) for a in (x, xp, xm))
    for beta in (0.5, 4.0, 30.0):
        _close(ExpCosDistribution.log_evaluate(tx, beta, tp, tm),
               JExpCos.log_evaluate(jx, beta, jp, jm))
    for beta in (0.25, 4.0, 8.0):
        tb, jb = BesselProductDistribution(beta), JBessel(beta)
        np.testing.assert_allclose(tb.alphaZ, jb.alphaZ, rtol=1e-13, atol=0)
        assert tb.log_I0_twobeta == jb.log_I0_twobeta
        assert tb.sigma_beta == jb.sigma_beta
        _close(tb.log_evaluate(tx, tp, tm), jb.log_evaluate(jx, jp, jm))
    ta_, ja_ = ApproximateBesselProductDistribution(12.0), JApprox(12.0)
    _close(ta_.log_evaluate(tx, tp, tm), ja_.log_evaluate(jx, jp, jm))


@pytest.mark.parametrize("beta", [4.0, 10.0])
def test_conditioned_evaluate(beta):
    ja, ta = _pair(beta=beta, Mt=8, Mx=8)
    th = _links(ja.ndof, 6)
    _close(QuenchedSchwingerConditionedFineAction(ta).evaluate(
        torch.from_numpy(th)), JCond(ja).evaluate(jnp.asarray(th)), 1e-9)


def _ks_pvalue(samples, log_density):
    grid = np.linspace(-np.pi, np.pi, 4001)
    dens = np.exp(log_density(grid))
    cdf = integrate.cumulative_trapezoid(dens, grid, initial=0.0)
    cdf /= cdf[-1]
    return stats.kstest(samples, lambda s: np.interp(s, grid, cdf)).pvalue


@pytest.mark.parametrize("beta", [1.0, 4.0])
def test_fill_draws_ks(beta):
    """The port's own set-up draws (torch.Generator noise) follow the
    densities: ExpCos, BesselProduct (both envelopes) and the large-beta
    mixture, at fixed staples and a fixed seed."""
    g = torch.Generator().manual_seed(2024)
    n = 4000
    xp = torch.full((n,), 0.7, dtype=torch.float64)
    xm = torch.full((n,), -1.3, dtype=torch.float64)
    s = ExpCosDistribution.draw(g, beta, xp, xm).numpy()
    p = _ks_pvalue(s, lambda t: ExpCosDistribution.log_evaluate(
        torch.from_numpy(t), beta, torch.tensor(0.7, dtype=torch.float64),
        torch.tensor(-1.3, dtype=torch.float64)).numpy())
    assert p > 1e-3, p
    for b in (beta, 0.25):
        bp = BesselProductDistribution(b)
        s = bp.draw(g, xp, xm).numpy()
        p = _ks_pvalue(s, lambda t: bp.log_evaluate(
            torch.from_numpy(t), torch.tensor(0.7, dtype=torch.float64),
            torch.tensor(-1.3, dtype=torch.float64)).numpy())
        assert p > 1e-3, (b, p)
    ap = ApproximateBesselProductDistribution(4.0 * beta + 8.0)
    s = ap.draw(g, xp, xm).numpy()
    p = _ks_pvalue(s, lambda t: ap.log_evaluate(
        torch.from_numpy(t), torch.tensor(0.7, dtype=torch.float64),
        torch.tensor(-1.3, dtype=torch.float64)).numpy())
    assert p > 1e-3, p


def test_fill_keeps_coarse_links_and_heatbath_sweep():
    """fill_fine_points only changes fine-only dofs (restrict is kept) and
    the heat-bath sweep stays on the circle."""
    _, ta = _pair(beta=4.0, Mt=8, Mx=8)
    g = torch.Generator().manual_seed(3)
    th = torch.from_numpy(_links(ta.ndof, 7))
    coarse = ta.restrict(th)
    filled = QuenchedSchwingerConditionedFineAction(ta).fill_fine_points(
        g, ta.prolongate(coarse, th))
    d = ta.restrict(filled) - coarse
    assert torch.all(torch.abs(d - 2 * math.pi * torch.round(
        d / (2 * math.pi))) < 1e-12)
    out = ta.heatbath_sweep(g, th)
    assert out.shape == th.shape and torch.all(out.abs() <= math.pi)


def test_twolevel_step_draw_keeps_caches():
    """The plain two-level screen (mc/twolevelstep.py draw): accepted and
    rejected chains alike keep S caches equal to the actions' values."""
    from mlmcpathintegral_tpu_torch.mc.twolevelstep import (
        TwoLevelMetropolisStep,
    )
    _, ta = _pair(beta=4.0, Mt=8, Mx=8)
    cond = QuenchedSchwingerConditionedFineAction(ta)
    step = TwoLevelMetropolisStep(ta.coarse_action(), ta, cond)
    g = torch.Generator().manual_seed(5)
    th = torch.from_numpy(_links(ta.ndof, 8, C=64))
    state = step.init(cond.fill_fine_points(g, th))
    n_acc = 0
    for _ in range(3):
        coarse = torch.from_numpy(
            _links(ta.coarse_action().ndof, 9 + n_acc, C=64))
        state, acc = step.draw(g, state, coarse)
        n_acc += int(acc.sum())
        _close(state.S_fine, ta.evaluate(state.theta), 1e-12)
        _close(state.S_cond, cond.evaluate(state.theta), 1e-12)
    assert 0 < n_acc < 3 * 64


def test_heatbath_sampler_kernel_and_plain_paths():
    """use_pallas draws one kernel seed from the generator and runs the
    sweep op; the plain path runs the action's sweeps."""
    from mlmcpathintegral_tpu_torch.ops.schwinger import (
        schwinger_sweep_chain,
    )
    from mlmcpathintegral_tpu_torch.samplers import (
        HeatBathState, OverrelaxedHeatBathSampler,
    )
    from mlmcpathintegral_tpu_torch.samplers.base import kernel_seed
    _, ta = _pair(beta=2.0, Mt=4, Mx=4)
    th = torch.from_numpy(_links(ta.ndof, 10))
    fused = OverrelaxedHeatBathSampler(ta, use_pallas=True)
    st, q = fused.draw_chain(torch.Generator().manual_seed(1),
                             HeatBathState(x=th), 3)
    want = schwinger_sweep_chain(th, kernel_seed(
        torch.Generator().manual_seed(1)), beta=2.0, Mt=4, Mx=4, n_steps=3)
    assert torch.equal(st.x, want[0]) and torch.equal(q, want[1])
    plain = OverrelaxedHeatBathSampler(ta, n_burnin=3)
    st = plain.prepare(torch.Generator().manual_seed(2), 7, torch.float64,
                       "cpu")
    assert st.x.shape == (7, ta.ndof) and torch.all(st.x.abs() <= math.pi)
    with pytest.raises(NotImplementedError):
        OverrelaxedHeatBathSampler(object())
