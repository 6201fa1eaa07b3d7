"""The port's Gaussian free field (mlmcpathintegral_tpu_torch/models/qft/
gff.py) and the heat-bath sampler's GFF and QM branches against the JAX
package, on the CPU in f64: the same fields (numpy seeds) and, for the
random sweeps and draws, JAX's own normals injected into the port (its
``normal`` replaced by one that hands them over in JAX's order).  The
deterministic pieces (actions, forces, neighbour sums, overrelaxation,
dense matrices, transfers, analytics) agree to 1e-12; so do the sweeps
and draws fed the same normals.  Then a short heat-bath chain on the
plain GFF sweep kernel against the <phi^2> oracle (4 sigma)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCoarsen
from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
from mlmcpathintegral_tpu.lattice import Lattice1D as JLattice1D
from mlmcpathintegral_tpu.models import HarmonicOscillatorAction as JHarm
from mlmcpathintegral_tpu.models.qft.gff import GFFAction as JGFF
from mlmcpathintegral_tpu.samplers import (
    OverrelaxedHeatBathSampler as JHeatBath,
)
from mlmcpathintegral_tpu.samplers.heatbath import (
    HeatBathState as JHeatBathState,
)
from mlmcpathintegral_tpu.utils.special import (
    gff_phi_squared_analytical as j_phi2,
)
from mlmcpathintegral_tpu_torch import convert
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.models import (
    HarmonicOscillatorAction, RotorAction,
)
from mlmcpathintegral_tpu_torch.models import base as mbase
from mlmcpathintegral_tpu_torch.models.qft import gff as mgff
from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
from mlmcpathintegral_tpu_torch.qoi import qoi_2d_phi_squared
from mlmcpathintegral_tpu_torch.samplers import (
    ExactSampler, ExactState, HeatBathState, OverrelaxedHeatBathSampler,
)
from mlmcpathintegral_tpu_torch.utils.special import (
    gff_phi_squared_analytical,
)

torch.set_num_threads(1)

C = 6
TOL = 1e-12

#: (Mt, Mx, coarsening, level, n_gibbs_smooth): plain unrotated, plain
#: rotated, and the smoothed coarse actions of both kinds
CASES = {"unrotated": (8, 6, "BOTH", 0, 0),
         "rotated": (8, 8, "ROTATE", 1, 0),
         "smoothed_unrotated": (4, 6, "BOTH", 0, 2),
         "smoothed_rotated": (6, 4, "ROTATE", 1, 2)}


def _pair(case, mass=1.5):
    Mt, Mx, ct, level, ng = CASES[case]
    ja = JGFF(JLattice2D(Mt, Mx, JCoarsen[ct], level), mass,
              n_gibbs_smooth=ng)
    ta = GFFAction(Lattice2D(Mt, Mx, CoarseningType[ct], level), mass,
                   n_gibbs_smooth=ng)
    return ja, ta


def _phi(n, seed, shape=(C,)):
    return np.random.default_rng(seed).normal(size=shape + (n,))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _feed(monkeypatch, module, arrays):
    """Replace ``module.normal`` by one that returns ``arrays`` in order
    (checking each requested shape)."""
    queue = [np.array(a) for a in arrays]

    def normal(generator, shape, dtype, device):
        z = queue.pop(0)
        assert tuple(shape) == z.shape, (shape, z.shape)
        return torch.from_numpy(z).to(dtype)
    monkeypatch.setattr(module, "normal", normal)
    return queue


@pytest.mark.parametrize("case", sorted(CASES))
def test_action_matches_jax(case):
    ja, ta = _pair(case)
    x = _phi(ta.ndof, 1, (2, C))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert (ta.a_lat, ta.mu2, ta.ndof) == (ja.a_lat, ja.mu2, ja.ndof)
    _close(ta.evaluate(tx), ja.evaluate(jx))
    _close(ta.force(tx), ja.force(jx))
    _close(ta._nbsum(tx), ja._nbsum(jx))
    _close(ta.overrelaxation_sweep(tx[0]), ja.overrelaxation_sweep(jx[0]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_heatbath_sweep_matches_jax_on_injected_noise(monkeypatch, case):
    ja, ta = _pair(case)
    x = _phi(ta.ndof, 2)
    key = jax.random.PRNGKey(3)
    if ta.n_gibbs_smooth:
        noise = [jax.random.normal(key, (ta.ndof, C), jnp.float64)]
    else:
        noise = [jax.random.normal(k, (C, len(colour)), jnp.float64)
                 for k, colour in zip(jax.random.split(key),
                                      ta._colour_masks)]
    left = _feed(monkeypatch, mgff, noise)
    _close(ta.heatbath_sweep(None, torch.from_numpy(x)),
           ja.heatbath_sweep(key, jnp.asarray(x)))
    assert not left


@pytest.mark.parametrize("case", sorted(CASES))
def test_exact_draws_match_jax_on_injected_noise(monkeypatch, case):
    ja, ta = _pair(case)
    key = jax.random.PRNGKey(4)
    z = jax.random.normal(key, (C, ta.ndof), jnp.float64)
    _feed(monkeypatch, mgff, [z])
    got = ta.exact_draw(None, C, torch.float64, "cpu")
    assert got.is_contiguous() and got.dtype == torch.float64
    _close(got, ja.exact_draw(key, C, jnp.float64))
    _feed(monkeypatch, mgff, [z])
    tx, ts = ta.exact_draw_with_action(None, C, torch.float64, "cpu")
    jx, js = ja.exact_draw_with_action(key, C, jnp.float64)
    _close(tx, jx)
    _close(ts, js, 1e-10)
    # the closed-form action is the action of the draw
    _close(ts, ta.evaluate(tx), 1e-10)


def test_gibbs_sweep_eff_matches_jax_on_injected_noise(monkeypatch):
    ja, ta = _pair("smoothed_rotated")
    x = _phi(ta.ndof, 5)
    key = jax.random.PRNGKey(6)
    groups = ta._eff_colour_groups
    noise = [jax.random.normal(k, (C, len(g)), jnp.float64)
             for k, g in zip(jax.random.split(key, len(groups)), groups)]
    _feed(monkeypatch, mgff, noise)
    _close(ta.gibbs_sweep_eff(None, torch.from_numpy(x)),
           ja.gibbs_sweep_eff(key, jnp.asarray(x)))


@pytest.mark.parametrize("case", ["smoothed_unrotated", "smoothed_rotated"])
def test_dense_matrices_match_jax(case):
    ja, ta = _pair(case)
    assert [list(g) for g in ta._eff_colour_groups] == \
        [list(g) for g in ja._eff_colour_groups]
    for name in ("_Q_precision", "_Q_eff", "_smoother_matrices", "_Q_hat",
                 "_dense_sqrt_cov", "_dense_sqrt_cov_hat"):
        _close(getattr(ta, name), getattr(ja, name), 1e-10)
    _close(ta._spectral_sqrt_inv if not ta.lattice.rotated else 0.0,
           ja._spectral_sqrt_inv if not ja.lattice.rotated else 0.0)


def test_analytics_and_transfer_match_jax():
    for case in ("unrotated", "rotated"):
        ja, ta = _pair(case, mass=3.0)
        assert ta.phi_squared_analytical() == pytest.approx(
            ja.phi_squared_analytical(), rel=1e-13)
    assert gff_phi_squared_analytical(10.0, 16, 16) == j_phi2(10.0, 16, 16)
    # unrotated -> rotated -> unrotated: both transfer kinds
    for ct, Mt, Mx, level in (("ROTATE", 8, 8, 0), ("ROTATE", 8, 8, 1),
                              ("BOTH", 8, 4, 0)):
        ja = JGFF(JLattice2D(Mt, Mx, JCoarsen[ct], level), 2.0)
        ta = GFFAction(Lattice2D(Mt, Mx, CoarseningType[ct], level), 2.0)
        jc, tc = ja.coarse_action(), ta.coarse_action()
        assert (tc.n_gibbs_smooth, tc.omega, tc.mu2, tc.ndof) == \
            (jc.n_gibbs_smooth, jc.omega, jc.mu2, jc.ndof)
        assert ta.info_string() == ja.info_string()
        xf, xc = _phi(ta.ndof, 7), _phi(tc.ndof, 8)
        _close(ta.restrict(torch.from_numpy(xf)),
               ja.restrict(jnp.asarray(xf)))
        _close(ta.prolongate(torch.from_numpy(xc), torch.from_numpy(xf)),
               ja.prolongate(jnp.asarray(xc), jnp.asarray(xf)))


def test_gff_state_carries_between_the_packages():
    x = _phi(64, 9)
    st = convert.to_torch(JHeatBathState(x=jnp.asarray(x)), device="cpu")
    assert type(st) is HeatBathState and st.x.dtype == torch.float64
    back = convert.to_numpy(st, types={"HeatBathState": JHeatBathState})
    assert type(back) is JHeatBathState
    np.testing.assert_array_equal(back.x, x)


def test_sampler_use_pallas_gating():
    """use_pallas is accepted for the plain, unrotated GFF (and the
    Schwinger action and the rotor) and refused for the smoothed or
    rotated GFF and for the oscillators, as in JAX."""
    lat = Lattice2D(8, 8, CoarseningType.ROTATE)
    s = OverrelaxedHeatBathSampler(GFFAction(lat, 1.0), use_pallas=True)
    assert s._kind == "gff" and s.host_seeded
    JHeatBath(JGFF(JLattice2D(8, 8, JCoarsen.ROTATE), 1.0), use_pallas=True)
    refused = [GFFAction(lat, 1.0, n_gibbs_smooth=2),
               GFFAction(lat.coarse_lattice(), 1.0),
               HarmonicOscillatorAction(Lattice1D(16, 4.0))]
    for act in refused:
        with pytest.raises(ValueError, match="use_pallas"):
            OverrelaxedHeatBathSampler(act, use_pallas=True)
    assert not OverrelaxedHeatBathSampler(refused[0]).host_seeded
    with pytest.raises(ValueError, match="use_pallas"):
        JHeatBath(JGFF(JLattice2D(8, 8, JCoarsen.ROTATE), 1.0,
                       n_gibbs_smooth=2), use_pallas=True)
    with pytest.raises(ValueError, match="even M_lat"):
        OverrelaxedHeatBathSampler(RotorAction(Lattice1D(15, 4.0), m0=0.25))


def test_harmonic_heatbath_draw_matches_jax(monkeypatch):
    """The generic 1-D even/odd branch on the harmonic oscillator: one
    draw of 1 overrelax + 2 heat-bath sweeps on JAX's normals."""
    M = 16
    ja = JHarm(JLattice1D(M, 4.0), m0=1.0, mu2=1.0)
    ta = HarmonicOscillatorAction(Lattice1D(M, 4.0), m0=1.0, mu2=1.0)
    js = JHeatBath(ja, n_sweep_heatbath=2, n_sweep_overrelax=1)
    ts = OverrelaxedHeatBathSampler(ta, n_sweep_heatbath=2,
                                    n_sweep_overrelax=1)
    x = _phi(M, 10)
    key = jax.random.PRNGKey(11)
    noise, k = [], key
    for _ in range(2):
        k0, k1, k = jax.random.split(k, 3)
        noise += [jax.random.normal(kk, (C, M // 2), jnp.float64)
                  for kk in (k0, k1)]
    left = _feed(monkeypatch, mbase, noise)
    (tstate, tacc) = ts.draw(None, HeatBathState(x=torch.from_numpy(x)))
    (jstate, jacc) = js.draw(key, JHeatBathState(x=jnp.asarray(x)))
    _close(tstate.x, jstate.x)
    assert bool(tacc.all()) and not left


def test_exact_sampler_batch_with_action_is_closed_form(monkeypatch):
    _, ta = _pair("smoothed_rotated")
    z = _phi(ta.ndof, 12, (3 * C,))
    _feed(monkeypatch, mgff, [z])
    s = ExactSampler(ta)
    state, xs, S = s.draw_batch_with_action(
        None, ExactState(x=torch.zeros(C, ta.ndof, dtype=torch.float64)), 3)
    assert xs.shape == (3, C, ta.ndof) and S.shape == (3, C)
    _close(S, 0.5 * (torch.from_numpy(z) ** 2).sum(-1).reshape(3, C))
    _close(S, ta.evaluate(xs), 1e-10)
    _close(state.x, xs[-1], 0.0)


def test_heatbath_chain_matches_phi_squared():
    """A chain driven by the plain GFF sweep kernel (the sampler with
    use_pallas on CPU tensors) reproduces the spectral-sum <phi^2> oracle
    (the port's twin of the JAX package's test of the same name)."""
    Mt, Mx, C_, mass = 8, 8, 512, 1.0
    act = GFFAction(Lattice2D(Mt, Mx, CoarseningType.BOTH), mass)
    sampler = OverrelaxedHeatBathSampler(act, use_pallas=True)
    qoi = qoi_2d_phi_squared(act)
    state = HeatBathState(x=torch.zeros(C_, act.ndof, dtype=torch.float32))
    gen = torch.Generator().manual_seed(5)
    for _ in range(40):                      # burn-in
        state, _ = sampler.draw(gen, state)
    vals = []
    for _ in range(200):
        state, _ = sampler.draw(gen, state)
        vals.append(qoi(state.x).double())
    vals = torch.cat(vals).numpy()
    est = vals.mean()
    err = vals.std() / np.sqrt(len(vals) / (2 * 5.0))   # tau <~ 5
    oracle = act.phi_squared_analytical()
    assert abs(est - oracle) < 4 * err, (est, err, oracle)
