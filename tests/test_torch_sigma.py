"""The port's O(3) sigma model (models/qft/nonlinearsigma.py), CompactExp
distribution, conditioned sigma fill and 2-D Wolff cluster sampler
against the JAX package, on the CPU in f64.  Deterministic pieces (the
action, force, vector maps, overrelaxation, transfers, the reflection
and flip hooks, chi_m, the fill's evaluate) agree to 1e-12 on the same
numpy-made states; so do the heat bath in both forms, the combined
sweeps and the conditioned fill fed JAX's own uniforms (the port's
``uniform`` replaced by one that hands them over in JAX's order: for each
colour update the CompactExp uniforms, then the azimuth uniforms).  Then
the guards the JAX package lacks, and the stochastic paths against each
other: the CompactExp mean, the cluster sampler against the heat bath in
chi_m, and the two-level method against the single-level one (4 sigma)."""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.conditioned.sigma import (
    NonlinearSigmaConditionedFineAction as JCond,
)
from mlmcpathintegral_tpu.distributions.compactexp import (
    CompactExpDistribution as JCompactExp,
)
from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCoarsen
from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
from mlmcpathintegral_tpu.models.base import RenormalisationType as JRenorm
from mlmcpathintegral_tpu.models.qft import nonlinearsigma as jsig
from mlmcpathintegral_tpu.samplers.cluster2d import (
    Cluster2DState as JCluster2DState,
)
from mlmcpathintegral_tpu.samplers.heatbath import (
    OverrelaxedHeatBathSampler as JHeatBath,
)
from mlmcpathintegral_tpu_torch import convert
from mlmcpathintegral_tpu_torch.conditioned.sigma import (
    NonlinearSigmaConditionedFineAction,
)
from mlmcpathintegral_tpu_torch.distributions import compactexp
from mlmcpathintegral_tpu_torch.distributions.compactexp import (
    CompactExpDistribution,
)
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.mc import (
    MonteCarloSingleLevel, MonteCarloTwoLevel,
)
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.qft import nonlinearsigma as tsig
from mlmcpathintegral_tpu_torch.samplers import (
    Cluster2DSampler, Cluster2DState, OverrelaxedHeatBathSampler,
)
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics

torch.set_num_threads(1)

C = 5
TOL = 1e-12
BETA = 1.5

#: (Mt, Mx, level): the unrotated 8x6 and the rotated 8x8 members of the
#: rotate hierarchy
CASES = {"unrotated": (8, 6, 0), "rotated": (8, 8, 1)}


def _pair(case, beta=BETA, renorm="NONE"):
    Mt, Mx, level = CASES[case]
    ja = jsig.NonlinearSigmaAction(
        JLattice2D(Mt, Mx, JCoarsen.ROTATE, level), beta, JRenorm[renorm])
    ta = tsig.NonlinearSigmaAction(
        Lattice2D(Mt, Mx, CoarseningType.ROTATE, level), beta,
        RenormalisationType[renorm])
    return ja, ta


def _state(n_vertices, seed, shape=(C,)):
    """Angle states of numpy-made unit vectors: [*shape, 2N]."""
    v = np.random.default_rng(seed).normal(size=shape + (n_vertices, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return np.array(jsig.vec_to_angles(jnp.asarray(v)))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _feed(monkeypatch, modules, arrays, name="uniform"):
    """Replace ``name`` in each of ``modules`` by one function that returns
    ``arrays`` in order (checking each requested shape)."""
    queue = [np.array(a) for a in arrays]

    def fed(generator, shape, dtype, device, *bounds):
        z = queue.pop(0)
        assert tuple(shape) == z.shape, (shape, z.shape)
        return torch.from_numpy(z).to(dtype)
    for module in modules:
        monkeypatch.setattr(module, name, fed)
    return queue


def _colour_noise(key, shape):
    """The uniforms JAX's _heatbath_colour draws with ``key``: CompactExp,
    then the azimuth on [-pi, pi)."""
    k1, k2 = jax.random.split(key)
    return [jax.random.uniform(k1, shape, jnp.float64),
            jax.random.uniform(k2, shape, jnp.float64, -math.pi, math.pi)]


def test_compactexp_matches_jax_and_its_mean():
    sigma = np.random.default_rng(0).uniform(0.01, 30.0, size=(7, 9))
    key = jax.random.PRNGKey(1)
    u = jax.random.uniform(key, sigma.shape, jnp.float64)
    _close(CompactExpDistribution.transform(torch.from_numpy(np.array(u)),
                                            torch.from_numpy(sigma)),
           JCompactExp.draw(key, jnp.asarray(sigma)))
    x = np.random.default_rng(2).uniform(-1.0, 1.0, size=sigma.shape)
    _close(CompactExpDistribution.log_evaluate(torch.from_numpy(x),
                                               torch.from_numpy(sigma)),
           JCompactExp.log_evaluate(jnp.asarray(x), jnp.asarray(sigma)))
    _close(CompactExpDistribution.evaluate(torch.from_numpy(x), 3.0),
           JCompactExp.evaluate(jnp.asarray(x), 3.0))
    # the mean coth(sigma) - 1/sigma, as the JAX package's test
    gen = torch.Generator().manual_seed(3)
    for s in (0.5, 2.0, 20.0):
        draws = CompactExpDistribution.draw(
            gen, torch.full((200_000,), s, dtype=torch.float64))
        assert torch.all(draws.abs() <= 1.0)
        assert float(draws.mean()) == pytest.approx(
            1.0 / math.tanh(s) - 1.0 / s, abs=3e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_action_force_and_vector_maps_match_jax(case):
    ja, ta = _pair(case)
    x = _state(ta.lattice.nvertices, 4, (2, C))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    assert ta.ndof == ja.ndof
    _close(ta.evaluate(tx), ja.evaluate(jx))
    _close(ta.force(tx), ja.force(jx))
    vec = tsig.angles_to_vec(tx)
    _close(vec, jsig.angles_to_vec(jx))
    _close(tsig.vec_to_angles(vec), jsig.vec_to_angles(jnp.asarray(
        vec.numpy())))
    _close(ta.delta_neighbours(vec), ja.delta_neighbours(jnp.asarray(
        vec.numpy())))
    assert [list(c) for c in ta._colour_masks] == \
        [list(c) for c in ja._colour_masks]
    # the per-spin geometry helpers
    h = vec / torch.linalg.norm(vec, dim=-1, keepdim=True)
    jh = jnp.asarray(h.numpy())
    _close(ta._perp(h), ja._perp(jh))
    ang = torch.from_numpy(np.random.default_rng(5).uniform(
        -math.pi, math.pi, size=h.shape[:-1]))
    _close(ta._rodrigues(vec, h, ang),
           ja._rodrigues(jnp.asarray(vec.numpy()), jh,
                         jnp.asarray(ang.numpy())))


@pytest.mark.parametrize("case", sorted(CASES))
def test_overrelaxation_both_forms_match_jax(case):
    ja, ta = _pair(case)
    x = _state(ta.lattice.nvertices, 6)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(ta.overrelaxation_sweep(tx), ja.overrelaxation_sweep(jx))
    _close(ta.combined_sweeps(None, tx, 2, 0),
           ja.combined_sweeps(jax.random.PRNGKey(0), jx, 2, 0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_heatbath_sweep_matches_jax_on_injected_noise(monkeypatch, case):
    ja, ta = _pair(case)
    x = _state(ta.lattice.nvertices, 7)
    key = jax.random.PRNGKey(8)
    noise = []
    for k, colour in zip(jax.random.split(key), ta._colour_masks):
        noise += _colour_noise(k, (C, len(colour)))
    left = _feed(monkeypatch, (tsig, compactexp), noise)
    _close(ta.heatbath_sweep(None, torch.from_numpy(x)),
           ja.heatbath_sweep(key, jnp.asarray(x)))
    assert not left


@pytest.mark.parametrize("case", sorted(CASES))
def test_combined_sweeps_match_jax_on_injected_noise(monkeypatch, case):
    """One overrelaxation and two heat-bath sweeps: the grid form on the
    unrotated lattice (full-grid noise a colour, chain-major here,
    chain-minor in JAX), the gather form on the rotated one."""
    ja, ta = _pair(case)
    x = _state(ta.lattice.nvertices, 9)
    key = jax.random.PRNGKey(10)
    noise, k = [], key
    Mt, Mx = ta.lattice.Mt_lat, ta.lattice.Mx_lat
    for _ in range(2):
        if ta.lattice.rotated:
            k, sub = jax.random.split(k)
            for kc, colour in zip(jax.random.split(sub), ta._colour_masks):
                noise += _colour_noise(kc, (C, len(colour)))
        else:
            k, k1, k2 = jax.random.split(k, 3)
            for kc in (k1, k2):
                noise += [jnp.moveaxis(u, -1, 0)
                          for u in _colour_noise(kc, (Mx, Mt, C))]
    left = _feed(monkeypatch, (tsig, compactexp), noise)
    got = ta.combined_sweeps(None, torch.from_numpy(x), 1, 2)
    _close(got, ja.combined_sweeps(key, jnp.asarray(x), 1, 2))
    assert not left
    # the sampler's draw goes through the same hook
    _feed(monkeypatch, (tsig, compactexp), noise)
    s = OverrelaxedHeatBathSampler(ta, n_sweep_heatbath=2,
                                   n_sweep_overrelax=1)
    st, acc = s.draw(None, Cluster2DState(x=torch.from_numpy(x)))
    _close(st.x, got, 0.0)
    assert bool(acc.all())


@pytest.mark.parametrize("renorm", ["NONE", "PERTURBATIVE"])
def test_transfers_hooks_and_chi_m_match_jax(monkeypatch, renorm):
    for case in sorted(CASES):
        ja, ta = _pair(case, renorm=renorm)
        jc, tc = ja.coarse_action(), ta.coarse_action()
        assert tc.beta == jc.beta and tc.ndof == jc.ndof
        assert ta.info_string() == ja.info_string()
        xf = _state(ta.lattice.nvertices, 11)
        xc = _state(tc.lattice.nvertices, 12)
        _close(ta.restrict(torch.from_numpy(xf)),
               ja.restrict(jnp.asarray(xf)))
        _close(ta.prolongate(torch.from_numpy(xc), torch.from_numpy(xf)),
               ja.prolongate(jnp.asarray(xc), jnp.asarray(xf)))
        _close(tsig.qoi_magnetic_susceptibility(ta)(torch.from_numpy(xf)),
               jsig.qoi_magnetic_susceptibility(ja)(jnp.asarray(xf)))
    with pytest.raises(NotImplementedError):
        _pair("unrotated", renorm="NONPERTURBATIVE")[1].coarse_action()
    # reflection vectors on JAX's normals, the bond energy and the flip
    key = jax.random.PRNGKey(13)
    z = jax.random.normal(key, (C, 3), jnp.float64)
    _feed(monkeypatch, (tsig,), [z], name="normal")
    r = ta.new_reflection(None, C, torch.float64, "cpu")
    _close(r, ja.new_reflection(key, C, jnp.float64))
    vec = tsig.angles_to_vec(torch.from_numpy(xf))
    jvec, jr = jnp.asarray(vec.numpy()), jnp.asarray(r.numpy())[:, None, :]
    _close(ta.flip_vec(vec, r[:, None, :]), ja.flip_vec(jvec, jr))
    _close(ta.S_ell_vec(vec[:, :-1], vec[:, 1:], r[:, None, :]),
           ja.S_ell_vec(jvec[:, :-1], jvec[:, 1:], jr))


@pytest.mark.parametrize("case", sorted(CASES))
def test_conditioned_fill_and_evaluate_match_jax(monkeypatch, case):
    ja, ta = _pair(case)
    jcond, tcond = JCond(ja), NonlinearSigmaConditionedFineAction(ta)
    x = _state(ta.lattice.nvertices, 14)
    _close(tcond.evaluate(torch.from_numpy(x)), jcond.evaluate(
        jnp.asarray(x)))
    key = jax.random.PRNGKey(15)
    _feed(monkeypatch, (tsig, compactexp), _colour_noise(
        key, (C, len(ta.lattice.fineonly_vertices))))
    got = tcond.fill_fine_points(None, torch.from_numpy(x))
    _close(got, jcond.fill_fine_points(key, jnp.asarray(x)))
    _close(tcond.evaluate(got), jcond.evaluate(jnp.asarray(got.numpy())))
    # the coarse spins stay (up to the angle-vector round trip)
    dofs = tsig.NonlinearSigmaAction._dof_map(ta.lattice.coarse_vertices)
    _close(got[:, dofs], x[:, dofs])


def test_guards_the_jax_package_lacks():
    # odd extents on an unrotated lattice: the checkerboard breaks detailed
    # balance (the JAX package accepts them)
    for Mt, Mx in ((7, 8), (8, 5)):
        jsig.NonlinearSigmaAction(JLattice2D(Mt, Mx, JCoarsen.ROTATE), 1.0)
        with pytest.raises(ValueError, match="even Mt_lat and Mx_lat"):
            tsig.NonlinearSigmaAction(
                Lattice2D(Mt, Mx, CoarseningType.ROTATE), 1.0)
    # the hierarchy: CoarsenRotate only, in both packages
    for mod, lat in ((tsig, Lattice2D(8, 8, CoarseningType.BOTH)),
                     (jsig, JLattice2D(8, 8, JCoarsen.BOTH))):
        with pytest.raises(ValueError, match="CoarsenRotate"):
            mod.NonlinearSigmaAction(lat, 1.0)
    # the fill's all-coarse-neighbours check, the same error as JAX's
    for cls, lat in ((NonlinearSigmaConditionedFineAction,
                      Lattice2D(8, 8, CoarseningType.BOTH)),
                     (JCond, JLattice2D(8, 8, JCoarsen.BOTH))):
        with pytest.raises(ValueError, match="all-coarse neighbours"):
            cls(types.SimpleNamespace(lattice=lat, beta=1.0))
    # a spin whose four neighbours cancel: NaN in JAX, finite here (beta *
    # max(|Delta|, 1e-30) in the CompactExp draw), in the gather and the
    # grid form
    ja, ta = _pair("unrotated")
    Mt, Mx, N = ta.lattice.Mt_lat, ta.lattice.Mx_lat, ta.lattice.nvertices
    v = np.zeros((1, N, 3))
    v[..., 2] = 1.0
    for nb, s in zip(ta._nn[0], (1.0, -1.0, 1.0, -1.0)):
        v[0, nb, 2] = s
    red = ta._colour_masks[0]
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    assert np.isnan(np.asarray(ja._heatbath_colour(
        key, jnp.asarray(v), red))).any()
    out = ta._heatbath_colour(gen, torch.from_numpy(v), red)
    assert torch.isfinite(out).all()
    planes = [v[..., c].reshape(1, Mx, Mt) for c in range(3)]
    mask = ta._grid_red
    assert np.isnan(np.asarray(ja._grid_heatbath_colour(
        key, tuple(jnp.asarray(np.moveaxis(p, 0, -1)) for p in planes),
        mask[..., None]))).any()
    out = ta._grid_heatbath_colour(
        gen, tuple(torch.from_numpy(p) for p in planes),
        torch.from_numpy(mask))
    assert all(torch.isfinite(p).all() for p in out)
    # the fused sweep kernels take no sigma action, as in JAX
    for cls, act in ((OverrelaxedHeatBathSampler, ta), (JHeatBath, ja)):
        with pytest.raises(ValueError, match="use_pallas requires"):
            cls(act, use_pallas=True)


def test_sigma_state_carries_between_the_packages():
    x = _state(48, 16)
    st = convert.to_torch(JCluster2DState(x=jnp.asarray(x)), device="cpu")
    assert type(st) is Cluster2DState and st.x.dtype == torch.float64
    back = convert.to_numpy(st, types={"Cluster2DState": JCluster2DState})
    assert type(back) is JCluster2DState
    np.testing.assert_array_equal(back.x, x)


def _chain_chi(sampler, act, seed, n_keep, C=32):
    """chi_m (average, error) over n_keep draws of C chains."""
    qoi = tsig.qoi_magnetic_susceptibility(act)
    gen = torch.Generator().manual_seed(seed)
    st = sampler.prepare(gen, C, torch.float64, "cpu")
    stats = Statistics("m", 40)
    s = stats.init(C, torch.float64, "cpu")
    qs = []
    for _ in range(n_keep):
        st, _ = sampler.draw(gen, st)
        qs.append(qoi(sampler.x_of(st)))
    s = stats_mod.record_block(s, torch.stack(qs))
    return stats.average(s), stats.error(s)


def test_cluster2d_agrees_with_heatbath():
    """The Wolff cluster sampler against the heat bath in chi_m on the
    rotate hierarchy's 8x8 fine lattice (4 sigma)."""
    act = tsig.NonlinearSigmaAction(Lattice2D(8, 8, CoarseningType.ROTATE),
                                    BETA)
    a1, e1 = _chain_chi(Cluster2DSampler(act, n_burnin=30, n_updates=3),
                        act, 21, 120)
    a2, e2 = _chain_chi(OverrelaxedHeatBathSampler(
        act, n_sweep_heatbath=2, n_sweep_overrelax=1, n_burnin=200),
        act, 22, 300)
    assert abs(a1 - a2) < 4 * math.hypot(e1, e2), (a1, a2, e1, e2)


def test_sigma_twolevel_matches_singlelevel():
    """The two-level screened chain against an independent single-level
    heat-bath estimate of chi_m (no closed-form oracle), 8x8."""
    act = tsig.NonlinearSigmaAction(Lattice2D(8, 8, CoarseningType.ROTATE),
                                    BETA)
    qoi_factory = tsig.qoi_magnetic_susceptibility

    def heatbath(a):
        return OverrelaxedHeatBathSampler(a, n_sweep_heatbath=2,
                                          n_sweep_overrelax=1, n_burnin=100)

    mc1 = MonteCarloSingleLevel(act, qoi_factory(act), heatbath(act),
                                n_burnin=200, n_samples=4000,
                                n_autocorr_window=40, chunk_size=100)
    _, st1 = mc1.evaluate(31, 64, torch.float64, "cpu")
    a1, e1 = mc1.numerical_result(st1), mc1.statistical_error(st1)
    mc2 = MonteCarloTwoLevel(act, qoi_factory, heatbath,
                             NonlinearSigmaConditionedFineAction,
                             n_burnin=200, n_samples=4000, chunk_size=100)
    st2 = mc2.evaluate_difference(32, 64, torch.float64, "cpu")
    a2 = mc2.stats_fine.average(st2["fine"])
    e2 = mc2.stats_fine.error(st2["fine"])
    assert mc2.p_accept > 0.2, mc2.p_accept
    assert abs(a1 - a2) < 4 * math.hypot(e1, e2), (a1, a2, e1, e2)
