"""The port's conditioned GFF fill (conditioned/gff.py) and the batched
screen's choice of its one-pass hooks (mc/twolevel.py
``make_batched_screen``) against the JAX package, on the CPU in f64: the
fill, ``evaluate``, ``fill_with_logq`` and ``fill_with_logq_sf`` on the
unrotated grid, the rotated lattice and the Gibbs-smoothed actions (where
the one-pass hook is shadowed to None), fed JAX's own normals; the hooks
against fill + evaluate; the all-coarse-neighbours check; the screen on
the two fine levels of a three-level hierarchy (the one-pass branch on the
unrotated level, fill_with_logq on the rotated, smoothed one) against
JAX's, with JAX's fill normals and accept uniforms handed over; then the
two-level method with heat-bath coarse chains against the <phi^2> oracle
(4 sigma)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.conditioned.gff import (
    GFFConditionedFineAction as JCond,
)
from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCoarsen
from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
from mlmcpathintegral_tpu.mc.twolevel import (
    make_batched_screen as j_make_batched_screen,
)
from mlmcpathintegral_tpu.mc.twolevelstep import (
    TwoLevelMetropolisStep as JTLStep,
)
from mlmcpathintegral_tpu.models.qft.gff import GFFAction as JGFF
from mlmcpathintegral_tpu.qoi import qoi_2d_phi_squared as j_qoi
from mlmcpathintegral_tpu_torch.conditioned import gff as cgff
from mlmcpathintegral_tpu_torch.conditioned.gff import (
    GFFConditionedFineAction,
)
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.mc import MonteCarloTwoLevel, twolevel
from mlmcpathintegral_tpu_torch.mc.twolevelstep import (
    TwoLevelMetropolisStep,
)
from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
from mlmcpathintegral_tpu_torch.qoi import qoi_2d_phi_squared
from mlmcpathintegral_tpu_torch.samplers import OverrelaxedHeatBathSampler

torch.set_num_threads(1)

C = 4
TOL = 1e-12
MASS = 3.0

#: (Mt, Mx, level, n_gibbs_smooth) on the rotate hierarchy: the unrotated
#: grid, the rotated lattice, and the smoothed (coarse-level) actions of
#: both kinds
CASES = {"grid": (8, 8, 0, 0), "rotated": (8, 8, 1, 0),
         "smoothed": (8, 8, 0, 2), "smoothed_rotated": (8, 8, 1, 2)}


def _pair(case):
    Mt, Mx, level, ng = CASES[case]
    ja = JGFF(JLattice2D(Mt, Mx, JCoarsen.ROTATE, level), MASS,
              n_gibbs_smooth=ng)
    ta = GFFAction(Lattice2D(Mt, Mx, CoarseningType.ROTATE, level), MASS,
                   n_gibbs_smooth=ng)
    return ja, ta


def _phi(n, seed, shape=(C,)):
    return np.random.default_rng(seed).normal(size=shape + (n,))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


class _Queue:
    """Stands in for ``normal`` / ``uniform``: hands over the given
    arrays in order, checking each requested shape."""

    def __init__(self, *arrays):
        self.arrays = [torch.from_numpy(np.array(a)) for a in arrays]

    def __call__(self, generator, shape, dtype, device, *bounds):
        z = self.arrays.pop(0)
        assert tuple(shape) == tuple(z.shape), (shape, z.shape)
        return z.to(dtype)


def _fill_shape(ta, lead=(C,)):
    """The normals a fill draws: the whole grid on an unrotated lattice,
    the fine-only vertices on a rotated one."""
    n = (len(ta.lattice.fineonly_vertices) if ta.lattice.rotated
         else ta.ndof)
    return lead + (n,)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fill_and_evaluate_match_jax_on_injected_noise(monkeypatch, case):
    ja, ta = _pair(case)
    jcond, tcond = JCond(ja), GFFConditionedFineAction(ta)
    # the one-pass hook is shadowed where its closed form does not hold
    assert (tcond.fill_with_logq_sf is None) == \
        (jcond.fill_with_logq_sf is None) == (case != "grid")
    x = _phi(ta.ndof, 1)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(tcond.evaluate(tx), jcond.evaluate(jx))
    key = jax.random.PRNGKey(2)
    xi = jax.random.normal(key, _fill_shape(ta), jnp.float64)
    monkeypatch.setattr(cgff, "normal", _Queue(xi, xi, xi))
    got = tcond.fill_fine_points(None, tx)
    _close(got, jcond.fill_fine_points(key, jx))
    _close(tcond.evaluate(got), jcond.evaluate(jnp.asarray(got.numpy())))
    g, s_q = tcond.fill_with_logq(None, tx)
    jg, js_q = jcond.fill_with_logq(key, jx)
    _close(g, jg)
    _close(s_q, js_q)
    if case == "grid":
        g, s_q, s_f = tcond.fill_with_logq_sf(None, tx)
        for a, b in zip((g, s_q, s_f), jcond.fill_with_logq_sf(key, jx)):
            _close(a, b)
    # the coarse vertices stay
    cv = ta.lattice.coarse_vertices
    _close(got[:, cv], x[:, cv], 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_pass_hooks_equal_fill_then_evaluate(monkeypatch, case):
    _, ta = _pair(case)
    cond = GFFConditionedFineAction(ta)
    x = torch.from_numpy(_phi(ta.ndof, 3, (2, C)))
    xi = np.random.default_rng(4).normal(size=_fill_shape(ta, (2, C)))
    monkeypatch.setattr(cgff, "normal", _Queue(xi, xi, xi))
    filled = cond.fill_fine_points(None, x)
    g, s_q = cond.fill_with_logq(None, x)
    _close(g, filled, 0.0)
    _close(s_q, cond.evaluate(filled), 1e-10)
    if cond.fill_with_logq_sf is not None:
        g, s_q, s_f = cond.fill_with_logq_sf(None, x)
        _close(g, filled, 0.0)
        _close(s_q, cond.evaluate(filled), 1e-10)
        _close(s_f, ta.evaluate(filled), 1e-10)


def test_all_coarse_neighbours_check_matches_jax():
    """Both-direction coarsening leaves fine-only vertices with fine-only
    neighbours: both packages refuse the fill, with the same error."""
    errors = []
    for cls, act in ((GFFConditionedFineAction,
                      GFFAction(Lattice2D(8, 8, CoarseningType.BOTH), 1.0)),
                     (JCond, JGFF(JLattice2D(8, 8, JCoarsen.BOTH), 1.0))):
        with pytest.raises(ValueError) as e:
            cls(act)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "only coarse" in errors[0]


def _levels():
    """The two fine levels of the 8x8 rotate hierarchy with its smoothed
    coarse actions, in both packages: [(JAX fine, JAX coarse, port fine,
    port coarse)]."""
    ja = JGFF(JLattice2D(8, 8, JCoarsen.ROTATE), MASS)
    ta = GFFAction(Lattice2D(8, 8, CoarseningType.ROTATE), MASS)
    out = []
    for _ in range(2):
        jc, tc = ja.coarse_action(), ta.coarse_action()
        out.append((ja, jc, ta, tc))
        ja, ta = jc, tc
    return out


def test_screen_takes_each_levels_one_pass_hook(monkeypatch):
    """The probe order of the JAX package: fill_with_logq_sf on the
    unrotated plain level, fill_with_logq on the rotated smoothed one
    (its _sf is None); the plain fill + evaluate only for a fill with
    neither hook."""
    calls = []
    for name in ("fill_with_logq_sf", "fill_with_logq", "fill_fine_points"):
        orig = getattr(GFFConditionedFineAction, name)

        def spy(self, *a, _orig=orig, _name=name):
            calls.append(_name)
            return _orig(self, *a)
        monkeypatch.setattr(GFFConditionedFineAction, name, spy)
    gen = torch.Generator().manual_seed(0)
    for (_, _, tf, tc), want in zip(_levels(), ("fill_with_logq_sf",
                                                "fill_with_logq")):
        cond = GFFConditionedFineAction(tf)
        tl = TwoLevelMetropolisStep(tc, tf, cond).init(
            torch.from_numpy(_phi(tf.ndof, 5)))
        screen = twolevel.make_batched_screen(
            tf, tc, cond, qoi_2d_phi_squared(tf), qoi_2d_phi_squared(tc))
        calls.clear()
        screen(gen, tl, torch.from_numpy(_phi(tc.ndof, 6, (3, C))))
        assert calls == [want], (tf.info_string(), calls)
    # a fill without the hooks: fill, then evaluate
    _, _, tf, tc = _levels()[0]
    plain = types.SimpleNamespace(
        fill_fine_points=lambda g, x: x + 1.0,
        evaluate=lambda x: torch.sum(x * x, dim=-1))
    tl = TwoLevelMetropolisStep(tc, tf, plain).init(
        torch.from_numpy(_phi(tf.ndof, 7)))
    screen = twolevel.make_batched_screen(tf, tc, plain,
                                          qoi_2d_phi_squared(tf),
                                          qoi_2d_phi_squared(tc))
    tl2, qf, _, _ = screen(gen, tl, torch.from_numpy(_phi(tc.ndof, 8,
                                                          (2, C))))
    assert torch.isfinite(qf).all()


@pytest.mark.parametrize("level", [0, 1])
def test_batched_screen_matches_jax(monkeypatch, level):
    """One screen of S proposals on each fine level against the JAX
    package's, JAX's fill normals and accept uniforms handed over: the
    final state, its cached actions and the traces."""
    S = 6
    jf, jc, tf, tc = _levels()[level]
    jcond, tcond = JCond(jf), GFFConditionedFineAction(tf)
    theta0 = _phi(tf.ndof, 9)
    xcs = _phi(tc.ndof, 10, (S, C))
    key = jax.random.PRNGKey(11)
    jtl = JTLStep(jc, jf, jcond).init(jnp.asarray(theta0))
    want = j_make_batched_screen(jf, jc, jcond, j_qoi(jf), j_qoi(jc))(
        key, jtl, jnp.asarray(xcs))
    k_fill, k_acc = jax.random.split(key)
    monkeypatch.setattr(cgff, "normal", _Queue(jax.random.normal(
        k_fill, _fill_shape(tf, (S, C)), jnp.float64)))
    monkeypatch.setattr(twolevel, "uniform", _Queue(jax.random.uniform(
        k_acc, (S, C), jnp.float64)))
    tl0 = TwoLevelMetropolisStep(tc, tf, tcond).init(
        torch.from_numpy(theta0))
    tl, qf, qc, acc = twolevel.make_batched_screen(
        tf, tc, tcond, qoi_2d_phi_squared(tf), qoi_2d_phi_squared(tc))(
        None, tl0, torch.from_numpy(xcs))
    for got, exp in zip((*tl, qf, qc), (*want[0], *want[1:3])):
        _close(got, exp, 1e-10)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want[3]))


def test_gff_twolevel_against_oracle():
    """The two-level method on the 8x8 rotate hierarchy, heat-bath coarse
    chains on the smoothed rotated coarse action (the dense Gibbs sweep),
    against phi_squared_analytical (4 sigma)."""
    act = GFFAction(Lattice2D(8, 8, CoarseningType.ROTATE), MASS)
    mc = MonteCarloTwoLevel(
        act, qoi_2d_phi_squared,
        lambda a: OverrelaxedHeatBathSampler(a, n_burnin=50),
        GFFConditionedFineAction, n_burnin=64, n_samples=64 * 128,
        chunk_size=128)
    st = mc.evaluate_difference(5, 64, torch.float64, "cpu")
    num, err = mc.stats_fine.average(st["fine"]), mc.stats_fine.error(
        st["fine"])
    assert 0.2 < mc.p_accept < 1.0, mc.p_accept
    assert abs(num - act.phi_squared_analytical()) < 4.0 * err, (num, err)
