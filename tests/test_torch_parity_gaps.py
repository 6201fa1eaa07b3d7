"""The port's counterparts of small JAX functions the other slices did not
need, each against the JAX function on the same numpy inputs (f64):
``record_masked``, ``hard_reset``, ``variance_device`` and
``Statistics.local_samples``; ``make_qoi`` for every name; the quenched
Schwinger force against JAX's and against torch's autograd, and the
default ``Action.force`` (autograd of ``evaluate``) against JAX's
``jax.grad``; ``Action.evaluation_cost``; the ExpCos and BesselProduct
densities on a grid to 1e-12; ``CoarsenType`` and ``default_dtype``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu import lattice as jlattice
from mlmcpathintegral_tpu import qoi as jqoi
from mlmcpathintegral_tpu.distributions.besselproduct import (
    BesselProductDistribution as JBessel,
)
from mlmcpathintegral_tpu.distributions.expcos import (
    ExpCosDistribution as JExpCos,
)
from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCT
from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
from mlmcpathintegral_tpu.models.qft.gff import GFFAction as JGFF
from mlmcpathintegral_tpu.models.qft.schwinger import (
    QuenchedSchwingerAction as JSchwinger,
)
from mlmcpathintegral_tpu.utils import statistics as js
from mlmcpathintegral_tpu_torch import lattice as tlattice
from mlmcpathintegral_tpu_torch import qoi as tqoi
from mlmcpathintegral_tpu_torch.distributions.besselproduct import (
    BesselProductDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.expcos import (
    ExpCosDistribution,
)
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.models.base import Action
from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.samplers.base import default_dtype
from mlmcpathintegral_tpu_torch.utils import statistics as ts

torch.set_num_threads(1)


def _states(C=6, k_max=5, T=9, seed=3):
    """The same accumulator in both packages after T recorded samples."""
    Qs = np.random.default_rng(seed).normal(size=(T, C))
    j = js.record_block(js.init(C, k_max, jnp.float64), jnp.asarray(Qs))
    t = ts.record_block(ts.init(C, k_max, torch.float64, "cpu"),
                        torch.from_numpy(Qs))
    return j, t


def _assert_states_equal(j, t, atol=1e-12):
    for name, a, b in zip(t._fields, j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("enabled", [False, True])
def test_record_masked_matches_jax(enabled):
    j, t = _states()
    Q = np.random.default_rng(4).normal(size=6)
    j2 = js.record_masked(j, jnp.asarray(Q), jnp.asarray(enabled))
    t2 = ts.record_masked(t, torch.from_numpy(Q), torch.tensor(enabled))
    _assert_states_equal(j2, t2)
    stats = ts.Statistics("Q", 5)
    assert stats.local_samples(t2) == js.Statistics("Q", 5) \
        .local_samples(j2) == 9 + int(enabled)


def test_hard_reset_and_local_samples_match_jax():
    j, t = _states()
    _assert_states_equal(js.hard_reset(j), ts.hard_reset(t))
    soft = ts.soft_reset(t)
    assert ts.Statistics("Q", 5).local_samples(soft) == 0
    assert int(soft.n_lt) == 9
    assert all(float(x.abs().sum()) == 0.0 for x in ts.hard_reset(t))


@pytest.mark.parametrize("T", [1, 2, 9])
def test_variance_device_matches_jax(T):
    j, t = _states(T=T)
    v = ts.variance_device(t)
    assert v.dim() == 0
    assert float(v) == pytest.approx(float(js.variance_device(j)),
                                     rel=1e-12, abs=1e-14)
    if T >= 2:
        assert float(v) == pytest.approx(
            ts.Statistics("Q", 5).variance(t), rel=1e-12)


def _qoi_inputs():
    rs = np.random.default_rng(7)
    lat1 = (jlattice.Lattice1D(16, 4.0), tlattice.Lattice1D(16, 4.0))
    sch = (JSchwinger(JLattice2D(4, 6, JCT.BOTH), beta=2.0),
           QuenchedSchwingerAction(Lattice2D(4, 6, CoarseningType.BOTH),
                                   beta=2.0))
    gff = (JGFF(JLattice2D(4, 4, JCT.BOTH), mass=1.0),
           GFFAction(Lattice2D(4, 4, CoarseningType.BOTH), mass=1.0))
    return {"x_squared": (lat1, rs.normal(size=(5, 16))),
            "susceptibility": (lat1, rs.uniform(-np.pi, np.pi, (5, 16))),
            "2d_susceptibility": (sch, rs.uniform(-np.pi, np.pi, (5, 48))),
            "avg_plaquette": (sch, rs.uniform(-np.pi, np.pi, (5, 48))),
            "2d_phi_squared": (gff, rs.normal(size=(5, 16)))}


@pytest.mark.parametrize("name", ["x_squared", "susceptibility",
                                  "2d_susceptibility", "avg_plaquette",
                                  "2d_phi_squared"])
def test_make_qoi_matches_jax(name):
    (jobj, tobj), x = _qoi_inputs()[name]
    want = np.asarray(jqoi.make_qoi(name, jobj)(jnp.asarray(x)))
    got = tqoi.make_qoi(name, tobj)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_make_qoi_refuses_unknown_name():
    with pytest.raises(ValueError, match="unknown QoI"):
        tqoi.make_qoi("chi_m", tlattice.Lattice1D(8, 1.0))


@pytest.mark.parametrize("Mt,Mx", [(4, 6), (8, 8)])
def test_schwinger_force_matches_jax_and_autograd(Mt, Mx):
    rs = np.random.default_rng(Mt * Mx)
    theta = rs.uniform(-np.pi, np.pi, (3, 2 * Mt * Mx))
    jact = JSchwinger(JLattice2D(Mt, Mx, JCT.BOTH), beta=3.0)
    tact = QuenchedSchwingerAction(Lattice2D(Mt, Mx, CoarseningType.BOTH),
                                   beta=3.0)
    got = tact.force(torch.from_numpy(theta))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jact.force(jnp.asarray(theta))),
                               rtol=0, atol=1e-12)
    # the base class's default: autograd of evaluate, against jax.grad
    auto = Action.force(tact, torch.from_numpy(theta))
    np.testing.assert_allclose(auto.numpy(), got.numpy(), rtol=0,
                               atol=1e-12)
    jgrad = jax.grad(lambda y: jnp.sum(jact.evaluate(y)))(
        jnp.asarray(theta))
    np.testing.assert_allclose(auto.numpy(), np.asarray(jgrad), rtol=0,
                               atol=1e-12)
    assert tact.evaluation_cost == jact.evaluation_cost == 2 * Mt * Mx


GRID = np.linspace(-np.pi, np.pi, 257)


@pytest.mark.parametrize("beta,x_p,x_m", [(0.5, 0.5, -0.3), (4.0, 0.5, -0.3),
                                          (12.0, 2.9, -3.0)])
def test_expcos_evaluate_matches_jax(beta, x_p, x_m):
    want = np.asarray(JExpCos.evaluate(jnp.asarray(GRID), beta, x_p, x_m))
    got = ExpCosDistribution.evaluate(torch.from_numpy(GRID), beta, x_p, x_m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    # tensor parameters broadcast as the numbers do
    got_t = ExpCosDistribution.evaluate(
        torch.from_numpy(GRID), beta, torch.full((257,), x_p,
                                                 dtype=torch.float64),
        torch.full((257,), x_m, dtype=torch.float64))
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


@pytest.mark.parametrize("beta,x_p,x_m", [(0.2, 0.5, -0.3), (4.0, 0.5, -0.3),
                                          (8.0, -2.0, 2.5)])
def test_besselproduct_evaluate_matches_jax(beta, x_p, x_m):
    want = np.asarray(JBessel(beta).evaluate(jnp.asarray(GRID), x_p, x_m))
    got = BesselProductDistribution(beta).evaluate(torch.from_numpy(GRID),
                                                   x_p, x_m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_coarsen_type_and_default_dtype():
    assert [(m.name, m.value) for m in tlattice.CoarsenType] == \
        [(m.name, m.value) for m in jlattice.CoarsenType]
    assert default_dtype() == torch.get_default_dtype() == torch.float32
