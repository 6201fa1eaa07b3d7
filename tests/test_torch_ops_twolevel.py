"""Plain PyTorch version of the fused two-level kernel
(mlmcpathintegral_tpu_torch/ops/schwinger_twolevel.py) against the Pallas
kernel of mlmcpathintegral_tpu/ops/pallas_schwinger_twolevel.py in
interpret mode: equal inputs (numpy seeds), equal kernel seeds, f64, all
eight outputs to 1e-9, for the exact (beta=4) and the large-beta (beta=10)
fill.  The fill draws and special functions are also compared one by one
against the JAX functions, run eagerly (no Pallas)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special as ssp

from mlmcpathintegral_tpu.conditioned.schwinger import (
    QuenchedSchwingerConditionedFineAction,
)
from mlmcpathintegral_tpu.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu.models.qft.schwinger import QuenchedSchwingerAction
from mlmcpathintegral_tpu.ops import pallas_rng as jrng
from mlmcpathintegral_tpu.ops import pallas_schwinger_twolevel as jtl
from mlmcpathintegral_tpu_torch.ops import rng as trng
from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as ttl

# the port's tests run small tensors: one thread per worker process
# avoids oversubscribing the cores the parallel test workers share
torch.set_num_threads(1)

MT = MX = 8
C = 8
N_STEPS, T_SUB = 3, 2
SEED = np.array([-20240611, 777], np.int32)
TOL = 1e-9
# fewer BesselProduct rounds than the default 48 (same code path; the
# interpret-mode compile grows with the unrolled rounds)
K_BESSEL = 16
OUTPUTS = ("theta_fine", "theta_coarse", "S_fine", "S_cond", "y", "qc",
           "ec", "acc")


def _inputs(beta):
    rs = np.random.default_rng(int(beta * 10))
    lat = Lattice2D(MT, MX, CoarseningType.BOTH)
    act = QuenchedSchwingerAction(lat, beta=beta)
    fine = rs.uniform(-np.pi, np.pi, (C, lat.nedges))
    coarse = rs.uniform(-np.pi, np.pi, (C, lat.nedges // 4))
    cond = QuenchedSchwingerConditionedFineAction(act)
    sf = np.array(act.evaluate(jnp.asarray(fine)))
    sq = np.array(cond.evaluate(jnp.asarray(fine)))
    return fine, coarse, sf, sq


@pytest.fixture(scope="module")
def jax_runs():
    """One interpret-mode kernel call per beta, shared by the tests."""
    out = {}
    for beta in (4.0, 10.0):
        args = [jnp.asarray(a) for a in _inputs(beta)]
        res = jtl.schwinger_twolevel_chain(
            *args, jnp.asarray(SEED), beta=beta, beta_c=beta / 4.0, Mt=MT,
            Mx=MX, n_steps=N_STEPS, t_sub=T_SUB, k_rej_bessel=K_BESSEL,
            block_chains=C, interpret=True)
        out[beta] = [np.asarray(r) for r in res]
    return out


@pytest.mark.parametrize("beta", [4.0, 10.0])
def test_chain_plain_matches_pallas(jax_runs, beta):
    args = [torch.from_numpy(a) for a in _inputs(beta)]
    got = ttl.schwinger_twolevel_chain(
        *args, torch.from_numpy(SEED), beta=beta, beta_c=beta / 4.0, Mt=MT,
        Mx=MX, n_steps=N_STEPS, t_sub=T_SUB, k_rej_bessel=K_BESSEL)
    for name, g, w in zip(OUTPUTS, got, jax_runs[beta]):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL,
                                   err_msg=name)


def _rngs(seed=11, n=512):
    site = np.zeros((1, n), np.uint32)
    chain = np.arange(n, dtype=np.uint32)[None, :]
    jr = jrng.CounterRng(jnp.uint32(seed), jnp.asarray(site),
                         jnp.asarray(chain), jnp.uint32(3), step=jnp.uint32(1))
    tr = trng.CounterRng(seed, torch.from_numpy(site.astype(np.int64)),
                         torch.from_numpy(chain.astype(np.int64)), 3, step=1)
    return jr, tr


def _staples(n=512, seed=5):
    rs = np.random.default_rng(seed)
    return (rs.uniform(-np.pi, np.pi, (1, n)),
            rs.uniform(-np.pi, np.pi, (1, n)))


@pytest.mark.parametrize("beta", [4.0, 0.25])
def test_bessel_draw_matches(beta):
    """Both envelope branches (beta=0.25 takes the flat small-beta one);
    truncated at 3 rounds so that failures are exercised too."""
    from mlmcpathintegral_tpu.distributions.besselproduct import (
        BesselProductDistribution,
    )
    bp = BesselProductDistribution(beta)
    xp, xm = _staples()
    jr, tr = _rngs()
    jx, jok = jtl._bessel_draw(jr, jnp.asarray(xp), jnp.asarray(xm), beta,
                               bp.log_I0_twobeta, bp.sigma_beta, 3,
                               jnp.float64)
    tx, tok = ttl._bessel_draw(tr, torch.from_numpy(xp),
                               torch.from_numpy(xm), beta,
                               bp.log_I0_twobeta, bp.sigma_beta, 3,
                               torch.float64)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert 0 < tok.sum() < tok.numel()
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    assert tr.ctr == jr.ctr


def test_approx_and_expcos_fill_draws_match():
    xp, xm = _staples()
    jr, tr = _rngs(seed=12)
    jx, _ = jtl._approx_bessel_draw(jr, jnp.asarray(xp), jnp.asarray(xm),
                                    10.0, jnp.float64)
    tx, _ = ttl._approx_bessel_draw(tr, torch.from_numpy(xp),
                                    torch.from_numpy(xm), 10.0,
                                    torch.float64)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    jx, jok = jtl._expcos_fill_draw(jr, jnp.asarray(xp), jnp.asarray(xm),
                                    3.0, 2, jnp.float64)
    tx, tok = ttl._expcos_fill_draw(tr, torch.from_numpy(xp),
                                    torch.from_numpy(xm), 3.0, 2,
                                    torch.float64)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    assert tr.ctr == jr.ctr


def test_special_functions_match():
    x = np.concatenate([np.linspace(-40.0, 40.0, 801), [0.0, 3.75, -3.75]])
    np.testing.assert_allclose(
        ttl.kernel_log_i0(torch.from_numpy(x)).numpy(),
        np.asarray(jtl.kernel_log_i0(jnp.asarray(x))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ttl.kernel_erf(torch.from_numpy(x)).numpy(),
                               np.asarray(jtl.kernel_erf(jnp.asarray(x))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(ttl.kernel_erf(torch.from_numpy(x)).numpy(),
                               ssp.erf(x), atol=2e-7)


def test_component_geometry_matches():
    fine, coarse, _, _ = _inputs(4.0)
    g = fine.reshape(C, MX, MT, 2)
    comps = ttl.split_parity(torch.from_numpy(g))
    jcomps = np.asarray(jtl.split_parity(jnp.asarray(g)))   # [8, J, I, C]
    np.testing.assert_array_equal(comps.numpy(),
                                  jcomps.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(ttl.merge_parity(comps).numpy(), g)
    f = tuple(comps)
    jf = tuple(jnp.asarray(jcomps))
    for tv, jv in ((ttl.s_fine(f, 4.0), jtl.s_fine(jf, 4.0, jtl.jnp_sh)),
                   (ttl.q_topological(f), jtl.q_topological(jf, jtl.jnp_sh)),
                   (ttl.s_cond_approx(f, 10.0),
                    jtl.s_cond_approx(jf, 10.0, jtl.jnp_sh))):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=TOL)
    tr, jrr = ttl.restrict_comps(f), jtl.restrict_comps(jf)
    for a, b in zip(tr, jrr):
        np.testing.assert_allclose(a.numpy(),
                                   np.asarray(b).transpose(2, 0, 1),
                                   rtol=0, atol=TOL)
