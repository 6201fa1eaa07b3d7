"""The port's rotor model and Wolff cluster sampler against the JAX
package: Lattice1D, RotorAction (action, force, W geometry, cluster hooks,
coarsening, analytics), qoi_susceptibility and the ExpSin2 density in f64
to 1e-12 on equal inputs (numpy seeds); ExpSin2 draws by a KS test; the
cluster cores fed equal reflections, seeds and uniforms (drawn here by the
JAX package's own key splits) to identical results, and both against the
exact enumeration of one update's outcomes."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from mlmcpathintegral_tpu.distributions.expsin2 import (
    ExpSin2Distribution as JExpSin2,
)
from mlmcpathintegral_tpu.lattice import Lattice1D as JLattice1D
from mlmcpathintegral_tpu.models.base import RenormalisationType as JRT
from mlmcpathintegral_tpu.models.rotor import RotorAction as JRotor
from mlmcpathintegral_tpu.qoi import qoi_susceptibility as j_qoi
from mlmcpathintegral_tpu.samplers.cluster import ClusterSampler as JCluster
from mlmcpathintegral_tpu_torch.distributions.expsin2 import (
    ExpSin2Distribution,
)
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
from mlmcpathintegral_tpu_torch.qoi import qoi_susceptibility
from mlmcpathintegral_tpu_torch.samplers import (
    ClusterSampler, OverrelaxedHeatBathSampler,
)

# the port's tests run small tensors: one thread per worker process
# avoids oversubscribing the cores the parallel test workers share
torch.set_num_threads(1)

TOL = 1e-12


def _pair(M=16, T=4.0, m0=0.25, renorm="NONE"):
    return (JRotor(JLattice1D(M, T), getattr(JRT, renorm), m0),
            RotorAction(Lattice1D(M, T), getattr(RenormalisationType, renorm),
                        m0))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def test_lattice1d_matches_jax():
    for M, T in ((16, 4.0), (6, 1.5)):
        j, t = JLattice1D(M, T), Lattice1D(M, T)
        assert (t.M_lat, t.T_final, t.a_lat, t.ndof) == \
            (j.M_lat, j.T_final, j.a_lat, j.ndof)
        jc, tc = j.coarse_lattice(), t.coarse_lattice()
        assert (tc.M_lat, tc.a_lat, tc.coarsening_level) == \
            (jc.M_lat, jc.a_lat, jc.coarsening_level)
        assert t.fine_lattice().M_lat == j.fine_lattice().M_lat
    with pytest.raises(ValueError):
        Lattice1D(7, 1.0).coarse_lattice()
    with pytest.raises(ValueError):
        Lattice1D(1, 1.0)


def test_rotor_action_matches_jax():
    ja, ta = _pair()
    rs = np.random.default_rng(0)
    x = rs.uniform(-np.pi, np.pi, (5, 16))
    xm, xp, xbar = (rs.uniform(-np.pi, np.pi, (5, 8)) for _ in range(3))
    tx = torch.from_numpy(x)
    _close(ta.evaluate(tx), ja.evaluate(jnp.asarray(x)))
    _close(ta.force(tx), ja.force(jnp.asarray(x)))
    for name in ("getWcurvature", "getWminimum"):
        _close(getattr(ta, name)(torch.from_numpy(xm), torch.from_numpy(xp)),
               getattr(ja, name)(jnp.asarray(xm), jnp.asarray(xp)))
    _close(ta.overrelax_site(torch.from_numpy(x[:, :8]), torch.from_numpy(xm),
                             torch.from_numpy(xp)),
           ja.overrelax_site(jnp.asarray(x[:, :8]), jnp.asarray(xm),
                             jnp.asarray(xp)))
    _close(ta.S_ell(torch.from_numpy(xm), torch.from_numpy(xp),
                    torch.from_numpy(xbar)),
           ja.S_ell(jnp.asarray(xm), jnp.asarray(xp), jnp.asarray(xbar)))
    _close(ta.flip(torch.from_numpy(xm), torch.from_numpy(xbar)),
           ja.flip(jnp.asarray(xm), jnp.asarray(xbar)))
    _close(ta.prolongate(torch.from_numpy(x[:, :8]), tx),
           ja.prolongate(jnp.asarray(x[:, :8]), jnp.asarray(x)))
    _close(ta.restrict(tx), ja.restrict(jnp.asarray(x)))
    _close(qoi_susceptibility(ta)(tx), j_qoi(ja)(jnp.asarray(x)))
    _close(qoi_susceptibility(ta.lattice)(tx), j_qoi(ja.lattice)(
        jnp.asarray(x)))


@pytest.mark.parametrize("renorm", ["NONE", "PERTURBATIVE"])
def test_rotor_coarsening_and_analytics_match_jax(renorm):
    ja, ta = _pair(M=32, T=2.0, m0=0.4, renorm=renorm)
    jc, tc = ja.coarse_action(), ta.coarse_action()
    assert tc.M_lat == jc.M_lat
    assert tc.m0 == pytest.approx(jc.m0, rel=TOL, abs=0)
    for name in ("chit_exact", "chit_perturbative", "chit_continuum"):
        assert getattr(ta, name)() == pytest.approx(getattr(ja, name)(),
                                                    rel=TOL, abs=0)
        assert getattr(tc, name)() == pytest.approx(getattr(jc, name)(),
                                                    rel=TOL, abs=0)
    with pytest.raises(NotImplementedError):
        _pair(renorm="NONPERTURBATIVE")[1].coarse_action()


def test_expsin2_density_matches_jax_and_draws_pass_ks():
    rs = np.random.default_rng(1)
    x = rs.uniform(-np.pi, np.pi, 200)
    sig = rs.uniform(0.01, 50.0, 200)
    _close(ExpSin2Distribution.log_evaluate(torch.from_numpy(x),
                                            torch.from_numpy(sig)),
           JExpSin2.log_evaluate(jnp.asarray(x), jnp.asarray(sig)))
    g = torch.Generator().manual_seed(3)
    grid = np.linspace(-np.pi, np.pi, 4001)
    for sigma in (0.3, 4.0, 60.0):
        s = ExpSin2Distribution.draw(
            g, torch.full((20000,), sigma, dtype=torch.float64)).numpy()
        assert np.all(np.abs(s) <= np.pi)
        pdf = np.exp(JExpSin2.log_evaluate(jnp.asarray(grid),
                                           jnp.asarray(sigma)))
        cdf = np.concatenate([[0.0], np.cumsum(
            0.5 * (pdf[1:] + pdf[:-1]) * np.diff(grid))])
        assert cdf[-1] == pytest.approx(1.0, abs=1e-6)
        p = scipy.stats.kstest(s, lambda v: np.interp(v, grid, cdf)).pvalue
        assert p > 1e-3, (sigma, p)


def _core_inputs(C, M, seed):
    """x, xbar, i0 from numpy and the update's uniforms from the JAX
    package's key splits (_walk_core: split(key) -> per-direction
    split(k, M); _vector_core: split(key) -> [C, M] per direction)."""
    rs = np.random.default_rng(seed)
    x = rs.uniform(-np.pi, np.pi, (C, M))
    xbar = rs.uniform(-np.pi, np.pi, C)
    i0 = rs.integers(0, M, C)
    key = jax.random.PRNGKey(seed)
    k_f, k_b = jax.random.split(key)
    walk_u = [np.stack([np.array(jax.random.uniform(k, (C,), jnp.float64))
                        for k in jax.random.split(kd, M)])
              for kd in (k_f, k_b)]
    vec_u = [np.array(jax.random.uniform(kd, (C, M), jnp.float64))
             for kd in (k_f, k_b)]
    return x, xbar, i0, key, walk_u, vec_u


@pytest.mark.parametrize("M,m0", [(8, 0.25), (16, 1.0), (5, 0.1)])
def test_cluster_cores_match_jax(M, m0):
    ja, ta = _pair(M=M, m0=m0)
    C = 512
    x, xbar, i0, key, walk_u, vec_u = _core_inputs(C, M, M)
    js, ts = JCluster(ja), ClusterSampler(ta)
    jx, jxb, ji0 = jnp.asarray(x), jnp.asarray(xbar), jnp.asarray(i0)
    tx, txb, ti0 = (torch.from_numpy(a) for a in (x, xbar, i0))
    want_w = np.asarray(js._walk_core(key, jx, jxb, ji0))
    got_w = ts._walk_core(tx, txb, ti0, *map(torch.from_numpy, walk_u))
    np.testing.assert_array_equal(got_w.numpy(), want_w)
    want_v = np.asarray(js._vector_core(key, jx, jxb, ji0))
    got_v = ts._vector_core(tx, txb, ti0, *map(torch.from_numpy, vec_u))
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    # the updates flipped clusters of every size
    n_flip = (got_v.numpy() != x).sum(axis=1)
    assert n_flip.min() >= 0 and n_flip.max() > 1


def _exact_outcome_dist(s_orig, i0, M):
    """Exact distribution over flip masks of one 1-D cluster update with a
    fixed reflection and seed, enumerated from the walk semantics of
    clustersampler.cc:92-132 (a copy of the JAX package's test helper).
    A link with one flipped endpoint opens with p_one = 1-exp(min(0, s)),
    one with two flipped endpoints with p_two = 1-exp(min(0, -s))."""
    p_one = 1.0 - np.exp(np.minimum(0.0, s_orig))
    p_two = 1.0 - np.exp(np.minimum(0.0, -s_orig))
    out = {}

    def o_f(k):  # forward open prob at walk order k (bond i0+k)
        b = (i0 + k) % M
        return p_two[b] if k == M - 1 else p_one[b]

    for F in range(M + 1):
        pF = 1.0
        for k in range(min(F, M)):
            pF *= o_f(k)
        if F < M:
            pF *= 1.0 - o_f(F)
        if pF == 0.0:
            continue
        B_lim = 1 if F == M else M - F

        def o_b(k):  # backward open prob at walk order k (bond i0-k-1)
            b = (i0 - k - 1) % M
            return p_two[b] if (F < M and k == B_lim - 1) else p_one[b]

        for B in range(B_lim + 1):
            pB = 1.0
            for k in range(min(B, B_lim)):
                pB *= o_b(k)
            if B < B_lim:
                pB *= 1.0 - o_b(B)
            if pB == 0.0:
                continue
            cnt = np.zeros(M, np.int64)
            cnt[i0] += 1                        # seed flip
            for r in range(1, min(F, M - 1) + 1):
                cnt[(i0 + r) % M] += 1          # forward flips
            if F == M:
                cnt[i0] += 1                    # full forward wrap re-flip
            for rb in range(1, B + 1):
                cnt[(i0 - rb) % M] += 1         # backward flips (rb == M
            mask = tuple(cnt % 2)               # re-flips the seed)
            out[mask] = out.get(mask, 0.0) + pF * pB
    return out


def _tv(exact, masks, C):
    vals, counts = np.unique(masks, axis=0, return_counts=True)
    emp = {tuple(v): c / C for v, c in zip(vals, counts)}
    keys = set(exact) | set(emp)
    return 0.5 * sum(abs(exact.get(k, 0.0) - emp.get(k, 0.0))
                     for k in keys), emp


def _cores(sampler, C, M, seed):
    g = torch.Generator().manual_seed(seed)
    walk = [torch.rand(M, C, generator=g, dtype=torch.float64)
            for _ in range(2)]
    vec = [torch.rand(C, M, generator=g, dtype=torch.float64)
           for _ in range(2)]
    return [("walk", lambda x, xb, i0: sampler._walk_core(x, xb, i0, *walk)),
            ("vector",
             lambda x, xb, i0: sampler._vector_core(x, xb, i0, *vec))]


@pytest.mark.parametrize("M,i0,seed", [(3, 0, 0), (3, 2, 1),
                                       (4, 1, 2), (4, 3, 3)])
def test_cluster_cores_match_exact_enumeration(M, i0, seed):
    """Both cores reproduce the exact per-outcome probabilities."""
    act = RotorAction(Lattice1D(M, float(M)), m0=1.3)
    rng = np.random.default_rng(seed)
    xbar = float(rng.uniform(-np.pi, np.pi))
    # keep every site away from the flip fixed points xbar + pi/2 mod pi
    x_row = xbar + np.pi / 2 + 0.3 + 0.5 * rng.uniform(0.2, 1.0, M)
    x_row = np.angle(np.exp(1j * x_row))
    flip_row = act.flip(torch.from_numpy(x_row), xbar).numpy()
    assert np.min(np.abs(np.angle(np.exp(1j * (flip_row - x_row))))) > 0.05
    tx_row = torch.from_numpy(x_row)
    s_orig = act.S_ell(tx_row, torch.roll(tx_row, -1), xbar).numpy()
    exact = _exact_outcome_dist(s_orig, i0, M)
    assert abs(sum(exact.values()) - 1.0) < 1e-12

    C = 120_000
    x = tx_row[None, :].repeat(C, 1)
    xb = torch.full((C,), xbar, dtype=torch.float64)
    i0v = torch.full((C,), i0, dtype=torch.int64)
    for name, core in _cores(ClusterSampler(act), C, M, 100 + seed):
        final = core(x, xb, i0v).numpy()
        d_orig = np.abs(np.angle(np.exp(1j * (final - x_row[None, :]))))
        d_flip = np.abs(np.angle(np.exp(1j * (final - flip_row[None, :]))))
        tv, emp = _tv(exact, (d_flip < d_orig).astype(np.int64), C)
        # TV of a multinomial with ~2^M cells at C = 120k is ~0.004
        assert tv < 0.012, (name, tv)


class _StubClusterAction:
    """Makes the full-backward-wrap path reachable (the rotor's bond signs
    always pair up): sites carry x = +-m_b, S_ell = s0(|x_i|, |x_j|)
    sign(x_i) sign(x_j) with exactly one positive bond."""

    def __init__(self, scale=0.7, thresh=3.0):
        self.scale = scale
        self.thresh = thresh

    def S_ell(self, x_i, x_j, xbar):
        s0 = self.scale * (self.thresh - torch.abs(x_i) * torch.abs(x_j))
        return s0 * torch.sign(x_i) * torch.sign(x_j)

    @staticmethod
    def flip(x, xbar):
        return -x


def test_cluster_full_backward_wrap_exact():
    """With the first forward bond closed (F = 0) the backward walk may
    wrap the whole ring and re-test bond (i0, i0+1) doubly flipped,
    re-flipping the seed (clustersampler.cc:108-113)."""
    M, i0 = 4, 0
    mags = torch.tensor([1.0, 2.0, 3.0, 5.0], dtype=torch.float64)
    act = _StubClusterAction()
    s_orig = act.S_ell(mags, torch.roll(mags, -1), 0.0).numpy()
    assert s_orig[i0] > 0 and np.all(s_orig[1:] < 0)
    exact = _exact_outcome_dist(s_orig, i0, M)
    wrap_mask = tuple(int(j != i0) for j in range(M))
    assert exact.get(wrap_mask, 0.0) > 0.05

    C = 150_000
    x = mags[None, :].repeat(C, 1)
    xb = torch.zeros(C, dtype=torch.float64)
    i0v = torch.full((C,), i0, dtype=torch.int64)
    for name, core in _cores(ClusterSampler(act), C, M, 11):
        final = core(x, xb, i0v).numpy()
        tv, emp = _tv(exact, (final < 0).astype(np.int64), C)
        assert tv < 0.012, (name, tv)
        assert abs(emp.get(wrap_mask, 0.0) - exact[wrap_mask]) < 0.01, name


@pytest.mark.parametrize("kind", ["cluster_vector", "cluster_walk",
                                  "cluster_kernel", "heatbath",
                                  "heatbath_kernel"])
def test_rotor_samplers_match_oracle(kind):
    """Each sampler's chi_t at M = 16, T = 4, I = 0.25 (the plain tensor
    versions, and the kernels' plain versions through draw_chain) within
    4 sigma of chit_exact, with the error from the spread of the
    independent chains' means."""
    act = RotorAction(Lattice1D(16, 4.0), m0=0.25)
    C, steps = 256, 150
    if kind.startswith("cluster"):
        s = ClusterSampler(act, n_burnin=20, n_updates=5,
                           vectorised=kind != "cluster_walk",
                           use_pallas=kind == "cluster_kernel")
    else:
        s = OverrelaxedHeatBathSampler(act, n_burnin=100,
                                       use_pallas=kind == "heatbath_kernel")
    g = torch.Generator().manual_seed(5)
    st = s.prepare(g, C, torch.float64, "cpu")
    if s.use_pallas:
        st, w = s.draw_chain(g, st, steps)
        chi = (w / (2 * math.pi)) ** 2 / act.lattice.T_final
    else:
        q = qoi_susceptibility(act)
        chi = []
        for _ in range(steps):
            st, acc = s.draw(g, st)
            chi.append(q(st.x))
        chi = torch.stack(chi)
        assert acc.all()
    per_chain = chi.mean(dim=0).numpy()
    err = per_chain.std(ddof=1) / math.sqrt(C)
    assert abs(per_chain.mean() - act.chit_exact()) < 4 * err, \
        (per_chain.mean(), err, act.chit_exact())
