"""The one-pass form of the Wolff cluster extents that the CUDA cluster
kernel (mlmcpathintegral_tpu_torch/csrc/rotor_cluster.cu) computes, held
against the two-pass form of the plain version
(mlmcpathintegral_tpu_torch/ops/rotor.py ``_cluster_update``) and against
the Pallas kernel (mlmcpathintegral_tpu/ops/pallas_rotor.py) in interpret
mode.

One pass: each bond is tested once, forward as before (F_raw, the walk
order of the first closed forward bond) and backward with p_one for every
bond (m1, the first p_one-closed backward order); the backward walk's
terminal bond k* = B_lim - 1 is the bond that closed the forward walk, so
B = min(m1, 1) when F_raw = M, else m1 if m1 < k*, k* if that bond's u_b
passes p_two, B_lim otherwise.  The decisions are the same comparisons on
the same values, so F_raw, B and the flipped paths are equal bit for bit.
Inputs are made with numpy from seeds.

Two branches never occur with probabilities made from the ring's
cosines: F_raw = M (no closed forward bond) and B = B_lim (the backward
walk reaching the forward walk's terminal bond) each need exactly one
anti-aligned bond, and the product of c_b c_{b+1} around the ring is a
square.  The tests reach them by handing both forms the same arbitrary
probabilities (the exponential replaced by seeded uniforms)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.ops import pallas_rotor as jpr
from mlmcpathintegral_tpu_torch.ops import rotor as tpr
from mlmcpathintegral_tpu_torch.ops.rng import CounterRng, element_ids
from mlmcpathintegral_tpu_torch.ops.schwinger import _mod_2pi

torch.set_num_threads(1)

SEED1, SEED2 = 123456, 2 ** 32 - 98765
N_UPDATES = 6
#: one update against the Pallas kernel in interpret mode, f64
TOL_PALLAS = 1e-12


def _walk_orders(M, i0):
    rows = torch.arange(M)
    d = rows - i0
    rel = d + torch.where(d < 0, M, 0)
    rel_b = torch.where(rel == 0, 0, M - rel)
    k_bw = torch.where(rel_b == 0, M - 1, rel_b - 1)
    return rel, rel_b, k_bw


def one_pass_extents(c, u_f, u_b, i0, *, kappa2, M, exp=torch.exp):
    """(F_raw, B, branch) of one update from one test per bond; branch 0:
    F_raw = M; 1: m1 < k*; 2: bond k* closed under p_two; 3: B = B_lim."""
    s = -kappa2 * c * torch.roll(c, -1, dims=-1)
    p_one = 1.0 - exp(torch.clamp(s, max=0.0))
    p_two = 1.0 - exp(torch.clamp(-s, max=0.0))
    rel, _, k_bw = _walk_orders(M, i0)
    closed_f = u_f >= torch.where(rel == M - 1, p_two, p_one)
    F_raw = torch.where(closed_f, rel, M).amin(dim=-1, keepdim=True)
    m1 = torch.where(u_b >= p_one, k_bw, M).amin(dim=-1, keepdim=True)
    t_two = ((rel == F_raw) & (u_b >= p_two)).any(dim=-1, keepdim=True)
    k_star = M - F_raw - 1
    B = torch.where(F_raw >= M, torch.clamp(m1, max=1),
                    torch.where(m1 < k_star, m1,
                                torch.where(t_two, k_star, k_star + 1)))
    branch = torch.where(F_raw >= M, 0, torch.where(
        m1 < k_star, 1, torch.where(t_two, 2, 3)))
    return F_raw, B, branch


def one_pass_update(x, rng, *, kappa2, M, exp=torch.exp):
    """One cluster update with the one-pass extents: (x', F_raw, B,
    branch), drawing the same words as ``_cluster_update``."""
    dtype = x.dtype
    xbar = (2.0 * rng.uniform(dtype)[:, 0:1] - 1.0) * tpr.PI
    u_seed = rng.uniform(dtype)[:, 0:1]
    i0 = torch.clamp(torch.floor((1.0 - u_seed) * M),
                     max=M - 1).to(torch.int64)
    c = torch.cos(x - xbar)
    u_f = rng.uniform(dtype)
    u_b = rng.uniform(dtype)
    F_raw, B, branch = one_pass_extents(c, u_f, u_b, i0, kappa2=kappa2, M=M,
                                        exp=exp)
    rel, rel_b, _ = _walk_orders(M, i0)
    n_flips = ((rel == 0).to(torch.int64)
               + ((rel >= 1) & (rel <= F_raw)).to(torch.int64)
               + ((rel_b >= 1) & (rel_b <= B)).to(torch.int64)
               + ((rel == 0) & (F_raw >= M)).to(torch.int64)
               + ((rel == 0) & (B >= M)).to(torch.int64))
    x = torch.where(n_flips % 2 == 1, _mod_2pi(tpr.PI + 2.0 * xbar - x), x)
    return x, F_raw, B, branch


class _ExtentSpy:
    """Stands in for ``torch`` inside ops/rotor.py while one
    ``_cluster_update`` runs and records its two-pass extents: F_raw from
    B_lim = where(F_raw >= M, 1, M - F_raw), B from minimum(B_raw, B_lim).
    ``exp`` replaces torch.exp there."""

    def __init__(self, M, exp=torch.exp):
        self.M = M
        self.exp = exp
        self.F_raw, self.B = [], []

    def __getattr__(self, name):
        return getattr(torch, name)

    def where(self, cond, a, b):
        if isinstance(a, int) and a == 1:       # B_lim (M >= 3)
            self.F_raw.append(torch.where(cond, self.M, self.M - b))
        return torch.where(cond, a, b)

    def minimum(self, a, b):
        out = torch.minimum(a, b)
        self.B.append(out)
        return out


def _paths(M, C, seed):
    """[C, M] f64 paths: a quarter uniform (short clusters), a quarter
    ordered (long ones, full wraps), half ordered with a domain wall (a
    walk that ends far from its seed), each with small noise."""
    rs = np.random.default_rng(seed)
    x = rs.uniform(-np.pi, np.pi, (C, M))
    q = C // 4
    base = rs.uniform(-np.pi, np.pi, (C, 1))
    x[q:2 * q] = base[q:2 * q] + 0.05 * rs.normal(size=(q, M))
    wall = rs.integers(1, M, (C, 1))
    flip = np.where(np.arange(M)[None, :] >= wall, np.pi, 0.0)
    x[2 * q:] = (base + flip + 0.05 * rs.normal(size=(C, M)))[2 * q:]
    return torch.from_numpy(np.mod(x + np.pi, 2 * np.pi) - np.pi)


class _ArbitraryExp:
    """Stands in for the exponential of the opening probabilities: seeded
    uniforms, scaled per chain by 1, 0.1, 0.01 and 0 in turn, in the order
    of the calls (p_one, then p_two, each update), whatever the argument."""

    def __init__(self, C, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.scale = torch.tensor([1.0, 0.1, 0.01, 0.0]).repeat(C // 4)

    def __call__(self, t):
        u = torch.rand(t.shape, generator=self.gen, dtype=torch.float64)
        return (u * self.scale[:, None]).to(t.dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("M", [3, 16, 24, 256])
def test_one_pass_extents_equal_the_two_pass_form(M, dtype, monkeypatch):
    """Over several updates of mixed paths at a weak and a strong coupling,
    then with arbitrary probabilities: the one-pass F_raw and B equal
    _cluster_update's, and every chain's flipped path is bit-identical
    after each update.  With the cosines' probabilities F_raw < M; over
    all runs both F_raw = M and F_raw < M occur, and at M >= 16 the
    terminal bond's three outcomes too."""
    C = 256
    site, chain = element_ids((M,), C, "cpu")
    seen = torch.zeros(4, dtype=torch.int64)
    for kappa2, arbitrary in ((0.5 * M / 4.0, False), (8.0 * M / 4.0, False),
                              (8.0 * M / 4.0, True)):
        exp_two, exp_one = ((_ArbitraryExp(C, M), _ArbitraryExp(C, M))
                            if arbitrary else (torch.exp, torch.exp))
        x_two = _paths(M, C, M).to(dtype)
        x_one = x_two.clone()
        for u in range(N_UPDATES):
            spy = _ExtentSpy(M, exp_two)
            monkeypatch.setattr(tpr, "torch", spy)
            x_two = tpr._cluster_update(
                x_two, CounterRng(SEED1, site, chain, SEED2, step=u), site,
                kappa2=kappa2, M=M, dtype=dtype)
            monkeypatch.setattr(tpr, "torch", torch)
            x_one, F_raw, B, branch = one_pass_update(
                x_one, CounterRng(SEED1, site, chain, SEED2, step=u),
                kappa2=kappa2, M=M, exp=exp_one)
            assert len(spy.F_raw) == len(spy.B) == 1
            assert torch.equal(F_raw, spy.F_raw[0]), (kappa2, u)
            assert torch.equal(B, spy.B[0]), (kappa2, u)
            assert torch.equal(x_one, x_two), (kappa2, u)
            if not arbitrary:
                assert (F_raw < M).all() and (branch != 3).all()
            seen += torch.bincount(branch.reshape(-1), minlength=4)
    assert seen[0] > 0 and seen[1:].sum() > 0, seen
    if M >= 16:
        assert (seen > 0).all(), seen


def test_one_pass_update_matches_pallas_interpret():
    """One update of the one-pass form against the Pallas cluster kernel in
    interpret mode (one step of one update), f64, to TOL_PALLAS."""
    M, C, block = 16, 16, 8
    x = _paths(M, C, 5)
    kappa2 = 2.0 * M / 4.0
    seed = np.array([SEED1, SEED2], np.uint32).view(np.int32)
    jx, jw = jpr.rotor_cluster_chain(
        jnp.asarray(x.numpy()), jnp.asarray(seed), kappa2=kappa2, M=M,
        n_steps=1, n_updates=1, block_chains=block, interpret=True)
    site, chain = element_ids((M,), C, "cpu")
    tx, _, _, _ = one_pass_update(
        x, CounterRng(SEED1, site, chain, SEED2, step=0), kappa2=kappa2,
        M=M)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=TOL_PALLAS)
    np.testing.assert_allclose(tpr.winding_sum(tx).numpy(),
                               np.asarray(jw)[0], rtol=0, atol=TOL_PALLAS)
    assert (tx != x).any(dim=1).double().mean() > 0.5
