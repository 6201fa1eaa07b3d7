"""The port's hierarchical and multilevel samplers
(mlmcpathintegral_tpu_torch/samplers/hierarchical.py, multilevel.py)
against the JAX package's on the CPU, in f64.

One hierarchical draw is compared with JAX's given the same inputs: the
fine state and the coarse sampler's move come from numpy, the fills replay
fixed numpy arrays on both sides (stubs on the test side; the JAX package
is not edited) and the port's accept uniforms are JAX's own, drawn from the
keys JAX's draw splits.  Then the restriction, the fills, the screen's dS,
the masking and the per-level counters must agree to 1e-12.  With stub
steps that accept by fixed masks, a chain rejected at a coarser level
keeps its fine state bit for bit and each level counts only the chains
still alive.  The oracles: the hierarchical sampler with an exact coarse
sampler and the multilevel sampler on the harmonic oscillator within 4
sigma of Xsquared_analytical, and the multilevel sampler's t_indep
bookkeeping, as JAX's own tests; and the coarse sampler's own generator:
on the CPU for a host-seeded sampler, each draw's kernel seed from it."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.conditioned import (
    make_conditioned_fine_action as j_cond,
)
from mlmcpathintegral_tpu.lattice import Lattice1D as JLattice1D
from mlmcpathintegral_tpu.mc.twolevelstep import TwoLevelState as JTLState
from mlmcpathintegral_tpu.models import (
    HarmonicOscillatorAction as JHarmonic,
)
from mlmcpathintegral_tpu.models import RenormalisationType as JRenorm
from mlmcpathintegral_tpu.models import RotorAction as JRotor
from mlmcpathintegral_tpu.samplers.hierarchical import (
    HierarchicalSampler as JHierarchical,
)
from mlmcpathintegral_tpu.samplers.hierarchical import (
    HierarchicalState as JHState,
)
from mlmcpathintegral_tpu_torch.conditioned import (
    make_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.mc import MonteCarloSingleLevel
from mlmcpathintegral_tpu_torch.mc import twolevelstep as ttl
from mlmcpathintegral_tpu_torch.models import (
    HarmonicOscillatorAction, RenormalisationType, RotorAction,
)
from mlmcpathintegral_tpu_torch.ops import rotor as trotor
from mlmcpathintegral_tpu_torch.qoi import qoi_x_squared
from mlmcpathintegral_tpu_torch.samplers import (
    ExactSampler, HierarchicalSampler, HierarchicalState, HMCSampler,
    MultilevelSampler, OverrelaxedHeatBathSampler, Sampler,
)
from mlmcpathintegral_tpu_torch.samplers.base import kernel_seed

torch.set_num_threads(1)

M, C, N_MAX_LEVEL = 16, 8, 3


class StubState(NamedTuple):
    x: object


class TorchCoarseStub(Sampler):
    """Moves every chain to a fixed coarse path, accepting by a fixed
    mask."""

    def __init__(self, action, x, acc):
        super().__init__(action)
        self.x, self.acc = torch.from_numpy(x), torch.from_numpy(acc)

    def init(self, generator, n_chains, dtype, device):
        return StubState(self.x)

    def draw(self, generator, state):
        return StubState(torch.where(self.acc[:, None], self.x, state.x)), \
            self.acc


class JaxCoarseStub:
    def __init__(self, x, acc):
        self.x, self.acc = jnp.asarray(x), jnp.asarray(acc)

    def set_state(self, state, x):
        return state._replace(x=x)

    def x_of(self, state):
        return state.x

    def draw(self, key, state):
        return StubState(jnp.where(self.acc[:, None], self.x, state.x)), \
            self.acc


def _actions(kind):
    if kind == "harmonic":
        return (HarmonicOscillatorAction(Lattice1D(M, 4.0),
                                         RenormalisationType.NONE, m0=1.0,
                                         mu2=1.0),
                JHarmonic(JLattice1D(M, 4.0), JRenorm.NONE, m0=1.0, mu2=1.0))
    return (RotorAction(Lattice1D(M, 4.0), RenormalisationType.NONE,
                        m0=0.25),
            JRotor(JLattice1D(M, 4.0), JRenorm.NONE, m0=0.25))


def _inputs(kind, seed):
    rs = np.random.default_rng(seed)
    scale = 0.7 if kind == "harmonic" else 0.4
    x = rs.normal(size=(C, M)) * scale
    xc = x[:, ::4] + rs.normal(size=(C, M // 4)) * 0.3 * scale
    fills = [rs.normal(size=(C, M // 2 >> ell)) * scale
             for ell in range(N_MAX_LEVEL - 1)]
    if kind == "rotor":
        x, xc = np.mod(x + np.pi, 2 * np.pi) - np.pi, \
            np.mod(xc + np.pi, 2 * np.pi) - np.pi
    acc = rs.random(C) < 0.75
    return x, xc, fills, acc


def _stub_fills(sampler, fills, to_array, set_odd):
    """Replace each level's fill by one that writes a fixed array into the
    odd sites (the conditioned action's evaluate stays the real one)."""
    for ell, step in enumerate(sampler.twolevel_steps):
        arr = to_array(fills[ell])
        step.conditioned_fine_action.fill_fine_points = \
            (lambda _g, x, arr=arr: set_odd(x, arr))


def _samplers(kind, x, xc, fills, acc):
    t_act, j_act = _actions(kind)
    ts = HierarchicalSampler(t_act, lambda a: TorchCoarseStub(a, xc, acc),
                             make_conditioned_fine_action, N_MAX_LEVEL)
    js = JHierarchical(j_act, lambda a: JaxCoarseStub(xc, acc), j_cond,
                       N_MAX_LEVEL)

    def t_set(x_, a):
        out = x_.clone()
        out[..., 1::2] = a
        return out
    _stub_fills(ts, fills, torch.from_numpy, t_set)
    _stub_fills(js, fills, jnp.asarray,
                lambda x_, a: x_.at[..., 1::2].set(a))
    return ts, js


def _jax_uniforms(key, n_level):
    """The accept uniforms JAX's draw takes at each level below the
    coarsest: keys[ell] split into (fill, accept) by the two-level step."""
    keys = jax.random.split(key, n_level)
    return [np.asarray(jax.random.uniform(jax.random.split(keys[ell])[1],
                                          (C,), jnp.float64))
            for ell in range(n_level - 1)]


@pytest.mark.parametrize("kind", ["harmonic", "rotor"])
@pytest.mark.parametrize("seed", [0, 1])
def test_one_draw_matches_jax(kind, seed, monkeypatch):
    x, xc, fills, acc = _inputs(kind, seed)
    ts, js = _samplers(kind, x, xc, fills, acc)
    L = ts.n_level
    key = jax.random.PRNGKey(seed)
    us = _jax_uniforms(key, L)
    # the port's step draws its accept uniform through ``uniform``: hand
    # it JAX's, level by level (the walk goes from level L-2 down to 0)
    order = iter(us[ell] for ell in range(L - 2, -1, -1))
    monkeypatch.setattr(ttl, "uniform", lambda *a, **k: torch.tensor(
        next(order)))

    z = np.zeros(L, np.int64)
    tstate = HierarchicalState(
        xs=(torch.from_numpy(x),) + (None,) * (L - 1),
        coarse=StubState(None), n_total=torch.from_numpy(z),
        n_accepted=torch.from_numpy(z), coarse_gen=torch.Generator())
    jstate = JHState(xs=(jnp.asarray(x),) + (None,) * (L - 1),
                     coarse=StubState(None), n_total=jnp.asarray(z),
                     n_accepted=jnp.asarray(z))
    tnew, tacc = ts.draw(torch.Generator(), tstate)
    jnew, jacc = js.draw(key, jstate)

    # restriction down the levels, prolongate + fill and the screen on the
    # way up: every level's state agrees
    for ell in range(L):
        np.testing.assert_allclose(tnew.xs[ell].numpy(),
                                   np.asarray(jnew.xs[ell]), rtol=0,
                                   atol=1e-12)
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(tnew.n_total.numpy(),
                                  np.asarray(jnew.n_total))
    np.testing.assert_array_equal(tnew.n_accepted.numpy(),
                                  np.asarray(jnew.n_accepted))
    assert tnew.n_total.dtype == torch.int64

    # dS of each level's screen from the same theta, coarse proposal and
    # fill, in both packages
    txs = [torch.from_numpy(x)]
    for ell in range(1, L):
        txs.append(ts.actions[ell - 1].restrict(txs[-1]))
    txs[L - 1] = torch.from_numpy(np.where(acc[:, None], xc,
                                           txs[L - 1].numpy()))
    for ell in range(L - 2, -1, -1):
        dS = []
        for sampler, arr in ((ts, torch.from_numpy), (js, jnp.asarray)):
            step = sampler.twolevel_steps[ell]
            fine, coarse = step.fine_action, step.coarse_action
            cond = step.conditioned_fine_action
            th, thc = arr(txs[ell].numpy()), arr(txs[ell + 1].numpy())
            thp = cond.fill_fine_points(None, fine.prolongate(thc, th))
            dS.append(np.asarray(
                (fine.evaluate(thp) - fine.evaluate(th))
                + (coarse.evaluate(fine.restrict(th)) - coarse.evaluate(thc))
                + (cond.evaluate(th) - cond.evaluate(thp))))
        np.testing.assert_allclose(dS[0], dS[1], rtol=0, atol=1e-12)
        txs[ell] = tnew.xs[ell]


class _MaskStep:
    """A two-level step that proposes a marked state and accepts by a fixed
    mask."""

    def __init__(self, mask, mark, to_array, where):
        self.mask, self.mark = to_array(mask), mark
        self.where = where

    def init(self, theta):
        return JTLState(theta, None, None)

    def draw(self, key, tl, theta_coarse):
        theta = self.where(self.mask[:, None], tl.theta * 0 + self.mark,
                           tl.theta)
        return JTLState(theta, None, None), self.mask


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_masking_and_counters_match_jax(seed):
    """Given per-level acceptance masks, a chain rejected at a coarser
    level keeps its fine state bit for bit, and each level counts the
    attempts and acceptances of the chains still alive, as JAX."""
    x, xc, fills, acc = _inputs("harmonic", seed)
    ts, js = _samplers("harmonic", x, xc, fills, acc)
    L = ts.n_level
    rs = np.random.default_rng(seed + 100)
    masks = [rs.random(C) < 0.6 for _ in range(L - 1)]
    for ell in range(L - 1):
        ts.twolevel_steps[ell] = _MaskStep(masks[ell], 100.0 + ell,
                                           torch.from_numpy, torch.where)
        js.twolevel_steps[ell] = _MaskStep(masks[ell], 100.0 + ell,
                                           jnp.asarray, jnp.where)
    n0 = np.array([5, 7, 11], np.int64)
    tstate = HierarchicalState(
        xs=(torch.from_numpy(x),) + (None,) * (L - 1),
        coarse=StubState(None), n_total=torch.from_numpy(n0),
        n_accepted=torch.from_numpy(n0 // 2), coarse_gen=torch.Generator())
    jstate = JHState(xs=(jnp.asarray(x),) + (None,) * (L - 1),
                     coarse=StubState(None), n_total=jnp.asarray(n0),
                     n_accepted=jnp.asarray(n0 // 2))
    tnew, tacc = ts.draw(torch.Generator(), tstate)
    jnew, jacc = js.draw(jax.random.PRNGKey(seed), jstate)
    alive = acc.copy()
    want_total, want_acc = n0.copy(), n0 // 2
    want_total[L - 1] += C
    want_acc[L - 1] += acc.sum()
    for ell in range(L - 2, -1, -1):
        want_total[ell] += alive.sum()
        alive = alive & masks[ell]
        want_acc[ell] += alive.sum()
    for new in (tnew, jnew):
        np.testing.assert_array_equal(np.asarray(new.n_total), want_total)
        np.testing.assert_array_equal(np.asarray(new.n_accepted), want_acc)
    np.testing.assert_array_equal(tacc.numpy(), alive)
    np.testing.assert_array_equal(np.asarray(jacc), alive)
    fine = tnew.xs[0].numpy()
    np.testing.assert_array_equal(fine[~alive], x[~alive])    # bit for bit
    assert np.all(fine[alive] == 100.0)
    np.testing.assert_array_equal(fine, np.asarray(jnew.xs[0]))


def _harmonic(M_lat):
    return HarmonicOscillatorAction(Lattice1D(M_lat, 4.0),
                                    RenormalisationType.NONPERTURBATIVE,
                                    m0=1.0, mu2=1.0)


def test_hierarchical_sampler_harmonic_oracle():
    """JAX tests/test_hierarchical_mlmc.py::test_hierarchical_sampler_
    harmonic on the port."""
    act = _harmonic(32)
    sampler = HierarchicalSampler(act, ExactSampler,
                                  make_conditioned_fine_action,
                                  n_max_level=3)
    mc = MonteCarloSingleLevel(act, qoi_x_squared(act.lattice), sampler,
                               n_burnin=100, n_samples=6000, chunk_size=100)
    _, stats = mc.evaluate(0, n_chains=64, dtype=torch.float64,
                           device="cpu")
    num, err = mc.numerical_result(stats), mc.statistical_error(stats)
    assert abs(num - act.Xsquared_analytical()) < 4 * err, (num, err)
    assert mc.stats_Q.tau_int(stats) < 2.0


def test_multilevel_sampler_harmonic_oracle():
    """JAX tests/test_multilevel_sampler.py::test_multilevel_sampler_
    harmonic_oracle on the port."""
    act = _harmonic(32)
    sampler = MultilevelSampler(act, qoi_x_squared, ExactSampler,
                                make_conditioned_fine_action, n_max_level=3)
    mc = MonteCarloSingleLevel(act, qoi_x_squared(act), sampler,
                               n_burnin=50, n_samples=4000, chunk_size=50)
    _, stats = mc.evaluate(1, n_chains=32, dtype=torch.float64,
                           device="cpu")
    num, err = mc.numerical_result(stats), mc.statistical_error(stats)
    assert abs(num - act.Xsquared_analytical()) < 4 * err, (num, err)
    assert mc.stats_Q.tau_int(stats) < 2.5


def test_multilevel_t_indep_bookkeeping():
    """JAX tests/test_multilevel_sampler.py::test_t_indep_bookkeeping."""
    act = _harmonic(16)
    sampler = MultilevelSampler(act, qoi_x_squared, ExactSampler,
                                make_conditioned_fine_action, n_max_level=2)
    gen = torch.Generator().manual_seed(2)
    state = sampler.prepare(gen, 16, torch.float64, "cpu")
    for _ in range(20):
        state, acc = sampler.draw(gen, state)
    assert bool(acc.all()) and acc.shape == (16,)
    assert (sampler.t_indep(state) >= 1.0).all()
    assert int(state.n_indep[0]) == 20   # one promotion per draw at level 0
    assert int(state.t_sampler.sum()) == 0


@pytest.mark.parametrize("which", ["hierarchical", "multilevel"])
def test_coarse_sampler_draws_from_its_own_generator(which, monkeypatch):
    """A host-seeded coarse sampler (the rotor sweep kernel takes its seed
    as host words) gets a CPU generator seeded once when the state is
    made; each coarse draw's kernel seed is that generator's next pair,
    and the generator the draw is given is not touched by it.  A sampler
    that is not host-seeded (HMC) gets one on the chains' device."""
    act = RotorAction(Lattice1D(16, 4.0), RenormalisationType.NONE, m0=0.25)
    seeds = []

    def record(x, seed, **kw):
        seeds.append(seed.clone())
        return x
    monkeypatch.setattr(trotor, "rotor_sweep", record)

    def coarse(a):
        return OverrelaxedHeatBathSampler(a, n_burnin=1, use_pallas=True)
    if which == "hierarchical":
        sampler = HierarchicalSampler(act, coarse,
                                      make_conditioned_fine_action, 3)
    else:
        sampler = MultilevelSampler(act, lambda a: None, coarse,
                                    make_conditioned_fine_action, 3)
        # an iid clock: tau_int ~ 1, so each level loops about once
        qgen = torch.Generator().manual_seed(3)
        sampler.qois = [lambda x: torch.rand(x.shape[0], dtype=x.dtype,
                                             generator=qgen)] * sampler.n_level
    state = sampler.init(torch.Generator().manual_seed(7), 4,
                         torch.float64, "cpu")
    assert state.coarse_gen.device.type == "cpu"
    ref = torch.Generator().manual_seed(state.coarse_gen.initial_seed())
    outer = torch.Generator().manual_seed(11)
    for _ in range(3):
        state, _ = sampler.draw(outer, state)
    assert len(seeds) >= 3
    for s in seeds:
        assert torch.equal(s, kernel_seed(ref))
    hmc = HierarchicalSampler(
        _harmonic(16), lambda a: HMCSampler(a, nt=2, n_burnin=1),
        make_conditioned_fine_action, 2)
    assert hmc.init(torch.Generator(), 2, torch.float64,
                    "cpu").coarse_gen.device.type == "cpu"
    assert not hmc.coarse_sampler.host_seeded
