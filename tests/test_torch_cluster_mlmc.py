"""The port's unfused multilevel path and hybrid Schwinger cluster sampler:
the link reconstruction and the rotor path rebuilt from links against the
JAX package given identical noise (f64, 1e-12) and their round trip; the
subsample clock; the batched screen against a sequential two-level
Metropolis screen fed the same proposals and uniforms (exactly); against
the JAX package on the same fill noise and accept uniforms (f64, 1e-12):
the sequential two-level step, the batched screen in one and in three
slices, the coarse subsampler's trip counts on equal clock histories, and
one unfused chunk of the fine and of the coarsest level from the same
carries; the port's whole evaluate on the CPU with hybrid cluster coarse
chains and with unfused heat-bath coarse chains against the analytic
oracle; the card as every entry point's default device; and the
configurations still unported."""

import importlib
import inspect
import math
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmcpathintegral_tpu_torch
from mlmcpathintegral_tpu.conditioned.base import (
    ConditionedFineAction as JCondBase,
)
from mlmcpathintegral_tpu.lattice import Lattice1D as JLattice1D
from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCT
from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
from mlmcpathintegral_tpu.mc import MonteCarloMultiLevel as JMLMC
from mlmcpathintegral_tpu.mc.twolevel import (
    make_batched_screen as j_make_batched_screen,
)
from mlmcpathintegral_tpu.mc.twolevel import (
    make_coarse_subsampler as j_make_coarse_subsampler,
)
from mlmcpathintegral_tpu.mc.twolevelstep import (
    TwoLevelMetropolisStep as JTLStep,
)
from mlmcpathintegral_tpu.models.qft.schwinger import (
    QuenchedSchwingerAction as JAction,
)
from mlmcpathintegral_tpu.models.rotor import RotorAction as JRotor
from mlmcpathintegral_tpu.qoi import qoi_susceptibility as j_qoi
from mlmcpathintegral_tpu.samplers import (
    QuenchedSchwingerClusterSampler as JQSCluster,
)
from mlmcpathintegral_tpu.samplers.heatbath import HeatBathState as JHBState
from mlmcpathintegral_tpu.utils import statistics as jstats
from mlmcpathintegral_tpu_torch import convert, ops
from mlmcpathintegral_tpu_torch.conditioned.base import ConditionedFineAction
from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.mc import (
    MonteCarloMultiLevel, TwoLevelMetropolisStep,
)
from mlmcpathintegral_tpu_torch.mc import twolevel, twolevelstep
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
from mlmcpathintegral_tpu_torch.ops import rng as trng
from mlmcpathintegral_tpu_torch.qoi import (
    qoi_2d_susceptibility, qoi_susceptibility,
)
from mlmcpathintegral_tpu_torch.samplers import (
    OverrelaxedHeatBathSampler, QuenchedSchwingerClusterSampler,
)
from mlmcpathintegral_tpu_torch.samplers.heatbath import HeatBathState
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod

# the port's tests run small tensors: one thread per worker process
# avoids oversubscribing the cores the parallel test workers share
torch.set_num_threads(1)

TOL = 1e-12


def _samplers(Mt=8, Mx=4, beta=2.0):
    ja = JAction(JLattice2D(Mt, Mx, JCT.BOTH), beta=beta)
    ta = QuenchedSchwingerAction(Lattice2D(Mt, Mx, CoarseningType.BOTH),
                                 beta=beta)
    return (JQSCluster(ja, n_burnin=0, n_updates=5),
            QuenchedSchwingerClusterSampler(ta, n_burnin=0, n_updates=5))


def test_reconstruct_and_psi_from_links_match_jax():
    js, ts = _samplers()
    Mt, Mx, C = 8, 4, 6
    rs = np.random.default_rng(0)
    psi = rs.uniform(-np.pi, np.pi, (C, Mt * Mx))
    key = jax.random.PRNGKey(3)
    # the noise JAX's _reconstruct draws from its key
    k_th, k_ph = jax.random.split(key)
    th = np.array(jax.random.uniform(k_th, (C, Mx, Mt), jnp.float64,
                                     -math.pi, math.pi))
    u = np.array(jax.random.uniform(k_ph, (C, 1, 1, 2), jnp.float64,
                                    -math.pi, math.pi))
    want = np.asarray(js._reconstruct(key, jnp.asarray(psi)))
    got = ts.reconstruct(torch.from_numpy(psi), torch.from_numpy(th),
                         torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)

    x = rs.uniform(-np.pi, np.pi, (C, 2 * Mt * Mx))
    c = np.array(jax.random.uniform(key, (C, 1), jnp.float64, -math.pi,
                                    math.pi))
    want = np.asarray(js._psi_from_links(key, jnp.asarray(x)))
    got = ts.psi_from_links(torch.from_numpy(x), torch.from_numpy(c))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)

    # round trip: the plaquettes of the rebuilt links are the increments of
    # psi (walk order d[i*Mx+j] = P[j,i]), and psi comes back up to the
    # global rotation
    g = torch.Generator().manual_seed(1)
    tpsi = torch.from_numpy(psi)
    links = ts._reconstruct(g, tpsi)
    P = ts.action.plaquette_angles(links).transpose(-1, -2).reshape(C, -1)
    d = torch.roll(tpsi, -1, dims=-1) - tpsi
    assert torch.angle(torch.exp(1j * (P - d))).abs().max() < 1e-12
    back = ts._psi_from_links(g, links)
    shift = torch.angle(torch.exp(1j * (back - tpsi)))
    assert (shift - shift[:, :1]).abs().max() < 1e-12


def test_hybrid_draw_and_subsample_clock():
    """A hybrid draw keeps psi's increments equal to the mixed links'
    plaquettes, and the coarse subsampler records the sampler's plaquette
    energy clock, not the QoI."""
    _, s = _samplers(8, 8, 2.0)
    g = torch.Generator().manual_seed(0)
    st = s.prepare(g, 16, torch.float64, "cpu")
    st2, acc = s.draw(g, st)
    assert acc.all() and st2.x.shape == (16, 128)
    P = s.action.plaquette_angles(st2.x).transpose(-1, -2).reshape(16, -1)
    d = torch.roll(st2.psi, -1, dims=-1) - st2.psi
    assert torch.angle(torch.exp(1j * (P - d))).abs().max() < 1e-9
    obs = s.subsample_observable(st2.x)
    assert obs.shape == (16,) and ((obs > -1) & (obs < 1)).all()
    sub = twolevel.make_coarse_subsampler(
        s, qoi_2d_susceptibility(s.action))
    ss = stats_mod.init(16, 10, torch.float64, "cpu")
    ta = (torch.zeros((), dtype=torch.float64),) * 2
    _, ss, ta = sub(g, st2, ss, ta)
    # tau_int is 1 before any history: t = ceil(2 tau) = 2 draws
    assert float(ta[1]) == 1.0 and float(ta[0]) == 2.0
    rec = float(torch.mean(ss.avg))
    assert abs(rec - float(torch.mean(obs))) < 0.2


class _NoiseFill(ConditionedFineAction):
    """Fills the odd sites of a 1-D path from a preset queue of noise
    (a batch of rows for a batched call, one row otherwise);
    S_cond = sum(odd^2) / 2."""

    def __init__(self, action, noise):
        super().__init__(action)
        self.noise = noise
        self.pos = 0

    def fill_fine_points(self, generator, x):
        n = x.shape[0] if x.dim() == 3 else 1
        rows = self.noise[self.pos:self.pos + n]
        self.pos += n
        out = x.clone()
        out[..., 1::2] = rows if x.dim() == 3 else rows[0]
        return out

    def evaluate(self, x):
        return 0.5 * torch.sum(x[..., 1::2] ** 2, dim=-1)


class _Queue:
    """Stands in for ``uniform``: hands out the next rows of a preset
    [S, C] array."""

    def __init__(self, u):
        self.u, self.pos = u, 0

    def __call__(self, generator, shape, dtype, device, *args):
        n = shape[0] if len(shape) == 2 else 1
        out = self.u[self.pos:self.pos + n]
        self.pos += n
        return out if len(shape) == 2 else out[0]


@pytest.mark.parametrize("n_slices", [1, 3])
def test_batched_screen_equals_sequential_screen(monkeypatch, n_slices):
    S, C, M = 12, 32, 16
    fine = RotorAction(Lattice1D(M, 4.0), m0=0.25)
    coarse = fine.coarse_action()
    rs = np.random.default_rng(7)
    xcs = torch.from_numpy(rs.uniform(-np.pi, np.pi, (S, C, M // 2)))
    noise = torch.from_numpy(rs.normal(size=(S, C, M // 2)))
    u = torch.from_numpy(rs.uniform(size=(S, C)))
    theta0 = torch.from_numpy(rs.uniform(-np.pi, np.pi, (C, M)))
    qf, qc = qoi_susceptibility(fine), qoi_susceptibility(coarse)

    cond = _NoiseFill(fine, noise)
    tl0 = TwoLevelMetropolisStep(coarse, fine, cond).init(theta0)
    monkeypatch.setattr(twolevel, "uniform", _Queue(u))
    budget = (S // n_slices) * C * M * 4
    screen = twolevel.make_batched_screen(fine, coarse, cond, qf, qc,
                                          slice_budget_bytes=budget)
    tl_b, qf_b, qc_b, acc_b = screen(None, tl0, xcs)
    assert cond.pos == S

    cond_s = _NoiseFill(fine, noise)
    step = TwoLevelMetropolisStep(coarse, fine, cond_s)
    monkeypatch.setattr(twolevelstep, "uniform", _Queue(u))
    tl, qfs, accs = tl0, [], []
    for t in range(S):
        tl, acc = step.draw(None, tl, xcs[t])
        qfs.append(qf(tl.theta))
        accs.append(acc)
    assert torch.equal(tl_b.theta, tl.theta)
    assert torch.equal(tl_b.S_fine, tl.S_fine)
    assert torch.equal(tl_b.S_cond, tl.S_cond)
    assert torch.equal(qf_b, torch.stack(qfs))
    assert torch.equal(acc_b, torch.stack(accs))
    assert torch.equal(qc_b, qc(xcs))
    assert 0.05 < float(acc_b.double().mean()) < 0.95


# -- the unfused layer against the JAX package --------------------------------
#
# The randomness of the two packages differs (PRNG keys, torch.Generator),
# so each test fixes it: the coarse "sampler" is a deterministic map, the
# JAX fill draws normals from its key, and the port is handed exactly those
# normals and the JAX accept uniforms, recomputed here from the same key
# splits as the JAX code makes them.

S_CH, C_CH, M_CH, N_ACTIVE = 8, 16, 16, 5


def _shift(x, lib):
    """A deterministic stand-in for a coarse draw (mod 2 pi)."""
    y = x + 0.37 + 0.2 * lib.sin(lib.roll(x, 1, -1))
    return y - 2 * math.pi * lib.floor((y + math.pi) / (2 * math.pi))


class _JShift:
    """JAX-side deterministic coarse sampler; its clock is mean cos x."""

    def __init__(self, action):
        self.action = action

    def draw(self, key, state):
        return JHBState(x=_shift(state.x, jnp)), jnp.ones(
            state.x.shape[:1], bool)

    def x_of(self, state):
        return state.x

    def subsample_observable(self, x):
        return jnp.mean(jnp.cos(x), axis=-1)


class _Shift(_JShift):
    def draw(self, generator, state):
        return HeatBathState(x=_shift(state.x, torch)), torch.ones(
            state.x.shape[:1], dtype=torch.bool)

    def subsample_observable(self, x):
        return torch.mean(torch.cos(x), dim=-1)


class _JNormalFill(JCondBase):
    """JAX-side fill: the odd sites from normals of the fill key;
    S_cond = sum(odd^2) / 2."""

    def fill_fine_points(self, key, x):
        odd = x[..., 1::2]
        return x.at[..., 1::2].set(jax.random.normal(key, odd.shape,
                                                     x.dtype))

    def evaluate(self, x):
        return 0.5 * jnp.sum(x[..., 1::2] ** 2, axis=-1)


def _rotor_pair(M=M_CH):
    return (JRotor(JLattice1D(M, 4.0), m0=0.25),
            RotorAction(Lattice1D(M, 4.0), m0=0.25))


def _fill_and_accept_draws(key, n_slices, S, C, M):
    """The fill normals [S, C, M/2] and accept uniforms [S, C] JAX's
    batched screen draws from ``key`` in ``n_slices`` slices."""
    keys = [key] if n_slices == 1 else list(jax.random.split(key, n_slices))
    noise, u = [], []
    for k in keys:
        k_fill, k_acc = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(
            k_fill, (S // n_slices, C, M // 2), jnp.float64)))
        u.append(np.asarray(jax.random.uniform(
            k_acc, (S // n_slices, C), jnp.float64)))
    return (torch.from_numpy(np.concatenate(noise)),
            torch.from_numpy(np.concatenate(u)))


def _flat_close(got, want, what, tol=TOL):
    gl, wl = [], []

    def flat(t, out):
        if isinstance(t, (tuple, list)):
            for x in t:
                flat(x, out)
        else:
            out.append(np.asarray(t))
    flat(convert.to_numpy(got), gl)
    flat(convert.to_numpy(want), wl)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol,
                                   err_msg=f"{what} leaf {i}")


def test_twolevel_step_matches_jax(monkeypatch):
    """The port's sequential two-level Metropolis step against JAX's, fed
    the same fill noise and accept uniforms, over a chain of steps."""
    (jf, tf), n_steps = _rotor_pair(), 6
    jc, tc = jf.coarse_action(), tf.coarse_action()
    rs = np.random.default_rng(11)
    theta0 = rs.uniform(-np.pi, np.pi, (C_CH, M_CH))
    xcs = rs.uniform(-np.pi, np.pi, (n_steps, C_CH, M_CH // 2))
    jstep = JTLStep(jc, jf, _JNormalFill(jf))
    jstate = jstep.init(jnp.asarray(theta0))
    noise, u = [], []
    for t in range(n_steps):
        key = jax.random.PRNGKey(100 + t)
        k_fill, k_acc = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(
            k_fill, (C_CH, M_CH // 2), jnp.float64)))
        u.append(np.asarray(jax.random.uniform(k_acc, (C_CH,),
                                               jnp.float64)))
        jstate, jacc = jstep.draw(key, jstate, jnp.asarray(xcs[t]))
        noise[-1] = noise[-1][None]
        u[-1] = u[-1][None]
    cond = _NoiseFill(tf, torch.from_numpy(np.concatenate(noise)))
    monkeypatch.setattr(twolevelstep, "uniform",
                        _Queue(torch.from_numpy(np.concatenate(u))))
    step = TwoLevelMetropolisStep(tc, tf, cond)
    state = step.init(torch.from_numpy(theta0))
    accs = []
    for t in range(n_steps):
        state, acc = step.draw(None, state, torch.from_numpy(xcs[t]))
        accs.append(acc)
    _flat_close(state, jstate, "two-level state")
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert 0 < float(torch.stack(accs).double().mean()) < 1


@pytest.mark.parametrize("n_slices", [1, 3])
def test_batched_screen_matches_jax(monkeypatch, n_slices):
    """make_batched_screen (and its accept chain, metropolis_chain)
    against the JAX package's make_batched_screen, with JAX's fill noise
    and accept uniforms handed to the port: traces, final state and its
    cached actions, in one slice and in three."""
    S, C, M = 12, C_CH, M_CH
    jf, tf = _rotor_pair(M)
    jc, tc = jf.coarse_action(), tf.coarse_action()
    rs = np.random.default_rng(8)
    theta0 = rs.uniform(-np.pi, np.pi, (C, M))
    xcs = rs.uniform(-np.pi, np.pi, (S, C, M // 2))
    budget = (S // n_slices) * C * M * 4
    key = jax.random.PRNGKey(21)

    jcond = _JNormalFill(jf)
    jtl = JTLStep(jc, jf, jcond).init(jnp.asarray(theta0))
    jscreen = j_make_batched_screen(jf, jc, jcond, j_qoi(jf), j_qoi(jc),
                                    slice_budget_bytes=budget)
    want = jscreen(key, jtl, jnp.asarray(xcs))

    noise, u = _fill_and_accept_draws(key, n_slices, S, C, M)
    cond = _NoiseFill(tf, noise)
    tl0 = TwoLevelMetropolisStep(tc, tf, cond).init(torch.from_numpy(theta0))
    monkeypatch.setattr(twolevel, "uniform", _Queue(u))
    screen = twolevel.make_batched_screen(
        tf, tc, cond, qoi_susceptibility(tf), qoi_susceptibility(tc),
        slice_budget_bytes=budget)
    tl, qf, qc, acc = screen(None, tl0, torch.from_numpy(xcs))
    assert cond.pos == S
    _flat_close((tl, qf, qc), want[:3], "batched screen")
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want[3]))
    assert 0.05 < float(acc.double().mean()) < 0.95


def _history(rho, n=60, C=C_CH, seed=0):
    """An AR(1) clock history [n, C] with lag-1 correlation rho."""
    rs = np.random.default_rng(seed)
    x = np.empty((n, C))
    x[0] = rs.normal(size=C)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + math.sqrt(1 - rho * rho) * rs.normal(size=C)
    return x


@pytest.mark.parametrize("rho,t_max", [(0.0, 100), (0.6, 100), (0.9, 100),
                                       (0.99, 100), (0.9, 3)])
def test_coarse_subsampler_matches_jax(rho, t_max):
    """make_coarse_subsampler against JAX's on equal clock histories: the
    trip count t = min(ceil(2 tau_int), t_max) (through t_accum), the
    coarse state after t draws and the clock statistics, over three
    consecutive samples."""
    jf, tf = _rotor_pair()
    hist = _history(rho)
    jst = jstats.record_block(jstats.init(C_CH, 20, jnp.float64),
                              jnp.asarray(hist))
    x0 = np.random.default_rng(1).uniform(-np.pi, np.pi, (C_CH, M_CH // 2))
    jcarry = (JHBState(x=jnp.asarray(x0)), jst,
              (jnp.asarray(0.0), jnp.asarray(0.0)))
    carry = convert.to_torch(jcarry, "cpu")
    jsub = j_make_coarse_subsampler(_JShift(jf.coarse_action()),
                                    j_qoi(jf.coarse_action()), t_max=t_max)
    sub = twolevel.make_coarse_subsampler(
        _Shift(tf.coarse_action()), qoi_susceptibility(tf.coarse_action()),
        t_max=t_max)
    trips = []
    for i in range(3):
        jcarry = jsub(jax.random.PRNGKey(i), *jcarry)
        carry = sub(None, *carry)
        _flat_close(carry, jcarry, f"subsample {i}")
        trips.append(float(carry[2][0]))
    assert carry[2][1] == 3.0
    # the first sample's trip count is the rule applied to JAX's tau_int
    # of the history (3 to 72 draws over these histories, 3 when capped)
    assert trips[0] == min(t_max, math.ceil(
        2.0 * float(jstats.tau_int_device(jst))))
    if t_max == 3:
        assert trips == [3.0, 6.0, 9.0]


def _carries(mc_j, seed=3):
    """JAX-side level-0 and coarsest carries with some history in every
    accumulator (the clock's an AR(1) series with tau_int about 5)."""
    rs = np.random.default_rng(seed)
    Mc = M_CH // 2

    def st(rho):
        return jstats.record_block(jstats.init(C_CH, 20, jnp.float64),
                                   jnp.asarray(_history(rho, 40, C_CH,
                                                        seed)))

    def acc():
        return (jnp.asarray(3.0), jnp.asarray(1.5))
    x_f = jnp.asarray(rs.uniform(-np.pi, np.pi, (C_CH, M_CH)))
    carry = (JHBState(x=jnp.asarray(rs.uniform(-np.pi, np.pi, (C_CH, Mc)))),
             mc_j.twolevel_steps[0].init(x_f), st(0.0), st(0.8), st(0.0),
             acc())
    carry_L = (JHBState(x=jnp.asarray(rs.uniform(-np.pi, np.pi,
                                                 (C_CH, Mc)))),
               st(0.0), st(0.8), st(0.0), acc())
    return carry, carry_L


def _unfused_mlmc_pair(noise):
    jf, tf = _rotor_pair()
    mc_j = JMLMC(jf, j_qoi, coarse_sampler_factory=_JShift,
                 conditioned_fine_action_factory=_JNormalFill, n_level=2,
                 n_burnin=0, n_samples=100, chunk_size=S_CH)
    mc_t = MonteCarloMultiLevel(
        tf, qoi_susceptibility, coarse_sampler_factory=_Shift,
        conditioned_fine_action_factory=lambda a: _NoiseFill(a, noise),
        n_level=2, n_burnin=0, n_samples=100, chunk_size=S_CH,
        use_pallas=False)
    return mc_j, mc_t


@pytest.mark.parametrize("level", ["fine", "coarsest"])
def test_unfused_chunks_match_jax(monkeypatch, level):
    """One unfused chunk of each package from the same carries (carried
    across by convert.py): the fine level's subsampled coarse draws, batched
    screen and Y record, and the coarsest level's measurements; every leaf
    of the returned carry and the per-step Y means, in f64 to 1e-12."""
    key = jax.random.PRNGKey(5)
    # the JAX fine chunk: k_c drives the coarse draws, k_s the screen (one
    # slice at this size)
    _, k_s = jax.random.split(key)
    noise, u = _fill_and_accept_draws(k_s, 1, S_CH, C_CH, M_CH)
    mc_j, mc_t = _unfused_mlmc_pair(noise)
    assert sorted(mc_t._unfused) == [0, 1]
    carry_j, carry_Lj = _carries(mc_j)
    jin = carry_j if level == "fine" else carry_Lj
    tin = convert.to_torch(convert.to_numpy(jin), "cpu")
    jchunk = mc_j._chunk[0] if level == "fine" else mc_j._chunk_L
    want = jchunk(key, jin, jnp.asarray(N_ACTIVE, jnp.int32))
    monkeypatch.setattr(twolevel, "uniform", _Queue(u))
    got = mc_t._unfused[0 if level == "fine" else 1](
        torch.tensor([1, 2], dtype=torch.int32), tin, N_ACTIVE)
    _flat_close(got, want, f"{level} chunk")
    # the subsampler took more than one draw per sample on this clock
    assert float(got[0][-1][0]) - 3.0 > S_CH


def _mlmc(coarse, cond=make_schwinger_conditioned_fine_action, **kw):
    act = QuenchedSchwingerAction(
        Lattice2D(8, 8, CoarseningType.BOTH), beta=4.0,
        renormalisation=RenormalisationType.NONPERTURBATIVE)
    if coarse == "cluster":
        factory = lambda a: QuenchedSchwingerClusterSampler(  # noqa: E731
            a, n_burnin=20, n_updates=5, use_pallas=True)
    else:
        factory = lambda a: OverrelaxedHeatBathSampler(  # noqa: E731
            a, n_burnin=100)
    args = dict(n_level=2, n_burnin=100, n_samples=3000, chunk_size=16,
                use_pallas=coarse == "cluster")
    args.update(kw)
    return MonteCarloMultiLevel(
        act, qoi_2d_susceptibility, coarse_sampler_factory=factory,
        conditioned_fine_action_factory=cond, **args)


@pytest.mark.parametrize("coarse", ["cluster", "heatbath_unfused"])
def test_unfused_evaluate_on_cpu_matches_oracle(coarse):
    """8x8, BOTH, beta=4 nonperturbative, 64 chains, ~3000 samples per
    level, every level unfused: hybrid cluster coarse chains (whose
    cluster updates run the K7 plain version) or plain heat-bath ones."""
    ops.reset_counters()
    mc = _mlmc(coarse)
    assert sorted(mc._unfused) == [0, 1]
    stats = mc.evaluate(torch.Generator().manual_seed(1), n_chains=64,
                        dtype=torch.float64, device="cpu")
    num, err = mc.numerical_result(), mc.statistical_error()
    oracle = mc.actions[0].chit_exact()
    assert abs(num - oracle) < 4 * err, (num, err, oracle)
    assert all(mc.stats_qoi[ell].samples(stats[ell]) >= 3000
               for ell in range(2))
    assert mc.tau_slow == [None, None] and mc._t_sub == [8, 8]
    assert all(c.launches == 0 and c.plain_cuda_calls == 0
               for c in ops.counters())


def _public_callables():
    for info in pkgutil.walk_packages(mlmcpathintegral_tpu_torch.__path__,
                                      "mlmcpathintegral_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if name.startswith("_") or getattr(obj, "__module__",
                                               None) != mod.__name__:
                continue
            if inspect.isfunction(obj):
                yield f"{mod.__name__}.{name}", obj
            elif inspect.isclass(obj):
                for mname, m in vars(obj).items():
                    if inspect.isfunction(m) and not mname.startswith("_"):
                        yield f"{mod.__name__}.{name}.{mname}", m


def test_entry_points_default_to_the_card():
    defaults = {}
    for qual, fn in _public_callables():
        p = inspect.signature(fn).parameters.get("device")
        if p is not None and p.default is not inspect.Parameter.empty:
            defaults[qual] = p.default
    assert defaults["mlmcpathintegral_tpu_torch.mc.multilevel."
                    "MonteCarloMultiLevel.evaluate"] == "cuda"
    assert defaults["mlmcpathintegral_tpu_torch.ops.rng.rng_fill"] == "cuda"
    assert set(defaults.values()) == {"cuda"}, defaults
    assert inspect.signature(trng.rng_fill_plain).parameters[
        "device"].default is inspect.Parameter.empty
    if not torch.cuda.is_available():
        # no silent CPU run: without a card the default raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trng.rng_fill(1, n_sites=2, n_chains=2, n_steps=1, n_ctr=2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _mlmc("cluster").evaluate(0, n_chains=4)


class _SequentialFill(ConditionedFineAction):
    independent_fill = False

    def fill_fine_points(self, generator, x):
        return x

    def evaluate(self, x):
        return x.sum(dim=-1)


@pytest.mark.parametrize("kind", ["sequential_fill", "gff_heatbath",
                                  "rotor_nonperturbative"])
def test_still_unported_configurations_raise(kind):
    if kind == "sequential_fill":
        # ported since: a fill that reads the fine state gets the
        # sequential screen instead of the NotImplementedError it raised
        mc = _mlmc("heatbath_unfused", cond=_SequentialFill)
        carries, _ = mc.init_carries(torch.Generator().manual_seed(0), 4,
                                     torch.float64, "cpu")
        carry, ybar = mc._chunk(0)(torch.tensor([1, 2], dtype=torch.int32),
                                   carries[0], mc.chunk_size)
        assert ybar.shape == (mc.chunk_size,)
        assert bool(torch.isfinite(ybar).all())
        assert mc.stats_qoi[0].samples(carry[2]) == 4 * mc.chunk_size
    elif kind == "gff_heatbath":
        # the GFF heat bath is ported; its fused sweep, as in JAX, takes
        # the plain GFF only, never the Gibbs-smoothed coarse action
        from mlmcpathintegral_tpu_torch.models import GFFAction
        smoothed = GFFAction(Lattice2D(8, 8, CoarseningType.ROTATE), 1.0,
                             n_gibbs_smooth=2)
        with pytest.raises(ValueError, match="use_pallas"):
            OverrelaxedHeatBathSampler(smoothed, use_pallas=True)
    else:
        act = RotorAction(Lattice1D(16, 4.0),
                          RenormalisationType.NONPERTURBATIVE, 0.25)
        with pytest.raises(NotImplementedError):
            act.coarse_action()


def test_convert_carries_cluster_states():
    js, ts = _samplers()
    st = js.init(jax.random.PRNGKey(0), 4, jnp.float64)
    tst = convert.to_torch(st, "cpu")
    assert type(tst).__name__ == "SchwingerClusterState"
    assert tst.psi.shape == (4, 32) and tst.x.shape == (4, 64)
    back = convert.to_numpy(tst, types={"SchwingerClusterState": type(st)})
    assert type(back) is type(st)
    np.testing.assert_array_equal(back.psi, np.asarray(st.psi))
