"""The port's MonteCarloTwoLevel (mlmcpathintegral_tpu_torch/mc/twolevel.py)
against the JAX one: one fused chunk from the same carries (carried across
by convert.py) with the JAX chunk's own seed pair, the JAX side in Pallas
interpret mode, f64, to 1e-9; the t_sub clock on equal statistics; the HMC
step-size bisection on an injected acceptance rate; the port's fused
harmonic evaluate_difference on the CPU and its batched branch with exact
(iid) and with subsampled HMC coarse draws, against the analytic oracle."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.conditioned.qm import (
    make_conditioned_fine_action as j_make_cond,
)
from mlmcpathintegral_tpu.lattice import Lattice1D as JLattice1D
from mlmcpathintegral_tpu.mc import MonteCarloTwoLevel as JMC2
from mlmcpathintegral_tpu.models import (
    HarmonicOscillatorAction as JHarmonic,
)
from mlmcpathintegral_tpu.models import (
    QuarticOscillatorAction as JQuartic,
)
from mlmcpathintegral_tpu.qoi import qoi_x_squared as j_qoi_x2
from mlmcpathintegral_tpu.samplers import HMCSampler as JHMC
from mlmcpathintegral_tpu.samplers.hmc import HMCState as JHMCState
from mlmcpathintegral_tpu.utils import statistics as jstats
from mlmcpathintegral_tpu_torch import convert, ops
from mlmcpathintegral_tpu_torch.conditioned.base import ConditionedFineAction
from mlmcpathintegral_tpu_torch.conditioned.qm import (
    make_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.mc import MonteCarloTwoLevel
from mlmcpathintegral_tpu_torch.models import (
    HarmonicOscillatorAction, QuarticOscillatorAction,
)
from mlmcpathintegral_tpu_torch.qoi import qoi_x_squared
from mlmcpathintegral_tpu_torch.samplers import ExactSampler, HMCSampler

torch.set_num_threads(1)

C, M, CHUNK, N_ACTIVE, T_SUB = 16, 16, 4, 3, 2
TOL = 1e-9
QUARTIC = dict(m0=1.0, mu2=1.0, lam=1.0, x0=1.0)


def _pair(kind, M_lat=M):
    if kind == "harmonic":
        return (JHarmonic(JLattice1D(M_lat, 4.0), m0=1.0, mu2=1.0),
                HarmonicOscillatorAction(Lattice1D(M_lat, 4.0), m0=1.0,
                                         mu2=1.0))
    return (JQuartic(JLattice1D(M_lat, 4.0), **QUARTIC),
            QuarticOscillatorAction(Lattice1D(M_lat, 4.0), **QUARTIC))


def _mc_pair(kind, **kw):
    ja, ta = _pair(kind)
    args = dict(n_burnin=0, n_samples=100, chunk_size=CHUNK, use_pallas=True)
    args.update(kw)
    jmc = JMC2(ja, j_qoi_x2,
               coarse_sampler_factory=lambda a: JHMC(a, nt=5, dt=0.1,
                                                     n_burnin=0),
               conditioned_fine_action_factory=j_make_cond,
               pallas_interpret=True, block_chains=C, **args)
    tmc = MonteCarloTwoLevel(
        ta, qoi_x_squared,
        coarse_sampler_factory=lambda a: HMCSampler(a, nt=5, dt=0.1,
                                                    n_burnin=0),
        conditioned_fine_action_factory=make_conditioned_fine_action,
        **args)
    return jmc, tmc


def _history(rho, n=40, seed=0):
    """An AR(1) series [n, C] with lag-1 correlation rho."""
    rs = np.random.default_rng(seed)
    x = np.empty((n, C))
    x[0] = rs.normal(size=C)
    for i in range(1, n):
        x[i] = rho * x[i - 1] + math.sqrt(1 - rho * rho) * rs.normal(size=C)
    return x


def _jstats(rho, seed):
    return jstats.record_block(jstats.init(C, 20, jnp.float64),
                               jnp.asarray(_history(rho, seed=seed)))


def _jax_fused_carry(jmc, seed=3):
    """A fused-chunk carry of the JAX package: a coarse path, the fine path
    prolongated from it and filled, its cache, dt and five accumulators
    with some history."""
    rs = np.random.default_rng(seed)
    act = jmc.fine_action
    xc = 1.0 + 0.5 * rs.normal(size=(C, M // 2))
    x = act.prolongate(jnp.asarray(xc), jnp.zeros((C, M)))
    x = jmc.conditioned_fine_action.fill_fine_points(
        jax.random.PRNGKey(seed), x)
    return (jnp.asarray(convert.qm_planes(x)),
            jnp.asarray(xc + 0.1 * rs.normal(size=(C, M // 2))),
            jnp.asarray(convert.qm_s_cache(act, jmc.conditioned_fine_action,
                                           x)),
            jnp.asarray(0.15, jnp.float64),
            _jstats(0.0, 1), _jstats(0.3, 2), _jstats(0.0, 3),
            _jstats(0.8, 4), _jstats(0.5, 5))


def _flat_close(got, want, what):
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
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("kind, with_traces", [("quartic", True),
                                               ("quartic", False),
                                               ("harmonic", True)])
def test_fused_chunk_matches_jax(kind, with_traces):
    jmc, tmc = _mc_pair(kind)
    assert jmc._fused_params == tmc._fused_params
    jcarry = _jax_fused_carry(jmc)
    tcarry = convert.to_torch(convert.to_numpy(jcarry), "cpu")
    key = jax.random.PRNGKey(7)
    seed = np.array(jax.random.randint(key, (2,), -2**31, 2**31 - 1,
                                       jnp.int32))
    want = jmc._make_fused_chunk(T_SUB, C, with_traces)(
        key, jcarry, jnp.asarray(N_ACTIVE, jnp.int32))
    got = tmc._make_fused_chunk(T_SUB, with_traces)(
        torch.from_numpy(seed), tcarry, N_ACTIVE)
    _flat_close(got, want, "fused chunk")
    # the chunk recorded N_ACTIVE samples per chain and moved the chains
    assert int(got[0][4].n) == 40 + N_ACTIVE
    assert not torch.equal(got[0][1], tcarry[1])


@pytest.mark.parametrize("as_torch", [True, False])
def test_qm_planes_round_trip(as_torch):
    """convert.qm_planes splits [C, M] paths into the kernel's even and odd
    planes [2, C, M/2]; convert.qm_paths interleaves them back."""
    x = np.random.default_rng(0).normal(size=(C, M))
    xt = torch.from_numpy(x) if as_torch else x
    planes = convert.qm_planes(xt)
    assert tuple(planes.shape) == (2, C, M // 2)
    np.testing.assert_array_equal(np.asarray(planes[0]), x[:, ::2])
    np.testing.assert_array_equal(np.asarray(planes[1]), x[:, 1::2])
    back = convert.qm_paths(planes)
    assert isinstance(back, torch.Tensor) == as_torch
    np.testing.assert_array_equal(np.asarray(back), x)


@pytest.mark.parametrize("rho_q, rho_e", [(-0.5, -0.5), (0.9, 0.3),
                                          (0.3, 0.95), (0.97, 0.97)])
def test_fused_t_sub_matches_jax(rho_q, rho_e):
    jmc, tmc = _mc_pair("quartic")
    jmc._st_cs_last, jmc._st_slow_last = _jstats(rho_q, 1), _jstats(rho_e, 2)
    tmc._st_cs_last, tmc._st_slow_last = convert.to_torch(
        (jmc._st_cs_last, jmc._st_slow_last), "cpu")
    t_sub = tmc._fused_t_sub()
    assert t_sub == jmc._fused_t_sub()
    assert tmc.tau_slow == pytest.approx(jmc.tau_slow, abs=1e-12)
    if rho_q < 0.0:
        # anticorrelated clocks: tau_int = 1, the floor
        assert t_sub == tmc.t_sub_min


def _accept_rate(dt, lib):
    """An injected acceptance rate, falling with the step size."""
    return lib.clip(1.6 - 4.0 * dt, 0.0, 1.0)


@pytest.mark.parametrize("rate, converges", [
    (lambda dt, lib: _accept_rate(dt, lib), True),
    (lambda dt, lib: 0.5 + 0.0 * dt, False)], ids=["bisects", "reverts"])
def test_autotune_bisection_matches_jax(rate, converges):
    ja, ta = _pair("harmonic")
    jh = JHMC(ja.coarse_action(), nt=5, dt=0.1, n_burnin=0)
    th = HMCSampler(ta.coarse_action(), nt=5, dt=0.1, n_burnin=0)
    n = 100     # the rate in steps of 0.01, the bisection's tolerance
    idx = np.arange(n)

    def j_step(key, x, dt):
        return x, jnp.asarray(idx) < jnp.floor(n * rate(dt, jnp))

    def t_step(generator, x, dt):
        return x, torch.from_numpy(idx) < torch.floor(n * rate(dt, torch))

    jh._single_step, th._single_step = j_step, t_step
    x = np.zeros((n, M // 2))
    jst = jh.autotune_stepsize(jax.random.PRNGKey(0),
                               JHMCState(x=jnp.asarray(x),
                                         dt=jnp.asarray(0.1)))
    tst = th.autotune_stepsize(None, convert.to_torch(
        JHMCState(x=x, dt=np.asarray(0.1)), "cpu"))
    assert float(tst.dt) == pytest.approx(float(jst.dt), abs=1e-15)
    assert (float(tst.dt) != 0.1) == converges


def _oracle_check(mc, stats, action, which):
    avg = getattr(mc, f"stats_{which}").average(stats[which])
    err = getattr(mc, f"stats_{which}").error(stats[which])
    oracle = action.Xsquared_analytical()
    assert abs(avg - oracle) < 4.0 * err, (which, avg, err, oracle)


def test_fused_harmonic_evaluate_matches_oracle():
    """The fused path on the CPU through the plain kernels: M=16, T=2,
    64 chains, against the analytic <x^2> of the fine action."""
    ops.reset_counters()
    act = HarmonicOscillatorAction(Lattice1D(16, 2.0), m0=1.0, mu2=1.0)
    mc = MonteCarloTwoLevel(
        act, qoi_x_squared,
        coarse_sampler_factory=lambda a: HMCSampler(a, nt=20, dt=0.1,
                                                    n_burnin=50,
                                                    use_pallas=True),
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_burnin=64, n_samples=64 * 192, chunk_size=32, use_pallas=True)
    assert mc._fused_params is not None
    stats = mc.evaluate_difference(torch.Generator().manual_seed(2),
                                   n_chains=64, dtype=torch.float64,
                                   device="cpu")
    _oracle_check(mc, stats, act, "fine")
    _oracle_check(mc, stats, mc.coarse_action, "coarse")
    assert mc.p_accept > 0.5 and mc.t_indep >= mc.t_sub_min
    assert mc.stats_fine.samples(stats["fine"]) == 64 * 192
    assert set(mc.timings) == {"prepare_s", "burnin_s", "tsub_update_s",
                               "sampling_s"}
    assert all(c.launches == 0 and c.plain_cuda_calls == 0
               for c in ops.counters())
    assert "QoI[fine]: Avg +/- Err" in mc.stats_fine.summary(stats["fine"])


def test_iid_branch_matches_oracle():
    """The batched branch with one batched exact draw per chunk: the
    coarse samples are iid (t_indep = 1), and the screen accepts them
    against the fine harmonic action."""
    act = HarmonicOscillatorAction(Lattice1D(16, 4.0), m0=1.0, mu2=1.0)
    mc = MonteCarloTwoLevel(
        act, qoi_x_squared, coarse_sampler_factory=ExactSampler,
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_burnin=32, n_samples=64 * 128, chunk_size=64, use_pallas=True)
    assert mc._fused_params is None
    stats = mc.evaluate_difference(torch.Generator().manual_seed(3),
                                   n_chains=64, dtype=torch.float64,
                                   device="cpu")
    _oracle_check(mc, stats, act, "fine")
    _oracle_check(mc, stats, mc.coarse_action, "coarse")
    assert mc.t_indep == 1.0 and 0.5 < mc.p_accept < 1.0


def test_subsampled_branch_runs():
    """The batched branch with HMC coarse chains subsampled one draw at a
    time (use_pallas=False): a short run gives finite statistics."""
    _, ta = _pair("quartic", 8)
    mc = MonteCarloTwoLevel(
        ta, qoi_x_squared,
        coarse_sampler_factory=lambda a: HMCSampler(a, nt=4, dt=0.2,
                                                    n_burnin=4),
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_burnin=8, n_samples=16 * 8, chunk_size=8)
    stats = mc.evaluate_difference(torch.Generator().manual_seed(4),
                                   n_chains=16, dtype=torch.float64,
                                   device="cpu")
    assert math.isfinite(mc.stats_diff.average(stats["diff"]))
    assert mc.t_indep >= 1.0 and 0.0 < mc.p_accept <= 1.0


class _SequentialFill(ConditionedFineAction):
    independent_fill = False

    def fill_fine_points(self, generator, x):
        return x

    def evaluate(self, x):
        return x.sum(dim=-1)


def test_sequential_screen_is_not_ported():
    # ported since: a fill that reads the fine state gets the sequential
    # screen (tests/test_torch_sequential_screen.py) instead of the
    # NotImplementedError it raised
    _, ta = _pair("harmonic")
    mc = MonteCarloTwoLevel(ta, qoi_x_squared, ExactSampler, _SequentialFill)
    assert mc._chunk.__qualname__.startswith(
        "MonteCarloTwoLevel._make_sequential_chunk")
    if not torch.cuda.is_available():
        # no silent CPU run: without a card the default device raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MonteCarloTwoLevel(
                ta, qoi_x_squared, ExactSampler,
                make_conditioned_fine_action).evaluate_difference(0, 4)


def test_qm_paths_default_to_the_card():
    """The QM paths' entry points run on the card unless asked for the
    CPU, and raise without one before any work."""
    import inspect

    from mlmcpathintegral_tpu_torch.perf_probe import (
        harmonic_hmc, quartic_twolevel,
    )
    for fn in (harmonic_hmc, quartic_twolevel,
               MonteCarloTwoLevel.evaluate_difference,
               HarmonicOscillatorAction.precision_symbol):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        for run in (lambda: harmonic_hmc(n_chains=4),
                    lambda: quartic_twolevel(n_chains=4)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                run()


class _Branch(Exception):
    pass


@pytest.mark.parametrize("M_lat, branch", [(64, "fused"),
                                           (4096, "batched")])
def test_fused_level_the_kernel_does_not_hold_runs_batched_on_the_card(
        monkeypatch, M_lat, branch):
    """On the card the fused kernel holds Mc <= 1024 coarse sites a chain:
    a fused configuration at M_lat = 4096 (Mc = 2048) takes the batched
    branch, decided from the shape before any launch, and one at M_lat =
    64 the fused one.  The card is stubbed: run_device answers "cuda", the
    two branches record themselves and stop, and the kernel's launch
    layout records any call."""
    from mlmcpathintegral_tpu_torch.mc import twolevel
    from mlmcpathintegral_tpu_torch.ops import _cuda
    from mlmcpathintegral_tpu_torch.ops import qm_twolevel as qtl

    act = HarmonicOscillatorAction(Lattice1D(M_lat, 4.0), m0=1.0, mu2=1.0)
    mc = MonteCarloTwoLevel(
        act, qoi_x_squared,
        coarse_sampler_factory=lambda a: HMCSampler(a, nt=20, dt=0.1,
                                                    use_pallas=True),
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_burnin=8, n_samples=64, chunk_size=8, use_pallas=True)
    assert mc._fused_params is not None
    launches = []

    def launch(*args, **kwargs):
        launches.append(args)
        raise _Branch("launch")

    def fused(*args, **kwargs):
        raise _Branch("fused")

    def batched(*args, **kwargs):
        raise _Branch("batched")

    monkeypatch.setattr(_cuda, "run_device",
                        lambda device="cuda": torch.device("cuda"))
    monkeypatch.setattr(qtl, "qm_twolevel_launch", launch)
    monkeypatch.setattr(MonteCarloTwoLevel, "_evaluate_difference_fused",
                        fused)
    monkeypatch.setattr(twolevel, "run_generators", batched)
    with pytest.raises(_Branch) as taken:
        mc.evaluate_difference(torch.Generator().manual_seed(1), n_chains=4)
    assert str(taken.value) == branch
    assert launches == []
    # the CPU's plain version takes any size: the fused branch there
    monkeypatch.setattr(_cuda, "run_device",
                        lambda device="cuda": torch.device("cpu"))
    with pytest.raises(_Branch, match="fused"):
        mc.evaluate_difference(torch.Generator().manual_seed(1), n_chains=4,
                               device="cpu")
