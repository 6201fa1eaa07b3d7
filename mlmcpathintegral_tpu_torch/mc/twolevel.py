"""Two-level Monte Carlo (PyTorch port of
``mlmcpathintegral_tpu/mc/twolevel.py``; reference
src/montecarlo/montecarlotwolevel.{hh,cc}): the coarse subsampling and the
batched delayed-acceptance screen that the unfused multilevel path shares,
and ``MonteCarloTwoLevel``, the mean and variance of Y = Q_fine - Q_coarse.

``make_coarse_subsampler`` draws one roughly independent coarse sample:
t = ceil(2 tau_int) coarse draws (capped at t_max), with tau_int read
from the statistics of the sampler's clock observable once per sample.
``make_batched_screen`` screens a whole chunk of coarse samples with the
two-level Metropolis test: where the fill is conditionally independent of
the current fine state (``independent_fill``, every fill of the package),
the proposals of the chunk are one batched tensor program and only the
accept/reject chain over [C] scalars runs step by step.  A fill that
reads the current fine state goes through ``make_sequential_screen``: a
coarse sample and a two-level step at a time.

``MonteCarloTwoLevel`` runs a chunk of ``chunk_size`` samples per call:
on its fused path (harmonic or quartic fine action, HMC coarse sampler,
Gaussian fill) one launch of the QM two-level kernel (ops/qm_twolevel.py),
else a batched-screen chunk whose coarse samples come from one batched
draw of an exact sampler or from the subsampler.  Each chunk takes a seed
pair drawn from the run's ``torch.Generator``: the kernel takes it
directly, an unfused chunk seeds a generator on the chains' device from
it (on the card with a CPU twin for its kernel seeds, ``chunk_generator``).

Chain-parallel runs (``mesh=``, see parallel/chains.py): every rank builds
the set-up state for all C chains from the same generator, keeps its block
of C/W chains and draws the same chunk seeds; a kernel launch hashes the
global chain index (``chain0`` = the rank's first chain), so the fused
path's chains draw what they draw in a one-process run, bit for bit.  An
unfused chunk's generator is seeded from the chunk seed and the rank: its
noise is the rank's own, so that path equals the one-process run in
distribution, not bit for bit.  The statistics getters and every decision
(burn-in, sample targets, the t_sub clock, the acceptance rate) read the
accumulators gathered over the group, the same numbers on every rank.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import uniform
from mlmcpathintegral_tpu_torch.mc.twolevelstep import TwoLevelMetropolisStep
from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops.rng import seed_pair
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics
from mlmcpathintegral_tpu_torch.utils.timer import sync


class ChunkGenerator(torch.Generator):
    """A chunk's generator on the chains' device.  On the card ``host`` is
    a CPU generator of its own, from which its kernel seeds come
    (``samplers.base.kernel_seed``), so a launch takes its seed words
    without waiting for a read from the card; on the CPU it is None and
    the seeds come from the generator itself."""

    host = None


#: mixed into a chunk's seed for its CPU twin on the card
HOST_SEED_MIX = 0xD1B54A32D192ED03


def chunk_generator(seed, device, rank: int = 0) -> ChunkGenerator:
    """A generator on ``device`` seeded from a chunk's seed pair and, on a
    chain mesh, the rank (rank 0 takes the one-process seed), so the
    ranks' plain noise differs; on the card with a CPU twin for its kernel
    seeds (``ChunkGenerator``), seeded from the same words."""
    s1, s2 = seed_pair(seed)
    mix = (rank * 0x9E3779B97F4A7C15) & ((1 << 64) - 1)
    word = ((s1 << 32) | s2) ^ mix
    gen = ChunkGenerator(device=device)
    gen.manual_seed(word)
    if gen.device.type != "cpu":
        gen.host = torch.Generator().manual_seed(word ^ HOST_SEED_MIX)
    return gen


def run_generators(generator, device):
    """(next_seed, setup_gen) of a run: ``next_seed()`` draws a chunk's
    int32 seed pair from ``generator`` (a CPU ``torch.Generator``, or an
    int seed for one); ``setup_gen`` is a generator on ``device`` seeded
    from it, for the set-up noise."""
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(int(generator))

    def next_seed():
        return torch.randint(-2**31, 2**31 - 1, (2,), generator=generator,
                             dtype=torch.int32)

    setup_gen = torch.Generator(device=device)
    setup_gen.manual_seed(int(torch.randint(2**62, (1,),
                                            generator=generator)))
    return next_seed, setup_gen


def fill_row(buf, i: int, n: int, x):
    """``buf[i] = x`` into a buffer of n rows shaped like x, allocated at
    the first row: a chunk's coarse samples [n, C, ndof] are held once,
    where a list of them and its stack would hold them twice."""
    if buf is None:
        buf = x.new_empty((n, *x.shape))
    buf[i] = x
    return buf


def make_coarse_subsampler(coarse_sampler, qoi_coarse, t_max: int = 100,
                           clock_view=None):
    """Returns draw(generator, cstate, stats_cs, t_accum) -> (cstate,
    stats_cs, t_accum), which draws one roughly independent coarse sample;
    t_accum accumulates (sum of t, number of samples) for the t_indep
    estimate.  ``clock_view(stats_cs)``: the state the clock reads (the
    accumulators gathered over a chain mesh, so every rank draws the same
    t), by default stats_cs itself.

    The clock records the sampler's ``subsample_observable`` when it has
    one, else the coarse QoI (the reference's rule,
    montecarlotwolevel.cc:82-94).  The rule assumes the QoI is the chain's
    slowest mode, which is false for cluster samplers, whose chi_t is the
    fastest; clocking those on chi_t left the coarse proposals correlated
    and biased the screened chain.  A sampler with ``independent_draws``
    needs one draw per sample."""
    independent = getattr(coarse_sampler, "independent_draws", False)
    clock_obs = getattr(coarse_sampler, "subsample_observable", qoi_coarse)
    view = clock_view if clock_view is not None else (lambda st: st)

    def draw_coarse_sample(generator, cstate, stats_cs, t_accum):
        if independent:
            t = 1
        else:
            t = int(torch.clamp(torch.ceil(
                2.0 * stats_mod.tau_int_device(view(stats_cs))),
                max=float(t_max)))
        # the t draws' clock values go in as one block: the closed-form
        # block record equals t single records, and t is fixed for the
        # sample before its first draw
        obs = None
        for i in range(t):
            cstate, _ = coarse_sampler.draw(generator, cstate)
            obs = fill_row(obs, i, t,
                           clock_obs(coarse_sampler.x_of(cstate)))
        stats_cs = stats_mod.record_block(stats_cs, obs)
        sum_t, n_indep = t_accum
        return cstate, stats_cs, (sum_t + t, n_indep + 1.0)

    draw_coarse_sample.sampler = coarse_sampler
    return draw_coarse_sample


def metropolis_chain(init, S_f, S_q, S_cc, qf, u):
    """The sequential accept/reject chain of the screen over S proposals.

    init = (S_fine, S_cond, S_c(restrict(theta)), Q_fine) of the incoming
    state, each [C]; S_f, S_q, S_cc, qf, u: [S, C] per-proposal fine
    action, conditioned action, coarse action, fine QoI and accept
    uniform.  After an acceptance restrict(theta) is that proposal's
    coarse sample, so S_cc is carried from the proposals
    (twolevelmetropolisstep.cc:35-89).  Returns (final (s_f, s_q, s_cc,
    q_cur), index of the last accepted proposal [C] (-1 if none), Q_fine
    trace [S, C], accept trace [S, C])."""
    s_f, s_q, s_cc, q_cur = init
    idx = torch.full(s_f.shape, -1, dtype=torch.int64, device=s_f.device)
    q_trace, acc_trace = [], []
    for t in range(S_f.shape[0]):
        dS = (S_f[t] - s_f) + (s_cc - S_cc[t]) + (s_q - S_q[t])
        acc = (dS < 0.0) | (u[t] < torch.exp(-dS))
        s_f = torch.where(acc, S_f[t], s_f)
        s_q = torch.where(acc, S_q[t], s_q)
        s_cc = torch.where(acc, S_cc[t], s_cc)
        q_cur = torch.where(acc, qf[t], q_cur)
        idx = torch.where(acc, t, idx)
        q_trace.append(q_cur)
        acc_trace.append(acc)
    return ((s_f, s_q, s_cc, q_cur), idx, torch.stack(q_trace),
            torch.stack(acc_trace))


def make_batched_screen(fine_action, coarse_action, cond, qoi_fine,
                        qoi_coarse, *, slice_budget_bytes: int = 2 ** 28):
    """Batched delayed-acceptance screen.  Returns
    screen(generator, tl, xcs, s_cc_pre=None) -> (tl', qf_trace, qc_trace,
    accept_trace), traces [S, C], for the coarse samples xcs
    [S, C, ndof_c]; ``s_cc_pre`` [S, C], when given, is their coarse action
    (an exact sampler's draw computes it already).  Proposals go in slices
    so that the [S, C, ndof] tensor stays within ``slice_budget_bytes``.

    The fill's one-pass hooks go first, as in the JAX package: a fill
    with ``fill_with_logq_sf`` returns the filled proposals with their
    conditioned and fine actions, one with ``fill_with_logq`` with their
    conditioned action; otherwise fill, then evaluate both actions.  A
    fill shadows a hook to None where it does not hold."""

    fill_with_logq = getattr(cond, "fill_with_logq", None)
    fill_with_logq_sf = getattr(cond, "fill_with_logq_sf", None)

    def screen_slice(generator, tl, s_cc0, qf0, xcs, s_cc_pre=None):
        S = xcs.shape[0]
        theta = fine_action.prolongate(
            xcs, tl.theta.expand(S, *tl.theta.shape))
        if fill_with_logq_sf is not None:
            theta, S_q, S_f = fill_with_logq_sf(generator, theta)
        elif fill_with_logq is not None:
            theta, S_q = fill_with_logq(generator, theta)
            S_f = fine_action.evaluate(theta)
        else:
            theta = cond.fill_fine_points(generator, theta)
            S_q = cond.evaluate(theta)                # [S, C]
            S_f = fine_action.evaluate(theta)
        S_cc = (coarse_action.evaluate(xcs) if s_cc_pre is None
                else s_cc_pre)
        qf = qoi_fine(theta)
        u = uniform(generator, S_f.shape, S_f.dtype, S_f.device)
        (s_f, s_q, s_cc, q_cur), idx, qf_trace, acc = metropolis_chain(
            (tl.S_fine, tl.S_cond, s_cc0, qf0), S_f, S_q, S_cc, qf, u)
        # the final fine state: the last accepted proposal, else the
        # incoming state
        last = torch.gather(
            theta, 0, idx.clamp(min=0)[None, :, None].expand(
                1, *theta.shape[1:]))[0]
        theta_fin = torch.where((idx >= 0)[:, None], last, tl.theta)
        return (type(tl)(theta=theta_fin, S_fine=s_f, S_cond=s_q), s_cc,
                q_cur, qf_trace, acc)

    def screen(generator, tl, xcs, s_cc_pre=None):
        S, C = xcs.shape[0], xcs.shape[1]
        ndof = tl.theta.shape[-1]
        s_slice = max(1, min(S, slice_budget_bytes // max(C * ndof * 4, 1)))
        while S % s_slice:
            s_slice -= 1          # largest divisor within the budget
        s_cc0 = coarse_action.evaluate(fine_action.restrict(tl.theta))
        qf0 = qoi_fine(tl.theta)
        qf_all, acc_all = [], []
        for lo in range(0, S, s_slice):
            tl, s_cc0, qf0, qf_c, acc = screen_slice(
                generator, tl, s_cc0, qf0, xcs[lo:lo + s_slice],
                None if s_cc_pre is None else s_cc_pre[lo:lo + s_slice])
            qf_all.append(qf_c)
            acc_all.append(acc)
        return tl, torch.cat(qf_all), qoi_coarse(xcs), torch.cat(acc_all)

    return screen


def make_sequential_screen(step, draw_coarse, qoi_fine, qoi_coarse):
    """Sequential delayed-acceptance screen, for fills that read the
    current fine state (``independent_fill`` False), whose proposals cannot
    be built ahead of the chain.  Returns screen(generator, cstate, tl,
    st_cs, t_accum, n) -> (cstate, tl, st_cs, t_accum, qf_trace,
    qc_trace, accept_trace), traces [n, C]: per step one subsampled
    coarse sample (``draw_coarse``, ``make_coarse_subsampler``), then one
    two-level step (``step``, a ``TwoLevelMetropolisStep``) on it, the
    JAX package's scan."""
    x_of = draw_coarse.sampler.x_of

    def screen(generator, cstate, tl, st_cs, t_accum, n):
        qf, qc, acc = [], [], []
        for _ in range(n):
            cstate, st_cs, t_accum = draw_coarse(generator, cstate, st_cs,
                                                 t_accum)
            xc = x_of(cstate)
            tl, accept = step.draw(generator, tl, xc)
            qf.append(qoi_fine(tl.theta))
            qc.append(qoi_coarse(xc))
            acc.append(accept)
        return (cstate, tl, st_cs, t_accum, torch.stack(qf),
                torch.stack(qc), torch.stack(acc))

    return screen


class MonteCarloTwoLevel:

    def __init__(self, fine_action, qoi_factory, coarse_sampler_factory,
                 conditioned_fine_action_factory, *,
                 n_burnin: int = 100, n_samples: int = 10000,
                 n_autocorr_window: int = 20,
                 n_coarse_autocorr_window: int = 20,
                 n_fine_autocorr_window: int = 20,
                 n_delta_autocorr_window: int = 20,
                 chunk_size: int = 256, use_pallas: bool = False,
                 t_sub_min: int = 2):
        self.fine_action = fine_action
        self.coarse_action = fine_action.coarse_action()
        self.qoi_fine = qoi_factory(fine_action)
        self.qoi_coarse = qoi_factory(self.coarse_action)
        self.coarse_sampler = coarse_sampler_factory(self.coarse_action)
        self.conditioned_fine_action = conditioned_fine_action_factory(
            fine_action)
        self.twolevel_step = TwoLevelMetropolisStep(
            self.coarse_action, fine_action, self.conditioned_fine_action)
        self.n_burnin = int(n_burnin)
        self.n_samples = int(n_samples)
        self.chunk_size = int(chunk_size)
        self.stats_fine = Statistics("QoI[fine]", n_fine_autocorr_window)
        self.stats_coarse = Statistics("QoI[coarse]",
                                       n_coarse_autocorr_window)
        self.stats_diff = Statistics("delta QoI", n_delta_autocorr_window)
        self.stats_cs = Statistics("QoI[coarsesampler]", n_autocorr_window)
        self.stats_slow = Statistics("E[coarsesampler]", n_autocorr_window)
        self.t_sub_min = int(t_sub_min)
        self._fused_params = self._fused_qm_spec() if use_pallas else None
        self._set_mesh(None, 0)
        draw_coarse = make_coarse_subsampler(self.coarse_sampler,
                                             self.qoi_coarse,
                                             clock_view=self._gathered)
        if self.conditioned_fine_action.independent_fill:
            self._chunk = self._make_batched_chunk(
                draw_coarse,
                make_batched_screen(fine_action, self.coarse_action,
                                    self.conditioned_fine_action,
                                    self.qoi_fine, self.qoi_coarse))
        else:
            self._chunk = self._make_sequential_chunk(
                make_sequential_screen(self.twolevel_step, draw_coarse,
                                       self.qoi_fine, self.qoi_coarse))

    def _make_batched_chunk(self, draw_coarse, screen):
        """``chunk(seed, carry, n_active) -> (carry, n_acc)``: chunk_size
        coarse samples (one batched draw of an iid sampler, else
        subsampled one by one), then the batched screen of all of them;
        the statistics record the leading ``n_active`` samples."""
        batch_draw = (getattr(self.coarse_sampler, "draw_batch", None)
                      if getattr(self.coarse_sampler, "independent_draws",
                                 False) else None)
        bdwa = getattr(self.coarse_sampler, "draw_batch_with_action", None)
        n = self.chunk_size

        def chunk(seed, carry, n_active):
            cstate, tl, st_f, st_c, st_d, st_cs, t_accum = carry
            gen = chunk_generator(seed, tl.theta.device, self._rank)
            s_cc_pre = None
            if batch_draw is not None:
                if bdwa is not None:
                    cstate, xcs, s_cc_pre = bdwa(gen, cstate, n)
                else:
                    cstate, xcs = batch_draw(gen, cstate, n)
                st_cs = stats_mod.record_many(st_cs, self.qoi_coarse(xcs))
                sum_t, n_indep = t_accum
                t_accum = (sum_t + float(n), n_indep + float(n))
            else:
                xcs = None
                for i in range(n):
                    cstate, st_cs, t_accum = draw_coarse(gen, cstate, st_cs,
                                                         t_accum)
                    xcs = fill_row(xcs, i, n,
                                   self.coarse_sampler.x_of(cstate))
            tl, qf, qc, acc = screen(gen, tl, xcs, s_cc_pre)
            st_f = stats_mod.record_block(st_f, qf, n_valid=n_active)
            st_c = stats_mod.record_block(st_c, qc, n_valid=n_active)
            st_d = stats_mod.record_block(st_d, qf - qc, n_valid=n_active)
            n_acc = torch.sum(acc[:n_active])
            return (cstate, tl, st_f, st_c, st_d, st_cs, t_accum), n_acc

        return chunk

    def _make_sequential_chunk(self, screen):
        """``chunk(seed, carry, n_active) -> (carry, n_acc)``: chunk_size
        steps of the sequential screen (``make_sequential_screen``); the
        statistics record the leading ``n_active`` samples."""
        def chunk(seed, carry, n_active):
            cstate, tl, st_f, st_c, st_d, st_cs, t_accum = carry
            gen = chunk_generator(seed, tl.theta.device, self._rank)
            cstate, tl, st_cs, t_accum, qf, qc, acc = screen(
                gen, cstate, tl, st_cs, t_accum, self.chunk_size)
            st_f = stats_mod.record_block(st_f, qf, n_valid=n_active)
            st_c = stats_mod.record_block(st_c, qc, n_valid=n_active)
            st_d = stats_mod.record_block(st_d, qf - qc, n_valid=n_active)
            n_acc = torch.sum(acc[:n_active])
            return (cstate, tl, st_f, st_c, st_d, st_cs, t_accum), n_acc

        return chunk

    # -- fused QM path (ops/qm_twolevel.py) -------------------------------------

    def _fused_qm_spec(self):
        """Kernel parameters when the fused QM two-level kernel supports
        this configuration (harmonic or quartic fine action, HMC coarse
        sampler with one repetition, Gaussian fill), else None."""
        from mlmcpathintegral_tpu_torch.conditioned.qm import (
            GaussianConditionedFineAction,
        )
        from mlmcpathintegral_tpu_torch.ops.hmc import action_kernel_params
        from mlmcpathintegral_tpu_torch.samplers.hmc import HMCSampler
        if type(self.conditioned_fine_action) is not \
                GaussianConditionedFineAction:
            return None
        if not isinstance(self.coarse_sampler, HMCSampler) \
                or self.coarse_sampler.n_rep != 1:
            return None
        kind, params = action_kernel_params(self.fine_action)
        if kind not in ("harmonic", "quartic"):
            return None
        params = dict(params)
        params.setdefault("lam", 0.0)
        params.setdefault("x0", 0.0)
        return params

    def _runs_fused(self, device: torch.device) -> bool:
        """The fused kernel runs this configuration on ``device``: its
        parameters are set and, on the card, the kernel holds the coarse
        level (``qm_twolevel.kernel_takes``); a larger level runs through
        the batched branch, decided from the shape before any launch.  The
        CPU's plain version takes any size."""
        if self._fused_params is None:
            return False
        if device.type != "cuda":
            return True
        from mlmcpathintegral_tpu_torch.ops.qm_twolevel import kernel_takes
        return kernel_takes(self.coarse_action.lattice.M_lat)

    def _make_fused_chunk(self, t_sub: int, with_traces: bool = True):
        """``chunk(seed, carry, n_active) -> (carry, n_acc)``: one launch
        of the two-level kernel over chunk_size steps.  ``with_traces``
        keeps the per-trajectory clock traces (burn-in, the t_sub
        measurement); the sampling chunks drop them."""
        from mlmcpathintegral_tpu_torch.ops.qm_twolevel import (
            qm_twolevel_chain,
        )
        p = self._fused_params
        nt = self.coarse_sampler.nt
        chunk_size = self.chunk_size
        inv_Mc = 1.0 / self.coarse_action.lattice.M_lat

        def chunk(seed, carry, n_active):
            fine, xc, scache, dt, st_f, st_c, st_d, st_cs, st_slow = carry
            fine, xc, scache, qf, qc, cs, ec, acc = qm_twolevel_chain(
                fine, xc, scache, dt, seed, nt=nt, n_steps=chunk_size,
                t_sub=t_sub, with_traces=with_traces, chain0=self._chain0,
                **p)
            st_f = stats_mod.record_block(st_f, qf, n_valid=n_active)
            st_c = stats_mod.record_block(st_c, qc, n_valid=n_active)
            st_d = stats_mod.record_block(st_d, qf - qc, n_valid=n_active)
            if with_traces:
                st_cs = stats_mod.record_many(st_cs, cs)
                # intensive energy (per coarse site): the configuration
                # slow mode feeding the t_sub clock
                st_slow = stats_mod.record_many(st_slow, inv_Mc * ec)
            n_acc = torch.sum(acc[:n_active], dtype=torch.float32)
            return (fine, xc, scache, dt, st_f, st_c, st_d, st_cs,
                    st_slow), n_acc

        return chunk

    def _fused_t_sub(self):
        """t_sub from the measured clock: ceil(2 max(tau_QoI, tau_slow)) of
        the per-trajectory coarse traces, floored at t_sub_min and capped
        at 100 (montecarlotwolevel.cc:82-94 and the slow-mode rule)."""
        tau_q = stats_mod.tau_int_device(self._gathered(self._st_cs_last))
        tau_e = stats_mod.tau_int_device(self._gathered(self._st_slow_last))
        tau = float(torch.maximum(tau_q, tau_e))
        self.tau_slow = float(tau_e)
        return int(min(100, max(self.t_sub_min, math.ceil(2.0 * tau))))

    # -- chain mesh ----------------------------------------------------------

    def _set_mesh(self, mesh, chain0: int) -> None:
        """The run's chain mesh (None: one process), this rank's first
        global chain, which its kernel launches hash, and its rank, which
        seeds its unfused chunks' generators."""
        self._mesh = mesh
        self._chain0 = int(chain0)
        self._rank = mesh.axis("chains").rank if mesh is not None else 0
        self.coarse_sampler.chain0 = self._chain0

    def _gathered(self, state):
        """A statistics state over the global chain axis."""
        return stats_mod.gather(state, self._mesh)

    def init_carry(self, setup_gen, n_chains: int, dtype, device):
        """The chunk carry a run starts from, for ``n_chains`` chains on
        ``device`` with set-up noise from ``setup_gen`` (a generator on
        ``device``): the coarse sampler prepared (with its burn-in), the
        fine chain from prolongate + fill of the initial coarse sample (a
        draw from the proposal itself, so the screened chain never starts
        in its tail), cached actions and empty statistics.  The fused
        path's carry holds the kernel's planes and cached (S_fine,
        S_cond); the batched path's the sampler state and a
        ``TwoLevelState``."""
        from mlmcpathintegral_tpu_torch.convert import qm_planes, qm_s_cache
        device = torch.device(device)
        cstate = self.coarse_sampler.prepare(setup_gen, n_chains, dtype,
                                             device)
        x_fine = self.fine_action.initialise_state(setup_gen, n_chains,
                                                   dtype, device)
        x_fine = self.fine_action.prolongate(
            self.coarse_sampler.x_of(cstate), x_fine)
        x_fine = self.conditioned_fine_action.fill_fine_points(setup_gen,
                                                               x_fine)
        stats = (self.stats_fine.init(n_chains, dtype, device),
                 self.stats_coarse.init(n_chains, dtype, device),
                 self.stats_diff.init(n_chains, dtype, device),
                 self.stats_cs.init(n_chains, dtype, device))
        if self._runs_fused(device):
            carry = (qm_planes(x_fine), cstate.x,
                     qm_s_cache(self.fine_action,
                                self.conditioned_fine_action, x_fine),
                     cstate.dt) + stats + (
                self.stats_slow.init(n_chains, dtype, device),)
        else:
            zero = torch.zeros((), dtype=dtype, device=device)
            carry = (cstate, self.twolevel_step.init(x_fine)) + stats + (
                (zero, zero),)
        sync(carry)
        return carry

    def _start(self, generator, n_chains, dtype, device, mesh):
        """(next_seed, carry, local chain count) of a run: the set-up for
        all n_chains chains on every rank (as the JAX package builds and
        then shards), this rank's block of it under a mesh."""
        from mlmcpathintegral_tpu_torch.parallel.chains import (
            chain_offset, shard_chains,
        )
        self._set_mesh(None, 0)
        next_seed, setup_gen = run_generators(generator, device)
        carry = self.init_carry(setup_gen, n_chains, dtype, device)
        n_local = n_chains
        if mesh is not None:
            if self._runs_fused(torch.device(device)):
                # the kernel's planes [2, C, Mc] and caches [2, C] hold the
                # chains on their second axis
                fine, xc, scache = carry[:3]
                fine, scache = shard_chains(
                    mesh, (fine.transpose(0, 1), scache.transpose(0, 1)))
                carry = (fine.transpose(0, 1).contiguous(),
                         *shard_chains(mesh, (xc,)),
                         scache.transpose(0, 1).contiguous(),
                         *shard_chains(mesh, carry[3:]))
            else:
                carry = shard_chains(mesh, carry)
            n_local = n_chains // mesh.axis("chains").world_size
        self._set_mesh(mesh, chain_offset(mesh, n_chains))
        return next_seed, carry, n_local

    def _p_accept(self, n_accepted, n_done: int, n_chains: int,
                  device) -> float:
        """The acceptance rate over every rank's chains."""
        from mlmcpathintegral_tpu_torch.parallel.chains import (
            all_reduce_scalar,
        )
        total = all_reduce_scalar(self._mesh, float(n_accepted), "sum",
                                  operand_on=device)
        return total / (n_done * n_chains)

    def _evaluate_difference_fused(self, generator, n_chains, dtype, device,
                                   sampling_scope, mesh):
        t0 = time.monotonic()
        self.timings = {}
        next_seed, carry, n_local = self._start(generator, n_chains, dtype,
                                                device, mesh)
        self.timings["prepare_s"] = time.monotonic() - t0

        t_phase = time.monotonic()
        t_sub = self.t_sub_min
        chunk = self._make_fused_chunk(t_sub)
        n_burn = 0
        while n_burn < self.n_burnin:
            n = min(self.chunk_size, self.n_burnin - n_burn)
            carry, _ = chunk(next_seed(), carry, n)
            n_burn += n
        sync(carry)
        self.timings["burnin_s"] = time.monotonic() - t_phase

        # the t_sub clock from the burn-in traces (ratchet up only)
        t_phase = time.monotonic()
        self._st_cs_last, self._st_slow_last = carry[7], carry[8]
        t_sub = max(t_sub, self._fused_t_sub())
        chunk = self._make_fused_chunk(t_sub, with_traces=False)
        self._t_sub = t_sub
        # hard reset of the Y statistics after burn-in
        # (montecarlotwolevel.cc:66-69)
        carry = carry[:4] + (
            self.stats_fine.init(n_local, dtype, device),
            self.stats_coarse.init(n_local, dtype, device),
            self.stats_diff.init(n_local, dtype, device)) + carry[7:]
        sync(carry)
        self.timings["tsub_update_s"] = time.monotonic() - t_phase

        with sampling_scope or contextlib.nullcontext():
            t_phase = time.monotonic()
            n_accepted = torch.zeros((), dtype=torch.float32, device=device)
            n_done = 0
            local_target = -(-self.n_samples // n_chains)
            while n_done < local_target:
                n = min(self.chunk_size, local_target - n_done)
                carry, n_acc = chunk(next_seed(), carry, n)
                n_accepted = n_accepted + n_acc
                n_done += n
            sync(carry)
            self.timings["sampling_s"] = time.monotonic() - t_phase
        self.n_sampling_draws = self._drawn(n_done)
        self.elapsed_s = time.monotonic() - t0
        self.final_carry = carry
        _, _, _, _, st_f, st_c, st_d, st_cs, st_slow = carry
        self.p_accept = self._p_accept(n_accepted, n_done, n_chains, device)
        self.t_indep = float(t_sub)
        self._st_cs_last, self._st_slow_last = st_cs, st_slow
        g = self._gathered
        return {"fine": g(st_f), "coarse": g(st_c), "diff": g(st_d),
                "coarse_sampler": g(st_cs), "coarse_slow": g(st_slow)}

    def evaluate_difference(self, generator, n_chains: int,
                            dtype=torch.float32, device="cuda",
                            verbose: bool = False, sampling_scope=None,
                            mesh=None):
        """Burn-in, then record n_samples of (Q_f, Q_c, Y); returns the
        statistics states by name (montecarlotwolevel.cc:38-79).
        ``generator``: a CPU ``torch.Generator`` (or an int seed for one)
        from which every chunk's seed pair and the set-up noise are drawn;
        ``device``: where the chains live, the card unless the caller asks
        for the CPU ("cuda" runs the kernels, which take float32; "cpu"
        their plain versions, in any float dtype); ``sampling_scope``: a
        context manager (a profiler, say) entered around the sampling
        phase, outside its timer.

        ``mesh``: a chain mesh (``parallel.chain_mesh``) whose ranks split
        the n_chains chains, each rank calling this with the same
        arguments (the same generator seed); the returned statistics are
        gathered over the mesh, and ``final_carry`` holds this rank's
        chains.  The fused path stays fused: its kernel takes the rank's
        chain offset (the JAX package drops to the unfused screen under a
        mesh only because a Pallas call does not partition)."""
        device = _cuda.run_device(device)
        if self._runs_fused(device):
            return self._evaluate_difference_fused(generator, n_chains,
                                                   dtype, device,
                                                   sampling_scope, mesh)
        t0 = time.monotonic()
        self.timings = {}
        next_seed, carry, n_local = self._start(generator, n_chains, dtype,
                                                device, mesh)
        # accepted moves accumulate on the device: no host read per chunk
        n_accepted = torch.zeros((), dtype=torch.float64, device=device)
        self.timings["prepare_s"] = time.monotonic() - t0

        # burn-in, then a hard reset of the Y statistics
        # (montecarlotwolevel.cc:66-69)
        t_phase = time.monotonic()
        n_burn = 0
        while n_burn < self.n_burnin:
            n = min(self.chunk_size, self.n_burnin - n_burn)
            carry, _ = self._chunk(next_seed(), carry, n)
            n_burn += n
        cstate, tl, _, _, _, st_cs, t_accum = carry
        carry = (cstate, tl, self.stats_fine.init(n_local, dtype, device),
                 self.stats_coarse.init(n_local, dtype, device),
                 self.stats_diff.init(n_local, dtype, device), st_cs,
                 t_accum)
        if verbose:
            print("Burnin completed")
        sync(carry)
        self.timings["burnin_s"] = time.monotonic() - t_phase

        with sampling_scope or contextlib.nullcontext():
            t_phase = time.monotonic()
            n_done = 0
            local_target = -(-self.n_samples // n_chains)
            while n_done < local_target:
                n = min(self.chunk_size, local_target - n_done)
                carry, n_acc = self._chunk(next_seed(), carry, n)
                n_accepted = n_accepted + n_acc
                n_done += n
            sync(carry)
            # the sampling phase's wall: the scope of the reference baseline's
            # eff formula (burn-in and set-up excluded)
            self.timings["sampling_s"] = time.monotonic() - t_phase
        self.n_sampling_draws = self._drawn(n_done)
        self.elapsed_s = time.monotonic() - t0
        self.final_carry = carry
        _, _, st_f, st_c, st_d, st_cs, (sum_t, n_indep) = carry
        self.p_accept = self._p_accept(n_accepted, n_done, n_chains, device)
        self.t_indep = float(sum_t) / max(float(n_indep), 1.0)
        g = self._gathered
        return {"fine": g(st_f), "coarse": g(st_c), "diff": g(st_d),
                "coarse_sampler": g(st_cs)}

    def _drawn(self, n_recorded: int) -> int:
        """Samples a chain drew in a phase that recorded ``n_recorded``:
        every chunk draws ``chunk_size``."""
        return -(-n_recorded // self.chunk_size) * self.chunk_size

    def show_statistics(self, stats):
        print(self.stats_fine.summary(stats["fine"]))
        print(self.stats_coarse.summary(stats["coarse"]))
        print(self.stats_diff.summary(stats["diff"]))
        print("=== Coarse level sampler statistics ===")
        print(self.stats_cs.summary(stats["coarse_sampler"]))
        print(f" subsampling t_indep = {self.t_indep:.3f}")
        print(f" two-level acceptance = {self.p_accept:.4f}")
