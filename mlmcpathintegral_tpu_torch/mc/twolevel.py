"""Coarse subsampling and the batched delayed-acceptance screen of the
unfused multilevel path (PyTorch port of the first half of
``mlmcpathintegral_tpu/mc/twolevel.py``; reference
src/montecarlo/montecarlotwolevel.{hh,cc}).

``make_coarse_subsampler`` draws one roughly independent coarse sample:
t = ceil(2 tau_int) coarse draws (capped at t_max), with tau_int read
from the statistics of the sampler's clock observable once per sample.
``make_batched_screen`` screens a whole chunk of coarse samples with the
two-level Metropolis test: because every fill is conditionally
independent of the current fine state, the proposals of the chunk are one
batched tensor program; only the accept/reject chain over [C] scalars
runs step by step.
"""

from __future__ import annotations

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import uniform
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod


def make_coarse_subsampler(coarse_sampler, qoi_coarse, t_max: int = 100):
    """Returns draw(generator, cstate, stats_cs, t_accum) -> (cstate,
    stats_cs, t_accum), which draws one roughly independent coarse sample;
    t_accum accumulates (sum of t, number of samples) for the t_indep
    estimate.

    The clock records the sampler's ``subsample_observable`` when it has
    one, else the coarse QoI (the reference's rule,
    montecarlotwolevel.cc:82-94).  The rule assumes the QoI is the chain's
    slowest mode, which is false for cluster samplers, whose chi_t is the
    fastest; clocking those on chi_t left the coarse proposals correlated
    and biased the screened chain.  A sampler with ``independent_draws``
    needs one draw per sample."""
    independent = getattr(coarse_sampler, "independent_draws", False)
    clock_obs = getattr(coarse_sampler, "subsample_observable", qoi_coarse)

    def draw_coarse_sample(generator, cstate, stats_cs, t_accum):
        if independent:
            t = 1
        else:
            t = int(torch.clamp(torch.ceil(
                2.0 * stats_mod.tau_int_device(stats_cs)), max=float(t_max)))
        for _ in range(t):
            cstate, _ = coarse_sampler.draw(generator, cstate)
            stats_cs = stats_mod.record(
                stats_cs, clock_obs(coarse_sampler.x_of(cstate)))
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
    screen(generator, tl, xcs) -> (tl', qf_trace, qc_trace, accept_trace),
    traces [S, C], for the coarse samples xcs [S, C, ndof_c].  Proposals
    go in slices so that the [S, C, ndof] tensor stays within
    ``slice_budget_bytes``."""

    def screen_slice(generator, tl, s_cc0, qf0, xcs):
        S = xcs.shape[0]
        theta = fine_action.prolongate(
            xcs, tl.theta.expand(S, *tl.theta.shape))
        theta = cond.fill_fine_points(generator, theta)
        S_q = cond.evaluate(theta)                    # [S, C]
        S_f = fine_action.evaluate(theta)
        S_cc = coarse_action.evaluate(xcs)
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

    def screen(generator, tl, xcs):
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
                generator, tl, s_cc0, qf0, xcs[lo:lo + s_slice])
            qf_all.append(qf_c)
            acc_all.append(acc)
        return tl, torch.cat(qf_all), qoi_coarse(xcs), torch.cat(acc_all)

    return screen
