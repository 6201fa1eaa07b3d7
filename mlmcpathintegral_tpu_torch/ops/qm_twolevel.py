"""Fused QM two-level Metropolis chain (port of
``mlmcpathintegral_tpu/ops/pallas_qm_twolevel.py``).

The QM two-level method (twolevelmetropolisstep.cc:35-89 driven by
montecarlotwolevel.cc:38-94) alternates tau-subsampled coarse HMC
trajectories (hmcsampler.cc:22-69) with the delayed-acceptance screen:
prolongate the coarse path, fill the odd sites from the Gaussian
conditional N(Wminimum, 1/Wcurvature)
(gaussianconditionedfineaction.cc:7-43), and accept on the three-term dS.
``qm_twolevel_chain`` runs ``n_steps`` such steps in one launch of the
CUDA kernel of ``csrc/qm_twolevel.cu`` for CUDA tensors, and the plain
PyTorch version below for CPU tensors.

The fine path is kept as its even and odd site planes [2, C, Mc]:
prolongation writes the even plane, the fill the odd one.  Trajectory t of
step s draws its momenta from CounterRng(site j, chain, step =
s (t_sub + 1) + t) words 1-2 and its accept uniform from word 3 of site 0;
the fill uses step s (t_sub + 1) + t_sub the same way.  The supported fine
actions are the harmonic and the quartic oscillator, one code path: lam = 0
reduces the quartic formulas (the Wminimum fixed point included) to the
harmonic ones.  ``t_sub`` and ``with_traces`` are run-time arguments of
the kernel; the sites a lane holds in registers are its template
parameter, so the kernel takes Mc up to 1024 (``qm_twolevel_launch``).
"""

from __future__ import annotations

import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops.hmc import force_and_action, leapfrog
from mlmcpathintegral_tpu_torch.ops.rng import (
    CounterRng, check_element_capacity, element_ids, seed_pair,
)

QM_TWOLEVEL = _cuda.KernelCounter(
    "qm_twolevel_chain", "mlmcpathintegral_tpu_torch/csrc/qm_twolevel.cu",
    "mlmcpathintegral_tpu/ops/pallas_qm_twolevel.py:196")


def _fine_action(xe, xo, *, m0, mu2, lam, x0, a):
    """The quartic action on the split planes: site 2j has the neighbour
    pair (xo_{j-1}, xo_j), site 2j+1 the pair (xe_j, xe_{j+1})."""
    d1 = xo - xe
    d2 = torch.roll(xo, 1, dims=-1) - xe
    xe2, xo2 = xe * xe, xo * xo
    qe = (xe - x0) * (xe - x0)
    qo = (xo - x0) * (xo - x0)
    s = (m0 * ((d1 * d1 + d2 * d2) / (a * a) + mu2 * (xe2 + xo2))
         + 0.5 * lam * (qe * qe + qo * qo))
    return 0.5 * a * torch.sum(s, dim=-1)


def _w_min_curv(x_m, x_p, *, m0, mu2, lam, x0, a):
    """Wminimum (4-step fixed point) and Wcurvature of the single-site
    conditioned action at spacing ``a``, the curvature taken at xbar
    (quarticoscillatoraction.hh:170-200)."""
    xbar = 0.5 * (x_m + x_p)
    rho = 1.0 / (1.0 + 0.5 * a * a * mu2)
    cc = 0.5 * a * a * lam / m0
    x = xbar
    for _ in range(4):
        xs = x - x0
        x = rho * (xbar - cc * xs * xs * xs)
    xs = xbar - x0
    curv = (2.0 / a + a * mu2) * m0 + 3.0 * lam * a * xs * xs
    return x, curv


def qm_twolevel_chain_plain(fine, x_coarse, s_cache, dt, seed, *, m0, mu2,
                            lam=0.0, x0=0.0, a_lat, nt, n_steps, t_sub,
                            with_traces=True, chain0=0):
    """Plain PyTorch version of the two-level kernel (any device, any float
    dtype); arguments and results as :func:`qm_twolevel_chain`."""
    QM_TWOLEVEL.count_plain(fine)
    _, C, Mc = fine.shape
    check_element_capacity(Mc, C, chain0)
    dtype = fine.dtype
    p_ = dict(m0=float(m0), mu2=float(mu2), lam=float(lam), x0=float(x0))
    fp = dict(p_, a=float(a_lat))
    force_c, action_c = force_and_action("quartic", **p_,
                                         a=2.0 * float(a_lat))
    seed1, seed2 = seed_pair(seed)
    site, chain = element_ids((Mc,), C, fine.device, chain0)
    dt = torch.as_tensor(dt, dtype=dtype, device=fine.device)
    inv_M, inv_Mc = 1.0 / (2 * Mc), 1.0 / Mc
    xe, xo, xc = fine[0], fine[1], x_coarse
    S_f, S_q = s_cache[0], s_cache[1]
    qfs, qcs, css, ecs, accs = [], [], [], [], []
    for s in range(n_steps):
        base = s * (t_sub + 1)
        for t in range(t_sub):
            rng = CounterRng(seed1, site, chain, seed2, step=base + t)
            p = rng.normal(dtype)
            T_cur = 0.5 * torch.sum(p * p, dim=-1)
            S_cur = action_c(xc)
            xt, p = leapfrog(xc, p, dt, force_c, int(nt))
            S_new = action_c(xt)
            dH = (S_new - S_cur) + (0.5 * torch.sum(p * p, dim=-1) - T_cur)
            u = rng.at(slice(0, 1)).uniform(dtype)[:, 0]
            accept = (dH < 0.0) | (u < torch.exp(-dH))
            xc = torch.where(accept[:, None], xt, xc)
            if with_traces:
                css.append(inv_Mc * torch.sum(xc * xc, dim=-1))
                ecs.append(torch.where(accept, S_new, S_cur))
        rng = CounterRng(seed1, site, chain, seed2, step=base + t_sub)
        wmin, curv = _w_min_curv(xc, torch.roll(xc, -1, dims=-1), **fp)
        xo_t = wmin + rng.normal(dtype) * torch.rsqrt(curv)
        log_curv = torch.log(curv)
        S_q_trial = torch.sum(0.5 * curv * (xo_t - wmin) * (xo_t - wmin)
                              - 0.5 * log_curv, dim=-1)
        S_f_trial = _fine_action(xc, xo_t, **fp)
        dS_coarse = action_c(xe) - action_c(xc)
        dS = (S_f_trial - S_f) + dS_coarse + (S_q - S_q_trial)
        u_acc = rng.at(slice(0, 1)).uniform(dtype)[:, 0]
        accept = (dS < 0.0) | (u_acc < torch.exp(-dS))
        xe = torch.where(accept[:, None], xc, xe)
        xo = torch.where(accept[:, None], xo_t, xo)
        S_f = torch.where(accept, S_f_trial, S_f)
        S_q = torch.where(accept, S_q_trial, S_q)
        qfs.append(inv_M * (torch.sum(xe * xe, dim=-1)
                            + torch.sum(xo * xo, dim=-1)))
        qcs.append(inv_Mc * torch.sum(xc * xc, dim=-1))
        accs.append(accept.to(dtype))

    def stack(xs):
        return torch.stack(xs) if xs else fine.new_zeros((0, C))
    if with_traces:
        cs, ec = stack(css), stack(ecs)
    else:
        cs, ec = fine.new_zeros((1, C)), fine.new_zeros((1, C))
    return (torch.stack([xe, xo]), xc, torch.stack([S_f, S_q]), stack(qfs),
            stack(qcs), cs, ec, stack(accs))


#: the most sites one lane of the kernel holds in registers: Mc <= 32 * 32
MAX_SITES_PER_LANE = 32


def kernel_takes(Mc: int) -> bool:
    """Whether the kernel holds Mc coarse sites a chain (Mc <= 1024);
    ``MonteCarloTwoLevel`` runs a larger level through its batched branch
    on the card."""
    return _cuda.next_pow2(-(-Mc // 32)) <= MAX_SITES_PER_LANE


def qm_twolevel_launch(Mc: int, n_chains: int | None = None):
    """(lanes per chain, sites per lane, chains per block, dynamic shared
    bytes) of the kernel's launch: a chain on one warp, or on a
    power-of-two share of one when Mc < 32; lane l holds sites l S ..
    l S + S - 1 in registers, S = Mc / 32 rounded up to a power of two
    (the kernel's template parameter); up to four warps a block; no shared
    memory."""
    sites = _cuda.next_pow2(-(-Mc // 32))
    if not kernel_takes(Mc):
        raise NotImplementedError(
            f"the two-level kernel holds at most {32 * MAX_SITES_PER_LANE} "
            f"coarse sites a chain in registers; got Mc={Mc}")
    lanes, cpb = _cuda.warp_chains(-(-Mc // sites), n_chains)
    return lanes, sites, cpb, 0


def qm_twolevel_attrs(Mc: int, n_chains: int):
    """Registers a thread, spilled bytes a thread and resident blocks and
    warps an SM of the kernel at its launch for n_chains chains of Mc
    coarse sites (the card is needed)."""
    lanes, sites, cpb, _ = qm_twolevel_launch(Mc, n_chains)
    return _cuda.kernel_attrs("mlmc_qm_twolevel_attrs", lanes * cpb, sites)


def _qm_twolevel_cuda(fine, x_coarse, s_cache, dt, seed, *, m0, mu2, lam,
                      x0, a_lat, nt, n_steps, t_sub, with_traces, chain0):
    _, C, Mc = fine.shape
    _cuda.require_cuda("fine", fine, (2, C, Mc))
    _cuda.require_cuda("x_coarse", x_coarse, (C, Mc))
    _cuda.require_cuda("s_cache", s_cache, (2, C))
    dt = torch.as_tensor(dt, dtype=torch.float32, device=fine.device)
    _cuda.require_cuda("dt", dt.reshape(1), (1,))
    check_element_capacity(Mc, C, chain0)
    lanes, sites, cpb, _ = qm_twolevel_launch(Mc, C)
    seed1, seed2 = seed_pair(seed)
    m0, mu2, lam, x0, a = (float(m0), float(mu2), float(lam), float(x0),
                           float(a_lat))
    ac = 2.0 * a
    n_traj = n_steps * t_sub if with_traces else 1

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=fine.device)
    fine_out, xc_out = torch.empty_like(fine), torch.empty_like(x_coarse)
    sc_out = torch.empty_like(s_cache)
    qf, qc, acc = empty(n_steps, C), empty(n_steps, C), empty(n_steps, C)
    cs, ec = empty(n_traj, C), empty(n_traj, C)
    err = _cuda.load_library().mlmc_qm_twolevel(
        fine.data_ptr(), x_coarse.data_ptr(), s_cache.data_ptr(),
        dt.data_ptr(), fine_out.data_ptr(), xc_out.data_ptr(),
        sc_out.data_ptr(), qf.data_ptr(), qc.data_ptr(), cs.data_ptr(),
        ec.data_ptr(), acc.data_ptr(), C, Mc, int(nt), int(n_steps),
        int(t_sub), int(bool(with_traces)),
        m0 / ac, 2.0 + ac * ac * mu2, ac * lam, x0, ac * ac, mu2, m0,
        0.5 * lam, 0.5 * ac, 0.5 * a, a * a,
        1.0 / (1.0 + 0.5 * a * a * mu2), 0.5 * a * a * lam / m0,
        (2.0 / a + a * mu2) * m0, 3.0 * lam * a, 1.0 / (2 * Mc), 1.0 / Mc,
        seed1, seed2, chain0, lanes, lanes * cpb, sites,
        _cuda.stream_ptr(fine.device))
    _cuda.check_status(err, "qm_twolevel kernel launch")
    QM_TWOLEVEL.launches += 1
    return fine_out, xc_out, sc_out, qf, qc, cs, ec, acc


def qm_twolevel_chain(fine, x_coarse, s_cache, dt, seed, *, m0, mu2, lam=0.0,
                      x0=0.0, a_lat, nt, n_steps, t_sub, with_traces=True,
                      chain0=0):
    """Run ``n_steps`` of the fused QM two-level chain on all chains.

    fine: [2, C, Mc] even/odd site planes of the current fine paths;
    x_coarse: [C, Mc] coarse HMC chain state; s_cache: [2, C] cached
    (S_fine, S_cond) of the current fine paths; dt: the HMC step size (a
    float or a 0-d tensor, read by the kernel from device memory); seed:
    an int32 pair.  Returns (fine, x_coarse, s_cache, qf [n_steps, C],
    qc [n_steps, C], cs, ec, acc [n_steps, C]) with cs/ec the per-trajectory
    coarse QoI and coarse action traces [n_steps * t_sub, C], or [1, C]
    zeros with ``with_traces=False``.  ``chain0``: the global index of the
    first chain (a rank's offset under a chain mesh)."""
    kw = dict(m0=m0, mu2=mu2, lam=lam, x0=x0, a_lat=a_lat, nt=nt,
              n_steps=n_steps, t_sub=t_sub, with_traces=with_traces,
              chain0=chain0)
    if _cuda.dispatch_device(fine) == "cpu":
        return qm_twolevel_chain_plain(fine, x_coarse, s_cache, dt, seed,
                                       **kw)
    return _qm_twolevel_cuda(fine, x_coarse, s_cache, dt, seed, **kw)
