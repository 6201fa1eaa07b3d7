"""Fused two-level Metropolis chain of the quenched Schwinger model — the
MLMC fine level (port of
``mlmcpathintegral_tpu/ops/pallas_schwinger_twolevel.py``).

``schwinger_twolevel_chain`` launches the CUDA kernel of
``csrc/schwinger_twolevel.cu`` for CUDA tensors and runs the plain
PyTorch version below for CPU tensors.  Per step:

  t_sub coarse heat-bath sweeps (the tau-subsampled coarse proposal)
  -> prolongate + 3-step conditioned fill
  -> the three dS terms + Metropolis accept
  -> emit Y = (Q_fine^2 - Q_coarse^2)/4 pi^2, coarse Q/energy traces and
     the accept bits.

The fine field is handled as eight parity components
T_ab = T(j=2J+a, i=2I+b), X_ab likewise, each [C, Mxc, Mtc]; every stencil
is a roll of whole components.  A fill whose truncated rejection loop
fails in any cell force-rejects the chain's move (an exact mixture of MH
kernels).  The in-kernel special functions are the Abramowitz-Stegun
forms of the reference kernel.
"""

from __future__ import annotations

import functools
import math

import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops.rng import (
    CounterRng, check_element_capacity, element_ids, seed_pair,
)
from mlmcpathintegral_tpu_torch.ops.schwinger import (
    TWOLEVEL_WORDS, _count_rounds, _expcos_rejection, _expcos_shift,
    _first_accepted, _mod_2pi, _one_step, block_threads, warp_lanes,
)
from mlmcpathintegral_tpu_torch.utils.timer import (
    COUNT_EVERY, recorded_launch,
)

PI = math.pi
TWO_PI = 2.0 * math.pi
FOURPI2_INV = 1.0 / (4.0 * math.pi * math.pi)

TWOLEVEL = _cuda.KernelCounter(
    "schwinger_twolevel_chain", "mlmcpathintegral_tpu_torch/csrc/"
    "schwinger_twolevel.cu",
    "mlmcpathintegral_tpu/ops/pallas_schwinger_twolevel.py:536")


# ---------------------------------------------------------------------------
# Special functions (Abramowitz & Stegun, as in the reference kernel)
# ---------------------------------------------------------------------------

_ERF_P = 0.3275911
_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def kernel_erf(x):
    """Abramowitz & Stegun 7.1.26 (|err| < 1.5e-7)."""
    s = torch.sign(x)
    z = torch.abs(x)
    t = 1.0 / (1.0 + _ERF_P * z)
    poly = torch.zeros_like(t)
    for a in reversed(_ERF_A):
        poly = (poly + a) * t
    return s * (1.0 - poly * torch.exp(-z * z))


_I0_SMALL = (1.0, 3.5156229, 3.0899424, 1.2067492, 0.2659732,
             0.0360768, 0.0045813)
_I0_LARGE = (0.39894228, 0.01328592, 0.00225319, -0.00157565, 0.00916281,
             -0.02057706, 0.02635537, -0.01647633, 0.00392377)


def kernel_log_i0(x):
    """log I0(x), A&S 9.8.1/9.8.2 (|rel err| < 2e-7), stable for large x."""
    z = torch.abs(x)
    y = z / 3.75
    t2 = y * y
    ps = torch.zeros_like(z)
    for a in reversed(_I0_SMALL):
        ps = ps * t2 + a
    u = 3.75 / torch.clamp(z, min=3.75)
    pl_ = torch.zeros_like(z)
    for a in reversed(_I0_LARGE):
        pl_ = pl_ * u + a
    zs = torch.clamp(z, min=3.75)
    large = zs - 0.5 * torch.log(zs) + torch.log(pl_)
    return torch.where(z < 3.75, torch.log(ps), large)


# ---------------------------------------------------------------------------
# Parity-component geometry: components [C, Mxc, Mtc];
# sh(A, dj, di) = A(J+dj, I+di)
# ---------------------------------------------------------------------------

def sh(A, dj, di):
    out = A
    if di:
        out = torch.roll(out, -di, dims=-1)
    if dj:
        out = torch.roll(out, -dj, dims=-2)
    return out


def split_parity(grid):
    """[C, Mx, Mt, 2] model grid -> [8, C, Mxc, Mtc] parity components
    (T00, T01, T10, T11, X00, X01, X10, X11)."""
    return torch.stack([grid[:, a::2, b::2, mu]
                        for mu in (0, 1) for a in (0, 1) for b in (0, 1)])


def merge_parity(comps):
    """[8, C, Mxc, Mtc] -> [C, Mx, Mt, 2]."""
    _, C, Mxc, Mtc = comps.shape
    g = comps.new_empty((C, 2 * Mxc, 2 * Mtc, 2))
    k = 0
    for mu in (0, 1):
        for a in (0, 1):
            for b in (0, 1):
                g[:, a::2, b::2, mu] = comps[k]
                k += 1
    return g


def sub_plaquettes(f):
    """The four fine plaquette parity grids P_ab = theta_P(2J+a, 2I+b)."""
    T00, T01, T10, T11, X00, X01, X10, X11 = f
    P00 = T00 + X01 - T10 - X00
    P01 = T01 + sh(X00, 0, 1) - T11 - X01
    P10 = T10 + X11 - sh(T00, 1, 0) - X10
    P11 = T11 + sh(X10, 0, 1) - sh(T01, 1, 0) - X11
    return P00, P01, P10, P11


def s_fine(f, beta):
    """beta sum_P (1 - cos theta_P) -> [C]."""
    acc = 0.0
    for P in sub_plaquettes(f):
        acc = acc + torch.sum(1.0 - torch.cos(P), dim=(-2, -1))
    return beta * acc


def q_topological(f):
    """sum_P mod_2pi(theta_P) -> [C] (qoi2dsusceptibility.cc:6-28)."""
    acc = 0.0
    for P in sub_plaquettes(f):
        acc = acc + torch.sum(_mod_2pi(P), dim=(-2, -1))
    return acc


def coarse_plaquettes(Tc, Xc):
    return Tc + sh(Xc, 0, 1) - sh(Tc, 1, 0) - Xc


def s_coarse(Tc, Xc, beta_c):
    P = coarse_plaquettes(Tc, Xc)
    return beta_c * torch.sum(1.0 - torch.cos(P), dim=(-2, -1))


def q_coarse(Tc, Xc):
    return torch.sum(_mod_2pi(coarse_plaquettes(Tc, Xc)), dim=(-2, -1))


def restrict_comps(f):
    """Fine components -> coarse links, mod 2pi (both-coarsening case of
    quenchedschwingeraction.cc:148-163)."""
    T00, T01, T10, T11, X00, X01, X10, X11 = f
    return _mod_2pi(T00 + T01), _mod_2pi(X00 + X10)


# ---------------------------------------------------------------------------
# Conditioned fill (quenchedschwingerconditionedfineaction.cc:7-78)
# ---------------------------------------------------------------------------

def _expcos_fill_draw(rng, tp, tm, beta, k_rej, dtype, count=None):
    """ExpCos rejection draw without fallback: (x, ok); lanes with
    ok=False carry no valid sample and force-reject the move."""
    tau, shift = _expcos_shift(tp, tm, beta)
    x, acc = _expcos_rejection(rng, tau, k_rej, dtype, count)
    return _mod_2pi(x + shift), acc


def _bessel_draw(rng, x_p, x_m, beta, log_i0_2beta, sigma_beta, k_rej,
                 dtype, count=None):
    """BesselProduct two-piece Gaussian-envelope rejection draw, truncated
    at k_rej rounds (4 words a round; 2 in the flat small-beta regime);
    returns (x, ok); ``count`` (or None) counts the loop."""
    sb = sigma_beta
    dx0 = x_m - x_p
    sign = torch.where(dx0 < 0, dx0.new_tensor(-1.0), dx0.new_tensor(1.0))
    dx = torch.abs(dx0)
    dm = dx - TWO_PI
    log_C_p = 2.0 * log_i0_2beta * (1.0 - dx * dx * FOURPI2_INV)
    log_C_m = 2.0 * log_i0_2beta * (1.0 - dm * dm * FOURPI2_INV)
    d = torch.clamp(log_C_p - log_C_m, -60.0, 60.0)
    p_right = 1.0 / (1.0 + torch.exp(-d))
    sigma = sb / math.sqrt(2.0)
    if 2.0 * log_i0_2beta <= 1.0:
        # uniform envelope, global bound p~ <= I0(2 beta)^2
        w = rng.uniform(dtype, n=2 * k_rej)
        w = w.reshape(k_rej, 2, *w.shape[1:])
        prop = PI * (2.0 * w[:, 0] - 1.0)
        xi = w[:, 1]
        log_rho = (kernel_log_i0(2.0 * beta * torch.cos(0.5 * prop))
                   + kernel_log_i0(2.0 * beta * torch.cos(0.5 * (prop - dx)))
                   - 2.0 * log_i0_2beta)
        in_interval = torch.ones_like(prop, dtype=torch.bool)
    else:
        w = rng.uniform(dtype, n=4 * k_rej)
        w = w.reshape(k_rej, 4, *w.shape[1:])
        right = w[:, 0] < p_right
        normal = (torch.sqrt(-2.0 * torch.log(w[:, 1]))
                  * torch.cos(TWO_PI * w[:, 2]))
        xi = w[:, 3]
        mu = torch.where(right, 0.5 * dx, 0.5 * dx - PI)
        a_min = torch.where(right, -PI + dx, torch.full_like(dx, -PI))
        a_max = torch.where(right, torch.full_like(dx, PI), -PI + dx)
        log_C = torch.where(right, log_C_p, log_C_m)
        prop = mu + sigma * normal
        in_interval = (prop >= a_min) & (prop < a_max)
        u = (prop - mu) / sb
        log_rho = (kernel_log_i0(2.0 * beta * torch.cos(0.5 * prop))
                   + kernel_log_i0(2.0 * beta * torch.cos(0.5 * (prop - dx)))
                   - log_C + u * u)
    ok = in_interval & (torch.log(xi) <= log_rho)
    _count_rounds(count, ok)
    x, acc = _first_accepted(prop, ok)
    return _mod_2pi(sign * x + x_p), acc


def _approx_fold(x0):
    """x_p - x_m folded to [0, pi] with sign bookkeeping
    (approximatebesselproductdistribution.cc:10-19)."""
    sign = torch.where(x0 < 0, x0.new_tensor(-1.0), x0.new_tensor(1.0))
    x0 = torch.abs(x0)
    flip = x0 > PI
    sign = torch.where(flip, -sign, sign)
    x0 = torch.where(flip, TWO_PI - x0, x0)
    return x0, sign


def _approx_params(x0, beta):
    """(N_p, s2p, s2m) of the large-beta Gaussian mixture; the weight in
    log space (f32-safe for s2m -> 0)."""
    eps = 0.125 * PI
    s2p = torch.where(x0 < eps, x0.new_tensor(beta),
                      beta * torch.cos(0.25 * x0))
    s2m_raw = beta * torch.sin(0.25 * x0)
    s2m_c = torch.clamp(s2m_raw, min=1e-20)
    log_rho = 1.5 * (torch.log(s2p) - torch.log(s2m_c)) \
        - 4.0 * (s2p - s2m_raw)
    N_p = torch.where(x0 < eps, x0.new_tensor(1.0),
                      1.0 / (1.0 + torch.exp(torch.clamp(log_rho, -60.0,
                                                         60.0))))
    s2m = torch.where(x0 < eps, x0.new_tensor(0.0), s2m_raw)
    return N_p, s2p, s2m


def _approx_bessel_draw(rng, x_p, x_m, beta, dtype):
    """Large-beta Gaussian-mixture draw (3 words), no rejection."""
    x0, sign = _approx_fold(x_p - x_m)
    N_p, s2p, s2m = _approx_params(x0, beta)
    main = rng.uniform(dtype) <= N_p
    sigma = torch.where(main, torch.rsqrt(s2p),
                        torch.rsqrt(torch.clamp(s2m, min=1e-20)))
    xshift = torch.where(main, x0.new_tensor(0.0), x0.new_tensor(PI))
    x = sigma * rng.normal(dtype) + 0.5 * x0 - xshift
    return _mod_2pi(sign * x + x_m), torch.ones_like(x, dtype=torch.bool)


def _approx_log_eval(x, x_p, x_m, beta, kmax=4):
    """log of the mixture density with 2 kmax + 1 periodic copies."""
    x0, sign = _approx_fold(x_p - x_m)
    z = sign * (x - x_m)
    N_p, s2p, s2m = _approx_params(x0, beta)
    s_p = torch.zeros_like(z)
    s_m = torch.zeros_like(z)
    for k in range(-kmax, kmax + 1):
        zs = z - 0.5 * x0 + 2.0 * k * PI
        s_p = s_p + torch.sqrt(s2p) * torch.exp(-0.5 * s2p * zs * zs)
        zs = zs + PI
        s_m = s_m + torch.sqrt(torch.clamp(s2m, min=0.0)) * torch.exp(
            -0.5 * s2m * zs * zs)
    dens = math.sqrt(0.5 / math.pi) * (N_p * s_p + (1.0 - N_p) * s_m)
    return torch.log(torch.clamp(dens, min=1e-30))


def _expcos_log_eval(x, beta, tp, tm):
    """log p(x | tp, tm) of ExpCos, stable for large beta."""
    sigma = 2.0 * beta * torch.abs(torch.cos(0.5 * (tp - tm)))
    s = beta * (torch.cos(x - tp) + torch.cos(x - tm))
    return s - math.log(TWO_PI) - kernel_log_i0(sigma)


def prolongate_fill(rng, Tc, Xc, beta, log_i0_2beta, sigma_beta, k_rej,
                    k_rej_bessel, dtype, exact=True, counts=None):
    """Trial fine state: prolongate the coarse links + 3-step fill.
    Returns (components, fill_ok[C]).  ``counts`` (or None): the rows of
    the BesselProduct draws and of the ExpCos fill to count into."""
    c_bes, c_fill = (None, None) if counts is None else counts
    # prolongate 'both': each coarse link splits evenly over its halves
    T00 = 0.5 * Tc
    T01 = 0.5 * Tc
    X00 = 0.5 * Xc
    X10 = 0.5 * Xc

    # STEP 1: perimeter randomisation — +-u on the two halves
    u_t = PI * (2.0 * rng.uniform(dtype) - 1.0)
    u_x = PI * (2.0 * rng.uniform(dtype) - 1.0)
    T00 = _mod_2pi(T00 + u_t)
    T01 = _mod_2pi(T01 - u_t)
    X00 = _mod_2pi(X00 + u_x)
    X10 = _mod_2pi(X10 - u_x)

    # STEP 2: interior vertical links — sum from BesselProduct, split
    theta_p = _mod_2pi(T01 + sh(X00, 0, 1) + sh(X10, 0, 1) - sh(T01, 1, 0))
    theta_m = _mod_2pi(X00 + X10 + sh(T00, 1, 0) - T00)
    if exact:
        theta_tilde, ok_b = _bessel_draw(rng, theta_p, theta_m, beta,
                                         log_i0_2beta, sigma_beta,
                                         k_rej_bessel, dtype, c_bes)
    else:
        theta_tilde, ok_b = _approx_bessel_draw(rng, theta_p, theta_m,
                                                beta, dtype)
    u = PI * (2.0 * rng.uniform(dtype) - 1.0)
    X01 = _mod_2pi(0.5 * theta_tilde + u)
    X11 = _mod_2pi(0.5 * theta_tilde - u)

    # STEP 3: interior horizontal links (odd-j rows) from ExpCos
    tp_e = _mod_2pi(T00 + X01 - X00)
    tm_e = _mod_2pi(X10 + sh(T00, 1, 0) - X11)
    T10, ok_e = _expcos_fill_draw(rng, tp_e, tm_e, beta, k_rej, dtype,
                                  c_fill)
    tp_o = _mod_2pi(T01 + sh(X00, 0, 1) - X01)
    tm_o = _mod_2pi(X11 + sh(T01, 1, 0) - sh(X10, 0, 1))
    T11, ok_o = _expcos_fill_draw(rng, tp_o, tm_o, beta, k_rej, dtype,
                                  c_fill)

    ok = ok_b & ok_e & ok_o
    fill_ok = ok.flatten(1).all(dim=1)                       # [C]
    return (T00, T01, T10, T11, X00, X01, X10, X11), fill_ok


def s_cond(f, beta, alphas):
    """Conditioned-action value of a filled fine state, exact beta <= 8
    branch (conditioned/schwinger.py evaluate) -> [C]."""
    T00, T01, T10, T11, X00, X01, X10, X11 = f
    phi_12 = X10 + sh(T00, 1, 0)
    phi_23 = sh(T01, 1, 0) - sh(X10, 0, 1)
    phi_34 = -T01 - sh(X00, 0, 1)
    phi_41 = -T00 + X00
    th_1 = T10
    th_2 = -X11
    th_3 = -T11
    th_4 = X01
    Phi = phi_12 + phi_23 + phi_34 + phi_41
    S = -beta * torch.sum(
        torch.cos(th_1 - th_2 - phi_12) + torch.cos(th_2 - th_3 - phi_23)
        + torch.cos(th_3 - th_4 - phi_34) + torch.cos(th_4 - th_1 - phi_41),
        dim=(-2, -1))
    # -log Znorm_inv = +log(1 + sum_k alpha_k cos(k Phi)), rescaled series
    series = 1.0
    for k, a_k in enumerate(alphas, start=1):
        series = series + a_k * torch.cos(float(k) * Phi)
    return S + torch.sum(torch.log(series), dim=(-2, -1))


def s_cond_approx(f, beta):
    """Conditioned-action value, large-beta branch: vertical-sum mixture
    density + horizontal ExpCos terms -> [C]."""
    T00, T01, T10, T11, X00, X01, X10, X11 = f
    theta_p = _mod_2pi(T01 + sh(X00, 0, 1) + sh(X10, 0, 1) - sh(T01, 1, 0))
    theta_m = _mod_2pi(X00 + X10 + sh(T00, 1, 0) - T00)
    th_v = _mod_2pi(X01 + X11)
    S = -torch.sum(_approx_log_eval(th_v, theta_p, theta_m, beta),
                   dim=(-2, -1))
    tp_e = _mod_2pi(T00 + X01 - X00)
    tm_e = _mod_2pi(X10 + sh(T00, 1, 0) - X11)
    tp_o = _mod_2pi(T01 + sh(X00, 0, 1) - X01)
    tm_o = _mod_2pi(X11 + sh(T01, 1, 0) - sh(X10, 0, 1))
    S = S - torch.sum(_expcos_log_eval(T10, beta, tp_e, tm_e)
                      + _expcos_log_eval(T11, beta, tp_o, tm_o),
                      dim=(-2, -1))
    return S


# ---------------------------------------------------------------------------
# The chain
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def fill_constants(beta: float):
    """(exact, alphas, log I0(2 beta), sigma_beta) of the fill at beta:
    the exact BesselProduct branch for beta <= 8, else the large-beta
    mixture (quenchedschwingerconditionedfineaction.hh:37-44)."""
    exact = float(beta) <= 8.0
    if not exact:
        return False, (), 0.0, 1.0
    from mlmcpathintegral_tpu_torch.distributions.besselproduct import (
        BesselProductDistribution,
    )
    bp = BesselProductDistribution(float(beta))
    return (True, tuple(float(a) for a in bp.alphaZ[1:]),
            bp.log_I0_twobeta, bp.sigma_beta)


@recorded_launch("k4.launch", 3)
def schwinger_twolevel_chain_plain(theta_fine, theta_coarse, s_fine_cache,
                                   s_cond_cache, seed, *, beta, beta_c, Mt,
                                   Mx, n_steps, t_sub=2, n_overrelax_c=1,
                                   n_heatbath_c=1, k_rej=8, k_rej_fill=16,
                                   k_rej_bessel=48, chain0=0, rounds=None):
    """Plain PyTorch version of the kernel (any device, any float dtype);
    same signature and outputs as :func:`schwinger_twolevel_chain`.
    Recorded as the kernel's launch, ``rounds`` the counts of the coarse
    heat bath, the BesselProduct draws and the ExpCos fill."""
    TWOLEVEL.count_plain(theta_fine)
    exact, alphas, log_i0_2beta, sigma_beta = fill_constants(float(beta))
    dtype = theta_fine.dtype
    C = theta_fine.shape[0]
    Mtc, Mxc = Mt // 2, Mx // 2
    check_element_capacity(Mxc * Mtc, C, chain0)
    seed1, seed2 = seed_pair(seed)
    f = tuple(split_parity(theta_fine.reshape(C, Mx, Mt, 2)))
    gc = theta_coarse.reshape(C, Mxc, Mtc, 2)
    Tc, Xc = gc[..., 0], gc[..., 1]
    S_f = s_fine_cache.to(dtype)
    S_q = s_cond_cache.to(dtype)
    site, chain = element_ids((Mxc, Mtc), C, theta_fine.device, chain0)
    ys, qcs, ecs, accs = [], [], [], []
    for s in range(n_steps):
        base = s * (t_sub + 1)
        for t in range(t_sub):
            rng_t = CounterRng(seed1, site, chain, seed2, step=base + t)
            Tc, Xc = _one_step(Tc, Xc, rng_t, beta=beta_c,
                               n_overrelax=n_overrelax_c,
                               n_heatbath=n_heatbath_c, k_rej=k_rej,
                               dtype=dtype,
                               count=None if rounds is None else rounds[0])
            P = coarse_plaquettes(Tc, Xc)
            qcs.append(torch.sum(_mod_2pi(P), dim=(-2, -1)))
            ecs.append(torch.sum(torch.cos(P), dim=(-2, -1)))
        rng = CounterRng(seed1, site, chain, seed2, step=base + t_sub)
        trial, fill_ok = prolongate_fill(
            rng, Tc, Xc, beta, log_i0_2beta, sigma_beta, k_rej_fill,
            k_rej_bessel, dtype, exact=exact,
            counts=None if rounds is None else (rounds[1], rounds[2]))
        S_f_trial = s_fine(trial, beta)
        Tc_r, Xc_r = restrict_comps(f)
        dS_coarse = s_coarse(Tc_r, Xc_r, beta_c) - s_coarse(Tc, Xc, beta_c)
        S_q_trial = (s_cond(trial, beta, alphas) if exact
                     else s_cond_approx(trial, beta))
        dS = (S_f_trial - S_f) + dS_coarse + (S_q - S_q_trial)
        u_acc = rng.at((slice(0, 1), slice(0, 1))).uniform(dtype)[:, 0, 0]
        accept = fill_ok & ((dS < 0.0) | (u_acc < torch.exp(-dS)))
        a3 = accept[:, None, None]
        f = tuple(torch.where(a3, t_new, t_old)
                  for t_new, t_old in zip(trial, f))
        S_f = torch.where(accept, S_f_trial, S_f)
        S_q = torch.where(accept, S_q_trial, S_q)
        qf = q_topological(f)
        qc = q_coarse(Tc, Xc)
        ys.append(FOURPI2_INV * (qf * qf - qc * qc))
        accs.append(accept.to(dtype))
    fine_out = merge_parity(torch.stack(f)).reshape(C, 2 * Mt * Mx)
    coarse_out = torch.stack([Tc, Xc], dim=-1).reshape(C, 2 * Mtc * Mxc)

    def stack(xs):
        return torch.stack(xs) if xs else theta_fine.new_zeros((0, C))
    return (fine_out, coarse_out, S_f, S_q, stack(ys), stack(qcs),
            stack(ecs), stack(accs))


def twolevel_smem_bytes(Mt: int, Mx: int, n_chains: int | None = None):
    """(lanes per chain, chains per block, dynamic shared bytes) of the
    two-level kernel's launch: the warp design (``schwinger.warp_lanes`` of
    the coarse grid, up to WARP_SITES_MAX coarse cells), a chain on a warp
    or on an aligned share of one, two lanes a cell, up to four warps a
    block; a larger field on the block design, a chain a block on
    ``schwinger.block_threads`` threads; per chain 20 floats a coarse cell
    and the TWOLEVEL_WORDS-word table, in a block the sums' scratch (5
    floats a thread) beside them."""
    ncells = (Mx // 2) * (Mt // 2)
    per_chain = 4 * (TWOLEVEL_WORDS + 20 * ncells)
    if warp_lanes(Mx // 2, Mt // 2) is not None:
        lanes, cpb = _cuda.warp_chains(2 * ncells, n_chains)
        return lanes, cpb, cpb * per_chain

    def smem_of(G):
        return per_chain + 4 * 5 * G
    G = block_threads(ncells, n_chains, smem_of)
    return G, 1, smem_of(G)


def twolevel_launch(Mt: int, Mx: int, n_chains: int):
    """(lanes per chain, chains per block, dynamic shared bytes, branch) of
    the two-level kernel's launch: branch "warp" (the warp design) or
    "block" (the block design, a chain a block).  The fields always live
    in shared memory: ``MonteCarloMultiLevel`` runs a level whose block
    (at ``team_slots`` threads, ``twolevel_smem_bytes`` without a chain
    count) does not fit unfused."""
    lanes, cpb, smem = twolevel_smem_bytes(Mt, Mx, n_chains)
    return lanes, cpb, smem, "warp" if lanes <= 32 else "block"


def twolevel_attrs(Mt: int, Mx: int, n_chains: int):
    """Registers a thread, spilled bytes a thread and resident blocks and
    warps an SM of the two-level kernel at its launch for n_chains chains
    of an Mx x Mt fine field (the card is needed)."""
    lanes, cpb, smem, branch = twolevel_launch(Mt, Mx, n_chains)
    return _cuda.kernel_attrs("mlmc_schwinger_twolevel_attrs", lanes * cpb,
                              smem, int(branch == "warp"), 0)  # uncounted


@functools.lru_cache(maxsize=32)
def _device_alphas(beta: float, device: torch.device):
    _, alphas, _, _ = fill_constants(beta)
    return torch.tensor(alphas if alphas else [0.0], dtype=torch.float32,
                        device=device)


@recorded_launch("k4.launch", 3, every=COUNT_EVERY)
def _twolevel_cuda(theta_fine, theta_coarse, s_fine_cache, s_cond_cache,
                   seed, *, beta, beta_c, Mt, Mx, n_steps, t_sub,
                   n_overrelax_c, n_heatbath_c, k_rej, k_rej_fill,
                   k_rej_bessel, chain0, rounds):
    """The kernel's launch; with ``rounds`` the counted kernel, which adds
    its three loops' counts to it."""
    C = theta_fine.shape[0]
    if Mt % 2 or Mx % 2:
        raise ValueError("both-direction coarsening needs even Mt, Mx")
    _cuda.require_cuda("theta_fine", theta_fine, (C, 2 * Mt * Mx))
    _cuda.require_cuda("theta_coarse", theta_coarse, (C, Mt * Mx // 2))
    _cuda.require_cuda("s_fine_cache", s_fine_cache, (C,))
    _cuda.require_cuda("s_cond_cache", s_cond_cache, (C,))
    check_element_capacity((Mx // 2) * (Mt // 2), C, chain0)
    lanes, cpb, smem, _ = twolevel_launch(Mt, Mx, C)
    _cuda.check_smem(smem, theta_fine.device,
                     f"the {Mx}x{Mt} two-level fields")
    exact, alphas, log_i0_2beta, sigma_beta = fill_constants(float(beta))
    small_beta = exact and 2.0 * log_i0_2beta <= 1.0
    dev_alphas = _device_alphas(float(beta), theta_fine.device)
    seed1, seed2 = seed_pair(seed)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32,
                           device=theta_fine.device)
    fine_out = torch.empty_like(theta_fine)
    coarse_out = torch.empty_like(theta_coarse)
    sf_out, sq_out = empty(C), empty(C)
    y, acc = empty(n_steps, C), empty(n_steps, C)
    qc, ec = empty(n_steps * t_sub, C), empty(n_steps * t_sub, C)
    lib = _cuda.load_library()
    err = lib.mlmc_schwinger_twolevel(
        theta_fine.data_ptr(), theta_coarse.data_ptr(),
        s_fine_cache.data_ptr(), s_cond_cache.data_ptr(),
        fine_out.data_ptr(), coarse_out.data_ptr(), sf_out.data_ptr(),
        sq_out.data_ptr(), y.data_ptr(), qc.data_ptr(), ec.data_ptr(),
        acc.data_ptr(), dev_alphas.data_ptr(),
        rounds.data_ptr() if rounds is not None else None, len(alphas), C,
        Mx, Mt,
        n_steps, t_sub, n_overrelax_c, n_heatbath_c, k_rej, k_rej_fill,
        k_rej_bessel, int(exact), int(small_beta), float(beta),
        float(beta_c), float(2.0 * log_i0_2beta), float(sigma_beta),
        float(sigma_beta / math.sqrt(2.0)), seed1, seed2, chain0, lanes,
        cpb, smem,
        _cuda.stream_ptr(theta_fine.device))
    _cuda.check_status(err, "schwinger_twolevel kernel launch")
    TWOLEVEL.launches += 1
    return fine_out, coarse_out, sf_out, sq_out, y, qc, ec, acc


def schwinger_twolevel_chain(theta_fine, theta_coarse, s_fine_cache,
                             s_cond_cache, seed, *, beta, beta_c, Mt, Mx,
                             n_steps, t_sub=2, n_overrelax_c=1,
                             n_heatbath_c=1, k_rej=8, k_rej_fill=16,
                             k_rej_bessel=48, chain0=0):
    """``n_steps`` fused two-level MLMC draws in one launch.

    theta_fine: [C, 2*Mt*Mx] fine links; theta_coarse: [C, 2*(Mt/2)*(Mx/2)]
    coarse links; s_fine_cache/s_cond_cache: [C] cached action values of
    theta_fine.  Returns (theta_fine', theta_coarse', s_fine', s_cond',
    Y[n_steps, C], qc[n_steps*t_sub, C], ec[n_steps*t_sub, C],
    accept[n_steps, C]).  Requires both-direction coarsening; beta <= 8
    runs the exact BesselProduct fill, beta > 8 the Gaussian mixture.
    ``k_rej`` bounds the coarse heat-bath rejection (stay on exhaustion);
    ``k_rej_fill``/``k_rej_bessel`` bound the fill (force-reject on
    exhaustion).  ``chain0``: the global index of the first chain (a
    rank's offset under a chain mesh), which the counter RNG hashes."""
    kw = dict(beta=beta, beta_c=beta_c, Mt=Mt, Mx=Mx, n_steps=n_steps,
              t_sub=t_sub, n_overrelax_c=n_overrelax_c,
              n_heatbath_c=n_heatbath_c, k_rej=k_rej, k_rej_fill=k_rej_fill,
              k_rej_bessel=k_rej_bessel, chain0=chain0)
    if _cuda.dispatch_device(theta_fine) == "cpu":
        return schwinger_twolevel_chain_plain(
            theta_fine, theta_coarse, s_fine_cache, s_cond_cache, seed, **kw)
    return _twolevel_cuda(theta_fine, theta_coarse, s_fine_cache,
                          s_cond_cache, seed, **kw)
