"""Plain reference of the two fused Schwinger kernels that the benchmark's
window drives: the sweep chain (K3, the coarsest level) and the two-level
chain (K4, every finer level).

A frozen copy of the port's plain versions (``ops/rng.py``,
``ops/schwinger.py``, ``ops/schwinger_twolevel.py``) in plain PyTorch, so
that the yardstick does not move when the program does.  It imports
nothing of the program.  For equal inputs and seeds it draws the kernels'
counter-RNG words (the same hash of seed, site, chain, step and draw
counter) and runs the same truncated rejection loops, so it follows a
kernel's chains one by one until a float rounding flip sends a chain
elsewhere.  It runs in any float dtype: float64 as the reference, a
lower precision as the control.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

TWO_PI = 2.0 * math.pi
PI = math.pi
FOURPI2_INV = 1.0 / (4.0 * math.pi * math.pi)
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Counter-based RNG (two lanes, murmur3 finaliser), as the kernels hash it
# ---------------------------------------------------------------------------

def _mul32(h, c: int):
    """(h * c) mod 2^32 for an int64 tensor h in [0, 2^32) and a uint32
    constant c, without leaving the int64 range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & M32


def fmix32(h):
    """murmur3 32-bit finalizer (full avalanche) on int64 tensors holding
    uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def seed_pair(seed):
    """(seed1, seed2) as Python ints in [0, 2^32) from an int, an
    int32[1] or int32[2] tensor or a pair; a single word gets seed2 = 0
    (``pallas_schwinger._seed_pair``)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(-1).tolist()
    elif isinstance(seed, int):
        seed = [seed]
    seed = [int(s) for s in seed]
    if len(seed) == 1:
        seed = seed + [0]
    if len(seed) != 2:
        raise ValueError(f"seed must hold one or two words, got {seed}")
    return seed[0] & M32, seed[1] & M32

def element_ids(site_shape, n_chains: int, device, chain0: int = 0):
    """(site_id, chain_id) int64 tensors: site_id of shape ``site_shape``
    enumerates the site axes in row-major order, chain_id of shape
    [n_chains, 1, ..., 1] is the global chain index chain0 + local.  They
    broadcast to [n_chains, *site_shape], the chain-first layout of the
    plain kernels (the Pallas kernels put chains last; the ids are the
    same)."""
    n_sites = math.prod(site_shape)
    site = torch.arange(n_sites, dtype=torch.int64,
                        device=device).reshape(site_shape)
    chain = torch.arange(chain0, chain0 + n_chains, dtype=torch.int64,
                         device=device)
    return site, chain.reshape(n_chains, *([1] * len(site_shape)))


def _as_u32(v, like):
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & M32
    return torch.as_tensor(int(v) & M32, dtype=torch.int64,
                           device=like.device)


class CounterRng:
    """Per-element two-lane counter RNG (see module docstring).

    ``site``/``chain``: broadcastable int64 id tensors (see
    :func:`element_ids`).  ``seed``/``seed2``: uint32 words.  ``step``
    folds a per-step index into the site lane.  ``ctr`` is the draw
    counter: each word advances it by one, and the first word drawn is
    ``ctr = 1``, as in the JAX class.  ``n=k`` draws k consecutive words
    at once, stacked on a new leading axis."""

    def __init__(self, seed, site, chain, seed2=None, step=None):
        site = site.to(torch.int64)
        base_s = fmix32(_mul32(site, 0x9E3779B9) ^ _as_u32(seed, site))
        if step is not None:
            step_h = (_mul32(step.to(torch.int64), 0x165667B1)
                      if isinstance(step, torch.Tensor)
                      else (int(step) * 0x165667B1) & M32)
            base_s = fmix32((base_s + step_h) & M32)
        base_c = _mul32(chain.to(torch.int64), 0x85EBCA77)
        if seed2 is not None:
            base_c = base_c ^ _as_u32(seed2, base_c)
        self.base_s = base_s
        self.base_c = fmix32(base_c)
        self.ctr = 0

    def at(self, index) -> "CounterRng":
        """A view restricted to the sites ``base_s[index]`` (same chain
        lane, same counter): the draws of those sites, bit for bit."""
        out = object.__new__(CounterRng)
        out.base_s = self.base_s[index]
        out.base_c = self.base_c
        out.ctr = self.ctr
        return out

    def skip(self, n: int) -> None:
        """Advance the counter past ``n`` words without drawing them."""
        self.ctr += n

    def bits(self, n=None):
        """uint32 words as int64; shape [*ids] or [n, *ids]."""
        if n is None:
            self.ctr += 1
            c = self.ctr
            hs = (self.base_s + ((c * 0xC2B2AE3D) & M32)) & M32
            hc = (self.base_c + ((c * 0x27D4EB2F) & M32)) & M32
        else:
            c = torch.arange(self.ctr + 1, self.ctr + n + 1,
                             dtype=torch.int64, device=self.base_s.device)
            self.ctr += n
            lead = (n,) + (1,) * max(self.base_s.dim(), self.base_c.dim())
            c = c.reshape(lead)
            hs = (self.base_s + _mul32(c, 0xC2B2AE3D)) & M32
            hc = (self.base_c + _mul32(c, 0x27D4EB2F)) & M32
        return fmix32((fmix32(hs) + fmix32(hc)) & M32)

    def uniform(self, dtype, n=None):
        """(0, 1] uniforms: a float in [1, 2) built from the exponent bits
        in float32, mapped to (0, 1], then cast to ``dtype``."""
        fbits = (self.bits(n) >> 9) | 0x3F800000
        f = fbits.to(torch.int32).view(torch.float32)
        return (2.0 - f).to(dtype)

    def normal(self, dtype):
        """Standard normals via Box-Muller (two words)."""
        u1 = self.uniform(dtype)
        u2 = self.uniform(dtype)
        return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


# ---------------------------------------------------------------------------
# Sweep chain (K3): overrelaxation + ExpCos heat bath in 4 link groups
# ---------------------------------------------------------------------------

def _mod_2pi(x):
    """[-pi, pi) wrap (utils.special.mod_2pi)."""
    return x - TWO_PI * torch.floor(0.5 * (x + PI) / PI)


def _sh(A, di, dj):
    """A(i+di, j+dj) for A of shape [C, Mx, Mt] (dim 1 = j, dim 2 = i)."""
    out = A
    if di:
        out = torch.roll(out, -di, dims=2)
    if dj:
        out = torch.roll(out, -dj, dims=1)
    return out


def _staples(T, X, mu):
    """(theta_p, theta_m) for direction mu (quenchedschwingeraction.cc:
    25-44)."""
    if mu == 0:
        tp = _mod_2pi(_sh(T, 0, 1) + X - _sh(X, 1, 0))
        tm = _mod_2pi(_sh(T, 0, -1) + _sh(X, 1, -1) - _sh(X, 0, -1))
    else:
        tp = _mod_2pi(T + _sh(X, 1, 0) - _sh(T, 0, 1))
        tm = _mod_2pi(_sh(T, -1, 1) + _sh(X, -1, 0) - _sh(T, -1, 0))
    return tp, tm


def _first_accepted(prop, ok):
    """(x, accepted): the proposal of the first accepted round (rounds on
    dim 0) — the sequential rejection loop evaluated for all rounds at
    once; lanes with no accepted round get 0."""
    acc = ok.any(dim=0)
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
    x = torch.gather(prop, 0, first)[0]
    return torch.where(acc, x, torch.zeros_like(x)), acc


def _expcos_rejection(rng, tau, k_rej, dtype):
    """Centred x ~ exp(tau cos x) on [-pi, pi) by mixed-envelope rejection
    (uniform proposals for tau < 0.45, a tight Gaussian otherwise), 3 words
    per round: u1 (radius), u2 (uniform proposal / Box-Muller angle), u
    (accept).  Returns (x, accepted)."""
    w = rng.uniform(dtype, n=3 * k_rej)
    w = w.reshape(k_rej, 3, *w.shape[1:])
    u1, u2, u = w[:, 0], w[:, 1], w[:, 2]
    use_uni = tau < 0.45
    sigma = 0.5 * PI / torch.sqrt(torch.clamp(tau, min=1e-12))
    prop_u = PI * (2.0 * u2 - 1.0)
    prop_g = sigma * (torch.sqrt(-2.0 * torch.log(u1))
                      * torch.cos(TWO_PI * u2))
    prop = torch.where(use_uni, prop_u, prop_g)
    log_ratio = tau * (torch.cos(prop) - 1.0) + torch.where(
        use_uni, 0.0, 2.0 * tau * prop * prop / (PI * PI))
    ok = (-PI <= prop) & (prop < PI) & (torch.log(u) <= log_ratio)
    return _first_accepted(prop, ok)


def _expcos_shift(tp, tm, beta):
    """(tau, shift) of the ExpCos draw given the two staples."""
    dx = tm - tp
    tau = 2.0 * beta * torch.abs(torch.cos(0.5 * dx))
    shift = 0.5 * (tp + tm) + torch.where(
        torch.abs(dx) > PI, dx.new_tensor(PI), dx.new_tensor(0.0))
    return tau, shift


def _expcos_draw(rng, cur, tp, tm, beta, k_rej, dtype):
    """Heat-bath draw from p(x) ~ exp[beta(cos(x-tp)+cos(x-tm))]; lanes
    that never accept keep ``cur``."""
    tau, shift = _expcos_shift(tp, tm, beta)
    x, acc = _expcos_rejection(rng, tau, k_rej, dtype)
    return torch.where(acc, _mod_2pi(x + shift), cur)


_GROUPS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _group_sel(mu, parity):
    """Selector of one (mu, parity) group on the [..., Mx, Mt] grid:
    temporal links by j parity, spatial links by i parity."""
    if mu == 0:
        return (Ellipsis, slice(parity, None, 2), slice(None))
    return (Ellipsis, slice(None), slice(parity, None, 2))


def _one_step(T, X, rng, *, beta, n_overrelax, n_heatbath, k_rej, dtype):
    """One full draw on [C, Mx, Mt] fields: n_overrelax + n_heatbath
    coloured sweeps.  Each heat-bath group takes 3 k_rej words from the
    stream; only the group's own sites are drawn (their words are the
    same ones the Pallas kernel draws for them)."""
    for _ in range(n_overrelax):
        for mu, parity in _GROUPS:
            tp, tm = _staples(T, X, mu)
            sel = _group_sel(mu, parity)
            L = (T if mu == 0 else X).clone()
            L[sel] = _mod_2pi(tp[sel] + tm[sel] - L[sel])
            T, X = (L, X) if mu == 0 else (T, L)
    for _ in range(n_heatbath):
        for mu, parity in _GROUPS:
            tp, tm = _staples(T, X, mu)
            sel = _group_sel(mu, parity)
            L = (T if mu == 0 else X).clone()
            L[sel] = _expcos_draw(rng.at(sel), L[sel], tp[sel], tm[sel],
                                  beta, k_rej, dtype)
            rng.skip(3 * k_rej)
            T, X = (L, X) if mu == 0 else (T, L)
    return T, X


def _plaquettes(T, X):
    return _mod_2pi(T + _sh(X, 1, 0) - _sh(T, 0, 1) - X)


def sweep_chain(theta, seed, *, beta, Mt, Mx, n_steps, n_overrelax=1,
                n_heatbath=1, k_rej=6, with_energy=False, step_offset=0,
                chain0=0):
    """``n_steps`` sweep-chain draws (K3) on [C, Mx*Mt*2] links: returns
    (theta', qsum[n_steps, C], esum[n_steps, C] or None).  ``chain0``:
    the global index of theta's first chain, which the RNG hashes."""
    C = theta.shape[0]
    seed1, seed2 = seed_pair(seed)
    g = theta.reshape(C, Mx, Mt, 2)
    T, X = g[..., 0], g[..., 1]
    site, chain = element_ids((Mx, Mt), C, theta.device, chain0)
    qs, es = [], []
    for s in range(n_steps):
        rng = CounterRng(seed1, site, chain, seed2, step=step_offset + s)
        T, X = _one_step(T, X, rng, beta=beta, n_overrelax=n_overrelax,
                         n_heatbath=n_heatbath, k_rej=k_rej,
                         dtype=theta.dtype)
        plaq = _plaquettes(T, X)
        qs.append(torch.sum(plaq, dim=(1, 2)))
        if with_energy:
            es.append(torch.sum(torch.cos(plaq), dim=(1, 2)))
    out = torch.stack([T, X], dim=-1).reshape(C, 2 * Mx * Mt)
    qsum = (torch.stack(qs) if qs
            else theta.new_zeros((0, C)))
    esum = torch.stack(es) if with_energy and es else (
        theta.new_zeros((0, C)) if with_energy else None)
    return out, qsum, esum



# ---------------------------------------------------------------------------
# Two-level chain (K4)
# ---------------------------------------------------------------------------

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

def _expcos_fill_draw(rng, tp, tm, beta, k_rej, dtype):
    """ExpCos rejection draw without fallback: (x, ok); lanes with
    ok=False carry no valid sample and force-reject the move."""
    tau, shift = _expcos_shift(tp, tm, beta)
    x, acc = _expcos_rejection(rng, tau, k_rej, dtype)
    return _mod_2pi(x + shift), acc


def _bessel_draw(rng, x_p, x_m, beta, log_i0_2beta, sigma_beta, k_rej,
                 dtype):
    """BesselProduct two-piece Gaussian-envelope rejection draw, truncated
    at k_rej rounds (4 words a round; 2 in the flat small-beta regime);
    returns (x, ok)."""
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
                    k_rej_bessel, dtype, exact=True):
    """Trial fine state: prolongate the coarse links + 3-step fill.
    Returns (components, fill_ok[C])."""
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
                                         k_rej_bessel, dtype)
    else:
        theta_tilde, ok_b = _approx_bessel_draw(rng, theta_p, theta_m,
                                                beta, dtype)
    u = PI * (2.0 * rng.uniform(dtype) - 1.0)
    X01 = _mod_2pi(0.5 * theta_tilde + u)
    X11 = _mod_2pi(0.5 * theta_tilde - u)

    # STEP 3: interior horizontal links (odd-j rows) from ExpCos
    tp_e = _mod_2pi(T00 + X01 - X00)
    tm_e = _mod_2pi(X10 + sh(T00, 1, 0) - X11)
    T10, ok_e = _expcos_fill_draw(rng, tp_e, tm_e, beta, k_rej, dtype)
    tp_o = _mod_2pi(T01 + sh(X00, 0, 1) - X01)
    tm_o = _mod_2pi(X11 + sh(T01, 1, 0) - sh(X10, 0, 1))
    T11, ok_o = _expcos_fill_draw(rng, tp_o, tm_o, beta, k_rej, dtype)

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

def _alpha_coefficients(beta: float, kmax: int = 16, nmax: int = 32):
    """Fourier-cosine coefficients of the BesselProduct normalisation
    Z(Phi) (besselproductdistribution.hh:60-79): alpha_0 absolute,
    alpha_{k>0} rescaled by alpha_0."""
    def log_fact(n):
        return math.lgamma(n + 1)

    def log_nck(n, k):
        return log_fact(n) - log_fact(k) - log_fact(n - k)

    alphas = []
    alpha0 = None
    for k in range(kmax + 1):
        s = 0.0
        for n in range(k, nmax + 1):
            for m in range(k, nmax + 1):
                log_comb = (log_nck(2 * n, n - k) + log_nck(2 * m, m - k)
                            - 2.0 * (log_fact(n) + log_fact(m)))
                s += (0.5 * beta) ** (2 * (n + m)) * math.exp(log_comb)
        alpha = (2.0 if k == 0 else 4.0) * math.pi * s
        if k == 0:
            alpha0 = alpha
        else:
            alpha /= alpha0
        alphas.append(alpha)
    return alphas


@functools.lru_cache(maxsize=32)
def fill_constants(beta: float):
    """(exact, alphas, log I0(2 beta), sigma_beta) of the fill at beta:
    the exact BesselProduct branch for beta <= 8, else the large-beta
    mixture (quenchedschwingerconditionedfineaction.hh:37-44)."""
    from scipy import special as ssp
    exact = float(beta) <= 8.0
    if not exact:
        return False, (), 0.0, 1.0
    log_i0_2beta = float(np.log(ssp.i0e(2 * beta)) + 2 * beta)
    return (True, tuple(_alpha_coefficients(float(beta))[1:]), log_i0_2beta,
            math.pi / math.sqrt(2.0 * log_i0_2beta))


def twolevel_chain(theta_fine, theta_coarse, s_fine_cache, s_cond_cache,
                   seed, *, beta, beta_c, Mt, Mx, n_steps, t_sub=2,
                   n_overrelax_c=1, n_heatbath_c=1, k_rej=8, k_rej_fill=16,
                   k_rej_bessel=48, chain0=0):
    """``n_steps`` two-level draws (K4): per step t_sub coarse sweeps, the
    prolongation and conditioned fill, the Metropolis accept.  Returns
    (theta_fine', theta_coarse', S_fine', S_cond', Y[n_steps, C],
    qc[n_steps*t_sub, C], ec[n_steps*t_sub, C], accept[n_steps, C])."""
    exact, alphas, log_i0_2beta, sigma_beta = fill_constants(float(beta))
    dtype = theta_fine.dtype
    C = theta_fine.shape[0]
    Mtc, Mxc = Mt // 2, Mx // 2
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
                               dtype=dtype)
            P = coarse_plaquettes(Tc, Xc)
            qcs.append(torch.sum(_mod_2pi(P), dim=(-2, -1)))
            ecs.append(torch.sum(torch.cos(P), dim=(-2, -1)))
        rng = CounterRng(seed1, site, chain, seed2, step=base + t_sub)
        trial, fill_ok = prolongate_fill(
            rng, Tc, Xc, beta, log_i0_2beta, sigma_beta, k_rej_fill,
            k_rej_bessel, dtype, exact=exact)
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

