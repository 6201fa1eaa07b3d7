"""Special functions and small math helpers (PyTorch port of
``mlmcpathintegral_tpu/utils/special.py``).

Tensor functions (``mod_2pi``, ``i0_scaled``, ``fast_i0_scaled``,
``log_i0``) run on the tensors' own device; host-side functions
(numpy/scipy) implement the once-per-experiment analytic oracles and are
copied unchanged from the JAX package.

Reference parity (formulas re-derived, behaviour matched):
  * mod_2pi                     — src/common/auxilliary.hh:42-52
  * fast_i0_scaled              — src/common/fastbessel.hh:26-50
  * Sigma_hat                   — src/common/auxilliary.cc:7-27
  * Phi_chit / compute_In       — src/common/auxilliary.cc:44-194
  * gff_phi_squared_analytical  — src/common/auxilliary.cc:197-209
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# Tensor helpers
# ---------------------------------------------------------------------------

def mod_2pi(x):
    """Map x to the interval [-pi, pi) (periodic wrap)."""
    return x - TWO_PI * torch.floor(0.5 * (x + math.pi) / math.pi)


def mod_pi(x):
    """Map x to the interval [-pi/2, pi/2) (periodic wrap)."""
    return x - math.pi * torch.floor((x + 0.5 * math.pi) / math.pi)


def i0_scaled(z):
    """exp(-|z|) * I0(z) — scaled modified Bessel function."""
    return torch.special.i0e(z)


def _asymptotic_coeffs(n: int):
    """a_k = ((2k-1)!!)^2 / (8^k k!) of the asymptotic expansion
    I0(z) e^{-z} ~ (2 pi z)^{-1/2} sum_k a_k z^{-k}."""
    coeffs = []
    for k in range(n):
        dfact = 1.0
        for j in range(1, 2 * k, 2):
            dfact *= j
        coeffs.append(dfact * dfact / (8.0**k * math.factorial(k)))
    return coeffs


_FASTBESSEL_COEFFS = tuple(_asymptotic_coeffs(10))
_FASTBESSEL_ZLO = 20.0


def fast_i0_scaled(z):
    """Fast exp(-z) I0(z) for z >= 0: i0e for small z, truncated asymptotic
    series for large z (the reference's fastbessel component)."""
    zi = 1.0 / torch.clamp(z, min=_FASTBESSEL_ZLO)
    series = torch.zeros_like(zi)
    for a_k in reversed(_FASTBESSEL_COEFFS):
        series = series * zi + a_k
    large = series / torch.sqrt(TWO_PI * torch.clamp(z, min=_FASTBESSEL_ZLO))
    return torch.where(z < _FASTBESSEL_ZLO, torch.special.i0e(z), large)


def log_2pi_i0_scaled(z):
    """log(2 pi e^{-z} I0(z)) — the log-normalisation used by the ExpSin2
    distribution family."""
    return math.log(TWO_PI) + torch.log(fast_i0_scaled(z))


def log_i0(z):
    """log I0(z), stable for large z: log(i0e(z)) + |z|."""
    return torch.log(torch.special.i0e(z)) + torch.abs(z)


# ---------------------------------------------------------------------------
# Host-side analytics (numpy / scipy) — once-per-experiment oracles
# ---------------------------------------------------------------------------

def log_factorial(n: int) -> float:
    return float(math.lgamma(n + 1))


def log_nCk(n: int, k: int) -> float:
    return log_factorial(n) - log_factorial(k) - log_factorial(n - k)


def Sigma_hat(xi: float, p: int, mmax: int = 100) -> float:
    """Theta-function ratio sum_m m^p e^{-xi m^2/2} / sum_m e^{-xi m^2/2}."""
    if p % 2 == 1:
        return 0.0
    if p == 0:
        return 1.0
    m = np.arange(1, mmax)
    expf = np.exp(-0.5 * xi * m * m)
    num = 2.0 * np.sum(m**p * expf)
    denom = 1.0 + 2.0 * np.sum(expf)
    return float(num / denom)


@lru_cache(maxsize=64)
def compute_In(x: float, nmax: int = 20):
    """Scaled Bessel-type integrals for the analytic Schwinger susceptibility.

    Returns (In, dIn, ddIn) with
      In[n]   = e^{-x} I_n(x)
      dIn[n]  = -1/(4 pi^2) \\int_{-pi}^{pi} phi e^{x(cos(phi)-1)} sin(n phi) dphi
      ddIn[n] =  1/(8 pi^3) \\int_{-pi}^{pi} phi^2 e^{x(cos(phi)-1)} cos(n phi) dphi
    """
    from scipy import integrate
    from scipy import special as ssp

    In = np.empty(nmax)
    dIn = np.empty(nmax)
    ddIn = np.empty(nmax)
    for n in range(nmax):
        In[n] = ssp.ive(n, x)
        if n == 0:
            dIn[n] = 0.0   # sin(0 * phi) == 0 identically
        else:
            dIn[n], _ = integrate.quad(
                lambda phi: -1.0 / (4.0 * math.pi**2) * phi
                * math.exp(x * (math.cos(phi) - 1.0)),
                -math.pi, math.pi, weight="sin", wvar=n,
                epsabs=1e-15, epsrel=1e-12, limit=512,
            )
        if n == 0:
            # QUADPACK's oscillatory rule with wvar=0 loses the sharply
            # peaked integrand at large x: plain adaptive rule with a
            # breakpoint at the peak
            ddIn[n], _ = integrate.quad(
                lambda phi: 1.0 / (8.0 * math.pi**3) * phi * phi
                * math.exp(x * (math.cos(phi) - 1.0)),
                -math.pi, math.pi, points=[0.0],
                epsabs=1e-15, epsrel=1e-12, limit=512,
            )
        else:
            ddIn[n], _ = integrate.quad(
                lambda phi: 1.0 / (8.0 * math.pi**3) * phi * phi
                * math.exp(x * (math.cos(phi) - 1.0)),
                -math.pi, math.pi, weight="cos", wvar=n,
                epsabs=1e-15, epsrel=1e-12, limit=512,
            )
    return In, dIn, ddIn


def Phi_chit(beta: float, n_plaq: int) -> float:
    """Analytic (finite-volume, finite-a) topological-susceptibility function
    for the compact U(1) family: chi_t * V = (P/beta) Phi_chit(beta, P)."""
    if beta > 2000.0:
        raise ValueError("Phi_chit unstable for beta>2000")
    nmax = 20
    In, dIn, ddIn = compute_In(float(beta), nmax)
    duplicity = np.where(np.arange(nmax) > 0, 2.0, 1.0)
    rho = In / In[0]
    weight = duplicity * rho**n_plaq
    weight /= weight.sum()
    phi_chit = np.sum(
        beta * weight * (ddIn / In - (n_plaq - 1) * (dIn / In) ** 2)
    )
    return float(phi_chit)


def Phi_chit_perturbative(beta: float, n_plaq: int) -> float:
    """Semiclassical expansion of Phi_chit, valid for large beta."""
    xi = n_plaq / beta
    z = 1.0 / beta
    S2 = Sigma_hat(xi, 2)
    S4 = Sigma_hat(xi, 4)
    phi_lo = 1.0 - xi * S2
    phi_nlo = 0.5 - xi * S2 + 0.25 * xi * xi * (S4 - S2 * S2)
    return (phi_lo + z * phi_nlo) / (4.0 * math.pi**2)


def gff_phi_squared_analytical(mass: float, Mt_lat: int, Mx_lat: int) -> float:
    """Spectral sum for <phi^2> of the 2-D Gaussian free field."""
    mu2 = mass * mass / (Mt_lat * Mx_lat)
    k1 = np.sin(math.pi * np.arange(Mt_lat) / Mt_lat) ** 2
    k2 = np.sin(math.pi * np.arange(Mx_lat) / Mx_lat) ** 2
    denom = 4.0 * (k1[:, None] + k2[None, :]) + mu2
    return float(np.sum(1.0 / denom) / (Mt_lat * Mx_lat))
