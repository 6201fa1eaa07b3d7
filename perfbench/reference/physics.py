"""Couplings and analytic values of the quenched Schwinger model, for the
reference: the nonperturbative matching of the coarse coupling across a
both-direction coarsening (quenchedschwingerrenormalisation.cc:7-64) and
the analytic V chi_t (qoi2dsusceptibility.cc:30-34).  A copy of the port's
``utils/special.py`` and ``models/qft/schwinger.py`` arithmetic in numpy
and scipy; it imports nothing of the program.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=64)
def _bessel_integrals(x: float, nmax: int = 20):
    """(In, dIn, ddIn): e^{-x} I_n(x) and the two Fourier integrals of
    e^{x(cos phi - 1)} behind the analytic susceptibility."""
    from scipy import integrate
    from scipy import special as ssp

    In = np.empty(nmax)
    dIn = np.empty(nmax)
    ddIn = np.empty(nmax)
    for n in range(nmax):
        In[n] = ssp.ive(n, x)
        if n == 0:
            dIn[n] = 0.0
        else:
            dIn[n], _ = integrate.quad(
                lambda phi: -1.0 / (4.0 * math.pi**2) * phi
                * math.exp(x * (math.cos(phi) - 1.0)),
                -math.pi, math.pi, weight="sin", wvar=n,
                epsabs=1e-15, epsrel=1e-12, limit=512)
        if n == 0:
            ddIn[n], _ = integrate.quad(
                lambda phi: 1.0 / (8.0 * math.pi**3) * phi * phi
                * math.exp(x * (math.cos(phi) - 1.0)),
                -math.pi, math.pi, points=[0.0],
                epsabs=1e-15, epsrel=1e-12, limit=512)
        else:
            ddIn[n], _ = integrate.quad(
                lambda phi: 1.0 / (8.0 * math.pi**3) * phi * phi
                * math.exp(x * (math.cos(phi) - 1.0)),
                -math.pi, math.pi, weight="cos", wvar=n,
                epsabs=1e-15, epsrel=1e-12, limit=512)
    return In, dIn, ddIn


def chit_analytical(beta: float, n_plaq: int) -> float:
    """V chi_t = (P / beta) Phi_chit(beta, P) on a lattice of P plaquettes."""
    nmax = 20
    In, dIn, ddIn = _bessel_integrals(float(beta), nmax)
    duplicity = np.where(np.arange(nmax) > 0, 2.0, 1.0)
    weight = duplicity * (In / In[0]) ** n_plaq
    weight /= weight.sum()
    phi = np.sum(beta * weight * (ddIn / In - (n_plaq - 1) * (dIn / In) ** 2))
    return n_plaq / beta * float(phi)


def beta_coarse(beta: float, n_plaq: int) -> float:
    """The coarse coupling of a both-direction coarsening with
    nonperturbative matching: V chi_t equal on both levels, found by
    bisection in x = beta_c / beta; the raw 0.25 beta for beta <= 4."""
    from scipy import optimize
    if beta <= 4.0:
        return 0.25 * beta

    def f_root(x):
        return (chit_analytical(x * beta, n_plaq // 4)
                - chit_analytical(beta, n_plaq))

    xs = np.geomspace(0.02, 2.0, 49)
    fs = [f_root(x) for x in xs]
    x = None
    for i in range(len(xs) - 1, 0, -1):
        if fs[i - 1] == 0.0:
            x = xs[i - 1]
            break
        if fs[i - 1] * fs[i] < 0:
            x = optimize.bisect(f_root, xs[i - 1], xs[i], rtol=1e-12,
                                maxiter=100)
            break
    if x is None:
        x = 0.25
    return x * beta


def level_couplings(beta: float, Mt: int, Mx: int, n_level: int):
    """beta of each level of a both-direction hierarchy, finest first."""
    betas = [float(beta)]
    for _ in range(n_level - 1):
        betas.append(beta_coarse(betas[-1], Mt * Mx))
        Mt, Mx = Mt // 2, Mx // 2
    return betas
