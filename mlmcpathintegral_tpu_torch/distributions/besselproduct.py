"""BesselProduct distribution:
p(x | x_p, x_m) = Z^-1 I0(2 beta cos((x-x_p)/2)) I0(2 beta cos((x-x_m)/2))
(PyTorch port of ``mlmcpathintegral_tpu/distributions/besselproduct.py``;
reference src/distribution/besselproductdistribution.{hh,cc}).

The marginal of the sum of the two fine vertical links inside a coarse
Schwinger cell; valid for beta <= 8.  Sampling is rejection with a
two-piece Gaussian envelope whose side is chosen with probability ~ C_s
(its envelope height) only — the in-interval check already pays each
piece's mass.  The normalisation 1/Z(Phi) is a Fourier-cosine series in
Phi = x_p - x_m with coefficients ``alphaZ`` computed once per beta in
numpy (they are constants of the action, as in the JAX package).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy import special as ssp

from mlmcpathintegral_tpu_torch.distributions.rejection import (
    batched_rejection_sample, normal, uniform,
)
from mlmcpathintegral_tpu_torch.utils.special import (
    log_factorial, log_i0, log_nCk, mod_2pi,
)

TWO_PI = 2.0 * math.pi


def _alpha_coefficients(beta: float, kmax: int = 16, nmax: int = 32):
    """Fourier-cosine coefficients of Z(Phi)
    (besselproductdistribution.hh:60-79): alpha_0 absolute, alpha_{k>0}
    rescaled by alpha_0."""
    alphas = []
    alpha0 = None
    for k in range(kmax + 1):
        s = 0.0
        for n in range(k, nmax + 1):
            for m in range(k, nmax + 1):
                log_comb = (log_nCk(2 * n, n - k) + log_nCk(2 * m, m - k)
                            - 2.0 * (log_factorial(n) + log_factorial(m)))
                s += (0.5 * beta) ** (2 * (n + m)) * math.exp(log_comb)
        alpha = (2.0 if k == 0 else 4.0) * math.pi * s
        if k == 0:
            alpha0 = alpha
        else:
            alpha /= alpha0
        alphas.append(alpha)
    return np.asarray(alphas)


class BesselProductDistribution:

    def __init__(self, beta: float, kmax: int = 16, nmax: int = 32):
        if beta > 8.0:
            raise ValueError("BesselProductDistribution requires beta <= 8 "
                             "(besselproductdistribution.hh:55-58)")
        self.beta = float(beta)
        self.kmax = kmax
        self.alphaZ = _alpha_coefficients(beta, kmax, nmax)
        self.log_I0_twobeta = float(np.log(ssp.i0e(2 * beta)) + 2 * beta)
        self.sigma_beta = math.pi / math.sqrt(2.0 * self.log_I0_twobeta)

    # -- normalisation ---------------------------------------------------------

    def log_Znorm_inv(self, phi, rescaled: bool = True):
        """log(1/Z(phi)); rescaled drops the alpha_0 factor (cancels in
        two-level differences) — besselproductdistribution.cc:16-27."""
        k = torch.arange(1, self.kmax + 1, dtype=phi.dtype, device=phi.device)
        alphas = torch.as_tensor(self.alphaZ[1:], dtype=phi.dtype,
                                 device=phi.device)
        s = 1.0 + torch.sum(alphas * torch.cos(k * phi[..., None]), dim=-1)
        log_s = torch.log(s)
        if not rescaled:
            log_s = log_s + math.log(self.alphaZ[0])
        return -log_s

    def log_evaluate(self, x, x_p, x_m):
        """log p(x | x_p, x_m) with the exact series normalisation;
        ``x_p``, ``x_m``: tensors or numbers, broadcast with ``x``."""
        x_p = torch.as_tensor(x_p, dtype=x.dtype, device=x.device)
        x_m = torch.as_tensor(x_m, dtype=x.dtype, device=x.device)
        lp = log_i0(2.0 * self.beta * torch.cos(0.5 * (x - x_p)))
        lm = log_i0(2.0 * self.beta * torch.cos(0.5 * (x - x_m)))
        return self.log_Znorm_inv(x_p - x_m, rescaled=False) + lp + lm

    def evaluate(self, x, x_p, x_m):
        """p(x | x_p, x_m), elementwise."""
        return torch.exp(self.log_evaluate(x, x_p, x_m))

    # -- sampling --------------------------------------------------------------

    def draw(self, generator, x_p, x_m):
        x_p, x_m = torch.broadcast_tensors(x_p, x_m)
        shape, dtype, device = x_p.shape, x_p.dtype, x_p.device
        pi = math.pi
        beta = self.beta
        sb = self.sigma_beta
        logI0 = self.log_I0_twobeta

        dx0 = x_m - x_p
        sign = torch.where(dx0 < 0, dx0.new_tensor(-1.0), dx0.new_tensor(1.0))
        dx = torch.abs(dx0)

        # envelope piece constants (besselproductdistribution.hh:100-115)
        log_C_p = 2.0 * logI0 * (1.0 - dx * dx / (4.0 * pi * pi))
        log_C_m = 2.0 * logI0 * (1.0 - (dx - TWO_PI) ** 2 / (4.0 * pi * pi))
        p_right = 1.0 / (1.0 + torch.exp(log_C_m - log_C_p))
        sigma = sb / math.sqrt(2.0)

        if 2.0 * logI0 <= 1.0:
            # small beta: nearly flat density — uniform envelope with the
            # global bound p~(x) <= I0(2 beta)^2
            def propose_accept(g):
                x = pi * (2.0 * uniform(g, shape, dtype, device) - 1.0)
                log_rho = (log_i0(2.0 * beta * torch.cos(0.5 * x))
                           + log_i0(2.0 * beta * torch.cos(0.5 * (x - dx)))
                           - 2.0 * logI0)
                xi = uniform(g, shape, dtype, device)
                return x, torch.log(xi) <= log_rho
        else:
            def propose_accept(g):
                right = uniform(g, shape, dtype, device) < p_right
                mu = torch.where(right, 0.5 * dx, 0.5 * dx - pi)
                a_min = torch.where(right, -pi + dx, torch.full_like(dx, -pi))
                a_max = torch.where(right, torch.full_like(dx, pi), -pi + dx)
                log_C = torch.where(right, log_C_p, log_C_m)
                x = mu + sigma * normal(g, shape, dtype, device)
                in_interval = (x >= a_min) & (x < a_max)
                u = (x - mu) / sb
                log_rho = (log_i0(2.0 * beta * torch.cos(0.5 * x))
                           + log_i0(2.0 * beta * torch.cos(0.5 * (x - dx)))
                           - log_C + u * u)
                xi = uniform(g, shape, dtype, device)
                ok = in_interval & (torch.log(xi) <= log_rho)
                return x, ok

        x = batched_rejection_sample(generator, propose_accept, max_iter=500)
        return mod_2pi(sign * x + x_p)
