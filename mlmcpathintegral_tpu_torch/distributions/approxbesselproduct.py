"""Approximate BesselProduct distribution for large beta (> 8)
(PyTorch port of
``mlmcpathintegral_tpu/distributions/approxbesselproduct.py``; reference
src/distribution/approximatebesselproductdistribution.{hh,cc}).

Gaussian mixture with a main peak at x0/2 (sigma_+^-2 = beta cos(x0/4))
and a secondary peak at x0/2 - pi (sigma_-^-2 = beta sin(x0/4)), weight
N_+ = 1/(1+rho), rho = (s2p/s2m)^{3/2} exp(-4(s2p-s2m)).  ``evaluate``
sums 2 kmax + 1 periodic copies, so draw and evaluate are consistent.
"""

from __future__ import annotations

import math

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import (
    normal, uniform,
)
from mlmcpathintegral_tpu_torch.utils.special import mod_2pi

TWO_PI = 2.0 * math.pi


class ApproximateBesselProductDistribution:

    def __init__(self, beta: float, kmax: int = 4):
        self.beta = float(beta)
        self.kmax = int(kmax)

    def _fold(self, x_p, x_m):
        """Map to x0 in [0, pi] with sign bookkeeping
        (approximatebesselproductdistribution.cc:10-19)."""
        x0 = x_p - x_m
        sign = torch.where(x0 < 0, x0.new_tensor(-1.0), x0.new_tensor(1.0))
        x0 = torch.abs(x0)
        flip = x0 > math.pi
        sign = torch.where(flip, -sign, sign)
        x0 = torch.where(flip, TWO_PI - x0, x0)
        return x0, sign

    def _N_p_sigma2inv(self, x0):
        """(N_p, sigma2_p_inv, sigma2_m_inv)
        (approximatebesselproductdistribution.cc:39-55)."""
        beta = self.beta
        eps = 0.125 * math.pi
        s2p = torch.where(x0 < eps, x0.new_tensor(beta),
                          beta * torch.cos(0.25 * x0))
        s2m_raw = beta * torch.sin(0.25 * x0)
        rho = ((s2p / torch.clamp(s2m_raw, min=1e-300)) ** 1.5
               * torch.exp(-4.0 * (s2p - s2m_raw)))
        N_p = torch.where(x0 < eps, x0.new_tensor(1.0), 1.0 / (1.0 + rho))
        s2m = torch.where(x0 < eps, x0.new_tensor(0.0), s2m_raw)
        return N_p, s2p, s2m

    def draw(self, generator, x_p, x_m):
        x_p, x_m = torch.broadcast_tensors(x_p, x_m)
        shape, dtype, device = x_p.shape, x_p.dtype, x_p.device
        x0, sign = self._fold(x_p, x_m)
        N_p, s2p, s2m = self._N_p_sigma2inv(x0)
        main = uniform(generator, shape, dtype, device) <= N_p
        sigma = torch.where(main, 1.0 / torch.sqrt(s2p),
                            1.0 / torch.sqrt(torch.clamp(s2m, min=1e-300)))
        xshift = torch.where(main, x0.new_tensor(0.0), x0.new_tensor(math.pi))
        x = (sigma * normal(generator, shape, dtype, device) + 0.5 * x0
             - xshift)
        return mod_2pi(sign * x + x_m)

    def log_evaluate(self, x, x_p, x_m):
        return torch.log(torch.clamp(self.evaluate(x, x_p, x_m), min=1e-300))

    def evaluate(self, x, x_p, x_m):
        """Density with 2*kmax+1 periodic copies
        (approximatebesselproductdistribution.cc:7-36)."""
        x0, sign = self._fold(x_p, x_m)
        z = sign * (x - x_m)
        N_p, s2p, s2m = self._N_p_sigma2inv(x0)
        N_m = 1.0 - N_p
        s_p = torch.zeros_like(z)
        s_m = torch.zeros_like(z)
        for k in range(-self.kmax, self.kmax + 1):
            zs = z - 0.5 * x0 + 2.0 * k * math.pi
            s_p = s_p + torch.sqrt(s2p) * torch.exp(-0.5 * s2p * zs * zs)
            zs = zs + math.pi
            s_m = s_m + torch.sqrt(torch.clamp(s2m, min=0.0)) * torch.exp(
                -0.5 * s2m * zs * zs)
        return math.sqrt(0.5 / math.pi) * (N_p * s_p + N_m * s_m)
