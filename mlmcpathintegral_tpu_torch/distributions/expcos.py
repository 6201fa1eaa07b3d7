"""ExpCos distribution: p(x | x_p, x_m) = Z^-1 exp[beta(cos(x-x_p) +
cos(x-x_m))] on [-pi, pi), Z = 2 pi I0(2 beta |cos((x_p-x_m)/2)|)
(PyTorch port of ``mlmcpathintegral_tpu/distributions/expcos.py``;
reference src/distribution/expcosdistribution.{hh,cc}).

cos(x-x_p)+cos(x-x_m) = 2 cos(dx/2) cos(x - (x_p+x_m)/2) reduces sampling
to a centred ExpCos with tau = 2 beta |cos(dx/2)|, drawn by rejection and
shifted back.
"""

from __future__ import annotations

import math

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import (
    batched_rejection_sample_mask, normal, uniform,
)
from mlmcpathintegral_tpu_torch.utils.special import fast_i0_scaled, mod_2pi

TWO_PI = 2.0 * math.pi


class ExpCosDistribution:
    """Batched draw/evaluate; ``beta`` scalar, ``x_p``/``x_m`` tensors."""

    @staticmethod
    def draw(generator, beta, x_p, x_m, fallback=None, max_iter=100):
        """Rejection draw.  With ``fallback`` (current values in the output
        frame) the loop is truncated at ``max_iter`` rounds and unaccepted
        lanes return ``fallback`` — exact for MCMC heat-bath use, NOT for
        density-matched fill-ins, which must omit ``fallback``."""
        x_p, x_m = torch.broadcast_tensors(x_p, x_m)
        shape, dtype, device = x_p.shape, x_p.dtype, x_p.device
        pi = math.pi
        dx = x_m - x_p
        tau = 2.0 * beta * torch.abs(torch.cos(0.5 * dx))
        # mixed envelope: uniform proposals for small tau, TIGHT Gaussian
        # (sigma^2 = pi^2/(4 tau); cos x - 1 + 2 x^2/pi^2 <= 0 on [-pi, pi])
        # otherwise — per-round acceptance >= 0.64 for all tau
        use_uni = tau < 0.45
        sigma = 0.5 * pi / torch.sqrt(torch.clamp(tau, min=1e-12))

        def propose_accept(g):
            x_u = uniform(g, shape, dtype, device, -pi, pi)
            x_g = sigma * normal(g, shape, dtype, device)
            x = torch.where(use_uni, x_u, x_g)
            u = uniform(g, shape, dtype, device)
            log_ratio = tau * (torch.cos(x) - 1.0) + torch.where(
                use_uni, 0.0, 2.0 * tau * x * x / (pi ** 2))
            ok = (-pi <= x) & (x < pi) & (torch.log(u) <= log_ratio)
            return x, ok

        x, acc = batched_rejection_sample_mask(generator, propose_accept,
                                               max_iter)
        shift = 0.5 * (x_p + x_m) + torch.where(
            torch.abs(dx) > pi, dx.new_tensor(pi), dx.new_tensor(0.0))
        out = mod_2pi(x + shift)
        if fallback is not None:
            out = torch.where(acc, out, fallback)
        return out

    @staticmethod
    def evaluate(x, beta, x_p, x_m):
        """p(x | x_p, x_m), elementwise."""
        return torch.exp(ExpCosDistribution.log_evaluate(x, beta, x_p, x_m))

    @staticmethod
    def log_evaluate(x, beta, x_p, x_m):
        """log p(x | x_p, x_m), stable for large beta:
        log Z = log(2 pi I0e(sigma)) + sigma, sigma = 2 beta |cos(dx/2)|.
        ``x_p``, ``x_m``: tensors or numbers, broadcast with ``x``."""
        x_p = torch.as_tensor(x_p, dtype=x.dtype, device=x.device)
        x_m = torch.as_tensor(x_m, dtype=x.dtype, device=x.device)
        sigma = 2.0 * beta * torch.abs(torch.cos(0.5 * (x_p - x_m)))
        s = beta * (torch.cos(x - x_p) + torch.cos(x - x_m))
        log_Z = math.log(TWO_PI) + torch.log(fast_i0_scaled(sigma)) + sigma
        return s - log_Z
