"""ExpSin2 distribution: p(x) = Z^-1 exp(-sigma sin^2(x/2)), x in [-pi, pi]
(PyTorch port of ``mlmcpathintegral_tpu/distributions/expsin2.py``;
reference src/distribution/expsin2distribution.{hh,cc}).

Normalisation Z = 2 pi e^{-sigma/2} I0(sigma/2).  Sampling is rejection
with a Gaussian envelope, batched over lanes.  Used by the rotor heat bath
(src/action/qm/rotoraction.cc:20-37).
"""

from __future__ import annotations

import math

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import (
    batched_rejection_sample_mask, normal, uniform,
)
from mlmcpathintegral_tpu_torch.utils.special import fast_i0_scaled

TWO_PI = 2.0 * math.pi


class ExpSin2Distribution:
    """Batched draw/evaluate; ``sigma`` a tensor (per-lane parameters)."""

    @staticmethod
    def draw(generator, sigma, fallback=None, max_iter: int = 100):
        """Samples of ``sigma``'s shape.  With ``fallback`` the rejection
        loop is truncated at ``max_iter`` rounds and unaccepted lanes
        return ``fallback`` — exact only for MCMC heat-bath use."""
        shape, dtype, device = sigma.shape, sigma.dtype, sigma.device
        width = math.pi / torch.sqrt(2.0 * sigma)

        def propose_accept(g):
            r = width * normal(g, shape, dtype, device)
            u = uniform(g, shape, dtype, device)
            sin_half = torch.sin(0.5 * r)
            log_ratio = -sigma * (sin_half * sin_half
                                  - (r * r) / (math.pi * math.pi))
            ok = (torch.abs(r) < math.pi) & (torch.log(u) < log_ratio)
            return r, ok

        x, acc = batched_rejection_sample_mask(generator, propose_accept,
                                               max_iter)
        if fallback is not None:
            x = torch.where(acc, x, fallback)
        return x

    @staticmethod
    def evaluate(x, sigma):
        """p(x; sigma), elementwise."""
        return torch.exp(ExpSin2Distribution.log_evaluate(x, sigma))

    @staticmethod
    def log_evaluate(x, sigma):
        """log p = -sigma sin^2(x/2) - log(2 pi I0e(sigma/2)), stable for
        large sigma."""
        sin_half = torch.sin(0.5 * x)
        log_Z = math.log(TWO_PI) + torch.log(fast_i0_scaled(0.5 * sigma))
        return -sigma * sin_half * sin_half - log_Z
