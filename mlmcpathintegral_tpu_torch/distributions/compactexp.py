"""CompactExp distribution: p(x) = sigma e^{sigma x} / (2 sinh sigma) on
[-1, 1], drawn by exact inverse CDF (PyTorch port of
``mlmcpathintegral_tpu/distributions/compactexp.py``; reference
src/distribution/compactexpdistribution.{hh,cc}).  The O(3) sigma model's
heat bath draws the spin's projection onto its neighbour sum from it
(nonlinearsigmaaction.cc:60).

The inverse transform x = sigma^-1 log[u e^sigma + (1-u) e^-sigma] is
written x = 1 + sigma^-1 log[u + (1-u) e^{-2 sigma}], stable at large
sigma.  ``transform`` maps given uniforms, so a test can hand over the
JAX package's; ``draw`` takes them from a ``torch.Generator``.
"""

from __future__ import annotations

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import uniform


class CompactExpDistribution:

    @staticmethod
    def transform(u, sigma):
        """The inverse CDF at uniforms ``u`` (broadcast with ``sigma``)."""
        return 1.0 + torch.log(u + (1.0 - u) * torch.exp(-2.0 * sigma)) \
            / sigma

    @staticmethod
    def draw(generator, sigma):
        """One draw per entry of the tensor ``sigma``."""
        u = uniform(generator, sigma.shape, sigma.dtype, sigma.device)
        return CompactExpDistribution.transform(u, sigma)

    @staticmethod
    def log_evaluate(x, sigma):
        """log p(x; sigma) = log sigma + sigma x - log(2 sinh sigma),
        stable at large sigma through 2 sinh(s) = e^s (1 - e^{-2s})."""
        sigma = torch.as_tensor(sigma, dtype=x.dtype, device=x.device)
        return (torch.log(sigma) + sigma * x - sigma
                - torch.log1p(-torch.exp(-2.0 * sigma)))

    @staticmethod
    def evaluate(x, sigma):
        return torch.exp(CompactExpDistribution.log_evaluate(x, sigma))
