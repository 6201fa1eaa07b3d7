"""Batched rejection sampling (PyTorch port of
``mlmcpathintegral_tpu/distributions/rejection.py``).

Every lane proposes and accept/rejects in lockstep; the loop runs until
all lanes have accepted or ``max_iter`` rounds are spent, and accepted
lanes are frozen.  The envelopes in this family are tight (acceptance
>~ 0.5 per round), so the expected number of rounds is a handful.  The
all-accepted test reads one boolean back to the host per round.  It runs
in the set-up phase and, on the unfused multilevel path, on the sampling
path too: in the plain heat-bath mix sweeps of the hybrid cluster sampler
and in the conditioned fill of the batched screen.
"""

from __future__ import annotations

import torch


def uniform(generator: torch.Generator, shape, dtype, device, low=0.0,
            high=1.0):
    """Uniforms on [low, high) drawn by ``generator`` (on its own device)
    and moved to ``device``."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return (low + (high - low) * u).to(device)


def normal(generator: torch.Generator, shape, dtype, device):
    """Standard normals drawn by ``generator`` and moved to ``device``."""
    return torch.randn(shape, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def batched_rejection_sample_mask(generator, propose_accept, max_iter=100):
    """Run batched rejection sampling until all lanes accept.

    ``propose_accept(generator) -> (proposal, accept_mask)`` proposes a
    full batch.  Returns ``(x, accepted)``: ``accepted`` marks lanes that
    genuinely accepted within ``max_iter`` rounds (the rest keep their
    final proposal).  Truncation is exact only for callers that replace
    unaccepted lanes by the current state (heat-bath ``fallback``)."""
    x, acc = propose_accept(generator)
    i = 0
    while i < max_iter and not bool(acc.all()):
        proposal, ok = propose_accept(generator)
        x = torch.where(acc, x, proposal)
        acc = acc | ok
        i += 1
    return x, acc


def batched_rejection_sample(generator, propose_accept, max_iter=100):
    """As :func:`batched_rejection_sample_mask`, returning only the
    samples (exact draws need a large ``max_iter``)."""
    x, _ = batched_rejection_sample_mask(generator, propose_accept, max_iter)
    return x
