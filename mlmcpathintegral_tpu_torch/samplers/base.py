"""Sampler protocol (PyTorch port of
``mlmcpathintegral_tpu/samplers/base.py``): a sampler's ``draw`` maps a
batched state (a NamedTuple whose tensors lead with the chain axis) to the
next one.  Randomness comes from an explicit ``torch.Generator``: the
sampler draws its kernel seeds, or its plain tensor noise, from it."""

from __future__ import annotations

import abc

import torch


def default_dtype():
    """torch's default float dtype (float32 unless the caller set
    another), the port's counterpart of the JAX package's x64 switch."""
    return torch.get_default_dtype()


def own_generator(sampler, generator: torch.Generator,
                  device) -> torch.Generator:
    """A generator of the sampler's own, seeded once from ``generator``:
    on the CPU for a ``host_seeded`` sampler (its kernels take their seeds
    as host words, so a CPU generator serves every draw without a read
    from the card), else on ``device``.  A sampler nested in another (the
    coarsest level of the hierarchical and multilevel samplers) draws from
    it, whatever generator the outer draws take."""
    seed = int(torch.randint(2**62, (1,), generator=generator,
                             device=generator.device))
    gen_device = torch.device("cpu") if sampler.host_seeded else device
    return torch.Generator(device=gen_device).manual_seed(seed)


def kernel_seed(generator: torch.Generator) -> torch.Tensor:
    """An int32[2] kernel seed pair (the kernels take it as two host
    words), drawn from ``generator.host`` where the generator carries one
    (a chunk's CPU twin, ``mc.twolevel.chunk_generator``: no read from the
    card), else from ``generator`` on its own device."""
    source = getattr(generator, "host", None) or generator
    return torch.randint(-2**31, 2**31 - 1, (2,), generator=source,
                         dtype=torch.int32, device=source.device)


class Sampler(abc.ABC):
    """Batched sampler over an action."""

    #: True where a draw takes nothing but kernel seeds from its generator:
    #: a CPU generator then serves the draws of chains on the card, with
    #: no read from the card per draw
    host_seeded = False

    #: global index of the state's first chain, which a kernel's counter
    #: RNG hashes (chain0 + local chain): 0 for a state holding every
    #: chain, a rank's offset when the chains are split over a chain mesh
    #: (the MC methods set it for their run)
    chain0 = 0

    def __init__(self, action):
        self.action = action

    @abc.abstractmethod
    def init(self, generator, n_chains: int, dtype, device):
        """Fresh sampler state with an ``x: [n_chains, ndof]`` field."""

    @abc.abstractmethod
    def draw(self, generator, state):
        """One draw on all chains: (state, accept[n_chains] bool)."""

    def set_state(self, state, x):
        """Replace the current position (MCMCStep::set_state).  Samplers
        with cached action values override it to refresh their caches."""
        return state._replace(x=x)

    def x_of(self, state):
        """Current position [n_chains, ndof] of a sampler state."""
        return state.x

    def prepare(self, generator, n_chains: int, dtype, device,
                n_burnin: int = 0):
        """Initialise + burn in (the work the reference does in sampler
        constructors)."""
        state = self.init(generator, n_chains, dtype, device)
        for _ in range(n_burnin):
            state, _ = self.draw(generator, state)
        return state
