"""Counter-based RNG shared by the fused kernels (PyTorch port of
``mlmcpathintegral_tpu/ops/pallas_rng.py``; its CUDA twin is
``csrc/rng.cuh``).

Each element keys two 32-bit lanes — one from its site index (+ per-step
seed and step counter), one from its global chain index (+ second seed
word) — advanced by a shared draw counter and combined through a final
avalanche.  A launch over chains [chain0, chain0 + C) of a larger run (one
rank's block under a chain mesh) hashes chain0 + its local chain, so its
chains draw what the same chains of the whole launch draw:

    bits = fmix32( fmix32(base_site + ctr*C1) + fmix32(base_chain + ctr*C2) )

The bits are identical to the JAX ones for every (seed, seed2, site, chain,
step, ctr), which is what lets the plain versions of the kernels reproduce
the Pallas kernels bit for bit.

PyTorch on the CPU has no ``>>`` or ``+`` for ``torch.uint32``, so the
plain version hashes in ``int64`` and masks to 32 bits after every
multiply and add.  The multiply is split into 16-bit halves so that no
intermediate leaves the int64 range.  Seed words given as int32 wrap to
uint32 as ``astype(uint32)`` does in the JAX kernels.
"""

from __future__ import annotations

import math

import torch

from mlmcpathintegral_tpu_torch.ops import _cuda

TWO_PI = 2.0 * math.pi
M32 = 0xFFFFFFFF

MAX_SITES = 1 << 31      # per-lane ids: full uint32 minus a safety bit
MAX_CHAINS = 1 << 31


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


def check_element_capacity(n_sites: int, n_chains: int,
                           chain0: int = 0) -> None:
    """Reject configurations whose per-lane ids would wrap uint32 — a
    silent wrap would hand identical noise streams to distinct sites.
    ``chain0``: the global index of the launch's first chain."""
    if chain0 < 0:
        raise ValueError(f"chain0 must be >= 0, got {chain0}")
    n_chains = chain0 + n_chains
    if n_sites > MAX_SITES or n_chains > MAX_CHAINS:
        raise ValueError(
            f"counter RNG supports up to {MAX_SITES} sites and "
            f"{MAX_CHAINS} chains per kernel (got {n_sites} sites, "
            f"{n_chains} chains); larger lattices need a wider id scheme")


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
# rng_fill: the generator's words over a grid of ids (csrc/rng_fill.cu)
# ---------------------------------------------------------------------------

RNG_FILL = _cuda.KernelCounter(
    "rng_fill", "mlmcpathintegral_tpu_torch/csrc/rng.cuh",
    "mlmcpathintegral_tpu/ops/pallas_rng.py:53")


#: threads a block of rng_fill, and the most blocks along y (CUDA's limit)
FILL_THREADS = 256
MAX_GRID_Y = 65535
MAX_FILL_WORDS = 2**31 - 1


def fill_launch(n_sites: int, n_chains: int, n_steps: int, n_ctr: int):
    """(threads a block, blocks along x, blocks along y) of an rng_fill
    launch: x over the (chain, site) plane, one thread an id, y over the
    steps, each block looping over steps gridDim.y apart where there are
    more than 65 535.  The kernel indexes in 32 bits: a grid whose plane
    or whole output passes 2^31 - 1 words is refused here, before any
    launch."""
    plane = n_chains * n_sites
    total = plane * n_steps * n_ctr
    if plane > MAX_FILL_WORDS or total > MAX_FILL_WORDS:
        raise ValueError(
            f"rng_fill indexes in 32 bits: {n_chains} chains x {n_sites} "
            f"sites x {n_steps} steps x {n_ctr} counters = {total} words "
            f"passes {MAX_FILL_WORDS}; fill it in smaller grids")
    threads = min(FILL_THREADS, max(32, -(-plane // 32) * 32))
    return (threads, max(1, -(-plane // threads)),
            max(1, min(n_steps, MAX_GRID_Y)))


def _check_stepless(step0, n_steps) -> None:
    if step0 is None and n_steps != 1:
        raise ValueError(f"a step-less stream has one step, got n_steps="
                         f"{n_steps}")


def rng_fill_plain(seed, *, n_sites, n_chains, n_steps, n_ctr, device,
                   step0=0, chain0=0):
    """Plain version of :func:`rng_fill`."""
    _check_stepless(step0, n_steps)
    check_element_capacity(n_sites, n_chains, chain0)
    seed1, seed2 = seed_pair(seed)
    site, chain = element_ids((n_sites,), n_chains, device, chain0)
    if torch.device(device).type == "cuda":
        RNG_FILL.plain_cuda_calls += 1
    bits, uni, nrm = [], [], []
    for st in range(n_steps):
        rng = CounterRng(seed1, site, chain, seed2,
                         step=None if step0 is None else step0 + st)
        bits.append(rng.bits(n_ctr))
        rng.ctr = 0
        u = rng.uniform(torch.float32, n_ctr)
        uni.append(u)
        half = n_ctr // 2
        u1, u2 = u[0:2 * half:2], u[1:2 * half:2]
        nrm.append(torch.sqrt(-2.0 * torch.log(u1))
                   * torch.cos(TWO_PI * u2))
    return torch.stack(bits), torch.stack(uni), torch.stack(nrm)


def rng_fill(seed, *, n_sites, n_chains, n_steps, n_ctr, step0=0,
             device="cuda", chain0=0):
    """The counter RNG's words for every (step, ctr, chain, site) with
    step = step0 .. step0+n_steps-1, ctr = 1 .. n_ctr: returns
    (bits int64 [n_steps, n_ctr, n_chains, n_sites] holding uint32 values,
    uniforms float32 of the same shape, normals float32
    [n_steps, n_ctr//2, n_chains, n_sites] from the word pairs
    (2k+1, 2k+2)).  ``step0=None`` takes the step-less streams (no step
    index folded into the site lane; ``n_steps`` must be 1), which the GFF
    sweep kernel draws from.  ``chain0``: the global index of the grid's
    first chain (its chains are chain0 .. chain0+n_chains-1).  Runs the
    kernel on the card unless ``device`` is the CPU, where the plain
    version runs.  The kernel
    writes the bits as uint32; widening them to int64 is a pass of its
    own after the launch."""
    device = _cuda.run_device(device)
    _check_stepless(step0, n_steps)
    if device.type == "cpu":
        return rng_fill_plain(seed, n_sites=n_sites, n_chains=n_chains,
                              n_steps=n_steps, n_ctr=n_ctr, step0=step0,
                              device=device, chain0=chain0)
    check_element_capacity(n_sites, n_chains, chain0)
    launch = fill_launch(n_sites, n_chains, n_steps, n_ctr)
    seed1, seed2 = seed_pair(seed)
    shape = (n_steps, n_ctr, n_chains, n_sites)
    bits = torch.empty(shape, dtype=torch.int32, device=device)
    uni = torch.empty(shape, dtype=torch.float32, device=device)
    nrm = torch.empty((n_steps, n_ctr // 2, n_chains, n_sites),
                      dtype=torch.float32, device=device)
    err = _cuda.load_library().mlmc_rng_fill(
        bits.data_ptr(), uni.data_ptr(), nrm.data_ptr(), seed1, seed2,
        chain0, n_sites, n_chains, step0 or 0, n_steps, n_ctr, int(step0 is None),
        *launch, _cuda.stream_ptr(device))
    _cuda.check_status(err, "rng_fill kernel launch")
    RNG_FILL.launches += 1
    return bits.to(torch.int64) & M32, uni, nrm
