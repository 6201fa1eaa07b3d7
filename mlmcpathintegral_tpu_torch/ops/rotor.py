"""Fused sweeps and Wolff cluster updates of the topological rotor (port of
``mlmcpathintegral_tpu/ops/pallas_rotor.py``).

``rotor_sweep_chain`` / ``rotor_sweep`` run even/odd overrelaxation and
ExpCos heat-bath sweeps of the rotor path (``csrc/rotor_sweep.cu``);
``rotor_cluster_chain`` runs closed-form 1-D Wolff cluster updates
(``csrc/rotor_cluster.cu``).  Both launch their CUDA kernel for CUDA
tensors and run the plain PyTorch version below for CPU tensors.  The
plain versions draw the same counter RNG words as the Pallas kernels, so
for equal seeds they reproduce them (in interpret mode) up to float
rounding.  Both chains emit the per-step winding sum
W = sum_j mod_2pi(x_{j+1} - x_j); the susceptibility QoI is
(W / 2 pi)^2 / T.

Sweeps.  The conditional of a site given both neighbours is
exp[kappa (cos(x - x_m) + cos(x - x_p))] with kappa = I/a, an ExpCos draw
around the circular mean, and the overrelaxation reflection is
mod_2pi(x_m + x_p - x), the Schwinger link update on a 1-D checkerboard.
Even site 2k and odd site 2k+1 share RNG site id k; within a step the
even half-sweep draws words 1 .. 3 k_rej, the odd one the next 3 k_rej
(per heat-bath sweep).  ``rotor_sweep`` is the chain with n_steps = 1 at
step 0: N single sweeps do not equal one N-step chain.

Cluster updates.  Every bond test of one update reads the configuration
from before it (the rotor reflection flips S_ell's sign per flipped
endpoint), so an update is two masked min-reductions per chain: F_raw,
the walk order of the first closed forward bond, and B_raw, that of the
first closed backward bond, with the two terminal links of a full wrap
tested with both endpoints flipped (``samplers/cluster.py`` _vector_core).
Update u of step s draws its words from CounterRng(step = s n_updates + u)
in the order u_refl, u_seed, u_f, u_b; the reflection xbar and the seed
i0 come from site 0's words.  The CUDA kernel takes both minima from one
test per bond (its header says how); the plain version keeps the
two-pass form, and tests/test_torch_ops_rotor_extents.py holds the two
equal.
"""

from __future__ import annotations

import math

import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops.rng import (
    CounterRng, check_element_capacity, element_ids, seed_pair,
)
from mlmcpathintegral_tpu_torch.ops.schwinger import (
    SWEEP_WORDS, _expcos_draw, _mod_2pi,
)

PI = math.pi

SWEEP = _cuda.KernelCounter(
    "rotor_sweep_chain", "mlmcpathintegral_tpu_torch/csrc/rotor_sweep.cu",
    "mlmcpathintegral_tpu/ops/pallas_rotor.py:109")
CLUSTER = _cuda.KernelCounter(
    "rotor_cluster_chain", "mlmcpathintegral_tpu_torch/csrc/rotor_cluster.cu",
    "mlmcpathintegral_tpu/ops/pallas_rotor.py:247")


def winding_sum(x):
    """sum_j mod_2pi(x_{j+1} - x_j) over the sites of [..., M] paths."""
    return torch.sum(_mod_2pi(torch.roll(x, -1, dims=-1) - x), dim=-1)


# ---------------------------------------------------------------------------
# K8: even/odd overrelax + ExpCos heat-bath sweeps
# ---------------------------------------------------------------------------

def _sweep_step(e, o, rng, *, kappa, n_overrelax, n_heatbath, k_rej, dtype):
    """One draw on the parity components e = x(2k), o = x(2k+1)."""
    for _ in range(n_overrelax):
        e = _mod_2pi(torch.roll(o, 1, dims=-1) + o - e)
        o = _mod_2pi(e + torch.roll(e, -1, dims=-1) - o)
    for _ in range(n_heatbath):
        e = _expcos_draw(rng, e, torch.roll(o, 1, dims=-1), o, kappa, k_rej,
                         dtype)
        o = _expcos_draw(rng, o, e, torch.roll(e, -1, dims=-1), kappa, k_rej,
                         dtype)
    return e, o


def _parity_winding(e, o):
    """Winding sum of the path (e, o): sum mod_2pi(o - e) over the even
    bonds plus sum mod_2pi(e(k+1) - o) over the odd ones."""
    return (torch.sum(_mod_2pi(o - e), dim=-1)
            + torch.sum(_mod_2pi(torch.roll(e, -1, dims=-1) - o), dim=-1))


def rotor_sweep_chain_plain(x, seed, *, kappa, M, n_steps, n_overrelax=1,
                            n_heatbath=1, k_rej=8, chain0=0):
    """Plain PyTorch version of the sweep kernel (any device, any float
    dtype): returns (x', wsum[n_steps, C])."""
    SWEEP.count_plain(x)
    C = x.shape[0]
    _check_even(M)
    check_element_capacity(M // 2, C, chain0)
    seed1, seed2 = seed_pair(seed)
    e, o = x[:, 0::2], x[:, 1::2]
    site, chain = element_ids((M // 2,), C, x.device, chain0)
    ws = []
    for s in range(n_steps):
        rng = CounterRng(seed1, site, chain, seed2, step=s)
        e, o = _sweep_step(e, o, rng, kappa=kappa, n_overrelax=n_overrelax,
                           n_heatbath=n_heatbath, k_rej=k_rej, dtype=x.dtype)
        ws.append(_parity_winding(e, o))
    out = torch.stack([e, o], dim=-1).reshape(C, M)
    return out, (torch.stack(ws) if ws else x.new_zeros((0, C)))


def _check_even(M):
    if M % 2:
        raise ValueError("checkerboard sweep needs even M_lat")


#: the pending-draw queue of a chain (csrc/rotor_sweep.cu ROTOR_QUEUE: a
#: chunk of 4 draws on each of 32 lanes), 6 words an item
QUEUE = 128


def sweep_launch(M: int, n_chains: int, smem_limit: int):
    """(chains per block, dynamic shared bytes, table words) of the sweep
    kernel's launch, from the shape and the device's opt-in limit
    ``smem_limit``: a chain on one warp, its slice of shared memory holding
    the word table (SWEEP_WORDS; one heat-bath sweep at k_rej 8 reads
    counters up to 48), the path, and one over the other the queue of pending
    draws (QUEUE items of 6 words) and, when the winding sum's tree has
    more than one virtual thread a lane (next_pow2(M/2) > 32), a scratch
    of that tree's threads; up to four warps a block, fewer where the
    chains or 48 KB run out first.  A path whose slice with the table would
    pass the limit keeps no table (its words are hashed where they are
    drawn)."""
    _check_even(M)
    tpc = min(1024, _cuda.next_pow2(M // 2))
    pool = max(tpc if tpc > 32 else 0, 6 * QUEUE)
    words = SWEEP_WORDS
    if 4 * (words + M + pool) > smem_limit:
        words = 0
    chain_bytes = 4 * (words + M + pool)
    cpb = max(1, min(_cuda.WARPS_PER_BLOCK,
                     _cuda.SMEM_DEFAULT // chain_bytes, n_chains))
    return cpb, chain_bytes * cpb, words


def sweep_attrs(M: int, n_chains: int):
    """Registers a thread, spilled bytes a thread and resident blocks and
    warps an SM of the sweep kernel at its launch for [n_chains, M] (the
    card is needed)."""
    cpb, smem, _ = sweep_launch(M, n_chains, _cuda.max_smem_optin(0))
    return _cuda.kernel_attrs("mlmc_rotor_sweep_attrs", 32 * cpb, smem)


def _sweep_cuda(x, seed, *, kappa, M, n_steps, n_overrelax, n_heatbath,
                k_rej, want_w, chain0):
    C = x.shape[0]
    _check_even(M)
    _cuda.require_cuda("x", x, (C, M))
    check_element_capacity(M // 2, C, chain0)
    cpb, smem, words = sweep_launch(
        M, C, _cuda.max_smem_optin(x.device.index or 0))
    _cuda.check_smem(smem, x.device, f"the M={M} rotor path")
    seed1, seed2 = seed_pair(seed)
    out = torch.empty_like(x)
    wsum = (torch.empty((n_steps, C), dtype=x.dtype, device=x.device)
            if want_w else None)
    err = _cuda.load_library().mlmc_rotor_sweep(
        x.data_ptr(), out.data_ptr(),
        wsum.data_ptr() if wsum is not None else None, C, M, n_steps,
        n_overrelax, n_heatbath, k_rej, float(kappa), seed1, seed2, chain0,
        cpb, words, smem, _cuda.stream_ptr(x.device))
    _cuda.check_status(err, "rotor_sweep kernel launch")
    SWEEP.launches += 1
    return out, wsum


def rotor_sweep_chain(x, seed, *, kappa, M, n_steps, n_overrelax=1,
                      n_heatbath=1, k_rej=8, chain0=0):
    """``n_steps`` fused rotor draws in one launch.  x: [C, M] path angles
    (M even); seed: int32 scalar or pair; chain0: the global index of x's
    first chain.  Returns (x', wsum[n_steps, C])."""
    kw = dict(kappa=kappa, M=M, n_steps=n_steps, n_overrelax=n_overrelax,
              n_heatbath=n_heatbath, k_rej=k_rej, chain0=chain0)
    if _cuda.dispatch_device(x) == "cpu":
        return rotor_sweep_chain_plain(x, seed, **kw)
    return _sweep_cuda(x, seed, want_w=True, **kw)


def rotor_sweep(x, seed, *, kappa, M, n_overrelax=1, n_heatbath=1, k_rej=8,
                step_offset=0, chain0=0):
    """One fused draw: the chain at n_steps = 1.  ``step_offset`` is
    accepted and ignored, as in the JAX package."""
    del step_offset
    kw = dict(kappa=kappa, M=M, n_steps=1, n_overrelax=n_overrelax,
              n_heatbath=n_heatbath, k_rej=k_rej, chain0=chain0)
    if _cuda.dispatch_device(x) == "cpu":
        return rotor_sweep_chain_plain(x, seed, **kw)[0]
    return _sweep_cuda(x, seed, want_w=False, **kw)[0]


# ---------------------------------------------------------------------------
# K7: closed-form Wolff cluster updates
# ---------------------------------------------------------------------------

def _cluster_update(x, rng, rows, *, kappa2, M, dtype):
    """One Wolff cluster update of [C, M] paths (rows: site index [M])."""
    xbar = (2.0 * rng.uniform(dtype)[:, 0:1] - 1.0) * PI           # [C, 1]
    u_seed = rng.uniform(dtype)[:, 0:1]
    i0 = torch.clamp(torch.floor((1.0 - u_seed) * M),
                     max=M - 1).to(torch.int64)                     # [C, 1]

    c = torch.cos(x - xbar)
    s_orig = -kappa2 * c * torch.roll(c, -1, dims=-1)     # bond (b, b+1)
    p_one = 1.0 - torch.exp(torch.clamp(s_orig, max=0.0))
    p_two = 1.0 - torch.exp(torch.clamp(-s_orig, max=0.0))

    d = rows - i0
    rel = d + torch.where(d < 0, M, 0)
    rel_b = torch.where(rel == 0, 0, M - rel)
    k_bw = torch.where(rel_b == 0, M - 1, rel_b - 1)

    u_f = rng.uniform(dtype)
    closed_f = u_f >= torch.where(rel == M - 1, p_two, p_one)
    F_raw = torch.where(closed_f, rel, M).amin(dim=-1, keepdim=True)

    B_lim = torch.where(F_raw >= M, 1, M - F_raw)
    u_b = rng.uniform(dtype)
    term = (k_bw == B_lim - 1) & (F_raw < M)
    closed_b = u_b >= torch.where(term, p_two, p_one)
    B_raw = torch.where(closed_b, k_bw, M).amin(dim=-1, keepdim=True)
    B = torch.minimum(B_raw, B_lim)

    n_flips = ((rel == 0).to(torch.int64)
               + ((rel >= 1) & (rel <= F_raw)).to(torch.int64)
               + ((rel_b >= 1) & (rel_b <= B)).to(torch.int64)
               + ((rel == 0) & (F_raw >= M)).to(torch.int64)
               + ((rel == 0) & (B >= M)).to(torch.int64))
    return torch.where(n_flips % 2 == 1, _mod_2pi(PI + 2.0 * xbar - x), x)


def rotor_cluster_chain_plain(x, seed, *, kappa2, M, n_steps, n_updates=10,
                              chain0=0):
    """Plain PyTorch version of the cluster kernel (any device, any float
    dtype): returns (x', wsum[n_steps, C])."""
    CLUSTER.count_plain(x)
    C = x.shape[0]
    check_element_capacity(M, C, chain0)
    seed1, seed2 = seed_pair(seed)
    site, chain = element_ids((M,), C, x.device, chain0)
    ws = []
    for s in range(n_steps):
        for u in range(n_updates):
            rng = CounterRng(seed1, site, chain, seed2,
                             step=s * n_updates + u)
            x = _cluster_update(x, rng, site, kappa2=kappa2, M=M,
                                dtype=x.dtype)
        ws.append(winding_sum(x))
    return x, (torch.stack(ws) if ws else x.new_zeros((0, C)))


def cluster_launch(M: int, n_chains: int | None = None):
    """(lanes per chain, sites per lane, chains per block, dynamic shared
    bytes) of the cluster kernel's launch: a chain on one warp, or on a
    power-of-two share of one when M < 32, site m on lane m mod lanes; the
    path and its cosines (2 M floats) in the chain's slice of shared
    memory; up to four warps a block, fewer where the chains or 48 KB of
    shared memory run out first."""
    lanes, per_warp = _cuda.warp_layout(M)
    warps = min(_cuda.WARPS_PER_BLOCK,
                max(1, _cuda.SMEM_DEFAULT // (8 * M * per_warp)))
    if n_chains is not None:
        warps = max(1, min(warps, -(-n_chains // per_warp)))
    cpb = warps * per_warp
    return lanes, -(-M // lanes), cpb, 8 * M * cpb


def cluster_attrs(M: int, n_chains: int):
    """Registers a thread, spilled bytes a thread and resident blocks and
    warps an SM of the cluster kernel at its launch for [n_chains, M]
    (the card is needed)."""
    lanes, _, cpb, smem = cluster_launch(M, n_chains)
    return _cuda.kernel_attrs("mlmc_rotor_cluster_attrs", lanes * cpb, smem)


def rotor_cluster_chain(x, seed, *, kappa2, M, n_steps, n_updates=10,
                        chain0=0):
    """``n_steps`` fused cluster draws of ``n_updates`` Wolff updates each,
    in one launch.  x: [C, M] path angles; kappa2 = 2 I/a (the S_ell
    prefactor); chain0: the global index of x's first chain.  Returns
    (x', wsum[n_steps, C])."""
    if _cuda.dispatch_device(x) == "cpu":
        return rotor_cluster_chain_plain(x, seed, kappa2=kappa2, M=M,
                                         n_steps=n_steps, n_updates=n_updates,
                                         chain0=chain0)
    C = x.shape[0]
    _cuda.require_cuda("x", x, (C, M))
    check_element_capacity(M, C, chain0)
    lanes, _, cpb, smem = cluster_launch(M, C)
    _cuda.check_smem(smem, x.device, f"the M={M} rotor path")
    seed1, seed2 = seed_pair(seed)
    out = torch.empty_like(x)
    wsum = torch.empty((n_steps, C), dtype=x.dtype, device=x.device)
    err = _cuda.load_library().mlmc_rotor_cluster(
        x.data_ptr(), out.data_ptr(), wsum.data_ptr(), C, M, n_steps,
        n_updates, float(kappa2), seed1, seed2, chain0, lanes, lanes * cpb,
        smem,
        _cuda.stream_ptr(x.device))
    _cuda.check_status(err, "rotor_cluster kernel launch")
    CLUSTER.launches += 1
    return out, wsum
