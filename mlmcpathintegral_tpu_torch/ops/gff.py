"""Fused red/black sweeps of the plain 2-D Gaussian free field (port of
``mlmcpathintegral_tpu/ops/pallas_gff.py``), and the raw neighbour sum of
the JAX package's GFF probe (``tools/perf_probe.py`` probe_verify_gff).

``gff_sweep`` launches the CUDA kernel of ``csrc/gff_sweep.cu`` for CUDA
tensors and runs the plain PyTorch version below for CPU tensors.  One
draw: ``n_overrelax`` reflections phi -> 2 nb/kappa - phi, then
``n_heatbath`` Gaussian heat-bath sweeps phi ~ nb/kappa + sigma N(0, 1),
each as red ((i + j) even) then black, on fields [C, Mx*Mt] with vertex
l = Mt*j + i.  The normals come from the counter RNG's step-less streams
(site l, global chain index; heat-bath sweep h, colour c takes words
4h + 2c + 1 and 4h + 2c + 2), so for equal seeds the plain version
reproduces the Pallas kernel up to float rounding.  The neighbour sum
follows the Pallas order ((phi[j-1] + phi[j+1]) + phi[i-1]) + phi[i+1];
the model's own ``GFFAction._nbsum`` sums in the XLA order, so the two
sweeps agree to rounding, not bit for bit.
"""

from __future__ import annotations

import math

import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops.rng import (
    CounterRng, check_element_capacity, element_ids, seed_pair,
)

SWEEP = _cuda.KernelCounter(
    "gff_sweep", "mlmcpathintegral_tpu_torch/csrc/gff_sweep.cu",
    "mlmcpathintegral_tpu/ops/pallas_gff.py:72")
NBSUM = _cuda.KernelCounter(
    "gff_nbsum", "mlmcpathintegral_tpu_torch/csrc/gff_sweep.cu",
    "tools/perf_probe.py:321")


#: the neighbour-sum kernel's threads a row at most, and the grid's
#: limit in y
NB_ROW_THREADS = 256
MAX_GRID_Y = 65535
#: the sweep kernel's warp branch (a chain on one warp, n/64 sites a lane
#: a half-sweep) takes fields up to WARP_SITES_MAX sites when there are at
#: least WARP_MIN_CHAINS chains; else a chain takes a block.  Measured on
#: the H100 (scripts/gff_bits.py --boundary): the warp branch is faster
#: from 2048 chains at 16x16 to 48x48, the block design below 2048 chains
#: and at 64x64
WARP_SITES_MAX = 2304
WARP_MIN_CHAINS = 2048
#: the sweep kernel's branches, as the C launcher numbers them
BRANCHES = {"warp": 0, "block": 1, "global": 2}


def _nbsum_grid(g):
    """Neighbour sum of [C, Mx, Mt] grids in the Pallas order."""
    return ((torch.roll(g, 1, dims=1) + torch.roll(g, -1, dims=1))
            + torch.roll(g, 1, dims=2)) + torch.roll(g, -1, dims=2)


def _colour_masks(Mx, Mt, device):
    j = torch.arange(Mx, device=device)[:, None]
    i = torch.arange(Mt, device=device)[None, :]
    red = (i + j) % 2 == 0
    return red, ~red


def gff_nbsum_plain(phi, Mt, Mx):
    """Plain version of :func:`gff_nbsum`."""
    NBSUM.count_plain(phi)
    C = phi.shape[0]
    return _nbsum_grid(phi.reshape(C, Mx, Mt)).reshape(C, Mx * Mt)


def nbsum_launch(Mt: int, Mx: int, n_chains: int, vec: bool):
    """(sites a thread V, threads a row, rows a block, blocks in x, blocks
    in y) of the neighbour-sum kernel's 2-D launch: a row takes min(Mt / V,
    256) threads of V consecutive sites (V = 4, 16-byte loads and stores,
    when ``vec``), a block the whole rows that fit in 256 threads (at most
    the chain's Mx, so no thread of a small field idles), blocks
    in x the row groups, blocks in y the chains (each block loops over the
    chains gridDim.y apart)."""
    V = 4 if vec else 1
    tpr = min(Mt // V, NB_ROW_THREADS)
    rpb = min(NB_ROW_THREADS // tpr, Mx)
    return V, tpr, rpb, -(-Mx // rpb), min(max(n_chains, 1), MAX_GRID_Y)


def gff_nbsum(phi, Mt, Mx):
    """The 4-point periodic neighbour sum of every site of fields
    [C, Mx*Mt], in the Pallas kernel's summation order."""
    if _cuda.dispatch_device(phi) == "cpu":
        return gff_nbsum_plain(phi, Mt, Mx)
    C = phi.shape[0]
    _cuda.require_cuda("phi", phi, (C, Mx * Mt))
    out = torch.empty_like(phi)
    # 16-byte loads and stores need rows of a multiple of 4 sites and
    # aligned pointers
    vec = Mt % 4 == 0 and phi.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    V, tpr, rpb, gx, gy = nbsum_launch(Mt, Mx, C, vec)
    err = _cuda.load_library().mlmc_gff_nbsum(
        phi.data_ptr(), out.data_ptr(), C, Mx, Mt, V, tpr, rpb, gx, gy,
        _cuda.stream_ptr(phi.device))
    _cuda.check_status(err, "gff_nbsum kernel launch")
    NBSUM.launches += 1
    return out


def _sigma(kappa: float) -> float:
    """Heat-bath width 1/sqrt(kappa), in double as the Pallas kernel
    folds it."""
    return 1.0 / math.sqrt(kappa)


def gff_sweep_plain(phi, seed, *, kappa, Mt, Mx, n_overrelax=0,
                    n_heatbath=1, chain0=0):
    """Plain PyTorch version of the kernel (any device, any float dtype):
    the Pallas kernel's arithmetic, whole-lattice masked updates."""
    SWEEP.count_plain(phi)
    C = phi.shape[0]
    check_element_capacity(Mx * Mt, C, chain0)
    seed1, seed2 = seed_pair(seed)
    kappa = float(kappa)
    sigma = _sigma(kappa)
    g = phi.reshape(C, Mx, Mt)
    masks = _colour_masks(Mx, Mt, phi.device)
    for _ in range(n_overrelax):
        for mask in masks:
            g = torch.where(mask, 2.0 * _nbsum_grid(g) / kappa - g, g)
    if n_heatbath:
        site, chain = element_ids((Mx, Mt), C, phi.device, chain0)
        rng = CounterRng(seed1, site, chain, seed2)
        for _ in range(n_heatbath):
            for mask in masks:
                new = _nbsum_grid(g) / kappa + sigma * rng.normal(phi.dtype)
                g = torch.where(mask, new, g)
    return g.reshape(C, Mx * Mt)


def sweep_launch(Mt: int, Mx: int, n_chains: int, smem_limit: int):
    """(lanes per chain, chains per block, dynamic shared bytes, branch) of
    the sweep kernel's launch on a device that lets a block opt in to
    ``smem_limit`` bytes.  branch: "warp" (a chain on one warp, up to
    ``_cuda.WARPS_PER_BLOCK`` chains a block, for fields up to
    WARP_SITES_MAX sites and at least WARP_MIN_CHAINS chains), "block" (a
    chain on a block of min(1024, next_pow2(n/2)) threads, one for each
    site of a colour, the field in shared memory) or "global" (the same
    block with a field beyond shared memory updated in place in the output
    tensor)."""
    n = Mx * Mt
    if n <= WARP_SITES_MAX and n_chains >= WARP_MIN_CHAINS:
        cpb = _cuda.WARPS_PER_BLOCK
        return 32, cpb, 4 * cpb * n, "warp"
    lanes = min(1024, _cuda.next_pow2(n // 2))
    if 4 * n <= smem_limit:
        return lanes, 1, 4 * n, "block"
    return lanes, 1, 0, "global"


def sweep_attrs(Mt: int, Mx: int, n_chains: int):
    """Registers a thread, spilled bytes a thread and resident blocks and
    warps an SM of the sweep kernel at its launch for n_chains chains of
    an Mx x Mt field (the card is needed)."""
    lanes, cpb, smem, branch = sweep_launch(
        Mt, Mx, n_chains, _cuda.max_smem_optin(0))
    return _cuda.kernel_attrs("mlmc_gff_sweep_attrs", lanes * cpb, smem,
                              BRANCHES[branch])


def _sweep_cuda(phi, seed, *, kappa, Mt, Mx, n_overrelax, n_heatbath,
                chain0):
    C = phi.shape[0]
    _cuda.require_cuda("phi", phi, (C, Mx * Mt))
    if Mt % 2 or Mx % 2:
        raise ValueError(f"the GFF sweep kernel updates a colour in place "
                         f"and needs even Mt and Mx, got {Mt}x{Mx}")
    check_element_capacity(Mx * Mt, C, chain0)
    lanes, cpb, smem, branch = sweep_launch(
        Mt, Mx, C, _cuda.max_smem_optin(phi.device.index or 0))
    seed1, seed2 = seed_pair(seed)
    out = torch.empty_like(phi)
    kappa = float(kappa)
    err = _cuda.load_library().mlmc_gff_sweep(
        phi.data_ptr(), out.data_ptr(), C, Mx, Mt, n_overrelax, n_heatbath,
        kappa, _sigma(kappa), seed1, seed2, chain0, lanes, cpb,
        BRANCHES[branch],
        smem, _cuda.stream_ptr(phi.device))
    _cuda.check_status(err, "gff_sweep kernel launch")
    SWEEP.launches += 1
    return out


def gff_sweep(phi, seed, *, kappa, Mt, Mx, n_overrelax=0, n_heatbath=1,
              chain0=0):
    """Fused GFF sweeps on all chains.

    phi: [C, Mx*Mt] flat fields (vertex l = Mt*j + i); seed: an int, an
    int32[1] or int32[2] tensor or a pair (a single word takes seed2 = 0);
    kappa = 4 + mu2; chain0: the global index of phi's first chain.
    Returns the swept phi."""
    kw = dict(kappa=kappa, Mt=Mt, Mx=Mx, n_overrelax=n_overrelax,
              n_heatbath=n_heatbath, chain0=chain0)
    if _cuda.dispatch_device(phi) == "cpu":
        return gff_sweep_plain(phi, seed, **kw)
    return _sweep_cuda(phi, seed, **kw)
