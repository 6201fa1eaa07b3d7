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


def gff_nbsum(phi, Mt, Mx):
    """The 4-point periodic neighbour sum of every site of fields
    [C, Mx*Mt], in the Pallas kernel's summation order."""
    if _cuda.dispatch_device(phi) == "cpu":
        return gff_nbsum_plain(phi, Mt, Mx)
    C = phi.shape[0]
    _cuda.require_cuda("phi", phi, (C, Mx * Mt))
    out = torch.empty_like(phi)
    err = _cuda.load_library().mlmc_gff_nbsum(
        phi.data_ptr(), out.data_ptr(), C, Mx, Mt,
        _cuda.stream_ptr(phi.device))
    _cuda.check_status(err, "gff_nbsum kernel launch")
    NBSUM.launches += 1
    return out


def _sigma(kappa: float) -> float:
    """Heat-bath width 1/sqrt(kappa), in double as the Pallas kernel
    folds it."""
    return 1.0 / math.sqrt(kappa)


def gff_sweep_plain(phi, seed, *, kappa, Mt, Mx, n_overrelax=0,
                    n_heatbath=1):
    """Plain PyTorch version of the kernel (any device, any float dtype):
    the Pallas kernel's arithmetic, whole-lattice masked updates."""
    SWEEP.count_plain(phi)
    C = phi.shape[0]
    check_element_capacity(Mx * Mt, C)
    seed1, seed2 = seed_pair(seed)
    kappa = float(kappa)
    sigma = _sigma(kappa)
    g = phi.reshape(C, Mx, Mt)
    masks = _colour_masks(Mx, Mt, phi.device)
    for _ in range(n_overrelax):
        for mask in masks:
            g = torch.where(mask, 2.0 * _nbsum_grid(g) / kappa - g, g)
    if n_heatbath:
        site, chain = element_ids((Mx, Mt), C, phi.device)
        rng = CounterRng(seed1, site, chain, seed2)
        for _ in range(n_heatbath):
            for mask in masks:
                new = _nbsum_grid(g) / kappa + sigma * rng.normal(phi.dtype)
                g = torch.where(mask, new, g)
    return g.reshape(C, Mx * Mt)


def sweep_launch(Mt: int, Mx: int, n_chains: int, smem_limit: int):
    """(threads per chain, chains per block, dynamic shared bytes, fields
    in global memory) of the kernel's launch on a device that lets a block
    opt in to ``smem_limit`` bytes: the fields in shared memory when they
    fit, else updated in place in the output tensor, one chain per
    block."""
    n = Mx * Mt
    tpc, cpb = _cuda.block_layout(n)
    cpb = max(1, min(cpb, n_chains))
    smem = 4 * cpb * n
    if smem <= smem_limit:
        return tpc, cpb, smem, False
    return tpc, 1, 0, True


def _sweep_cuda(phi, seed, *, kappa, Mt, Mx, n_overrelax, n_heatbath):
    C = phi.shape[0]
    _cuda.require_cuda("phi", phi, (C, Mx * Mt))
    if Mt % 2 or Mx % 2:
        raise ValueError(f"the GFF sweep kernel updates a colour in place "
                         f"and needs even Mt and Mx, got {Mt}x{Mx}")
    check_element_capacity(Mx * Mt, C)
    tpc, cpb, smem, in_global = sweep_launch(
        Mt, Mx, C, _cuda.max_smem_optin(phi.device.index or 0))
    seed1, seed2 = seed_pair(seed)
    out = torch.empty_like(phi)
    kappa = float(kappa)
    err = _cuda.load_library().mlmc_gff_sweep(
        phi.data_ptr(), out.data_ptr(), C, Mx, Mt, n_overrelax, n_heatbath,
        kappa, _sigma(kappa), seed1, seed2, tpc, cpb, int(in_global), smem,
        _cuda.stream_ptr(phi.device))
    _cuda.check_status(err, "gff_sweep kernel launch")
    SWEEP.launches += 1
    return out


def gff_sweep(phi, seed, *, kappa, Mt, Mx, n_overrelax=0, n_heatbath=1):
    """Fused GFF sweeps on all chains.

    phi: [C, Mx*Mt] flat fields (vertex l = Mt*j + i); seed: an int, an
    int32[1] or int32[2] tensor or a pair (a single word takes seed2 = 0);
    kappa = 4 + mu2.  Returns the swept phi."""
    kw = dict(kappa=kappa, Mt=Mt, Mx=Mx, n_overrelax=n_overrelax,
              n_heatbath=n_heatbath)
    if _cuda.dispatch_device(phi) == "cpu":
        return gff_sweep_plain(phi, seed, **kw)
    return _sweep_cuda(phi, seed, **kw)
