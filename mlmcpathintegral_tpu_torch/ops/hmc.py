"""Fused HMC trajectory of the 1-D QM actions (port of
``mlmcpathintegral_tpu/ops/pallas_hmc.py``).

``hmc_trajectory`` runs one whole leapfrog trajectory (nt + 1 force
evaluations, half kicks at both ends, hmcsampler.cc:22-69) and the
Metropolis test on every chain: it launches the CUDA kernel of
``csrc/hmc_trajectory.cu`` for CUDA tensors and runs the plain PyTorch
version below for CPU tensors.  The momenta p and accept uniforms u are
passed in.  Supported actions (``kind``):

  * ``harmonic``: F = (m0/a)((2 + a^2 mu2) x - x_- - x_+),
    S = a m0/2 sum [ (dx/a)^2 + mu2 x^2 ]
  * ``quartic``: adds a lambda/4 (x - x0)^4 potential
  * ``rotor``: F = (I/a)(sin(x - x_-) + sin(x - x_+)),
    S = (I/a) sum (1 - cos dx)

The plain version keeps the Pallas kernel's order of operations, with the
Python-side constants folded in double as there, so that the kernel (built
with ``--fmad=false``) matches it operation for operation.
"""

from __future__ import annotations

import torch

from mlmcpathintegral_tpu_torch.ops import _cuda

HMC = _cuda.KernelCounter(
    "hmc_trajectory", "mlmcpathintegral_tpu_torch/csrc/hmc_trajectory.cu",
    "mlmcpathintegral_tpu/ops/pallas_hmc.py:132")

KINDS = {"harmonic": 0, "quartic": 1, "rotor": 2}


def _roll(x, shift):
    return torch.roll(x, shift, dims=-1)


def force_and_action(kind, *, m0, mu2=0.0, lam=0.0, x0=0.0, a):
    """(force, action) of ``kind`` on [..., M] paths, in the Pallas
    kernel's order of operations (``_force_and_action``)."""
    if kind == "harmonic":
        c = 2.0 + a * a * mu2

        def force(x):
            return (m0 / a) * (c * x - _roll(x, 1) - _roll(x, -1))

        def action(x):
            dx = x - _roll(x, 1)
            s = dx * dx / (a * a) + mu2 * x * x
            return 0.5 * a * m0 * torch.sum(s, dim=-1)

    elif kind == "quartic":
        c = 2.0 + a * a * mu2

        def force(x):
            xs = x - x0
            return ((m0 / a) * (c * x - _roll(x, 1) - _roll(x, -1))
                    + a * lam * xs * xs * xs)

        def action(x):
            dx = x - _roll(x, 1)
            xs2 = (x - x0) * (x - x0)
            s = m0 * (dx * dx / (a * a) + mu2 * x * x) \
                + 0.5 * lam * xs2 * xs2
            return 0.5 * a * torch.sum(s, dim=-1)

    elif kind == "rotor":
        def force(x):
            return (m0 / a) * (torch.sin(x - _roll(x, 1))
                               + torch.sin(x - _roll(x, -1)))

        def action(x):
            dx = x - _roll(x, 1)
            return (m0 / a) * torch.sum(1.0 - torch.cos(dx), dim=-1)
    else:
        raise ValueError(f"unknown action kind '{kind}'")
    return force, action


def leapfrog(x, p, dt, force, nt):
    """nt leapfrog steps with half kicks at both ends: (x_t, p_t)."""
    xt = x
    p = p - (0.5 * dt) * force(xt)
    xt = xt + dt * p
    for _ in range(nt - 1):
        p = p - dt * force(xt)
        xt = xt + dt * p
    p = p - (0.5 * dt) * force(xt)
    return xt, p


def action_kernel_params(action):
    """(kind, params) for actions the fused kernel supports, or
    (None, None)."""
    from mlmcpathintegral_tpu_torch.models.harmonic import (
        HarmonicOscillatorAction,
    )
    from mlmcpathintegral_tpu_torch.models.quartic import (
        QuarticOscillatorAction,
    )
    from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
    if type(action) is HarmonicOscillatorAction:
        return "harmonic", dict(m0=action.m0, mu2=action.mu2,
                                a_lat=action.a_lat)
    if type(action) is QuarticOscillatorAction:
        return "quartic", dict(m0=action.m0, mu2=action.mu2,
                               lam=action.lam, x0=action.x0,
                               a_lat=action.a_lat)
    if type(action) is RotorAction:
        return "rotor", dict(m0=action.m0, a_lat=action.a_lat)
    return None, None


def hmc_trajectory_plain(x, p, u, dt, *, kind, m0, mu2=0.0, lam=0.0, x0=0.0,
                         a_lat, nt):
    """Plain PyTorch version of the trajectory kernel (any device, any
    float dtype): returns (x_new [C, M], accept [C] bool)."""
    HMC.count_plain(x)
    force, action = force_and_action(kind, m0=float(m0), mu2=float(mu2),
                                     lam=float(lam), x0=float(x0),
                                     a=float(a_lat))
    dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
    T_cur = 0.5 * torch.sum(p * p, dim=-1)
    S_cur = action(x)
    xt, p = leapfrog(x, p, dt, force, int(nt))
    T_new = 0.5 * torch.sum(p * p, dim=-1)
    dH = (action(xt) - S_cur) + (T_new - T_cur)
    accept = (dH < 0.0) | (u < torch.exp(-dH))
    return torch.where(accept[:, None], xt, x), accept


#: the warp branch's most sites a lane: x and p of up to 32 SITES_MAX
#: sites stay in registers with no kind spilling (ptxas on sm_90a: at 8
#: sites a lane the rotor kind spills)
SITES_MAX = 4


def hmc_launch(M: int, n_chains: int | None = None):
    """(branch, lanes per chain, sites a lane, chains per block, dynamic
    shared bytes) of the trajectory kernel's launch, from the shape alone.
    "warp": a chain on one warp, or on an aligned power-of-two share of one
    when M < 32, lane l holding sites l + lanes k of x and p in registers
    (lanes x sites = next_pow2(M)), up to four warps a block, fewer where
    the chains run out first; up to 32 SITES_MAX sites.  "block": a chain
    on a power-of-two group of up to 1024 threads, x, p and a reduction
    slot a thread in shared memory (the design before the warp branch)."""
    n = _cuda.next_pow2(M)
    if n <= 32 * SITES_MAX:
        lanes, cpb = _cuda.warp_chains(M, n_chains)
        return "warp", lanes, n // lanes, cpb, 0
    tpc, cpb = _cuda.block_layout(M)
    if n_chains is not None:
        cpb = max(1, min(cpb, n_chains))
    return "block", tpc, 0, cpb, 4 * (cpb * 2 * M + tpc * cpb)


def hmc_attrs(M: int, n_chains: int, kind: str):
    """Registers a thread, spilled bytes a thread and resident blocks and
    warps an SM of the trajectory kernel at its launch for [n_chains, M]
    (the card is needed)."""
    _, lanes, sites, cpb, smem = hmc_launch(M, n_chains)
    return _cuda.kernel_attrs("mlmc_hmc_trajectory_attrs", lanes * cpb,
                              KINDS[kind], sites, smem)


def hmc_trajectory(x, p, u, dt, *, kind, m0, mu2=0.0, lam=0.0, x0=0.0,
                   a_lat, nt):
    """One fused HMC trajectory + Metropolis test on all chains.

    x, p: [C, M]; u: [C] uniforms; dt: the step size (a float or a 0-d
    tensor; the kernel reads it from device memory, so a tensor on the
    card costs no host sync).  Returns (x_new [C, M], accept [C] bool)."""
    kw = dict(kind=kind, m0=m0, mu2=mu2, lam=lam, x0=x0, a_lat=a_lat, nt=nt)
    if _cuda.dispatch_device(x) == "cpu":
        return hmc_trajectory_plain(x, p, u, dt, **kw)
    if kind not in KINDS:
        raise ValueError(f"unknown action kind '{kind}'")
    C, M = x.shape
    _cuda.require_cuda("x", x, (C, M))
    _cuda.require_cuda("p", p, (C, M))
    _cuda.require_cuda("u", u, (C,))
    dt = torch.as_tensor(dt, dtype=torch.float32, device=x.device)
    _cuda.require_cuda("dt", dt.reshape(1), (1,))
    _, lanes, sites, cpb, smem = hmc_launch(M, C)
    _cuda.check_smem(smem, x.device, f"the M={M} HMC path")
    a, m0, mu2, lam = float(a_lat), float(m0), float(mu2), float(lam)
    if kind == "harmonic":
        k_act = 0.5 * a * m0
    elif kind == "quartic":
        k_act = 0.5 * a
    else:
        k_act = m0 / a
    out = torch.empty_like(x)
    acc = torch.empty((C,), dtype=torch.bool, device=x.device)
    err = _cuda.load_library().mlmc_hmc_trajectory(
        x.data_ptr(), p.data_ptr(), u.data_ptr(), dt.data_ptr(),
        out.data_ptr(), acc.data_ptr(), C, M, int(nt), KINDS[kind],
        m0 / a, 2.0 + a * a * mu2, a * lam, float(x0), a * a, mu2, m0,
        0.5 * lam, k_act, lanes, cpb, sites, smem,
        _cuda.stream_ptr(x.device))
    _cuda.check_status(err, "hmc_trajectory kernel launch")
    HMC.launches += 1
    return out, acc
