"""Fused overrelax + heat-bath sweeps of the quenched Schwinger model
(port of ``mlmcpathintegral_tpu/ops/pallas_schwinger.py``).

``schwinger_sweep`` (one draw) and ``schwinger_sweep_chain`` (``n_steps``
draws, emitting per step Q = sum_P mod_2pi(theta_P) and optionally
E = sum_P cos(theta_P)) launch the CUDA kernel of
``csrc/schwinger_sweep.cu`` for CUDA tensors and run the plain PyTorch
version below for CPU tensors.  The plain version draws the same counter
RNG words as the Pallas kernel, so for equal seeds it reproduces the JAX
kernel (run in interpret mode) up to float rounding.

Per draw: ``n_overrelax`` reflection sweeps and ``n_heatbath`` ExpCos
heat-bath sweeps in 4 (mu, parity) link groups; the rejection draws 3
words per round and is truncated at ``k_rej`` rounds, after which the
link stays (an exact identity mixture).  ``schwinger_sweep_chain`` with
``n_steps = N`` equals N ``schwinger_sweep`` calls with
``step_offset = 0 .. N-1``.
"""

from __future__ import annotations

import math

import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops.rng import (
    CounterRng, check_element_capacity, element_ids, seed_pair,
)
from mlmcpathintegral_tpu_torch.utils.timer import (
    COUNT_EVERY, recorded_launch,
)

TWO_PI = 2.0 * math.pi
PI = math.pi

SWEEP = _cuda.KernelCounter(
    "schwinger_sweep_chain", "mlmcpathintegral_tpu_torch/csrc/"
    "schwinger_sweep.cu",
    "mlmcpathintegral_tpu/ops/pallas_schwinger.py:272")


def _mod_2pi(x):
    """[-pi, pi) wrap (utils.special.mod_2pi)."""
    return x - TWO_PI * torch.floor(0.5 * (x + PI) / PI)


def _sh(A, di, dj):
    """A(i+di, j+dj) for A of shape [C, Mx, Mt] (dim 1 = j, dim 2 = i)."""
    out = A
    if di:
        out = torch.roll(out, -di, dims=2)
    if dj:
        out = torch.roll(out, -dj, dims=1)
    return out


def _staples(T, X, mu):
    """(theta_p, theta_m) for direction mu (quenchedschwingeraction.cc:
    25-44)."""
    if mu == 0:
        tp = _mod_2pi(_sh(T, 0, 1) + X - _sh(X, 1, 0))
        tm = _mod_2pi(_sh(T, 0, -1) + _sh(X, 1, -1) - _sh(X, 0, -1))
    else:
        tp = _mod_2pi(T + _sh(X, 1, 0) - _sh(T, 0, 1))
        tm = _mod_2pi(_sh(T, -1, 1) + _sh(X, -1, 0) - _sh(T, -1, 0))
    return tp, tm


def _first_accepted(prop, ok):
    """(x, accepted): the proposal of the first accepted round (rounds on
    dim 0) — the sequential rejection loop evaluated for all rounds at
    once; lanes with no accepted round get 0."""
    acc = ok.any(dim=0)
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
    x = torch.gather(prop, 0, first)[0]
    return torch.where(acc, x, torch.zeros_like(x)), acc


def _count_rounds(count, ok):
    """Add to ``count`` (a loop's row of the counts ``recorded_launch``
    hands a launch, or None) the rejection loops whose k rounds ``ok`` holds on dim 0, evaluated
    all at once: every element a draw, its rounds needed the sequential
    loop's (the first accepting round + 1, or k), its rounds evaluated
    k."""
    if count is None:
        return
    k = ok.shape[0]
    acc = ok.any(dim=0)
    first = torch.argmax(ok.to(torch.int8), dim=0)
    n = acc.numel()
    count[0] += n
    count[1] += torch.where(acc, first + 1, k).sum()
    count[2] += n * k


def _expcos_rejection(rng, tau, k_rej, dtype, count=None):
    """Centred x ~ exp(tau cos x) on [-pi, pi) by mixed-envelope rejection
    (uniform proposals for tau < 0.45, a tight Gaussian otherwise), 3 words
    per round: u1 (radius), u2 (uniform proposal / Box-Muller angle), u
    (accept).  Returns (x, accepted); ``count`` (or None) counts the
    loop."""
    w = rng.uniform(dtype, n=3 * k_rej)
    w = w.reshape(k_rej, 3, *w.shape[1:])
    u1, u2, u = w[:, 0], w[:, 1], w[:, 2]
    use_uni = tau < 0.45
    sigma = 0.5 * PI / torch.sqrt(torch.clamp(tau, min=1e-12))
    prop_u = PI * (2.0 * u2 - 1.0)
    prop_g = sigma * (torch.sqrt(-2.0 * torch.log(u1))
                      * torch.cos(TWO_PI * u2))
    prop = torch.where(use_uni, prop_u, prop_g)
    log_ratio = tau * (torch.cos(prop) - 1.0) + torch.where(
        use_uni, 0.0, 2.0 * tau * prop * prop / (PI * PI))
    ok = (-PI <= prop) & (prop < PI) & (torch.log(u) <= log_ratio)
    _count_rounds(count, ok)
    return _first_accepted(prop, ok)


def _expcos_shift(tp, tm, beta):
    """(tau, shift) of the ExpCos draw given the two staples."""
    dx = tm - tp
    tau = 2.0 * beta * torch.abs(torch.cos(0.5 * dx))
    shift = 0.5 * (tp + tm) + torch.where(
        torch.abs(dx) > PI, dx.new_tensor(PI), dx.new_tensor(0.0))
    return tau, shift


def _expcos_draw(rng, cur, tp, tm, beta, k_rej, dtype, count=None):
    """Heat-bath draw from p(x) ~ exp[beta(cos(x-tp)+cos(x-tm))]; lanes
    that never accept keep ``cur``."""
    tau, shift = _expcos_shift(tp, tm, beta)
    x, acc = _expcos_rejection(rng, tau, k_rej, dtype, count)
    return torch.where(acc, _mod_2pi(x + shift), cur)


_GROUPS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _group_sel(mu, parity):
    """Selector of one (mu, parity) group on the [..., Mx, Mt] grid:
    temporal links by j parity, spatial links by i parity."""
    if mu == 0:
        return (Ellipsis, slice(parity, None, 2), slice(None))
    return (Ellipsis, slice(None), slice(parity, None, 2))


def _one_step(T, X, rng, *, beta, n_overrelax, n_heatbath, k_rej, dtype,
              count=None):
    """One full draw on [C, Mx, Mt] fields: n_overrelax + n_heatbath
    coloured sweeps.  Each heat-bath group takes 3 k_rej words from the
    stream; only the group's own sites are drawn (their words are the
    same ones the Pallas kernel draws for them).  ``count`` (or None)
    counts the heat bath's rejection loop."""
    for _ in range(n_overrelax):
        for mu, parity in _GROUPS:
            tp, tm = _staples(T, X, mu)
            sel = _group_sel(mu, parity)
            L = (T if mu == 0 else X).clone()
            L[sel] = _mod_2pi(tp[sel] + tm[sel] - L[sel])
            T, X = (L, X) if mu == 0 else (T, L)
    for _ in range(n_heatbath):
        for mu, parity in _GROUPS:
            tp, tm = _staples(T, X, mu)
            sel = _group_sel(mu, parity)
            L = (T if mu == 0 else X).clone()
            L[sel] = _expcos_draw(rng.at(sel), L[sel], tp[sel], tm[sel],
                                  beta, k_rej, dtype, count)
            rng.skip(3 * k_rej)
            T, X = (L, X) if mu == 0 else (T, L)
    return T, X


def _plaquettes(T, X):
    return _mod_2pi(T + _sh(X, 1, 0) - _sh(T, 0, 1) - X)


@recorded_launch("k3.launch", 1)
def schwinger_sweep_chain_plain(theta, seed, *, beta, Mt, Mx, n_steps,
                                n_overrelax=1, n_heatbath=1, k_rej=6,
                                with_energy=False, step_offset=0, chain0=0,
                                rounds=None):
    """Plain PyTorch version of the kernel (any device, any float dtype):
    returns (theta', qsum[n_steps, C], esum[n_steps, C] or None).
    ``chain0``: the global index of theta's first chain, as the kernel's.
    Recorded as the kernel's launch, ``rounds`` the heat bath's counts."""
    SWEEP.count_plain(theta)
    C = theta.shape[0]
    check_element_capacity(Mx * Mt, C, chain0)
    seed1, seed2 = seed_pair(seed)
    g = theta.reshape(C, Mx, Mt, 2)
    T, X = g[..., 0], g[..., 1]
    site, chain = element_ids((Mx, Mt), C, theta.device, chain0)
    qs, es = [], []
    for s in range(n_steps):
        rng = CounterRng(seed1, site, chain, seed2, step=step_offset + s)
        T, X = _one_step(T, X, rng, beta=beta, n_overrelax=n_overrelax,
                         n_heatbath=n_heatbath, k_rej=k_rej,
                         dtype=theta.dtype,
                         count=None if rounds is None else rounds[0])
        plaq = _plaquettes(T, X)
        qs.append(torch.sum(plaq, dim=(1, 2)))
        if with_energy:
            es.append(torch.sum(torch.cos(plaq), dim=(1, 2)))
    out = torch.stack([T, X], dim=-1).reshape(C, 2 * Mx * Mt)
    qsum = (torch.stack(qs) if qs
            else theta.new_zeros((0, C)))
    esum = torch.stack(es) if with_energy and es else (
        theta.new_zeros((0, C)) if with_energy else None)
    return out, qsum, esum


#: the warp design's largest field: a chain of up to 64 sites on one warp
#: (at most two sites a lane, so its Q/E sums add in the order of the
#: block-wide tree and keep its bits)
WARP_SITES_MAX = 64
#: counter words a chain of the sweep kernel, and of the two-level kernel,
#: keeps in shared memory (csrc/schwinger_sweep.cuh SWEEP_WORDS,
#: TWOLEVEL_WORDS)
SWEEP_WORDS = 96
TWOLEVEL_WORDS = 320


def warp_lanes(Mx: int, Mt: int):
    """Lanes a chain of an Mx x Mt field gets in the warp design (two a
    site, up to a warp), or None where the design does not take the field:
    more than WARP_SITES_MAX sites, or a link group (rows or columns of one
    parity) with more links than lanes, which the design's one link a lane
    could not cover."""
    nsites = Mx * Mt
    lanes = _cuda.warp_layout(2 * nsites)[0]
    largest_group = max(-(-Mx // 2) * Mt, Mx * -(-Mt // 2))
    if nsites > WARP_SITES_MAX or largest_group > lanes:
        return None
    return lanes


#: the block design (csrc/schwinger_sweep.cuh): the fewest threads a
#: chain (two warps; a share of one warp is the warp design's) and the most
#: (half an SM's resident threads: a team of 1024 holds an SM alone, and
#: each of its barriers idles it), the slots a thread sums at most
#: (TEAM_SLOTS), the threads an SM keeps resident at the kernels' 64
#: registers a thread (65 536 / 64, __launch_bounds__(1024)), an SM's
#: shared memory and what each block reserves of it, and the SMs of the
#: card the layouts are planned for (an H100)
TEAM_THREADS_MIN = 64
TEAM_THREADS_MAX = 512
TEAM_SLOTS = 8
SM_THREADS = 1024
SM_SMEM = 233_472
BLOCK_SMEM_RESERVED = 1024
H100_SMS = 132


def team_slots(n_items: int) -> int:
    """The slots the block design's sums add over, in the order of the
    one-item-a-thread tree: min(1024, next_pow2(n_items)), the threads a
    chain of the block design before the team."""
    return min(1024, _cuda.next_pow2(n_items))


def block_threads(n_items: int, n_chains: int | None, smem_of) -> int:
    """Threads a chain of the block design for chains of ``n_items`` sites
    or cells: ``team_slots``, at most TEAM_THREADS_MAX, while an SM holds
    one chain of the launch, else halved while the chains an SM must hold
    for one wave, as far as its shared memory holds them
    (``smem_of(threads)``: a block's bytes), would need more than
    SM_THREADS threads; never below TEAM_THREADS_MIN or the slots /
    TEAM_SLOTS.  With no chain count: ``team_slots``, the threads a chain
    whose block bytes decide whether a field fits (as before the team)."""
    P = team_slots(n_items)
    if n_chains is None:
        return P
    G = min(P, TEAM_THREADS_MAX)
    per_sm = -(-n_chains // H100_SMS)
    least = max(TEAM_THREADS_MIN, P // TEAM_SLOTS)
    while G > least:
        fit = SM_SMEM // (smem_of(G) + BLOCK_SMEM_RESERVED)
        if G * min(per_sm, max(fit, 1)) <= SM_THREADS:
            break
        G //= 2
    return G


def sweep_smem_bytes(Mt: int, Mx: int, n_chains: int | None = None):
    """(lanes per chain, chains per block, dynamic shared bytes) of the
    sweep kernel's launch with the fields in shared memory: the warp
    design (``warp_lanes``) up to WARP_SITES_MAX sites, a chain on a warp
    or on an aligned share of one, up to four warps a block; a larger field
    on the block design, a chain a block on ``block_threads`` threads;
    each chain with its SWEEP_WORDS-word table, beside it the block's Q/E
    scratch (2 floats a thread)."""
    nsites = Mx * Mt
    if warp_lanes(Mx, Mt) is not None:
        lanes, cpb = _cuda.warp_chains(2 * nsites, n_chains)
        return lanes, cpb, 4 * cpb * (SWEEP_WORDS + 2 * nsites)

    def smem_of(G):
        return 4 * (SWEEP_WORDS + 2 * nsites + 2 * G)
    G = block_threads(nsites, n_chains, smem_of)
    return G, 1, smem_of(G)


def sweep_launch(Mt: int, Mx: int, n_chains: int, smem_limit: int):
    """(lanes per chain, chains per block, dynamic shared bytes, branch) of
    the sweep kernel's launch on a device that lets a block opt in to
    ``smem_limit`` bytes.  branch: "warp" (the warp design), "block" (the
    block design, the field in shared memory) or "global" (a field beyond
    shared memory in a global scratch buffer, a chain a block on
    ``team_slots`` threads, with only the word table and the Q/E scratch in
    shared memory).  Whether a field fits is decided at ``team_slots``
    threads, so the block branch takes the fields it took before the
    team."""
    lanes, cpb, smem = sweep_smem_bytes(Mt, Mx, n_chains)
    if lanes <= 32 and smem <= smem_limit:
        return lanes, cpb, smem, "warp"
    if lanes > 32 and sweep_smem_bytes(Mt, Mx)[2] <= smem_limit:
        return lanes, cpb, smem, "block"
    P = team_slots(Mx * Mt)
    return P, 1, 4 * (SWEEP_WORDS + 2 * P), "global"


def sweep_attrs(Mt: int, Mx: int, n_chains: int):
    """Registers a thread, spilled bytes a thread and resident blocks and
    warps an SM of the sweep kernel at its launch for n_chains chains of
    an Mx x Mt field (the card is needed)."""
    lanes, cpb, smem, branch = sweep_launch(
        Mt, Mx, n_chains, _cuda.max_smem_optin(0))
    return _cuda.kernel_attrs("mlmc_schwinger_sweep_attrs", lanes * cpb,
                              smem, int(branch == "warp"), 0)  # uncounted


@recorded_launch("k3.launch", 1, every=COUNT_EVERY)
def _sweep_cuda(theta, seed, *, beta, Mt, Mx, n_steps, n_overrelax,
                n_heatbath, k_rej, with_energy, step_offset, want_q, chain0,
                rounds):
    """The kernel's launch; with ``rounds`` the counted kernel, which adds
    the heat bath's counts to it."""
    C = theta.shape[0]
    _cuda.require_cuda("theta", theta, (C, 2 * Mx * Mt))
    check_element_capacity(Mx * Mt, C, chain0)
    lanes, cpb, smem, branch = sweep_launch(
        Mt, Mx, C, _cuda.max_smem_optin(theta.device.index or 0))
    seed1, seed2 = seed_pair(seed)
    out = torch.empty_like(theta)
    work = torch.empty_like(theta) if branch == "global" else None
    qsum = (torch.empty((n_steps, C), dtype=theta.dtype, device=theta.device)
            if want_q else None)
    esum = (torch.empty((n_steps, C), dtype=theta.dtype, device=theta.device)
            if with_energy else None)
    lib = _cuda.load_library()
    err = lib.mlmc_schwinger_sweep(
        theta.data_ptr(), out.data_ptr(),
        qsum.data_ptr() if qsum is not None else None,
        esum.data_ptr() if esum is not None else None,
        work.data_ptr() if work is not None else None,
        rounds.data_ptr() if rounds is not None else None,
        C, Mx, Mt, n_steps, step_offset, n_overrelax, n_heatbath, k_rej,
        float(beta), seed1, seed2, chain0, lanes, cpb, smem,
        _cuda.stream_ptr(theta.device))
    _cuda.check_status(err, "schwinger_sweep kernel launch")
    SWEEP.launches += 1
    return out, qsum, esum


def schwinger_sweep(theta, seed, *, beta, Mt, Mx, n_overrelax=1,
                    n_heatbath=1, k_rej=6, step_offset=0, chain0=0):
    """One fused overrelax + heat-bath draw on all chains.

    theta: [C, Mx*Mt*2] flat link angles; seed: int32 scalar or pair
    (two words for production-length chains).  ``step_offset`` selects
    the per-step stream of the chain kernel; ``chain0`` is the global
    index of theta's first chain (a rank's offset under a chain mesh).
    Returns the new theta."""
    kw = dict(beta=beta, Mt=Mt, Mx=Mx, n_steps=1, n_overrelax=n_overrelax,
              n_heatbath=n_heatbath, k_rej=k_rej, with_energy=False,
              step_offset=step_offset, chain0=chain0)
    if _cuda.dispatch_device(theta) == "cpu":
        return schwinger_sweep_chain_plain(theta, seed, **kw)[0]
    return _sweep_cuda(theta, seed, want_q=False, **kw)[0]


def schwinger_sweep_chain(theta, seed, *, beta, Mt, Mx, n_steps,
                          n_overrelax=1, n_heatbath=1, k_rej=6,
                          with_energy=False, chain0=0):
    """``n_steps`` consecutive fused draws in one launch, the field
    resident in shared memory.  Returns (theta', qsum[n_steps, C]) or,
    with ``with_energy``, (theta', qsum, esum[n_steps, C]).  ``chain0``:
    the global index of theta's first chain."""
    kw = dict(beta=beta, Mt=Mt, Mx=Mx, n_steps=n_steps,
              n_overrelax=n_overrelax, n_heatbath=n_heatbath, k_rej=k_rej,
              with_energy=with_energy, step_offset=0, chain0=chain0)
    if _cuda.dispatch_device(theta) == "cpu":
        out, qsum, esum = schwinger_sweep_chain_plain(theta, seed, **kw)
    else:
        out, qsum, esum = _sweep_cuda(theta, seed, want_q=True, **kw)
    if with_energy:
        return out, qsum, esum
    return out, qsum
