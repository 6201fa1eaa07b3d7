"""Batched on-device statistics: mean, variance, autocorrelation, tau_int
(PyTorch port of ``mlmcpathintegral_tpu/utils/statistics.py``; reference
src/common/statistics.{hh,cc}).

The accumulator is batched over chains: each chain carries its own
running moments, a ring buffer of its last ``k_max`` samples and running
lagged products S_k.  Getters aggregate across chains the way the
reference aggregates across MPI ranks.

Semantics matched to the reference:
  * record: running avg, long-term moments E[Q..Q^4], windowed
    S_k = (1/N_k) sum_i Q_i Q_{i-k} with N_k = n_longterm - k
  * soft reset clears {n, avg} only; long-term moments survive burn-in
  * tau_int = max(1, 1 + 2 sum_{k>=1} (1 - k/N) C_k / C_0),
    C_k = <S_k> - <Q>^2
  * error(avg) = sqrt(tau_int * Var / N), variance error via 4th moments
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops import statistics as stats_kernel


class StatsState(NamedTuple):
    """Accumulator: int32 scalar counters, [C] moments, [C, k_max]
    window buffers, all on the run's device."""
    n: torch.Tensor          # sample count per chain since last reset
    avg: torch.Tensor        # [C] running average since last reset
    n_lt: torch.Tensor       # long-term sample count per chain
    avg_lt: torch.Tensor     # [C] long-term running E[Q]
    avg2_lt: torch.Tensor    # [C] long-term running E[Q^2]
    avg3_lt: torch.Tensor    # [C] long-term running E[Q^3]
    avg4_lt: torch.Tensor    # [C] long-term running E[Q^4]
    ring: torch.Tensor       # [C, k_max]; ring[:, k] = Q_{t-k}
    S_k: torch.Tensor        # [C, k_max] running lagged products


def init(n_chains: int, k_max: int, dtype=torch.float32,
         device="cuda") -> StatsState:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def c0():
        return torch.zeros((), dtype=torch.int32, device=device)

    return StatsState(c0(), z(n_chains), c0(), z(n_chains), z(n_chains),
                      z(n_chains), z(n_chains), z(n_chains, k_max),
                      z(n_chains, k_max))


def _n_recorded(T: int, n_valid) -> int:
    return T if n_valid is None else max(0, min(int(n_valid), T))


def record_block(state: StatsState, Qs: torch.Tensor,
                 n_valid=None) -> StatsState:
    """Record a [T, C] block of samples: ``n_valid`` (a host int, or None
    for the whole block) records only the leading ``n_valid`` samples.  A
    state on the card is updated by one launch of the statistics kernel
    (``ops/statistics.py``, ``csrc/statistics.cu``), one on the CPU by
    :func:`record_block_plain`.  The input state is left as it was."""
    if _cuda.dispatch_device(state.avg) == "cuda":
        return StatsState(*stats_kernel.record_block_cuda(
            state, Qs, _n_recorded(Qs.shape[0], n_valid)))
    return record_block_plain(state, Qs, n_valid)


def record_block_plain(state: StatsState, Qs: torch.Tensor,
                       n_valid=None) -> StatsState:
    """The plain version of :func:`record_block`, in closed form (no
    sequential scan): running moments from block sums, the ring buffer by
    one gather, the lagged products S_k by k_max lagged dot products of the
    block against (ring history ++ block)."""
    stats_kernel.STATS.count_plain(state.avg)
    T = Qs.shape[0]
    dtype = state.avg.dtype
    # [C, T] with each chain's samples contiguous: a chain's sums then
    # reduce one row the same way whatever the number of chains, so a
    # rank's block of a chain-split run keeps the one-process bits
    Qb = Qs.to(dtype).T.contiguous()
    k_max = state.ring.shape[1]
    v = _n_recorded(T, n_valid)
    if n_valid is None:
        Qm = Qb
    else:
        mask = (torch.arange(T, device=Qb.device) < v).to(dtype)
        Qm = Qb * mask[None, :]
    vf = float(v)

    n_new = state.n + v
    n_lt_new = state.n_lt + v
    nf = torch.clamp(n_new.to(dtype), min=1.0)
    nltf = torch.clamp(n_lt_new.to(dtype), min=1.0)
    n_old_f = state.n.to(dtype)
    nlt_old_f = state.n_lt.to(dtype)

    Qm2 = Qm * Qm
    s1 = torch.sum(Qm, dim=1)
    s2 = torch.sum(Qm2, dim=1)
    s3 = torch.sum(Qm2 * Qm, dim=1)
    s4 = torch.sum(Qm2 * Qm2, dim=1)
    avg = (n_old_f * state.avg + s1) / nf
    avg_lt = (nlt_old_f * state.avg_lt + s1) / nltf
    avg2_lt = (nlt_old_f * state.avg2_lt + s2) / nltf
    avg3_lt = (nlt_old_f * state.avg3_lt + s3) / nltf
    avg4_lt = (nlt_old_f * state.avg4_lt + s4) / nltf

    # ext[:, p] holds global sample index n_lt_old - k_max + p: the ring
    # (oldest first) then the block; slots before any history are zeros
    ext = torch.cat([state.ring.flip(1), Qb], dim=1)
    k = torch.arange(k_max, device=Qb.device)
    ring = ext[:, k_max + v - 1 - k]                  # newest first

    # lagged pair sums over the new valid pairs of each lag: the window of
    # lag l starts at ext column k_max - l
    win = ext.unfold(1, T, 1)                         # [C, k_max + 1, T]
    P = torch.sum(Qm[:, None, :] * win[:, k_max - k, :], dim=2)
    kf = k.to(dtype)[None, :]
    N_old = torch.clamp(nlt_old_f - kf, min=0.0)
    N_new = torch.clamp(nlt_old_f + vf - kf, min=0.0)
    S_k = torch.where(N_new > 0.0,
                      (N_old * state.S_k + P) / torch.clamp(N_new, min=1.0),
                      state.S_k)
    return StatsState(n_new, avg, n_lt_new, avg_lt, avg2_lt, avg3_lt,
                      avg4_lt, ring, S_k)


def record_many(state: StatsState, Qs: torch.Tensor) -> StatsState:
    """Record a [T, C] block of samples (closed-form block update)."""
    return record_block(state, Qs)


def record(state: StatsState, Q: torch.Tensor) -> StatsState:
    """Record one sample per chain, Q: [C]."""
    return record_block(state, Q[None])


def record_masked(state: StatsState, Q: torch.Tensor, enabled) -> StatsState:
    """Record one sample per chain only when ``enabled`` (a bool, or a 0-d
    bool tensor on the state's device): the per-step form of
    ``record_block``'s ``n_valid`` prefix."""
    new = record(state, Q)
    en = torch.as_tensor(enabled, device=state.avg.device)
    return StatsState(*(torch.where(en, a, b) for a, b in zip(new, state)))


def tau_int_device(state: StatsState) -> torch.Tensor:
    """Integrated autocorrelation time as a 0-d tensor on the state's
    device, aggregated over the chain axis like :meth:`Statistics.tau_int`
    (the clock of the tau-based coarse subsampling,
    montecarlotwolevel.cc:82-94)."""
    avg = torch.mean(state.avg_lt)
    C_k = torch.mean(state.S_k, dim=0) - avg * avg
    n = (state.n_lt * state.ring.shape[0]).to(C_k.dtype)
    k = torch.arange(1, C_k.shape[0], dtype=C_k.dtype, device=C_k.device)
    tsum = torch.sum((1.0 - k / torch.clamp(n, min=1.0)) * C_k[1:])
    good = (state.n_lt >= 2) & (C_k[0] > 0.0)
    return torch.where(
        good, torch.clamp(1.0 + 2.0 * tsum
                          / torch.where(good, C_k[0], torch.ones_like(n)),
                          min=1.0),
        torch.ones_like(n))


def variance_device(state: StatsState) -> torch.Tensor:
    """Cross-chain sample variance as a 0-d tensor on the state's device
    (statistics.cc:30-35)."""
    avg = torch.mean(state.avg_lt)
    avg2 = torch.mean(state.S_k[:, 0])
    n = (state.n_lt * state.ring.shape[0]).to(avg.dtype)
    return torch.where(state.n_lt >= 2,
                       n / torch.clamp(n - 1.0, min=1.0) * (avg2 - avg * avg),
                       torch.zeros_like(avg))


def gather(state, mesh, axis_name: str = "chains"):
    """The accumulators of a chain-sharded run over the global chain axis
    (every rank's block, in rank order), for the getters, which then see
    every chain: the gathered state equals the one-process state bit for
    bit, and so does every number computed from it.  ``mesh`` None: the
    state itself."""
    if mesh is None:
        return state
    from mlmcpathintegral_tpu_torch.parallel.chains import gather_chains
    return gather_chains(mesh, state, axis_name)


def soft_reset(state: StatsState) -> StatsState:
    return state._replace(n=torch.zeros_like(state.n),
                          avg=torch.zeros_like(state.avg))


def hard_reset(state: StatsState) -> StatsState:
    """Full reset: clears the long-term moments and the autocorrelation
    window as well (statistics.hh:128-147 ``hard_reset``), unlike
    :func:`soft_reset`, which keeps them so tau_int survives burn-in."""
    return StatsState(*(torch.zeros_like(a) for a in state))


def device_summary(state: StatsState):
    """All scalar estimators of one accumulator, reduced on its device and
    read back in one transfer: (floats[5] = [avg, variance,
    variance_error, tau_int, window_capped], ints[2] = [n, n_lt]) as
    numpy arrays (statistics.cc:30-98)."""
    C = state.ring.shape[0]
    k_max = state.ring.shape[1]
    avg = torch.mean(state.avg)
    a1 = torch.mean(state.avg_lt)
    a2 = torch.mean(state.avg2_lt)
    a3 = torch.mean(state.avg3_lt)
    a4 = torch.mean(state.avg4_lt)
    C_k = torch.mean(state.S_k, dim=0) - a1 * a1
    nf = state.n_lt.to(C_k.dtype) * float(C)
    avg2w = torch.mean(state.S_k[:, 0])
    var = torch.where(nf >= 2.0,
                      nf / torch.clamp(nf - 1.0, min=1.0) * (avg2w - a1 * a1),
                      torch.zeros_like(nf))
    ve = (a4 - 4.0 * a1 * a3 + 8.0 * a1 * a1 * a2 - a2 * a2
          - 4.0 * a1 ** 4) / torch.clamp(nf, min=1.0)
    var_err = torch.where(nf >= 1.0, torch.sqrt(torch.clamp(ve, min=0.0)),
                          torch.zeros_like(nf))
    k = torch.arange(1, k_max, dtype=C_k.dtype, device=C_k.device)
    tsum = torch.sum((1.0 - k / torch.clamp(nf, min=1.0)) * C_k[1:])
    good = (state.n_lt >= 2) & (C_k[0] > 0.0)
    tau = torch.where(
        good, torch.clamp(1.0 + 2.0 * tsum
                          / torch.where(good, C_k[0], torch.ones_like(nf)),
                          min=1.0),
        torch.ones_like(nf))
    capped = ((state.n_lt > k_max + 2) & (C_k[0] > 0.0)
              & (C_k[-1] > 0.1 * C_k[0]))
    floats = torch.stack([avg, var, var_err, tau, capped.to(C_k.dtype)])
    ints = torch.stack([state.n.to(torch.int64), state.n_lt.to(torch.int64)])
    return (floats.cpu().numpy().astype(np.float64),
            ints.cpu().numpy().astype(np.int64))


def binning_analysis(samples, n_levels: int = 12) -> np.ndarray:
    """Naive error of the 2^b-binned series per level b (the plateau is
    the true error) — the numpy form of native/statistics_engine.cc
    mlmc_stats_binning."""
    buf = np.ascontiguousarray(samples, dtype=np.float64).ravel().copy()
    errs = []
    for _ in range(n_levels):
        if buf.size < 2:
            errs.append(errs[-1] if errs else 0.0)
            continue
        errs.append(float(buf.std(ddof=1) / np.sqrt(buf.size)))
        m2 = buf.size // 2
        buf = 0.5 * (buf[:2 * m2:2] + buf[1:2 * m2:2])
    return np.asarray(errs)


def tau_binning(series) -> float:
    """Binning estimate of tau_int from a scalar series:
    tau ~= (plateau error / naive error)^2 over doubling bin sizes — the
    cross-check of a window-capped tau_int.  For iid chains the series
    may be cross-chain means."""
    series = np.asarray(series, np.float64).ravel()
    if series.size < 64:
        return 1.0
    n_levels = max(2, int(math.log2(series.size)) - 3)
    errs = binning_analysis(series, n_levels=min(n_levels, 16))
    if errs[0] <= 0.0:
        return 1.0
    return float(max(1.0, (errs.max() / errs[0]) ** 2))


class Statistics:
    """Host-side view over a StatsState: reference-compatible estimators,
    aggregated over the chain axis.  The scalar estimators of one state
    are reduced on its device once and cached by state identity."""

    def __init__(self, label: str, k_max: int):
        self.label = label
        self.k_max = k_max
        self._warned_capped = False
        self._scalar_cache = (None, None)

    def init(self, n_chains: int, dtype=torch.float32,
             device="cuda") -> StatsState:
        return init(n_chains, self.k_max, dtype, device)

    def _scalars(self, state):
        cached_state, cached = self._scalar_cache
        if cached_state is state:
            return cached
        out = device_summary(state)
        self._scalar_cache = (state, out)
        return out

    def samples(self, state) -> int:
        _, i = self._scalars(state)
        return int(i[0]) * state.avg.shape[0]

    def local_samples(self, state) -> int:
        """Samples a chain has recorded since the last reset."""
        return int(state.n)

    def average(self, state) -> float:
        return float(self._scalars(state)[0][0])

    def variance(self, state) -> float:
        return float(self._scalars(state)[0][1])

    def variance_error(self, state) -> float:
        return float(self._scalars(state)[0][2])

    def auto_corr(self, state) -> np.ndarray:
        avg = torch.mean(state.avg_lt)
        return (torch.mean(state.S_k, dim=0) - avg * avg).cpu().numpy()

    def tau_int(self, state) -> float:
        f, _ = self._scalars(state)
        if f[4] > 0.0 and not self._warned_capped:
            self._warned_capped = True
            warnings.warn(
                f"Statistics[{self.label}]: autocorrelation has not "
                f"decayed within the k_max={self.k_max} window — tau_int "
                f"is a lower bound; widen n_autocorr_window or cross-check "
                f"with tau_binning", stacklevel=2)
        return float(f[3])

    def window_capped(self, state) -> bool:
        """True when the normalised autocorrelation at the window edge is
        still above 0.1 — the windowed tau_int is then a lower bound."""
        return bool(self._scalars(state)[0][4] > 0.0)

    def error(self, state) -> float:
        n = self.samples(state)
        if n == 0:
            return float("inf")
        return float(math.sqrt(self.tau_int(state)
                               * max(self.variance(state), 0.0) / n))

    def summary(self, state) -> str:
        return (f" {self.label}: Avg +/- Err = {self.average(state):.6f}"
                f" +/- {self.error(state):.6f}\n"
                f" {self.label}: Var +/- Err = {self.variance(state):.6f}"
                f" +/- {self.variance_error(state):.6f}\n"
                f" {self.label}: tau_{{int}}   = {self.tau_int(state):.3f}\n"
                f" {self.label}: window      = {self.k_max}\n"
                f" {self.label}: # samples   = {self.samples(state)}")
