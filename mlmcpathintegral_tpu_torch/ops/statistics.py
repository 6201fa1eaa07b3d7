"""The statistics update in one CUDA pass (``csrc/statistics.cu``).

``record_block_cuda`` launches the kernel that records a [T, C] block of
samples into a batched statistics state (``utils/statistics.py``
``StatsState``): the running mean, the long-term moments, the ring of the
last k_max samples, the lagged products S_k and the two counters, written
to new tensors.  ``utils.statistics.record_block`` calls it for a state on
the card and runs its plain version, ``record_block_plain``, for one on the
CPU.  The kernel replaces no Pallas kernel: the JAX package leaves this
update to XLA.  Its launch shape comes from the shape alone
(:func:`record_launch`), and so does the order of every sum, so a chain's
row is the same whatever the number of chains.
"""

from __future__ import annotations

import ctypes

import torch

from mlmcpathintegral_tpu_torch.ops import _cuda

STATS = _cuda.KernelCounter(
    "stats_record", "mlmcpathintegral_tpu_torch/csrc/statistics.cu",
    "none: mlmcpathintegral_tpu/utils/statistics.py record_block (XLA)")

#: samples staged a tile and the zeroed doubles in front of a chain's
#: series (csrc/statistics.cu STATS_TILE, STATS_PAD); threads a block at
#: most (STATS_THREADS)
TILE, PAD, MAX_THREADS = 512, 8, 256
#: the float fields of a ``StatsState``, in the kernel's order
FLOAT_FIELDS = ("avg", "avg_lt", "avg2_lt", "avg3_lt", "avg4_lt", "ring",
                "S_k")
#: lags a thread: odd, so a warp's window loads fall in distinct banks
LAGS = (1, 3, 5, 7)
#: chains a block where a chain takes one warp: a tile's row is then read
#: as 8 neighbouring float32 chains, one 32-byte sector
CHAINS_PER_BLOCK = 8


def record_launch(k_max: int, n_chains: int):
    """(lags a thread, warps a chain, chains a block, dynamic shared bytes)
    of the kernel's launch for a [n_chains, k_max] state: the fewest odd
    lags a thread that let one warp hold the window (more warps where k_max
    > 32 * 7), up to CHAINS_PER_BLOCK chains a block within MAX_THREADS
    threads, and a chain's tile of doubles in shared memory."""
    lags = next((r for r in LAGS if 32 * r >= k_max), LAGS[-1])
    wpc = max(1, -(-k_max // (32 * lags)))
    if 32 * wpc > MAX_THREADS:
        raise NotImplementedError(
            f"the statistics kernel keeps up to "
            f"{MAX_THREADS // 32 * 32 * LAGS[-1]} lags (n_autocorr_window), "
            f"got {k_max}")
    cb = max(1, min(CHAINS_PER_BLOCK, MAX_THREADS // (32 * wpc), n_chains))
    return lags, wpc, cb, cb * (PAD + k_max + TILE) * 8


def record_attrs(k_max: int, n_chains: int, dtype=torch.float32):
    """Registers a thread, spilled bytes a thread and resident blocks and
    warps an SM of the kernel at its launch for a [n_chains, k_max] state
    (the card is needed)."""
    lags, wpc, cb, smem = record_launch(k_max, n_chains)
    return _cuda.kernel_attrs("mlmc_stats_record_attrs", 32 * wpc * cb,
                              int(dtype == torch.float64), lags, smem)


def record_block_cuda(state, Qs: torch.Tensor, v: int):
    """The statistics state after recording the leading ``v`` rows of the
    [T, C] block ``Qs`` (0 <= v <= T), as a tuple in ``StatsState``'s
    order, by one launch of the kernel.  The input state is left as it
    was."""
    n, n_lt = state.n, state.n_lt
    dtype = state.avg.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the statistics kernel takes float32 or float64 "
                        f"states, got {dtype}")
    C, K = state.ring.shape
    floats = [t.contiguous() for t in (state.avg, state.avg_lt,
                                       state.avg2_lt, state.avg3_lt,
                                       state.avg4_lt, state.ring, state.S_k)]
    for name, t in zip(FLOAT_FIELDS, floats):
        _cuda.require_cuda(name, t, (C, K) if t.dim() == 2 else (C,), dtype)
    _cuda.require_cuda("n", n.reshape(1), (1,), torch.int32)
    _cuda.require_cuda("n_lt", n_lt.reshape(1), (1,), torch.int32)
    if Qs.dim() != 2 or Qs.shape[1] != C:
        raise ValueError(f"Qs: expected a [T, {C}] block, got "
                         f"{tuple(Qs.shape)}")
    if Qs.device != n.device:
        raise ValueError(f"Qs: expected a tensor on {n.device}, got "
                         f"{Qs.device}")
    Qs = Qs.to(dtype)
    if Qs.stride(1) != 1 or Qs.stride(0) < C:
        Qs = Qs.contiguous()
    lags, wpc, cb, smem = record_launch(K, C)
    _cuda.check_smem(smem, n.device, f"the k_max={K} statistics record")
    n_out, n_lt_out = torch.empty_like(n), torch.empty_like(n_lt)
    out = [torch.empty_like(t) for t in floats]
    in_ptrs = (ctypes.c_void_p * 10)(
        Qs.data_ptr(), n.data_ptr(), n_lt.data_ptr(),
        *(t.data_ptr() for t in floats))
    out_ptrs = (ctypes.c_void_p * 9)(
        n_out.data_ptr(), n_lt_out.data_ptr(), *(t.data_ptr() for t in out))
    err = _cuda.load_library().mlmc_stats_record(
        in_ptrs, out_ptrs, C, K, max(Qs.stride(0), 1), int(v),
        int(dtype == torch.float64), lags, wpc, cb, smem,
        _cuda.stream_ptr(n.device))
    _cuda.check_status(err, "stats_record kernel launch")
    STATS.launches += 1
    return (n_out, out[0], n_lt_out, *out[1:])
