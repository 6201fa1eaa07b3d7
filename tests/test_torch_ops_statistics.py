"""The statistics kernel (``csrc/statistics.cu``, ``ops/statistics.py``).

On the CPU: the module imports without a card, a state on the CPU takes
the plain version (the kernel's counter does not move), the launch layout
at its boundaries, and a numpy model of the kernel's arithmetic (the
ring-and-block series staged a tile at a time, each lag summed in double
by one thread over a register window slid over t, the moments lane-strided
and met in a butterfly) against the plain version and a float64
recomputation.  On the card (marker ``chip``): the kernel against the
plain version, the model's bits and (float32 states) the float64
recomputation at the cells' shapes and the edge cases, its rows across
chain counts and slices, the input state unchanged, and a fused 8x8 MLMC
whose every record goes through the kernel, three launches a
``level{l}.stats`` span."""

import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu_torch.ops import statistics as ops_stats
from mlmcpathintegral_tpu_torch.utils import statistics as st

torch.set_num_threads(1)

F32_EPS = float(np.finfo(np.float32).eps)


def _series(T, C, seed, rho=0.8, offset=0.3):
    """AR(1) chains, [T, C] float64: a real autocorrelation for the lags."""
    rs = np.random.default_rng(seed)
    x = np.empty((T, C))
    x[0] = rs.normal(size=C)
    for t in range(1, T):
        x[t] = rho * x[t - 1] + rs.normal(size=C)
    return x + offset


def _state(C, K, history, dtype, device, seed=0):
    """A state that has recorded ``history`` AR(1) samples (plain version,
    float64 on the CPU, then cast: every field a value of ``dtype``)."""
    s = st.init(C, K, torch.float64, device="cpu")
    if history:
        s = st.record_block_plain(
            s, torch.from_numpy(_series(history, C, seed + 1000)))
    return st.StatsState(*(t.to(device=device, dtype=dtype)
                           if t.is_floating_point() else t.to(device)
                           for t in s))


# -- the kernel's arithmetic, modelled in numpy -------------------------------


def kernel_model(state, Q, v, tile=ops_stats.TILE):
    """The float32 kernel's update, operation for operation, in numpy
    float64: returns the new state as numpy arrays in ``StatsState``'s
    order.  A product of two float32 values is exact in double, so the
    kernel's fma is a multiply and an add here; ``tile`` (a multiple of 32)
    is the samples staged at a time."""
    n, avg, n_lt, a1, a2, a3, a4, ring, S = (
        t.cpu().numpy() for t in state)
    n, n_lt = int(n), int(n_lt)
    C, K = ring.shape
    Q = np.asarray(Q, np.float32)
    if v == 0:
        return (n, avg, n_lt, a1, a2, a3, a4, ring, S)
    lags, wpc, _, _ = ops_stats.record_launch(K, C)
    ext = np.concatenate([ring[:, ::-1], Q[:v].T], axis=1).astype(np.float64)
    P = np.zeros((C, 32 * wpc * lags))
    m = np.zeros((4, C, 32))
    for ts in range(0, v, tile):
        tn = min(tile, v - ts)
        buf = np.concatenate([np.zeros((C, ops_stats.PAD)),
                              ext[:, ts:ts + K + tn]], axis=1)
        base = ops_stats.PAD + K

        def b(i):
            return buf[:, base + i]
        for k0 in range(0, K, lags):
            win = [None] * lags
            for r in range(1, lags):
                win[lags - r] = b(-k0 - r)
            t = 0
            while t + lags <= tn:
                for u in range(lags):
                    win[u] = b(t + u - k0)
                    q = b(t + u)
                    for r in range(lags):
                        P[:, k0 + r] = P[:, k0 + r] + q * win[(u - r) % lags]
                t += lags
            for t in range(t, tn):
                q = b(t)
                for r in range(lags):
                    P[:, k0 + r] = P[:, k0 + r] + q * b(t - k0 - r)
        for t in range(tn):
            q = b(t)
            q2 = q * q
            for i, x in enumerate((q, q2, q2 * q, q2 * q2)):
                m[i, :, t % 32] = m[i, :, t % 32] + x
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        m = m + m[:, :, lanes ^ off]
    s = m[:, :, 0]
    f32 = np.float32
    nn, nl = float(max(n + v, 1)), float(max(n_lt + v, 1))
    mom = [((float(n) * avg.astype(np.float64) + s[0]) / nn).astype(f32)]
    for a, si in zip((a1, a2, a3, a4), s):
        mom.append(((float(n_lt) * a.astype(np.float64) + si) / nl)
                   .astype(f32))
    k = np.arange(K)
    n_new = n_lt + v - k
    S_new = np.where(
        n_new > 0,
        ((np.maximum(n_lt - k, 0) * S.astype(np.float64) + P[:, :K])
         / np.maximum(n_new, 1)).astype(f32), S)
    ring_new = np.where(k < v, Q[np.clip(v - 1 - k, 0, None)].T,
                        ring[:, np.clip(k - v, 0, K - 1)])
    return (n + v, mom[0], n_lt + v, *mom[1:], ring_new, S_new)


def _fields(state):
    return [t.cpu().numpy() for t in state]


#: (name, chains, k_max, T, n_valid, history): the model's cases, at the
#: tile the test stages (32) so that the tiles' seams show at small T
MODEL_CASES = [
    ("window_100", 5, 100, 70, None, 130),
    ("partial", 4, 100, 70, 41, 130),
    ("fresh_short", 3, 100, 37, None, 0),
    ("history_short", 3, 20, 45, None, 7),
    ("lags_1", 6, 20, 65, None, 40),
    ("lags_3_edge", 4, 33, 64, 63, 40),
    ("lags_7_two_warps", 2, 300, 40, None, 310),
    ("one_sample", 7, 20, 1, None, 3),
    ("none", 3, 20, 9, 0, 30),
]


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_kernel_model_matches_plain(case):
    """The modelled kernel agrees with the plain float32 version within its
    rounding, exactly on the ring and counters, and lies within one float32
    step of the float64 recomputation, no farther than the plain version."""
    _, C, K, T, n_valid, hist = case
    state = _state(C, K, hist, torch.float32, "cpu")
    Q = torch.from_numpy(_series(T, C, 7)).to(torch.float32)
    v = T if n_valid is None else n_valid
    model = kernel_model(state, Q.numpy(), v, tile=32)
    plain = _fields(st.record_block_plain(state, Q, n_valid))
    exact = _fields(st.record_block_plain(
        st.StatsState(*(t.double() if t.is_floating_point() else t
                        for t in state)), Q.double(), n_valid))
    for i, name in enumerate(st.StatsState._fields):
        if name in ("n", "n_lt", "ring"):
            np.testing.assert_array_equal(model[i], plain[i], err_msg=name)
            continue
        step = np.spacing(np.abs(exact[i]).astype(np.float32))
        err_model = np.abs(model[i] - exact[i])
        err_plain = np.abs(plain[i] - exact[i])
        assert np.all(err_model <= step), name
        assert err_model.max() <= err_plain.max() + 1e-300, name


@pytest.mark.parametrize("k_max", [1, 20, 32, 33, 64, 96, 97, 100, 224,
                                   225, 1000, 1792])
@pytest.mark.parametrize("chains", [1, 3, 8, 8192])
def test_record_launch(k_max, chains):
    """Odd lags a thread, the window held by the chain's warps, at most 256
    threads and 8 chains a block, a chain's tile of doubles in shared
    memory."""
    lags, wpc, cb, smem = ops_stats.record_launch(k_max, chains)
    assert lags % 2 == 1 and 32 * wpc * lags >= k_max
    assert wpc == 1 or 32 * (wpc - 1) * lags < k_max
    assert 32 * wpc * cb <= ops_stats.MAX_THREADS
    assert 1 <= cb <= min(chains, ops_stats.CHAINS_PER_BLOCK)
    assert smem == cb * (ops_stats.PAD + k_max + ops_stats.TILE) * 8


def test_record_launch_refuses_a_window_past_the_block():
    with pytest.raises(NotImplementedError, match="1792"):
        ops_stats.record_launch(1793, 64)


def test_cpu_state_takes_the_plain_version():
    """A CPU state: the plain version, bit for bit, and no launch or plain
    call on the card counted; a CUDA-less process imports the module (this
    one has no card)."""
    state = _state(6, 20, 30, torch.float32, "cpu")
    Q = torch.from_numpy(_series(25, 6, 3)).to(torch.float32)
    ops_stats.STATS.reset()
    for got, want in zip(st.record_block(state, Q, 17),
                         st.record_block_plain(state, Q, 17)):
        assert torch.equal(got, want)
    assert ops_stats.STATS.launches == 0
    assert ops_stats.STATS.plain_cuda_calls == 0


# -- on the card --------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mlmcpathintegral_tpu_torch.ops import _cuda
    _cuda.build()
    return torch.device("cuda")


#: (name, chains, k_max, T, n_valid, history, dtype): the cells' shapes at
#: fewer chains (8x8: Y at T 256 and the traces at 2048, k_max 100; 64x64:
#: the traces at 8100, k_max 64), T = 1, T < k_max, a fresh state, n_valid
#: 0 and partial, a series past one block's shared memory, a window of
#: several warps, and float64
CARD_CASES = [
    ("y_8x8", 512, 100, 256, 256, 300, torch.float32),
    ("trace_8x8", 256, 100, 2048, None, 2048, torch.float32),
    ("trace_64x64", 64, 64, 8100, None, 8100, torch.float32),
    ("y_partial_short_history", 333, 100, 256, 100, 50, torch.float32),
    ("n_valid_0", 64, 100, 256, 0, 300, torch.float32),
    ("fresh_short_block", 100, 100, 37, None, 0, torch.float32),
    ("one_sample", 257, 20, 1, None, 5, torch.float32),
    ("past_shared_memory", 16, 100, 20000, None, 10, torch.float32),
    ("window_five_warps", 24, 1000, 3000, 2900, 1500, torch.float32),
    ("lags_3_edge", 40, 33, 700, 650, 40, torch.float32),
    ("trace_8x8_f64", 64, 100, 2048, None, 2048, torch.float64),
    ("trace_64x64_f64", 32, 64, 8100, 8000, 100, torch.float64),
    ("one_sample_f64", 65, 20, 1, None, 0, torch.float64),
]


@pytest.mark.chip
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_kernel_against_plain_and_oracle(card, case):
    """Ring and counters equal the plain version's; moments and S_k agree
    with it within its rounding (the plain version sums the products in
    the state's type, in PyTorch's order, so its error grows with T: 64
    eps sqrt(T) of the field's scale, eps the state's).  A float32 state's
    error against the float64 recomputation is no larger than the plain
    version's, and within one float32 step."""
    _, C, K, T, n_valid, hist, dtype = case
    state = _state(C, K, hist, dtype, card)
    Q = torch.from_numpy(_series(T, C, 11)).to(dtype=dtype, device=card)
    before = [t.clone() for t in state]
    Q_before = Q.clone()
    ops_stats.STATS.reset()
    got = st.record_block(state, Q, n_valid)
    assert ops_stats.STATS.launches == 1
    for a, b in zip(state, before):
        assert torch.equal(a, b)
    assert torch.equal(Q, Q_before)
    plain = st.record_block_plain(state, Q, n_valid)
    oracle = None
    if dtype == torch.float32:
        oracle = dict(zip(st.StatsState._fields, _fields(
            st.record_block_plain(st.StatsState(
                *(t.double() if t.is_floating_point() else t
                  for t in state)), Q.double(), n_valid))))
    eps = float(torch.finfo(dtype).eps)
    for name, g, p in zip(st.StatsState._fields, got, plain):
        if name in ("n", "n_lt", "ring"):
            assert torch.equal(g, p), name
            continue
        g, p = g.cpu().numpy(), p.cpu().numpy()
        scale = max(float(np.abs(p).max()), 1e-30)
        np.testing.assert_allclose(g, p, rtol=0,
                                   atol=64 * eps * np.sqrt(T) * scale,
                                   err_msg=name)
        if oracle is None:
            continue
        ref = oracle[name]
        err_g = np.abs(g - ref).max()
        err_p = np.abs(p - ref).max()
        assert err_g <= err_p, (name, float(err_g), float(err_p))
        step = np.spacing(np.abs(ref).astype(np.float32))
        assert np.all(np.abs(g - ref) <= step), name


@pytest.mark.chip
def test_kernel_bits_equal_the_model(card):
    """The kernel's float32 update is the CPU model's, bit for bit, at the
    kernel's own tile, across tiles and two lag widths."""
    for C, K, T, n_valid, hist in ((9, 100, 1100, None, 150),
                                   (5, 33, 600, 517, 20)):
        state = _state(C, K, hist, torch.float32, card)
        Q = torch.from_numpy(_series(T, C, 5)).to(torch.float32)
        v = T if n_valid is None else n_valid
        got = _fields(st.record_block(state, Q.to(card), n_valid))
        for name, g, m in zip(st.StatsState._fields, got,
                              kernel_model(state, Q.numpy(), v)):
            np.testing.assert_array_equal(g, m, err_msg=name)


@pytest.mark.chip
def test_rows_the_same_across_chain_counts(card):
    """A chain's row has the same bits whatever the chains beside it: the
    whole launch against slices of it (other launch shapes, chains a
    block), float32 and float64."""
    for dtype in (torch.float32, torch.float64):
        C, K, T = 333, 100, 2048
        state = _state(C, K, 400, dtype, card)
        Q = torch.from_numpy(_series(T, C, 3)).to(dtype=dtype, device=card)
        whole = st.record_block(state, Q, 1500)
        for lo, hi in ((0, 1), (1, 4), (4, 12), (12, 333), (100, 229)):
            part = st.StatsState(*(t[lo:hi] if t.dim() else t
                                   for t in state))
            got = st.record_block(part, Q[:, lo:hi], 1500)
            for name, g, w in zip(st.StatsState._fields, got, whole):
                assert torch.equal(g, w[lo:hi] if w.dim() else w), \
                    (name, lo, hi, dtype)


@pytest.mark.chip
def test_record_and_record_masked(card):
    """T = 1: ``record`` launches the kernel; ``record_masked`` with a
    device flag records where it is true and leaves the state's bits where
    it is false, with no host read; a strided block (the coarsest level's
    Y, every t_sub-th trace row) is read in place."""
    state = _state(300, 100, 40, torch.float32, card)
    q = torch.from_numpy(_series(1, 300, 9)[0]).to(torch.float32).to(card)
    ops_stats.STATS.reset()
    one = st.record(state, q)
    on = st.record_masked(state, q, torch.tensor(True, device=card))
    off = st.record_masked(state, q, torch.tensor(False, device=card))
    assert ops_stats.STATS.launches == 3
    assert ops_stats.STATS.plain_cuda_calls == 0
    for a, b, c, d in zip(one, on, off, state):
        assert torch.equal(a, b) and torch.equal(c, d)
    assert int(one.n_lt) == 41
    trace = torch.from_numpy(_series(2048, 300, 4)).to(torch.float32)
    trace = trace.to(card)
    y = trace[7::8]
    for a, b in zip(st.record_block(state, y, 200),
                    st.record_block(state, y.contiguous(), 200)):
        assert torch.equal(a, b)


@pytest.mark.chip
def test_fused_mlmc_records_through_the_kernel(card):
    """A fused 8x8 two-level MLMC (window 100, chunk 256: the Y record at T
    256 and the traces at T 256 t_sub): no plain call on the
    card, and under the profiler every ``level{l}.stats`` span carries
    ``stats_launches`` = 3."""
    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        make_schwinger_conditioned_fine_action,
    )
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.mc import MonteCarloMultiLevel
    from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
    from mlmcpathintegral_tpu_torch.samplers import (
        OverrelaxedHeatBathSampler,
    )
    from mlmcpathintegral_tpu_torch.utils import timer

    act = QuenchedSchwingerAction(
        Lattice2D(8, 8, CoarseningType.BOTH), beta=4.0,
        renormalisation=RenormalisationType.NONPERTURBATIVE)

    def factory(a):
        return OverrelaxedHeatBathSampler(a, n_sweep_heatbath=1,
                                          n_sweep_overrelax=1, n_burnin=100,
                                          use_pallas=True)
    C = 256
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility, coarse_sampler_factory=factory,
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=100, n_samples=4 * 256 * C,
        n_autocorr_window=100, n_min_samples_qoi=1000, chunk_size=256,
        use_pallas=True)
    ops.reset_counters()
    mc.evaluate(torch.Generator().manual_seed(5), n_chains=C,
                dtype=torch.float32, device=card)
    carries, carry_L = mc.final_carries
    carries = list(carries) + [carry_L]
    fns = [mc._chunk(ell) for ell in range(2)]
    timer.clear()
    seed = torch.tensor([123, 456], dtype=torch.int32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        for _ in range(3):
            for ell in (1, 0):
                carries[ell], _ = fns[ell](seed, carries[ell], 256)
        torch.cuda.synchronize()
    spans = [s for s in timer.spans() if s.name.endswith(".stats")]
    timer.clear()
    assert sorted({s.name for s in spans}) == ["level0.stats",
                                               "level1.stats"]
    assert len(spans) == 6
    assert all(s.attrs["stats_launches"] == 3 for s in spans)
    assert ops_stats.STATS.launches > 6
    assert ops_stats.STATS.plain_cuda_calls == 0
