"""The host-side logic of the warp-per-chain HMC trajectory and rotor sweep
kernels (mlmcpathintegral_tpu_torch/csrc/hmc_trajectory.cu, rotor_sweep.cu).

1. The strided lane layout's sums.  The trajectory kernel puts site
   l + G k of a chain on lane l (slot k) and sums a lane's slots in pairs
   at distance S/2, S/4, .., 1, then over the lanes by a shuffle butterfly;
   the sweep kernel puts pair k on lane k mod 32 the same way and sums the
   winding sum's virtual threads (next_pow2(M/2) of them, at most 1024,
   each summing its pairs from 0) by the same tree.  ``strided_sum``
   below is a plain-torch model of those sums; it is held bit for bit
   against ``chain_sum``'s shared-memory tree (rng.cuh), the order the
   kernels' block-wide designs add in, in float32.  The model of the
   shuffles that bring each site its two neighbours (qm.cuh StridedRing,
   with the wrap of a padded ring) is held against a roll of the path.

2. The sweep kernel's pooled rejection.  A lane takes the first round of
   each of its draws of a half-sweep (up to four at a time); the draws
   still pending go to a queue that the warp drains breadth first, rounds
   ahead once fewer draws than lanes remain.  ``queue_schedule`` models
   that order on the rounds the plain version draws at path B2's kappa
   (I/a = 16) and k_rej = 8, and picks the sequential loop's round and
   proposal bit for bit, with the "no round accepts" case.

3. The launch functions choose the branch and layout from the shape at
   their boundaries, and take every M the block-per-chain kernels before
   them took.

Inputs are made with numpy from seeds; no card is needed."""

import math

import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops import hmc as thmc
from mlmcpathintegral_tpu_torch.ops import rotor as tpr
from mlmcpathintegral_tpu_torch.ops import schwinger as tps

torch.set_num_threads(1)

H100_SMEM_OPTIN = 232448
SUM_MS = (2, 30, 32, 64, 100, 256, 1024)


# ---- 1. strided sums --------------------------------------------------------

def tree_sum(v, tpc):
    """rng.cuh chain_sum: thread t holds v[t] (zeros past the values), and
    red[t] += red[t + off] for t < off, off = tpc/2 .. 1."""
    red = torch.zeros(tpc, dtype=torch.float32)
    red[:v.numel()] = v
    off = tpc // 2
    while off:
        red[:off] = red[:off] + red[off:2 * off]
        off //= 2
    return red[0]


def thread_partials(w, tpc):
    """The per-thread partials of a block-wide sum over more items than
    threads: thread t adds items t, t + tpc, .. to 0 in order."""
    part = torch.zeros(tpc, dtype=torch.float32)
    for t in range(min(tpc, w.numel())):
        acc = torch.zeros((), dtype=torch.float32)
        for k in range(t, w.numel(), tpc):
            acc = acc + w[k]
        part[t] = acc
    return part


def butterfly(lanes):
    """The shuffle butterfly over a chain's lanes (dim 0): at each offset
    every lane adds its partner's value, v_l + v_{l xor off}.  Returns
    every lane's result."""
    G = lanes.shape[0]
    off = G // 2
    while off:
        lanes = lanes + lanes[torch.arange(G) ^ off]
        off //= 2
    return lanes


def strided_sum(v, G, S):
    """The kernels' sum of the values v[t] of G S virtual threads: thread
    l + G k is slot k of lane l; a lane adds its slots in pairs at distance
    S/2 .. 1, then the butterfly adds over the lanes.  Returns every lane's
    result."""
    slots = torch.zeros(G * S, dtype=torch.float32)
    slots[:v.numel()] = v
    slots = slots.reshape(S, G).clone()                # [slot, lane]
    off = S // 2
    while off:
        slots[:off] = slots[:off] + slots[off:2 * off]
        off //= 2
    return butterfly(slots[0])


def _values(n, seed):
    """float32 values whose sum depends on the order of the adds."""
    rs = np.random.default_rng(seed)
    v = rs.standard_normal(n) * np.exp(rs.uniform(-8, 8, n))
    return torch.from_numpy(v.astype(np.float32))


def strided_layout(M):
    """(lanes, slots a lane) of qm.cuh StridedRing for M sites, and
    whether the trajectory kernel's launch takes it (its warp branch)."""
    n = _cuda.next_pow2(M)
    lanes = min(32, n)
    branch, l_, s_, _, _ = thmc.hmc_launch(M, 4096)
    if branch == "warp":
        assert (l_, s_) == (lanes, n // lanes)
    return lanes, n // lanes


@pytest.mark.parametrize("M", SUM_MS)
def test_trajectory_sums_keep_the_tree_order(M):
    """K5's T and S: the strided layout's sum equals the block branch's
    tree (thread t = site t) bit for bit, in every lane (the launch takes
    the layout up to 128 sites; the model holds for any M)."""
    lanes, sites = strided_layout(M)
    for seed in range(4):
        v = _values(M, seed)
        got = strided_sum(v, lanes, sites)
        want = tree_sum(v, _cuda.next_pow2(M))
        assert torch.equal(got, want.expand(lanes))


@pytest.mark.parametrize("M", SUM_MS + (2500, 4100))
def test_winding_sum_keeps_the_tree_order(M):
    """K8's W: the lanes' virtual threads (pairs t, t + tpc, .. from 0),
    their tree and the butterfly equal the block tree over next_pow2(M/2)
    threads (at most 1024) bit for bit."""
    H = M // 2
    tpc = min(1024, _cuda.next_pow2(H))
    P = min(32, tpc)
    for seed in range(4):
        w = _values(H, 100 + seed)
        part = thread_partials(w, tpc)
        got = strided_sum(part, P, tpc // P)
        assert torch.equal(got, tree_sum(part, tpc).expand(P))


def test_sum_order_is_seen():
    """The check can fail: a lane's slots summed in site order, or the
    values summed one after another, change the bits of some sums."""
    differs = 0
    for seed in range(16):
        v = _values(256, seed)
        tree = tree_sum(v, 256)
        in_order = butterfly(v.reshape(32, 8).sum(dim=1))[0]
        sequential = torch.zeros((), dtype=torch.float32)
        for x in v:
            sequential = sequential + x
        differs += int(not torch.equal(in_order, tree))
        differs += int(not torch.equal(sequential, tree))
    assert differs > 0


def ring_neighbours(x, G, S):
    """The shuffles of qm.cuh StridedRing on one chain's path x [M]: slot k
    of lane l reads slot k of lane l -+ 1, lane G - 1 sends its slot k - 1
    to lane 0 and lane 0 its slot k + 1 to lane G - 1; with padding (M < G
    S) sites M - 1 and 0 exchange values by two more.  Returns (x_{m-1},
    x_{m+1}) of every real site m."""
    M = x.numel()
    v = torch.full((G * S,), float("nan"), dtype=x.dtype)
    v[:M] = x
    v = v.reshape(S, G)                       # v[k, l] = site l + G k
    lane = torch.arange(G)
    k = torch.arange(S)[:, None]
    to_down = torch.where(lane == G - 1, v[(k + S - 1) % S, lane], v)
    to_up = torch.where(lane == 0, v[(k + 1) % S, lane], v)
    vm = to_down[:, (lane - 1) % G]
    vp = to_up[:, (lane + 1) % G]
    if M < G * S:
        last_lane, last_slot = (M - 1) % G, (M - 1) // G
        vm[0, 0] = v[last_slot, last_lane]
        vp[last_slot, last_lane] = v[0, 0]
    return vm.reshape(-1)[:M], vp.reshape(-1)[:M]


@pytest.mark.parametrize("M", list(range(1, 70)) + [100, 255, 256, 1000,
                                                     1023, 1024])
def test_strided_ring_neighbours(M):
    x = torch.from_numpy(np.random.default_rng(M).standard_normal(M))
    lanes, sites = strided_layout(M)
    vm, vp = ring_neighbours(x, lanes, sites)
    assert torch.equal(vm, torch.roll(x, 1))
    assert torch.equal(vp, torch.roll(x, -1))


# ---- 2. the sweep kernel's rejection ----------------------------------------

def _b2_rounds(monkeypatch, C=8, M=256, k_rej=8, seed=(5, 6)):
    """The rounds (proposal, accept) of every heat-bath draw of one rotor
    sweep step at path B2's kappa = I/a = 16, as the plain version draws
    them: per half-sweep [k_rej, C, M/2]."""
    seen = []

    def recording(prop, ok, _first=tps._first_accepted):
        seen.append((prop.clone(), ok.clone()))
        return _first(prop, ok)
    monkeypatch.setattr(tps, "_first_accepted", recording)
    x = torch.from_numpy(np.random.default_rng(9).uniform(
        -math.pi, math.pi, (C, M)).astype(np.float32))
    kappa = 0.25 / (4.0 / M)
    assert kappa == 16.0
    # a few steps, so that the path is smooth and tau ~ 2 kappa
    tpr.rotor_sweep_chain_plain(x, seed, kappa=kappa, M=M, n_steps=4,
                                k_rej=k_rej)
    monkeypatch.undo()
    return seen


def sequential_loop(prop, ok):
    """Each draw on its own: round after round until one accepts (prop,
    ok: [k, n]).  Returns (round taken or k, proposal or 0)."""
    k, n = ok.shape
    rounds, x = [], []
    for d in range(n):
        r = next((r for r in range(k) if ok[r, d]), k)
        rounds.append(r)
        x.append(prop[r, d] if r < k else torch.zeros((), dtype=prop.dtype))
    return torch.tensor(rounds), torch.stack(x)


def queue_schedule(prop, ok, lanes=32, chunk=4):
    """rotor_sweep.cu heatbath_lane_draws for one chain (prop, ok: [k, n]
    rounds of n draws): lane l's draws are l, l + lanes, ..; a chunk of
    ``chunk`` a lane at a time, each lane tests its draws' round 0, and the
    draws it rejects join a queue in draw order (a ballot a slot).  The
    warp then drains the queue in passes: n queued draws take the 32 lanes,
    W = 1 lane a draw while n >= 32, else W = 32 / next_pow2(n), the draw
    at the head of the queue on lanes 0 .. W-1 testing rounds r .. r+W-1;
    a draw whose W rounds all reject goes to the back of the queue at round
    r + W while rounds remain.  Returns (round taken or k, proposal or 0)
    of every draw and the passes of each chunk."""
    k, n = ok.shape
    rounds = torch.full((n,), k, dtype=torch.long)
    x = torch.zeros(n, dtype=prop.dtype)
    passes = []
    per_chunk = lanes * chunk
    for c0 in range(0, n, per_chunk):
        queue = []
        for q in range(chunk):
            for lane in range(lanes):
                d = c0 + q * lanes + lane
                if d >= n or k == 0:
                    continue
                if ok[0, d]:
                    rounds[d], x[d] = 0, prop[0, d]
                elif k > 1:
                    queue.append((d, 1))
        p = 0
        while queue:
            p += 1
            W = 1 if len(queue) >= lanes else lanes // _cuda.next_pow2(
                len(queue))
            taken, queue = queue[:lanes // W], queue[lanes // W:]
            for d, r in taken:
                hit = next((rr for rr in range(r, min(r + W, k))
                            if ok[rr, d]), None)
                if hit is not None:
                    rounds[d], x[d] = hit, prop[hit, d]
                elif r + W < k:
                    queue.append((d, r + W))
        passes.append(p)
    return rounds, x, passes


def lane_loop_passes(ok, lanes=32):
    """The passes a loop of each lane over its own draws would take: the
    warp waits for its busiest lane (the most rounds past the first)."""
    k, n = ok.shape
    first = torch.where(ok.any(dim=0), torch.argmax(ok.to(torch.int8),
                                                    dim=0), k - 1)
    return max(int(first[lane::lanes].sum()) for lane in range(lanes))


def test_queue_picks_the_sequential_loops_round(monkeypatch):
    halves = _b2_rounds(monkeypatch)
    assert len(halves) == 8                   # 4 steps x 2 parities
    later = passes = lane_passes = 0
    for prop, ok in halves:
        k, C, H = ok.shape
        for c in range(C):
            r_seq, x_seq = sequential_loop(prop[:, c], ok[:, c])
            r_q, x_q, p = queue_schedule(prop[:, c], ok[:, c])
            assert torch.equal(r_q, r_seq)
            assert torch.equal(x_q, x_seq)
            x_plain, acc_plain = tps._first_accepted(prop[:, c], ok[:, c])
            assert torch.equal(x_q, x_plain)
            assert torch.equal(r_q < k, acc_plain)
            later += int((r_seq >= 2).sum())
            passes += sum(p)
            lane_passes += lane_loop_passes(ok[:, c])
    # draws accepted past the second round are there, and the queue takes
    # fewer passes than lanes that each loop over their own draws
    assert later > 0
    assert passes < lane_passes
    # the Gaussian envelope accepts about 2/pi of the rounds at tau ~ 32
    prop, ok = halves[-1]
    assert 0.55 < float(ok[0].double().mean()) < 0.75


@pytest.mark.parametrize("n", [1, 5, 31, 32, 100, 128, 300])
def test_queue_no_round_accepts(n):
    """Draws that no round accepts keep their site (round k, proposal 0),
    at every queue length (rounds ahead on 1 .. 32 lanes a draw) and over
    several chunks."""
    rs = np.random.default_rng(n)
    k = 8
    prop = torch.from_numpy(rs.uniform(-3, 3, (k, n)).astype(np.float32))
    ok = torch.from_numpy(rs.uniform(size=(k, n)) < 0.3)
    ok[0] = False
    ok[:, ::5] = False
    r_seq, x_seq = sequential_loop(prop, ok)
    r_q, x_q, _ = queue_schedule(prop, ok)
    assert torch.equal(r_q, r_seq) and torch.equal(x_q, x_seq)
    assert bool((r_q[::5] == k).all()) and bool((x_q[::5] == 0).all())


def test_queue_at_k_rej_one(monkeypatch):
    """k_rej = 1: the first round alone decides; nothing is queued."""
    (prop, ok), *_ = _b2_rounds(monkeypatch, C=2, k_rej=1)
    r_seq, x_seq = sequential_loop(prop[:, 0], ok[:, 0])
    r_q, x_q, passes = queue_schedule(prop[:, 0], ok[:, 0])
    assert torch.equal(r_q, r_seq) and torch.equal(x_q, x_seq)
    assert passes == [0]


# ---- 3. the launch functions ------------------------------------------------

@pytest.mark.parametrize("M, C, want", [
    (1, 64, ("warp", 1, 1, 64, 0)),
    (2, 64, ("warp", 2, 1, 64, 0)),
    (16, 4096, ("warp", 16, 1, 8, 0)),
    (30, 4096, ("warp", 32, 1, 4, 0)),
    (32, 4096, ("warp", 32, 1, 4, 0)),       # path C's coarse launch
    (33, 4096, ("warp", 32, 2, 4, 0)),
    (64, 8192, ("warp", 32, 2, 4, 0)),       # path D's launch
    (100, 4096, ("warp", 32, 4, 4, 0)),
    (128, 4096, ("warp", 32, 4, 4, 0)),      # the register branch's largest
    (8, 3, ("warp", 8, 1, 4, 0)),            # few chains: one warp a block
    (129, 64, ("block", 256, 0, 1, 4 * (2 * 129 + 256))),
    (1025, 64, ("block", 1024, 0, 1, 4 * (2 * 1025 + 1024))),
    (20_000, 8, ("block", 1024, 0, 1, 4 * (2 * 20_000 + 1024))),
])
def test_hmc_launch_layout(M, C, want):
    got = thmc.hmc_launch(M, C)
    assert got == want
    branch, lanes, sites, cpb, smem = got
    if branch == "warp":
        assert lanes * sites == _cuda.next_pow2(M)
        assert sites <= thmc.SITES_MAX
        assert (lanes * cpb) % 32 == 0 or lanes * cpb < 32
        assert lanes * cpb <= 32 * _cuda.WARPS_PER_BLOCK
    else:
        assert (lanes, cpb) == (min(1024, _cuda.next_pow2(M)), 1)


def test_hmc_launch_takes_every_M_the_block_design_took():
    """The block-per-chain design took every M whose chain fit one block's
    shared memory (x, p and a slot a thread); each still runs: on the warp
    branch (no shared memory) or on the block branch with the same bytes."""
    took = 0
    for M in range(1, 29_100):
        tpc, cpb = _cuda.block_layout(M)
        cpb = max(1, min(cpb, 4096))
        parent = 4 * (cpb * 2 * M + tpc * cpb)
        branch, _, _, _, smem = thmc.hmc_launch(M, 4096)
        if parent <= H100_SMEM_OPTIN:
            took += 1
            assert smem <= H100_SMEM_OPTIN
            assert (branch == "warp") == (M <= 32 * thmc.SITES_MAX)
    assert took > 28_000


def _slice(words, M, pool=768):
    """Bytes of a sweep chain's slice: table, path, queue or scratch."""
    return 4 * (words + M + pool)


@pytest.mark.parametrize("M, C, want", [
    (2, 64, (4, 4 * _slice(96, 2), 96)),
    (24, 64, (4, 4 * _slice(96, 24), 96)),     # ragged: idle lanes
    (32, 4096, (4, 4 * _slice(96, 32), 96)),
    (34, 4096, (4, 4 * _slice(96, 34), 96)),
    (64, 4096, (4, 4 * _slice(96, 64), 96)),
    (100, 4096, (4, 4 * _slice(96, 100), 96)),
    (256, 4096, (4, 4 * _slice(96, 256), 96)),  # path B2
    (16, 3, (3, 3 * _slice(96, 16), 96)),       # few chains
    # the winding sum's scratch over the queue where it is the larger
    (3000, 64, (2, 2 * _slice(96, 3000, 1024), 96)),
    (20_000, 8, (1, _slice(96, 20_000, 1024), 96)),
    (57_088, 8, (1, _slice(0, 57_088, 1024), 0)),  # no room for words
])
def test_sweep_launch_layout(M, C, want):
    """(chains a block, shared bytes, table words): a warp a chain, whole
    warps a block, at most four, fewer where 48 KB or the chains run out."""
    got = tpr.sweep_launch(M, C, H100_SMEM_OPTIN)
    assert got == want
    cpb, smem, _ = got
    assert cpb <= _cuda.WARPS_PER_BLOCK
    assert smem <= max(_cuda.SMEM_DEFAULT, smem // cpb)


def test_sweep_launch_takes_every_M_the_block_design_took():
    """The block-per-chain design (a thread a site pair) took every even M
    whose path and reduction slots fit one block; each still fits."""
    took = 0
    for M in range(2, 60_000, 2):
        tpc, cpb = _cuda.block_layout(M // 2)
        cpb = max(1, min(cpb, 4096))
        parent = 4 * (cpb * M + tpc * cpb)
        smem = tpr.sweep_launch(M, 4096, H100_SMEM_OPTIN)[1]
        if parent <= H100_SMEM_OPTIN:
            took += 1
            assert smem <= H100_SMEM_OPTIN, M
    assert took == 57_088 // 2
    with pytest.raises(ValueError, match="even"):
        tpr.sweep_launch(25, 64, H100_SMEM_OPTIN)
