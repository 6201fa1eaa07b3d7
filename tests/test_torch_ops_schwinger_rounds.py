"""The host-side logic of the warp-per-chain Schwinger kernels
(mlmcpathintegral_tpu_torch/csrc/schwinger_sweep.cu, schwinger_twolevel.cu).

1. The lane-parallel rejection.  In a link group (or a fill phase) the
   lanes an item leaves idle run its rejection rounds ahead: the W lanes of
   an item evaluate rounds rb .. rb + W - 1 together, and a ballot takes
   the lowest lane whose round accepts (``schwinger_sweep.cuh``
   ``first_accepted``).  ``lane_groups`` below is a plain-torch model of
   that loop; it is held bit for bit, draws and "no round accepted" flags,
   against the sequential loop the parent kernels ran (stop at the first
   accepted round, at most k rounds) and against the plain versions'
   ``_first_accepted``, on the rounds the plain versions draw: the ExpCos
   rejection at the main path's k_rej 6 (coarsest sweeps), 8 (coarse sweeps
   of the two-level kernel) and 16 (the fill), and the BesselProduct draw
   at 16 and 48, in both its branches.  A round reads no field value, so
   the rounds a loop of k rounds draws are the first k of a longer one:
   truncating at k equals the plain version run with k_rej = k.

2. The launch function of each kernel picks the warp design, the
   block-wide branch or the global-memory branch from the shape, the chain
   count and the opt-in limit, at their boundaries.

Inputs are made with numpy from seeds; no card is needed."""

import math

import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops import schwinger as tps
from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as ttl
from mlmcpathintegral_tpu_torch.ops.rng import CounterRng, element_ids

torch.set_num_threads(1)

H100_SMEM_OPTIN = 232448
SEED1, SEED2 = 20240611, 2 ** 32 - 777
N_ELEMENTS = 4096
#: the lanes an item can get from a warp (lanes_per_item: a power of two)
LANES = (1, 2, 4, 8, 16, 32)


def lane_groups(prop, ok, W):
    """The CUDA loop ``first_accepted`` over rounds on dim 0: rounds are
    evaluated W at a time (lane q of a group takes round rb + q, lanes past
    the last round hold no round), and the lowest lane whose round accepts
    gives the proposal.  Returns (x, accepted), x = 0 where no round of the
    loop accepts."""
    k = prop.shape[0]
    x = torch.zeros_like(prop[0])
    acc = torch.zeros_like(ok[0])
    for rb in range(0, k, W):
        hits = ok[rb:rb + W]                       # the group's ballot
        take = hits.any(dim=0) & ~acc
        first = torch.argmax(hits.to(torch.int8), dim=0, keepdim=True)
        x = torch.where(take, torch.gather(prop[rb:rb + W], 0, first)[0], x)
        acc = acc | take
    return x, acc


def sequential(prop, ok):
    """The parent kernels' loop: round after round until one accepts."""
    x = torch.zeros_like(prop[0])
    acc = torch.zeros_like(ok[0])
    for r in range(prop.shape[0]):
        take = ok[r] & ~acc
        x = torch.where(take, prop[r], x)
        acc = acc | take
    return x, acc


def _rng():
    site, chain = element_ids((N_ELEMENTS // 4,), 4, "cpu")
    return CounterRng(SEED1, site, chain, SEED2, step=5)


def _capture(monkeypatch, module):
    """Record the (proposals, accept flags) of every round that the plain
    version's ``_first_accepted`` picks from, in ``module``."""
    seen = []

    def recording(prop, ok, _first=module._first_accepted):
        seen.append((prop.clone(), ok.clone()))
        return _first(prop, ok)
    monkeypatch.setattr(module, "_first_accepted", recording)
    return seen


def _expcos_rounds(monkeypatch, k_rej):
    """The ExpCos rejection's rounds at taus that cover both envelopes
    (uniform below 0.45, Gaussian above) and beta up to 10."""
    rs = np.random.default_rng(k_rej)
    tau = torch.from_numpy(np.concatenate([
        rs.uniform(0.0, 0.45, N_ELEMENTS // 4),
        rs.uniform(0.45, 40.0, 3 * N_ELEMENTS // 4)]).astype(np.float32))
    tau = tau.reshape(4, N_ELEMENTS // 4)
    seen = _capture(monkeypatch, tps)
    out = tps._expcos_rejection(_rng(), tau, k_rej, torch.float32)
    (prop, ok), = seen
    return prop, ok, out, lambda k: tps._expcos_rejection(
        _rng(), tau, k, torch.float32)


def _bessel_rounds(monkeypatch, k_rej, beta):
    """The BesselProduct draw's rounds at staples over the circle: beta=4
    (the main path, 4 words a round) or beta=0.25 (the small-beta branch,
    2 words a round)."""
    rs = np.random.default_rng(int(10 * beta) + k_rej)
    x_p, x_m = (torch.from_numpy(rs.uniform(-math.pi, math.pi, N_ELEMENTS)
                                 .astype(np.float32)).reshape(4, -1)
                for _ in range(2))
    exact, _, log_i0_2beta, sigma_beta = ttl.fill_constants(beta)
    assert exact
    seen = _capture(monkeypatch, ttl)

    def draw(k):
        return ttl._bessel_draw(_rng(), x_p, x_m, beta, log_i0_2beta,
                                sigma_beta, k, torch.float32)
    out = draw(k_rej)
    (prop, ok), = seen
    sign = torch.where(x_m - x_p < 0, -1.0, 1.0)
    # the draw the kernel writes from a first-round proposal x
    return prop, ok, out, draw, lambda x: tps._mod_2pi(sign * x + x_p)


CASES = [("expcos", 6, None), ("expcos", 8, None), ("expcos", 16, None),
         ("bessel", 16, 4.0), ("bessel", 48, 4.0), ("bessel", 48, 0.25)]


@pytest.mark.parametrize("W", LANES)
@pytest.mark.parametrize("kind, k_rej, beta", CASES)
def test_lane_groups_pick_the_sequential_loops_round(monkeypatch, kind,
                                                     k_rej, beta, W):
    if kind == "expcos":
        prop, ok, (x_plain, acc_plain), _ = _expcos_rounds(monkeypatch,
                                                           k_rej)
        finish = None
    else:
        prop, ok, (x_plain, acc_plain), _, finish = _bessel_rounds(
            monkeypatch, k_rej, beta)
    assert prop.shape[0] == k_rej
    x_seq, acc_seq = sequential(prop, ok)
    x_lane, acc_lane = lane_groups(prop, ok, W)
    assert torch.equal(acc_lane, acc_seq) and torch.equal(acc_lane,
                                                          acc_plain)
    assert torch.equal(x_lane, x_seq)
    if finish is None:
        assert torch.equal(x_lane, x_plain)
    else:
        assert torch.equal(finish(x_lane), x_plain)
    # the cases the loop has to get right are there: draws accepted at
    # round 3 or later (past the first group of one, two and three lanes)
    # and, at the shortest loops, draws that no round accepts
    first = torch.where(ok.any(dim=0),
                        torch.argmax(ok.to(torch.int8), dim=0), k_rej)
    assert int(first[acc_seq].max()) >= 3
    if (kind, k_rej) in (("expcos", 6), ("bessel", 16)):
        assert int((~acc_lane).sum()) > 0


@pytest.mark.parametrize("k_trunc", (1, 3, 6, 8, 16))
@pytest.mark.parametrize("kind", ("expcos", "bessel"))
def test_truncation_equals_the_shorter_loop(monkeypatch, kind, k_trunc):
    """A loop of k rounds draws the first k rounds of a longer one: the
    lane groups on the first k rounds of a 48-round loop give the plain
    version run with k_rej = k, draws and flags, and their no-accept
    draws are those whose first accepted round is k or later."""
    if kind == "expcos":
        prop, ok, _, shorter = _expcos_rounds(monkeypatch, 48)
        finish = None
    else:
        prop, ok, _, shorter, finish = _bessel_rounds(monkeypatch, 48, 4.0)
    monkeypatch.undo()
    x_plain, acc_plain = shorter(k_trunc)
    first = torch.where(ok.any(dim=0),
                        torch.argmax(ok.to(torch.int8), dim=0), 48)
    for W in LANES:
        x, acc = lane_groups(prop[:k_trunc], ok[:k_trunc], W)
        assert torch.equal(acc, acc_plain)
        assert torch.equal(~acc, first >= k_trunc)
        assert torch.equal(x if finish is None else finish(x), x_plain)
    if k_trunc <= 6:
        assert int((~acc_plain).sum()) > 0


def test_no_round_accepts():
    """All rounds rejected: every lane group reports no accepted round and
    x = 0, as the sequential loop does (the K3 link stays, the K4 cell
    force-rejects)."""
    rs = np.random.default_rng(3)
    prop = torch.from_numpy(rs.uniform(-3, 3, (48, 256)).astype(np.float32))
    ok = torch.zeros_like(prop, dtype=torch.bool)
    ok[:, ::2] = torch.from_numpy(rs.uniform(size=(48, 128)) < 0.05)
    for k in (6, 8, 16, 48):
        x_seq, acc_seq = sequential(prop[:k], ok[:k])
        for W in LANES:
            x, acc = lane_groups(prop[:k], ok[:k], W)
            assert torch.equal(acc, acc_seq) and torch.equal(x, x_seq)
            assert not bool(acc[1::2].any())
            assert bool((x[1::2] == 0).all())


# ---- the launch functions ------------------------------------------------

@pytest.mark.parametrize("Mx, Mt, n_chains, branch, lanes, cpb", [
    (4, 4, 1024, "warp", 32, 4),     # the main path's coarsest level
    (2, 2, 10, "warp", 8, 12),       # four chains a warp, three warps
    (8, 8, 1024, "warp", 32, 4),     # 64 sites: two a lane, the largest
    (8, 8, 64, "warp", 32, 4),
    (8, 16, 64, "block", 128, 1),    # 128 sites: a chain a block
    (1, 48, 64, "block", 64, 1),     # a row of 48 links: a group > 32
    (128, 128, 64, "block", 1024, 1),
    (256, 256, 64, "global", 1024, 1),
])
def test_sweep_launch_branches(Mx, Mt, n_chains, branch, lanes, cpb):
    got = tps.sweep_launch(Mt, Mx, n_chains, H100_SMEM_OPTIN)
    # a block row's lanes: the threads a chain of the one-site-a-thread
    # block, whose team takes at most TEAM_THREADS_MAX of them
    if branch == "block":
        lanes = min(lanes, tps.TEAM_THREADS_MAX)
    assert got[3] == branch and got[:2] == (lanes, cpb)
    nsites = Mx * Mt
    assert (tps.warp_lanes(Mx, Mt) is not None) == (branch == "warp")
    if branch == "warp":
        # two lanes a site up to a warp, whole warps in a block of <= 4,
        # every link group within the chain's lanes
        assert lanes == min(32, _cuda.next_pow2(2 * nsites))
        assert max(-(-Mx // 2) * Mt, Mx * -(-Mt // 2)) <= lanes
        assert lanes * cpb <= 32 * _cuda.WARPS_PER_BLOCK
        assert (lanes * cpb) % 32 == 0 or lanes * cpb < 32
        assert got[2] == 4 * cpb * (tps.SWEEP_WORDS + 2 * nsites)
    elif branch == "block":
        assert got[2] == 4 * (tps.SWEEP_WORDS + 2 * nsites + 2 * lanes)
        assert got[2] <= H100_SMEM_OPTIN
    else:
        assert tps.sweep_smem_bytes(Mt, Mx, n_chains)[2] > H100_SMEM_OPTIN
        assert got[2] == 4 * (tps.SWEEP_WORDS + 2 * lanes)
    # a smaller opt-in limit moves a shared-memory field to global memory
    if branch != "global":
        assert tps.sweep_launch(Mt, Mx, n_chains, got[2] - 4)[3] == "global"


@pytest.mark.parametrize("Mx, Mt, n_chains, branch, lanes, cpb", [
    (8, 8, 1024, "warp", 32, 4),     # the main path's fine level
    (4, 4, 3, "warp", 8, 4),         # 4 cells: four chains a warp
    (16, 16, 64, "warp", 32, 4),     # 64 cells: the largest
    (16, 18, 64, "block", 128, 1),   # 72 cells: a chain a block
    (128, 128, 64, "block", 1024, 1),
])
def test_twolevel_launch_branches(Mx, Mt, n_chains, branch, lanes, cpb):
    got = ttl.twolevel_launch(Mt, Mx, n_chains)
    # a block row's lanes, as in test_sweep_launch_branches
    if branch == "block":
        lanes = min(lanes, tps.TEAM_THREADS_MAX)
    assert got[3] == branch and got[:2] == (lanes, cpb)
    assert got[:3] == ttl.twolevel_smem_bytes(Mt, Mx, n_chains)
    ncells = (Mx // 2) * (Mt // 2)
    if branch == "warp":
        # a chain keeps its fields (20 floats a cell) and its word table
        assert lanes == min(32, _cuda.next_pow2(2 * ncells))
        assert lanes * cpb <= 32 * _cuda.WARPS_PER_BLOCK
        assert got[2] == 4 * cpb * (tps.TWOLEVEL_WORDS + 20 * ncells)
    else:
        assert got[2] == 4 * (tps.TWOLEVEL_WORDS + 20 * ncells + 5 * lanes)


def test_twolevel_block_beyond_shared_memory_is_refused(monkeypatch):
    """The two-level kernel keeps its fields in shared memory: a 128x128
    fine field (4096 cells, 320 KB) is refused as the parent refused it,
    and MonteCarloMultiLevel runs such a level unfused; the main path's
    launch fits."""
    monkeypatch.setattr(_cuda, "max_smem_optin",
                        lambda device_index: H100_SMEM_OPTIN)
    dev = torch.device("cuda", 0)
    _cuda.check_smem(ttl.twolevel_launch(8, 8, 1024)[2], dev, "8x8")
    with pytest.raises(NotImplementedError, match="runs such levels unfused"):
        _cuda.check_smem(ttl.twolevel_launch(128, 128, 64)[2], dev,
                         "128x128")
