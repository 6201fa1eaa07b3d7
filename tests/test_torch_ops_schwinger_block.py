"""The host-side logic of the Schwinger kernels' block design
(mlmcpathintegral_tpu_torch/csrc/schwinger_sweep.cuh, the block design;
schwinger_sweep.cu, schwinger_twolevel.cu schwinger_twolevel_team_kernel).

1. The sums.  ``team_sum`` adds a chain's values over P slots (the threads
   a chain of the earlier one-item-a-thread block design) on a team of
   G <= P threads: thread 32 w + l takes slots w + (G/32) l + G k, adds
   them in pairs at distance 4, 2, 1 (absent slots +0), then by a shuffle
   butterfly over the lanes and one over the warps.  ``team_sum`` below is
   a plain-torch model of that order, held bit for bit in float32 against
   ``chain_sum``'s shared-memory tree over the P slots (rng.cuh), each slot
   summing its sites s = slot, slot + P, ... in order, as the earlier
   design's threads did; a mapping that puts the in-thread slots in the
   low bits gives other bits, so the order is visible.

2. The maps.  A thread takes the items lt, lt + G, ... of each link group
   (and of the coarse cells), their places walked without a division
   (``GridWalk``); ``walk_sites`` models the walk and the compares that
   wrap the neighbours, and every link of every (mu, parity) group is
   covered exactly once with the staples' neighbours of the earlier
   design; with fewer links than threads, W lanes a link cover each once;
   every coarse cell and each of its two ExpCos draws once.

3. The launch functions at their boundaries: every (Mt, Mx, chains) the
   earlier design took gets the same branch, the warp and global-memory
   layouts are unchanged, a block layout is one the kernels take
   (``team_layout_ok``) within the shared memory limit, and whether a
   fused level fits is decided as before.

Inputs are made with numpy from seeds; no card is needed."""

import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops import schwinger as tps
from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as ttl

torch.set_num_threads(1)

H100_SMEM_OPTIN = 232448
#: fields from 9x9 to 64x64, and 128x128 with odd extents beside it
SUM_FIELDS = ((9, 9), (12, 10), (16, 16), (15, 17), (32, 32), (33, 31),
              (64, 64), (128, 128), (127, 129))


# ---- 1. the sums -------------------------------------------------------------

def slot_values(v, P):
    """The earlier design's per-thread values: slot t sums the sites t,
    t + P, ... in order from +0 (float32)."""
    n = v.numel()
    rows = -(-n // P)
    pad = torch.zeros(rows * P, dtype=torch.float32)
    pad[:n] = v
    acc = torch.zeros(P, dtype=torch.float32)
    for r in range(rows):
        part = pad[r * P:(r + 1) * P]
        live = torch.arange(P) + r * P < n
        acc = torch.where(live, acc + part, acc)
    return acc


def tree_sum(slots):
    """rng.cuh chain_sum over P threads: red[t] += red[t + off], off = P/2
    .. 1."""
    red = slots.clone()
    off = red.numel() // 2
    while off:
        red[:off] = red[:off] + red[off:2 * off]
        off //= 2
    return red[0]


def butterfly(x, offsets):
    """x[i] + x[i ^ off] for each offset in turn, along the last axis."""
    idx = torch.arange(x.shape[-1])
    for off in offsets:
        x = x + x[..., idx ^ off]
    return x


def team_sum(slots, G, mapping="team"):
    """schwinger_sweep.cuh team_sum on a team of G threads over the P
    slots: ``mapping`` "team" is the kernel's (slot w + (G/32) l + G k of
    thread 32 w + l); "low" puts a thread's slots in the low bits (slot
    m lt + k), an order the kernel must not take."""
    P = slots.numel()
    nw, m = G // 32, P // G
    lt = torch.arange(G)
    w, lane = lt // 32, lt % 32
    z = torch.zeros(G, dtype=torch.float32)

    def slot(k):
        if k >= m:
            return z
        sl = (w + nw * lane + G * k) if mapping == "team" else m * lt + k
        return slots[sl]
    pair = [slot(k) + slot(k + 4) for k in range(4)]
    v = (pair[0] + pair[2]) + (pair[1] + pair[3])
    v = butterfly(v.reshape(nw, 32), (16, 8, 4, 2, 1))[:, 0]
    u = torch.zeros(32, dtype=torch.float32)
    u[:nw] = v
    offs = []
    off = nw // 2
    while off:
        offs.append(off)
        off //= 2
    return butterfly(u, offs)[0]


def team_sizes(P):
    """The team sizes the block design takes for P slots."""
    G = max(tps.TEAM_THREADS_MIN, P // tps.TEAM_SLOTS)
    while G <= P:
        yield G
        G *= 2


def values(rs, n):
    """Values of mixed sign and magnitude, so that the order of the adds
    shows in the bits."""
    v = rs.standard_normal(n) * np.exp(rs.uniform(-6, 6, n))
    return torch.from_numpy(v.astype(np.float32))


@pytest.mark.parametrize("Mx, Mt", SUM_FIELDS)
def test_team_sum_adds_in_the_tree_order(Mx, Mt):
    rs = np.random.default_rng(Mx * 1000 + Mt)
    n = Mx * Mt
    P = tps.team_slots(n)
    for _ in range(3):
        slots = slot_values(values(rs, n), P)
        want = tree_sum(slots)
        for G in team_sizes(P):
            got = team_sum(slots, G)
            assert got.view(torch.int32) == want.view(torch.int32), (G, P)


def test_team_sum_order_is_visible():
    """The model is not blind to the order: slots taken in the low bits
    (slot m lt + k) change the bits of some sums, and so does a plain
    sequential sum."""
    rs = np.random.default_rng(7)
    P, moved_low, moved_seq = 1024, 0, 0
    for _ in range(20):
        slots = slot_values(values(rs, 4096), P)
        want = tree_sum(slots).view(torch.int32)
        moved_low += int(team_sum(slots, 128, "low").view(torch.int32)
                         != want)
        seq = torch.zeros((), dtype=torch.float32)
        for x in slots:
            seq = seq + x
        moved_seq += int(seq.view(torch.int32) != want)
    assert moved_low > 0 and moved_seq > 0


# ---- 2. the maps -------------------------------------------------------------

class GridWalk:
    """schwinger_sweep.cuh GridWalk: items k0, k0 + step, ... of a grid
    with rows of ``length`` items, as (row, column)."""

    def __init__(self, k0, step, length):
        base = length if length > 0 else 1
        self.r, self.c = divmod(k0, base)
        self.dr, self.dc = divmod(step, base)
        self.len = length

    def next(self):
        self.r += self.dr
        self.c += self.dc
        if self.c >= self.len:
            self.c -= self.len
            self.r += 1


def group_size(mu, parity, Mx, Mt):
    return ((Mx - parity + 1) // 2) * Mt if mu == 0 \
        else Mx * ((Mt - parity + 1) // 2)


def group_len(mu, parity, Mt):
    return Mt if mu == 0 else (Mt - parity + 1) // 2


def block_link(mu, parity, w, Mx, Mt):
    """schwinger_sweep.cuh block_link: the link's site and the five
    neighbours its staples read, wrapped by compares."""
    j = parity + 2 * w.r if mu == 0 else w.r
    i = w.c if mu == 0 else parity + 2 * w.c
    jp = 0 if j + 1 == Mx else j + 1
    jm = Mx - 1 if j == 0 else j - 1
    ip = 0 if i + 1 == Mt else i + 1
    im = Mt - 1 if i == 0 else i - 1
    if mu == 0:
        return (j, i), (j * Mt + i, jp * Mt + i, j * Mt + ip, jm * Mt + i,
                        jm * Mt + ip, jm * Mt + i)
    return (j, i), (j * Mt + i, j * Mt + ip, jp * Mt + i, jp * Mt + im,
                    j * Mt + im, j * Mt + im)


def staple_sites(mu, j, i, Mx, Mt):
    """The earlier design's at() reads of link (mu, j, i): the link, then
    the five neighbours in the order block_link gives them."""
    def at(dj, di):
        return ((j + dj) % Mx) * Mt + (i + di) % Mt
    if mu == 0:
        return (at(0, 0), at(1, 0), at(0, 1), at(-1, 0), at(-1, 1),
                at(-1, 0))
    return (at(0, 0), at(0, 1), at(1, 0), at(1, -1), at(0, -1), at(0, -1))


def walk_sites(mu, parity, Mx, Mt, G):
    """Every thread's links of a group in the block design: the threads'
    walks when the group has at least G links (W = 1), else link lt / W on
    lane q = 0 of its W lanes (as the kernel writes it)."""
    n = group_size(mu, parity, Mx, Mt)
    length = group_len(mu, parity, Mt)
    W = 1 if n >= G else min(32, G // _cuda.next_pow2(n))
    taken = []
    for lt in range(G):
        if W > 1:
            if lt % W == 0 and lt // W < n:
                taken.append(block_link(mu, parity,
                                        GridWalk(lt // W, 0, length),
                                        Mx, Mt))
            continue
        w = GridWalk(lt, G, length)
        k = lt
        while k < n:
            taken.append(block_link(mu, parity, w, Mx, Mt))
            k += G
            w.next()
    return taken


@pytest.mark.parametrize("Mx, Mt", [(9, 9), (8, 16), (1, 48), (12, 10),
                                    (16, 16), (15, 17), (32, 32), (64, 64),
                                    (2, 100), (127, 129)])
def test_every_link_of_every_group_once(Mx, Mt):
    P = tps.team_slots(Mx * Mt)
    for G in team_sizes(P):
        for mu in (0, 1):
            for parity in (0, 1):
                taken = walk_sites(mu, parity, Mx, Mt, G)
                want = sorted((j, i) for j in range(Mx) for i in range(Mt)
                              if (j if mu == 0 else i) % 2 == parity)
                assert sorted(t[0] for t in taken) == want
                for (j, i), sites in taken:
                    assert sites == staple_sites(mu, j, i, Mx, Mt)


@pytest.mark.parametrize("Mxc, Mtc", [(9, 9), (16, 16), (17, 15), (32, 32),
                                      (32, 64)])
def test_every_cell_and_draw_once(Mxc, Mtc):
    """The two-level team kernel's phases A-C: thread lt walks the cells
    lt, lt + G, ... and draws both ExpCos links of each; the cell's
    neighbours (J, I+1) and (J+1, I) wrapped as cell_at wraps them."""
    n = Mxc * Mtc
    for G in team_sizes(tps.team_slots(n)):
        draws = []
        for lt in range(G):
            w = GridWalk(lt, G, Mtc)
            k = lt
            while k < n:
                J, I = w.r, w.c
                c = J * Mtc + I
                assert c == k
                assert J * Mtc + (I + 1) % Mtc == (J * Mtc
                                                   + (I + 1 - Mtc
                                                      if I + 1 >= Mtc
                                                      else I + 1))
                draws += [(c, 0), (c, 1)]
                k += G
                w.next()
        assert sorted(draws) == [(c, o) for c in range(n) for o in (0, 1)]


def test_team_sum_slots_cover_each_slot_once():
    for n in (81, 256, 1024, 4096):
        P = tps.team_slots(n)
        for G in team_sizes(P):
            nw = G // 32
            got = sorted(w + nw * lane + G * k for w in range(nw)
                         for lane in range(32) for k in range(P // G))
            assert got == list(range(P))


# ---- 3. the launch functions -------------------------------------------------

def parent_sweep_launch(Mt, Mx, n_chains):
    """The sweep kernel's launch before the team: the warp design, else a
    block of next_pow2(sites) threads (at most 1024), else global memory."""
    nsites = Mx * Mt
    if tps.warp_lanes(Mx, Mt) is not None:
        lanes, cpb = _cuda.warp_chains(2 * nsites, n_chains)
        smem = 4 * cpb * (tps.SWEEP_WORDS + 2 * nsites)
    else:
        lanes, cpb = min(1024, _cuda.next_pow2(nsites)), 1
        smem = 4 * (tps.SWEEP_WORDS + 2 * nsites + 2 * lanes)
    if smem <= H100_SMEM_OPTIN:
        return lanes, cpb, smem, "warp" if lanes <= 32 else "block"
    return lanes, 1, 4 * (tps.SWEEP_WORDS + 2 * lanes), "global"


def parent_twolevel_launch(Mt, Mx, n_chains):
    ncells = (Mx // 2) * (Mt // 2)
    per_chain = 4 * (tps.TWOLEVEL_WORDS + 20 * ncells)
    if tps.warp_lanes(Mx // 2, Mt // 2) is not None:
        lanes, cpb = _cuda.warp_chains(2 * ncells, n_chains)
        return lanes, cpb, cpb * per_chain, "warp"
    tpc = min(1024, _cuda.next_pow2(ncells))
    return tpc, 1, per_chain + 4 * 5 * tpc, "block"


def team_layout_ok(G, cpb, n):
    """schwinger_sweep.cuh team_layout_ok."""
    P = tps.team_slots(n)
    return (cpb == 1 and G >= 64 and G & (G - 1) == 0 and G <= P
            and G * tps.TEAM_SLOTS >= P)


CHAINS = (1, 64, 128, 256, 1024, 4096, 16384)
SIDES = (1, 2, 3, 4, 6, 8, 9, 10, 12, 16, 18, 24, 32, 48, 64, 96, 128,
         130, 192, 256)


def test_sweep_launch_takes_every_shape_the_parent_took():
    for Mx in SIDES:
        for Mt in SIDES:
            for C in CHAINS:
                old = parent_sweep_launch(Mt, Mx, C)
                got = tps.sweep_launch(Mt, Mx, C, H100_SMEM_OPTIN)
                assert got[3] == old[3], (Mx, Mt, C)
                if got[3] != "block":
                    assert got == old, (Mx, Mt, C)
                    continue
                G, cpb, smem, _ = got
                assert team_layout_ok(G, cpb, Mx * Mt)
                assert G <= old[0] and smem <= old[2] <= H100_SMEM_OPTIN
                assert smem == 4 * (tps.SWEEP_WORDS + 2 * Mx * Mt + 2 * G)
                # a fused coarsest level fits as it did before the team
                assert tps.sweep_smem_bytes(Mt, Mx)[2] == old[2]


def test_twolevel_launch_takes_every_shape_the_parent_took():
    for Mx in SIDES:
        for Mt in SIDES:
            if Mx % 2 or Mt % 2:
                continue
            for C in CHAINS:
                old = parent_twolevel_launch(Mt, Mx, C)
                got = ttl.twolevel_launch(Mt, Mx, C)
                assert got[3] == old[3], (Mx, Mt, C)
                if got[3] == "warp":
                    assert got == old
                    continue
                G, cpb, smem, _ = got
                assert team_layout_ok(G, cpb, (Mx // 2) * (Mt // 2))
                assert G <= old[0] and smem <= old[2]
                # the fit decision (MonteCarloMultiLevel, check_smem) is
                # the parent's block
                assert ttl.twolevel_smem_bytes(Mt, Mx)[2] == old[2]


@pytest.mark.parametrize("launch, M, C, G", [
    # few chains an SM: the earlier design's threads a chain, at most
    # TEAM_THREADS_MAX
    ("sweep", 16, 64, 256), ("sweep", 32, 128, 512),
    ("sweep", 128, 64, 512),
    ("twolevel", 32, 256, 256), ("twolevel", 64, 256, 512),
    # many chains: smaller teams, several resident an SM
    ("sweep", 32, 1024, 128), ("sweep", 64, 1024, 128),
    ("sweep", 64, 256, 512), ("twolevel", 32, 1024, 128),
    ("twolevel", 64, 1024, 512),
])
def test_block_threads_at_the_scale_launches(launch, M, C, G):
    """The team sizes at the scale study's and the hybrid draw's launches:
    an SM holds the chains of one wave (up to its shared memory) within
    SM_THREADS threads, or the team is at its least."""
    if launch == "sweep":
        got = tps.sweep_launch(M, M, C, H100_SMEM_OPTIN)
        n = M * M
    else:
        got = ttl.twolevel_launch(M, M, C)
        n = (M // 2) * (M // 2)
    assert got[0] == G
    per_sm = -(-C // tps.H100_SMS)
    fit = tps.SM_SMEM // (got[2] + tps.BLOCK_SMEM_RESERVED)
    least = max(tps.TEAM_THREADS_MIN, tps.team_slots(n) // tps.TEAM_SLOTS)
    assert G * min(per_sm, fit) <= tps.SM_THREADS or G == least
