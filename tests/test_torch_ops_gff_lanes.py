"""The host-side logic of the GFF sweep and neighbour-sum kernels
(mlmcpathintegral_tpu_torch/csrc/gff_sweep.cu).

1. The sweep's colour walk.  A half-sweep of colour c visits only the
   n/2 sites of that colour: lane lt of a group of G lanes takes
   k = lt, lt + G, .. < n/2 as row j and half-column m (k = j Mt/2 + m,
   stepped by increments fixed once a launch, while j < Mx) and updates
   site
   j Mt + 2m + ((j + c) & 1).  ``colour_walk`` is a plain model of those
   integer steps; it must visit every site of colour c exactly once, each
   of whose four neighbours (``gff_nb``'s indices) has the other colour
   and equals a roll of the field, for every even Mx, Mt up to the warp
   branch's limit and at the block design's boundary.

2. The hoisted counter words.  The kernel takes a chain's hash once a
   launch, the chain word of a half-sweep's two counters once a
   half-sweep and a site's hash once a sweep; a word is then split_bits
   (rng.cuh).  Modelled in ops/rng.py's plain arithmetic, the split words
   equal CounterRng's step-less stream, and a heat-bath sweep taken site
   by site along the walk with words 4h + 2c + 1 and 4h + 2c + 2 equals
   the plain version bit for bit in float32.

3. ``sweep_launch``'s branch and layout at its boundaries, and the
   neighbour-sum kernel's 2-D grid: every element covered once, its sum in
   gff_nb's order, at the JAX probe's shapes and at path E's and the
   64 x 256x256 field.

Inputs are made with numpy from seeds; no card is needed."""

import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops import gff as tpg
from mlmcpathintegral_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

H100_SMEM_OPTIN = 232448
M32 = trng.M32


# ---- 1. the colour walk ------------------------------------------------------

def colour_walk(Mx, Mt, lanes):
    """The (row, half-column) pairs each lane visits in a half-sweep, as
    the kernel's ColourWalk steps them: [lanes, steps] arrays j, m and the
    mask of the steps the kernel takes (while j < Mx)."""
    half = Mt // 2
    lt = np.arange(lanes)
    j, m = lt // half, lt % half
    dj, dm = lanes // half, lanes % half
    J, Mm = [], []
    while (j < Mx).any():
        J.append(j.copy())
        Mm.append(m.copy())
        m = m + dm
        j = j + dj
        carry = m >= half
        m = np.where(carry, m - half, m)
        j = np.where(carry, j + 1, j)
    J, Mm = np.stack(J, axis=1), np.stack(Mm, axis=1)
    return J, Mm, J < Mx


def walk_sites(Mx, Mt, lanes, colour):
    """(site, row, column) of every update of a colour's half-sweep."""
    J, Mm, live = colour_walk(Mx, Mt, lanes)
    j, m = J[live], Mm[live]
    i = 2 * m + ((j + colour) & 1)
    return j * Mt + i, j, i


def nb_indices(j, i, Mx, Mt):
    """The four neighbour sites of gff_nb, in its order, as its offsets
    from the site s = j Mt + i."""
    s = j * Mt + i
    up = np.where(j == 0, (Mx - 1) * Mt, -Mt)
    dn = np.where(j == Mx - 1, -(Mx - 1) * Mt, Mt)
    lf = np.where(i == 0, Mt - 1, -1)
    rt = np.where(i == Mt - 1, 1 - Mt, 1)
    return s + up, s + dn, s + lf, s + rt


def check_walk(Mx, Mt, lanes):
    n = Mx * Mt
    idx = torch.arange(n).reshape(Mx, Mt)
    rolls = [torch.roll(idx, 1, 0), torch.roll(idx, -1, 0),
             torch.roll(idx, 1, 1), torch.roll(idx, -1, 1)]
    colour_of = ((np.arange(n) // Mt + np.arange(n) % Mt) & 1)
    for c in (0, 1):
        s, j, i = walk_sites(Mx, Mt, lanes, c)
        # every site of colour c once, and no other
        assert np.array_equal(np.sort(s), np.flatnonzero(colour_of == c))
        assert (j < Mx).all() and (i < Mt).all()
        for nb, roll in zip(nb_indices(j, i, Mx, Mt), rolls):
            assert (colour_of[nb] == 1 - c).all()
            assert np.array_equal(nb, roll.reshape(-1).numpy()[s])


def _warp_shapes():
    return [(Mx, Mt) for Mx in range(2, tpg.WARP_SITES_MAX // 2 + 1, 2)
            for Mt in range(2, tpg.WARP_SITES_MAX // Mx + 1, 2)]


@pytest.mark.parametrize("Mx", [2, 4, 6, 8, 10, 16, 30, 32, 48, 64, 128,
                                1152])
def test_warp_walk_visits_each_site_of_a_colour_once(Mx):
    """Every even Mt with Mx Mt up to the warp branch's limit (32 lanes a
    chain)."""
    shapes = [s for s in _warp_shapes() if s[0] == Mx]
    assert shapes
    for Mx_, Mt in shapes:
        assert tpg.sweep_launch(Mt, Mx_, 4096, H100_SMEM_OPTIN)[3] == "warp"
        check_walk(Mx_, Mt, 32)


def test_warp_walk_all_shapes():
    """The rest of the even shapes up to the limit."""
    done = {2, 4, 6, 8, 10, 16, 30, 32, 48, 64, 128, 1152}
    shapes = [s for s in _warp_shapes() if s[0] not in done]
    assert len(shapes) > 500
    for Mx, Mt in shapes:
        check_walk(Mx, Mt, 32)


@pytest.mark.parametrize("Mx, Mt", [(16, 16), (6, 10), (48, 50), (50, 48),
                                    (2, 1154), (1154, 2), (64, 64),
                                    (128, 128), (242, 240), (242, 242),
                                    (256, 256)])
def test_block_walk_visits_each_site_of_a_colour_once(Mx, Mt):
    """The block design's threads (few chains, or past the warp branch's
    fields) and the global branch's, the same walk."""
    lanes, cpb, _, branch = tpg.sweep_launch(Mt, Mx, 64, H100_SMEM_OPTIN)
    assert branch in ("block", "global") and cpb == 1
    check_walk(Mx, Mt, lanes)


def test_walk_balances_the_lanes():
    """At path E's 16x16 every lane updates n/64 = 4 sites a half-sweep."""
    J, _, live = colour_walk(16, 16, 32)
    assert live.sum(axis=1).tolist() == [4] * 32


# ---- 2. the hoisted counter words -------------------------------------------

def _mul(h, c):
    return trng._mul32(h, c)


def site_hash(seed1, site):
    return trng.fmix32(_mul(site, 0x9E3779B9) ^ seed1)


def chain_base(seed2, chain):
    return trng.fmix32(_mul(chain, 0x85EBCA77) ^ seed2)


def base_word(base_c, ctr):
    return trng.fmix32((base_c + (ctr * 0x27D4EB2F & M32)) & M32)


def split_bits(base_s, cw, ctr):
    return trng.fmix32((trng.fmix32((base_s + (ctr * 0xC2B2AE3D & M32))
                                    & M32) + cw) & M32)


@pytest.mark.parametrize("seed", [(0, 0), (7, 9), (123456, 4294868531),
                                  (4294967295, 1)])
def test_split_words_equal_the_stepless_stream(seed):
    seed1, seed2 = seed
    rs = np.random.default_rng(seed1 % 1000)
    site = torch.from_numpy(rs.integers(0, 1 << 20, 64)).reshape(1, 64)
    chain = torch.from_numpy(rs.integers(0, 1 << 20, 8)).reshape(8, 1)
    rng = trng.CounterRng(seed1, site, chain, seed2)
    hs = site_hash(seed1, site)
    bc = chain_base(seed2, chain)
    for ctr in range(1, 10):
        want = rng.bits()
        assert torch.equal(split_bits(hs, base_word(bc, ctr), ctr), want)


def walk_sweep(phi, seed, *, kappa, Mt, Mx, n_overrelax, n_heatbath,
               lanes=32, ctr_shift=0):
    """A model of the kernel's sweep on float32 fields [C, Mx*Mt]: each
    half-sweep updates the sites of its colour in the walk's order, with
    gff_nb's neighbour sum and the words of the hoisted hashes at counters
    4h + 2c + 1 + ctr_shift and the next."""
    C = phi.shape[0]
    seed1, seed2 = trng.seed_pair(seed)
    kappa = float(kappa)
    sigma = tpg._sigma(kappa)
    P = phi.clone()
    chain = torch.arange(C, dtype=torch.int64)[:, None]
    bc = chain_base(seed2, chain)

    def nb(s, j, i):
        a, b, l_, r = (torch.from_numpy(x) for x in nb_indices(j, i, Mx,
                                                               Mt))
        return ((P[:, a] + P[:, b]) + P[:, l_]) + P[:, r]

    for _ in range(n_overrelax):
        for c in (0, 1):
            s, j, i = walk_sites(Mx, Mt, lanes, c)
            s_t = torch.from_numpy(s)
            P[:, s_t] = 2.0 * nb(s, j, i) / kappa - P[:, s_t]
    for h in range(n_heatbath):
        for c in (0, 1):
            ctr = 4 * h + 2 * c + 1 + ctr_shift
            cw1, cw2 = base_word(bc, ctr), base_word(bc, ctr + 1)
            s, j, i = walk_sites(Mx, Mt, lanes, c)
            s_t = torch.from_numpy(s)
            hs = site_hash(seed1, s_t[None, :])

            def uniform(b):
                f = ((b >> 9) | 0x3F800000).to(torch.int32).view(
                    torch.float32)
                return 2.0 - f
            u1 = uniform(split_bits(hs, cw1, ctr))
            u2 = uniform(split_bits(hs, cw2, ctr + 1))
            z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(trng.TWO_PI * u2)
            P[:, s_t] = nb(s, j, i) / kappa + sigma * z
    return P


@pytest.mark.parametrize("Mx, Mt, n_or, n_hb, lanes", [
    (16, 16, 1, 1, 32),     # path E's shape and draw
    (16, 16, 0, 2, 32),     # counters 5..8 of a second sweep
    (8, 12, 2, 1, 32),
    (6, 34, 1, 3, 32),
    (36, 36, 1, 1, 1024),   # the block design's walk
    (16, 16, 1, 1, 128),
])
def test_walk_sweep_equals_the_plain_version(Mx, Mt, n_or, n_hb, lanes):
    rs = np.random.default_rng(Mx * Mt + n_hb)
    phi = torch.from_numpy(rs.standard_normal((40, Mx * Mt))
                           .astype(np.float32))
    kw = dict(kappa=4.0 + (10.0 / Mt) ** 2, Mt=Mt, Mx=Mx, n_overrelax=n_or,
              n_heatbath=n_hb)
    got = walk_sweep(phi, (11, -3), lanes=lanes, **kw)
    want = tpg.gff_sweep_plain(phi, (11, -3), **kw)
    assert torch.equal(got, want)
    # counters off by one move every site of the last heat-bath sweep
    if n_hb:
        off = walk_sweep(phi, (11, -3), lanes=lanes, ctr_shift=1, **kw)
        assert (off != want).float().mean() > 0.9


# ---- 3. launch layouts -------------------------------------------------------

@pytest.mark.parametrize("Mx, Mt, C, want", [
    (16, 16, 4096, (32, 4, 4 * 4 * 256, "warp")),    # path E
    (16, 16, 2048, (32, 4, 4 * 4 * 256, "warp")),    # the fewest chains
    (16, 16, 2047, (128, 1, 4 * 256, "block")),      # too few chains
    (16, 16, 64, (128, 1, 4 * 256, "block")),
    (2, 2, 4096, (32, 4, 4 * 4 * 4, "warp")),
    (48, 48, 4096, (32, 4, 4 * 4 * 2304, "warp")),   # the warp limit
    (2, 1152, 4096, (32, 4, 4 * 4 * 2304, "warp")),
    (48, 50, 4096, (1024, 1, 4 * 2400, "block")),    # just past it
    (2, 1154, 4096, (1024, 1, 4 * 2308, "block")),
    (64, 64, 4096, (1024, 1, 4 * 4096, "block")),
    (128, 128, 64, (1024, 1, 4 * 16384, "block")),
    (242, 240, 64, (1024, 1, 4 * 58080, "block")),   # last in shared memory
    (242, 242, 64, (1024, 1, 0, "global")),          # first beyond it
    (256, 256, 64, (1024, 1, 0, "global")),
])
def test_sweep_launch_layout(Mx, Mt, C, want):
    got = tpg.sweep_launch(Mt, Mx, C, H100_SMEM_OPTIN)
    assert got == want
    lanes, cpb, smem, branch = got
    assert cpb <= _cuda.WARPS_PER_BLOCK
    assert smem <= (_cuda.SMEM_DEFAULT if branch == "warp"
                    else H100_SMEM_OPTIN)
    # the block design has a thread for each site of a colour, up to 1024
    if branch != "warp":
        assert lanes == min(1024, _cuda.next_pow2(Mx * Mt // 2))


def nbsum_model(phi, Mt, Mx, vec):
    """The neighbour-sum kernel on float32 fields: every thread of the
    grid ``nbsum_launch`` gives computes its V sites' sums as the kernel
    does (the float4 components: ((a + b) + left) + right).  Returns the
    output and how often each element was written."""
    C = phi.shape[0]
    V, tpr, rpb, gx, gy = tpg.nbsum_launch(Mt, Mx, C, vec)
    assert rpb * tpr <= 256 and gy <= 65535
    t = np.arange(rpb * tpr)
    bx = np.arange(gx)
    j = (bx[:, None] * rpb + t[None, :] // tpr).reshape(-1)
    lane = np.broadcast_to(t % tpr, (gx, t.size)).reshape(-1)
    keep = j < Mx
    j, lane = j[keep], lane[keep]
    i0 = np.concatenate([V * lane + V * tpr * q
                         for q in range(-(-Mt // (V * tpr)))])
    j = np.tile(j, -(-Mt // (V * tpr)))
    keep = i0 < Mt
    j, i0 = j[keep], i0[keep]
    out = torch.full_like(phi, float("nan"))
    writes = np.zeros((C, Mx * Mt), np.int64)
    G = phi.reshape(C, Mx, Mt)
    jm = np.where(j == 0, Mx - 1, j - 1)
    jp = np.where(j == Mx - 1, 0, j + 1)
    chains = [np.arange(by, C, gy) for by in range(gy)]
    assert sorted(np.concatenate(chains).tolist()) == list(range(C))
    for v in range(V):
        i = i0 + v
        im = np.where(i == 0, Mt - 1, i - 1)
        ip = np.where(i == Mt - 1, 0, i + 1)
        s = (G[:, jm, i] + G[:, jp, i]) + G[:, j, im]
        out.reshape(C, Mx, Mt)[:, j, i] = s + G[:, j, ip]
        np.add.at(writes, (slice(None), j * Mt + i), 1)
    return out, writes


@pytest.mark.parametrize("C, Mx, Mt, vec", [
    (256, 16, 16, True),     # the JAX probe's shapes
    (256, 8, 8, True),
    (256, 8, 16, True),
    (256, 16, 8, True),
    (4096, 16, 16, True),    # path E's field
    (64, 256, 256, True),
    (64, 256, 256, False),   # misaligned pointers: scalar sites
    (8, 30, 30, False),      # rows not a multiple of 4
    (4, 6, 1032, True),      # rows longer than 256 threads
    (2, 4, 300, False),
])
def test_nbsum_grid_covers_every_element_once(C, Mx, Mt, vec):
    rs = np.random.default_rng(C + Mx + Mt)
    phi = torch.from_numpy(rs.standard_normal((C, Mx * Mt))
                           .astype(np.float32))
    got, writes = nbsum_model(phi, Mt, Mx, vec)
    assert (writes == 1).all()
    assert torch.equal(got, tpg.gff_nbsum_plain(phi, Mt, Mx))


def test_nbsum_grid_loops_over_chains_past_the_y_limit():
    V, tpr, rpb, gx, gy = tpg.nbsum_launch(4, 4, 100_000, True)
    assert (V, tpr, rpb, gx, gy) == (4, 1, 4, 1, 65535)
