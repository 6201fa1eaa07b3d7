"""Spatial (lattice-axis) sharding with halo exchange (PyTorch port of
``mlmcpathintegral_tpu/parallel/spatial.py``).

The reference never decomposes the lattice across ranks; its scaling axes
are independent chains and the multigrid hierarchy.  The 5-point-stencil
sweeps shard naturally all the same: the rows j of a [C, Mx, Mt(, 2)]
field are split in contiguous blocks over the ranks of a ``space`` mesh
axis, and before each coloured (half- or quarter-) sweep every rank sends
its first row to the previous rank and its last row to the next one
(``batch_isend_irecv``), so each holds one halo row on either side.  At
one rank the halo is the rank's own wrapped row, a local copy.  With a
``chain_axis`` the chains are split too (a 2-D chains x space mesh from
``chains.make_mesh``); the chain blocks need no communication.

The sharded sweeps take and return the rank's block of the flat state,
[C_loc, (Mx/W) * Mt] for the GFF and [C_loc, (Mx/W) * Mt * 2] for the
links (``shard_field`` / ``gather_field`` convert).  Given the same noise
a sharded sweep equals the dense one bit for bit: a coloured sweep reads
only frozen values of the other colour, and every site's arithmetic is
the dense sweep's, in the same order — the decomposition changes data
movement, not math.  Halo rows on a gloo group go through the host
(``chains.host_staged``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from mlmcpathintegral_tpu_torch.distributions.rejection import (
    normal, uniform,
)
from mlmcpathintegral_tpu_torch.parallel.chains import (
    _all_gather_rows, host_staged,
)
from mlmcpathintegral_tpu_torch.utils.special import mod_2pi

PI = math.pi


# -- layout helpers ------------------------------------------------------------

def _axis_block(ax, n: int, what: str) -> slice:
    W = ax.world_size
    if n % W:
        raise ValueError(f"{what} {n} must be a multiple of the {W} ranks "
                         f"of mesh axis '{ax.axis_name}'")
    per = n // W
    return slice(ax.rank * per, (ax.rank + 1) * per)


def _local(mesh, x, row_dim: int, axis: str, chain_axis, chain_dim: int):
    """This rank's block of x: rows along ``row_dim``, chains along
    ``chain_dim`` when the mesh splits them."""
    idx = [slice(None)] * x.dim()
    idx[row_dim] = _axis_block(mesh.axis(axis), x.shape[row_dim], "rows")
    if chain_axis is not None:
        idx[chain_dim] = _axis_block(mesh.axis(chain_axis),
                                     x.shape[chain_dim], "chains")
    return x[tuple(idx)]


def _gather_dim(ax, x, dim: int):
    """The ranks' blocks of x along ``dim``, joined in rank order."""
    if ax.world_size == 1:
        return x
    rows = _all_gather_rows(ax, x.reshape(-1))
    parts = rows.reshape(ax.world_size, *x.shape)
    return torch.cat(list(parts.unbind(0)), dim=dim)


def shard_field(mesh, x, Mx: int, axis: str = "space", chain_axis=None):
    """This rank's block of a global flat state x [C, Mx * rest] (rows j
    leading each chain's sites): [C_loc, (Mx/W) * rest]."""
    loc = _local(mesh, x.reshape(x.shape[0], Mx, -1), 1, axis, chain_axis,
                 0)
    return loc.reshape(loc.shape[0], -1)


def gather_field(mesh, x_loc, Mx_loc: int, axis: str = "space",
                 chain_axis=None):
    """The global flat state [C, Mx * rest] from every rank's block."""
    C_loc = x_loc.shape[0]
    g = _gather_dim(mesh.axis(axis), x_loc.reshape(C_loc, Mx_loc, -1), 1)
    if chain_axis is not None:
        g = _gather_dim(mesh.axis(chain_axis), g, 0)
    return g.reshape(g.shape[0], -1)


def shard_sweep_noise(mesh, noise, axis: str = "space", chain_axis=None):
    """This rank's block of a sweep's noise (``make_schwinger_sweep_noise``:
    four groups of [R, C, rows, cols] arrays)."""
    return [tuple(_local(mesh, a, 2, axis, chain_axis, 1) for a in nz)
            for nz in noise]


def _halo(ax, x):
    """(row above the block, row below it) of the local rows x [C, R, ..]:
    the previous rank's last row and the next rank's first row, each
    [C, 1, ..]; at one rank the block's own wrapped rows."""
    if ax.world_size == 1:
        return x[:, -1:], x[:, :1]
    W = ax.world_size
    nxt = ax.ranks[(ax.rank + 1) % W]
    prv = ax.ranks[(ax.rank - 1) % W]
    staged = host_staged(ax.group)
    last, first = x[:, -1:].contiguous(), x[:, :1].contiguous()
    if staged:
        last, first = last.cpu(), first.cpu()
    top, bot = torch.empty_like(last), torch.empty_like(first)
    # posted in the same order on every rank (sends before receives), so
    # backends that match a peer's messages in order pair them the same
    # way as the tags do
    ops = [dist.P2POp(dist.isend, last, nxt, ax.group, tag=0),
           dist.P2POp(dist.isend, first, prv, ax.group, tag=1),
           dist.P2POp(dist.irecv, top, prv, ax.group, tag=0),
           dist.P2POp(dist.irecv, bot, nxt, ax.group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        top, bot = top.to(x.device), bot.to(x.device)
    return top, bot


def _space_axis(mesh, axis: str, Mx: int):
    ax = mesh.axis(axis)
    n_dev = ax.world_size
    if Mx % (2 * n_dev):
        raise ValueError(f"Mx={Mx} must be a multiple of 2*{n_dev}")
    return ax


# -- GFF ----------------------------------------------------------------------

def gff_heatbath_sweep_noise(action, phi, xi):
    """Single-rank reference: red/black heat-bath sweep of the 5-point
    stencil driven by externally supplied noise xi [C, N] (same math as
    GFFAction.heatbath_sweep, deterministic given xi)."""
    kappa = 4.0 + action.mu2
    sigma = 1.0 / math.sqrt(kappa)
    for colour in action._colour_masks:
        idx = torch.as_tensor(colour, device=phi.device)
        delta = action._nbsum(phi)[..., idx]
        phi = phi.clone()
        phi[..., idx] = delta / kappa + sigma * xi[..., idx]
    return phi


def make_sharded_gff_sweep(action, mesh, axis: str = "space",
                           chain_axis: str | None = None):
    """Build the sharded sweep ``sweep(phi, xi)``: phi, xi are this rank's
    blocks [C_loc, (Mx/W) * Mt] of the rows (and, with ``chain_axis``, of
    the chains).  Requires an unrotated lattice whose Mx is a multiple of
    2 W (even rows a rank keep the global checkerboard parity aligned)."""
    lat = action.lattice
    if lat.rotated:
        raise ValueError("spatial sharding needs an unrotated lattice")
    Mt, Mx = lat.Mt_lat, lat.Mx_lat
    ax = _space_axis(mesh, axis, Mx)
    Mx_loc = Mx // ax.world_size
    kappa = 4.0 + action.mu2
    sigma = 1.0 / math.sqrt(kappa)

    def sweep(phi, xi):
        C = phi.shape[0]
        g = phi.reshape(C, Mx_loc, Mt)
        xi_g = xi.reshape(C, Mx_loc, Mt)
        i_idx = torch.arange(Mt, device=phi.device)[None, :]
        j_idx = torch.arange(Mx_loc, device=phi.device)[:, None]
        for parity in (0, 1):
            top, bot = _halo(ax, g)
            ext = torch.cat([top, g, bot], dim=1)
            # the dense sweep's neighbour sum, in its order:
            # (i-1) + (i+1) + (j-1) + (j+1)
            delta = (torch.roll(g, 1, -1) + torch.roll(g, -1, -1)
                     + ext[:, :-2] + ext[:, 2:])
            new = delta / kappa + sigma * xi_g
            # global colour (i + j) % 2: the block offset is even
            mask = ((i_idx + j_idx) % 2 == parity)[None]
            g = torch.where(mask, new, g)
        return g.reshape(C, Mx_loc * Mt)

    return sweep


# -- Schwinger link sweeps ----------------------------------------------------
#
# The quenched Schwinger heat-bath sweep (quenchedschwingeraction.cc:25-66)
# updates links in 4 conflict-free (direction, parity) groups; every staple
# reaches at most one row in +-j, so sharding the Mx (row) axis needs a
# one-row halo of both link orientations per quarter-sweep.  The rejection
# draw is driven by externally supplied noise rounds so the sharded and the
# dense sweeps are bit-identical given the same noise; the keyed variant
# draws the noise on each rank from a generator seeded by its position.

def _expcos_draw_noise(nz, beta, x_p, x_m, fallback):
    """First-accept rejection draw from ExpCos(beta; x_p, x_m) driven by
    pre-drawn noise rounds nz = (x_uni[R,...], x_gauss[R,...], u[R,...])
    (x_uni ~ U[-pi, pi), x_gauss ~ N(0,1), u ~ U[0,1)).  Same envelope and
    acceptance logic as distributions.ExpCosDistribution.draw; unaccepted
    lanes return ``fallback`` (exact identity-mixture truncation)."""
    xu_r, xg_r, uu_r = nz
    dx = x_m - x_p
    tau = 2.0 * beta * torch.abs(torch.cos(0.5 * dx))
    use_uni = tau < 0.45
    sigma = 0.5 * PI / torch.sqrt(torch.clamp(tau, min=1e-12))
    zero = torch.zeros((), dtype=x_p.dtype, device=x_p.device)
    x = torch.zeros_like(x_p)
    acc = torch.zeros(x_p.shape, dtype=torch.bool, device=x_p.device)
    for r in range(xu_r.shape[0]):
        xx = torch.where(use_uni, xu_r[r], sigma * xg_r[r])
        log_ratio = tau * (torch.cos(xx) - 1.0) + torch.where(
            use_uni, zero, 2.0 * tau * xx * xx / (PI ** 2))
        ok = (-PI <= xx) & (xx < PI) & (torch.log(uu_r[r]) <= log_ratio)
        x = torch.where(acc, x, xx)
        acc = acc | ok
    shift = 0.5 * (x_p + x_m) + torch.where(torch.abs(dx) > PI,
                                            zero + PI, zero)
    out = mod_2pi(x + shift)
    return torch.where(acc, out, fallback)


def schwinger_group_shapes(action, n_chains: int):
    """Global noise shapes of the 4 (mu, parity) sweep groups."""
    lat = action.lattice
    Mt, Mx = lat.Mt_lat, lat.Mx_lat
    return [(n_chains, Mx // 2, Mt), (n_chains, Mx // 2, Mt),
            (n_chains, Mx, Mt // 2), (n_chains, Mx, Mt // 2)]


def _group_noise(generator, shape, dtype, device):
    return (uniform(generator, shape, dtype, device, -PI, PI),
            normal(generator, shape, dtype, device),
            uniform(generator, shape, dtype, device))


def make_schwinger_sweep_noise(generator, action, n_chains: int,
                               max_iter: int = 6, dtype=torch.float64):
    """Draw the noise of one noise-driven heat-bath sweep from
    ``generator`` (on its device): a list of 4 per-group tuples
    (x_uni, x_gauss, u), each [R, C, .., ..]."""
    return [_group_noise(generator, (max_iter,) + shape, dtype,
                         generator.device)
            for shape in schwinger_group_shapes(action, n_chains)]


def schwinger_heatbath_sweep_noise(action, theta, noise):
    """Single-rank reference: one full heat-bath sweep driven by the
    supplied noise (deterministic; same group order and staple math as
    QuenchedSchwingerAction.heatbath_sweep)."""
    for (mu, parity), nz in zip(action._link_groups(), noise):
        g = action._grid(theta).clone()
        theta_p, theta_m = action.staple_angles_mu(theta, mu)
        sel = action._group_sel(mu, parity)
        cur = g[sel + (mu,)]
        g[sel + (mu,)] = _expcos_draw_noise(nz, action.beta, theta_p[sel],
                                            theta_m[sel], cur)
        theta = action._flat(g)
    return theta


def _sharded_staples_mu(ext, mu, Mx_loc):
    """(theta_p, theta_m) [C, Mx_loc, Mt] for direction ``mu`` from an
    extended local grid ext [C, Mx_loc+2, Mt, 2] carrying one halo row on
    each side (same formulas as staple_angles_mu; j-shifts become row
    slices of ext, i-shifts stay periodic local rolls)."""
    T, X = ext[..., 0], ext[..., 1]

    def sh(A, di, dj):
        out = A
        if di:
            out = torch.roll(out, -di, dims=-1)
        return out[:, 1 + dj:1 + dj + Mx_loc, :]

    def c(A):
        return A[:, 1:1 + Mx_loc, :]

    if mu == 0:
        tp = mod_2pi(sh(T, 0, 1) + c(X) - sh(X, 1, 0))
        tm = mod_2pi(sh(T, 0, -1) + sh(X, 1, -1) - sh(X, 0, -1))
    else:
        tp = mod_2pi(c(T) + sh(X, 1, 0) - sh(T, 0, 1))
        tm = mod_2pi(sh(T, -1, 1) + sh(X, -1, 0) - sh(T, -1, 0))
    return tp, tm


_GROUPS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _quarter_sweep(ax, g_loc, mu, parity, nz, beta, Mx_loc):
    """One (mu, parity) group of the sharded sweep on g_loc
    [C, Mx_loc, Mt, 2]."""
    top, bot = _halo(ax, g_loc)
    ext = torch.cat([top, g_loc, bot], dim=1)
    tp, tm = _sharded_staples_mu(ext, mu, Mx_loc)
    if mu == 0:   # rows of one global-j parity (Mx_loc even)
        sel = (slice(None), slice(parity, None, 2), slice(None))
    else:         # columns of one i parity (Mt fully local)
        sel = (slice(None), slice(None), slice(parity, None, 2))
    g_loc = g_loc.clone()
    cur = g_loc[..., mu][sel]
    g_loc[sel + (mu,)] = _expcos_draw_noise(nz, beta, tp[sel], tm[sel], cur)
    return g_loc


def make_sharded_schwinger_sweep(action, mesh, axis: str = "space",
                                 chain_axis: str | None = None,
                                 max_iter: int = 6):
    """Build the noise-driven sharded heat-bath sweep ``sweep(theta,
    noise)``: theta is this rank's block [C_loc, (Mx/W) * Mt * 2] of the
    [C, Mx, Mt, 2] link grid's rows (and chains, with ``chain_axis``),
    noise its block of ``make_schwinger_sweep_noise`` (``shard_sweep_noise``).
    Bit-identical to :func:`schwinger_heatbath_sweep_noise` given the same
    noise.  Requires Mx to be a multiple of 2 W (even rows a rank keep the
    global j-parity of the temporal-link groups aligned)."""
    lat = action.lattice
    Mt, Mx = lat.Mt_lat, lat.Mx_lat
    ax = _space_axis(mesh, axis, Mx)
    Mx_loc = Mx // ax.world_size
    beta = action.beta
    del max_iter   # the rounds are the noise's leading axis

    def sweep(theta, noise):
        C = theta.shape[0]
        g = theta.reshape(C, Mx_loc, Mt, 2)
        for (mu, parity), nz in zip(_GROUPS, noise):
            g = _quarter_sweep(ax, g, mu, parity, nz, beta, Mx_loc)
        return g.reshape(C, Mx_loc * Mt * 2)

    return sweep


def _position_seed(seed: int, space_index: int, chain_index: int) -> int:
    """A 63-bit generator seed from the caller's seed and the rank's mesh
    position: one independent stream per (space, chain) block."""
    m = (1 << 64) - 1
    h = (int(seed) * 0x9E3779B97F4A7C15 + (space_index + 1)
         * 0xBF58476D1CE4E5B9 + (chain_index + 1) * 0x94D049BB133111EB) & m
    h ^= h >> 31
    return h & ((1 << 63) - 1)


def make_sharded_schwinger_heatbath(action, mesh, axis: str = "space",
                                    chain_axis: str | None = None,
                                    max_iter: int = 6):
    """Keyed production variant: ``sweep(seed, theta)`` draws each rank's
    rejection noise from a generator on theta's device seeded from
    ``seed`` (an int, new for every sweep) and the rank's position on the
    space and chain axes, then runs the same halo-exchange sweep on the
    rank's block theta [C_loc, (Mx/W) * Mt * 2]."""
    lat = action.lattice
    Mt, Mx = lat.Mt_lat, lat.Mx_lat
    ax = _space_axis(mesh, axis, Mx)
    Mx_loc = Mx // ax.world_size
    beta = action.beta
    chain_index = 0 if chain_axis is None else mesh.axis(chain_axis).rank

    def sweep(seed, theta):
        C = theta.shape[0]
        gen = torch.Generator(device=theta.device).manual_seed(
            _position_seed(seed, ax.rank, chain_index))
        shapes = [(C, Mx_loc // 2, Mt), (C, Mx_loc // 2, Mt),
                  (C, Mx_loc, Mt // 2), (C, Mx_loc, Mt // 2)]
        g = theta.reshape(C, Mx_loc, Mt, 2)
        for (mu, parity), shape in zip(_GROUPS, shapes):
            nz = _group_noise(gen, (max_iter,) + shape, theta.dtype,
                              theta.device)
            g = _quarter_sweep(ax, g, mu, parity, nz, beta, Mx_loc)
        return g.reshape(C, Mx_loc * Mt * 2)

    return sweep
