"""O(3) non-linear sigma model on a 2-D lattice (PyTorch port of
``mlmcpathintegral_tpu/models/qft/nonlinearsigma.py``; reference
src/action/qft/nonlinearsigmaaction.{hh,cc},
nonlinearsigmarenormalisation.hh, qoi2dmagneticsusceptibility.cc).

S[sigma] = -beta/2 sum_n sigma_n . Delta_n, with Delta_n the sum of the 4
nearest-neighbour unit spins; a state holds the spherical angles
(theta, phi) of each vertex as a flat [C, 2N] tensor.  The model needs the
CoarsenRotate hierarchy (nonlinearsigmaaction.hh:143-151).

The heat bath and overrelaxation update one red/black colour at a time:
a spin's conditional depends only on its 4 nearest neighbours, which
have the other colour on the rotated and the unrotated members of the
hierarchy alike.  Two forms:

* the gather form (``heatbath_sweep``, ``overrelaxation_sweep``) indexes
  the neighbour table, on any lattice of the hierarchy;
* the grid form (``combined_sweeps``) holds an unrotated lattice's spins
  as three chain-major [C, Mx, Mt] planes (vertex l = Mt*j + i, so the
  flat state reshapes to the grid), takes the 4-point stencil as four
  periodic rolls and each colour as a checkerboard ``where``, and
  converts angles to vectors once a draw.

Noise comes from the run's ``torch.Generator`` through
``distributions.rejection.uniform``: for each colour update the CompactExp
uniforms, then the azimuth uniforms (the grid form draws both over the
whole grid and keeps the colour's sites, as the JAX package does).

Two guards the JAX package lacks, neither changing a result it gets
right: the checkerboard needs even extents on an unrotated lattice (an
odd one silently breaks detailed balance), and the CompactExp draw takes
beta * max(|Delta|, 1e-30), finite where the four neighbours cancel.
"""

from __future__ import annotations

import math
from functools import cached_property

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.distributions.compactexp import (
    CompactExpDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.rejection import (
    normal, uniform,
)
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.models.base import Action, RenormalisationType

TINY = 1e-30


def angles_to_vec(state):
    """[..., 2N] (theta, phi) pairs -> [..., N, 3] unit vectors."""
    ang = state.reshape(*state.shape[:-1], -1, 2)
    theta, phi = ang[..., 0], ang[..., 1]
    st = torch.sin(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi),
                        torch.cos(theta)], dim=-1)


def vec_to_angles(vec):
    """[..., N, 3] -> [..., 2N] (theta, phi), by atan2 as the reference
    (nonlinearsigmaaction.cc:69-72)."""
    phi = torch.atan2(vec[..., 1], vec[..., 0])
    theta = torch.atan2(torch.sqrt(vec[..., 0] ** 2 + vec[..., 1] ** 2),
                        vec[..., 2])
    out = torch.stack([theta, phi], dim=-1)
    return out.reshape(*out.shape[:-2], -1)


class NonlinearSigmaAction(Action):

    def __init__(self, lattice: Lattice2D, beta: float,
                 renormalisation: RenormalisationType =
                 RenormalisationType.NONE):
        if lattice.coarsening_type is not CoarseningType.ROTATE:
            raise ValueError("sigma model needs CoarsenRotate "
                             "(nonlinearsigmaaction.hh:143-151)")
        if not lattice.rotated and (lattice.Mt_lat % 2 or lattice.Mx_lat % 2):
            raise ValueError("the red/black sweeps of the sigma model need "
                             "even Mt_lat and Mx_lat")
        self.lattice = lattice
        self.beta = float(beta)
        self.renormalisation = renormalisation
        #: index and mask tensors by (name, device), copied there once
        self._on_device = {}

    @property
    def ndof(self) -> int:
        return 2 * self.lattice.nvertices

    def _tensor(self, name, array: np.ndarray, device) -> torch.Tensor:
        """``array`` as a tensor on ``device``, made once a device."""
        key = (name, str(device))
        if key not in self._on_device:
            self._on_device[key] = torch.as_tensor(array, device=device)
        return self._on_device[key]

    # -- geometry helpers ------------------------------------------------------

    @cached_property
    def _nn(self) -> np.ndarray:
        return self.lattice.neighbour_vertices[:, :4]

    @cached_property
    def _colour_masks(self):
        ell = np.arange(self.lattice.nvertices)
        i, j = self.lattice.vertex_lin2cart(ell)
        red = (i % 2 == 0) if self.lattice.rotated else ((i + j) % 2 == 0)
        return np.flatnonzero(red), np.flatnonzero(~red)

    def delta_neighbours(self, vec):
        """Sum of the 4 nearest-neighbour spins: [..., N, 3]."""
        return torch.sum(vec[..., self._tensor("nn", self._nn, vec.device),
                             :], dim=-2)

    # -- action ----------------------------------------------------------------

    def evaluate(self, state):
        vec = angles_to_vec(state)
        delta = self.delta_neighbours(vec)
        return -0.5 * self.beta * torch.sum(vec * delta, dim=(-2, -1))

    def force(self, state):
        """dS/d(theta, phi) (nonlinearsigmaaction.cc:96-116)."""
        ang = state.reshape(*state.shape[:-1], -1, 2)
        theta, phi = ang[..., 0], ang[..., 1]
        delta = self.delta_neighbours(angles_to_vec(state))
        ct, st = torch.cos(theta), torch.sin(theta)
        cp, sp = torch.cos(phi), torch.sin(phi)
        dS_dtheta = -self.beta * ((delta[..., 0] * cp
                                   + delta[..., 1] * sp) * ct
                                  - delta[..., 2] * st)
        dS_dphi = -self.beta * (-delta[..., 0] * sp
                                + delta[..., 1] * cp) * st
        out = torch.stack([dS_dtheta, dS_dphi], dim=-1)
        return out.reshape(state.shape)

    def initialise_state(self, generator, n_chains, dtype, device):
        """Random unit spins: normalised Gaussian vectors, uniform on the
        sphere (the reference normalises a shell draw,
        nonlinearsigmaaction.cc:142-163)."""
        v = normal(generator, (n_chains, self.lattice.nvertices, 3), dtype,
                   device)
        return vec_to_angles(v / torch.linalg.norm(v, dim=-1, keepdim=True))

    # -- heat bath / overrelaxation, gather form -------------------------------

    @staticmethod
    def _perp(delta_hat):
        """'Best perpendicular' unit vector (nonlinearsigmaaction.cc:36-59):
        zero the absolutely smallest component, rotate the other two."""
        a = torch.abs(delta_hat)
        idx = torch.argmin(a, dim=-1, keepdim=True)
        amin = torch.gather(a, -1, idx)[..., 0]
        rho_inv = 1.0 / torch.sqrt(torch.clamp(1.0 - amin * amin, min=TINY))
        d0, d1, d2 = delta_hat[..., 0], delta_hat[..., 1], delta_hat[..., 2]
        z = torch.zeros_like(d0)
        p0 = torch.stack([z, -d2 * rho_inv, +d1 * rho_inv], dim=-1)
        p1 = torch.stack([-d2 * rho_inv, z, +d0 * rho_inv], dim=-1)
        p2 = torch.stack([+d1 * rho_inv, -d0 * rho_inv, z], dim=-1)
        sel = torch.nn.functional.one_hot(idx[..., 0], 3).to(
            delta_hat.dtype)
        return (sel[..., 0:1] * p0 + sel[..., 1:2] * p1
                + sel[..., 2:3] * p2)

    @staticmethod
    def _rodrigues(v, axis, angle):
        """Rotate v around the unit vector ``axis`` by ``angle``."""
        c = torch.cos(angle)[..., None]
        s = torch.sin(angle)[..., None]
        dot = torch.sum(axis * v, dim=-1, keepdim=True)
        return v * c + torch.cross(axis, v, dim=-1) * s + axis * dot * (1.0
                                                                     - c)

    def _heatbath_colour(self, generator, vec, colour):
        """Exact conditional redraw of the spins at the vertices
        ``colour`` (nonlinearsigmaaction.cc:24-73)."""
        idx = self._tensor(("vertices", colour.tobytes()), colour,
                           vec.device)
        delta = self.delta_neighbours(vec)[..., idx, :]
        nrm = torch.linalg.norm(delta, dim=-1)
        delta_hat = delta / torch.clamp(nrm, min=TINY)[..., None]
        sig_par = CompactExpDistribution.draw(
            generator, self.beta * torch.clamp(nrm, min=TINY))
        sig_perp = torch.sqrt(torch.clamp(1.0 - sig_par * sig_par, min=0.0))
        perp = self._perp(delta_hat)
        new = sig_par[..., None] * delta_hat + sig_perp[..., None] * perp
        az = uniform(generator, nrm.shape, vec.dtype, vec.device, -math.pi,
                     math.pi)
        out = vec.clone()
        out[..., idx, :] = self._rodrigues(new, delta_hat, az)
        return out

    def heatbath_sweep(self, generator, state):
        vec = angles_to_vec(state)
        for colour in self._colour_masks:
            vec = self._heatbath_colour(generator, vec, colour)
        return vec_to_angles(vec)

    def overrelaxation_sweep(self, state):
        """Reflect each spin about its neighbour-sum direction
        (nonlinearsigmaaction.cc:76-94)."""
        vec = angles_to_vec(state)
        for colour in self._colour_masks:
            idx = self._tensor(("vertices", colour.tobytes()), colour,
                               vec.device)
            delta = self.delta_neighbours(vec)[..., idx, :]
            delta_hat = delta / torch.clamp(
                torch.linalg.norm(delta, dim=-1), min=TINY)[..., None]
            s = vec[..., idx, :]
            dot = torch.sum(s * delta_hat, dim=-1, keepdim=True)
            vec = vec.clone()
            vec[..., idx, :] = 2.0 * dot * delta_hat - s
        return vec_to_angles(vec)

    # -- grid form (unrotated lattices) ----------------------------------------

    @cached_property
    def _grid_red(self) -> np.ndarray:
        """[Mx, Mt] red checkerboard ((i + j) even; i = axis 1)."""
        i = np.arange(self.lattice.Mt_lat)[None, :]
        j = np.arange(self.lattice.Mx_lat)[:, None]
        return (i + j) % 2 == 0

    @staticmethod
    def _grid_delta(g):
        """4-nearest-neighbour spin sum of each [C, Mx, Mt] component
        plane, in the JAX package's order (j - 1, j + 1, i - 1, i + 1)."""
        def nn(p):
            return (torch.roll(p, 1, -2) + torch.roll(p, -1, -2)
                    + torch.roll(p, 1, -1) + torch.roll(p, -1, -1))
        return tuple(nn(p) for p in g)

    def _grid_unit_delta(self, g):
        dx, dy, dz = self._grid_delta(g)
        nrm = torch.sqrt(dx * dx + dy * dy + dz * dz)
        r = 1.0 / torch.clamp(nrm, min=TINY)
        return dx * r, dy * r, dz * r, nrm

    def _grid_heatbath_colour(self, generator, g, mask):
        gx, gy, gz = g
        hx, hy, hz, nrm = self._grid_unit_delta(g)
        sig_par = CompactExpDistribution.draw(
            generator, self.beta * torch.clamp(nrm, min=TINY))
        sig_perp = torch.sqrt(torch.clamp(1.0 - sig_par * sig_par, min=0.0))
        # 'best perpendicular' (the rule of _perp): zero the absolutely
        # smallest component of delta_hat, rotate the other two
        a0, a1, a2 = torch.abs(hx), torch.abs(hy), torch.abs(hz)
        m0 = (a0 <= a1) & (a0 <= a2)
        m1 = (~m0) & (a1 <= a2)
        amin = torch.where(m0, a0, torch.where(m1, a1, a2))
        rho_inv = 1.0 / torch.sqrt(torch.clamp(1.0 - amin * amin, min=TINY))
        zero = torch.zeros_like(hx)
        px = torch.where(m0, zero, torch.where(m1, -hz, hy)) * rho_inv
        py = torch.where(m0, -hz, torch.where(m1, zero, -hx)) * rho_inv
        pz = torch.where(m0, hy, torch.where(m1, hx, zero)) * rho_inv
        nx = sig_par * hx + sig_perp * px
        ny = sig_par * hy + sig_perp * py
        nz = sig_par * hz + sig_perp * pz
        # Rodrigues rotation of (nx, ny, nz) about (hx, hy, hz) by the
        # azimuth
        az = uniform(generator, nrm.shape, gx.dtype, gx.device, -math.pi,
                     math.pi)
        c, s = torch.cos(az), torch.sin(az)
        dot = hx * nx + hy * ny + hz * nz
        cx = hy * nz - hz * ny
        cy = hz * nx - hx * nz
        cz = hx * ny - hy * nx
        d1c = dot * (1.0 - c)
        nx = nx * c + cx * s + hx * d1c
        ny = ny * c + cy * s + hy * d1c
        nz = nz * c + cz * s + hz * d1c
        return (torch.where(mask, nx, gx), torch.where(mask, ny, gy),
                torch.where(mask, nz, gz))

    def _grid_overrelax_colour(self, g, mask):
        gx, gy, gz = g
        hx, hy, hz, _ = self._grid_unit_delta(g)
        dot2 = 2.0 * (gx * hx + gy * hy + gz * hz)
        return (torch.where(mask, dot2 * hx - gx, gx),
                torch.where(mask, dot2 * hy - gy, gy),
                torch.where(mask, dot2 * hz - gz, gz))

    def combined_sweeps(self, generator, state, n_overrelax, n_heatbath):
        """All overrelaxation then heat-bath sweeps of one draw in one
        grid-form pass: the conditional updates of the sweep methods above
        (the rolls reproduce _nn on unrotated lattices); only the noise
        layout differs.  Rotated lattices and unbatched states take the
        gather form."""
        if self.lattice.rotated or state.ndim != 2:
            for _ in range(n_overrelax):
                state = self.overrelaxation_sweep(state)
            for _ in range(n_heatbath):
                state = self.heatbath_sweep(generator, state)
            return state
        Mt, Mx = self.lattice.Mt_lat, self.lattice.Mx_lat
        C = state.shape[0]
        # angles -> [C, Mx, Mt] planes (the formulas of angles_to_vec)
        theta = state[:, 0::2].reshape(C, Mx, Mt)
        phi = state[:, 1::2].reshape(C, Mx, Mt)
        st = torch.sin(theta)
        g = (st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta))
        red = self._tensor("red", self._grid_red, state.device)
        black = ~red
        for _ in range(n_overrelax):
            g = self._grid_overrelax_colour(g, red)
            g = self._grid_overrelax_colour(g, black)
        for _ in range(n_heatbath):
            g = self._grid_heatbath_colour(generator, g, red)
            g = self._grid_heatbath_colour(generator, g, black)
        gx, gy, gz = g
        phi = torch.atan2(gy, gx)
        theta = torch.atan2(torch.sqrt(gx * gx + gy * gy), gz)
        return torch.stack([theta.reshape(C, -1), phi.reshape(C, -1)],
                           dim=-1).reshape(C, -1)

    # -- cluster hooks (nonlinearsigmaaction.cc:166-210) -----------------------

    @staticmethod
    def new_reflection(generator, n_chains, dtype, device):
        """A uniform random unit reflection vector per chain: [C, 3]."""
        v = normal(generator, (n_chains, 3), dtype, device)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    def S_ell_vec(self, vec_i, vec_j, r):
        """Bond energy -2 beta (r.sigma_i)(r.sigma_j); r: [..., 3]."""
        return (-2.0 * self.beta * torch.sum(r * vec_i, dim=-1)
                * torch.sum(r * vec_j, dim=-1))

    @staticmethod
    def flip_vec(vec, r):
        """sigma -> sigma - 2 (sigma.r) r."""
        return vec - 2.0 * torch.sum(vec * r, dim=-1, keepdim=True) * r

    # -- multigrid -------------------------------------------------------------

    @staticmethod
    def _dof_map(vertex_idx) -> np.ndarray:
        """(theta, phi) dof indices of the given vertices."""
        return np.stack([2 * vertex_idx, 2 * vertex_idx + 1],
                        axis=-1).reshape(-1)

    def prolongate(self, state_coarse, state_fine):
        lat = self.lattice
        out = state_fine.clone()
        out[..., self._tensor("dst", self._dof_map(lat.coarse_vertices),
                              out.device)] = state_coarse[..., self._tensor(
                                  "src", self._dof_map(lat.fine2coarse),
                                  out.device)]
        return out

    def restrict(self, state_fine):
        lat = self.lattice
        inv = np.empty(lat.coarse_lattice().nvertices, dtype=np.int64)
        inv[lat.fine2coarse] = lat.coarse_vertices
        return state_fine[..., self._tensor("restrict", self._dof_map(inv),
                                            state_fine.device)]

    def coarse_action(self) -> "NonlinearSigmaAction":
        """beta_c = beta - log(2)/(4 pi) with perturbative renormalisation
        (nonlinearsigmarenormalisation.hh:58-76)."""
        if self.renormalisation is RenormalisationType.PERTURBATIVE:
            beta_c = self.beta - 0.5 * math.log(2.0) / (2.0 * math.pi)
        elif self.renormalisation is RenormalisationType.NONPERTURBATIVE:
            raise NotImplementedError(
                "nonperturbative renormalisation not implemented for the "
                "sigma model (matches reference)")
        else:
            beta_c = self.beta
        return NonlinearSigmaAction(self.lattice.coarse_lattice(), beta_c,
                                    self.renormalisation)

    def info_string(self):
        return f"NonlinearSigma({self.lattice}, beta={self.beta})"


def qoi_magnetic_susceptibility(action):
    """|sum_n sigma_n|^2 / N (qoi2dmagneticsusceptibility.cc:6-21), from
    the angles directly."""
    def evaluate(state):
        ang = state.reshape(*state.shape[:-1], -1, 2)
        theta, phi = ang[..., 0], ang[..., 1]
        st = torch.sin(theta)
        mx = torch.sum(st * torch.cos(phi), dim=-1)
        my = torch.sum(st * torch.sin(phi), dim=-1)
        mz = torch.sum(torch.cos(theta), dim=-1)
        return (mx * mx + my * my + mz * mz) / action.lattice.nvertices
    return evaluate
