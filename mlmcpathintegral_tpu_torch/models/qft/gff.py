"""Gaussian free field on a 2-D periodic lattice (PyTorch port of
``mlmcpathintegral_tpu/models/qft/gff.py``).

S[phi] = 1/2 phi^T Q phi with the 5-point stencil Q = (4+mu2) I - sum of
nearest-neighbour shifts, mu2 = a^2 m^2 and a = 1/Mt (unrotated) or
sqrt(2)/Mt (rotated) — reference: src/action/qft/gffaction.{hh,cc}
(stencil gffaction.cc:7-29, a_lat rule gffaction.hh:174-180).

Exact draws: spectral on unrotated lattices, phi = Re[ifft2(fft2(z) /
sqrt(lambda))] with lambda the stencil symbol (``torch.fft``); a dense
host-side inverse Cholesky factor applied as one [C,N]x[N,N] matmul on
rotated ones (the reference solves with a sparse Cholesky factor,
gffaction.cc:133-213).

Gibbs-smoothed effective coarse action (gffaction.cc:45-65, 133-174):
coloured SOR-Gibbs sweeps w.r.t. a 9-point effective action, and the
matching smoothed precision Q_hat, computed once on the host in numpy
(dense, small coarse lattices), so that draw and evaluate stay exactly
consistent.  The per-draw dense algebra runs as
``torch.matmul`` on the chains' device.  Noise comes from the run's
``torch.Generator``.
"""

from __future__ import annotations

import math
import warnings
from functools import cached_property

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import normal
from mlmcpathintegral_tpu_torch.lattice2d import Lattice2D
from mlmcpathintegral_tpu_torch.models.base import Action, RenormalisationType
from mlmcpathintegral_tpu_torch.utils.special import (
    gff_phi_squared_analytical,
)


def _index(idx: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


class GFFAction(Action):

    def __init__(self, lattice: Lattice2D, mass: float,
                 n_gibbs_smooth: int = 0, omega: float = 1.0):
        self.lattice = lattice
        self.mass = float(mass)
        self.n_gibbs_smooth = int(n_gibbs_smooth)
        self.omega = float(omega)
        self.renormalisation = RenormalisationType.NONE
        if self.n_gibbs_smooth > 0 and lattice.nvertices > 4096:
            warnings.warn(
                f"GFFAction: n_gibbs_smooth={n_gibbs_smooth} on a "
                f"{lattice.nvertices}-vertex lattice — the smoothed Q_hat "
                f"is dense, so heat-bath/overrelaxation sweeps become an "
                f"O(N^2) sequential Gibbs scan (_dense_gibbs_sweep).  The "
                f"smoothed action is intended for COARSE levels "
                f"(gffaction.hh:201-208); use n_gibbs_smooth=0 on fine "
                f"lattices.", stacklevel=2)
        if lattice.rotated:
            self.a_lat = math.sqrt(2.0) / lattice.Mt_lat
        else:
            self.a_lat = 1.0 / lattice.Mt_lat
        self.mu2 = self.a_lat * self.a_lat * self.mass * self.mass

    @property
    def ndof(self) -> int:
        return self.lattice.nvertices

    # -- index helpers ---------------------------------------------------------

    @cached_property
    def _nn(self) -> np.ndarray:
        """[N, 4] nearest-neighbour gather indices."""
        return self.lattice.neighbour_vertices[:, :4]

    @cached_property
    def _nn8(self) -> np.ndarray:
        return self.lattice.neighbour_vertices

    @cached_property
    def _colour_masks(self):
        """Red/black split such that all 4 nearest neighbours of a site have
        the other colour: (i+j)%2 on unrotated lattices, i%2 on rotated."""
        ell = np.arange(self.lattice.nvertices)
        i, j = self.lattice.vertex_lin2cart(ell)
        if self.lattice.rotated:
            red = (i % 2 == 0)
        else:
            red = ((i + j) % 2 == 0)
        return np.flatnonzero(red), np.flatnonzero(~red)

    def _nbsum(self, phi):
        """Sum of the 4 nearest neighbours, [..., N]: four periodic rolls
        of the [..., Mx, Mt] grid on unrotated lattices (in the XLA order
        (i-1) + (i+1) + (j-1) + (j+1)), the neighbour table on rotated
        ones."""
        lat = self.lattice
        if not lat.rotated:
            Mt, Mx = lat.Mt_lat, lat.Mx_lat
            g = phi.reshape(phi.shape[:-1] + (Mx, Mt))
            s = (torch.roll(g, 1, -1) + torch.roll(g, -1, -1)
                 + torch.roll(g, 1, -2) + torch.roll(g, -1, -2))
            return s.reshape(phi.shape)
        return torch.sum(phi[..., _index(self._nn, phi.device)], dim=-1)

    # -- action ----------------------------------------------------------------

    def evaluate(self, phi):
        """1/2 phi^T Q phi (5-point stencil) or 1/2 phi^T Q_hat phi when
        Gibbs-smoothed (gffaction.cc:7-29)."""
        if self.n_gibbs_smooth > 0:
            Qhat = torch.as_tensor(self._Q_hat, dtype=phi.dtype,
                                   device=phi.device)
            return 0.5 * torch.einsum("...i,ij,...j->...", phi, Qhat, phi)
        kappa = 4.0 + self.mu2
        return 0.5 * torch.sum(phi * (kappa * phi - self._nbsum(phi)), dim=-1)

    def force(self, phi):
        """Q phi (gffaction.cc:80-96); equals grad(evaluate) for the
        unsmoothed action."""
        if self.n_gibbs_smooth > 0:
            Qhat = torch.as_tensor(self._Q_hat, dtype=phi.dtype,
                                   device=phi.device)
            return torch.matmul(phi, Qhat)
        return (4.0 + self.mu2) * phi - self._nbsum(phi)

    def initialise_state(self, generator, n_chains, dtype, device):
        return self.exact_draw(generator, n_chains, dtype, device)

    # -- heat bath / overrelaxation (checkerboard) -----------------------------

    def heatbath_sweep(self, generator, phi):
        """One heat-bath sweep.  Unsmoothed: red/black on the 5-point
        stencil, phi_ell ~ N(Delta/(4+mu2), 1/(4+mu2)) (gffaction.cc:33-42).
        Gibbs-smoothed: a sequential single-site Gibbs scan w.r.t. the
        dense Q_hat, which keeps the sweep consistent with the smoothed
        ``evaluate`` of the two-level acceptance ratio (the reference
        sweeps the plain stencil there, which samples another law)."""
        if self.n_gibbs_smooth > 0:
            return self._dense_gibbs_sweep(generator, phi, overrelax=False)
        kappa = 4.0 + self.mu2
        sigma = 1.0 / math.sqrt(kappa)
        for colour in self._colour_masks:
            idx = _index(colour, phi.device)
            delta = self._nbsum(phi)[..., idx]
            xi = normal(generator, delta.shape, phi.dtype, phi.device)
            phi = phi.clone()
            phi[..., idx] = delta / kappa + sigma * xi
        return phi

    def overrelaxation_sweep(self, phi):
        """phi_ell -> 2 Delta/(4+mu2) - phi_ell (gffaction.cc:68-78);
        smoothed actions reflect around the Q_hat conditional mean."""
        if self.n_gibbs_smooth > 0:
            return self._dense_gibbs_sweep(None, phi, overrelax=True)
        kappa = 4.0 + self.mu2
        for colour in self._colour_masks:
            idx = _index(colour, phi.device)
            delta = self._nbsum(phi)[..., idx]
            phi = phi.clone()
            phi[..., idx] = 2.0 * delta / kappa - phi[..., idx]
        return phi

    def _dense_gibbs_sweep(self, generator, phi, *, overrelax: bool):
        """Sequential site-by-site Gibbs (or overrelaxation) sweep for the
        dense smoothed precision Q_hat: phi_i | rest ~
        N(-sum_{j!=i} Qhat_ij phi_j / Qhat_ii, 1/Qhat_ii), N rank-1
        updates of the [chains, N] field (the coarse lattice is small)."""
        Qhat = torch.as_tensor(self._Q_hat, dtype=phi.dtype,
                               device=phi.device)
        diag = torch.diagonal(Qhat)
        N = phi.shape[-1]
        noise = None if overrelax else normal(
            generator, (N,) + tuple(phi.shape[:-1]), phi.dtype, phi.device)
        phi = phi.clone()
        for i in range(N):
            qii = diag[i]
            delta = torch.tensordot(phi, Qhat[i], dims=([-1], [0])) \
                - phi[..., i] * qii
            mean = -delta / qii
            if overrelax:
                phi[..., i] = 2.0 * mean - phi[..., i]
            else:
                phi[..., i] = mean + noise[i] / torch.sqrt(qii)
        return phi

    # -- multigrid transfer ----------------------------------------------------

    def prolongate(self, phi_coarse, phi_fine):
        """Inject coarse dofs at the coarse vertices (gffaction.cc:99-108)."""
        lat = self.lattice
        out = phi_fine.clone()
        out[..., _index(lat.coarse_vertices, out.device)] = \
            phi_coarse[..., _index(lat.fine2coarse, out.device)]
        return out

    def restrict(self, phi_fine):
        """Extract the coarse dofs (gffaction.cc:111-119)."""
        lat = self.lattice
        inv = np.empty(lat.coarse_lattice().nvertices, dtype=np.int64)
        inv[lat.fine2coarse] = lat.coarse_vertices
        return phi_fine[..., _index(inv, phi_fine.device)]

    def coarse_action(self) -> "GFFAction":
        """Coarse level always uses 2 Gibbs smoothing steps with omega=1
        (gffaction.hh:201-208)."""
        return GFFAction(self.lattice.coarse_lattice(), self.mass,
                         n_gibbs_smooth=2, omega=1.0)

    # -- dense matrices (host, built once; only when needed) -------------------

    def _build_Q(self, stencil) -> np.ndarray:
        """Dense precision matrix from a stencil [diag, nn, (diag-nn)]
        with duplicate-index accumulation (gffaction.cc:178-199)."""
        N = self.lattice.nvertices
        Q = np.zeros((N, N))
        Q[np.arange(N), np.arange(N)] = stencil[0]
        nb = self._nn8
        for j, coeff in enumerate(stencil[1:]):
            for k in range(4):
                np.add.at(Q, (np.arange(N), nb[:, 4 * j + k]), coeff)
        return Q

    @cached_property
    def _Q_precision(self) -> np.ndarray:
        return self._build_Q([4.0 + self.mu2, -1.0])

    @cached_property
    def _Q_eff(self) -> np.ndarray:
        """9-point effective action stencil (gffaction.cc:143-147)."""
        c = 4.0 + 0.5 * self.mu2
        return self._build_Q([c - 4.0 / c, -2.0 / c, -1.0 / c])

    @cached_property
    def _eff_colour_groups(self):
        """Greedy graph colouring of the Q_eff adjacency: sites of one
        colour never couple through Q_eff, so updating a whole colour at
        once is an exact sequential Gibbs step (the 9-point stencil couples
        diagonal neighbours: 4 colours typically result)."""
        Q = self._Q_eff
        N = Q.shape[0]
        adj = (np.abs(Q) > 1e-14) & ~np.eye(N, dtype=bool)
        colour = np.full(N, -1)
        for v in range(N):
            used = set(colour[adj[v]]) - {-1}
            c = 0
            while c in used:
                c += 1
            colour[v] = c
        return [np.flatnonzero(colour == c)
                for c in range(int(colour.max()) + 1)]

    @cached_property
    def _smoother_matrices(self):
        """G^k for the coloured SOR-Gibbs smoother of Q_eff:
        G = I - M^-1 Q_eff with M = D/omega + (couplings from
        earlier-updated colours), the exact splitting of
        :meth:`gibbs_sweep_eff`."""
        Q = self._Q_eff
        N = Q.shape[0]
        D = np.diag(Q).copy()
        order = np.empty(N, dtype=np.int64)
        for rank, grp in enumerate(self._eff_colour_groups):
            order[grp] = rank
        M = np.diag(D / self.omega)
        earlier = order[:, None] > order[None, :]
        M[earlier] = Q[earlier]
        G1 = np.eye(N) - np.linalg.solve(M, Q)
        return np.linalg.matrix_power(G1, self.n_gibbs_smooth)

    @cached_property
    def _Q_hat(self) -> np.ndarray:
        """Precision of the k-times-smoothed exact draw:
        Q_hat = (Sigma_eff + G^k (Sigma - Sigma_eff) G^k^T)^-1
        (gffaction.cc:133-174, with the coloured G)."""
        Sigma = np.linalg.inv(self._Q_precision)
        Sigma_eff = np.linalg.inv(self._Q_eff)
        Gk = self._smoother_matrices
        cov = Sigma_eff + Gk @ (Sigma - Sigma_eff) @ Gk.T
        return np.linalg.inv(cov)

    # -- exact sampling --------------------------------------------------------

    @cached_property
    def _spectral_sqrt_inv(self) -> np.ndarray:
        """1/sqrt(lambda) on the (Mx, Mt) FFT grid for the unrotated
        5-point stencil."""
        Mt, Mx = self.lattice.Mt_lat, self.lattice.Mx_lat
        ki = 2.0 * math.pi * np.arange(Mt) / Mt
        kj = 2.0 * math.pi * np.arange(Mx) / Mx
        lam = (4.0 + self.mu2 - 2.0 * np.cos(ki)[None, :]
               - 2.0 * np.cos(kj)[:, None])
        return 1.0 / np.sqrt(lam)

    @cached_property
    def _dense_sqrt_cov(self) -> np.ndarray:
        """L^-1 with Q = L L^T, for rotated lattices (row-vector form:
        phi = z @ L_inv has covariance Q^-1)."""
        return np.linalg.inv(np.linalg.cholesky(self._Q_precision))

    @cached_property
    def _dense_sqrt_cov_hat(self) -> np.ndarray:
        """L^-1 with Q_hat = L L^T: the closed-form factor of the
        Gibbs-smoothed covariance (the constructive draw, an unsmoothed
        exact draw and k coloured Gibbs sweeps, has covariance exactly
        Q_hat^-1)."""
        return np.linalg.inv(np.linalg.cholesky(self._Q_hat))

    def _dense_draw(self, z, factor: np.ndarray):
        return torch.matmul(z, torch.as_tensor(factor, dtype=z.dtype,
                                               device=z.device))

    def _draw_unsmoothed(self, generator, n_chains, dtype, device):
        lat = self.lattice
        z = normal(generator, (n_chains, lat.nvertices), dtype, device)
        if lat.rotated:
            return self._dense_draw(z, self._dense_sqrt_cov)
        Mt, Mx = lat.Mt_lat, lat.Mx_lat
        zg = z.reshape(n_chains, Mx, Mt)
        filt = torch.as_tensor(self._spectral_sqrt_inv, dtype=dtype,
                               device=z.device)
        phig = torch.fft.ifft2(torch.fft.fft2(zg) * filt).real
        # .real is a strided view: the fields go on as contiguous tensors
        return phig.reshape(n_chains, lat.nvertices).to(dtype).contiguous()

    def gibbs_sweep_eff(self, generator, phi):
        """One coloured SOR-Gibbs sweep w.r.t. Q_eff, exactly the iteration
        matrix of ``_Q_hat`` (cf. gffaction.cc:45-65; the colour groups are
        conflict-free, so each group update is an exact Gibbs step)."""
        Q_eff = self._Q_eff
        D = np.diag(Q_eff)
        om = self.omega
        gamma = math.sqrt(om * (2.0 - om))
        for colour in self._eff_colour_groups:
            idx = _index(colour, phi.device)
            Q_rows = torch.as_tensor(Q_eff[colour], dtype=phi.dtype,
                                     device=phi.device)
            d = torch.as_tensor(D[colour], dtype=phi.dtype,
                                device=phi.device)
            off = torch.matmul(phi, Q_rows.T) - phi[..., idx] * d
            mu = -off / d
            xi = normal(generator, mu.shape, phi.dtype, phi.device)
            new = ((1.0 - om) * phi[..., idx] + om * mu
                   + gamma * xi / torch.sqrt(d))
            phi = phi.clone()
            phi[..., idx] = new
        return phi

    def exact_draw(self, generator, n_chains, dtype, device):
        """Exact sample of the (possibly Gibbs-smoothed) action
        (gffaction.cc:200-213)."""
        if self.n_gibbs_smooth == 0:
            return self._draw_unsmoothed(generator, n_chains, dtype, device)
        if self.lattice.nvertices <= 4096:
            # the dense closed-form factor of the smoothed covariance: one
            # matmul instead of k Gibbs sweeps per draw
            z = normal(generator, (n_chains, self.lattice.nvertices), dtype,
                       device)
            return self._dense_draw(z, self._dense_sqrt_cov_hat)
        phi = self._draw_unsmoothed(generator, n_chains, dtype, device)
        for _ in range(self.n_gibbs_smooth):
            phi = self.gibbs_sweep_eff(generator, phi)
        return phi

    def exact_draw_with_action(self, generator, n_chains, dtype, device):
        """(x, S(x)) for exact draws.  For the dense Gaussian factor
        x = z L^-1 the action is 1/2 x^T Q x = 1/2 sum z^2 in closed form
        from the driving normals (no [n, N] @ [N, N] evaluate)."""
        lat = self.lattice
        dense_ok = lat.nvertices <= 4096 and (
            self.n_gibbs_smooth > 0 or lat.rotated)
        if dense_ok:
            z = normal(generator, (n_chains, lat.nvertices), dtype, device)
            Li = (self._dense_sqrt_cov_hat if self.n_gibbs_smooth > 0
                  else self._dense_sqrt_cov)
            return self._dense_draw(z, Li), 0.5 * torch.sum(z * z, dim=-1)
        x = self.exact_draw(generator, n_chains, dtype, device)
        return x, self.evaluate(x)

    # -- analytics -------------------------------------------------------------

    def phi_squared_analytical(self) -> float:
        """Spectral sum for <phi^2> (src/common/auxilliary.cc:197-209)."""
        lat = self.lattice
        if lat.rotated:
            # the rotated lattice's own spectrum through the dense
            # precision matrix (small lattices only)
            Sigma = np.linalg.inv(self._Q_precision)
            return float(np.trace(Sigma) / lat.nvertices)
        # unrotated: mu2 = m^2/Mt^2; auxilliary.cc uses m^2/(Mt*Mx)
        mass_eff = self.mass * math.sqrt(lat.Mx_lat / lat.Mt_lat)
        return gff_phi_squared_analytical(mass_eff, lat.Mt_lat, lat.Mx_lat)

    def info_string(self):
        return (f"GFF({self.lattice}, mass={self.mass}, mu2={self.mu2:.6f}, "
                f"n_gibbs={self.n_gibbs_smooth})")
