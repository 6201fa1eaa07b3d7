"""Conditioned fine action of the Gaussian free field (PyTorch port of
``mlmcpathintegral_tpu/conditioned/gff.py``; reference
src/action/qft/gffconditionedfineaction.{hh,cc}).

The fill draws every fine-only vertex from the exact single-site
conditional of the 5-point stencil, phi ~ N(Delta/(4+mu2), 1/(4+mu2));
``evaluate`` is the sum of the matching Gaussian energies (the constant
-1/2 log kappa a site cancels in every two-level difference, so the
reference omits it, and so does this port).

The reference fills the fine-only vertices one after another
(gffconditionedfineaction.cc:7-25), which is consistent only when all 4
nearest neighbours of every fine-only vertex are coarse: true for the
CoarsenRotate hierarchy.  The fill here draws all fine-only vertices at
once and the constructor checks that property.  On an unrotated fine
lattice the fine-only vertices are the odd checkerboard of the [Mx, Mt]
grid, and fill and evaluate run as periodic rolls and a parity mask.
Noise comes from the run's ``torch.Generator`` through
``distributions.rejection.normal``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.conditioned.base import ConditionedFineAction
from mlmcpathintegral_tpu_torch.distributions.rejection import normal


class GFFConditionedFineAction(ConditionedFineAction):

    def __init__(self, action):
        super().__init__(action)
        lat = action.lattice
        self.mu2 = action.mu2
        self._fineonly = lat.fineonly_vertices
        self._nn_fine = lat.neighbour_vertices[self._fineonly, :4]
        coarse = np.zeros(lat.nvertices, bool)
        coarse[lat.coarse_vertices] = True
        if not coarse[self._nn_fine].all():
            raise ValueError(
                "GFF conditioned fill-in needs every fine-only vertex to "
                "have only coarse nearest neighbours (use CoarsenRotate, "
                "cf. gffconditionedfineaction.cc:7-25)")
        #: the fine-only mask of the flat unrotated field, else None
        self._grid_mask = None
        if not lat.rotated:
            i = np.arange(lat.Mt_lat)[None, :]
            j = np.arange(lat.Mx_lat)[:, None]
            self._grid_mask = ((i + j) % 2 == 1).reshape(-1)
        if self._grid_mask is None or action.n_gibbs_smooth:
            # shadow the one-pass hook: the batched screen probes for it
            # and then falls back to fill + evaluate
            self.fill_with_logq_sf = None

    def _mask(self, phi):
        return torch.as_tensor(self._grid_mask, device=phi.device)

    def _gather(self, phi):
        """(fine-only indices, the neighbour sum at each) on a rotated
        fine lattice."""
        dev = phi.device
        nn = torch.as_tensor(self._nn_fine, dtype=torch.int64, device=dev)
        fine = torch.as_tensor(self._fineonly, dtype=torch.int64, device=dev)
        return fine, torch.sum(phi[..., nn], dim=-1)

    def fill_fine_points(self, generator, phi):
        return self.fill_with_logq(generator, phi)[0]

    def fill_with_logq(self, generator, phi):
        """Fill, and the filled state's conditioned action in one pass:
        for the exact Gaussian conditional it is 1/2 kappa (sigma xi)^2
        summed over the fine-only sites, 1/2 sum xi^2 (the constant
        omitted as in :meth:`evaluate`), with no second stencil pass over
        the [S, C, ndof] proposals."""
        kappa = 4.0 + self.mu2
        sigma = 1.0 / math.sqrt(kappa)
        if self._grid_mask is not None:
            m = self._mask(phi)
            delta = self.action._nbsum(phi)
            xi = normal(generator, phi.shape, phi.dtype, phi.device)
            g = torch.where(m, sigma * xi + delta / kappa, phi)
            return g, 0.5 * torch.sum(torch.where(m, xi * xi, 0.0), dim=-1)
        fine, delta = self._gather(phi)
        xi = normal(generator, delta.shape, phi.dtype, phi.device)
        g = phi.clone()
        g[..., fine] = sigma * (xi + sigma * delta)
        return g, 0.5 * torch.sum(xi * xi, dim=-1)

    def fill_with_logq_sf(self, generator, phi):
        """Fill, S_cond and S_fine of the filled state in one stencil pass.

        Every edge of the fine lattice joins a coarse (even) and a filled
        (odd) vertex, so with delta = nbsum(phi), whose odd entries read
        only the even plane the fill leaves alone,

            S_fine(phi') = 1/2 kappa sum phi'^2 - sum_odd phi'_odd delta
            S_cond(phi') = 1/2 sum xi^2.

        Shadowed to None in __init__ where this closed form does not hold
        (a rotated fine lattice or a Gibbs-smoothed action)."""
        kappa = 4.0 + self.mu2
        sigma = 1.0 / math.sqrt(kappa)
        m = self._mask(phi)
        delta = self.action._nbsum(phi)
        xi = normal(generator, phi.shape, phi.dtype, phi.device)
        g = torch.where(m, sigma * xi + delta / kappa, phi)
        S_q = 0.5 * torch.sum(torch.where(m, xi * xi, 0.0), dim=-1)
        S_f = (0.5 * kappa * torch.sum(g * g, dim=-1)
               - torch.sum(torch.where(m, g * delta, 0.0), dim=-1))
        return g, S_q, S_f

    def evaluate(self, phi):
        kappa = 4.0 + self.mu2
        if self._grid_mask is not None:
            dphi = phi - self.action._nbsum(phi) / kappa
            return 0.5 * kappa * torch.sum(
                torch.where(self._mask(phi), dphi * dphi, 0.0), dim=-1)
        fine, delta = self._gather(phi)
        dphi = phi[..., fine] - delta / kappa
        return 0.5 * kappa * torch.sum(dphi * dphi, dim=-1)
