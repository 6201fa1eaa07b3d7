"""Topological rotor (quantum-mechanical particle on a circle)
(PyTorch port of ``mlmcpathintegral_tpu/models/rotor.py``).

S[x] = (I/a) sum_j (1 - cos(x_j - x_{j-1})), x_j in [-pi, pi).

Reference parity: src/action/qm/rotoraction.{hh,cc} and
rotorrenormalisation.{hh,cc}.  The rotor is also a ClusterAction: the
Wolff reflection is h(x) = pi + 2 xbar - x with bond energy
S_ell = -2 (I/a) cos(x_i - xbar) cos(x_{i+1} - xbar)
(rotoraction.hh:226-268).
"""

from __future__ import annotations

import math

import torch

from mlmcpathintegral_tpu_torch.distributions.expsin2 import (
    ExpSin2Distribution,
)
from mlmcpathintegral_tpu_torch.distributions.rejection import uniform
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.models.base import (
    QMAction, RenormalisationType,
)
from mlmcpathintegral_tpu_torch.utils.special import (
    Phi_chit, Sigma_hat, mod_2pi,
)


class RotorAction(QMAction):
    """Quantum rotor action; ``m0`` is the moment of inertia I."""

    def __init__(self, lattice: Lattice1D,
                 renormalisation: RenormalisationType =
                 RenormalisationType.NONE,
                 m0: float = 1.0):
        super().__init__(lattice, renormalisation, m0)

    # -- action ----------------------------------------------------------------

    def evaluate(self, x):
        """S = (I/a) sum_j (1 - cos(x_j - x_{j-1})) (rotoraction.cc:8-17)."""
        dx = x - torch.roll(x, 1, dims=-1)
        return (self.m0 / self.a_lat) * torch.sum(1.0 - torch.cos(dx),
                                                  dim=-1)

    def force(self, x):
        """P_j = (I/a)(sin(x_j - x_{j-1}) + sin(x_j - x_{j+1}))
        (rotoraction.cc:59-81)."""
        x_m = torch.roll(x, 1, dims=-1)
        x_p = torch.roll(x, -1, dims=-1)
        return (self.m0 / self.a_lat) * (torch.sin(x - x_m)
                                         + torch.sin(x - x_p))

    def initialise_state(self, generator, n_chains, dtype, device):
        """Uniform in [-pi, pi) (rotoraction.cc:84-89)."""
        return uniform(generator, (n_chains, self.M_lat), dtype, device,
                       -math.pi, math.pi)

    # -- conditioned single-site geometry --------------------------------------

    def getWcurvature(self, x_m, x_p):
        """W'' = 2 I/a |cos((x_+ - x_-)/2)| (rotoraction.hh:195-205)."""
        return (2.0 * self.m0 / self.a_lat
                * torch.abs(torch.cos(0.5 * (x_p - x_m))))

    def getWminimum(self, x_m, x_p):
        """x0 = atan2(sin x_- + sin x_+, cos x_- + cos x_+)
        (rotoraction.hh:207-220)."""
        return torch.atan2(torch.sin(x_p) + torch.sin(x_m),
                           torch.cos(x_p) + torch.cos(x_m))

    def heatbath_site(self, generator, x_m, x_p, x_cur=None):
        """x = mod_2pi(x0 + ExpSin2(sigma=2 W'')), the exact conditional
        of a site given both neighbours (rotoraction.cc:20-37).  With
        ``x_cur`` the rejection loop is truncated at 6 rounds and
        stragglers keep the current value (an exact identity mixture)."""
        x0 = self.getWminimum(x_m, x_p)
        sigma = 2.0 * self.getWcurvature(x_m, x_p)
        if x_cur is None:
            xi = ExpSin2Distribution.draw(generator, sigma)
        else:
            xi = ExpSin2Distribution.draw(
                generator, sigma, fallback=mod_2pi(x_cur - x0), max_iter=6)
        return mod_2pi(x0 + xi)

    def overrelax_site(self, x, x_m, x_p):
        """x -> mod_2pi(2 x0 - x) (rotoraction.cc:40-56)."""
        return mod_2pi(2.0 * self.getWminimum(x_m, x_p) - x)

    # -- cluster-action hooks (Wolff; rotoraction.hh:226-268) ------------------

    @staticmethod
    def new_reflection(generator, n_chains, dtype, device):
        """Per-chain reflection angle xbar ~ U[-pi, pi)."""
        return uniform(generator, (n_chains,), dtype, device, -math.pi,
                       math.pi)

    def S_ell(self, x_i, x_j, xbar):
        """Bond energy S_ell = -2 (I/a) cos(x_i - xbar) cos(x_j - xbar)."""
        return (-2.0 * self.m0 / self.a_lat
                * torch.cos(x_i - xbar) * torch.cos(x_j - xbar))

    @staticmethod
    def flip(x, xbar):
        """h(x) = mod_2pi(pi + 2 xbar - x)."""
        return mod_2pi(math.pi + 2.0 * xbar - x)

    # -- multigrid -------------------------------------------------------------

    def coarse_action(self) -> "RotorAction":
        """Coarsen with renormalised moment of inertia
        (rotorrenormalisation.hh:38-58, rotorrenormalisation.cc:7-14)."""
        if self.renormalisation is RenormalisationType.PERTURBATIVE:
            xi = self.lattice.T_final / self.m0
            m0c = (1.0 + _deltaI(xi) * self.a_lat / self.m0) * self.m0
        elif self.renormalisation is RenormalisationType.NONPERTURBATIVE:
            raise NotImplementedError(
                "nonperturbative renormalisation not implemented for rotor "
                "(matches reference rotorrenormalisation.hh:52-57)")
        else:
            m0c = self.m0
        return RotorAction(self.lattice.coarse_lattice(),
                           self.renormalisation, m0c)

    # -- analytics (rotoraction.cc:92-121) -------------------------------------

    def chit_exact(self) -> float:
        """chi_t at finite lattice spacing: (1/I) Phi(I/a, T/a)."""
        return 1.0 / self.m0 * Phi_chit(
            self.m0 / self.a_lat, round(self.lattice.T_final / self.a_lat))

    def chit_perturbative(self) -> float:
        xi = self.lattice.T_final / self.m0
        z = self.a_lat / self.m0
        S2 = Sigma_hat(xi, 2)
        S4 = Sigma_hat(xi, 4)
        return (1.0 / (4.0 * math.pi**2 * self.m0)
                * (1.0 - xi * S2
                   + (0.5 - xi * S2
                      + 0.25 * xi * xi * (S4 - S2 * S2)) * z))

    def chit_continuum(self) -> float:
        xi = self.lattice.T_final / self.m0
        return (1.0 / (4.0 * math.pi**2 * self.m0)
                * (1.0 - xi * Sigma_hat(xi, 2)))

    def info_string(self):
        return f"Rotor(M={self.M_lat}, a={self.a_lat:.5f}, I={self.m0})"


def _deltaI(xi: float) -> float:
    """delta_I(xi) for the perturbative renormalisation
    (rotorrenormalisation.cc:7-14)."""
    S2 = Sigma_hat(xi, 2)
    S4 = Sigma_hat(xi, 4)
    num = 1.0 - 2.0 * xi * S2 + 0.5 * xi * xi * (S4 - S2 * S2)
    den = 1.0 - 2.0 * xi * S2 + xi * xi * (S4 - S2 * S2)
    return 0.5 * num / den
