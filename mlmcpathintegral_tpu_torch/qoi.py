"""Quantities of interest (PyTorch port of ``mlmcpathintegral_tpu/qoi.py``):
batched functions x[..., ndof] -> [...]."""

from __future__ import annotations

import math

import torch

from mlmcpathintegral_tpu_torch.utils.special import mod_2pi

FOUR_PI2_INV = 1.0 / (4.0 * math.pi * math.pi)


def _lattice_of(obj):
    """Accept either a lattice or an action (the reference's QoIFactory
    takes actions, quantityofinterest.hh:26-36)."""
    return getattr(obj, "lattice", obj)


def qoi_x_squared(lattice):
    """<X^2> estimator: (1/M) sum_j x_j^2 (qoixsquared.cc:3-19)."""
    def evaluate(x):
        return torch.mean(x * x, dim=-1)
    return evaluate


def qoi_susceptibility(lattice):
    """Topological susceptibility chi_t = Q[x]^2 / T with winding number
    Q = (1/2pi) sum_j mod_2pi(x_j - x_{j-1}) (qoisusceptibility.cc:3-19)."""
    T_final = _lattice_of(lattice).T_final

    def evaluate(x):
        dx = x - torch.roll(x, 1, dims=-1)
        Q = torch.sum(mod_2pi(dx), dim=-1)
        return FOUR_PI2_INV * Q * Q / T_final
    return evaluate


def qoi_2d_susceptibility(action):
    """V chi_t = Q^2/(4 pi^2), Q = sum_P mod_2pi(theta_P) over plaquettes
    of a gauge action (qoi2dsusceptibility.cc:6-28)."""
    def evaluate(theta):
        plaq = action.plaquette_angles(theta)
        Q = torch.sum(mod_2pi(plaq), dim=(-2, -1))
        return FOUR_PI2_INV * Q * Q
    return evaluate


def qoi_avg_plaquette(action):
    """(1/(Mt Mx)) sum_P cos(theta_P) (qoiavgplaquette.cc:6-27)."""
    def evaluate(theta):
        return torch.mean(torch.cos(action.plaquette_angles(theta)),
                          dim=(-2, -1))
    return evaluate


def qoi_2d_phi_squared(action_or_lattice):
    """(1/M) sum phi^2 for scalar 2-D fields (qoi2dphisquared.cc:3-11)."""
    def evaluate(phi):
        return torch.mean(phi * phi, dim=-1)
    return evaluate


def make_qoi(name: str, obj):
    """Factory by name (the analog of QoIFactory wiring in driver_qm.cc /
    driver_qft.cc)."""
    if name == "x_squared":
        return qoi_x_squared(obj)
    if name == "susceptibility":
        return qoi_susceptibility(obj)
    if name == "2d_susceptibility":
        return qoi_2d_susceptibility(obj)
    if name == "avg_plaquette":
        return qoi_avg_plaquette(obj)
    if name == "2d_phi_squared":
        return qoi_2d_phi_squared(obj)
    raise ValueError(f"unknown QoI '{name}'")
