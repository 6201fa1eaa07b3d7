"""Gaussian fill-in distribution: a 4-D joint approximation of the
plaquette fill pi(theta_1..theta_4 | phi_12, phi_23, phi_34, phi_41)
(PyTorch port of ``mlmcpathintegral_tpu/distributions/gaussianfillin.py``;
reference src/distribution/gaussianfillindistribution.{hh,cc}).

The four interior link angles of a coarse Schwinger cell are a 3-D eta
subspace plus a uniform gauge shift omega; the density in eta is a
two-component Gaussian mixture (main peak at 0, secondary at
(pi, 0, pi/2)) with widths set by 4 beta cos/sin(Phi*), with periodic
copies of the peaks for beta <= 72.  Draw and evaluate form a consistent
pair.  A draw takes, in order, the mixture's uniforms, three normals a
cell and the gauge uniforms from its ``torch.Generator``.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import (
    normal, uniform,
)
from mlmcpathintegral_tpu_torch.utils.special import mod_2pi

PI = math.pi


def _construct_peaks(n_offsets: int):
    """Peak locations in units of pi/2 with periodic offset copies
    (gaussianfillindistribution.cc:77-121)."""
    p_main = [(0, 0, 0), (2, 2, 2), (-2, 2, 2), (2, -2, 2), (-2, -2, 2),
              (2, 2, -2), (-2, 2, -2), (2, -2, -2), (-2, -2, -2)]
    p_secondary = [(2, 0, 1), (-2, 0, 1), (0, 2, -1), (0, -2, -1)]
    rng = range(-n_offsets, n_offsets + 1)
    main, secondary = set(), set()
    for kx, ky, kz in itertools.product(rng, rng, rng):
        off = (4 * kx, 4 * ky, 4 * kz)
        for p in p_main:
            main.add(tuple(a + b for a, b in zip(p, off)))
        for p in p_secondary:
            secondary.add(tuple(a + b for a, b in zip(p, off)))

    def conv(s):
        return 0.5 * PI * np.asarray(sorted(s), dtype=float)
    return conv(main), conv(secondary)


class GaussianFillinDistribution:

    def __init__(self, beta: float, add_gaussian_noise: bool = True):
        if not add_gaussian_noise:
            raise ValueError("sampling only from peak is broken in the "
                             "reference and unsupported here "
                             "(gaussianfillindistribution.hh:58-62)")
        self.beta = float(beta)
        n_offsets = 0 if beta > 72.0 else 1
        self.main_peaks, self.secondary_peaks = _construct_peaks(n_offsets)

    def _get_pc(self, Phi_star):
        """Main-peak probability (gaussianfillindistribution.hh:176-189)."""
        beta = self.beta
        s2p = beta * torch.cos(Phi_star)
        s2m = beta * torch.sin(Phi_star)
        rho = ((s2p / torch.clamp(s2m, min=1e-300)) ** 1.5
               * torch.exp(-4.0 * (s2p - s2m)))
        pc = 1.0 / (1.0 + rho)
        pc = torch.where(Phi_star < 0.125 * PI, 1.0, pc)
        return torch.where(Phi_star > 0.375 * PI, 0.0, pc)

    @staticmethod
    def _fold(Phi):
        """Map Phi to Phi* in [0, pi/2] with (swap, shift) bookkeeping."""
        swap = Phi < 0
        Phi_star = torch.abs(Phi)
        shift = Phi_star > 0.5 * PI
        swap = swap ^ shift
        Phi_star = torch.where(shift, PI - Phi_star, Phi_star)
        return Phi_star, swap, shift

    def draw(self, generator, phi_12, phi_23, phi_34, phi_41):
        """(theta_1..theta_4), each of the phis' broadcast shape
        (gaussianfillindistribution.hh:85-140)."""
        phi_12, phi_23, phi_34, phi_41 = torch.broadcast_tensors(
            phi_12, phi_23, phi_34, phi_41)
        shape, dtype, dev = phi_12.shape, phi_12.dtype, phi_12.device
        Phi = 0.25 * (phi_12 + phi_23 + phi_34 + phi_41)
        Phi_star, swap, shift = self._fold(Phi)
        p_c = self._get_pc(Phi_star)
        main = uniform(generator, shape, dtype, dev) < p_c
        sigma = torch.where(
            main, 1.0 / torch.sqrt(4.0 * self.beta * torch.cos(Phi_star)),
            1.0 / torch.sqrt(torch.clamp(
                4.0 * self.beta * torch.sin(Phi_star), min=1e-300)))
        secondary = (~main).to(dtype)
        e1 = PI * secondary
        e2 = torch.zeros(shape, dtype=dtype, device=dev)
        e3 = 0.5 * PI * secondary
        xi = normal(generator, (*shape, 3), dtype, dev)
        sqrt2 = math.sqrt(2.0)
        e1 = e1 + sqrt2 * sigma * xi[..., 0]
        e2 = e2 + sqrt2 * sigma * xi[..., 1]
        e3 = e3 + sigma * xi[..., 2]
        e1, e2 = torch.where(swap, e2, e1), torch.where(swap, e1, e2)
        e1 = torch.where(shift, e1 + PI, e1)
        e2 = torch.where(shift, e2 + PI, e2)
        omega = 2.0 * PI * uniform(generator, shape, dtype, dev)
        th1 = mod_2pi(0.5 * (+e1 + e2 + e3) + omega)
        th2 = mod_2pi(0.5 * (+e1 - e2 - e3) + omega + Phi - phi_12)
        th3 = mod_2pi(0.5 * (-e1 - e2 + e3) + omega + 2.0 * Phi
                      - phi_12 - phi_23)
        th4 = mod_2pi(0.5 * (-e1 + e2 - e3) + omega + 3.0 * Phi
                      - phi_12 - phi_23 - phi_34)
        return th1, th2, th3, th4

    def evaluate(self, theta_1, theta_2, theta_3, theta_4,
                 phi_12, phi_23, phi_34, phi_41):
        """Mixture density in the eta subspace
        (gaussianfillindistribution.cc:6-75)."""
        e1 = mod_2pi(0.5 * (theta_1 + theta_2 - theta_3 - theta_4)
                     + 0.5 * (phi_41 - phi_23))
        e2 = mod_2pi(0.5 * (theta_1 - theta_2 - theta_3 + theta_4)
                     + 0.5 * (phi_34 - phi_12))
        e3 = mod_2pi(0.5 * (theta_1 - theta_2 + theta_3 - theta_4)
                     + 0.25 * (-phi_12 + phi_23 - phi_34 + phi_41))
        Phi = 0.25 * (phi_12 + phi_23 + phi_34 + phi_41)
        Phi_star, swap, shift = self._fold(Phi)
        e1 = torch.where(shift, mod_2pi(e1 + PI), e1)
        e2 = torch.where(shift, mod_2pi(e2 + PI), e2)
        e1, e2 = torch.where(swap, e2, e1), torch.where(swap, e1, e2)
        p_c = self._get_pc(Phi_star)
        s2c = 2.0 * self.beta * torch.cos(Phi_star)
        s2s = 2.0 * self.beta * torch.sin(Phi_star)

        def peak_sum(peaks, s2inv):
            p = torch.as_tensor(peaks, dtype=e1.dtype, device=e1.device)
            d1 = e1[..., None] - p[:, 0]
            d2 = e2[..., None] - p[:, 1]
            d3 = e3[..., None] - p[:, 2]
            Q = d1 * d1 + d2 * d2 + 2.0 * d3 * d3
            return torch.sum(torch.exp(-0.5 * s2inv[..., None] * Q), dim=-1)

        g_c = peak_sum(self.main_peaks, s2c)
        g_s = peak_sum(self.secondary_peaks, s2s)
        norm_c = s2c ** 1.5
        norm_s = torch.clamp(s2s, min=0.0) ** 1.5
        return p_c * norm_c * g_c + (1.0 - p_c) * norm_s * g_s

    def log_evaluate(self, *args):
        return torch.log(torch.clamp(self.evaluate(*args), min=1e-300))
