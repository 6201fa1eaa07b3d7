"""Conditioned fine actions of the quenched Schwinger model (PyTorch port
of ``mlmcpathintegral_tpu/conditioned/schwinger.py``; reference
src/action/qft/quenchedschwingerconditionedfineaction.{hh,cc}).

For both-direction coarsening:

Given coarse links prolongated onto the fine lattice, the fill runs in
three vectorised steps (cc:7-78):

  STEP 1: add +-u (uniform) to the two fine halves of every coarse link;
  STEP 2: draw the sum of the two interior vertical links of each coarse
          cell from BesselProduct (beta <= 8) or its large-beta Gaussian
          mixture, then split it uniformly;
  STEP 3: draw every interior horizontal link from ExpCos given its two
          (now fixed) plaquette staples.

``evaluate`` includes the exact series normalisation log Z(Phi) of the
BesselProduct (cc:212-290).  The fused kernel (ops/schwinger_twolevel.py)
runs the same fill in-kernel; this plain version builds the initial state
of the screened chain and serves the unfused levels.

``QuenchedSchwingerGaussianConditionedFineAction`` draws the four interior
links of each coarse cell at once from the 4-D Gaussian approximation
(``GaussianFillinDistribution``); like the JAX package's, it is reached
only by constructing it (the factory never returns it).
``QuenchedSchwingerSemiConditionedFineAction`` fills temporal- or
spatial-only coarsening in two steps: randomise the split of each halved
link, then draw each interior link of the kept direction from ExpCos
(cc:136-209).  Noise comes from the run's ``torch.Generator``, in the JAX
package's order of keys.
"""

from __future__ import annotations

import math

import torch

from mlmcpathintegral_tpu_torch.conditioned.base import ConditionedFineAction
from mlmcpathintegral_tpu_torch.distributions.approxbesselproduct import (
    ApproximateBesselProductDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.besselproduct import (
    BesselProductDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.expcos import (
    ExpCosDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.gaussianfillin import (
    GaussianFillinDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.rejection import uniform
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType
from mlmcpathintegral_tpu_torch.utils.special import mod_2pi

PI = math.pi


def _cell(A, a_i, b_j):
    """A(2i + a_i, 2j + b_j) over all coarse cells; A: [..., Mx, Mt] ->
    [..., Mx/2, Mt/2]."""
    out = A
    if a_i:
        out = torch.roll(out, -a_i, dims=-1)
    if b_j:
        out = torch.roll(out, -b_j, dims=-2)
    return out[..., ::2, ::2]


def _rowcell(A, a_i, b_j):
    """A(i + a_i, 2j + b_j) over all i and coarse rows; -> [..., Mx/2, Mt]."""
    out = A
    if a_i:
        out = torch.roll(out, -a_i, dims=-1)
    if b_j:
        out = torch.roll(out, -b_j, dims=-2)
    return out[..., ::2, :]


class QuenchedSchwingerConditionedFineAction(ConditionedFineAction):
    """Full (both-direction) coarsening fill; beta > 8 takes the
    large-beta Gaussian-mixture branch."""

    def __init__(self, action):
        super().__init__(action)
        self.beta = action.beta
        if self.beta > 8.0:
            self.bessel = None
            self.approx = ApproximateBesselProductDistribution(self.beta)
        else:
            self.bessel = BesselProductDistribution(self.beta)
            self.approx = None

    # -- fill (cc:7-78) --------------------------------------------------------

    def fill_fine_points(self, generator, theta):
        act = self.action
        g = act._grid(theta)
        T, X = g[..., 0].clone(), g[..., 1].clone()
        cshape = (*T.shape[:-2], T.shape[-2] // 2, T.shape[-1] // 2)
        dtype, device = T.dtype, T.device

        # STEP 1: perimeter randomisation
        _perimeter_split(generator, T, X)

        # STEP 2: interior vertical links (sum from BesselProduct, split
        # uniformly)
        theta_p = mod_2pi(_cell(T, 1, 0) + _cell(X, 2, 0)
                          + _cell(X, 2, 1) - _cell(T, 1, 2))
        theta_m = mod_2pi(_cell(X, 0, 0) + _cell(X, 0, 1)
                          + _cell(T, 0, 2) - _cell(T, 0, 0))
        dist = self.bessel if self.bessel is not None else self.approx
        theta_tilde = dist.draw(generator, theta_p, theta_m)
        u = uniform(generator, cshape, dtype, device, -PI, PI)
        X[..., ::2, 1::2] = mod_2pi(0.5 * theta_tilde + u)
        X[..., 1::2, 1::2] = mod_2pi(0.5 * theta_tilde - u)

        # STEP 3: interior horizontal links from ExpCos
        tp = mod_2pi(_rowcell(T, 0, 0) + _rowcell(X, 1, 0)
                     - _rowcell(X, 0, 0))
        tm = mod_2pi(_rowcell(X, 0, 1) + _rowcell(T, 0, 2)
                     - _rowcell(X, 1, 1))
        T[..., 1::2, :] = ExpCosDistribution.draw(generator, self.beta, tp,
                                                  tm)
        return act._flat(torch.stack([T, X], dim=-1))

    # -- evaluate (cc:212-290) -------------------------------------------------

    def evaluate(self, theta):
        g = self.action._grid(theta)
        T, X = g[..., 0], g[..., 1]
        if self.bessel is not None:
            phi_12 = _cell(X, 0, 1) + _cell(T, 0, 2)
            phi_23 = _cell(T, 1, 2) - _cell(X, 2, 1)
            phi_34 = -_cell(T, 1, 0) - _cell(X, 2, 0)
            phi_41 = -_cell(T, 0, 0) + _cell(X, 0, 0)
            th_1 = _cell(T, 0, 1)
            th_2 = -_cell(X, 1, 1)
            th_3 = -_cell(T, 1, 1)
            th_4 = _cell(X, 1, 0)
            Phi = phi_12 + phi_23 + phi_34 + phi_41
            S = -self.beta * torch.sum(
                torch.cos(th_1 - th_2 - phi_12)
                + torch.cos(th_2 - th_3 - phi_23)
                + torch.cos(th_3 - th_4 - phi_34)
                + torch.cos(th_4 - th_1 - phi_41), dim=(-2, -1))
            return S - torch.sum(self.bessel.log_Znorm_inv(Phi,
                                                           rescaled=True),
                                 dim=(-2, -1))
        # large-beta branch: vertical-sum density + horizontal ExpCos terms
        phi_p = mod_2pi(_cell(T, 1, 0) + _cell(X, 2, 0)
                        + _cell(X, 2, 1) - _cell(T, 1, 2))
        phi_m = mod_2pi(-_cell(T, 0, 0) + _cell(X, 0, 0)
                        + _cell(X, 0, 1) + _cell(T, 0, 2))
        th = mod_2pi(_cell(X, 1, 0) + _cell(X, 1, 1))
        S = -torch.sum(self.approx.log_evaluate(th, phi_p, phi_m),
                       dim=(-2, -1))
        tp = mod_2pi(-_rowcell(X, 0, 0) + _rowcell(T, 0, 0)
                     + _rowcell(X, 1, 0))
        tm = mod_2pi(_rowcell(X, 0, 1) + _rowcell(T, 0, 2)
                     - _rowcell(X, 1, 1))
        th_h = mod_2pi(_rowcell(T, 0, 1))
        return S - torch.sum(ExpCosDistribution.log_evaluate(
            th_h, self.beta, tp, tm), dim=(-2, -1))


def _perimeter_split(generator, T, X):
    """STEP 1 of the both-direction fills: add +-u to the two fine halves
    of every coarse link (in place; the coarse sums stay)."""
    cshape = (*T.shape[:-2], T.shape[-2] // 2, T.shape[-1] // 2)
    u_t = uniform(generator, cshape, T.dtype, T.device, -PI, PI)
    u_x = uniform(generator, cshape, T.dtype, T.device, -PI, PI)
    T[..., ::2, ::2] = mod_2pi(T[..., ::2, ::2] + u_t)
    T[..., ::2, 1::2] = mod_2pi(T[..., ::2, 1::2] - u_t)
    X[..., ::2, ::2] = mod_2pi(X[..., ::2, ::2] + u_x)
    X[..., 1::2, ::2] = mod_2pi(X[..., 1::2, ::2] - u_x)


class QuenchedSchwingerGaussianConditionedFineAction(ConditionedFineAction):
    """Gaussian-approximation fill: the four interior links of each coarse
    cell drawn at once from the 4-D GaussianFillinDistribution (cc:81-133,
    293-326)."""

    def __init__(self, action):
        super().__init__(action)
        self.beta = action.beta
        self.gaussian = GaussianFillinDistribution(self.beta,
                                                   add_gaussian_noise=True)

    @staticmethod
    def _cell_phis(T, X):
        phi_12 = mod_2pi(_cell(X, 0, 1) + _cell(T, 0, 2))
        phi_23 = mod_2pi(_cell(T, 1, 2) - _cell(X, 2, 1))
        phi_34 = mod_2pi(-_cell(X, 2, 0) - _cell(T, 1, 0))
        phi_41 = mod_2pi(-_cell(T, 0, 0) + _cell(X, 0, 0))
        return phi_12, phi_23, phi_34, phi_41

    def fill_fine_points(self, generator, theta):
        act = self.action
        g = act._grid(theta)
        T, X = g[..., 0].clone(), g[..., 1].clone()
        _perimeter_split(generator, T, X)
        # STEP 2+3: the joint interior fill
        th1, th2, th3, th4 = self.gaussian.draw(generator,
                                                *self._cell_phis(T, X))
        T[..., 1::2, ::2] = th1        # T(2i, 2j+1)   = +theta_1
        X[..., 1::2, 1::2] = -th2      # X(2i+1, 2j+1) = -theta_2
        T[..., 1::2, 1::2] = -th3      # T(2i+1, 2j+1) = -theta_3
        X[..., ::2, 1::2] = th4        # X(2i+1, 2j)   = +theta_4
        return act._flat(torch.stack([T, X], dim=-1))

    def evaluate(self, theta):
        g = self.action._grid(theta)
        T, X = g[..., 0], g[..., 1]
        th1 = mod_2pi(_cell(T, 0, 1))
        th2 = mod_2pi(-_cell(X, 1, 1))
        th3 = mod_2pi(-_cell(T, 1, 1))
        th4 = mod_2pi(_cell(X, 1, 0))
        return -torch.sum(self.gaussian.log_evaluate(
            th1, th2, th3, th4, *self._cell_phis(T, X)), dim=(-2, -1))


def _colcell(A, a_i, b_j):
    """A(2i + a_i, j + b_j) over all j and coarse columns; A: [..., Mx, Mt]
    -> [..., Mx, Mt/2]."""
    out = A
    if a_i:
        out = torch.roll(out, -a_i, dims=-1)
    if b_j:
        out = torch.roll(out, -b_j, dims=-2)
    return out[..., :, ::2]


class QuenchedSchwingerSemiConditionedFineAction(ConditionedFineAction):
    """Fill for temporal- or spatial-only coarsening (cc:136-209)."""

    def __init__(self, action):
        super().__init__(action)
        self.beta = action.beta
        self.case = action._coarsen_case()
        if self.case not in ("temporal", "spatial"):
            raise ValueError("semi fill-in needs temporal/spatial coarsening")

    def fill_fine_points(self, generator, theta):
        act = self.action
        g = act._grid(theta)
        T, X = g[..., 0].clone(), g[..., 1].clone()
        dtype, dev = T.dtype, T.device
        Mx, Mt = T.shape[-2], T.shape[-1]
        if self.case == "temporal":
            # randomise the split of every coarse temporal link
            u = uniform(generator, (*T.shape[:-2], Mx, Mt // 2), dtype, dev,
                        -PI, PI)
            T[..., :, ::2] = mod_2pi(T[..., :, ::2] + u)
            T[..., :, 1::2] = mod_2pi(T[..., :, 1::2] - u)
            # interior spatial links X(2i+1, j) from ExpCos
            tp = mod_2pi(_colcell(X, 0, 0) + _colcell(T, 0, 1)
                         - _colcell(T, 0, 0))
            tm = mod_2pi(_colcell(T, 1, 0) + _colcell(X, 2, 0)
                         - _colcell(T, 1, 1))
            X[..., :, 1::2] = ExpCosDistribution.draw(generator, self.beta,
                                                      tp, tm)
        else:
            u = uniform(generator, (*X.shape[:-2], Mx // 2, Mt), dtype, dev,
                        -PI, PI)
            X[..., ::2, :] = mod_2pi(X[..., ::2, :] + u)
            X[..., 1::2, :] = mod_2pi(X[..., 1::2, :] - u)
            # interior temporal links T(i, 2j+1) from ExpCos
            tp = mod_2pi(_rowcell(T, 0, 0) + _rowcell(X, 1, 0)
                         - _rowcell(X, 0, 0))
            tm = mod_2pi(_rowcell(X, 0, 1) + _rowcell(T, 0, 2)
                         - _rowcell(X, 1, 1))
            T[..., 1::2, :] = ExpCosDistribution.draw(generator, self.beta,
                                                      tp, tm)
        return act._flat(torch.stack([T, X], dim=-1))

    def evaluate(self, theta):
        g = self.action._grid(theta)
        T, X = g[..., 0], g[..., 1]
        if self.case == "temporal":
            phi_p = mod_2pi(-_colcell(T, 0, 0) + _colcell(X, 0, 0)
                            + _colcell(T, 0, 1))
            phi_m = mod_2pi(_colcell(T, 1, 0) + _colcell(X, 2, 0)
                            - _colcell(T, 1, 1))
            th = mod_2pi(_colcell(X, 1, 0))
        else:
            phi_p = mod_2pi(-_rowcell(X, 0, 0) + _rowcell(T, 0, 0)
                            + _rowcell(X, 1, 0))
            phi_m = mod_2pi(_rowcell(X, 0, 1) + _rowcell(T, 0, 2)
                            - _rowcell(X, 1, 1))
            th = mod_2pi(_rowcell(T, 0, 1))
        return -torch.sum(ExpCosDistribution.log_evaluate(
            th, self.beta, phi_p, phi_m), dim=(-2, -1))


def make_schwinger_conditioned_fine_action(action) -> ConditionedFineAction:
    """Factory by coarsening type
    (quenchedschwingerconditionedfineaction.hh:215-238)."""
    if action.lattice.coarsening_type is CoarseningType.BOTH:
        return QuenchedSchwingerConditionedFineAction(action)
    return QuenchedSchwingerSemiConditionedFineAction(action)
