"""Conditioned fine actions of the 1-D QM models (PyTorch port of
``mlmcpathintegral_tpu/conditioned/qm.py``).

Reference parity:
  * GaussianConditionedFineAction — src/action/qm/gaussianconditionedfineaction.cc:
    odd sites ~ N(Wminimum, 1/Wcurvature), evaluate = sum of
    1/2 W'' dx^2 - 1/2 log W'' (the Gaussian log-density up to a constant).
  * RotorConditionedFineAction — src/action/qm/rotorconditionedfineaction.cc:
    odd sites ~ mod_2pi(x0 + ExpSin2(sigma = 2 W'')), evaluate =
    -log p_ExpSin2(dx; sigma) with the exact Bessel normalisation.

The odd sites are conditionally independent given the even ones, so a
fill is one batched draw over [..., M/2] sites.
"""

from __future__ import annotations

import torch

from mlmcpathintegral_tpu_torch.conditioned.base import ConditionedFineAction
from mlmcpathintegral_tpu_torch.distributions.expsin2 import (
    ExpSin2Distribution,
)
from mlmcpathintegral_tpu_torch.distributions.rejection import normal
from mlmcpathintegral_tpu_torch.utils.special import mod_2pi


def _even_neighbours(x):
    """For odd sites 2j+1: left neighbour x[2j], right neighbour x[2j+2]
    (periodic); each [..., M/2]."""
    x_even = x[..., ::2]
    return x_even, torch.roll(x_even, -1, dims=-1)


def _with_odd(x, odd):
    out = x.clone()
    out[..., 1::2] = odd
    return out


class GaussianConditionedFineAction(ConditionedFineAction):
    """Fill odd sites from N(Wminimum, 1/Wcurvature)."""

    def fill_fine_points(self, generator, x):
        x_m, x_p = _even_neighbours(x)
        x0 = self.action.getWminimum(x_m, x_p)
        curv = self.action.getWcurvature(x_m, x_p)
        xi = normal(generator, x0.shape, x.dtype, x.device)
        return _with_odd(x, x0 + xi / torch.sqrt(curv))

    def evaluate(self, x):
        x_m, x_p = _even_neighbours(x)
        dx = x[..., 1::2] - self.action.getWminimum(x_m, x_p)
        curv = self.action.getWcurvature(x_m, x_p)
        return torch.sum(0.5 * curv * dx * dx - 0.5 * torch.log(curv),
                         dim=-1)


class RotorConditionedFineAction(ConditionedFineAction):
    """Fill odd sites from the exact ExpSin2 conditional of the rotor."""

    def fill_fine_points(self, generator, x):
        x_m, x_p = _even_neighbours(x)
        x0 = self.action.getWminimum(x_m, x_p)
        sigma = 2.0 * self.action.getWcurvature(x_m, x_p)
        xi = ExpSin2Distribution.draw(generator, sigma)
        return _with_odd(x, mod_2pi(x0 + xi))

    def evaluate(self, x):
        x_m, x_p = _even_neighbours(x)
        dx = x[..., 1::2] - self.action.getWminimum(x_m, x_p)
        sigma = 2.0 * self.action.getWcurvature(x_m, x_p)
        return -torch.sum(ExpSin2Distribution.log_evaluate(dx, sigma),
                          dim=-1)


def make_conditioned_fine_action(action) -> ConditionedFineAction:
    """The conditioned fine action matching the action's type (the
    per-model ConditionedFineActionFactory of driver_qm.cc:305-335)."""
    from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
    if isinstance(action, RotorAction):
        return RotorConditionedFineAction(action)
    return GaussianConditionedFineAction(action)
