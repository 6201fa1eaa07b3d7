"""Conditioned fine action of the O(3) sigma model (PyTorch port of
``mlmcpathintegral_tpu/conditioned/sigma.py``; reference
src/action/qft/nonlinearsigmaconditionedfineaction.{hh,cc}).

The fill is the exact single-site heat bath (the gather form of
``NonlinearSigmaAction``) at every fine-only vertex, all of whose nearest
neighbours are coarse on the rotate hierarchy, so the fills are
conditionally independent and run at once.  ``evaluate`` is the
CompactExp log-density of each filled spin's projection onto its
neighbour sum (the uniform azimuth's factor is constant and cancels).
"""

from __future__ import annotations

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.conditioned.base import ConditionedFineAction
from mlmcpathintegral_tpu_torch.distributions.compactexp import (
    CompactExpDistribution,
)
from mlmcpathintegral_tpu_torch.models.qft.nonlinearsigma import (
    TINY, angles_to_vec, vec_to_angles,
)


class NonlinearSigmaConditionedFineAction(ConditionedFineAction):

    def __init__(self, action):
        super().__init__(action)
        lat = action.lattice
        self.beta = action.beta
        self._fineonly = lat.fineonly_vertices
        self._nn_fine = lat.neighbour_vertices[self._fineonly, :4]
        coarse = np.zeros(lat.nvertices, bool)
        coarse[lat.coarse_vertices] = True
        if not coarse[self._nn_fine].all():
            raise ValueError("sigma fill-in needs all-coarse neighbours at "
                             "fine-only vertices (CoarsenRotate)")

    def fill_fine_points(self, generator, state):
        vec = self.action._heatbath_colour(generator, angles_to_vec(state),
                                           self._fineonly)
        return vec_to_angles(vec)

    def evaluate(self, state):
        vec = angles_to_vec(state)
        dev = vec.device
        nn = torch.as_tensor(self._nn_fine, dtype=torch.int64, device=dev)
        fine = torch.as_tensor(self._fineonly, dtype=torch.int64, device=dev)
        delta = torch.sum(vec[..., nn, :], dim=-2)
        nrm = torch.linalg.norm(delta, dim=-1)
        z = torch.sum(vec[..., fine, :] * delta, dim=-1) \
            / torch.clamp(nrm, min=TINY)
        return -torch.sum(CompactExpDistribution.log_evaluate(
            z, self.beta * nrm), dim=-1)
