"""Overrelaxed heat-bath sampler (PyTorch port of
``mlmcpathintegral_tpu/samplers/heatbath.py``, quenched Schwinger only).

Reference parity: src/sampler/overrelaxedheatbathsampler.{hh,cc} —
n_sweep_overrelax overrelaxation sweeps followed by n_sweep_heatbath
heat-bath sweeps.  The action supplies coloured whole-lattice sweeps
(4 conflict-free link groups).  With ``use_pallas`` a draw is one launch
of the fused sweep kernel (ops/schwinger.py; the name is the JAX
package's, whose fused kernels were Pallas); otherwise the action's plain
tensor sweeps run with noise from the ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mlmcpathintegral_tpu_torch.samplers.base import Sampler, kernel_seed
from mlmcpathintegral_tpu_torch.utils.special import mod_2pi


class HeatBathState(NamedTuple):
    x: torch.Tensor   # [C, ndof]


class OverrelaxedHeatBathSampler(Sampler):

    def __init__(self, action, n_sweep_heatbath: int = 1,
                 n_sweep_overrelax: int = 1, n_burnin: int = 100,
                 use_pallas: bool = False):
        from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
            QuenchedSchwingerAction,
        )
        if type(action) is not QuenchedSchwingerAction:
            raise NotImplementedError(
                "the ported heat-bath sampler covers the quenched Schwinger "
                "action only; the QM, rotor and GFF sweeps are later "
                "slices (ROADMAP.md, open items 10-11)")
        super().__init__(action)
        self.n_sweep_heatbath = int(n_sweep_heatbath)
        self.n_sweep_overrelax = int(n_sweep_overrelax)
        self.n_burnin = int(n_burnin)
        self.use_pallas = bool(use_pallas)

    def init(self, generator, n_chains, dtype, device):
        return HeatBathState(x=self.action.initialise_state(
            generator, n_chains, dtype, device))

    def _kernel_kw(self):
        lat = self.action.lattice
        return dict(beta=self.action.beta, Mt=lat.Mt_lat, Mx=lat.Mx_lat,
                    n_overrelax=self.n_sweep_overrelax,
                    n_heatbath=self.n_sweep_heatbath)

    def draw(self, generator, state: HeatBathState):
        x = state.x
        if self.use_pallas:
            from mlmcpathintegral_tpu_torch.ops.schwinger import (
                schwinger_sweep,
            )
            x = schwinger_sweep(x, kernel_seed(generator),
                                **self._kernel_kw())
        else:
            for _ in range(self.n_sweep_overrelax):
                x = self.action.overrelaxation_sweep(x)
            for _ in range(self.n_sweep_heatbath):
                x = self.action.heatbath_sweep(generator, x)
        accept = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        return HeatBathState(x=x), accept

    def draw_chain(self, generator, state: HeatBathState, n_steps: int):
        """``n_steps`` consecutive draws, returning ``(state', qsum)`` with
        qsum[s, c] = sum_P mod_2pi(theta_P) after step s.  With
        ``use_pallas`` this is one launch of the sweep-chain kernel."""
        x = state.x
        if self.use_pallas:
            from mlmcpathintegral_tpu_torch.ops.schwinger import (
                schwinger_sweep_chain,
            )
            x, qsum = schwinger_sweep_chain(x, kernel_seed(generator),
                                            n_steps=n_steps,
                                            **self._kernel_kw())
            return HeatBathState(x=x), qsum
        qs = []
        for _ in range(n_steps):
            state, _ = self.draw(generator, state)
            qs.append(torch.sum(mod_2pi(self.action.plaquette_angles(
                state.x)), dim=(-2, -1)))
        return state, torch.stack(qs)

    def prepare(self, generator, n_chains, dtype, device):
        return super().prepare(generator, n_chains, dtype, device,
                               self.n_burnin)
