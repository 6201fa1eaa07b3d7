"""Overrelaxed heat-bath sampler (PyTorch port of
``mlmcpathintegral_tpu/samplers/heatbath.py``).

Reference parity: src/sampler/overrelaxedheatbathsampler.{hh,cc} —
n_sweep_overrelax overrelaxation sweeps followed by n_sweep_heatbath
heat-bath sweeps.  Actions with coloured whole-lattice sweeps (the
quenched Schwinger action's 4 conflict-free link groups, the GFF's and
the O(3) sigma model's red/black) supply them, and an action with a
``combined_sweeps`` hook (the sigma model) runs a whole draw's sweeps
through it; the 1-D QM actions (harmonic, quartic, rotor) are
swept on the even/odd checkerboard through their ``heatbath_site`` /
``overrelax_site``.  With ``use_pallas`` (the quenched Schwinger action,
the plain GFF and the rotor) a draw is one launch of the fused sweep
kernel (ops/schwinger.py, ops/gff.py, ops/rotor.py; the name is the JAX
package's, whose fused kernels were Pallas), which takes only a seed pair
from the generator; otherwise the plain tensor sweeps run with noise from
the ``torch.Generator``.
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
        from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
        from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
            QuenchedSchwingerAction,
        )
        from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
        #: actions with whole-lattice coloured sweeps are swept by them;
        #: the others by the 1-D even/odd sweep of their heatbath_site
        self._action_sweeps = hasattr(action, "heatbath_sweep")
        if not self._action_sweeps:
            if not hasattr(action, "heatbath_site"):
                raise NotImplementedError(
                    f"{type(action).__name__} has neither coloured sweeps "
                    f"nor heatbath_site: no heat bath for it")
            if action.lattice.M_lat % 2:
                raise ValueError("checkerboard sweep needs even M_lat")
        super().__init__(action)
        self.n_sweep_heatbath = int(n_sweep_heatbath)
        self.n_sweep_overrelax = int(n_sweep_overrelax)
        self.n_burnin = int(n_burnin)
        #: one launch of the fused sweep kernel per draw: the quenched
        #: Schwinger action, the plain (unsmoothed, unrotated) GFF and the
        #: rotor, as in the JAX package
        self.use_pallas = bool(use_pallas)
        self._kind = None
        if use_pallas:
            if type(action) is QuenchedSchwingerAction:
                self._kind = "schwinger"
            elif (type(action) is GFFAction and action.n_gibbs_smooth == 0
                  and not action.lattice.rotated):
                self._kind = "gff"
            elif type(action) is RotorAction:
                self._kind = "rotor"
            else:
                raise ValueError("use_pallas requires the quenched "
                                 "Schwinger action, the plain GFF or the "
                                 "rotor")
        #: a fused draw takes only a seed pair (host words) from its
        #: generator: a CPU generator serves it without a read from the card
        self.host_seeded = self.use_pallas

    def init(self, generator, n_chains, dtype, device):
        return HeatBathState(x=self.action.initialise_state(
            generator, n_chains, dtype, device))

    # -- 1-D half-sweeps --------------------------------------------------------

    def _half_sweep_heatbath(self, generator, x, parity: int):
        """Update all sites of one parity from their conditional given the
        (frozen) other parity."""
        x_m = torch.roll(x, 1, dims=-1)[..., parity::2]
        x_p = torch.roll(x, -1, dims=-1)[..., parity::2]
        out = x.clone()
        out[..., parity::2] = self.action.heatbath_site(
            generator, x_m, x_p, x_cur=x[..., parity::2])
        return out

    def _half_sweep_overrelax(self, x, parity: int):
        x_m = torch.roll(x, 1, dims=-1)[..., parity::2]
        x_p = torch.roll(x, -1, dims=-1)[..., parity::2]
        out = x.clone()
        out[..., parity::2] = self.action.overrelax_site(x[..., parity::2],
                                                        x_m, x_p)
        return out

    # -- draw ------------------------------------------------------------------

    def _kernel_kw(self):
        lat = self.action.lattice
        kw = dict(n_overrelax=self.n_sweep_overrelax,
                  n_heatbath=self.n_sweep_heatbath)
        if self._kind == "rotor":
            return dict(kappa=self.action.m0 / self.action.a_lat,
                        M=lat.M_lat, **kw)
        if self._kind == "gff":
            return dict(kappa=4.0 + self.action.mu2, Mt=lat.Mt_lat,
                        Mx=lat.Mx_lat, **kw)
        return dict(beta=self.action.beta, Mt=lat.Mt_lat, Mx=lat.Mx_lat,
                    **kw)

    def draw(self, generator, state: HeatBathState):
        x = state.x
        if self.use_pallas:
            from mlmcpathintegral_tpu_torch.ops import gff, rotor, schwinger
            sweep = {"rotor": rotor.rotor_sweep, "gff": gff.gff_sweep,
                     "schwinger": schwinger.schwinger_sweep}[self._kind]
            x = sweep(x, kernel_seed(generator), chain0=self.chain0,
                      **self._kernel_kw())
        elif self._action_sweeps:
            combined = getattr(self.action, "combined_sweeps", None)
            if combined is not None:
                x = combined(generator, x, self.n_sweep_overrelax,
                             self.n_sweep_heatbath)
            else:
                for _ in range(self.n_sweep_overrelax):
                    x = self.action.overrelaxation_sweep(x)
                for _ in range(self.n_sweep_heatbath):
                    x = self.action.heatbath_sweep(generator, x)
        else:
            for _ in range(self.n_sweep_overrelax):
                x = self._half_sweep_overrelax(x, 0)
                x = self._half_sweep_overrelax(x, 1)
            for _ in range(self.n_sweep_heatbath):
                x = self._half_sweep_heatbath(generator, x, 0)
                x = self._half_sweep_heatbath(generator, x, 1)
        accept = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        return HeatBathState(x=x), accept

    def draw_chain(self, generator, state: HeatBathState, n_steps: int):
        """``n_steps`` consecutive draws, returning ``(state', trace)``
        with trace[s, c] after step s: sum_P mod_2pi(theta_P) for the
        Schwinger action, the winding sum for the rotor.  With
        ``use_pallas`` this is one launch of the sweep-chain kernel;
        otherwise a loop of draws (gauge actions only)."""
        x = state.x
        if self._kind in ("rotor", "schwinger"):
            from mlmcpathintegral_tpu_torch.ops import rotor, schwinger
            chain = (rotor.rotor_sweep_chain if self._kind == "rotor"
                     else schwinger.schwinger_sweep_chain)
            x, trace = chain(x, kernel_seed(generator), n_steps=n_steps,
                             chain0=self.chain0, **self._kernel_kw())
            return HeatBathState(x=x), trace
        qs = []
        for _ in range(n_steps):
            state, _ = self.draw(generator, state)
            qs.append(torch.sum(mod_2pi(self.action.plaquette_angles(
                state.x)), dim=(-2, -1)))
        return state, torch.stack(qs)

    def prepare(self, generator, n_chains, dtype, device):
        return super().prepare(generator, n_chains, dtype, device,
                               self.n_burnin)
