"""Multilevel sampler: persistent per-level states with a tau-adaptive,
data-dependent level walk (PyTorch port of
``mlmcpathintegral_tpu/samplers/multilevel.py``).

Reference parity: src/sampler/multilevelsampler.{hh,cc}.  Unlike the
hierarchical sampler, per-level states persist between draws and the chain
only promotes a sample to the next finer level once the current level has
accumulated ceil(tau_int) draws since its last promotion
(multilevelsampler.cc:71-113); the walk returns to the coarsest level after
every unpromoted draw.

The JAX package writes the walk as statically nested ``lax.while_loop``s;
here it is a host loop per level whose condition reads
``ceil(tau_int_device(stats[ell]))`` from the card on every iteration —
one host read per inner draw, which is the semantics (tau moves with
every recorded sample, so it is never cached).  All chains walk in
lockstep on cross-chain tau estimates (the batched analog of the
reference's single-chain estimates).  The promotion counters live on the
host, as the JAX package's ``t_indep`` bookkeeping reads them.

The coarsest sampler draws from a generator of its own
(``samplers.base.own_generator``), as in the hierarchical sampler.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.mc.twolevelstep import (
    level_hierarchy, seed_hierarchy,
)
from mlmcpathintegral_tpu_torch.samplers.base import Sampler, own_generator
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics


class MultilevelSamplerState(NamedTuple):
    tl: tuple                 # per-level TwoLevelState, ell = 0 .. L-2
    coarse: Any               # coarsest-level sampler state
    stats: tuple              # per-level sampler StatsState, ell = 0 .. L-1
    t_sampler: torch.Tensor   # [L] int64 (host) draws since last promotion
    t_indep_sum: torch.Tensor  # [L] float64 (host) sum of promotion spacings
    n_indep: torch.Tensor     # [L] float64 (host) number of promotions
    coarse_gen: torch.Generator   # the coarse sampler's own generator


class MultilevelSampler(Sampler):

    def __init__(self, fine_action, qoi_factory, coarse_sampler_factory,
                 conditioned_fine_action_factory, n_max_level: int,
                 n_autocorr_window: int = 20):
        super().__init__(fine_action)
        self.n_level = n_max_level - fine_action.lattice.coarsening_level
        if self.n_level < 2:
            raise ValueError(f"need >= 2 levels, got {self.n_level}")
        self.actions, self.twolevel_steps = level_hierarchy(
            fine_action, conditioned_fine_action_factory, self.n_level)
        self.coarse_sampler = coarse_sampler_factory(self.actions[-1])
        self.qois = [qoi_factory(a) for a in self.actions]
        self.stats_defs = [Statistics(f"Q_sampler[{ell}]", n_autocorr_window)
                           for ell in range(self.n_level)]

    # -- state -----------------------------------------------------------------

    def init(self, generator, n_chains, dtype, device):
        coarse = self.coarse_sampler.init(generator, n_chains, dtype, device)
        L = self.n_level
        xs = seed_hierarchy(self.actions, self.twolevel_steps,
                            self.coarse_sampler.x_of(coarse), generator)
        tl = tuple(self.twolevel_steps[ell].init(xs[ell])
                   for ell in range(L - 1))
        stats = tuple(self.stats_defs[ell].init(n_chains, dtype, device)
                      for ell in range(L))
        return MultilevelSamplerState(
            tl=tl, coarse=coarse, stats=stats,
            t_sampler=torch.zeros((L,), dtype=torch.int64),
            t_indep_sum=torch.zeros((L,), dtype=torch.float64),
            n_indep=torch.zeros((L,), dtype=torch.float64),
            coarse_gen=own_generator(self.coarse_sampler, generator, device))

    def prepare(self, generator, n_chains, dtype, device):
        state = self.init(generator, n_chains, dtype, device)
        coarse = self.coarse_sampler.prepare(generator, n_chains, dtype,
                                             device)
        return state._replace(coarse=coarse)

    def x_of(self, state):
        return state.tl[0].theta

    def set_state(self, state, x):
        tl0 = self.twolevel_steps[0].set_state(state.tl[0], x)
        return state._replace(tl=(tl0,) + tuple(state.tl[1:]))

    # -- draw (multilevelsampler.cc:71-113) ------------------------------------

    def _draw_level(self, ell: int, generator, st: dict) -> None:
        """Loop until level ``ell`` has produced a tau-decorrelated sample;
        recursive over levels.  ``st`` holds the walk's state, updated in
        place: "tl" and "stats" lists, "coarse", and the host counters."""
        L = self.n_level
        while st["t_sampler"][ell] < math.ceil(
                float(stats_mod.tau_int_device(st["stats"][ell]))):
            if ell == L - 1:
                st["coarse"], _ = self.coarse_sampler.draw(st["coarse_gen"],
                                                           st["coarse"])
                x_ell = self.coarse_sampler.x_of(st["coarse"])
            else:
                # recursively obtain a decorrelated coarser sample
                self._draw_level(ell + 1, generator, st)
                x_coarse = (self.coarse_sampler.x_of(st["coarse"])
                            if ell + 1 == L - 1 else st["tl"][ell + 1].theta)
                st["tl"][ell], _ = self.twolevel_steps[ell].draw(
                    generator, st["tl"][ell], x_coarse)
                x_ell = st["tl"][ell].theta
            st["stats"][ell] = stats_mod.record(st["stats"][ell],
                                                self.qois[ell](x_ell))
            st["t_sampler"][ell] += 1
        # promotion bookkeeping (multilevelsampler.cc:92-109)
        st["t_indep_sum"][ell] += st["t_sampler"][ell]
        st["n_indep"][ell] += 1.0
        st["t_sampler"][ell] = 0

    def draw(self, generator, state: MultilevelSamplerState):
        st = {"tl": list(state.tl), "stats": list(state.stats),
              "coarse": state.coarse, "coarse_gen": state.coarse_gen,
              "t_sampler": state.t_sampler.tolist(),
              "t_indep_sum": state.t_indep_sum.tolist(),
              "n_indep": state.n_indep.tolist()}
        self._draw_level(0, generator, st)
        state = MultilevelSamplerState(
            tl=tuple(st["tl"]), coarse=st["coarse"],
            stats=tuple(st["stats"]),
            t_sampler=torch.tensor(st["t_sampler"], dtype=torch.int64),
            t_indep_sum=torch.tensor(st["t_indep_sum"],
                                     dtype=torch.float64),
            n_indep=torch.tensor(st["n_indep"], dtype=torch.float64),
            coarse_gen=state.coarse_gen)
        x = self.x_of(state)
        return state, torch.ones(x.shape[:-1], dtype=torch.bool,
                                 device=x.device)

    def t_indep(self, state):
        """Average spacing between promoted samples per level."""
        s = state.t_indep_sum.numpy()
        n = state.n_indep.numpy()
        return s / np.maximum(n, 1.0)
