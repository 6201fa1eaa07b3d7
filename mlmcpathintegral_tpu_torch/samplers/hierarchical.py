"""Hierarchical (delayed-acceptance) sampler (PyTorch port of
``mlmcpathintegral_tpu/samplers/hierarchical.py``).

Reference parity: src/sampler/hierarchicalsampler.{hh,cc} — the paper's key
autocorrelation-reduction device.  A draw restricts the current fine state
down the level hierarchy, redraws the coarsest level with a standalone
sampler, then walks back up applying a TwoLevelMetropolisStep per level;
the overall acceptance is the AND of all level acceptances and the
reference aborts on the first rejection (hierarchicalsampler.cc:55-81).

All chains run every level in lockstep: "abort on first rejection" is
per-chain masking, a chain's state advancing only while its running
accept flag is still true.  The per-level counters stay on the chains'
device (int64), so a draw reads nothing back to the host.

The coarsest sampler draws from a generator of its own, seeded once when
the state is made (``samplers.base.own_generator``): on the CPU where its
kernels take host seed words (the rotor sweep kernel), so that no draw
reads a seed from the card; the fills and accept uniforms of the levels
above come from the generator the draw is given.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from mlmcpathintegral_tpu_torch.mc.twolevelstep import (
    level_hierarchy, seed_hierarchy,
)
from mlmcpathintegral_tpu_torch.samplers.base import Sampler, own_generator


class HierarchicalState(NamedTuple):
    xs: tuple                      # per-level states, xs[ell]: [C, M_ell]
    coarse: Any                    # coarse-sampler state
    n_total: torch.Tensor          # [L] int64 per-level attempted moves
    n_accepted: torch.Tensor       # [L] int64 per-level accepted moves
    coarse_gen: torch.Generator    # the coarse sampler's own generator


class HierarchicalSampler(Sampler):

    def __init__(self, fine_action, coarse_sampler_factory,
                 conditioned_fine_action_factory, n_max_level: int):
        """``coarse_sampler_factory(action) -> Sampler`` builds the
        coarsest-level sampler; ``conditioned_fine_action_factory(action) ->
        ConditionedFineAction`` builds the per-level fill-in
        (hierarchicalsampler.cc:8-52)."""
        super().__init__(fine_action)
        self.n_level = n_max_level - fine_action.lattice.coarsening_level
        if self.n_level < 2:
            raise ValueError(f"need >= 2 levels, got {self.n_level}")
        self.actions, self.twolevel_steps = level_hierarchy(
            fine_action, conditioned_fine_action_factory, self.n_level)
        self.coarse_sampler = coarse_sampler_factory(self.actions[-1])

    # -- state -----------------------------------------------------------------

    def _state(self, xs, coarse, coarse_gen):
        z = torch.zeros((self.n_level,), dtype=torch.int64,
                        device=xs[0].device)
        return HierarchicalState(xs=tuple(xs), coarse=coarse, n_total=z,
                                 n_accepted=z.clone(),
                                 coarse_gen=coarse_gen)

    def init(self, generator, n_chains, dtype, device):
        xs = [self.action.initialise_state(generator, n_chains, dtype,
                                           device)]
        for ell in range(1, self.n_level):
            xs.append(self.actions[ell - 1].restrict(xs[ell - 1]))
        coarse = self.coarse_sampler.init(generator, n_chains, dtype, device)
        return self._state(xs, coarse, own_generator(
            self.coarse_sampler, generator, device))

    def prepare(self, generator, n_chains, dtype, device):
        """Prepare the coarsest-level sampler (burn-in/autotune, the work its
        factory-built ctor does in the reference) and seed the hierarchy by
        an upward prolongate+fill pass from the burned-in coarsest state —
        so the fine chains start inside the proposal distribution."""
        coarse = self.coarse_sampler.prepare(generator, n_chains, dtype,
                                             device)
        xs = seed_hierarchy(self.actions, self.twolevel_steps,
                            self.coarse_sampler.x_of(coarse), generator)
        return self._state(xs, coarse, own_generator(
            self.coarse_sampler, generator, device))

    def set_state(self, state, x):
        return state._replace(xs=(x,) + tuple(state.xs[1:]))

    def x_of(self, state):
        return state.xs[0]

    # -- draw (hierarchicalsampler.cc:55-81) -----------------------------------

    def draw(self, generator, state: HierarchicalState):
        L = self.n_level
        xs = list(state.xs)
        # restrict the current fine state down the hierarchy (contiguous:
        # the coarse sampler's kernels take contiguous fields)
        for ell in range(1, L):
            xs[ell] = self.actions[ell - 1].restrict(xs[ell - 1]).contiguous()

        C = xs[0].shape[0]
        n_total = state.n_total.clone()
        n_accepted = state.n_accepted.clone()
        # coarsest level: standalone sampler move
        cs = self.coarse_sampler.set_state(state.coarse, xs[L - 1])
        cs, accept_all = self.coarse_sampler.draw(state.coarse_gen, cs)
        xs[L - 1] = self.coarse_sampler.x_of(cs)
        n_total[L - 1] += C
        n_accepted[L - 1] += torch.sum(accept_all)

        # walk back up; per-chain early exit by masking (the per-level
        # acceptance bookkeeping matches hierarchicalsampler.cc:90-117:
        # a level only counts attempts by chains still alive)
        for ell in range(L - 2, -1, -1):
            step = self.twolevel_steps[ell]
            tl, acc = step.draw(generator, step.init(xs[ell]), xs[ell + 1])
            xs[ell] = torch.where(accept_all[..., None], tl.theta, xs[ell])
            n_total[ell] += torch.sum(accept_all)
            accept_all = accept_all & acc
            n_accepted[ell] += torch.sum(accept_all)

        return HierarchicalState(xs=tuple(xs), coarse=cs, n_total=n_total,
                                 n_accepted=n_accepted,
                                 coarse_gen=state.coarse_gen), accept_all

    def show_stats(self, state):
        """Per-level acceptance report (hierarchicalsampler.cc:90-117)."""
        for ell, p in enumerate(self.acceptance(state)):
            tag = ("[finest]  " if ell == 0 else
                   "[coarsest]" if ell == self.n_level - 1 else
                   "          ")
            print(f"  level {ell} {tag} : p = {p:.3f}")

    @staticmethod
    def acceptance(state) -> list:
        """Per-level acceptance rates n_accepted / n_total (one host
        read)."""
        n_tot = state.n_total.tolist()
        n_acc = state.n_accepted.tolist()
        return [a / max(t, 1) for a, t in zip(n_acc, n_tot)]
