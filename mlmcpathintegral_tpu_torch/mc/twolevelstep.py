"""Two-level Metropolis step — the delayed-acceptance screen (PyTorch port
of ``mlmcpathintegral_tpu/mc/twolevelstep.py``; reference
src/montecarlo/twolevelmetropolisstep.{hh,cc}).

Given a coarse proposal theta_coarse, build the fine trial
theta' = prolongate(theta_coarse) + conditioned fill, and accept with

  dS = [S_f(theta') - S_f(theta)]
     + [S_c(restrict(theta)) - S_c(theta_coarse)]
     + [S_cond(theta) - S_cond(theta')]

The fine and conditioned action values of the current state are cached in
the state (twolevelmetropolisstep.hh:104-108).  The fused kernel
(ops/schwinger_twolevel.py) runs this step on the main path; ``draw``
here is the plain tensor version, kept as the oracle of that kernel's
screen.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import uniform


class TwoLevelState(NamedTuple):
    theta: torch.Tensor    # [C, M_fine] current fine state
    S_fine: torch.Tensor   # [C] cached fine action of theta
    S_cond: torch.Tensor   # [C] cached conditioned action of theta


class TwoLevelMetropolisStep:

    def __init__(self, coarse_action, fine_action, conditioned_fine_action):
        self.coarse_action = coarse_action
        self.fine_action = fine_action
        self.conditioned_fine_action = conditioned_fine_action

    def init(self, theta_fine) -> TwoLevelState:
        """State with caches from a full fine state [C, M_fine]."""
        return TwoLevelState(
            theta=theta_fine,
            S_fine=self.fine_action.evaluate(theta_fine),
            S_cond=self.conditioned_fine_action.evaluate(theta_fine))

    def set_state(self, state: TwoLevelState, theta_fine) -> TwoLevelState:
        """Reset the current fine state + caches
        (twolevelmetropolisstep.cc:91-97)."""
        return self.init(theta_fine)

    def draw(self, generator, state: TwoLevelState, theta_coarse):
        """One screening step on all chains; theta_coarse: [C, M_coarse].
        Returns (state, accept[C])."""
        theta_prime = self.fine_action.prolongate(theta_coarse, state.theta)
        theta_prime = self.conditioned_fine_action.fill_fine_points(
            generator, theta_prime)
        S_fine_prime = self.fine_action.evaluate(theta_prime)
        dS_fine = S_fine_prime - state.S_fine
        theta_C = self.fine_action.restrict(state.theta)
        dS_coarse = (self.coarse_action.evaluate(theta_C)
                     - self.coarse_action.evaluate(theta_coarse))
        S_cond_prime = self.conditioned_fine_action.evaluate(theta_prime)
        dS_trial = state.S_cond - S_cond_prime
        dS = dS_fine + dS_coarse + dS_trial
        u = uniform(generator, dS.shape, dS.dtype, dS.device)
        accept = (dS < 0.0) | (u < torch.exp(-dS))
        theta = torch.where(accept[..., None], theta_prime, state.theta)
        S_fine = torch.where(accept, S_fine_prime, state.S_fine)
        S_cond = torch.where(accept, S_cond_prime, state.S_cond)
        return TwoLevelState(theta, S_fine, S_cond), accept


def level_hierarchy(fine_action, conditioned_fine_action_factory,
                    n_level: int):
    """(actions, steps) of an ``n_level`` hierarchy: the actions finest
    first, each the coarse action of the one before, and the
    TwoLevelMetropolisStep from level ell + 1 to level ell, its fill
    ``conditioned_fine_action_factory(actions[ell])``."""
    actions, steps = [fine_action], []
    for ell in range(n_level - 1):
        coarse = actions[ell].coarse_action()
        cond = conditioned_fine_action_factory(actions[ell])
        steps.append(TwoLevelMetropolisStep(coarse, actions[ell], cond))
        actions.append(coarse)
    return actions, steps


def seed_hierarchy(actions, steps, x_coarsest, generator):
    """Per-level states, finest first, seeded upward from the coarsest
    level's ``x_coarsest``: each finer level the prolongation of the level
    below with its fine points filled by its step's conditioned action, so
    every level starts inside its proposal distribution."""
    xs = [None] * len(actions)
    xs[-1] = x_coarsest
    C, dtype, device = x_coarsest.shape[0], x_coarsest.dtype, \
        x_coarsest.device
    for ell in range(len(actions) - 2, -1, -1):
        x = actions[ell].initialise_state(generator, C, dtype, device)
        x = actions[ell].prolongate(xs[ell + 1], x)
        xs[ell] = steps[ell].conditioned_fine_action.fill_fine_points(
            generator, x)
    return xs
