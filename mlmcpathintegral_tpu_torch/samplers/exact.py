"""Exact sampler for actions that draw independent samples (PyTorch port of
``mlmcpathintegral_tpu/samplers/exact.py``).

Reference parity: HarmonicOscillatorAction and GFFAction double as
Samplers (harmonicoscillatoraction.hh:264-276, gffaction.hh:356-375),
selected with ``sampler = 'exact'``.
Here any action with ``exact_draw(generator, n_chains, dtype, device)``
qualifies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mlmcpathintegral_tpu_torch.samplers.base import Sampler


class ExactState(NamedTuple):
    x: torch.Tensor


class ExactSampler(Sampler):

    #: successive draws are iid: the two-level coarse subsampling
    #: (montecarlotwolevel.cc:82-94) needs one draw per sample
    independent_draws = True

    def __init__(self, action):
        super().__init__(action)
        if not hasattr(action, "exact_draw"):
            raise ValueError(
                f"action {action.info_string()} has no exact sampler")

    def init(self, generator, n_chains, dtype, device):
        return ExactState(x=self.action.exact_draw(generator, n_chains,
                                                   dtype, device))

    def draw(self, generator, state: ExactState):
        x = self.action.exact_draw(generator, state.x.shape[0],
                                   state.x.dtype, state.x.device)
        return ExactState(x=x), torch.ones(x.shape[:-1], dtype=torch.bool,
                                           device=x.device)

    def draw_batch(self, generator, state: ExactState, n: int):
        """``n`` iid draws for every chain in one batched draw:
        (state', xs[n, C, ndof])."""
        C, N = state.x.shape
        xs = self.action.exact_draw(generator, n * C, state.x.dtype,
                                    state.x.device).reshape(n, C, N)
        return ExactState(x=xs[-1]), xs

    def draw_batch_with_action(self, generator, state: ExactState, n: int):
        """Like :meth:`draw_batch`, also returning S(x) [n, C] of every
        draw (the screen then skips its coarse-action evaluation): in
        closed form from the driving normals where the action has
        ``exact_draw_with_action`` (the GFF's dense factors), else by
        ``evaluate``."""
        with_action = getattr(self.action, "exact_draw_with_action", None)
        if with_action is None:
            state, xs = self.draw_batch(generator, state, n)
            return state, xs, self.action.evaluate(xs)
        C, N = state.x.shape
        xs, S = with_action(generator, n * C, state.x.dtype, state.x.device)
        xs = xs.reshape(n, C, N)
        return ExactState(x=xs[-1]), xs, S.reshape(n, C)

    def prepare(self, generator, n_chains, dtype, device):
        return self.init(generator, n_chains, dtype, device)
