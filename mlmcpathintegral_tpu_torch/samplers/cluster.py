"""Wolff single-cluster sampler for 1-D cluster actions (PyTorch port of
``mlmcpathintegral_tpu/samplers/cluster.py``; reference
src/sampler/clustersampler.{hh,cc}).

The action provides the ClusterAction hooks (rotoraction.hh:226-268):
``new_reflection(generator, n_chains, dtype, device)``,
``S_ell(x_i, x_j, xbar)`` and ``flip(x, xbar)``.

Two cores sample one update given the reflection angle xbar [C], the seed
site i0 [C] and the update's uniforms:

* ``_walk_core``, the executable specification: the bidirectional walk of
  clustersampler.cc:92-132, from the seed to the right until a bond fails
  (or the walk wraps to the seed), then to the left until a bond fails (or
  it reaches the forward walk's last site), one site per step for all
  chains in lockstep;
* ``_vector_core``, the same distribution in closed form: with the rotor
  reflection S_ell flips sign per flipped endpoint, so every bond's
  opening probability is known from the configuration before the update,
  and the cluster is the run of open bonds around the seed, found with two
  masked min-reductions.

With ``use_pallas`` a draw is one launch of the fused cluster kernel
(ops/rotor.py ``rotor_cluster_chain``) running all ``n_updates`` updates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import uniform
from mlmcpathintegral_tpu_torch.samplers.base import Sampler, kernel_seed


class ClusterState(NamedTuple):
    x: torch.Tensor   # [C, M]


class ClusterSampler(Sampler):

    def __init__(self, action, n_burnin: int = 100, n_updates: int = 10,
                 vectorised: bool = True, use_pallas: bool = False):
        super().__init__(action)
        self.n_burnin = int(n_burnin)
        self.n_updates = int(n_updates)
        self.vectorised = bool(vectorised)
        self.use_pallas = bool(use_pallas)
        if self.use_pallas:
            from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
            if not isinstance(action, RotorAction):
                raise ValueError(
                    "the fused cluster chain kernel hard-codes the rotor "
                    "hooks (S_ell/flip, rotoraction.hh:226-268)")

    def init(self, generator, n_chains, dtype, device):
        return ClusterState(x=self.action.initialise_state(
            generator, n_chains, dtype, device))

    def draw_chain(self, generator, state: ClusterState, n_steps: int):
        """``n_steps`` fused cluster draws in one kernel launch.  Returns
        (state', wsum[n_steps, C]), the winding-sum trace; the
        susceptibility QoI is (wsum/2pi)^2 / T."""
        from mlmcpathintegral_tpu_torch.ops.rotor import rotor_cluster_chain
        act = self.action
        x, wsum = rotor_cluster_chain(
            state.x, kernel_seed(generator), kappa2=2.0 * act.m0 / act.a_lat,
            M=state.x.shape[-1], n_steps=n_steps, n_updates=self.n_updates,
            chain0=self.chain0)
        return ClusterState(x=x), wsum

    # -- one cluster update (clustersampler.cc:92-132) -------------------------

    def _update(self, generator, x):
        """One update with fresh reflection, seed and uniforms."""
        C, M = x.shape
        xbar = self.action.new_reflection(generator, C, x.dtype, x.device)
        i0 = torch.randint(0, M, (C,), generator=generator,
                           device=generator.device).to(x.device)
        if self.vectorised:
            u_f = uniform(generator, (C, M), x.dtype, x.device)
            u_b = uniform(generator, (C, M), x.dtype, x.device)
            return self._vector_core(x, xbar, i0, u_f, u_b)
        u_fwd = uniform(generator, (M, C), x.dtype, x.device)
        u_bwd = uniform(generator, (M, C), x.dtype, x.device)
        return self._walk_core(x, xbar, i0, u_fwd, u_bwd)

    def _walk_core(self, x, xbar, i0, u_fwd, u_bwd):
        """Sequential bidirectional walk; ``u_fwd``/``u_bwd`` [M, C]: the
        uniform of each walk step."""
        act = self.action
        C, M = x.shape
        chain = torch.arange(C, device=x.device)
        x = x.clone()
        x[chain, i0] = act.flip(x[chain, i0], xbar)       # the seed

        def walk(x, u, start, direction, stop_at):
            """From position i, bond to i+direction; flip the neighbour if
            bonded; stop on the first unbonded link or when the next
            position hits ``stop_at``.  Returns (x, last position)."""
            pos, last = start, start
            active = torch.ones(C, dtype=torch.bool, device=x.device)
            for k in range(M):
                nxt = (pos + direction) % M
                s_ell = act.S_ell(x[chain, pos], x[chain, nxt], xbar)
                p_connect = 1.0 - torch.exp(torch.clamp(-s_ell, max=0.0))
                bonded = active & (u[k] < p_connect)
                x[chain, nxt] = torch.where(
                    bonded, act.flip(x[chain, nxt], xbar), x[chain, nxt])
                # the reference records the position before the final
                # advance as i_last (clustersampler.cc:103-113)
                last = torch.where(active, pos, last)
                pos = torch.where(bonded, nxt, pos)
                active = bonded & (nxt != stop_at)
            return x, last

        x, i_last_p = walk(x, u_fwd, i0, +1, i0)      # stop on wrapping
        x, _ = walk(x, u_bwd, i0, -1, i_last_p)       # stop at i_last_p
        return x

    def _vector_core(self, x, xbar, i0, u_f, u_b):
        """Closed-form update; ``u_f``/``u_b`` [C, M]: the uniform of each
        bond's forward and backward test.

        The walk's semantics, reproduced exactly: forward from i0 through
        open bonds, and on a full wrap the final link (i0-1 -> i0) tests a
        doubly-flipped pair and, if open, re-flips the seed; backward until
        the first closed bond or until re-flipping i_last_p.  Every tested
        link has one flipped endpoint except those two terminal links."""
        act = self.action
        C, M = x.shape
        # bond b joins sites (b, b+1); S_ell of the configuration before
        # the update
        s_orig = act.S_ell(x, torch.roll(x, -1, dims=-1), xbar[:, None])
        p_one = 1.0 - torch.exp(torch.clamp(s_orig, max=0.0))
        p_two = 1.0 - torch.exp(torch.clamp(-s_orig, max=0.0))

        cols = torch.arange(M, device=x.device)[None, :]
        rel = (cols - i0[:, None]) % M     # forward walk order of bond b
        rel_b = (i0[:, None] - cols) % M   # site distance going left
        # backward walk order of bond b; rel_b == 0 maps to M-1: after a
        # fully wrapping backward walk (only when the first forward bond is
        # closed, B_lim == M) the walk re-tests bond (i0, i0+1) with both
        # endpoints flipped; for F_raw >= 1 its order M-1 >= B_lim never
        # changes B
        k_bw = (rel_b - 1) % M

        # forward: rel = M-1 is the full-wrap link, both endpoints flipped
        closed_f = u_f >= torch.where(rel == M - 1, p_two, p_one)
        F_raw = torch.where(closed_f, rel, M).amin(dim=-1)            # [C]

        # backward, capped at B_lim = distance from i0 to i_last_p going
        # left; its terminal link re-flips i_last_p (p_two), except after
        # a full forward wrap, where the seed is net-unflipped
        B_lim = torch.where(F_raw >= M, 1, M - F_raw)
        term = (k_bw == (B_lim - 1)[:, None]) & (F_raw < M)[:, None]
        closed_b = u_b >= torch.where(term, p_two, p_one)
        B_raw = torch.where(closed_b, k_bw, M).amin(dim=-1)
        B = torch.minimum(B_raw, B_lim)
        F_raw, B = F_raw[:, None], B[:, None]
        n_flips = ((rel == 0).to(torch.int64)
                   + ((rel >= 1) & (rel <= F_raw)).to(torch.int64)
                   + ((rel_b >= 1) & (rel_b <= B)).to(torch.int64)
                   # full forward wrap: the final link re-flips the seed
                   + ((rel == 0) & (F_raw >= M)).to(torch.int64)
                   # full backward wrap (F_raw == 0, all M backward links
                   # open): the terminal link re-flips the seed
                   + ((rel == 0) & (B >= M)).to(torch.int64))
        return torch.where(n_flips % 2 == 1, act.flip(x, xbar[:, None]), x)

    def draw(self, generator, state: ClusterState):
        if self.use_pallas:
            # one fused launch runs all n_updates cluster updates
            state, _ = self.draw_chain(generator, state, 1)
        else:
            x = state.x
            for _ in range(self.n_updates):
                x = self._update(generator, x)
            state = ClusterState(x=x)
        accept = torch.ones(state.x.shape[:-1], dtype=torch.bool,
                            device=state.x.device)
        return state, accept

    def prepare(self, generator, n_chains, dtype, device):
        return super().prepare(generator, n_chains, dtype, device,
                               self.n_burnin)
