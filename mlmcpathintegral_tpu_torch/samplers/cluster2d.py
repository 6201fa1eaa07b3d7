"""Wolff single-cluster sampler for the 2-D O(3) sigma model (PyTorch port
of ``mlmcpathintegral_tpu/samplers/cluster2d.py``; reference
src/sampler/clustersampler.cc:52-89, the generic cluster growth over the
lattice's neighbour graph, with the sigma model's spin-flip hooks,
nonlinearsigmaaction.cc:166-210).

The sequential breadth-first growth becomes parallel label propagation:
each sweep makes one independent bond trial for every edge from the
current frontier to a vertex outside the cluster, and an outside vertex
joins if any of its trials succeeds.  That has the law of the sequential
growth: a bond's probability depends only on the (flipped) frontier spin
and the (unflipped) outside spin, every frontier-to-outside edge gets
exactly one trial, and the probability of not joining factorises over the
trials in both schedules.  All chains grow their clusters in lockstep.

The JAX package tests ``any(frontier)`` on the device every sweep; here
that test is a read from the card, so it is made every
``CHECK_EVERY`` sweeps only (a sweep with an empty frontier changes
nothing).  The growth stays bounded by the vertex count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import uniform
from mlmcpathintegral_tpu_torch.models.qft.nonlinearsigma import (
    angles_to_vec, vec_to_angles,
)
from mlmcpathintegral_tpu_torch.samplers.base import Sampler


class Cluster2DState(NamedTuple):
    x: torch.Tensor   # [C, 2N] angle state


class Cluster2DSampler(Sampler):
    """For actions with ``new_reflection``, ``S_ell_vec`` and ``flip_vec``
    whose spins are (theta, phi) angle pairs (the O(3) sigma model)."""

    #: growth sweeps between two reads of the frontier
    CHECK_EVERY = 4

    def __init__(self, action, n_burnin: int = 100, n_updates: int = 10):
        super().__init__(action)
        self.n_burnin = int(n_burnin)
        self.n_updates = int(n_updates)
        self._nn = action.lattice.neighbour_vertices[:, :4]

    def init(self, generator, n_chains, dtype, device):
        return Cluster2DState(x=self.action.initialise_state(
            generator, n_chains, dtype, device))

    def _single_cluster_update(self, generator, x):
        act = self.action
        N = act.lattice.nvertices
        vec = angles_to_vec(x)                            # [C, N, 3]
        C, dev = vec.shape[0], vec.device
        r = act.new_reflection(generator, C, vec.dtype, dev)[:, None, :]
        seed = torch.randint(0, N, (C,), generator=generator,
                             device=generator.device).to(dev)
        in_cluster = torch.nn.functional.one_hot(seed, N).bool()
        vec = torch.where(in_cluster[..., None], act.flip_vec(vec, r), vec)
        frontier = in_cluster
        nn = torch.as_tensor(self._nn, dtype=torch.int64, device=dev)
        for it in range(N):
            if it % self.CHECK_EVERY == 0 and not bool(frontier.any()):
                break
            # r.sigma per vertex; the frontier's spins are flipped already
            r_sigma = torch.sum(vec * r, dim=-1)          # [C, N]
            s_ell = (-2.0 * act.beta
                     * r_sigma[..., None] * r_sigma[:, nn])  # [C, N, 4]
            # an edge is live from a frontier neighbour to a vertex
            # outside the cluster
            live = frontier[:, nn] & ~in_cluster[..., None]
            p_connect = 1.0 - torch.exp(torch.clamp(-s_ell, max=0.0))
            u = uniform(generator, s_ell.shape, vec.dtype, dev)
            join = torch.any(live & (u < p_connect), dim=-1)  # [C, N]
            vec = torch.where(join[..., None], act.flip_vec(vec, r), vec)
            in_cluster = in_cluster | join
            frontier = join
        return vec_to_angles(vec)

    def draw(self, generator, state: Cluster2DState):
        x = state.x
        for _ in range(self.n_updates):
            x = self._single_cluster_update(generator, x)
        accept = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        return Cluster2DState(x=x), accept

    def prepare(self, generator, n_chains, dtype, device):
        return super().prepare(generator, n_chains, dtype, device,
                               self.n_burnin)
