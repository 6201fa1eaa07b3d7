"""Hybrid cluster sampler for the quenched Schwinger model (PyTorch port of
``mlmcpathintegral_tpu/samplers/schwingercluster.py``; reference
src/sampler/quenchedschwingerclustersampler.{hh,cc}).

The joint distribution of the Mt*Mx plaquette angles equals that of the
increments of a topological rotor with M = Mt*Mx sites and I = beta * a
(a = 1/M).  A 1-D Wolff cluster sampler moves the rotor path; the links
are rebuilt in a fixed gauge (the increments integrated into vertical
links column by column, the last row closed horizontally), then a random
gauge transformation and random torus Wilson-line phases restore the link
measure (quenchedschwingerclustersampler.cc:40-86).  ``n_mix_sweeps``
overrelaxation + heat-bath sweeps then move the smooth plaquette modes,
which near-global clusters barely touch, and the rotor path is rebuilt
from the mixed links.  With ``use_pallas`` the cluster updates are one
launch of the cluster kernel (K7) and each mixing sweep one launch of the
fused sweep kernel (K2, ``ops/schwinger.py`` ``schwinger_sweep``: the
overrelaxation, then the heat bath truncated at 6 rejection rounds, as
the JAX package's heat-bath sampler swaps it in for the plain pair); its
random stream is the kernel's, not the plain sweeps'.  Without it both
are the plain tensor code.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import uniform
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
from mlmcpathintegral_tpu_torch.samplers.base import Sampler, kernel_seed
from mlmcpathintegral_tpu_torch.samplers.cluster import (
    ClusterSampler, ClusterState,
)
from mlmcpathintegral_tpu_torch.utils.special import mod_2pi


class SchwingerClusterState(NamedTuple):
    x: torch.Tensor            # [C, 2*Mt*Mx] current link state
    psi: torch.Tensor          # [C, Mt*Mx] rotor path


class QuenchedSchwingerClusterSampler(Sampler):
    """Wolff clusters on the equivalent rotor path move the topological
    sector in O(1) updates; the mixing sweeps move the smooth plaquette
    modes.  Both preserve the same equilibrium, so their composition does
    too.  Subsampling the coarse chain by tau assumes its clock is the
    slowest mode: under cluster updates that is the plaquette energy, not
    chi_t, so the subsample clock watches ``subsample_observable``."""

    def __init__(self, action, n_burnin: int = 100, n_updates: int = 10,
                 n_mix_sweeps: int = 1, use_pallas: bool = False):
        super().__init__(action)
        lat = action.lattice
        lattice1d = Lattice1D(lat.Mt_lat * lat.Mx_lat, 1.0)
        self.rotor_action = RotorAction(lattice1d, RenormalisationType.NONE,
                                        m0=action.beta * lattice1d.a_lat)
        self.cluster = ClusterSampler(self.rotor_action, n_burnin=n_burnin,
                                      n_updates=n_updates,
                                      use_pallas=use_pallas)
        self.n_mix_sweeps = int(n_mix_sweeps)
        self.use_pallas = bool(use_pallas)

    @property
    def chain0(self):
        """The global index of the state's first chain, which the cluster
        kernel and the sweep kernel hash: the nested cluster sampler's."""
        return self.cluster.chain0

    @chain0.setter
    def chain0(self, value):
        self.cluster.chain0 = int(value)

    def init(self, generator, n_chains, dtype, device):
        psi = self.rotor_action.initialise_state(generator, n_chains, dtype,
                                                 device)
        return SchwingerClusterState(x=self._reconstruct(generator, psi),
                                     psi=psi)

    def prepare(self, generator, n_chains, dtype, device):
        cs = self.cluster.prepare(generator, n_chains, dtype, device)
        return SchwingerClusterState(x=self._reconstruct(generator, cs.x),
                                     psi=cs.x)

    def subsample_observable(self, x):
        """Slow-mode clock for tau-based coarse subsampling: the average
        plaquette energy."""
        return torch.mean(torch.cos(self.action.plaquette_angles(x)),
                          dim=(-2, -1))

    def draw(self, generator, state: SchwingerClusterState):
        cs, _ = self.cluster.draw(generator, ClusterState(x=state.psi))
        psi = cs.x
        x = self._reconstruct(generator, psi)
        if self.n_mix_sweeps > 0:
            x = self.mix(generator, x)
            psi = self._psi_from_links(generator, x)
        accept = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        return SchwingerClusterState(x=x, psi=psi), accept

    def mix(self, generator, x):
        """The ``n_mix_sweeps`` overrelaxation + heat-bath sweeps of links
        x: with ``use_pallas`` one sweep-kernel launch a sweep (one seed
        pair a draw, the sweeps at step offsets 0, 1, ...), which on the
        card raises rather than fall back; else the action's plain tensor
        sweeps."""
        act = self.action
        if not self.use_pallas:
            for _ in range(self.n_mix_sweeps):
                x = act.overrelaxation_sweep(x)
                x = act.heatbath_sweep(generator, x)
            return x
        from mlmcpathintegral_tpu_torch.ops.schwinger import schwinger_sweep
        lat = act.lattice
        seed = kernel_seed(generator)
        for i in range(self.n_mix_sweeps):
            x = schwinger_sweep(x, seed, beta=act.beta, Mt=lat.Mt_lat,
                                Mx=lat.Mx_lat, n_overrelax=1, n_heatbath=1,
                                k_rej=6, step_offset=i, chain0=self.chain0)
        return x

    # -- rotor path <-> links (quenchedschwingerclustersampler.cc:40-86) -------

    def _psi_from_links(self, generator, x):
        """Rotor path from the links' plaquette angles, d[i*Mx+j] = P[j,i],
        with a uniform global rotation (the rotor measure is uniform in
        it)."""
        c = uniform(generator, (x.shape[0], 1), x.dtype, x.device,
                    -math.pi, math.pi)
        return self.psi_from_links(x, c)

    def psi_from_links(self, x, c):
        """:meth:`_psi_from_links` given the rotation c [C, 1]."""
        C = x.shape[0]
        d = self.action.plaquette_angles(x).transpose(-1, -2).reshape(C, -1)
        psi = torch.cumsum(d, dim=-1)
        psi = torch.cat([torch.zeros_like(psi[:, :1]), psi[:, :-1]], dim=-1)
        return mod_2pi(psi + c)

    def _reconstruct(self, generator, psi):
        """Links [C, 2*Mt*Mx] whose plaquettes are the increments of psi,
        in a random gauge with random Wilson-line phases."""
        lat = self.action.lattice
        C = psi.shape[0]
        th = uniform(generator, (C, lat.Mx_lat, lat.Mt_lat), psi.dtype,
                     psi.device, -math.pi, math.pi)
        u = uniform(generator, (C, 1, 1, 2), psi.dtype, psi.device,
                    -math.pi, math.pi)
        return self.reconstruct(psi, th, u)

    def reconstruct(self, psi, th, u):
        """:meth:`_reconstruct` given the gauge transformation th
        [C, Mx, Mt] and the phases u [C, 1, 1, 2]."""
        lat = self.action.lattice
        Mt, Mx = lat.Mt_lat, lat.Mx_lat
        C = psi.shape[0]
        # increments d[l] = psi[l+1] - psi[l] on the linear index
        # l = i * Mx + j (i = temporal row of the walk)
        dg = (torch.roll(psi, -1, dims=-1) - psi).reshape(C, Mt, Mx)

        # vertical links: X(i, j) = sum_{k < i} d[k, j], X(0, j) = 0
        X_it = torch.cumsum(dg, dim=-2)
        X_it = torch.cat([torch.zeros_like(X_it[:, :1]), X_it[:, :-1]],
                         dim=-2)
        X = X_it.transpose(-1, -2)                # [C, Mx, Mt] = [j, i]

        # horizontal links: zero except the last temporal row i = Mt-1:
        # T(Mt-1, j+1) = T(Mt-1, j) - X(Mt-1, j) - d[(Mt-1)*Mx + j]
        T_last = torch.cumsum(-(X_it[:, Mt - 1, :] + dg[:, Mt - 1, :]),
                              dim=-1)
        T_last = torch.cat([torch.zeros_like(T_last[:, :1]),
                            T_last[:, :-1]], dim=-1)         # T(., 0) = 0
        T = torch.zeros_like(X)
        T[:, :, Mt - 1] = T_last

        # random gauge transformation theta(i, j) per site:
        # T(i,j) += theta(i,j) - theta(i+1,j); X(i,j) += theta(i,j) -
        # theta(i,j+1)
        T = mod_2pi(T + th - torch.roll(th, -1, dims=-1))
        X = mod_2pi(X + th - torch.roll(th, -1, dims=-2))

        # uniform torus Wilson-line phases: a shift u/Mt on every temporal
        # link (u'/Mx on every spatial one) leaves the plaquettes alone and
        # makes the phases, which the reconstruction pins and gauge
        # transformations cannot move, uniform, as the link measure has
        # them; pinned phases bias the delayed-acceptance screen when these
        # links are its coarse proposals.  The reference omits this
        # (quenchedschwingerclustersampler.cc:70-82).
        T = mod_2pi(T + u[..., 0] / Mt)
        X = mod_2pi(X + u[..., 1] / Mx)
        return torch.stack([T, X], dim=-1).reshape(C, 2 * Mt * Mx)
