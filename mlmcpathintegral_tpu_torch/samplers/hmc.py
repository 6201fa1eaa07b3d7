"""Hybrid Monte Carlo, batched over chains (PyTorch port of
``mlmcpathintegral_tpu/samplers/hmc.py``).

Reference parity: src/sampler/hmcsampler.{hh,cc}.  The integrator is the
reference's leapfrog with half kicks at both ends (hmcsampler.cc:22-69):
nt + 1 force evaluations per trajectory.  The step size is tuned to a
target acceptance rate by bisection (hmcsampler.cc:77-113), each iterate
measuring the acceptance over all chains at once, read to the host once
per iterate.  ``dt`` lives in the state as a 0-d tensor on the chains'
device, so the trajectory kernel reads it without a host sync.

With ``use_pallas`` (the JAX package's name) a trajectory is one launch of
the fused kernel (ops/hmc.py), the momenta and accept uniforms drawn by
the ``torch.Generator`` on the device; otherwise the plain leapfrog runs
on the action's ``force`` and ``evaluate``.  The JAX sampler's ``unroll``
and ``block_chains`` are left out: they tune the XLA scan and the Pallas
VMEM tiling, which the port does not have.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import (
    normal, uniform,
)
from mlmcpathintegral_tpu_torch.ops.hmc import leapfrog
from mlmcpathintegral_tpu_torch.samplers.base import Sampler


class HMCState(NamedTuple):
    x: torch.Tensor    # [C, ndof] current positions
    dt: torch.Tensor   # 0-d step size


class HMCSampler(Sampler):

    def __init__(self, action, nt: int = 100, dt: float = 0.1,
                 n_rep: int = 1, n_burnin: int = 100,
                 use_pallas: bool = False):
        super().__init__(action)
        self.nt = int(nt)
        self.dt0 = float(dt)
        self.n_rep = int(n_rep)
        self.n_burnin = int(n_burnin)
        self.use_pallas = bool(use_pallas)
        if use_pallas:
            from mlmcpathintegral_tpu_torch.ops.hmc import (
                action_kernel_params,
            )
            self._kind, self._kparams = action_kernel_params(action)
            if self._kind is None:
                raise ValueError(
                    f"no fused kernel for {type(action).__name__}")

    # -- state -----------------------------------------------------------------

    def init(self, generator, n_chains, dtype, device):
        x = self.action.initialise_state(generator, n_chains, dtype, device)
        return HMCState(x=x, dt=torch.tensor(self.dt0, dtype=dtype,
                                             device=x.device))

    # -- kernel ----------------------------------------------------------------

    def _single_step(self, generator, x, dt):
        """One HMC trajectory + Metropolis test on all chains
        (hmcsampler.cc:22-69).  Returns (x_new, accept[C])."""
        p = normal(generator, x.shape, x.dtype, x.device)
        u = uniform(generator, x.shape[:-1], x.dtype, x.device)
        if self.use_pallas:
            from mlmcpathintegral_tpu_torch.ops.hmc import hmc_trajectory
            return hmc_trajectory(x, p, u, dt, kind=self._kind, nt=self.nt,
                                  **self._kparams)
        T_cur = 0.5 * torch.sum(p * p, dim=-1)
        S_cur = self.action.evaluate(x)
        xt, p = leapfrog(x, p, dt, self.action.force, self.nt)
        T_trial = 0.5 * torch.sum(p * p, dim=-1)
        dH = (self.action.evaluate(xt) - S_cur) + (T_trial - T_cur)
        accept = (dH < 0.0) | (u < torch.exp(-dH))
        return torch.where(accept[..., None], xt, x), accept

    def draw(self, generator, state: HMCState):
        """n_rep repetitions; accept = OR over repetitions
        (hmcsampler.cc:8-19)."""
        x, accept = self._single_step(generator, state.x, state.dt)
        for _ in range(self.n_rep - 1):
            x, a = self._single_step(generator, x, state.dt)
            accept = accept | a
        return state._replace(x=x), accept

    # -- step-size autotuning (hmcsampler.cc:77-113) ---------------------------

    def autotune_stepsize(self, generator, state: HMCState,
                          p_accept_target: float = 0.8, n_iter: int = 30,
                          n_tune_steps: int = 50, tolerance: float = 1e-2,
                          verbose: bool = False):
        """Bisect dt in [dt/2, 2 dt] to hit the target acceptance rate.

        Each iterate runs n_tune_steps trajectories on all chains and reads
        their acceptance rate to the host once.  Returns the tuned state;
        dt reverts to its start when no iterate came within ``tolerance``
        (hmcsampler.cc:103-109)."""
        dt0 = float(state.dt)
        dt_min, dt_max = 0.5 * dt0, 2.0 * dt0
        x = state.x
        converged = False
        dt = dt0
        for k in range(n_iter):
            dt = 0.5 * (dt_min + dt_max)
            dt_t = torch.tensor(dt, dtype=state.dt.dtype,
                                device=state.dt.device)
            n_acc = torch.zeros((), dtype=torch.int64, device=x.device)
            for _ in range(n_tune_steps):
                x, a = self._single_step(generator, x, dt_t)
                n_acc = n_acc + torch.sum(a)
            p_acc = float(n_acc) / (n_tune_steps * x.shape[0])
            if p_acc > p_accept_target:
                dt_min = dt
            else:
                dt_max = dt
            if abs(p_acc - p_accept_target) < tolerance:
                converged = True
            if verbose:
                print(f"  autotune iter {k}: dt={dt:.5f} p_acc={p_acc:.4f}")
        if not converged:
            dt = dt0
        return HMCState(x=x, dt=torch.tensor(dt, dtype=state.dt.dtype,
                                             device=state.dt.device))

    def prepare(self, generator, n_chains, dtype, device,
                p_accept_target: float = 0.8):
        """init + burn-in + autotune, as the reference constructor does
        (hmcsampler.hh:84-109)."""
        state = self.init(generator, n_chains, dtype, device)
        for _ in range(self.n_burnin):
            state, _ = self.draw(generator, state)
        return self.autotune_stepsize(generator, state, p_accept_target)
