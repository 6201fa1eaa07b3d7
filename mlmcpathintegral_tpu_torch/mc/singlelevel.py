"""Single-level Monte Carlo estimation (PyTorch port of
``mlmcpathintegral_tpu/mc/singlelevel.py``; reference
src/montecarlo/montecarlosinglelevel.{hh,cc}).

The host drives an adaptive outer loop (recompute the target sample count
from the running tau_int and variance, montecarlosinglelevel.cc:57-89)
around chunks of ``chunk_size`` draws: every chunk advances all chains
``chunk_size`` draws, evaluates the QoI after each and records the
leading ``n_active`` values into the batched statistics in one
``record_block``.  The target is distributed across the chain batch: the
per-chain target is ceil(n_target / n_chains).

A draw is a host loop of launches (PyTorch has no jitted scan), so
nothing in a chunk reads the card: the accepted count and the per-step
cross-chain QoI means (for the binning cross-check of a window-capped
tau_int) stay on the device until the run reads them.  Each chunk draws
from a generator seeded by a seed pair from the run's CPU generator: on
the chains' device, or on the CPU for a sampler whose draws take only
kernel seeds (``host_seeded``), so that a seed reaches the kernel as host
words without a copy from the card.
"""

from __future__ import annotations

import contextlib
import math
import time
from pathlib import Path

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.mc.twolevel import (
    chunk_generator, run_generators,
)
from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics
from mlmcpathintegral_tpu_torch.utils.timer import sync


class MonteCarloSingleLevel:

    def __init__(self, action, qoi, sampler, *,
                 n_burnin: int = 100, n_samples: int = 0,
                 epsilon: float = 1e-2, n_autocorr_window: int = 20,
                 n_min_samples_qoi: int = 100, chunk_size: int = 256,
                 qoi_log_path=None, save_states_path=None):
        self.action = action
        self.qoi = qoi
        self.sampler = sampler
        self.n_burnin = int(n_burnin)
        self.n_samples = int(n_samples)      # 0 => adaptive via epsilon
        self.epsilon = float(epsilon)
        self.n_min_samples_qoi = int(n_min_samples_qoi)
        self.chunk_size = int(chunk_size)
        self.stats_Q = Statistics("Q", n_autocorr_window)
        self.elapsed_s = 0.0
        self.timings = {}
        #: LOG_QOI analog (montecarlosinglelevel.cc:46-76): every recorded
        #: per-chain QoI value to a binary float64 file of shape
        #: [n_steps, n_chains]
        self.qoi_log_path = qoi_log_path
        #: SAVE_STATES analog (montecarlosinglelevel.cc:61-70): the
        #: recorded chain states per chunk as ``states_<offset>.npz``
        #: ([n_recorded, n_chains, ndof]) under this directory
        self.save_states_path = save_states_path
        #: per-step cross-chain QoI means (device tensors), for the binning
        #: cross-check of a window-capped tau_int
        self._qbar_history = []
        self._log_fh = None

    def _chunk(self, generator, sampler_state, stats_state, n_active,
               record_history=True):
        """Advance ``chunk_size`` draws; record the QoI of the first
        ``n_active`` of them (montecarlosinglelevel.cc:58-77).  Returns
        (sampler state, statistics state, accepted moves of all draws as a
        0-d tensor on the device)."""
        save = self.save_states_path is not None and record_history
        qs, accs, xs = [], [], []
        for _ in range(self.chunk_size):
            sampler_state, accept = self.sampler.draw(generator,
                                                      sampler_state)
            x = self.sampler.x_of(sampler_state)
            qs.append(self.qoi(x))
            accs.append(accept)
            if save:
                xs.append(x)
        Q = torch.stack(qs)                               # [chunk, C]
        stats_state = stats_mod.record_block(stats_state, Q,
                                             n_valid=n_active)
        n_acc = torch.sum(torch.stack(accs), dtype=torch.float64)
        n = int(n_active)
        if self._log_fh is not None:
            Q[:n].double().cpu().numpy().tofile(self._log_fh)
        if record_history:
            # the cross-chain mean, reduced on the device: the binning
            # cross-check needs this [n] vector, not the [n, C] trace
            self._qbar_history.append(torch.mean(Q[:n], dim=1))
        if save:
            d = Path(self.save_states_path)
            d.mkdir(parents=True, exist_ok=True)
            offset = sum(h.shape[0] for h in self._qbar_history) - n
            np.savez_compressed(d / f"states_{offset:08d}.npz",
                                x=torch.stack(xs[:n]).cpu().numpy())
        return sampler_state, stats_state, n_acc

    # -------------------------------------------------------------------------

    def evaluate(self, generator, n_chains: int, dtype=torch.float32,
                 device="cuda", verbose: bool = False, sampling_scope=None):
        """Run burn-in + adaptive sampling; returns (sampler_state,
        stats_state) (montecarlosinglelevel.cc:23-94).  ``generator``: a
        CPU ``torch.Generator`` (or an int seed for one) from which every
        chunk's seed pair and the set-up noise are drawn; ``device``: where
        the chains live, the card unless the caller asks for the CPU.
        ``timings`` holds the host seconds of set-up (``prepare_s``: the
        sampler's initialisation and burn-in), burn-in (``burnin_s``) and
        sampling (``sampling_s``), each ending in a synchronisation.
        ``sampling_scope``: a context manager (a profiler, say) entered
        around the sampling phase, outside its timer."""
        device = _cuda.run_device(device)
        t0 = time.monotonic()
        self.timings = {}
        next_seed, setup_gen = run_generators(generator, device)
        gen_device = (torch.device("cpu") if self.sampler.host_seeded
                      else device)
        sstate = self.sampler.prepare(setup_gen, n_chains, dtype, device)
        stats = self.stats_Q.init(n_chains, dtype, device)
        sync((sstate, stats))
        self.timings["prepare_s"] = time.monotonic() - t0

        # burn-in recorded into the long-term moments, then soft-reset, so
        # tau_int is learned during warm-up (montecarlosinglelevel.cc:28-38)
        t_phase = time.monotonic()
        self._qbar_history = []
        n_burn_done = 0
        while n_burn_done < self.n_burnin:
            n = min(self.chunk_size, self.n_burnin - n_burn_done)
            sstate, stats, _ = self._chunk(
                chunk_generator(next_seed(), gen_device), sstate, stats, n,
                record_history=False)
            n_burn_done += n
        stats = stats_mod.soft_reset(stats)
        sync((sstate, stats))
        self.timings["burnin_s"] = time.monotonic() - t_phase
        if verbose:
            print("Burnin completed")

        with sampling_scope or contextlib.nullcontext():
            t_phase = time.monotonic()
            if self.qoi_log_path is not None:
                self._log_fh = open(self.qoi_log_path, "wb")
            try:
                two_eps_inv2 = 2.0 / (self.epsilon * self.epsilon)
                # accepted moves accumulate on the device (float64: exact
                # counts far beyond any run); ``done`` is tracked on the
                # host
                n_accepted = torch.zeros((), dtype=torch.float64,
                                         device=device)
                n_drawn = 0
                done = 0
                while True:
                    n_target = self._target(stats, two_eps_inv2)
                    local_target = -(-n_target // n_chains)   # ceil
                    if done >= local_target:
                        break
                    n = min(self.chunk_size, local_target - done)
                    sstate, stats, n_acc = self._chunk(
                        chunk_generator(next_seed(), gen_device), sstate,
                        stats, n)
                    n_accepted = n_accepted + n_acc
                    done += n
                    n_drawn += self.chunk_size * n_chains
                sync((sstate, stats))
            finally:
                if self._log_fh is not None:
                    self._log_fh.close()
                    self._log_fh = None
            self.timings["sampling_s"] = time.monotonic() - t_phase
        #: draws in the sampling phase (every chunk runs chunk_size draws)
        self.n_sampling_draws = n_drawn // n_chains
        self.p_accept = float(n_accepted) / max(n_drawn, 1)
        self.elapsed_s = time.monotonic() - t0
        return sstate, stats

    def _target(self, stats, two_eps_inv2) -> int:
        if self.n_samples > 0:
            return self.n_samples
        tau = self.stats_Q.tau_int(stats)
        if self.stats_Q.window_capped(stats):
            tau = max(tau, self._tau_binning())
        var = self.stats_Q.variance(stats)
        return max(self.n_min_samples_qoi,
                   int(math.ceil(tau * two_eps_inv2 * var)))

    def _tau_binning(self) -> float:
        """Binning cross-check of a window-capped tau_int over the
        per-step cross-chain mean series."""
        if not self._qbar_history:
            return 1.0
        return stats_mod.tau_binning(torch.cat(
            self._qbar_history).double().cpu().numpy())

    # -------------------------------------------------------------------------

    def numerical_result(self, stats) -> float:
        return self.stats_Q.average(stats)

    def statistical_error(self, stats) -> float:
        return self.stats_Q.error(stats)

    def show_statistics(self, stats):
        print(self.stats_Q.summary(stats))
        print(f" [timer SinglelevelMC] : {self.elapsed_s:.4f} s")
