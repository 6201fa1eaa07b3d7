"""Full multilevel Monte Carlo (MLMC) with the telescoping estimator
(PyTorch port of ``mlmcpathintegral_tpu/mc/multilevel.py``; reference
src/montecarlo/montecarlomultilevel.{hh,cc}).

Per level ell < L-1 the estimator measures Y_ell = Q_ell(theta_ell) -
Q_{ell+1}(theta_{ell+1}), where theta_{ell+1} is a tau-subsampled coarse
sample and theta_ell comes from one two-level Metropolis screening; the
coarsest level measures Y_{L-1} = Q_{L-1}.  The result is
sum_ell mean(Y_ell) with error sqrt(sum err_ell^2).

A level runs fused when it can: a quenched Schwinger level with
both-direction coarsening and a heat-bath coarse sampler runs the
two-level chain kernel (ops/schwinger_twolevel.py), the coarsest such level
the sweep-chain kernel (ops/schwinger.py); each chunk of ``chunk_size``
recorded samples is one launch plus the statistics update.  Every other
level (``use_pallas=False``, or another coarse sampler such as the hybrid
cluster sampler) runs unfused: per recorded sample the level's coarse
sampler draws ceil(2 tau) times (mc/twolevel.py make_coarse_subsampler),
and a chunk's coarse samples go through the batched screen
(make_batched_screen), or, where the level's fill reads the current fine
state, the sequential screen, a sample at a time
(make_sequential_screen).  Each chunk takes a seed pair (int32[2]) drawn from
the run's ``torch.Generator``: the kernels take it directly, an unfused
chunk seeds a generator on the chains' device from it, whose kernel seeds
come from a CPU twin on the card (mc/twolevel.py ``chunk_generator``), so
a launch of the chunk waits on no read from the card.  The host runs the
adaptive outer loop.  A level whose fused kernel would need more shared
memory per block than the card lets one block opt in to runs unfused with
its factory's coarse sampler, as the JAX package does with fields beyond
its VMEM budget (``_fused_fields_fit``); the plain versions on the CPU
have no such limit.  The paths are chosen again for the device of each
run (``init_carries``).  A configuration without a ported conditioned
fill raises when its factory is called.

Chain-parallel runs (``evaluate(mesh=)``, parallel/chains.py): every rank
builds every level's set-up state for all C chains from the same
generator and keeps its block of C/W chains, as the JAX package builds and
then shards; all ranks draw the same chunk seeds, and the fused kernels
hash the global chain index (``chain0``, the rank's first chain), so a
fused level's chains draw what they draw in a one-process run, bit for
bit.  The statistics are gathered over the mesh before a getter reads
them, so every decision — burn-in length, sample targets, t_sub, the
adaptive N_ell — is made from the same numbers on every rank, the
measured cost per sample from the slowest rank's time; the ranks stay in
lockstep.  An unfused chunk's generator is seeded from its chunk seed and
the rank, so its plain noise is the rank's own: that path equals the
one-process run in distribution, not bit for bit.  The multilevel method
is the one the reference cannot parallelise (driver_qm.cc:382-386).

Adaptive sample allocation (montecarlomultilevel.cc:147-164):
  N_ell = ceil( 2/eps^2 * S * sqrt(V_ell / C_ell^eff) * tau_ell ),
  S = sum_ell sqrt(V_ell * C_ell^eff),  C_ell^eff = ceil(tau_ell) C_ell
with per-sample costs C_ell timed on the warm chunks.
"""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.mc.twolevel import (
    chunk_generator, fill_row, make_batched_screen, make_coarse_subsampler,
    make_sequential_screen, run_generators,
)
from mlmcpathintegral_tpu_torch.mc.twolevelstep import TwoLevelMetropolisStep
from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops.statistics import STATS
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
from mlmcpathintegral_tpu_torch.utils import timer
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics
from mlmcpathintegral_tpu_torch.utils.timer import sync


class MonteCarloMultiLevel:

    #: max in-kernel coarse sweeps per launch: bounds the trace buffers
    #: and the single-launch runtime
    LAUNCH_SWEEP_BUDGET = 8192

    #: minimum in-kernel coarse sweeps per recorded sample on fused
    #: levels.  Delayed acceptance is exact only for independent coarse
    #: proposals; ceil(2 tau_QoI) under-decorrelates the heat-bath
    #: configuration at weak coupling and measurably biased the screened
    #: chain at 8x8 beta=4 (t_sub=4 vs 8)
    FUSED_T_SUB_MIN = 8

    def __init__(self, fine_action, qoi_factory, coarse_sampler_factory,
                 conditioned_fine_action_factory, *,
                 n_level: int, epsilon: float = 1e-2, n_burnin: int = 100,
                 n_samples: int = 0, n_autocorr_window: int = 20,
                 n_min_samples_qoi: int = 100, chunk_size: int = 128,
                 use_pallas: bool = True, t_max: int = 100):
        self.n_level = int(n_level)
        self.epsilon = float(epsilon)
        self.n_burnin = int(n_burnin)
        self.n_samples = int(n_samples)   # fixed per-level target if > 0
        self.n_min_samples_qoi = int(n_min_samples_qoi)
        self.chunk_size = int(chunk_size)
        #: the fused kernels where a level allows them, as in the JAX
        #: package's API; False runs every level unfused
        self.use_pallas = bool(use_pallas)
        self.t_max = int(t_max)

        # the action hierarchy + per-level machinery
        # (montecarlomultilevel.cc:26-68)
        self.actions = [fine_action]
        self.twolevel_steps = []
        self.coarse_samplers = []     # sampler feeding level ell (on ell+1)
        for ell in range(self.n_level - 1):
            coarse = self.actions[ell].coarse_action()
            cond = conditioned_fine_action_factory(self.actions[ell])
            self.twolevel_steps.append(
                TwoLevelMetropolisStep(coarse, self.actions[ell], cond))
            self.actions.append(coarse)
            self.coarse_samplers.append(coarse_sampler_factory(coarse))
        self.coarsest_sampler = coarse_sampler_factory(self.actions[-1])
        self._factory_samplers = (list(self.coarse_samplers),
                                  self.coarsest_sampler)
        #: the most shared memory one block may use on the run's device
        #: (None: no limit, the plain versions on the CPU)
        self._smem_limit = None
        #: the run's chain mesh, this rank's first chain and its rank (set
        #: for each run by _set_mesh)
        self._mesh, self._chain0, self._rank = None, 0, 0
        self.qois = [qoi_factory(a) for a in self.actions]
        self.stats_qoi = [Statistics(f"Y[{ell}]", n_autocorr_window)
                          for ell in range(self.n_level)]
        self.stats_cs = [Statistics(f"Q_sampler[{ell}]", n_autocorr_window)
                         for ell in range(self.n_level - 1)]
        #: slow-mode (plaquette-energy) statistics of the in-kernel coarse
        #: chains: the t_sub clock runs on max(tau_QoI, tau_slow)
        self.stats_slow = [Statistics(f"E_sampler[{ell}]",
                                      n_autocorr_window)
                           for ell in range(self.n_level)]
        self._setup_fused()
        self._build_unfused()

    # -- fused path (Schwinger, both-coarsening) ------------------------------

    def _fused_level(self, ell: int) -> bool:
        """Level ell (< L-1) runs the fused two-level kernel?"""
        if not self.use_pallas:
            return False
        from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
            QuenchedSchwingerAction,
        )
        act = self.actions[ell]
        if type(act) is not QuenchedSchwingerAction:
            return False
        if not self._factory_is_heatbath(self.coarse_samplers[ell]):
            return False
        lat = act.lattice
        if not (act._coarsen_case() == "both"
                and lat.Mt_lat % 2 == 0 and lat.Mx_lat % 2 == 0):
            return False
        from mlmcpathintegral_tpu_torch.ops.schwinger_twolevel import (
            twolevel_smem_bytes,
        )
        return self._fits(twolevel_smem_bytes(lat.Mt_lat, lat.Mx_lat)[2])

    def _fused_coarsest(self) -> bool:
        if not self.use_pallas:
            return False
        from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
            QuenchedSchwingerAction,
        )
        if not self._factory_is_heatbath(self.coarsest_sampler):
            return False
        if type(self.actions[-1]) is not QuenchedSchwingerAction:
            return False
        from mlmcpathintegral_tpu_torch.ops.schwinger import sweep_smem_bytes
        lat = self.actions[-1].lattice
        return self._fits(sweep_smem_bytes(lat.Mt_lat, lat.Mx_lat)[2])

    def _fits(self, block_bytes: int) -> bool:
        """A fused kernel's block (its launch at full chains per block)
        fits the run's device (``_fused_fields_fit`` of the JAX package)."""
        return self._smem_limit is None or block_bytes <= self._smem_limit

    @staticmethod
    def _smem_limit_of(device: torch.device):
        """The opt-in shared-memory limit of one block on ``device``; None
        on the CPU, whose plain versions have none."""
        if device.type == "cpu":
            return None
        return _cuda.max_smem_optin(device.index or 0)

    def _select_paths(self, device) -> None:
        """Choose fused or unfused per level for ``device``: a level whose
        fused block does not fit runs unfused with its factory's sampler."""
        limit = self._smem_limit_of(torch.device(device))
        if limit != self._smem_limit:
            self._smem_limit = limit
            self._setup_fused()
            self._build_unfused()

    @staticmethod
    def _factory_is_heatbath(sampler) -> bool:
        from mlmcpathintegral_tpu_torch.samplers.heatbath import (
            OverrelaxedHeatBathSampler,
        )
        return isinstance(sampler, OverrelaxedHeatBathSampler)

    def _setup_fused(self):
        """Swap in heat-bath coarse samplers for the fused levels (the
        in-kernel coarse chain is the heat bath; the sampler object only
        initialises and burns in) and start the per-level subsampling
        rates at the floor."""
        self._t_sub = [self.FUSED_T_SUB_MIN] * self.n_level
        from mlmcpathintegral_tpu_torch.samplers.heatbath import (
            OverrelaxedHeatBathSampler,
        )
        self.coarse_samplers = list(self._factory_samplers[0])
        self.coarsest_sampler = self._factory_samplers[1]
        for ell in range(self.n_level - 1):
            if self._fused_level(ell):
                self.coarse_samplers[ell] = OverrelaxedHeatBathSampler(
                    self.actions[ell + 1], n_sweep_heatbath=1,
                    n_sweep_overrelax=1, n_burnin=self.n_burnin)
        if self._fused_coarsest():
            self.coarsest_sampler = OverrelaxedHeatBathSampler(
                self.actions[-1], n_sweep_heatbath=1, n_sweep_overrelax=1,
                n_burnin=self.n_burnin)

    def _is_fused(self, ell: int) -> bool:
        return (self._fused_coarsest() if ell == self.n_level - 1
                else self._fused_level(ell))

    def _level_chunk(self, ell: int) -> int:
        """Per-launch recorded samples for level ell: the configured
        chunk_size, reduced when the level's t_sub would make one fused
        launch exceed LAUNCH_SWEEP_BUDGET coarse sweeps."""
        if not self._is_fused(ell):
            return self.chunk_size
        t_sub = self._t_sub[ell if ell < self.n_level - 1 else -1]
        return max(8, min(self.chunk_size,
                          self.LAUNCH_SWEEP_BUDGET // max(t_sub, 1)))

    def _make_fused_chunk(self, ell: int, t_sub: int):
        """Fused two-level chunk for level ell at subsampling rate t_sub:
        ``chunk(seed, carry, n_active) -> (carry, ybar)``.  While the
        program records (utils/timer.py), a chunk is span
        ``level{ell}.chunk``, its attributes ``accepts`` (the screen's
        accepts, a device count) and ``screens`` (n_steps x chains),
        around K4's ``k4.launch`` and ``level{ell}.stats`` (the statistics'
        update and the Y mean; its attribute ``stats_launches`` counts the
        statistics kernel's launches in it, 3 on the card)."""
        from mlmcpathintegral_tpu_torch.ops.schwinger_twolevel import (
            schwinger_twolevel_chain,
        )
        act, cact = self.actions[ell], self.actions[ell + 1]
        lat = act.lattice
        chunk_size = self._level_chunk(ell)
        four_pi2_inv = 1.0 / (4.0 * math.pi ** 2)
        # analytic per-sweep plaquette-energy mean of the coarse chain,
        # N_cells * I1(beta_c)/I0(beta_c): the slow-mode trace is recorded
        # centred so the f32 autocorrelation sums stay well-conditioned
        from scipy.special import i0e, i1e
        clat = cact.lattice
        ec_center = float(clat.Mt_lat * clat.Mx_lat
                          * i1e(cact.beta) / i0e(cact.beta))
        span_chunk, span_stats = f"level{ell}.chunk", f"level{ell}.stats"

        def chunk(seed, carry, n_active):
            with timer.span(span_chunk) as sp:
                return chunk_body(sp, seed, carry, n_active)

        def chunk_body(sp, seed, carry, n_active):
            cstate, tl, st_y, st_cs, st_slow, t_accum = carry
            thf, thc, sf, sq, y, qc, ec, acc = schwinger_twolevel_chain(
                tl.theta, cstate.x, tl.S_fine, tl.S_cond, seed,
                beta=act.beta, beta_c=cact.beta,
                Mt=lat.Mt_lat, Mx=lat.Mx_lat,
                n_steps=chunk_size, t_sub=t_sub, chain0=self._chain0)
            if sp:
                sp.set(accepts=acc.sum(), screens=acc.numel())
            with sp.child(span_stats) as ss:
                launches = STATS.launches
                st_y = stats_mod.record_block(st_y, y, n_valid=n_active)
                st_cs = stats_mod.record_many(st_cs, four_pi2_inv * qc * qc)
                st_slow = stats_mod.record_many(st_slow, ec - ec_center)
                # per-step cross-chain Y mean: the series behind the
                # binning cross-check of a window-capped tau
                ybar = self._ybar(y)
                ss.set(stats_launches=STATS.launches - launches)
            sum_t, n_indep = t_accum
            t_accum = (sum_t + t_sub * chunk_size,
                       n_indep + float(chunk_size))
            cstate = type(cstate)(x=thc)
            tl_new = type(tl)(theta=thf, S_fine=sf, S_cond=sq)
            return (cstate, tl_new, st_y, st_cs, st_slow, t_accum), ybar

        return chunk

    def _make_fused_chunk_L(self, t_sub: int):
        """Fused coarsest-level chunk: chunk_size tau-subsampled
        measurements driven by the sweep-chain kernel.  While the program
        records, span ``level{L-1}.chunk`` around K3's ``k3.launch`` and
        ``level{L-1}.stats`` (with ``stats_launches``)."""
        from mlmcpathintegral_tpu_torch.ops.schwinger import (
            schwinger_sweep_chain,
        )
        cact = self.actions[-1]
        lat = cact.lattice
        chunk_size = self._level_chunk(self.n_level - 1)
        four_pi2_inv = 1.0 / (4.0 * math.pi ** 2)
        from scipy.special import i0e, i1e
        ec_center = float(lat.Mt_lat * lat.Mx_lat
                          * i1e(cact.beta) / i0e(cact.beta))
        ell = self.n_level - 1
        span_chunk, span_stats = f"level{ell}.chunk", f"level{ell}.stats"

        def chunk_L(seed, carry, n_active):
            with timer.span(span_chunk) as sp:
                return chunk_body(sp, seed, carry, n_active)

        def chunk_body(sp, seed, carry, n_active):
            cstate, st_y, st_cs, st_slow, t_accum = carry
            x, qsum, esum = schwinger_sweep_chain(
                cstate.x, seed, beta=cact.beta,
                Mt=lat.Mt_lat, Mx=lat.Mx_lat,
                n_steps=chunk_size * t_sub, with_energy=True,
                chain0=self._chain0)
            with sp.child(span_stats) as ss:
                launches = STATS.launches
                qoi = four_pi2_inv * qsum * qsum       # [chunk*t_sub, C]
                st_cs = stats_mod.record_many(st_cs, qoi)
                st_slow = stats_mod.record_many(st_slow, esum - ec_center)
                y = qoi[t_sub - 1::t_sub]              # [chunk, C]
                st_y = stats_mod.record_block(st_y, y, n_valid=n_active)
                ybar = self._ybar(y)
                ss.set(stats_launches=STATS.launches - launches)
            sum_t, n_indep = t_accum
            t_accum = (sum_t + t_sub * chunk_size,
                       n_indep + float(chunk_size))
            return (type(cstate)(x=x), st_y, st_cs, st_slow, t_accum), ybar

        return chunk_L

    # -- unfused path (mc/twolevel.py) -----------------------------------------

    def _build_unfused(self):
        """The chunk functions of the unfused levels:
        ``chunk(seed, carry, n_active) -> (carry, ybar)``, as the fused
        ones.  A chunk draws ``chunk_size`` subsampled coarse samples; on
        a fine level the batched screen then screens them all."""
        self._unfused = {}
        for ell in range(self.n_level - 1):
            if self._fused_level(ell):
                continue
            step = self.twolevel_steps[ell]
            draw_coarse = make_coarse_subsampler(self.coarse_samplers[ell],
                                                 self.qois[ell + 1],
                                                 clock_view=self._gathered)
            if step.conditioned_fine_action.independent_fill:
                self._unfused[ell] = self._make_unfused_chunk(
                    draw_coarse,
                    make_batched_screen(self.actions[ell],
                                        self.actions[ell + 1],
                                        step.conditioned_fine_action,
                                        self.qois[ell], self.qois[ell + 1]))
            else:
                self._unfused[ell] = self._make_sequential_chunk(
                    make_sequential_screen(step, draw_coarse,
                                           self.qois[ell],
                                           self.qois[ell + 1]))
        if not self._fused_coarsest():
            self._unfused[self.n_level - 1] = self._make_unfused_chunk_L(
                make_coarse_subsampler(self.coarsest_sampler,
                                       self.qois[-1],
                                       clock_view=self._gathered))

    def _make_unfused_chunk(self, draw_coarse, screen):
        def chunk(seed, carry, n_active):
            cstate, tl, st_y, st_cs, st_slow, t_accum = carry
            gen = chunk_generator(seed, tl.theta.device, self._rank)
            xcs = None
            for i in range(self.chunk_size):
                cstate, st_cs, t_accum = draw_coarse(gen, cstate, st_cs,
                                                     t_accum)
                xcs = fill_row(xcs, i, self.chunk_size,
                               draw_coarse.sampler.x_of(cstate))
            tl, qf, qc, _ = screen(gen, tl, xcs)
            y = qf - qc
            st_y = stats_mod.record_block(st_y, y, n_valid=n_active)
            return (cstate, tl, st_y, st_cs, st_slow, t_accum), \
                self._ybar(y)

        return chunk

    def _make_sequential_chunk(self, screen):
        """An unfused level whose fill reads the current fine state: its
        chunk's samples screened one at a time (``make_sequential_screen``)."""
        def chunk(seed, carry, n_active):
            cstate, tl, st_y, st_cs, st_slow, t_accum = carry
            gen = chunk_generator(seed, tl.theta.device, self._rank)
            cstate, tl, st_cs, t_accum, qf, qc, _ = screen(
                gen, cstate, tl, st_cs, t_accum, self.chunk_size)
            y = qf - qc
            st_y = stats_mod.record_block(st_y, y, n_valid=n_active)
            return (cstate, tl, st_y, st_cs, st_slow, t_accum), \
                self._ybar(y)

        return chunk

    def _make_unfused_chunk_L(self, draw_coarse):
        qoi_L = self.qois[-1]

        def chunk_L(seed, carry, n_active):
            cstate, st_y, st_cs, st_slow, t_accum = carry
            x = draw_coarse.sampler.x_of(cstate)
            gen = chunk_generator(seed, x.device, self._rank)
            ys = []
            for _ in range(self.chunk_size):
                cstate, st_cs, t_accum = draw_coarse(gen, cstate, st_cs,
                                                     t_accum)
                ys.append(qoi_L(draw_coarse.sampler.x_of(cstate)))
            y = torch.stack(ys)
            st_y = stats_mod.record_block(st_y, y, n_valid=n_active)
            return (cstate, st_y, st_cs, st_slow, t_accum), \
                self._ybar(y)

        return chunk_L

    # -------------------------------------------------------------------------

    def _update_t_sub(self, carries, carry_L):
        """Re-estimate the fused levels' coarse subsampling rates from
        max(tau_QoI, tau_slow) of the in-kernel coarse chain — the slow
        configuration mode is measured rather than assumed
        (FUSED_T_SUB_MIN stays as the backstop).  Adapts between chunks;
        unfused levels subsample by their own clock, per sample."""
        def quantised(tau):
            # round ceil(2 tau) up to a power of two (extra decorrelation
            # is harmless), floor at FUSED_T_SUB_MIN, cap at t_max
            t = min(self.t_max, max(self.FUSED_T_SUB_MIN,
                                    math.ceil(2.0 * tau)))
            return min(1 << (t - 1).bit_length(), self.t_max)

        def ratchet(cur, new):
            # change only when the rate is too small or >= 4x too large
            return new if (new > cur or new * 4 <= cur) else cur

        g = self._gathered
        for ell in range(self.n_level - 1):
            if self._fused_level(ell):
                tau = max(self.stats_cs[ell].tau_int(g(carries[ell][3])),
                          self.stats_slow[ell].tau_int(g(carries[ell][4])))
                self._t_sub[ell] = ratchet(self._t_sub[ell], quantised(tau))
        if self._fused_coarsest():
            stats_L = Statistics("cs_L", self.stats_qoi[-1].k_max)
            tau = max(stats_L.tau_int(g(carry_L[2])),
                      self.stats_slow[-1].tau_int(g(carry_L[3])))
            self._t_sub[-1] = ratchet(self._t_sub[-1], quantised(tau))

    def _chunk(self, ell: int):
        """The chunk function of level ell (a fused one at its current
        t_sub; building one is cheap: no compilation on this path)."""
        if ell in self._unfused:
            return self._unfused[ell]
        if ell == self.n_level - 1:
            return self._make_fused_chunk_L(self._t_sub[-1])
        return self._make_fused_chunk(ell, self._t_sub[ell])

    # -------------------------------------------------------------------------

    def evaluate(self, generator, n_chains: int, dtype=torch.float32,
                 device="cuda", verbose: bool = False, sampling_scope=None,
                 mesh=None):
        """Run the full MLMC estimation.  ``generator``: a CPU
        ``torch.Generator`` (or an int seed for one) from which every
        chunk's seed pair and the set-up noise are drawn; ``device``: where
        the chains live, the card unless the caller asks for the CPU
        ("cuda" runs the kernels, which take float32; "cpu" their plain
        versions, in any float dtype).  ``sampling_scope``: a context
        manager (a profiler, say) entered around the phases that record
        the estimate's samples, the cost measurement and the adaptive
        loop.  Returns the per-level Y statistics states.

        ``mesh``: a chain mesh (``parallel.chain_mesh``) whose ranks split
        the n_chains chains; every rank calls this with the same arguments
        (the same generator seed).  The returned statistics are gathered
        over the mesh; ``final_carries`` holds this rank's chains."""
        from mlmcpathintegral_tpu_torch.parallel.chains import (
            all_reduce_scalar, chain_offset, shard_chains,
        )
        t_start = time.monotonic()
        device = _cuda.run_device(device)
        self.timings = {}   # wall-clock per phase
        L = self.n_level
        # set-up noise is drawn on the device by a generator seeded from
        # the run's generator
        next_seed, setup_gen = run_generators(generator, device)

        # the set-up of every chain on every rank, then this rank's block
        self._set_mesh(None, 0)
        carries, carry_L = self.init_carries(setup_gen, n_chains, dtype,
                                             device)
        if mesh is not None:
            carries = [shard_chains(mesh, c) for c in carries]
            carry_L = shard_chains(mesh, carry_L)
        self._set_mesh(mesh, chain_offset(mesh, n_chains))
        self.timings["prepare_s"] = time.monotonic() - t_start

        self._reset_ybar(L)

        def run_level(ell, carry, n_more):
            """Record n_more further samples on level ell.  n_more=0
            dispatches ONE chunk recording nothing (a warm-up whose chain
            steps are extra decorrelation)."""
            done = 0
            n_chunks = 0
            c_ell = self._level_chunk(ell)
            chunk = self._chunk(ell)
            while done < n_more or (n_more == 0 and n_chunks == 0):
                n = min(c_ell, n_more - done)
                carry, ybar = chunk(next_seed(), carry, n)
                if n > 0:
                    self._ybar_history[ell].append(
                        ybar[:n] if self._mesh is None else (ybar, n))
                done += n
                n_chunks += 1
            sync(carry)
            return carry

        def warm_all_levels(carries, carry_L):
            """One n_active=0 chunk per level, coarsest first: the first
            launch of each kernel at the current t_sub (module load,
            first-touch allocations) lands outside the timed phases; its
            chain steps are extra decorrelation."""
            carry_L = run_level(L - 1, carry_L, 0)
            for ell in range(L - 2, -1, -1):
                carries[ell] = run_level(ell, carries[ell], 0)
            return carries, carry_L

        t_phase = time.monotonic()
        carries, carry_L = warm_all_levels(carries, carry_L)
        self.timings["compile_burnin_s"] = time.monotonic() - t_phase

        # burn-in on every level, coarsest to finest
        # (montecarlomultilevel.cc:83-100)
        t_phase = time.monotonic()
        burn_local = -(-self.n_burnin // n_chains)
        for ell in range(L - 1, -1, -1):
            if ell == L - 1:
                carry_L = run_level(ell, carry_L, burn_local)
            else:
                carries[ell] = run_level(ell, carries[ell], burn_local)
        # soft reset of the Y statistics: long-term moments stay for tau
        carries = [(cs, tl, stats_mod.soft_reset(st_y), st_cs, st_sl, ta)
                   for (cs, tl, st_y, st_cs, st_sl, ta) in carries]
        carry_L = (carry_L[0], stats_mod.soft_reset(carry_L[1]),
                   carry_L[2], carry_L[3], carry_L[4])
        self._reset_ybar(L)
        if verbose:
            print("Burnin completed")
        sync(carry_L)
        self.timings["burnin_s"] = time.monotonic() - t_phase

        # adapt the subsampling rates to the coarse-chain tau learned
        # during burn-in, then warm the re-parametrised kernels
        t_phase = time.monotonic()
        self._update_t_sub(carries, carry_L)
        self.timings["tsub_update_s"] = time.monotonic() - t_phase
        t_phase = time.monotonic()
        carries, carry_L = warm_all_levels(carries, carry_L)
        self.timings["compile_cost_s"] = time.monotonic() - t_phase

        with sampling_scope or contextlib.nullcontext():
            # per-sample cost of each level kernel; its recorded samples
            # count toward the targets
            t_cost0 = time.monotonic()
            self.cost_per_sample = []
            for ell in range(L):
                n_probe = self._level_chunk(ell)
                t0 = time.monotonic()
                if ell == L - 1:
                    carry_L = run_level(ell, carry_L, n_probe)
                else:
                    carries[ell] = run_level(ell, carries[ell], n_probe)
                # every rank takes the slowest rank's time
                per = all_reduce_scalar(
                    self._mesh, time.monotonic() - t0, "max",
                    operand_on=device) / (n_probe * n_chains)
                self.cost_per_sample.append(per * 1e6)   # micro-seconds
            self.timings["cost_measure_s"] = time.monotonic() - t_cost0

            # adaptive loop (montecarlomultilevel.cc:113-169)
            t_phase = time.monotonic()
            two_eps_inv2 = 2.0 / (self.epsilon * self.epsilon)
            n_target = [self.n_min_samples_qoi] * L
            if self.n_samples > 0:
                n_target = [self.n_samples] * L

            def st_y_of(ell):
                return self._gathered(carry_L[1] if ell == L - 1
                                      else carries[ell][2])

            while True:
                for ell in range(L - 1, -1, -1):
                    have = self.stats_qoi[ell].samples(st_y_of(ell))
                    want = n_target[ell]
                    if have < want:
                        n_more = -(-(want - have) // n_chains)
                        if ell == L - 1:
                            carry_L = run_level(ell, carry_L, n_more)
                        else:
                            carries[ell] = run_level(ell, carries[ell],
                                                     n_more)
                if self.n_samples > 0:
                    # fixed per-level target: one pass fills every level
                    break
                self._update_t_sub(carries, carry_L)
                V, tau, C_eff = [], [], []
                for ell in range(L):
                    st_y = st_y_of(ell)
                    V.append(max(self.stats_qoi[ell].variance(st_y), 0.0))
                    t = self.stats_qoi[ell].tau_int(st_y)
                    if self.stats_qoi[ell].window_capped(st_y):
                        # windowed tau is a lower bound: cross-check with the
                        # binning estimate
                        t = max(t, self._tau_binning_level(ell))
                    tau.append(t)
                    C_eff.append(math.ceil(tau[ell])
                                 * self.cost_per_sample[ell])
                S = sum(math.sqrt(v * c) for v, c in zip(V, C_eff))
                n_target = [
                    max(self.n_min_samples_qoi,
                        math.ceil(two_eps_inv2 * S
                                  * math.sqrt(V[ell]
                                              / max(C_eff[ell], 1e-12))
                                  * tau[ell]))
                    for ell in range(L)]
                if all(self.stats_qoi[ell].samples(st_y_of(ell))
                       >= n_target[ell] for ell in range(L)):
                    break
            self.n_target = n_target
            self.timings["sampling_s"] = time.monotonic() - t_phase
        self.elapsed_s = time.monotonic() - t_start

        stats = [st_y_of(ell) for ell in range(L)]
        self._final_stats = stats
        #: the per-level chunk carries the run ended with (this rank's
        #: chains under a mesh): (carries of the levels < L-1, carry_L)
        self.final_carries = (carries, carry_L)
        #: learned slow-mode (plaquette-energy) tau per fused level — the
        #: quantity the t_sub clock ran on (None on unfused levels, whose
        #: clock is the sampler's subsample_observable)
        self.tau_slow = [
            self.stats_slow[ell].tau_int(self._gathered(
                carry_L[3] if ell == L - 1 else carries[ell][4]))
            if self._is_fused(ell) else None
            for ell in range(L)]
        self.reliability = self._assess_reliability(stats)
        return stats

    def init_carries(self, setup_gen, n_chains: int, dtype, device):
        """The per-level chunk carries ``(carries, carry_L)`` from which
        :meth:`evaluate` starts: sampler prepare (incl. burn-in),
        prolongate + conditioned fill of the initial coarse sample (a
        draw from q), cached action values, empty statistics.  The set-up
        noise comes from ``setup_gen``, a generator on ``device``, and the
        levels' paths are chosen for ``device`` first."""
        self._select_paths(device)
        L = self.n_level
        carries = []
        for ell in range(L - 1):
            sampler = self.coarse_samplers[ell]
            cstate = sampler.prepare(setup_gen, n_chains, dtype, device)
            xc = sampler.x_of(cstate)
            x_fine = self.actions[ell].initialise_state(setup_gen, n_chains,
                                                        dtype, device)
            x_fine = self.actions[ell].prolongate(xc, x_fine)
            x_fine = self.twolevel_steps[ell].conditioned_fine_action \
                .fill_fine_points(setup_gen, x_fine)
            tl = self.twolevel_steps[ell].init(x_fine)
            sync(tl)
            st_y = self.stats_qoi[ell].init(n_chains, dtype, device)
            st_cs = self.stats_cs[ell].init(n_chains, dtype, device)
            st_slow = self.stats_slow[ell].init(n_chains, dtype, device)
            carries.append((cstate, tl, st_y, st_cs, st_slow,
                            self._zero_accum(dtype, device)))
        cstate = self.coarsest_sampler.prepare(setup_gen, n_chains, dtype,
                                               device)
        st_y = self.stats_qoi[L - 1].init(n_chains, dtype, device)
        st_cs_L = Statistics("cs_L", self.stats_cs[0].k_max
                             if self.stats_cs else 20).init(
            n_chains, dtype, device)
        st_slow_L = self.stats_slow[-1].init(n_chains, dtype, device)
        carry_L = (cstate, st_y, st_cs_L, st_slow_L,
                   self._zero_accum(dtype, device))
        sync(carry_L)
        return carries, carry_L

    @staticmethod
    def _zero_accum(dtype, device):
        """(sum of t_sub, number of independent samples) counters."""
        return (torch.zeros((), dtype=dtype, device=device),
                torch.zeros((), dtype=dtype, device=device))

    # -------------------------------------------------------------------------

    # -- chain mesh --------------------------------------------------------

    def _set_mesh(self, mesh, chain0: int) -> None:
        """The run's chain mesh (None: one process), this rank's first
        global chain, which every kernel launch of the run hashes (the
        fused chunks pass it, the samplers take it as ``chain0``), and its
        rank, which seeds its unfused chunks' generators."""
        self._mesh = mesh
        self._chain0 = int(chain0)
        self._rank = mesh.axis("chains").rank if mesh is not None else 0
        for s in self.coarse_samplers + [self.coarsest_sampler]:
            s.chain0 = self._chain0

    def _gathered(self, state):
        """A statistics state over the global chain axis."""
        return stats_mod.gather(state, self._mesh)

    def _ybar(self, y):
        """What a chunk returns beside its carry: the per-step cross-chain
        means of its Y [chunk, C]; under a mesh the rank's block of Y
        itself, whose means are taken over the gathered chains where the
        series is read (``_ybar_series``)."""
        return torch.mean(y, dim=1) if self._mesh is None else y

    def _ybar_series(self, h):
        if not isinstance(h, tuple):
            return h
        y, n = h
        y_all = stats_mod.gather(y.T, self._mesh).T.contiguous()
        return torch.mean(y_all, dim=1)[:n]

    # -------------------------------------------------------------------------

    def _reset_ybar(self, L: int):
        self._ybar_history = [[] for _ in range(L)]
        #: per-level (concatenated float64 host series, #chunks consumed)
        self._ybar_cache = [(np.empty(0), 0) for _ in range(L)]

    def _tau_binning_level(self, ell) -> float:
        """Binning tau estimate of level ell's recorded Y series (the
        per-step cross-chain means collected by run_level); chunks are
        copied to the host once, incrementally."""
        hist = self._ybar_history[ell]
        cache, used = self._ybar_cache[ell]
        if len(hist) > used:
            new = [self._ybar_series(h).double().cpu().numpy()
                   for h in hist[used:]]
            cache = np.concatenate(([cache] if cache.size else []) + new)
            for i in range(used, len(hist)):
                hist[i] = None
            self._ybar_cache[ell] = (cache, len(hist))
        if cache.size == 0:
            return 1.0
        return stats_mod.tau_binning(cache)

    def _assess_reliability(self, stats):
        """Per-level reliability report: window_capped and a binning
        cross-check of tau; a level is flagged when its windowed tau is
        capped AND the binning estimate exceeds it by >1.5x."""
        out = []
        for ell in range(self.n_level):
            st_y = stats[ell]
            capped = self.stats_qoi[ell].window_capped(st_y)
            tau_w = self.stats_qoi[ell].tau_int(st_y)
            tau_b = self._tau_binning_level(ell) if capped else None
            tau_eff = max(tau_w, tau_b) if tau_b is not None else tau_w
            out.append({
                "level": ell,
                "window_capped": bool(capped),
                "tau_int": float(tau_w),
                "tau_binning": (None if tau_b is None else float(tau_b)),
                "tau_eff": float(tau_eff),
                "flagged": bool(capped and tau_eff > 1.5 * tau_w),
            })
        return out

    @property
    def reliable(self) -> bool:
        """False when a level's tau_int is window-capped and the binning
        cross-check says it is substantially underestimated."""
        rel = getattr(self, "reliability", None)
        return rel is None or not any(r["flagged"] for r in rel)

    def statistical_error_robust(self, stats=None) -> float:
        """Statistical error with each level's tau replaced by
        max(windowed, binning) — an upper-bound error bar."""
        explicit = stats is not None
        stats = stats if explicit else self._final_stats
        rel = (self._assess_reliability(stats) if explicit
               else getattr(self, "reliability", None)
               or self._assess_reliability(stats))
        tot = 0.0
        for ell in range(self.n_level):
            n = self.stats_qoi[ell].samples(stats[ell])
            if n == 0:
                return float("inf")
            v = max(self.stats_qoi[ell].variance(stats[ell]), 0.0)
            tot += rel[ell]["tau_eff"] * v / n
        return math.sqrt(tot)

    def numerical_result(self, stats=None) -> float:
        stats = stats if stats is not None else self._final_stats
        return sum(self.stats_qoi[ell].average(stats[ell])
                   for ell in range(self.n_level))

    def statistical_error(self, stats=None) -> float:
        stats = stats if stats is not None else self._final_stats
        return math.sqrt(sum(self.stats_qoi[ell].error(stats[ell]) ** 2
                             for ell in range(self.n_level)))

    def show_statistics(self, stats=None):
        stats = stats if stats is not None else self._final_stats
        print(f" Q: Avg +/- Err = {self.numerical_result(stats):.6f} "
              f"+/- {self.statistical_error(stats):.6f}")
        print(f" [timer MultilevelMC] : {self.elapsed_s:.4f} s")

    def show_detailed_statistics(self, stats=None):
        stats = stats if stats is not None else self._final_stats
        print("=== Statistics of QoI ===")
        for ell in range(self.n_level):
            print(f"level = {ell}")
            print(self.stats_qoi[ell].summary(stats[ell]))
            print(f" target number of samples = {self.n_target[ell]}")
            print(f" cost per sample          = "
                  f"{self.cost_per_sample[ell]:.3f} mu s")
            print("------------------------------------")
