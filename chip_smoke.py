#!/usr/bin/env python3
"""Drive the PyTorch port (``mlmcpathintegral_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. build   - compile the kernels of ``csrc/`` with nvcc (timed) and
               print the card's name and power limit;
  2. rng     - the counter RNG (csrc/rng.cuh, through csrc/rng_fill.cu)
               against its plain PyTorch version over three id grids: all
               1024 chains x 64 sites at steps 0-3, counters 1-8; the
               main path's whole step x counter range (steps 0-2303,
               counters 1-320) at 16 sites x 4 chains; and the step-less
               streams at 256 sites x 4096 chains, counters 1-32; bits
               and uniforms identical, normals within 1e-6; then the
               kernel's device time (profiler) at the first grid and at
               two grids of 33.5M words (stepped and step-less), each
               beside its bound;
  3. sweep   - the sweep-chain kernel: overrelax-only against the plain
               version (max |d theta| <= 1e-5), n_steps=N against N
               single draws (bit-identical), with heat bath at 8x8 and
               4x4 the share of chains agreeing with the plain version to
               1e-4 after 4 draws (>= SHARE_MIN), and the main path's
               coarsest-level launch (4x4, beta_c=1, 1024 chains,
               n_steps=2048) against the plain version on its per-step
               Q and E traces (see ``departures``), with the sha256 of its
               outputs (two trees compare by it), its layout (lanes a
               chain, chains a block, branch: warp, block or global),
               registers a thread and resident warps an SM, and the
               rejection rounds of its plain version; and run 12's launch
               (phase 16: one draw of the temporally coarsened Schwinger
               file's coarse level, 8 sites in x by 4 in t, beta_c = 2,
               4096 chains; ``run12_launch``) with >= SHARE_MIN of the
               chains within 1e-4 mod 2 pi, its device ms, plain ms,
               bound and layout;
  4. twolevel - the two-level kernel at the main path's launch (8x8,
               beta=4, 1024 chains, n_steps=256, t_sub=8) against the
               plain version on its per-step y, accept, qc and ec traces
               (see ``departures``), and at beta=10 (the beta > 8 fill)
               for 4 steps: the share of chains whose y, acc, S_fine,
               S_cond and fine field agree to 1e-4 (>= SHARE_MIN); the
               main launch's sha256, layout, registers, resident warps and
               rejection rounds as in phase 3;
  5. mlmc    - the main path: MonteCarloMultiLevel with the settings of
               bench.py's bench_schwinger_mlmc, as
               ``perf_probe.headline_mlmc`` builds it (8x8, both-direction
               coarsening, beta=4 nonperturbative, heat-bath coarse chains,
               1024 chains, f32, 100k samples per level, chunk 256) on
               the card; it must go through the kernels (launch counters
               > 0, no plain-version call on CUDA) and land within 4 sigma
               of the analytic chi_t; printed with the layouts and
               rejection rounds of its two kernels' launches;
  6. rotor_sweep - the rotor sweep kernel (csrc/rotor_sweep.cu):
               overrelax-only identical to the plain version, one
               rotor_sweep against it, and path B2's launch (M=256, 4096
               chains, 128 steps) against it on the winding-sum trace
               (see ``departures``) and on the final paths (>= SHARE_MIN
               within 1e-4 mod 2 pi: the winding sum is blind to a change
               of one site), with the sha256 of the single sweep's and of
               the B2 launch's outputs, the launch's layout (chains a
               block, shared bytes, table words; a warp a chain),
               registers a thread and resident warps an SM; and path F2's
               launch (one draw of the rotor file's coarsest level: M=16,
               4096 chains, kappa=1, 10 overrelaxation + 1 heat-bath
               sweeps) against it (>= SHARE_MIN within 1e-4 mod 2 pi),
               timed beside its bound;
  7. rotor_cluster - the Wolff cluster kernel (csrc/rotor_cluster.cu)
               against its plain version at path A's launch shape (M=16,
               1024 chains, 5 updates; 64 steps compared, the 1-step launch
               timed by the profiler's device time per launch, the host's
               time per launch beside it), at path B1's launch (M=256,
               4096 chains, 128 steps x 10 updates) and at a ragged M (24
               sites: idle lanes; 64 chains, 64 steps x 10 updates), on
               winding sums and fields; with each launch's layout,
               registers a thread and resident blocks and warps an SM;
  8. rotor_chains - paths B1 (ClusterSampler on the cluster kernel) and B2
               (OverrelaxedHeatBathSampler on the sweep kernel, started
               from B1's paths): the rotor of bench.py's
               bench_rotor_cluster_M (M=256, T=4, I=0.25, 4096 chains,
               chunks of 128 steps) within 4 sigma of chit_exact;
  9. mlmc_cluster - path A: the main path's configuration with the hybrid
               cluster coarse chains of bench_schwinger_mlmc(coarse=
               "cluster"), as ``perf_probe.headline_mlmc_cluster`` builds
               it, on the card: within 4 sigma, through the cluster kernel
               (launches > 0, no plain-version call on CUDA);
 10. hmc     - the HMC trajectory kernel (csrc/hmc_trajectory.cu) against
               its plain version on the same x, p, u (x equilibrated by 30
               kernel trajectories, so some chains reject), for each kind
               at path D's launch (8192 chains, M=64, nt=20) and for the
               quartic one at path C's coarse launch (4096 chains, M=32,
               nt=100) and for the harmonic one at path F's (the
               hierarchy's coarsest level of runs F1 and F3: 4096 chains,
               M=16, nt=100, a=4/16; an aligned half-warp a chain):
               >= SHARE_MIN of chains with x within TOL and the
               same accept bit; with each launch's sha256 of x_out and
               accept, its layout (branch, lanes a chain, sites a lane,
               chains a block, shared bytes), registers a thread and
               resident warps an SM;
 12. hmc_chain - path D: bench.py's bench_harmonic unchanged
               (``perf_probe.harmonic_hmc``: M=64, T=4, m0=mu2=1, 8192
               chains, nt=20, prepare with autotune, a warm chunk, 8
               chunks of 64 draws) through the trajectory kernel alone,
               within 4 sigma of Xsquared_analytical;
 13. qm_twolevel_mlmc - paths C and C': bench_quartic_twolevel unchanged
               (``perf_probe.quartic_twolevel``: M=64, T=4,
               m0=mu2=lam=x0=1, 4096 chains, coarse HMC nt=100, Gaussian
               fill, 256 samples per chain in chunks of 64, a warm-up call
               first) through the trajectory and two-level kernels, the
               fine <x^2> within 4 combined sigma of the C++ run's; and the
               same with the harmonic action (C'), fine and coarse within
               4 sigma of their Xsquared_analytical;
 11. qm_twolevel - the two-level kernel (csrc/qm_twolevel.cu) against its
               plain version at path C's launch (4096 chains, Mc=32,
               nt=100, 64 steps) at t_sub=2 with traces (burn-in) and at
               the t_sub path C measured, without (sampling), on the
               per-step fine/coarse QoI and accept traces and the
               per-trajectory clock traces (see ``departures``), and the
               final fields and cached actions (>= SHARE_MIN within TOL),
               with the launch's layout, registers a thread and resident
               blocks and warps an SM.  It runs after phase 13, whose
               t_sub it takes.
 14. gff_sweep - the GFF sweep kernel (csrc/gff_sweep.cu) against its
               plain version: overrelax-only within 1e-6, and after 64
               heat-bath draws (1 overrelax + 1 heat bath each) every chain
               within TOL at path E's launch (4096 chains, 16x16; the warp
               branch) and at 128x128 and 256x256 (64 chains; the block
               and the global-memory branch), with each launch's branch,
               registers a thread and resident warps an SM; the
               neighbour-sum kernel (P1) identical to its plain version at
               the JAX probe's shapes (256 chains; 8x8, 16x16, 16x8, 8x16)
               and, timed beside their bounds, at path E's field (4096 x
               16x16) and 64 x 256x256; rng_fill's step-less streams (P2: seed
               42, 64 sites x 512 chains, words 1-3) with bits and
               uniforms identical; and the Schwinger sweep kernel on a
               256x256 lattice (64 chains, its global-memory branch):
               overrelax-only within 1e-5, one heat-bath draw with all but
               1e-4 of the links within TOL (a rounding flip of one of a
               chain's 131 072 links moves the chain);
 15. gff_singlelevel - path E: the reference's GFF parameter file
               (16x16, mass 10) driven single-level through the port's QFT
               driver with the heat bath on the GFF sweep kernel
               (``perf_probe.gff_heatbath``: 4096 chains, f32, 512
               sampling draws) on the card: within 4 sigma of
               phi_squared_analytical, 100 + 4 x 256 + 512 = 1636 sweep
               launches and no plain-version call on CUDA; then the same
               run under the profiler for the sampling phase's idle share
               and device ms per draw;
 16. qm_driver - a float64 file with use_pallas raises the kernels'
               TypeError on the card with no launch; then the QM driver
               (``drivers.qm.run``) on the reference's QM files at their
               widths (M_lat = 64, T = 4, nt = 100, 3 levels; 4096 f32
               chains where a file has no parallel section): the
               hierarchical sampler with HMC (K5) and heat-bath (K8)
               coarse chains, the multilevel sampler (K5), the
               double-well two-level run (K5), the rotor MLMC with plain
               cluster coarse chains, and the Schwinger two-level run
               through ``drivers.qft.run`` (K3 on its coarse chains); then
               the QFT files through ``drivers.qft.run``: the sigma file
               single-level (run 7) and two-level (8), after run 7 a short
               chain of the 2-D cluster sampler held to run 7's chi_m
               (``sigma_cluster_check``), the GFF file two-level with
               heat-bath (9) and exact (10) coarse chains and multilevel
               (11), and the Schwinger file coarsened in time only,
               two-level with K3 on its coarse chains (12); each within 4
               sigma of its oracle (runs 2, 3, 7, 8 and 11 the JAX
               package's estimate of their file and method, their
               distance from the analytic or single-level value beside
               it; run 4 the C++ run's; ``BESIDE`` the values reported and
               not gated), its path's kernels launched, no plain-version
               call on CUDA, and the phase that records its samples under
               the profiler, through the drivers' ``sampling_scope``, for
               its host and device ms a draw (``QM_RUNS``,
               ``REFERENCES``, ``ProfiledPhase``); then run 13, the
               last reference file no port run had driven
               (``ref_qft_schwinger_heatbath.in``: single-level heat
               bath, 8x8, beta = 4, 200 000 samples) as is and with
               its heat bath on K3, both at 4 sigma from chit_exact
               (the plain run's burn-in cut 10 000 -> 256 draws; cuts
               of F1 10 000 -> 1 000, F2 1 000 -> 256 and F3 500 -> 256
               draws keep the script within its limit);
 17. chain0  - every kernel's global chain offset at its path's launch
               (K3 and K4 at the main path's, K6 at path C's, 16 steps,
               K7 at path A's, K8 at B2's, K9 at E's, rng_fill at the
               kernel table's grid and P2's step-less grid): the launches
               of the two halves, the second with chain0 = C/2, equal the
               whole launch bit for bit, and the plain version with
               chain0 = C/2 passes the kernel's own phase's gates on the
               second half (K3 and K4: on its first 256 chains); the
               same for K3's and K4's block branches at phase 21's 16x16
               (2048 chains) and 32x32 (1024 chains) fields, whose halves
               run larger teams than the whole launch
               (``block_chain0_halves``, phase 21's gates on 64 chains);
               every sha256 phases 3, 4, 6 and 10 printed
               equals its recorded value (``BASELINE_SHA256``);
 18. mlmc_two_ranks - phase 5's run on two gloo ranks of the card (512
               chains each, ``mesh=``, ``two_rank_main_path``): its chi,
               error, tau_int(Y_0), t_sub and per-level samples must equal
               phase 5's exactly; each rank's kernel launches, its
               ``evaluate`` wall beside phase 5's, and the ms of one
               gather of a level's statistics and of one scalar
               all-reduce (the collectives of an adaptive decision);
 19. checkpoint - the main path's coarsest heat-bath chain (K3, 1024
               chains): 64 draws, saved, loaded into a fresh template, 64
               more equal 128 uninterrupted draws bit for bit; a saved
               and restored fine-level carry's next K4 chunk equals the
               uninterrupted one;
 20. spatial - the halo-exchange sweeps of ``parallel/spatial.py`` at one
               rank (GFF 256x256 and Schwinger 64x64, 64 chains each)
               equal their dense sweeps bit for bit, each timed beside
               the dense one;
 21. scale   - the paper's Schwinger scale study (``tools/
               schwinger_scale_study``, beta = 4 (M/16)^2, three levels):
               K4's block branch against its plain version at the 32x32
               and 64x64 fine launches (256 chains, 16 steps, t_sub = 4,
               the rows' beta and nonperturbative beta_c) under phase 4's
               departures gates and >= SHARE_MIN on y, accept, S_fine,
               S_cond and the field (y within TOL M/8: the f32 rounding of
               its charge sum over M^2 plaquettes), and K3's block branch
               at 16x16 and 32x32 (the 64x64 and 128x128 rows' coarsest
               launches at their beta): overrelax-only within 1e-5 and
               the heat-bath share after 4 draws as in phase 3, each
               launch's layout (the block design's threads a chain,
               chains a block, registers, resident warps), sha256 and
               device ms beside its bound;
               then the 16x16 and 32x32 rows through the tool's
               ``run_mlmc`` at 1024 chains with their sample counts cut
               (``SCALE_RUNS``), each within 4 sigma of chit_exact, K3
               and K4 launched, no plain-version call on CUDA; and the
               sequential two-level screen: the harmonic oscillator with
               exact coarse draws and the Gaussian fill forced through
               it, 1024 chains, within 4 sigma of Xsquared_analytical;
 22. hybrid  - the hybrid cluster draw's mixing sweep on the sweep
               kernel (K2, one ``schwinger_sweep`` launch a draw): K2
               against its plain version at the draw's launches on the
               cluster rows' level-0 coarse lattices (32x32 at the 64x64
               row's beta_c, 64x64 at the 128x128 row's; 256 chains on
               links the hybrid sampler rebuilt) under phase 3's gates
               (overrelax-only within 1e-5, >= SHARE_MIN of the chains
               within 1e-4 after 4 launches), each timed beside its bound
               with its layout as in phase 21;
               the 16x16 row of the scale study with hybrid cluster coarse
               chains through ``run_mlmc`` (1024 chains, 1M samples a
               level, ``HYBRID_ROW``): within 4 sigma of chit_exact, no
               flagged
               level, K7 and K2 launched, no plain version on CUDA; and
               path A's level-0 coarse samples and batched screen profiled
               (``scripts/unfused_profile.py``): host and device ms a
               draw, idle share, host reads a sample.  Phase 9 also
               requires one K2 launch a hybrid draw (K7's launches less
               the samplers' K7-only burn-in).
 23. stats   - the statistics kernel (``ops/statistics.py``,
               ``csrc/statistics.cu``) against ``record_block_plain`` on
               the same card tensors at the benchmark cells' records
               (``STATS_SHAPES``): ring and counters equal, moments and
               S_k within 64 eps sqrt(T) of the field's scale (the chip
               test's tolerance); each with the kernel's ms and the plain
               version's (CUDA events), the memory each allocates beyond
               its inputs, the bound, the launch layout, registers and
               resident warps.

Each path is driven with every launch counter set to 0 just before it and
read just after; each kernel of a path must have launched in it.  The
kernels line gives, per kernel, its launches on its path (K3 and K4 on
phase 5's, K7 on path A, K8 on path B2, K5 on path D, K6 on path C, K9
on path E; the two probe kernels, P1 and rng_fill's step-less mode P2,
are on no path and launch 0 times there; K3 and K4 also with their
launches on phase 21's 16x16 row and their block branches' times; K2, the
same kernel as K3, with its launches on path A and on phase 22's 16x16
cluster row and its times at the hybrid draw's launches; the statistics
kernel S with its launches on phase 5's path and its times at phase 23's
shapes),
``chain0`` where phase 17
checked the kernel's chain offset (K3 and K4 also ``block_branch_chain0``), the
measured ms of a launch at
its path's shape beside the plain version's and the bound (the least time
the card could take for the launch's work, ``perf_probe.bound_ms``; the
operations are counted from the kernel's arithmetic, with the rejection
rounds this run's plain versions took).

A kernel and its plain version compute the same thing in f32 with
transcendentals and sums rounded differently, so a chain departs from its
plain twin where a rounding flips a rejection or accept test, and then
stays apart.  Over a long launch the checks therefore follow each chain
until it departs: few chains may depart in the first step, few in the
first 16, and at no later step may more than MAX_HAZARD of the chains
still together depart at once (a fault tied to step or counter ids would
move them all).

Then the script's own wall seconds, the card line of nvidia-smi, the
kernel table as one JSON object, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA card,
or without the package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

#: relative agreement of a kernel output with its plain version
#: (differences over max(|plain|, 1))
TOL = 1e-4
#: least share of chains agreeing after a few steps
SHARE_MIN = 0.98
#: long launches: most chains that may depart in the first step, steps
#: the early share is taken over, and the largest share of the chains
#: still together that may depart at one later step (taken where at
#: least HAZARD_MIN_ALIVE chains are still together)
MAX_STEP0_DEPARTURES = 3
HEAD_STEPS = 16
MAX_HAZARD = 0.05
HAZARD_MIN_ALIVE = 100


#: the script's start, for each line's seconds since it (``t_s``)
START = time.monotonic()


def emit(obj):
    """One JSON line; a phase's line gets the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.monotonic() - START, 1)}
    print(json.dumps(obj), flush=True)


def sha256_of(tensors):
    """sha256 (16 hex digits) of the tensors' bytes in order: two trees'
    kernels at the same launch on the same card compare by it."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def field_share(a, b, tol):
    d = (a.double() - b.double()).abs().reshape(a.shape[0], -1)
    return float((d.amax(dim=1) <= tol).double().mean())


def angle_share(a, b, tol):
    """field_share for angles: differences taken mod 2 pi (a value at the
    -pi/pi seam may land on either side)."""
    d = torch.remainder(a.double() - b.double() + math.pi, 2 * math.pi) \
        - math.pi
    return float((d.abs().reshape(a.shape[0], -1).amax(dim=1)
                  <= tol).double().mean())


def rel_diff(a, b):
    return (a.double() - b.double()).abs() / b.double().abs().clamp(min=1.0)


def trace_share(a, b, tol):
    d = rel_diff(a, b)
    if d.dim() == 1:
        return float((d <= tol).double().mean())
    return float((d.amax(dim=0) <= tol).double().mean())


def departures(agree, diffs):
    """Follow each chain of a long launch until it departs from its plain
    twin.  ``agree``: bool [n_steps, C], True where all of chain c's
    outputs of step s agree; ``diffs``: [n_steps, C] absolute differences
    of the outputs.  Returns the report and whether it passes."""
    n, C = agree.shape
    steps = torch.arange(n, device=agree.device)[:, None]
    first = torch.where(agree, n, steps).amin(dim=0)       # [C]
    counts = torch.bincount(first, minlength=n + 1)[:n]      # per step
    alive = C - torch.cumsum(counts, 0) + counts             # entering s
    hazard = torch.where(alive >= HAZARD_MIN_ALIVE,
                         counts / alive.clamp(min=1), 0.0)
    together = steps < first[None, :]
    rep = {"chains": C, "steps": n,
           "departed_at_step0": int(counts[0]),
           f"share_together_{HEAD_STEPS}_steps":
               float((first >= HEAD_STEPS).double().mean()),
           "share_together_all_steps": float((first >= n).double().mean()),
           "median_departure_step": float(first.double().median()),
           "max_hazard": float(hazard.max()),
           "max_hazard_step": int(hazard.argmax()),
           "max_abs_err_while_together": float(
               torch.where(together, diffs, 0.0).max())}
    ok = (rep["departed_at_step0"] <= MAX_STEP0_DEPARTURES
          and rep[f"share_together_{HEAD_STEPS}_steps"] >= SHARE_MIN
          and rep["max_hazard"] <= MAX_HAZARD)
    return rep, ok


#: operations counted from the kernels' arithmetic, each float or integer
#: add, multiply, compare, select, shift, bit operation and
#: transcendental one: a counter-RNG word (3 fmix32, 2 multiply-adds, the
#: float bits), a (site, step) stream's set-up, mod_2pi, one ExpCos
#: rejection round (3 words, the proposal and the test), an ExpCos draw's
#: set-up, a link's two staples, one BesselProduct round (4 words, the
#: proposal and the test)
OPS_WORD, OPS_RNG_INIT, OPS_MOD2PI = 32, 30, 6
OPS_EXPCOS_ROUND, OPS_EXPCOS_SETUP, OPS_STAPLES = 3 * 32 + 19, 20, 16
OPS_BESSEL_ROUND, OPS_BESSEL_SETUP = 4 * 32 + 40, 25


@contextlib.contextmanager
def rejection_tally():
    """Count the rounds the plain versions' rejection loops run, to count
    the work a launch does on its data (the sequential loop stops at its
    first accepted round).  Yields {kind: [draws, rounds]}, filled while
    the context is open: "expcos" for the ExpCos draws of every plain
    version, "bessel" for the two-level fill's BesselProduct draws.  The
    plain versions evaluate all rounds at once and pick the first accepted
    one in ``_first_accepted``; this wraps it in both modules that call
    it."""
    from mlmcpathintegral_tpu_torch.ops import schwinger
    from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as tl
    tally = {}

    def counting(first_accepted, kind):
        def wrapped(prop, ok):
            x, acc = first_accepted(prop, ok)
            first = torch.argmax(ok.to(torch.int8), dim=0)
            rounds = torch.where(acc, first + 1, ok.shape[0])
            draws, total = tally.get(kind, (0, 0))
            tally[kind] = [draws + rounds.numel(), total + rounds.sum()]
            return x, acc
        return wrapped

    saved = schwinger._first_accepted, tl._first_accepted
    schwinger._first_accepted = counting(saved[0], "expcos")
    tl._first_accepted = counting(saved[1], "bessel")
    try:
        yield tally
    finally:
        schwinger._first_accepted, tl._first_accepted = saved


def tallied(fn):
    """Run a plain version once, timed with CUDA events and with its
    rejection rounds counted: (its result, mean rounds per draw by loop
    kind, ms).  One run serves the comparison, the timing and the work
    count: a plain version at a path's launch shape takes seconds."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with rejection_tally() as tally:
        torch.cuda.synchronize()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
    return (out, {k: float(r) / d for k, (d, r) in tally.items()},
            start.elapsed_time(stop))


def work_rng(n_sites, n_chains, n_steps, n_ctr):
    """(bytes, operations) of an rng_fill launch: every word's bits and
    uniform, and a Box-Muller normal (6 operations) per word pair."""
    n_words = n_sites * n_chains * n_steps * n_ctr
    return (4 * (2 * n_words + n_words // 2),
            n_sites * n_chains * n_steps * OPS_RNG_INIT
            + n_words * OPS_WORD + n_words // 2 * 6)


def sweep_ops(n_links, n_plaq, r, n_overrelax=1, n_heatbath=1):
    """Operations of one Schwinger sweep-chain step of one chain."""
    return (n_overrelax * n_links * (OPS_STAPLES + 2 + OPS_MOD2PI)
            + n_heatbath * n_links * (OPS_STAPLES + OPS_RNG_INIT
                                      + OPS_EXPCOS_SETUP
                                      + r * OPS_EXPCOS_ROUND)
            + n_plaq * (6 + OPS_MOD2PI))


def work_k3(C, Mx, Mt, n_steps, r):
    """(bytes, operations) of a sweep-chain launch with Q and E traces."""
    n_links = 2 * Mx * Mt
    nbytes = 4 * (2 * C * n_links + 2 * n_steps * C)
    return nbytes, C * n_steps * sweep_ops(n_links, Mx * Mt, r)


def work_k4(C, Mx, Mt, n_steps, t_sub, r, r_bessel):
    """(bytes, operations) of a two-level launch: per step t_sub coarse
    sweeps, then per coarse cell the fill (perimeter, BesselProduct,
    vertical split, two ExpCos links), its four fine plaquettes in S_fine
    and Q, S_cond and the restriction."""
    n_f, n_c, n_cells = 2 * Mx * Mt, Mx * Mt // 2, Mx * Mt // 4
    per_cell = (OPS_RNG_INIT + 2 * OPS_WORD + 4 * (1 + OPS_MOD2PI)
                + OPS_BESSEL_SETUP + r_bessel * OPS_BESSEL_ROUND
                + OPS_WORD + 2 * (2 + OPS_MOD2PI)
                + 2 * (OPS_STAPLES + OPS_EXPCOS_SETUP
                       + r * OPS_EXPCOS_ROUND)
                + 4 * (6 + OPS_MOD2PI) + 46 + 2 * (1 + OPS_MOD2PI) + 12)
    per_step = t_sub * sweep_ops(n_c, n_cells, r) + n_cells * per_cell + 15
    nbytes = 4 * (2 * C * (n_f + n_c + 2) + 2 * n_steps * C
                  + 2 * n_steps * t_sub * C)
    return nbytes, C * n_steps * per_step


def work_k8(C, M, n_steps, r, n_overrelax=1, n_heatbath=1):
    """(bytes, operations) of a rotor sweep-chain launch."""
    per_step = (M * (n_overrelax * (2 + OPS_MOD2PI)
                     + n_heatbath * (OPS_RNG_INIT + OPS_EXPCOS_SETUP
                                     + r * OPS_EXPCOS_ROUND))
                + M // 2 * (2 * (1 + OPS_MOD2PI) + 2))
    return 4 * (2 * C * M + n_steps * C), C * n_steps * per_step


def work_k7(C, M, n_steps, n_updates):
    """(bytes, operations) of a rotor cluster-chain launch: per update the
    reflection and seed (site 0's stream), then per site its cosine, bond
    probabilities, walk orders, two words, two tests, flip count and
    flip; per step the winding sum."""
    per_update = (OPS_RNG_INIT + 2 * OPS_WORD + 8
                  + M * (2 + 9 + 6 + OPS_RNG_INIT + 2 * OPS_WORD + 6 + 12
                         + 3 + OPS_MOD2PI + 2))
    per_step = n_updates * per_update + M * (2 + OPS_MOD2PI)
    return 4 * (2 * C * M + n_steps * C), C * n_steps * per_step


#: per-site operations of one force evaluation and of one action density
#: term (with its add into the sum) of each HMC kind
OPS_QM_FORCE = {"harmonic": 4, "quartic": 9, "rotor": 6}
OPS_QM_DENSITY = {"harmonic": 7, "quartic": 13, "rotor": 4}


def trajectory_ops(kind, M, nt):
    """Operations of one trajectory of one chain: nt + 1 kicks (force, a
    multiply and a subtract per site), nt drifts, two kinetic and two
    potential energies, the accept test."""
    return (M * ((nt + 1) * (OPS_QM_FORCE[kind] + 2) + 2 * nt
                 + 2 * OPS_QM_DENSITY[kind] + 2 * 3) + 12)


def work_k5(C, M, nt, kind):
    """(bytes, operations) of one trajectory launch: x and p read, u read,
    x and the accept bits written."""
    return 4 * (3 * C * M + C) + C, C * trajectory_ops(kind, M, nt)


def work_k6(C, Mc, nt, n_steps, t_sub, with_traces):
    """(bytes, operations) of one two-level launch: per step t_sub
    trajectories with in-kernel momenta (a stream set-up, two words and a
    Box-Muller normal per site; the accept word) and, with traces, the
    clock sums; then the fill (W fixed point, curvature, a normal, the
    conditioned density), the fine and two coarse actions, the screen and
    the QoI sums."""
    per_traj = (trajectory_ops("quartic", Mc, nt)
                + Mc * (OPS_RNG_INIT + 2 * OPS_WORD + 6)
                + OPS_RNG_INIT + OPS_WORD + (3 * Mc + 4 if with_traces
                                             else 0))
    per_fill = (Mc * (2 + 4 * 6 + 5 + OPS_RNG_INIT + 2 * OPS_WORD + 6 + 3
                      + 8 + 20 + 2 * OPS_QM_DENSITY["quartic"] + 6)
                + OPS_RNG_INIT + OPS_WORD + 20)
    n_traj = n_steps * t_sub if with_traces else 1
    nbytes = 4 * (2 * C * (3 * Mc + 2) + 3 * n_steps * C + 2 * n_traj * C)
    return nbytes, C * n_steps * (t_sub * per_traj + per_fill)


def work_k9(C, Mx, Mt, n_overrelax=1, n_heatbath=1):
    """(bytes, operations) of a GFF sweep launch: the field read and
    written once; every site updated once a sweep: its neighbour sum (3
    adds) and index (4), then a reflection (3) or a heat-bath draw (a
    step-less stream's set-up, two words, a Box-Muller normal of 6 and
    the update's 3)."""
    n = C * Mx * Mt
    per_site = (n_overrelax * (7 + 3)
                + n_heatbath * (7 + OPS_RNG_INIT + 2 * OPS_WORD + 6 + 3))
    return 4 * 2 * n, n * per_site


def work_p1(C, Mx, Mt):
    """(bytes, operations) of a neighbour-sum launch: 3 adds and the
    index (4) per site."""
    return 4 * 2 * C * Mx * Mt, 7 * C * Mx * Mt


def launch_layout(launch, attrs):
    """A Schwinger or GFF sweep kernel's launch layout (its launch
    function's (lanes, chains a block, shared bytes, branch)) with its
    registers a thread and resident warps an SM (the occupancy API)."""
    return {"lanes_per_chain": launch[0], "chains_per_block": launch[1],
            "smem_bytes": launch[2], "branch": launch[3], **attrs}


def bound_ms_row(nbytes, nops):
    from mlmcpathintegral_tpu_torch.perf_probe import bound_ms
    t, by = bound_ms(nbytes, nops)
    # no single PyTorch call computes any of these functions
    return dict(bound_ms=t, bound_by=by, bytes=nbytes, operations=nops,
                library_ms=None)


#: the qm_driver phase's runs: (name, driver, parameter file, settings
#: changed in the run's copy of the file, kernel counters that must
#: launch, cuts of scale (listed in the phase's line)).  Every run sets
#: parallel.dtype = 'float32' (the kernels' type) and 4096 chains where the
#: file has no parallel section.
QM_RUNS = (
    ("1_harmonic_hierarchical_hmc", "qm",
     "baselines/configs/ref_qm_harmonic_hmc.in",
     {("singlelevelmc", "sampler"): "hierarchical",
      ("hmc", "use_pallas"): True}, ("hmc_trajectory",),
     {("singlelevelmc", "n_burnin"): 1000}),
    ("2_rotor_hierarchical_heatbath", "qm",
     "baselines/configs/ref_qm_rotor_cluster.in",
     {("singlelevelmc", "sampler"): "hierarchical",
      ("heatbath", "use_pallas"): True}, ("rotor_sweep_chain",),
     {("singlelevelmc", "n_burnin"): 256}),
    ("3_harmonic_multilevel_sampler", "qm",
     "baselines/configs/ref_qm_harmonic_hmc.in",
     {("singlelevelmc", "sampler"): "multilevel",
      ("hmc", "use_pallas"): True}, ("hmc_trajectory",),
     {("singlelevelmc", "n_burnin"): 256}),
    ("4_quartic_twolevel", "qm",
     "baselines/configs/ref_qm_quartic_twolevel.in",
     {("hmc", "use_pallas"): True}, ("hmc_trajectory",), {}),
    ("5_rotor_mlmc_cluster", "qm", "configs/qm_rotor_multilevel.in", {}, (),
     {}),
    ("6_schwinger_twolevel_heatbath", "qft",
     "baselines/configs/ref_qft_schwinger_mlmc.in",
     {("general", "method"): "twolevel",
      ("twolevelmc", "sampler"): "heatbath",
      ("heatbath", "use_pallas"): True}, ("schwinger_sweep_chain",), {}),
    ("7_sigma_singlelevel_heatbath", "qft",
     "baselines/configs/ref_qft_sigma_heatbath.in", {}, (),
     {("singlelevelmc", "n_burnin"): 2000}),
    ("8_sigma_twolevel", "qft", "baselines/configs/ref_qft_sigma_heatbath.in",
     {("general", "method"): "twolevel"}, (), {}),
    ("9_gff_twolevel_heatbath", "qft",
     "baselines/configs/ref_qft_gff_twolevel.in", {}, (),
     {("twolevelmc", "n_burnin"): 256}),
    ("10_gff_twolevel_exact", "qft",
     "baselines/configs/ref_qft_gff_twolevel.in",
     {("twolevelmc", "sampler"): "exact"}, (), {}),
    ("11_gff_multilevel", "qft", "baselines/configs/ref_qft_gff_twolevel.in",
     {("general", "method"): "multilevel"}, (), {}),
    ("12_schwinger_temporal_twolevel", "qft",
     "baselines/configs/ref_qft_schwinger_mlmc.in",
     {("lattice", "coarsening"): "temporal",
      ("general", "method"): "twolevel",
      ("twolevelmc", "sampler"): "heatbath",
      ("heatbath", "use_pallas"): True}, ("schwinger_sweep_chain",), {}),
    # the last reference file no port run had driven: single-level heat
    # bath, 8x8, beta = 4, 200 000 samples, as is (its burn-in cut: the
    # plain heat bath takes ~19 ms a draw on the card's host), and with
    # its heat bath on K3
    ("13_schwinger_singlelevel_heatbath", "qft",
     "baselines/configs/ref_qft_schwinger_heatbath.in", {}, (),
     {("singlelevelmc", "n_burnin"): 256}),
    ("13_schwinger_singlelevel_heatbath_K3", "qft",
     "baselines/configs/ref_qft_schwinger_heatbath.in",
     {("heatbath", "use_pallas"): True}, ("schwinger_sweep_chain",), {}),
)
#: runs held to a reference run's estimate and error (combined sigma) in
#: place of the analytic value: the double well has none (the C++ run's
#: <x^2>, PERF.md section 2); the hierarchical walk with the checkerboard
#: heat bath as its coarsest move is biased in the JAX package itself (the
#: half-sweeps' fixed order is not reversible), so run 2 is held to the
#: JAX package's estimate of the same file, its distance from chit_exact
#: reported beside it; the multilevel sampler's persistent, tau-spaced
#: coarse chains are not independent of the fine state, and bias its
#: estimate in the JAX package too, so run 3 is held to the JAX package's
#: estimate of its file.  Both from JAX on the CPU in f64, seed 0,
#: burn-in 256 (PERF.md section 6 has their JSON lines):
#:   JAX_PLATFORMS=cpu python scripts/jax_qm_reference.py \
#:       baselines/configs/ref_qm_rotor_cluster.in \
#:       --set "singlelevelmc.sampler='hierarchical'" \
#:       --chains 512 --samples 2048
#:   JAX_PLATFORMS=cpu python scripts/jax_qm_reference.py \
#:       baselines/configs/ref_qm_harmonic_hmc.in \
#:       --set "singlelevelmc.sampler='multilevel'" \
#:       --chains 1024 --samples 1024
#: The sigma model has no analytic value: run 7 is held to the JAX
#: package's single-level estimate of its file (CPU, f64, seed 0, 1024
#: chains x 2048 samples, burn-in 2000, tau_int 6.10, 530 s).  The two
#: multilevel-family runs whose files leave their screened chains far from
#: equilibrium (ROADMAP W6, W7) are held to the JAX package's estimate of
#: the same file and method at the run's 4096 chains (CPU, f64, seed 0):
#: run 8 (the sigma file two-level: acceptance 4%, burn-in 100 samples;
#: 869 s) and run 11 (the GFF file multilevel: tau_int of Y_1 40; 212 s):
#:   JAX_PLATFORMS=cpu python scripts/jax_qft_reference.py \
#:       baselines/configs/ref_qft_sigma_heatbath.in \
#:       --chains 1024 --samples 2048 --burnin 2000
#:   JAX_PLATFORMS=cpu python scripts/jax_qft_reference.py \
#:       baselines/configs/ref_qft_sigma_heatbath.in \
#:       --set "general.method='twolevel'" --chains 4096
#:   JAX_PLATFORMS=cpu python scripts/jax_qft_reference.py \
#:       baselines/configs/ref_qft_gff_twolevel.in \
#:       --set "general.method='multilevel'" --chains 4096
SIGMA_JAX = (73.82355312781698, 0.036206880036453615)
REFERENCES = {"4_quartic_twolevel": (0.599879, 0.001528),
              "2_rotor_hierarchical_heatbath": (0.12326669692993164,
                                                0.0003980669737580518),
              "3_harmonic_multilevel_sampler": (0.5164759683691835,
                                                0.0004083067131027976),
              "7_sigma_singlelevel_heatbath": SIGMA_JAX,
              "8_sigma_twolevel": (78.30223210705434, 0.3367599057038013),
              "11_gff_multilevel": (0.32914387327060385,
                                    0.0005907441427202397)}
#: values reported beside a run's gate, not gating it (estimate, error):
#: the C++ run of the sigma file (baselines/ref_baselines.json), the JAX
#: package's estimate on its original accelerator (BENCH_detail.json
#: sigma_heatbath) and, for run 8, its single-level estimate on the CPU;
#: the C++ run's fine <phi^2> of the GFF file, which takes another mass
#: convention than phi_squared_analytical
SIGMA_BESIDE = {"cpp": (73.554551, 0.127645), "jax_bench": (73.8292, 0.0355)}
GFF_BESIDE = {"cpp_fine_other_mass_convention": (0.302185, 0.00013)}
BESIDE = {"7_sigma_singlelevel_heatbath": SIGMA_BESIDE,
          "8_sigma_twolevel": {"jax_singlelevel": SIGMA_JAX,
                               **SIGMA_BESIDE},
          "9_gff_twolevel_heatbath": GFF_BESIDE,
          "10_gff_twolevel_exact": GFF_BESIDE, "11_gff_multilevel": GFF_BESIDE}


class ProfiledPhase:
    """The drivers' ``sampling_scope``: the phase that records a run's
    samples under the profiler (device activity), the card synchronised at
    both ends.  Afterwards ``host_ms`` holds the phase's wall (the
    profiler's start and stop outside it, its tracing inside),
    ``device_busy_ms`` the union of the phase's device intervals,
    ``events`` their number and ``profile_s`` the seconds taken to read
    them."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        from mlmcpathintegral_tpu_torch.perf_probe import union_ms
        torch.cuda.synchronize()
        self.host_ms = (time.monotonic() - self.t0) * 1e3
        self.prof.stop()
        t0 = time.monotonic()
        ivals = [(e.start_ns() / 1e3, e.end_ns() / 1e3)
                 for e in self.prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA]
        self.events, self.device_busy_ms = len(ivals), union_ms(ivals)
        self.profile_s = time.monotonic() - t0
        del self.prof
        return False


def qm_run_config(root, run):
    """The run's copy of its parameter file with its settings and cuts."""
    from mlmcpathintegral_tpu_torch.utils.config import read_parameter_file
    _, _, path, settings, _, cuts = run
    cfg = read_parameter_file(root / path)
    par = cfg.setdefault("parallel", {"n_chains": 4096})
    par["dtype"] = "float32"
    for (sec, key), value in {**settings, **cuts}.items():
        cfg.setdefault(sec, {})[key] = value
    return cfg


def path_f_coarsest(root, name):
    """(coarsest action, run's config) of run ``name`` of QM_RUNS: the
    file's action, built by the QM driver's own reader, coarsened to the
    last level of its ``hierarchical`` section, where the run's sampler
    launches its kernel."""
    from mlmcpathintegral_tpu_torch.drivers.qm import build_action
    from mlmcpathintegral_tpu_torch.lattice import Lattice1D
    cfg = qm_run_config(root, next(r for r in QM_RUNS if r[0] == name))
    action = build_action(cfg, Lattice1D(cfg["lattice"]["M_lat"],
                                         cfg["lattice"]["T_final"]))
    for _ in range(cfg["hierarchical"]["n_max_level"] - 1):
        action = action.coarse_action()
    return action, cfg


def run12_launch(root, dev, links):
    """K3 against its plain version at run 12's launch: the coarse action
    of run 12's file (built by the QFT driver's own reader), one draw of
    the run's heat-bath sweeps on its chains.  Returns the check's fields
    (share of chains within 1e-4 mod 2 pi, largest difference, device ms,
    plain ms, bound, layout)."""
    from mlmcpathintegral_tpu_torch.drivers import qft as qft_driver
    from mlmcpathintegral_tpu_torch.ops import _cuda, schwinger
    from mlmcpathintegral_tpu_torch.perf_probe import (
        cuda_ms, kernel_device_ms,
    )
    cfg = qm_run_config(root, next(r for r in QM_RUNS
                                   if r[0].startswith("12_")))
    act = qft_driver.build_action(
        cfg, qft_driver._method_and_lattice(cfg)[1]).coarse_action()
    lat, hb, C = act.lattice, cfg["heatbath"], cfg["parallel"]["n_chains"]
    kw = dict(beta=act.beta, Mt=lat.Mt_lat, Mx=lat.Mx_lat,
              n_overrelax=hb["n_sweep_overrelax"],
              n_heatbath=hb["n_sweep_heatbath"])
    x = links(C, act.ndof)
    for i in range(20):
        x = schwinger.schwinger_sweep(x, (11, i), **kw)
    k = schwinger.schwinger_sweep(x, (12, 13), **kw)
    p, rounds, plain_ms = tallied(
        lambda: schwinger.schwinger_sweep_chain_plain(x, (12, 13),
                                                      n_steps=1, **kw)[0])
    launch = lambda: schwinger.schwinger_sweep(x, (12, 13), **kw)  # noqa
    ms, _ = kernel_device_ms(launch, 50, "schwinger_sweep")
    ms_from = "profiler"
    if ms is None:
        ms, ms_from = cuda_ms(launch, 50), "CUDA events"
    err = torch.remainder(k.double() - p.double() + math.pi,
                          2 * math.pi) - math.pi
    # a single draw writes no Q or E trace
    nbytes, nops = work_k3(C, lat.Mx_lat, lat.Mt_lat, 1, rounds["expcos"])
    nbytes -= 4 * 2 * C
    return {"shape": f"Mx={lat.Mx_lat} x Mt={lat.Mt_lat}, beta_c="
                     f"{act.beta}, {C} chains, {kw['n_overrelax']} + "
                     f"{kw['n_heatbath']} sweeps, n_steps=1",
            "share_within_1e-4": angle_share(k, p, TOL),
            "max_abs_err": float(err.abs().max()), "sha256": sha256_of([k]),
            "ms": ms, "ms_from": ms_from, "plain_ms": plain_ms,
            "rejection_rounds": rounds,
            "bound": bound_ms_row(nbytes, nops),
            "layout": launch_layout(schwinger.sweep_launch(
                lat.Mt_lat, lat.Mx_lat, C, _cuda.max_smem_optin(0)),
                schwinger.sweep_attrs(lat.Mt_lat, lat.Mx_lat, C))}


def qm_driver_phase(dev, root, runs=QM_RUNS):
    """Drive drivers.qm.run and drivers.qft.run on the card for each of
    ``runs`` (QM_RUNS), the launch counters set to 0 just before each, the
    phase that records its samples under the profiler (ProfiledPhase);
    gate each estimate at 4 sigma from its oracle, and after run 7 the
    cluster chain's (sigma_cluster_check).  Returns (rows, launches by
    kernel summed over the runs, ok)."""
    import io
    import warnings

    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch.drivers import qft as qft_driver
    from mlmcpathintegral_tpu_torch.drivers import qm as qm_driver
    drivers = {"qm": qm_driver, "qft": qft_driver}

    def drive(run, cfg, scope=None):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), warnings.catch_warnings():
            # the files' heatbath.random_order, which a coloured sweep
            # ignores
            warnings.simplefilter("ignore", UserWarning)
            t0 = time.monotonic()
            res = drivers[run[1]].run(cfg, device=dev, seed=0,
                                      sampling_scope=scope)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        return res, time.monotonic() - t0, out.getvalue().splitlines()

    # a float64 file with use_pallas on the card fails with the kernels'
    # type error: nothing casts it or runs the plain version instead
    cfg = qm_run_config(root, QM_RUNS[0])
    cfg["parallel"]["dtype"] = "float64"
    ops.reset_counters()
    try:
        drive(QM_RUNS[0], cfg)
        f64_error = None
    except TypeError as e:
        f64_error = str(e)
    rows = {"float64_use_pallas": {
        "error": f64_error, "launches": sum(c.launches
                                            for c in ops.counters()),
        "plain_calls_on_cuda": sum(c.plain_cuda_calls
                                   for c in ops.counters())}}
    emit({"phase": "qm_driver", "run": "float64_use_pallas",
          **rows["float64_use_pallas"]})
    ok = (f64_error is not None and "float32" in f64_error
          and not rows["float64_use_pallas"]["launches"]
          and not rows["float64_use_pallas"]["plain_calls_on_cuda"])
    totals = {}
    for run in runs:
        name, _, path, settings, kernels, cuts = run
        cfg = qm_run_config(root, run)
        phase = ProfiledPhase()
        ops.reset_counters()
        res, wall_s, lines = drive(run, cfg, phase)
        launches = {c.name: c.launches for c in ops.counters()}
        plain = {c.name: c.plain_cuda_calls for c in ops.counters()}
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        oracle, oracle_err = REFERENCES.get(name, (res["analytical"], 0.0))
        sigma = abs(res["numerical"] - oracle) / math.hypot(res["error"],
                                                            oracle_err)
        # the draws a chain made in the phase that records the samples
        # (MLMC: the samples a chain recorded on all levels, in its cost
        # measurement and adaptive loop)
        n_chains = res["n_chains"]
        draws = (sum(res["level_samples"]) / n_chains
                 if res["method"] == "multilevel" else res["sampling_draws"])
        row = {"driver": run[1], "file": path,
               "settings": {f"{a}.{b}": v for (a, b), v in
                            settings.items()},
               "cuts": {f"{a}.{b}": v for (a, b), v in cuts.items()},
               "n_chains": n_chains, "dtype": "float32",
               "method": res["method"], "action": res["action"],
               "estimate": res["numerical"], "error": res["error"],
               "sigma": math.sqrt(res["variance"])
               if "variance" in res else None,
               "tau_int": res.get("tau_int", res.get("level_tau_int")),
               "oracle": oracle, "oracle_error": oracle_err,
               "sigma_dev": sigma, "analytical": res["analytical"],
               "sigma_dev_analytical": res["sigma_dev"],
               "level_acceptance": res.get("level_acceptance"),
               "level_t_indep": res.get("level_t_indep"),
               "p_accept": res.get("p_accept"),
               "t_indep": res.get("t_indep"),
               "launches": {k: v for k, v in launches.items() if v},
               "plain_calls_on_cuda": plain,
               "wall_s": wall_s, "timings": res["timings"],
               "draws_per_chain": draws,
               "sampling_phase": {
                   "host_ms": phase.host_ms,
                   "device_busy_ms": phase.device_busy_ms,
                   "busy_share": phase.device_busy_ms / phase.host_ms,
                   "device_events": phase.events,
                   "profile_s": phase.profile_s},
               "host_ms_per_draw": phase.host_ms / max(draws, 1),
               "device_ms_per_draw": phase.device_busy_ms / max(draws, 1),
               "beside": {
                   k: {"value": v, "error": e,
                       "sigma_dev": (res["numerical"] - v)
                       / math.hypot(res["error"], e)}
                   for k, (v, e) in BESIDE.get(name, {}).items()},
               "report_tail": lines[-2:]}
        rows[name] = row
        missing = [k for k in kernels if launches.get(k, 0) == 0]
        bad = (not math.isfinite(res["numerical"]) or sigma > 4.0
               or missing or any(plain.values()))
        emit({"phase": "qm_driver", "run": name, **row})
        if bad:
            print(f"chip_smoke: qm_driver run {name}: {sigma:.2f} sigma, "
                  f"kernels not launched {missing}, plain calls on CUDA "
                  f"{plain}", file=sys.stderr, flush=True)
            ok = False
        if name == "7_sigma_singlelevel_heatbath":
            ok &= sigma_cluster_check(dev, root, run, row)
    return rows, totals, ok


def sigma_cluster_check(dev, root, run, row, n_burnin=30, n_keep=64):
    """A short chain of the 2-D Wolff cluster sampler (a library sampler:
    no driver selects it) at run 7's lattice, beta and chains, its
    clusteralgorithm section's updates a draw, ``n_burnin`` draws of
    burn-in and ``n_keep`` recorded: its chi_m within 4 sigma (combined)
    of run 7's.  Emits its line; returns whether it held."""
    from mlmcpathintegral_tpu_torch.drivers import qft as qft_driver
    from mlmcpathintegral_tpu_torch.samplers import Cluster2DSampler
    from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
    from mlmcpathintegral_tpu_torch.utils.statistics import Statistics
    cfg = qm_run_config(root, run)
    action = qft_driver.build_action(
        cfg, qft_driver._method_and_lattice(cfg)[1])
    sampler = Cluster2DSampler(action, n_burnin=n_burnin,
                               n_updates=cfg["clusteralgorithm"]["n_updates"])
    C = cfg["parallel"]["n_chains"]
    qoi = qft_driver.select_qoi(action)[0](action)
    gen = torch.Generator(device=dev).manual_seed(7)
    t0 = time.monotonic()
    st = sampler.prepare(gen, C, torch.float32, dev)
    qs = []
    for _ in range(n_keep):
        st, _ = sampler.draw(gen, st)
        qs.append(qoi(st.x))
    stats = Statistics("chi_m[cluster2d]", 20)
    s = stats_mod.record_block(stats.init(C, torch.float32, dev),
                               torch.stack(qs))
    avg, err = stats.average(s), stats.error(s)
    torch.cuda.synchronize()
    dev_sigma = abs(avg - row["estimate"]) / math.hypot(err, row["error"])
    out = {"lattice": str(action.lattice), "beta": action.beta,
           "n_chains": C, "n_burnin": sampler.n_burnin,
           "n_updates": sampler.n_updates, "draws_recorded": n_keep,
           "estimate": avg, "error": err, "tau_int": stats.tau_int(s),
           "run_7": [row["estimate"], row["error"]],
           "sigma_dev_from_run_7": dev_sigma,
           "wall_s": time.monotonic() - t0}
    emit({"phase": "qm_driver", "run": "7b_sigma_cluster2d", **out})
    if not math.isfinite(avg) or dev_sigma > 4.0:
        print(f"chip_smoke: the cluster chain's chi_m is {dev_sigma:.2f} "
              f"sigma from run 7's", file=sys.stderr, flush=True)
        return False
    return True


#: the sha256 of the launches phases 3, 4, 6 and 10 print, as this script
#: printed them on one H100 before chain offsets were added: every
#: kernel's bits at chain0 = 0 must not have moved
BASELINE_SHA256 = {
    "sweep.main_launch": "aa94db7ffd1fbefa",
    "sweep.run_12": "3dbf5e5c6bcffbd0",
    "twolevel.main_launch": "c0da854de3c0bdb9",
    "rotor_sweep.single_sweep": "94c6d21abd7a4707",
    "rotor_sweep.main_launch": "fd357dc6b9daf8b6",
    "rotor_sweep.path_F2": "ed8822101804fa93",
    "hmc.path_D:harmonic": "c7fa046d5403d1a7",
    "hmc.path_D:quartic": "97ffede54a7adedf",
    "hmc.path_D:rotor": "42323e612c5ee715",
    "hmc.path_C_coarse:quartic": "55de5b4fd8351106",
    "hmc.path_F_coarsest:harmonic": "cea157ed14cb7971",
}
#: phase 5's chi in that same run, reported beside this run's (the statistics
#: now sum each chain's samples as a contiguous row, which may move the
#: last bits of an estimate; not gated)
BASELINE_MAIN_CHI = 0.4796905517578125


def chain_axis(t, n):
    """The one axis of t whose size is the launch's chain count n."""
    axes = [d for d, s in enumerate(t.shape) if s == n]
    if len(axes) != 1:
        raise ValueError(f"no unique chain axis of size {n} in {t.shape}")
    return axes[0]


def chain0_halves(run, C):
    """A kernel launch over all C chains against two launches of its halves,
    the second with chain0 = C/2: ``run(lo, hi, chain0)`` launches the
    kernel on chains [lo, hi) of its inputs.  Returns (every output equal
    bit for bit, the whole launch's outputs, the second half's)."""
    def outs(lo, hi, c0):
        o = run(lo, hi, c0)
        return (o,) if isinstance(o, torch.Tensor) else tuple(o)

    whole, lo, hi = outs(0, C, 0), outs(0, C // 2, 0), \
        outs(C // 2, C, C // 2)
    torch.cuda.synchronize()
    equal = True
    for w, a, b in zip(whole, lo, hi):
        if w is None:
            continue
        equal &= torch.equal(w, torch.cat([a, b], dim=chain_axis(w, C)))
    return equal, whole, hi


#: phase 17's rows of the block branches (their kernels' counters hold
#: both branches)
BLOCK_K3 = "schwinger_sweep_chain (block)"
BLOCK_K4 = "schwinger_twolevel_chain (block)"


def block_chain0_halves(dev, links):
    """Phase 17 on the block branches: K3 at 16x16 (2048 chains, 4 draws,
    the 64x64 row's coarsest beta) and K4 at 32x32 (1024 chains, 16 steps
    at t_sub 2, the row's beta), each launch against its two halves (the
    second with chain0 = C/2; a half takes a larger team than the whole)
    bit for bit, and the plain version with chain0 = C/2 on the second
    half's first 64 chains under phase 21's gates.  Returns the two
    rows."""
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        QuenchedSchwingerConditionedFineAction,
    )
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral_tpu_torch.ops import _cuda, schwinger
    from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as tl
    rows = []
    C, h = 2048, 1024
    th = links(C, 2 * 16 * 16)
    kw = dict(beta=scale_betas(64)[2], Mt=16, Mx=16, n_steps=4,
              with_energy=True)
    eq, _, k = chain0_halves(lambda lo, hi, c0: schwinger.
                             schwinger_sweep_chain(th[lo:hi], (16, 4),
                                                   chain0=c0, **kw), C)
    p = schwinger.schwinger_sweep_chain_plain(th[h:h + 64], (16, 4),
                                              chain0=h, **kw)
    share = angle_share(k[0][:64], p[0], TOL)
    rows.append(dict(
        halves_equal=eq, plain_chain0={"heatbath_share_within_1e-4": share},
        ok=eq and share >= SHARE_MIN,
        launch=f"16x16, beta_c={kw['beta']}, {C} chains, n_steps=4",
        layouts=[schwinger.sweep_launch(16, 16, c, _cuda.max_smem_optin(0))
                 for c in (C, h)]))
    C, h, M = 1024, 512, 32
    beta, beta_c, _ = scale_betas(M)
    act = QuenchedSchwingerAction(Lattice2D(M, M, CoarseningType.BOTH),
                                  beta=beta)
    fine, coarse = links(C, 2 * M * M), links(C, M * M // 2)
    args = (fine, coarse, act.evaluate(fine),
            QuenchedSchwingerConditionedFineAction(act).evaluate(fine))
    kw = dict(beta=beta, beta_c=beta_c, Mt=M, Mx=M, n_steps=16, t_sub=2)
    eq, _, k = chain0_halves(lambda lo, hi, c0: tl.schwinger_twolevel_chain(
        *(a[lo:hi].contiguous() for a in args), (M, 21), chain0=c0, **kw), C)
    k = [t[:64] if i < 4 else t[:, :64] for i, t in enumerate(k)]
    p = tl.schwinger_twolevel_chain_plain(*(a[h:h + 64] for a in args),
                                          (M, 21), chain0=h, **kw)
    dqc = rel_diff(k[5], p[5]).reshape(16, 2, -1).amax(dim=1)
    dec = rel_diff(k[6], p[6]).reshape(16, 2, -1).amax(dim=1)
    rep, ok = departures((rel_diff(k[4], p[4]) <= TOL * M / 8)
                         & (k[7] == p[7]) & (dqc <= TOL) & (dec <= TOL),
                         (k[4] - p[4]).abs().double())
    rows.append(dict(halves_equal=eq, plain_chain0=rep, ok=eq and ok,
                     launch=f"{M}x{M}, beta={beta}, beta_c={beta_c}, {C} "
                            f"chains, n_steps=16, t_sub=2",
                     layouts=[tl.twolevel_launch(M, M, c) for c in (C, h)]))
    return rows


def two_rank_rank(rank, world, store, out_dir, n_chains, seed):
    """One rank of the main path on two gloo ranks of the one card: the
    phase-5 run (``perf_probe.headline_mlmc``, ``n_chains`` chains split
    over the ranks, ``mesh=``); writes its numbers, launches and the cost of
    the collectives behind one adaptive decision to out_dir/rank<r>.json."""
    import torch.distributed as dist

    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch.parallel import (
        gather_chains, global_chain_mesh, initialize_multihost,
    )
    from mlmcpathintegral_tpu_torch.parallel.chains import all_reduce_scalar
    from mlmcpathintegral_tpu_torch.perf_probe import headline_mlmc
    dev = torch.device("cuda", 0)
    # NCCL takes one rank a card: two ranks on the one card run on gloo
    initialize_multihost(f"file://{store}", world, rank, device=dev,
                         backend="gloo")
    try:
        mesh = global_chain_mesh()
        mc = headline_mlmc()
        ops.reset_counters()
        stats = mc.evaluate(torch.Generator().manual_seed(seed),
                            n_chains=n_chains, dtype=torch.float32,
                            device=dev, mesh=mesh)
        torch.cuda.synchronize()
        L = mc.n_level
        res = {"rank": rank, "chit": mc.numerical_result(),
               "err": mc.statistical_error(),
               "tau_int_Y0": mc.stats_qoi[0].tau_int(stats[0]),
               "t_sub": list(mc._t_sub),
               "level_samples": [mc.stats_qoi[ell].samples(stats[ell])
                                 for ell in range(L)],
               "elapsed_s": mc.elapsed_s, "timings_s": mc.timings,
               "cost_per_sample_us": mc.cost_per_sample,
               "launches": {c.name: c.launches for c in ops.counters()},
               "plain_calls_on_cuda": {c.name: c.plain_cuda_calls
                                       for c in ops.counters()}}
        # an adaptive decision reads each level's gathered Y statistics
        # (one gather of the rank's [C/2] and [C/2, k_max] accumulators)
        # and agrees on a time (one scalar all-reduce)
        st = mc.final_carries[0][0][2]
        reps = 20
        dist.barrier()
        t0 = time.monotonic()
        for _ in range(reps):
            gathered = gather_chains(mesh, st)
        torch.cuda.synchronize()
        res["gather_ms"] = (time.monotonic() - t0) * 1e3 / reps
        res["gathered_bytes"] = sum(x.numel() * x.element_size()
                                    for x in gathered if x.dim())
        dist.barrier()
        t0 = time.monotonic()
        for _ in range(reps):
            all_reduce_scalar(mesh, 1.0, "max", operand_on=dev)
        res["all_reduce_ms"] = (time.monotonic() - t0) * 1e3 / reps
        with open(Path(out_dir) / f"rank{rank}.json", "w") as fh:
            json.dump(res, fh)
    finally:
        dist.destroy_process_group()


def two_rank_main_path(root, n_chains, seed, timeout_s=600.0):
    """The main path on two gloo ranks of the card (``two_rank_rank``),
    spawned and joined; returns (each rank's numbers, wall seconds)."""
    import tempfile

    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        t0 = time.monotonic()
        ctx = mp.start_processes(
            two_rank_rank, args=(2, f"{tmp}/store", tmp, n_chains, seed),
            nprocs=2, join=False, start_method="spawn")
        deadline = t0 + timeout_s
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                fail(f"the two-rank main path did not finish within "
                     f"{timeout_s} s")
        wall = time.monotonic() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(2)]
    return ranks, wall


#: phase 21: K4's block branch at the scale study's 32x32 and 64x64 fine
#: launches and K3's at its 16x16 and 32x32 coarsest ones (chains, steps
#: and t_sub of the check); the cut scale-study rows run through the port's
#: tool (size, samples a level); the sequential screen's chains and samples
SCALE_K4 = ((32, 256, 16, 4), (64, 256, 16, 4))
SCALE_K3 = ((16, 64), (32, 128))
SCALE_RUNS = ((16, 524_288), (32, 262_144))
SEQ_CHAINS, SEQ_SAMPLES = 1024, 65_536


def scale_betas(M):
    """(beta, beta_c of level 1, beta of the coarsest level) of the scale
    study's M x M row: beta = 4 (M/16)^2, three levels, nonperturbative
    matching."""
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral_tpu_torch.tools.schwinger_scale_study import (
        scale_beta,
    )
    act = QuenchedSchwingerAction(
        Lattice2D(M, M, CoarseningType.BOTH), beta=scale_beta(M),
        renormalisation=RenormalisationType.NONPERTURBATIVE)
    c1 = act.coarse_action()
    return act.beta, c1.beta, c1.coarse_action().beta


def k4_block_check(dev, M, C, n_steps, t_sub):
    """K4 against its plain version at the scale study's M x M fine launch
    (beta = 4 (M/16)^2 and its nonperturbative beta_c; the block branch):
    C chains from a heat-bath coarse field filled by the conditioned
    action, n_steps steps at t_sub; phase 4's departures gates on the
    per-step y, accept, qc and ec, and >= SHARE_MIN of the chains on y,
    accept, S_fine, S_cond and the fine field at the end, each within TOL
    but y within TOL M/8 (the f32 rounding of its charge sum over M^2
    plaquettes against phase 4's 64).  Returns (the check's fields,
    ok)."""
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        QuenchedSchwingerConditionedFineAction,
    )
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as tl
    from mlmcpathintegral_tpu_torch.perf_probe import cuda_ms
    from mlmcpathintegral_tpu_torch.samplers import (
        OverrelaxedHeatBathSampler,
    )
    beta, beta_c, _ = scale_betas(M)
    gen = torch.Generator(device=dev).manual_seed(M)
    act = QuenchedSchwingerAction(Lattice2D(M, M, CoarseningType.BOTH),
                                  beta=beta)
    cact = QuenchedSchwingerAction(
        Lattice2D(M // 2, M // 2, CoarseningType.BOTH), beta=beta_c)
    xc = OverrelaxedHeatBathSampler(cact, n_burnin=50, use_pallas=True) \
        .prepare(torch.Generator().manual_seed(M), C, torch.float32, dev).x
    cond = QuenchedSchwingerConditionedFineAction(act)
    xf = cond.fill_fine_points(gen, act.prolongate(
        xc, act.initialise_state(gen, C, torch.float32, dev)))
    args = (xf, xc, act.evaluate(xf), cond.evaluate(xf))
    kw = dict(beta=beta, beta_c=beta_c, Mt=M, Mx=M, n_steps=n_steps,
              t_sub=t_sub)
    k = tl.schwinger_twolevel_chain(*args, (M, 21), **kw)
    p, rounds, plain_ms = tallied(
        lambda: tl.schwinger_twolevel_chain_plain(*args, (M, 21), **kw))
    torch.cuda.synchronize()
    # y = (Q_f^2 - Q_c^2) / 4 pi^2 with Q_f an f32 sum over M^2
    # plaquettes: its rounding grows as the square root of their number,
    # so y is held to phase 4's TOL at its 8x8 field scaled by M/8
    tol_y = TOL * M / 8
    dqc = rel_diff(k[5], p[5]).reshape(n_steps, t_sub, -1).amax(dim=1)
    dec = rel_diff(k[6], p[6]).reshape(n_steps, t_sub, -1).amax(dim=1)
    agree = (rel_diff(k[4], p[4]) <= tol_y) & (k[7] == p[7]) \
        & (dqc <= TOL) & (dec <= TOL)
    rep, ok = departures(agree, (k[4] - p[4]).abs().double())
    shares = {nm: trace_share(k[i], p[i], tol)
              for nm, i, tol in (("y", 4, tol_y), ("acc", 7, TOL),
                                 ("S_fine", 2, TOL), ("S_cond", 3, TOL))}
    same_acc = (k[7] == p[7]).all(dim=0)
    rep["y_max_abs_err_same_accepts"] = float(
        (k[4] - p[4]).abs()[:, same_acc].max()) if same_acc.any() else None
    shares["theta_fine"] = angle_share(k[0], p[0], TOL)
    ms = cuda_ms(lambda: tl.schwinger_twolevel_chain(*args, (M, 21), **kw),
                 3)
    bound = bound_ms_row(*work_k4(C, M, M, n_steps, t_sub,
                                  rounds["expcos"],
                                  rounds.get("bessel", 0.0)))
    res = {"shape": f"{M}x{M}, beta={beta}, beta_c={beta_c}, {C} chains, "
                    f"n_steps={n_steps}, t_sub={t_sub}",
           "departures": rep, "tol_y": tol_y, "share_within_tol": shares,
           "accept_rate": float(k[7].mean()),
           "accept_rate_plain": float(p[7].mean()),
           "sha256": sha256_of(k), "ms": ms, "plain_ms": plain_ms,
           "rejection_rounds": rounds, **bound,
           "layout": launch_layout(tl.twolevel_launch(M, M, C),
                                   tl.twolevel_attrs(M, M, C))}
    return res, ok and min(shares.values()) >= SHARE_MIN


def k3_block_check(dev, M, C, links):
    """K3 against its plain version at M x M, the coarsest launch of the
    scale study's 4M x 4M row (its coarsest beta; the block branch):
    overrelax-only within 1e-5 after 4 draws, and after 4 heat-bath draws
    >= SHARE_MIN of the chains within 1e-4 (mod 2 pi); the launch timed
    beside its bound.  Returns (the check's fields, ok)."""
    from mlmcpathintegral_tpu_torch.ops import _cuda, schwinger
    from mlmcpathintegral_tpu_torch.perf_probe import cuda_ms
    beta = scale_betas(4 * M)[2]
    th = links(C, 2 * M * M)
    kw = dict(beta=beta, Mt=M, Mx=M, n_steps=4, with_energy=True)
    k = schwinger.schwinger_sweep_chain(th, (M, 3), n_heatbath=0, **kw)
    p = schwinger.schwinger_sweep_chain_plain(th, (M, 3), n_heatbath=0,
                                              **kw)
    or_err = float((k[0] - p[0]).abs().max())
    k = schwinger.schwinger_sweep_chain(th, (M, 4), **kw)
    p, rounds, plain_ms = tallied(
        lambda: schwinger.schwinger_sweep_chain_plain(th, (M, 4), **kw))
    share = angle_share(k[0], p[0], TOL)
    ms = cuda_ms(lambda: schwinger.schwinger_sweep_chain(th, (M, 4), **kw),
                 5)
    res = {"shape": f"{M}x{M}, beta_c={beta}, {C} chains, n_steps=4",
           "overrelax_max_abs_err": or_err,
           "heatbath_share_within_1e-4": share, "sha256": sha256_of(k),
           "ms": ms, "plain_ms": plain_ms, "rejection_rounds": rounds,
           **bound_ms_row(*work_k3(C, M, M, 4, rounds["expcos"])),
           "layout": launch_layout(schwinger.sweep_launch(
               M, M, C, _cuda.max_smem_optin(0)),
               schwinger.sweep_attrs(M, M, C))}
    return res, or_err <= 1e-5 and share >= SHARE_MIN


#: phase 22: K2 at the hybrid draw's mixing launches on the cluster rows'
#: level-0 coarse lattices (coarse M of the row 2M, chains), the 16x16
#: cluster row (samples a level: the study's 1M, ~35 s on the card) and
#: path A's profiled samples
HYBRID_K2 = ((32, 256), (64, 256))
HYBRID_ROW = (16, 1_000_000)
HYBRID_PROFILE_SAMPLES = 16


def work_k2(C, Mx, Mt, r):
    """(bytes, operations) of one sweep launch without traces: the hybrid
    draw's mixing sweep."""
    n_links = 2 * Mx * Mt
    return 4 * 2 * C * n_links, C * sweep_ops(n_links, 0, r)


def k2_hybrid_check(dev, M, C):
    """K2 (``schwinger_sweep``, one launch a mixing sweep) against its
    plain version at the hybrid draw's launch on M x M, the level-0 coarse
    lattice of the scale study's 2M x 2M cluster row (its nonperturbative
    beta_c), C chains, on links rebuilt by the hybrid sampler
    (``_reconstruct`` of its cluster chain's paths): overrelax-only within
    1e-5 and, after 4 launches at step offsets 0-3, >= SHARE_MIN of the
    chains within 1e-4 (mod 2 pi), as phase 3; one launch timed with CUDA
    events beside its bound.  Returns (the check's fields, ok)."""
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral_tpu_torch.ops import _cuda, schwinger
    from mlmcpathintegral_tpu_torch.perf_probe import cuda_ms
    from mlmcpathintegral_tpu_torch.samplers import (
        QuenchedSchwingerClusterSampler,
    )
    beta = scale_betas(2 * M)[1]
    act = QuenchedSchwingerAction(Lattice2D(M, M, CoarseningType.BOTH),
                                  beta=beta)
    sampler = QuenchedSchwingerClusterSampler(act, n_burnin=20,
                                              use_pallas=True)
    gen = torch.Generator(device=dev).manual_seed(M)
    th = sampler.prepare(gen, C, torch.float32, dev).x
    kw = dict(beta=beta, Mt=M, Mx=M)
    k = schwinger.schwinger_sweep(th, (M, 5), n_heatbath=0, **kw)
    p = schwinger.schwinger_sweep_chain_plain(th, (M, 5), n_steps=1,
                                              n_heatbath=0, **kw)[0]
    or_err = float((k - p).abs().max())

    def four(sweep):
        x = th
        for i in range(4):
            x = sweep(x, (M, 6), step_offset=i, **kw)
        return x

    k = four(schwinger.schwinger_sweep)
    p, rounds, plain_ms = tallied(lambda: four(
        lambda x, seed, **a: schwinger.schwinger_sweep_chain_plain(
            x, seed, n_steps=1, **a)[0]))
    share = angle_share(k, p, TOL)
    ms = cuda_ms(lambda: schwinger.schwinger_sweep(th, (M, 6), **kw), 10)
    res = {"shape": f"{M}x{M}, beta_c={beta}, {C} chains, one sweep",
           "overrelax_max_abs_err": or_err,
           "heatbath_share_within_1e-4_after_4": share,
           "sha256": sha256_of([k]), "ms": ms, "plain_ms": plain_ms / 4,
           "rejection_rounds": rounds,
           **bound_ms_row(*work_k2(C, M, M, rounds["expcos"])),
           "layout": launch_layout(schwinger.sweep_launch(
               M, M, C, _cuda.max_smem_optin(0)),
               schwinger.sweep_attrs(M, M, C))}
    return res, or_err <= 1e-5 and share >= SHARE_MIN


def hybrid_phase(dev, root):
    """Phase 22: K2 against its plain version at the hybrid draw's mixing
    launches (``k2_hybrid_check``); the 16x16 row of the scale study with
    hybrid cluster coarse chains through the tool's ``run_mlmc`` (1024
    chains, ``HYBRID_ROW`` samples a level; launch counters reset just
    before and read just after): within 4 sigma of chit_exact, no flagged
    level, K7 and K2 launched, no plain version on CUDA; then path A's
    level-0 coarse samples and screen profiled
    (``scripts/unfused_profile.py``): host and device ms a draw, the idle
    share, host reads a sample.  Returns (the phase's line, its failures,
    the K2 checks, the row's launches)."""
    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch.ops import rotor
    from mlmcpathintegral_tpu_torch.tools.schwinger_scale_study import (
        run_mlmc, scale_beta,
    )
    failures = []
    k2 = {}
    for M, C in HYBRID_K2:
        k2[f"{M}x{M}"], ok = k2_hybrid_check(dev, M, C)
        if not ok:
            failures.append(f"K2 at the hybrid draw's {M}x{M} launch")
    torch.cuda.empty_cache()
    M, n = HYBRID_ROW
    ops.reset_counters()
    row = run_mlmc(M, M, beta=scale_beta(M), n_level=3, n_samples=n,
                   n_chains=1024, coarse="cluster", device=dev)
    torch.cuda.synchronize()
    launches = {c.name: c.launches for c in ops.counters()}
    plain = {c.name: c.plain_cuda_calls for c in ops.counters()}
    row.update(launches=launches, plain_calls_on_cuda=plain,
               cut="none" if n == 1_000_000
               else f"n_samples 1 000 000 -> {n} a level")
    if abs(row["chit"] - row["oracle"]) > 4.0 * row["err"]:
        failures.append(f"cluster row {M}x{M} beyond 4 sigma")
    if row["unreliable_levels"] != "none":
        failures.append(f"cluster row {M}x{M} flagged a level")
    if launches[ops.SWEEP.name] == 0 or launches[rotor.CLUSTER.name] == 0 \
            or any(plain.values()):
        failures.append(f"cluster row {M}x{M} missed K2 or K7 or ran a "
                        f"plain version on CUDA")
    sys.path.insert(0, str(root / "scripts"))
    import unfused_profile
    prof = unfused_profile.profile_level0("path_A", dev,
                                          HYBRID_PROFILE_SAMPLES, 64)
    out = {"phase": "hybrid", "k2_mix": k2,
           f"cluster_row_{M}x{M}": row, "path_A_profile": prof}
    return out, failures, k2, launches


#: phase 23: the statistics records a round of the benchmark cells make
#: (name, chains, k_max, T, n_valid): the 8x8 cells' Y at T 256 and their
#: coarse Q^2 and energy traces at T 2048 (k_max 100, 8192 and 1024
#: chains), the 64x64 cell's Y at T 81 and traces at T 8100 (k_max 64)
STATS_SHAPES = (("8x8_c8192_y", 8192, 100, 256, 256),
                ("8x8_c8192_trace", 8192, 100, 2048, None),
                ("8x8_c1024_y", 1024, 100, 256, 256),
                ("8x8_c1024_trace", 1024, 100, 2048, None),
                ("64x64_c1024_y", 1024, 64, 81, 81),
                ("64x64_c1024_trace", 1024, 64, 8100, None))


def work_stats(C, K, v):
    """(bytes, operations) of a statistics record of v samples into a
    [C, K] state: the block read, the ring and S_k read and written, the
    moments and counters; a multiply-add a lag and sample, and 7
    operations a sample for the four moments."""
    return 4 * (v * C + 4 * C * K + 12 * C), 2 * C * K * v + 7 * C * v


def stats_phase(dev):
    """Phase 23: the statistics kernel against its plain version on the
    same card tensors at ``STATS_SHAPES``, each on a state that has
    recorded one block already: ring and counters equal, moments and S_k
    within 64 eps sqrt(T) of the field's scale; the kernel's ms (CUDA
    events, 20 records) and the plain version's (3 records), the memory each allocates during one record beyond its
    inputs, the bound, the launch layout, registers and resident warps.
    Returns (the phase's line, its failures, the checks by shape)."""
    from mlmcpathintegral_tpu_torch.ops import statistics as ops_stats
    from mlmcpathintegral_tpu_torch.perf_probe import cuda_ms
    from mlmcpathintegral_tpu_torch.utils import statistics as st

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    g = torch.Generator(device=dev).manual_seed(23)
    eps = float(torch.finfo(torch.float32).eps)
    checks, failures = {}, []
    for name, C, K, T, n_valid in STATS_SHAPES:
        state = st.init(C, K, torch.float32, dev)
        state = st.record_block(state, torch.randn((T, C), generator=g,
                                                   device=dev) + 0.3)
        Q = torch.randn((T, C), generator=g, device=dev) + 0.3

        def kernel():
            return st.record_block(state, Q, n_valid)

        def plain():
            return st.record_block_plain(state, Q, n_valid)
        got, want = kernel(), plain()
        exact = all(torch.equal(getattr(got, f), getattr(want, f))
                    for f in ("n", "n_lt", "ring"))
        rel = {f: float((getattr(got, f) - getattr(want, f)).abs().max()
                        / getattr(want, f).abs().max().clamp(min=1e-30))
               for f in ("avg", "avg_lt", "avg2_lt", "avg3_lt", "avg4_lt",
                         "S_k")}
        tol = 64 * eps * math.sqrt(T)
        del got, want
        lags, wpc, cb, smem = ops_stats.record_launch(K, C)
        v = T if n_valid is None else n_valid
        checks[name] = {
            "shape": {"chains": C, "k_max": K, "T": T, "n_valid": v},
            "exact_ring_and_counters": exact,
            "max_rel_diff_from_plain": rel, "tol": tol,
            "ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 3),
            "peak_bytes": peak(kernel), "plain_peak_bytes": peak(plain),
            **bound_ms_row(*work_stats(C, K, v)),
            "layout": {"lags_per_thread": lags, "warps_per_chain": wpc,
                       "chains_per_block": cb, "smem_bytes": smem,
                       **ops_stats.record_attrs(K, C)}}
        if not exact or max(rel.values()) > tol:
            failures.append(f"the statistics kernel disagrees with its "
                            f"plain version at {name}")
        del state, Q
        torch.cuda.empty_cache()
    return {"phase": "stats", "records": checks}, failures, checks


def sequential_screen_run(dev, n_chains=SEQ_CHAINS, n_samples=SEQ_SAMPLES):
    """The sequential two-level screen on the card: the harmonic
    oscillator (M=32, T=4, m0=mu2=1) two-level with exact coarse draws and
    the Gaussian fill forced through the sequential screen (a fill
    claiming to read the fine state).  Returns (fields, |dev| in sigma of
    the fine <x^2> from Xsquared_analytical)."""
    from mlmcpathintegral_tpu_torch.conditioned.qm import (
        GaussianConditionedFineAction,
    )
    from mlmcpathintegral_tpu_torch.lattice import Lattice1D
    from mlmcpathintegral_tpu_torch.mc import MonteCarloTwoLevel
    from mlmcpathintegral_tpu_torch.models import (
        HarmonicOscillatorAction, RenormalisationType,
    )
    from mlmcpathintegral_tpu_torch.qoi import qoi_x_squared
    from mlmcpathintegral_tpu_torch.samplers import ExactSampler

    class SequentialGaussian(GaussianConditionedFineAction):
        independent_fill = False

    act = HarmonicOscillatorAction(Lattice1D(32, 4.0),
                                   RenormalisationType.NONPERTURBATIVE,
                                   m0=1.0, mu2=1.0)
    mc = MonteCarloTwoLevel(act, qoi_x_squared, ExactSampler,
                            SequentialGaussian, n_burnin=200,
                            n_samples=n_samples, chunk_size=64)
    stats = mc.evaluate_difference(torch.Generator().manual_seed(5),
                                   n_chains, torch.float32, dev)
    avg = mc.stats_fine.average(stats["fine"])
    err = mc.stats_fine.error(stats["fine"])
    oracle = act.Xsquared_analytical()
    return ({"fine_x2": avg, "error": err, "oracle": oracle,
             "p_accept": mc.p_accept, "n_chains": n_chains,
             "samples": mc.stats_fine.samples(stats["fine"]),
             "timings_s": mc.timings}, abs(avg - oracle) / err)


def scale_phase(dev, links):
    """Phase 21: K4's and K3's block branches against their plain versions
    at the scale study's launches, the cut 16x16 and 32x32 three-level
    rows through the port's scale-study tool (launch counters reset just
    before each and read just after), and the sequential screen.  Returns
    (the phase's line, its failures, the K4 and K3 checks, the launches of
    the 16x16 row)."""
    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch.tools.schwinger_scale_study import (
        run_mlmc, scale_beta,
    )
    failures, out = [], {}
    k4 = {}
    for M, C, n_steps, t_sub in SCALE_K4:
        k4[f"{M}x{M}"], ok = k4_block_check(dev, M, C, n_steps, t_sub)
        if not ok:
            failures.append(f"K4 block branch at {M}x{M}")
    k3 = {}
    for M, C in SCALE_K3:
        k3[f"{M}x{M}"], ok = k3_block_check(dev, M, C, links)
        if not ok:
            failures.append(f"K3 block branch at {M}x{M}")
    torch.cuda.empty_cache()
    rows, row_launches = {}, {}
    for M, n in SCALE_RUNS:
        ops.reset_counters()
        r = run_mlmc(M, M, beta=scale_beta(M), n_level=3, n_samples=n,
                     n_chains=1024, device=dev)
        torch.cuda.synchronize()
        launches = {c.name: c.launches for c in ops.counters()}
        plain = {c.name: c.plain_cuda_calls for c in ops.counters()}
        r.update(launches=launches, plain_calls_on_cuda=plain,
                 cut=f"n_samples 1 000 000 -> {n} a level")
        rows[f"{M}x{M}"], row_launches[M] = r, launches
        if abs(r["chit"] - r["oracle"]) > 4.0 * r["err"]:
            failures.append(f"scale row {M}x{M} beyond 4 sigma")
        if launches[ops.SWEEP.name] == 0 or launches[ops.TWOLEVEL.name] == 0 \
                or any(plain.values()):
            failures.append(f"scale row {M}x{M} missed a kernel or ran a "
                            f"plain version on CUDA")
    seq, seq_dev = sequential_screen_run(dev)
    seq["sigma_dev"] = seq_dev
    if not seq_dev <= 4.0:
        failures.append("sequential screen beyond 4 sigma")
    out = {"phase": "scale", "k4_block": k4, "k3_block": k3,
           "scale_rows": rows, "sequential_screen": seq}
    return out, failures, k4, k3, row_launches[SCALE_RUNS[0][0]]


def main() -> int:
    start = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    try:
        from mlmcpathintegral_tpu_torch import ops
        from mlmcpathintegral_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        QuenchedSchwingerConditionedFineAction,
    )
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral_tpu_torch.ops import rng, rotor, schwinger
    from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as tl
    from mlmcpathintegral_tpu_torch.perf_probe import (
        cuda_ms, headline_mlmc, headline_mlmc_cluster, kernel_device_ms,
    )
    from mlmcpathintegral_tpu_torch.samplers import (
        OverrelaxedHeatBathSampler,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{kind}, power limit not readable"

    # ---- 1. build --------------------------------------------------------
    t0 = time.monotonic()
    so, nvcc_s = _cuda.build()
    _cuda.load_library()
    emit({"phase": "build", "library": so.name,
          "nvcc_seconds": round(nvcc_s, 3),
          "build_and_load_seconds": round(time.monotonic() - t0, 3),
          "card": card_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. K1: counter RNG ---------------------------------------------
    # all chains and sites at a few ids; the main path's whole step x
    # counter range (two-level steps s*(t_sub+1)+t up to 255*9+8 = 2303,
    # fill and accept counters up to 292) at the 16 sites of its grids;
    # and the step-less streams (the GFF sweep's) over 33.5M words
    grids = (dict(n_sites=64, n_chains=1024, n_steps=4, n_ctr=8),
             dict(n_sites=16, n_chains=4, n_steps=2304, n_ctr=320),
             dict(n_sites=256, n_chains=4096, n_steps=1, n_ctr=32,
                  step0=None))
    bits_eq = uni_eq = True
    nrm_err, n_ids = 0.0, 0
    for g in grids:
        b, u, n = rng.rng_fill((123456, -98765), device=dev, **g)
        bp, up, np_ = rng.rng_fill_plain((123456, -98765), device=dev, **g)
        torch.cuda.synchronize()
        bits_eq &= torch.equal(b, bp)
        uni_eq &= torch.equal(u, up)
        nrm_err = max(nrm_err, float((n - np_).abs().max()))
        n_ids += b.numel()
        del b, u, n, bp, up, np_
    torch.cuda.empty_cache()
    # the kernel's own device time (the profiler's, without the wrapper's
    # allocations and its widening of the bits) at the kernel table's grid
    # and at two grids of 33.5M words where the stores dominate
    timed_grids = {"table": grids[0],
                   "stepped_33.5M": dict(n_sites=64, n_chains=4096,
                                         n_steps=4, n_ctr=32),
                   "stepless_33.5M": grids[2]}
    rng_times = {}
    for name, g in timed_grids.items():
        ms, _ = kernel_device_ms(
            lambda: rng.rng_fill((1, 2), device=dev, **g), 20, "rng_fill")
        bound = bound_ms_row(*work_rng(g["n_sites"], g["n_chains"],
                                       g["n_steps"], g["n_ctr"]))
        rng_times[name] = {"grid": g, "ms": ms, "ms_from": "profiler",
                           "bound_ms": bound["bound_ms"],
                           "bound_by": bound["bound_by"],
                           "share_of_bound": bound["bound_ms"] / ms,
                           "plain_ms": cuda_ms(lambda: rng.rng_fill_plain(
                               (1, 2), device=dev, **g), 2)}
        torch.cuda.empty_cache()
    plain_ms = rng_times["table"]["plain_ms"]
    emit({"phase": "rng", "ids": n_ids, "grids": grids,
          "bits_identical": bits_eq, "uniforms_identical": uni_eq,
          "normal_max_abs_err": nrm_err, "timed": rng_times,
          "plain_ms": plain_ms})
    if not (bits_eq and uni_eq and nrm_err <= 1e-6):
        fail("counter RNG disagrees with its plain version")
    rng_row = dict(max_abs_err=nrm_err, ms=rng_times["table"]["ms"],
                   ms_from="profiler", plain_ms=plain_ms,
                   **bound_ms_row(*work_rng(**grids[0])),
                   large_grids={k: rng_times[k] for k in (
                       "stepped_33.5M", "stepless_33.5M")})

    # ---- 3. K2/K3: sweep chain ------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)

    def links(C, n_links):
        return (torch.rand(C, n_links, generator=gen, device=dev) * 2 - 1) \
            * math.pi

    sweep_res = {}
    th8 = links(1024, 128)
    skw = dict(beta=2.0, Mt=8, Mx=8, n_steps=4, with_energy=True)
    k = schwinger.schwinger_sweep_chain(th8, (7, 9), n_heatbath=0, **skw)
    p = schwinger.schwinger_sweep_chain_plain(th8, (7, 9), n_heatbath=0,
                                              **skw)
    or_err = float((k[0] - p[0]).abs().max())
    sweep_res["overrelax_max_abs_err"] = or_err
    sweep_res["overrelax_qsum_max_abs_err"] = float(
        (k[1] - p[1]).abs().max())
    t = th8
    for s in range(4):
        t = schwinger.schwinger_sweep(t, (7, 9), beta=2.0, Mt=8, Mx=8,
                                      step_offset=s)
    k3 = schwinger.schwinger_sweep_chain(th8, (7, 9), beta=2.0, Mt=8, Mx=8,
                                         n_steps=4)
    sweep_res["chain_equals_stepwise"] = bool(torch.equal(t, k3[0]))
    shares = {}
    for (Mx, Mt, beta) in ((8, 8, 2.0), (4, 4, 1.0)):
        th = links(1024, 2 * Mx * Mt)
        hkw = dict(beta=beta, Mt=Mt, Mx=Mx, n_steps=4, with_energy=True)
        k = schwinger.schwinger_sweep_chain(th, (3, 4), **hkw)
        p = schwinger.schwinger_sweep_chain_plain(th, (3, 4), **hkw)
        shares[f"{Mx}x{Mt}"] = field_share(k[0], p[0], TOL)
    sweep_res["heatbath_share_within_1e-4"] = shares
    # the main path's coarsest-level launch: 4x4, beta_c=1, 256 x 8 sweeps
    thL = links(1024, 32)
    mkw = dict(beta=1.0, Mt=4, Mx=4, n_steps=2048, with_energy=True)
    k = schwinger.schwinger_sweep_chain(thL, (5, 6), **mkw)
    p, k3_rounds, plain_ms = tallied(
        lambda: schwinger.schwinger_sweep_chain_plain(thL, (5, 6), **mkw))
    torch.cuda.synchronize()
    dq, de = rel_diff(k[1], p[1]), rel_diff(k[2], p[2])
    main_rep, main_ok = departures(
        (dq <= TOL) & (de <= TOL),
        torch.maximum((k[1] - p[1]).abs(), (k[2] - p[2]).abs()).double())
    main_rep["sha256"] = sha256_of(k)
    sweep_res["main_launch"] = main_rep
    ms = cuda_ms(lambda: schwinger.schwinger_sweep_chain(thL, (5, 6),
                                                         **mkw), 5)
    k3_layout = {f"{M}x{M}": launch_layout(schwinger.sweep_launch(
        M, M, C, _cuda.max_smem_optin(0)), schwinger.sweep_attrs(M, M, C))
        for M, C in ((4, 1024), (8, 1024))}
    sweep_res.update(ms=ms, plain_ms=plain_ms,
                     main_shape="4x4, 1024 chains, n_steps=2048",
                     layout=k3_layout, rejection_rounds=k3_rounds)
    # run 12's launch (phase 16): one draw of the heat-bath sampler on the
    # coarse level of the Schwinger file coarsened in time only, 8 sites
    # in x by 4 in t (a field that is not square), the run's chains, from
    # links equilibrated by the kernel itself
    r12 = run12_launch(root, dev, links)
    sweep_res["run_12"] = r12
    emit({"phase": "sweep", **sweep_res})
    if or_err > 1e-5 or not sweep_res["chain_equals_stepwise"] \
            or min(shares.values()) < SHARE_MIN or not main_ok \
            or r12["share_within_1e-4"] < SHARE_MIN:
        fail("sweep kernel disagrees with its plain version")
    sweep_row = dict(max_abs_err=main_rep["max_abs_err_while_together"],
                     ms=ms, plain_ms=plain_ms, **bound_ms_row(*work_k3(
                         1024, 4, 4, 2048, k3_rounds["expcos"])),
                     rejection_rounds=k3_rounds, layout=k3_layout["4x4"],
                     sha256_main_launch=main_rep["sha256"],
                     max_abs_err_run_12=r12["max_abs_err"],
                     ms_run_12=r12["ms"], ms_from_run_12=r12["ms_from"],
                     plain_ms_run_12=r12["plain_ms"],
                     bound_ms_run_12=r12["bound"]["bound_ms"])

    # ---- 4. K4: two-level chain -----------------------------------------
    def carry(beta, C=1024):
        lat = Lattice2D(8, 8, CoarseningType.BOTH)
        act = QuenchedSchwingerAction(lat, beta=beta)
        cact = act.coarse_action()
        hb = OverrelaxedHeatBathSampler(cact, n_burnin=50, use_pallas=True)
        xc = hb.prepare(torch.Generator().manual_seed(3), C, torch.float32,
                        dev).x
        cond = QuenchedSchwingerConditionedFineAction(act)
        xf = cond.fill_fine_points(gen, act.prolongate(
            xc, act.initialise_state(gen, C, torch.float32, dev)))
        return (xf, xc, act.evaluate(xf), cond.evaluate(xf)), cact.beta

    tl_res = {}
    # the main path's fine-level launch: 8x8, beta=4, 256 steps, t_sub=8
    args, beta_c = carry(4.0)
    mkw = dict(beta=4.0, beta_c=beta_c, Mt=8, Mx=8, n_steps=256, t_sub=8)
    k = tl.schwinger_twolevel_chain(*args, (1, 2), **mkw)
    p, k4_rounds, plain_ms = tallied(
        lambda: tl.schwinger_twolevel_chain_plain(*args, (1, 2), **mkw))
    torch.cuda.synchronize()

    # [n_steps * t_sub, C] coarse-sweep traces -> worst sweep of each step
    dqc = rel_diff(k[5], p[5]).reshape(256, 8, -1).amax(dim=1)
    dec = rel_diff(k[6], p[6]).reshape(256, 8, -1).amax(dim=1)
    agree = (rel_diff(k[4], p[4]) <= TOL) & (k[7] == p[7]) \
        & (dqc <= TOL) & (dec <= TOL)
    main_rep, main_ok = departures(agree, (k[4] - p[4]).abs().double())
    main_rep["accept_rate"] = float(k[7].mean())
    main_rep["accept_rate_plain"] = float(p[7].mean())
    main_rep["sha256"] = sha256_of(k)
    tl_res["main_launch"] = main_rep
    ms = cuda_ms(lambda: tl.schwinger_twolevel_chain(*args, (1, 2), **mkw),
                 3)
    k4_layout = launch_layout(tl.twolevel_launch(8, 8, 1024),
                              tl.twolevel_attrs(8, 8, 1024))
    tl_res.update(ms=ms, plain_ms=plain_ms,
                  main_shape="8x8, 1024 chains, n_steps=256, t_sub=8",
                  layout=k4_layout, rejection_rounds=k4_rounds)
    # the beta > 8 fill (Gaussian mixture), off the main path: 4 steps
    args, beta_c = carry(10.0)
    kw = dict(beta=10.0, beta_c=beta_c, Mt=8, Mx=8, n_steps=4, t_sub=8)
    k = tl.schwinger_twolevel_chain(*args, (11, -12), **kw)
    p = tl.schwinger_twolevel_chain_plain(*args, (11, -12), **kw)
    res = {nm: trace_share(k[i], p[i], TOL)
           for nm, i in (("S_fine", 2), ("S_cond", 3), ("y", 4),
                         ("acc", 7))}
    res["theta_fine"] = field_share(k[0], p[0], TOL)
    tl_res["beta=10, 4 steps"] = res
    emit({"phase": "twolevel", **tl_res})
    if not main_ok or min(res.values()) < SHARE_MIN:
        fail("two-level kernel disagrees with its plain version")
    tl_row = dict(max_abs_err=main_rep["max_abs_err_while_together"],
                  ms=ms, plain_ms=plain_ms, **bound_ms_row(*work_k4(
                      1024, 8, 8, 256, 8, k4_rounds["expcos"],
                      k4_rounds["bessel"])), rejection_rounds=k4_rounds,
                  layout=k4_layout, sha256_main_launch=main_rep["sha256"])

    # ---- 5. the main path -----------------------------------------------
    mc = headline_mlmc()
    ops.reset_counters()
    stats = mc.evaluate(torch.Generator().manual_seed(2), n_chains=1024,
                        dtype=torch.float32, device=dev)
    launches = {c.name: c.launches for c in ops.counters()}
    plain_cuda = {c.name: c.plain_cuda_calls for c in ops.counters()}
    num, err = mc.numerical_result(), mc.statistical_error()
    oracle = mc.actions[0].chit_exact()
    sigma_dev = abs(num - oracle) / err
    tau0 = mc.stats_qoi[0].tau_int(stats[0])
    n0 = mc.stats_qoi[0].samples(stats[0])
    method_wall = mc.timings["cost_measure_s"] + mc.timings["sampling_s"]
    eff = n0 / (tau0 * method_wall)
    emit({"phase": "mlmc", "chit": num, "err": err, "chit_exact": oracle,
          "sigma_dev": sigma_dev, "tau_int_Y0": tau0, "n0": n0,
          "t_sub": mc._t_sub, "timings_s": mc.timings,
          "cost_per_sample_us": mc.cost_per_sample,
          "method_wall_s": method_wall, "eff_samples_per_sec": eff,
          "launches": launches, "plain_calls_on_cuda": plain_cuda,
          "layout": {schwinger.SWEEP.name: k3_layout["4x4"],
                     tl.TWOLEVEL.name: k4_layout},
          "rejection_rounds": {schwinger.SWEEP.name: k3_rounds,
                               tl.TWOLEVEL.name: k4_rounds},
          "reliable": mc.reliable})
    if not math.isfinite(num) or not math.isfinite(err) or err <= 0:
        fail("main path gave a non-finite estimate")
    if sigma_dev > 4.0:
        fail(f"main path {sigma_dev:.2f} sigma from chit_exact")
    if launches["schwinger_sweep_chain"] == 0 \
            or launches["schwinger_twolevel_chain"] == 0:
        fail("main path did not launch the sweep and two-level kernels")
    if any(plain_cuda.values()):
        fail("main path ran a plain version on CUDA")
    phase5 = {"chit": num, "err": err, "tau_int_Y0": tau0,
              "t_sub": list(mc._t_sub),
              "level_samples": [mc.stats_qoi[ell].samples(stats[ell])
                                for ell in range(mc.n_level)],
              "elapsed_s": mc.elapsed_s}

    # ---- 6. K8: rotor sweep chain ----------------------------------------
    gen = torch.Generator(device=dev).manual_seed(4)
    B_M, B_C, B_STEPS, B_T, B_I = 256, 4096, 128, 4.0, 0.25
    kappa = B_I / (B_T / B_M)
    r8 = {}
    xB = (torch.rand(B_C, B_M, generator=gen, device=dev) * 2 - 1) * math.pi
    okw = dict(kappa=kappa, M=B_M, n_steps=4, n_heatbath=0)
    k = rotor.rotor_sweep_chain(xB, (7, 9), **okw)
    p = rotor.rotor_sweep_chain_plain(xB, (7, 9), **okw)
    r8["overrelax_field_max_abs_err"] = float((k[0] - p[0]).abs().max())
    r8["overrelax_wsum_share_within_1e-4"] = trace_share(k[1], p[1], TOL)
    k = rotor.rotor_sweep(xB, (7, 9), kappa=kappa, M=B_M)
    p = rotor.rotor_sweep_chain_plain(xB, (7, 9), kappa=kappa, M=B_M,
                                      n_steps=1)[0]
    r8["single_sweep_share_within_1e-4"] = angle_share(k, p, TOL)
    r8["single_sweep_sha256"] = sha256_of([k])
    bkw = dict(kappa=kappa, M=B_M, n_steps=B_STEPS)
    k = rotor.rotor_sweep_chain(xB, (5, 6), **bkw)
    p, k8_rounds, plain_ms = tallied(
        lambda: rotor.rotor_sweep_chain_plain(xB, (5, 6), **bkw))
    torch.cuda.synchronize()
    r8["main_launch_sha256"] = sha256_of(k)
    r8["layout"] = dict(zip(
        ("chains_per_block", "smem_bytes", "table_words"),
        rotor.sweep_launch(B_M, B_C, _cuda.max_smem_optin(dev.index or 0))))
    r8["attrs"] = rotor.sweep_attrs(B_M, B_C)
    # the winding sum is blind to a local change of one site, so the final
    # paths are held against each other too
    main_rep, main_ok = departures(rel_diff(k[1], p[1]) <= TOL,
                                   (k[1] - p[1]).abs().double())
    main_rep["field_share_within_1e-4"] = angle_share(k[0], p[0], TOL)
    r8["main_launch"] = main_rep
    ms = cuda_ms(lambda: rotor.rotor_sweep_chain(xB, (5, 6), **bkw), 5)
    r8.update(ms=ms, plain_ms=plain_ms, rejection_rounds=k8_rounds,
              main_shape=f"M={B_M}, {B_C} chains, n_steps={B_STEPS}")
    # path F2's launch: one draw of the heat-bath sampler on the coarsest
    # level of the rotor file's hierarchy (its kappa, M and sweeps, the
    # run's chains), from a path equilibrated by the kernel itself
    f2_act, f2_cfg = path_f_coarsest(root, "2_rotor_hierarchical_heatbath")
    f2_hb, f2_C = f2_cfg["heatbath"], f2_cfg["parallel"]["n_chains"]
    fkw = dict(kappa=f2_act.m0 / f2_act.a_lat, M=f2_act.lattice.M_lat,
               n_overrelax=f2_hb["n_sweep_overrelax"],
               n_heatbath=f2_hb["n_sweep_heatbath"])
    xF = (torch.rand(f2_C, fkw["M"], generator=gen, device=dev) * 2
          - 1) * math.pi
    for i in range(20):
        xF = rotor.rotor_sweep(xF, (11, i), **fkw)
    k = rotor.rotor_sweep(xF, (12, 13), **fkw)
    p, f2_rounds, f2_plain_ms = tallied(
        lambda: rotor.rotor_sweep_chain_plain(xF, (12, 13), n_steps=1,
                                              **fkw)[0])
    f2_launch = lambda: rotor.rotor_sweep(xF, (12, 13), **fkw)  # noqa: E731
    f2_ms, _ = kernel_device_ms(f2_launch, 50, "rotor_sweep")
    f2_from = "profiler"
    if f2_ms is None:
        f2_ms, f2_from = cuda_ms(f2_launch, 50), "CUDA events"
    f2_err = torch.remainder(k.double() - p.double() + math.pi,
                             2 * math.pi) - math.pi
    r8["path_F2"] = {
        "shape": f"M={fkw['M']}, {f2_C} chains, kappa={fkw['kappa']}, "
                 f"{fkw['n_overrelax']} overrelaxation + "
                 f"{fkw['n_heatbath']} heat-bath sweeps, n_steps=1",
        "share_within_1e-4": angle_share(k, p, TOL),
        "max_abs_err": float(f2_err.abs().max()), "sha256": sha256_of([k]),
        "ms": f2_ms, "ms_from": f2_from, "plain_ms": f2_plain_ms,
        "rejection_rounds": f2_rounds,
        "bound": bound_ms_row(*work_k8(
            f2_C, fkw["M"], 1, f2_rounds["expcos"],
            fkw["n_overrelax"], fkw["n_heatbath"])),
        "layout": dict(zip(
            ("chains_per_block", "smem_bytes", "table_words"),
            rotor.sweep_launch(fkw["M"], f2_C,
                               _cuda.max_smem_optin(dev.index or 0)))),
        "attrs": rotor.sweep_attrs(fkw["M"], f2_C)}
    emit({"phase": "rotor_sweep", **r8})
    if r8["overrelax_field_max_abs_err"] != 0.0 or not main_ok \
            or r8["overrelax_wsum_share_within_1e-4"] < 1.0 \
            or r8["single_sweep_share_within_1e-4"] < SHARE_MIN \
            or main_rep["field_share_within_1e-4"] < SHARE_MIN \
            or r8["path_F2"]["share_within_1e-4"] < SHARE_MIN:
        fail("rotor sweep kernel disagrees with its plain version")
    k8_row = dict(max_abs_err=main_rep["max_abs_err_while_together"],
                  ms=ms, plain_ms=plain_ms, **bound_ms_row(*work_k8(
                      B_C, B_M, B_STEPS, k8_rounds["expcos"])),
                  rejection_rounds=k8_rounds, attrs=r8["attrs"],
                  max_abs_err_path_F2=r8["path_F2"]["max_abs_err"],
                  ms_path_F2=f2_ms, ms_from_path_F2=f2_from,
                  plain_ms_path_F2=f2_plain_ms,
                  bound_ms_path_F2=r8["path_F2"]["bound"]["bound_ms"])

    # ---- 7. K7: rotor cluster chain -------------------------------------
    r7 = {}
    clat = headline_mlmc_cluster().actions[-1]
    kappa2_A = 2.0 * clat.beta          # I = beta_c a, a = 1/M: 2 I/a
    A_M, A_C = clat.lattice.Mt_lat * clat.lattice.Mx_lat, 1024
    # the ragged launch: the same rotor at M=24 (kappa2 = 2 I M / T)
    shapes = (("path_A", A_C, A_M, 64, 5, kappa2_A),
              ("path_B1", B_C, B_M, B_STEPS, 10, 2.0 * kappa),
              ("ragged_M24", 64, 24, 64, 10, 2.0 * B_I * 24 / B_T))
    k7_ok = True
    for name, C, M, n_steps, n_upd, k2 in shapes:
        x = (torch.rand(C, M, generator=gen, device=dev) * 2 - 1) * math.pi
        ckw = dict(kappa2=k2, M=M, n_steps=n_steps, n_updates=n_upd)
        k = rotor.rotor_cluster_chain(x, (3, 4), **ckw)
        p, _, plain_ms = tallied(
            lambda: rotor.rotor_cluster_chain_plain(x, (3, 4), **ckw))
        torch.cuda.synchronize()
        rep, ok = departures(rel_diff(k[1], p[1]) <= TOL,
                             (k[1] - p[1]).abs().double())
        rep["field_share_within_1e-4"] = angle_share(k[0], p[0], TOL)
        rep["field_share_identical"] = float(
            (k[0] == p[0]).all(dim=1).double().mean())
        k7_ok &= ok and rep["field_share_within_1e-4"] >= SHARE_MIN
        rep["layout"] = dict(zip(
            ("lanes_per_chain", "sites_per_lane", "chains_per_block",
             "smem_bytes"), rotor.cluster_launch(M, C)))
        rep["attrs"] = rotor.cluster_attrs(M, C)
        if name.startswith("ragged"):
            rep["launch"] = dict(chains=C, **ckw)
            r7[name] = rep
            continue
        # the launch the path makes: path A one step per coarse draw
        lkw = dict(ckw, n_steps=1) if name == "path_A" else ckw
        rep["plain_ms"] = plain_ms if lkw is ckw else cuda_ms(
            lambda: rotor.rotor_cluster_chain_plain(x, (3, 4), **lkw), 1)
        if name == "path_A":
            # a one-step launch takes microseconds on the card, less than
            # the host needs to issue it: CUDA events around back-to-back
            # launches time the host.  The kernel's time is the profiler's
            # device time per launch; the 64-step launch's time per step
            # is a second reading
            launch = lambda: rotor.rotor_cluster_chain(  # noqa: E731
                x, (3, 4), **lkw)
            rep["host_ms_per_launch"] = cuda_ms(launch, 50)
            rep["ms_per_step_of_64_step_launch"] = cuda_ms(
                lambda: rotor.rotor_cluster_chain(x, (3, 4), **ckw),
                5) / n_steps
            rep["ms"], rep["profiled_launches"] = kernel_device_ms(
                launch, 50, "rotor_cluster")
            rep["ms_from"] = "profiler"
            if rep["ms"] is None:
                rep["ms"] = rep["ms_per_step_of_64_step_launch"]
                rep["ms_from"] = "64-step launch / 64"
        else:
            rep["ms"] = cuda_ms(lambda: rotor.rotor_cluster_chain(
                x, (3, 4), **lkw), 5)
        rep["launch"] = dict(chains=C, **lkw)
        rep["bound"] = bound_ms_row(*work_k7(C, M, lkw["n_steps"], n_upd))
        r7[name] = rep
    emit({"phase": "rotor_cluster", **r7})
    if not k7_ok:
        fail("rotor cluster kernel disagrees with its plain version")
    k7_row = dict(max_abs_err=max(r7[n]["max_abs_err_while_together"]
                                  for n in r7),
                  ms=r7["path_A"]["ms"], ms_from=r7["path_A"]["ms_from"],
                  host_ms_per_launch=r7["path_A"]["host_ms_per_launch"],
                  plain_ms=r7["path_A"]["plain_ms"],
                  **r7["path_A"]["bound"],
                  ms_path_B1=r7["path_B1"]["ms"],
                  plain_ms_path_B1=r7["path_B1"]["plain_ms"],
                  bound_ms_path_B1=r7["path_B1"]["bound"]["bound_ms"],
                  attrs=r7["path_A"]["attrs"],
                  attrs_path_B1=r7["path_B1"]["attrs"])

    # ---- 8. paths B1 and B2: rotor chains through the samplers ----------
    from mlmcpathintegral_tpu_torch.lattice import Lattice1D
    from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
    from mlmcpathintegral_tpu_torch.samplers import ClusterSampler
    from mlmcpathintegral_tpu_torch.samplers.heatbath import HeatBathState
    from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
    from mlmcpathintegral_tpu_torch.utils.statistics import Statistics
    ract = RotorAction(Lattice1D(B_M, B_T), m0=B_I)
    oracle_r = ract.chit_exact()
    chains = {}

    def rotor_path(name, sampler, state, n_chunks=8):
        """Warm chunk, then n_chunks of 128 steps with the counters
        reset just before: chi_t, its error (the larger of Statistics'
        tau-corrected one and the spread of the independent chains'
        means), launches."""
        g = torch.Generator(device=dev).manual_seed(len(chains) + 11)
        state, _ = sampler.draw_chain(g, state, B_STEPS)
        st = Statistics("chi_t", 40)
        ss = st.init(B_C, torch.float32, dev)
        per_chain = torch.zeros(B_C, dtype=torch.float64, device=dev)
        ops.reset_counters()
        t0 = time.monotonic()
        for _ in range(n_chunks):
            state, w = sampler.draw_chain(g, state, B_STEPS)
            chi = w * w / (4.0 * math.pi ** 2 * B_T)
            ss = stats_mod.record_many(ss, chi)
            per_chain += chi.double().sum(dim=0)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = {c.name: c.launches for c in ops.counters()}
        plain = {c.name: c.plain_cuda_calls for c in ops.counters()}
        per_chain /= n_chunks * B_STEPS
        err_chains = float(per_chain.std() / math.sqrt(B_C))
        num, err_st = st.average(ss), st.error(ss)
        err = max(err_st, err_chains)
        rep = {"chit": num, "err": err, "err_statistics": err_st,
               "err_chain_means": err_chains, "tau_int": st.tau_int(ss),
               "chit_exact": oracle_r, "sigma_dev": abs(num - oracle_r) / err,
               "samples": st.samples(ss), "wall_s": wall,
               "launches": launches, "plain_calls_on_cuda": plain}
        chains[name] = rep
        return state, rep

    b1 = ClusterSampler(ract, n_burnin=100, n_updates=10, use_pallas=True)
    st1 = b1.prepare(torch.Generator(device=dev).manual_seed(3), B_C,
                     torch.float32, dev)
    st1, rep_b1 = rotor_path("B1_cluster", b1, st1)
    b2 = OverrelaxedHeatBathSampler(ract, use_pallas=True)
    _, rep_b2 = rotor_path("B2_heatbath", b2, HeatBathState(x=st1.x))
    emit({"phase": "rotor_chains", **chains})
    for name, rep, kernel in (("B1", rep_b1, rotor.CLUSTER.name),
                              ("B2", rep_b2, rotor.SWEEP.name)):
        if not math.isfinite(rep["chit"]) or rep["sigma_dev"] > 4.0:
            fail(f"path {name} {rep['sigma_dev']:.2f} sigma from chit_exact")
        if rep["launches"][kernel] == 0 or any(
                rep["plain_calls_on_cuda"].values()):
            fail(f"path {name} did not go through {kernel} alone")

    # ---- 9. path A: MLMC with hybrid cluster coarse chains --------------
    mca = headline_mlmc_cluster()
    ops.reset_counters()
    stats = mca.evaluate(torch.Generator().manual_seed(2), n_chains=1024,
                         dtype=torch.float32, device=dev)
    launches_A = {c.name: c.launches for c in ops.counters()}
    plain_A = {c.name: c.plain_cuda_calls for c in ops.counters()}
    num, err = mca.numerical_result(), mca.statistical_error()
    sigma_dev = abs(num - oracle) / err
    tau0 = mca.stats_qoi[0].tau_int(stats[0])
    n0 = mca.stats_qoi[0].samples(stats[0])
    method_wall = mca.timings["cost_measure_s"] + mca.timings["sampling_s"]
    # each level's mean beside its exact value, with the error also taken
    # from the spread of the independent chains' means (a cross-check of
    # the tau-corrected error the gate uses)
    exact = [oracle - mca.actions[1].chit_exact(),
             mca.actions[1].chit_exact()]
    levels = [{"avg": mca.stats_qoi[ell].average(stats[ell]),
               "err": mca.stats_qoi[ell].error(stats[ell]),
               "err_chain_means": float(
                   stats[ell].avg.double().std()
                   / math.sqrt(stats[ell].avg.numel())),
               "exact": exact[ell]} for ell in range(2)]
    emit({"phase": "mlmc_cluster", "chit": num, "err": err,
          "chit_exact": oracle, "sigma_dev": sigma_dev, "tau_int_Y0": tau0,
          "levels": levels, "n0": n0, "timings_s": mca.timings,
          "cost_per_sample_us": mca.cost_per_sample,
          "method_wall_s": method_wall,
          "eff_samples_per_sec": n0 / (tau0 * method_wall),
          "launches": launches_A, "plain_calls_on_cuda": plain_A,
          "reliable": mca.reliable})
    if not math.isfinite(num) or not math.isfinite(err) or err <= 0:
        fail("path A gave a non-finite estimate")
    if sigma_dev > 4.0:
        fail(f"path A {sigma_dev:.2f} sigma from chit_exact")
    if launches_A[rotor.CLUSTER.name] == 0:
        fail("path A did not launch the cluster kernel")
    if any(plain_A.values()):
        fail("path A ran a plain version on CUDA")
    # a hybrid draw is one K7 and one K2 launch; the samplers' prepare
    # burns in with K7 alone
    burn_A = sum(s.cluster.n_burnin
                 for s in mca.coarse_samplers + [mca.coarsest_sampler])
    if launches_A[ops.SWEEP.name] \
            != launches_A[rotor.CLUSTER.name] - burn_A:
        fail("path A's hybrid draws did not each launch K2 once: "
             f"K2 {launches_A[ops.SWEEP.name]}, K7 "
             f"{launches_A[rotor.CLUSTER.name]}, burn-in {burn_A}")

    # ---- 10. K5: HMC trajectory -----------------------------------------
    from mlmcpathintegral_tpu_torch import convert
    from mlmcpathintegral_tpu_torch.conditioned.qm import (
        GaussianConditionedFineAction,
    )
    from mlmcpathintegral_tpu_torch.models import QuarticOscillatorAction
    from mlmcpathintegral_tpu_torch.ops import hmc
    from mlmcpathintegral_tpu_torch.ops import qm_twolevel as qtl
    from mlmcpathintegral_tpu_torch.perf_probe import (
        harmonic_hmc, quartic_twolevel,
    )
    gen = torch.Generator(device=dev).manual_seed(5)
    QM = dict(m0=1.0, mu2=1.0, lam=1.0, x0=1.0)
    kinds = {"harmonic": dict(m0=1.0, mu2=1.0), "quartic": QM,
             "rotor": dict(m0=1.0)}
    # path F1's and F3's launch: the coarsest level of the harmonic file's
    # hierarchy (the run's chains, the file's nt)
    f1_act, f1_cfg = path_f_coarsest(root, "1_harmonic_hierarchical_hmc")
    f1_kind, f1_par = hmc.action_kernel_params(f1_act)
    # (name, chains, sites, nt, {kind: parameters}, the kind timed): path
    # D's launch, path C's coarse-chain launch (coarse spacing 2a = 4/32)
    # and path F's
    launches_k5 = (
        ("path_D", 8192, 64, 20,
         {kn: dict(kinds[kn], a_lat=4.0 / 64) for kn in sorted(kinds)},
         "harmonic"),
        ("path_C_coarse", 4096, 32, 100, {"quartic": dict(QM, a_lat=4.0 / 32)},
         "quartic"),
        ("path_F_coarsest", f1_cfg["parallel"]["n_chains"],
         f1_act.lattice.M_lat, f1_cfg["hmc"]["nt"], {f1_kind: f1_par},
         f1_kind))
    r10, k5_ok, dt_t = {}, True, torch.tensor(0.1, device=dev)
    for name, C, M, nt, params, timed in launches_k5:
        for kn, par in params.items():
            x = torch.randn(C, M, generator=gen, device=dev) * 0.5 \
                + par.get("x0", 0.0)
            hkw = dict(kind=kn, nt=nt, **par)
            # a hot start accepts every trajectory (dH << 0): equilibrate
            # first, so that the compared launch rejects some chains
            for _ in range(30):
                x, _ = hmc.hmc_trajectory(
                    x, torch.randn(C, M, generator=gen, device=dev),
                    torch.rand(C, generator=gen, device=dev), dt_t, **hkw)
            p = torch.randn(C, M, generator=gen, device=dev)
            u = torch.rand(C, generator=gen, device=dev)
            k = hmc.hmc_trajectory(x, p, u, dt_t, **hkw)
            pl, _, plain_ms = tallied(
                lambda: hmc.hmc_trajectory_plain(x, p, u, dt_t, **hkw))
            share = float(((rel_diff(k[0], pl[0]).amax(dim=1) <= TOL)
                           & (k[1] == pl[1])).double().mean())
            rep = {"share_within_1e-4_same_accept": share,
                   "accept_rate": float(k[1].double().mean()),
                   "accept_rate_plain": float(pl[1].double().mean()),
                   "max_abs_err": float((k[0] - pl[0]).abs().max()),
                   "plain_ms": plain_ms, "sha256": sha256_of(k),
                   "layout": dict(zip(
                       ("branch", "lanes_per_chain", "sites_per_lane",
                        "chains_per_block", "smem_bytes"),
                       hmc.hmc_launch(M, C))),
                   "attrs": hmc.hmc_attrs(M, C, kn)}
            k5_ok &= share >= SHARE_MIN
            if kn == timed:
                launch = lambda: hmc.hmc_trajectory(  # noqa: E731
                    x, p, u, dt_t, **hkw)
                rep["host_ms_per_launch"] = cuda_ms(launch, 50)
                rep["ms"], _ = kernel_device_ms(launch, 50, "hmc_trajectory")
                rep["ms_from"] = "profiler"
                if rep["ms"] is None:
                    rep["ms"], rep["ms_from"] = rep["host_ms_per_launch"], \
                        "CUDA events"
                rep["bound"] = bound_ms_row(*work_k5(C, M, nt, kn))
            r10[f"{name}:{kn}"] = rep
    emit({"phase": "hmc", "shapes": [[*s[:4], sorted(s[4])]
                                     for s in launches_k5], **r10})
    if not k5_ok:
        fail("HMC trajectory kernel disagrees with its plain version")
    rD = r10["path_D:harmonic"]
    k5_row = dict(max_abs_err=max(r["max_abs_err"] for r in r10.values()),
                  ms=rD["ms"], ms_from=rD["ms_from"],
                  host_ms_per_launch=rD["host_ms_per_launch"],
                  plain_ms=rD["plain_ms"], **rD["bound"],
                  ms_path_C_coarse=r10["path_C_coarse:quartic"]["ms"],
                  bound_ms_path_C_coarse=r10["path_C_coarse:quartic"][
                      "bound"]["bound_ms"], attrs=rD["attrs"],
                  attrs_path_C_coarse=r10["path_C_coarse:quartic"]["attrs"])
    rF = r10[f"path_F_coarsest:{f1_kind}"]
    k5_row.update(max_abs_err_path_F=rF["max_abs_err"], ms_path_F=rF["ms"],
                  plain_ms_path_F=rF["plain_ms"],
                  bound_ms_path_F=rF["bound"]["bound_ms"],
                  attrs_path_F=rF["attrs"])

    # ---- 12. path D: single-level HMC through K5 -------------------------
    ops.reset_counters()
    rep_d = harmonic_hmc(device=dev)
    rep_d["launches"] = {c.name: c.launches for c in ops.counters()}
    rep_d["plain_calls_on_cuda"] = {c.name: c.plain_cuda_calls
                                    for c in ops.counters()}
    emit({"phase": "hmc_chain", **rep_d})
    if not math.isfinite(rep_d["avg_x2"]) or rep_d["sigma_dev"] > 4.0:
        fail(f"path D {rep_d['sigma_dev']:.2f} sigma from "
             f"Xsquared_analytical")
    if rep_d["launches"][hmc.HMC.name] == 0 \
            or any(rep_d["plain_calls_on_cuda"].values()):
        fail("path D did not go through the trajectory kernel alone")

    # ---- 13. paths C and C': two-level QM through K5 and K6 -------------
    qm_paths = {}
    for name, qm_kind in (("C_quartic", "quartic"),
                          ("C'_harmonic", "harmonic")):
        ops.reset_counters()
        rep = quartic_twolevel(kind=qm_kind, device=dev)
        rep["launches"] = {c.name: c.launches for c in ops.counters()}
        rep["plain_calls_on_cuda"] = {c.name: c.plain_cuda_calls
                                      for c in ops.counters()}
        qm_paths[name] = rep
    emit({"phase": "qm_twolevel_mlmc", **qm_paths})
    rep_c = qm_paths["C_quartic"]
    for name, rep in qm_paths.items():
        devs = [rep["sigma_dev"], rep.get("coarse_sigma_dev", 0.0)]
        if not all(math.isfinite(v) for v in devs + [rep["avg_x2"]]) \
                or max(devs) > 4.0:
            fail(f"path {name} {max(devs):.2f} sigma from its oracle")
        if rep["launches"][hmc.HMC.name] == 0 \
                or rep["launches"][qtl.QM_TWOLEVEL.name] == 0 \
                or any(rep["plain_calls_on_cuda"].values()):
            fail(f"path {name} did not go through K5 and K6 alone")

    # ---- 11. K6: QM two-level chain --------------------------------------
    Mc, C6 = 32, 4096
    act = QuarticOscillatorAction(Lattice1D(2 * Mc, 4.0), **QM)
    cond = GaussianConditionedFineAction(act)
    xc = QM["x0"] + 0.5 * torch.randn(C6, Mc, generator=gen, device=dev)
    xf = cond.fill_fine_points(gen, act.prolongate(
        xc, torch.zeros(C6, 2 * Mc, device=dev)))
    args6 = (convert.qm_planes(xf), xc, convert.qm_s_cache(act, cond, xf),
             dt_t)
    t_sub_c = int(rep_c["t_indep"])
    r11, k6_ok = {}, True
    for t_sub, traces in ((2, True), (t_sub_c, False)):
        qkw = dict(QM, a_lat=act.a_lat, nt=100, n_steps=64, t_sub=t_sub,
                   with_traces=traces)
        k = qtl.qm_twolevel_chain(*args6, (7, 8), **qkw)
        pl, _, plain_ms = tallied(
            lambda: qtl.qm_twolevel_chain_plain(*args6, (7, 8), **qkw))
        agree = ((rel_diff(k[3], pl[3]) <= TOL)
                 & (rel_diff(k[4], pl[4]) <= TOL) & (k[7] == pl[7]))
        if traces:
            # [n_steps * t_sub, C] clock traces -> worst trajectory a step
            for i in (5, 6):
                agree &= rel_diff(k[i], pl[i]).reshape(
                    64, t_sub, -1).amax(dim=1) <= TOL
        rep, ok = departures(agree, (k[3] - pl[3]).abs().double())
        rep.update({
            "t_sub": t_sub, "with_traces": traces, "plain_ms": plain_ms,
            "accept_rate": float(k[7].mean()),
            "accept_rate_plain": float(pl[7].mean()),
            "fine_share_within_1e-4": field_share(
                k[0].transpose(0, 1), pl[0].transpose(0, 1), TOL),
            "coarse_share_within_1e-4": field_share(k[1], pl[1], TOL),
            "s_cache_share_within_1e-4": trace_share(k[2], pl[2], TOL),
            "ms": cuda_ms(lambda: qtl.qm_twolevel_chain(
                *args6, (7, 8), **qkw), 3),
            "bound": bound_ms_row(*work_k6(C6, Mc, 100, 64, t_sub,
                                           traces))})
        k6_ok &= ok and min(rep["fine_share_within_1e-4"],
                            rep["coarse_share_within_1e-4"],
                            rep["s_cache_share_within_1e-4"]) >= SHARE_MIN
        r11["burn_in" if traces else "sampling"] = rep
    k6_attrs = qtl.qm_twolevel_attrs(Mc, C6)
    emit({"phase": "qm_twolevel", "chains": C6, "Mc": Mc, "nt": 100,
          "n_steps": 64, "layout": dict(zip(
              ("lanes_per_chain", "sites_per_lane", "chains_per_block",
               "smem_bytes"), qtl.qm_twolevel_launch(Mc, C6))),
          "attrs": k6_attrs, **r11})
    if not k6_ok:
        fail("QM two-level kernel disagrees with its plain version")
    rS = r11["sampling"]
    k6_row = dict(max_abs_err=max(r["max_abs_err_while_together"]
                                  for r in r11.values()),
                  ms=rS["ms"], plain_ms=rS["plain_ms"], **rS["bound"],
                  launch=dict(chains=C6, Mc=Mc, nt=100, n_steps=64,
                              t_sub=t_sub_c, with_traces=False),
                  ms_burn_in_launch=r11["burn_in"]["ms"],
                  plain_ms_burn_in_launch=r11["burn_in"]["plain_ms"],
                  bound_ms_burn_in_launch=r11["burn_in"]["bound"][
                      "bound_ms"], attrs=k6_attrs)

    # ---- 14. K9, P1, P2: the GFF sweep, the neighbour sum, step-less RNG
    from mlmcpathintegral_tpu_torch.ops import gff
    from mlmcpathintegral_tpu_torch.perf_probe import (
        PATH_E_CHAINS, gff_heatbath,
    )
    gen = torch.Generator(device=dev).manual_seed(6)
    E_M, kappa_E = 16, 4.0 + (10.0 / 16) ** 2     # path E: mass 10, a = 1/16
    r14, k9_ok = {}, True

    def device_ms(launch, name_sub):
        """A short launch's time: the profiler's device time per launch
        (CUDA events around back-to-back launches would time the host,
        given beside it)"""
        host = cuda_ms(launch, 50)
        ms, _ = kernel_device_ms(launch, 50, name_sub)
        return {"ms": host if ms is None else ms,
                "ms_from": "CUDA events" if ms is None else "profiler",
                "host_ms_per_launch": host}

    phiE = torch.randn(PATH_E_CHAINS, E_M * E_M, generator=gen, device=dev)
    okw = dict(kappa=kappa_E, Mt=E_M, Mx=E_M, n_overrelax=1, n_heatbath=0)
    k = gff.gff_sweep(phiE, (7, 9), **okw)
    p = gff.gff_sweep_plain(phiE, (7, 9), **okw)
    r14["overrelax_max_abs_err"] = float((k - p).abs().max())
    k9_ok &= r14["overrelax_max_abs_err"] <= 1e-6
    # 64 heat-bath draws from the same start, one seed pair a draw: the
    # chain is linear with no accept test, so no chain may depart
    for name, M, C in (("path_E", E_M, PATH_E_CHAINS), ("128x128", 128, 64),
                       ("256x256", 256, 64)):
        x = phiE if M == E_M else torch.randn(C, M * M, generator=gen,
                                              device=dev)
        hkw = dict(kappa=4.0 + (10.0 / M) ** 2, Mt=M, Mx=M, n_overrelax=1,
                   n_heatbath=1)
        xk, xp = x, x
        for s in range(64):
            xk = gff.gff_sweep(xk, (s, -s - 1), **hkw)
        torch.cuda.synchronize()
        t_plain = time.monotonic()
        for s in range(64):
            xp = gff.gff_sweep_plain(xp, (s, -s - 1), **hkw)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t_plain) * 1e3 / 64
        d = rel_diff(xk, xp).amax(dim=1)
        rep = {"chains": C, "draws": 64,
               "share_within_1e-4": float((d <= TOL).double().mean()),
               "max_rel_err": float(d.max()),
               "max_abs_err": float((xk - xp).abs().max()),
               "in_global_memory": gff.sweep_launch(
                   M, M, C, _cuda.max_smem_optin(0))[3] == "global",
               "layout": launch_layout(gff.sweep_launch(
                   M, M, C, _cuda.max_smem_optin(0)),
                   gff.sweep_attrs(M, M, C)),
               **device_ms(lambda: gff.gff_sweep(x, (1, 2), **hkw),
                           "gff_sweep"),
               "plain_ms": plain_ms,
               "bound": bound_ms_row(*work_k9(C, M, M))}
        k9_ok &= rep["share_within_1e-4"] == 1.0
        r14[name] = rep
    # P1 at the JAX probe's shapes
    p1_eq = True
    for Mt, Mx in ((8, 8), (16, 16), (16, 8), (8, 16)):
        x = torch.randn(256, Mx * Mt, generator=gen, device=dev)
        p1_eq &= torch.equal(gff.gff_nbsum(x, Mt, Mx),
                             gff.gff_nbsum_plain(x, Mt, Mx))
    x = torch.randn(256, 256, generator=gen, device=dev)
    r14["nbsum"] = {"identical": bool(p1_eq), "shape": "256 chains, 16x16",
                    **device_ms(lambda: gff.gff_nbsum(x, 16, 16),
                                "gff_nbsum"),
                    "plain_ms": cuda_ms(lambda: gff.gff_nbsum_plain(
                        x, 16, 16), 5),
                    "bound": bound_ms_row(*work_p1(256, 16, 16))}
    # P1 where its bytes dominate: path E's field and 64 x 256x256
    for name, C, M in (("nbsum_path_E_field", PATH_E_CHAINS, E_M),
                       ("nbsum_256x256", 64, 256)):
        x = torch.randn(C, M * M, generator=gen, device=dev)
        eq = torch.equal(gff.gff_nbsum(x, M, M), gff.gff_nbsum_plain(x, M, M))
        p1_eq &= eq
        r14[name] = {"identical": bool(eq), "chains": C, "Mx": M, "Mt": M,
                     **device_ms(lambda: gff.gff_nbsum(x, M, M),
                                 "gff_nbsum"),
                     "plain_ms": cuda_ms(lambda: gff.gff_nbsum_plain(
                         x, M, M), 5),
                     "bound": bound_ms_row(*work_p1(C, M, M))}
    # P2: the probe's step-less streams, seed 42, words 1-3
    p2 = dict(n_sites=64, n_chains=512, n_steps=1, n_ctr=3, step0=None)
    b, u, n = rng.rng_fill(42, device=dev, **p2)
    bp, up, np_ = rng.rng_fill_plain(42, device=dev, **p2)
    torch.cuda.synchronize()
    r14["rng_stepless"] = {
        "bits_identical": bool(torch.equal(b, bp)),
        "uniforms_identical": bool(torch.equal(u, up)),
        "normal_max_abs_err": float((n - np_).abs().max()),
        "grid": {k: v for k, v in p2.items()},
        **device_ms(lambda: rng.rng_fill(42, device=dev, **p2),
                    "rng_fill"),
        "plain_ms": cuda_ms(lambda: rng.rng_fill_plain(42, device=dev,
                                                       **p2), 5),
        "bound": bound_ms_row(*work_rng(64, 512, 1, 3))}
    p2_ok = (r14["rng_stepless"]["bits_identical"]
             and r14["rng_stepless"]["uniforms_identical"]
             and r14["rng_stepless"]["normal_max_abs_err"] <= 1e-6)
    # K3 beyond shared memory: a 256x256 link field, 64 chains
    th = links(64, 2 * 256 * 256)
    kw3 = dict(beta=4.0, Mt=256, Mx=256, n_steps=1, with_energy=True)
    k = schwinger.schwinger_sweep_chain(th, (7, 9), n_heatbath=0, **kw3)
    p = schwinger.schwinger_sweep_chain_plain(th, (7, 9), n_heatbath=0,
                                              **kw3)
    k3_or = float((k[0] - p[0]).abs().max())
    k = schwinger.schwinger_sweep_chain(th, (3, 4), **kw3)
    p = schwinger.schwinger_sweep_chain_plain(th, (3, 4), **kw3)
    # 131 072 links a chain: a float rounding that flips one ExpCos test
    # (a few in 10^7 links, as at the smaller launches) moves a whole
    # chain, so the share is taken over links
    dl = torch.remainder(k[0].double() - p[0].double() + math.pi,
                         2 * math.pi) - math.pi
    r14["schwinger_256x256"] = {
        "in_global_memory": schwinger.sweep_launch(
            256, 256, 64, _cuda.max_smem_optin(0))[3] == "global",
        "layout": launch_layout(schwinger.sweep_launch(
            256, 256, 64, _cuda.max_smem_optin(0)),
            schwinger.sweep_attrs(256, 256, 64)),
        "overrelax_max_abs_err": k3_or,
        "heatbath_link_share_within_1e-4": float(
            (dl.abs() <= TOL).double().mean()),
        "heatbath_links_off": int((dl.abs() > TOL).sum()),
        "heatbath_chain_share_within_1e-4": angle_share(k[0], p[0], TOL),
        "ms": cuda_ms(lambda: schwinger.schwinger_sweep_chain(
            th, (3, 4), **kw3), 5)}
    k3_big_ok = (k3_or <= 1e-5 and r14["schwinger_256x256"][
        "heatbath_link_share_within_1e-4"] >= 1.0 - 1e-4)
    emit({"phase": "gff_sweep", **r14})
    if not k9_ok:
        fail("GFF sweep kernel disagrees with its plain version")
    if not p1_eq:
        fail("neighbour-sum kernel disagrees with its plain version")
    if not p2_ok:
        fail("step-less RNG streams disagree with their plain version")
    if not k3_big_ok:
        fail("sweep kernel on a 256x256 field disagrees with its plain "
             "version")
    rE = r14["path_E"]
    k9_row = dict(max_abs_err=max(r14[n]["max_abs_err"] for n in
                                  ("path_E", "128x128", "256x256")),
                  ms=rE["ms"], ms_from=rE["ms_from"],
                  host_ms_per_launch=rE["host_ms_per_launch"],
                  plain_ms=rE["plain_ms"], **rE["bound"],
                  launch=dict(chains=PATH_E_CHAINS, Mt=E_M, Mx=E_M,
                              n_overrelax=1, n_heatbath=1),
                  ms_128x128=r14["128x128"]["ms"],
                  bound_ms_128x128=r14["128x128"]["bound"]["bound_ms"],
                  ms_256x256=r14["256x256"]["ms"],
                  bound_ms_256x256=r14["256x256"]["bound"]["bound_ms"],
                  layouts={n: r14[n]["layout"] for n in
                           ("path_E", "128x128", "256x256")})
    r1 = r14["nbsum"]
    p1_row = dict(max_abs_err=0.0, ms=r1["ms"], ms_from=r1["ms_from"],
                  plain_ms=r1["plain_ms"], **r1["bound"], launch=r1["shape"],
                  large_shapes={n: {k: r14[n][k] for k in (
                      "chains", "Mx", "Mt", "ms", "ms_from", "plain_ms",
                      "bound")} for n in ("nbsum_path_E_field",
                                          "nbsum_256x256")})
    # P2's time and bound at the step-less 33.5M-word grid of phase 2,
    # where the stores dominate; the probe's own grid (3 words a stream)
    # beside it
    r2, t2 = r14["rng_stepless"], rng_times["stepless_33.5M"]
    p2_row = dict(max_abs_err=max(r2["normal_max_abs_err"], nrm_err),
                  ms=t2["ms"], ms_from=t2["ms_from"],
                  plain_ms=t2["plain_ms"],
                  **bound_ms_row(*work_rng(256, 4096, 1, 32)),
                  launch=t2["grid"], probe_grid=r2["grid"],
                  ms_probe_grid=r2["ms"], plain_ms_probe_grid=r2["plain_ms"],
                  bound_ms_probe_grid=r2["bound"]["bound_ms"])

    # ---- 15. path E: the GFF heat bath through the QFT driver ------------
    ops.reset_counters()
    rep_e = gff_heatbath(device=dev)
    rep_e["launches"] = {c.name: c.launches for c in ops.counters()}
    rep_e["plain_calls_on_cuda"] = {c.name: c.plain_cuda_calls
                                    for c in ops.counters()}
    prof_e = gff_heatbath(device=dev, profile=True)
    rep_e["profiled"] = {k: prof_e[k] for k in (
        "phase_device_busy_ms", "phase_idle_share", "device_ms_per_draw",
        "phase_device_events", "gff_sweep_ms_per_launch",
        "host_ms_per_draw", "eff_samples_per_sec", "numerical")}
    emit({"phase": "gff_singlelevel", **rep_e})
    want_k9 = 100 + 4 * 256 + 512
    if not math.isfinite(rep_e["numerical"]) or rep_e["sigma_dev"] > 4.0:
        fail(f"path E {rep_e['sigma_dev']:.2f} sigma from "
             f"phi_squared_analytical")
    if rep_e["launches"][gff.SWEEP.name] != want_k9 \
            or any(rep_e["plain_calls_on_cuda"].values()):
        fail(f"path E made {rep_e['launches'][gff.SWEEP.name]} GFF sweep "
             f"launches (want {want_k9}) or ran a plain version on CUDA")

    # ---- 16. qm_driver: the QM driver's samplers and methods, and the
    # Schwinger two-level run of the QFT driver, at the reference files'
    # widths (K5, K8 and K3 on the coarsest levels)
    qm_rows, qm_launches, qm_ok = qm_driver_phase(dev, root)
    if not qm_ok:
        fail("a qm_driver run missed its oracle, launched no kernel of its "
             "path or ran a plain version on CUDA")

    # ---- 17. chain0: every kernel's global chain offset ------------------
    # at its path's launch: the two halves (the second with chain0 = C/2)
    # equal the whole launch bit for bit, and the plain version with
    # chain0 = C/2 agrees with the kernel's second half under the gates of
    # the kernel's own phase.  K5 (HMC trajectory) and P1 (neighbour sum)
    # draw no random words (K5's momenta and accept uniforms come from its
    # caller), so they have no chain offset
    from mlmcpathintegral_tpu_torch.parallel import chain_mesh
    gen = torch.Generator(device=dev).manual_seed(17)
    r17 = {}

    def half(t, C):
        return t.narrow(chain_axis(t, C), C // 2, C - C // 2)

    # K3: the main path's coarsest launch
    th3 = links(1024, 32)
    kw3 = dict(beta=1.0, Mt=4, Mx=4, n_steps=2048, with_energy=True)
    # the plain version on the first 256 chains of the second half
    # (chain0 = 512): chains are independent, so the slice stands for the
    # half at a quarter of the plain version's time
    eq, _, k = chain0_halves(lambda lo, hi, c0: schwinger.
                             schwinger_sweep_chain(th3[lo:hi], (5, 6),
                                                   chain0=c0, **kw3), 1024)
    k = [t[:, :256] if t.shape[0] == 2048 else t[:256] for t in k]
    p = schwinger.schwinger_sweep_chain_plain(th3[512:768], (5, 6),
                                              chain0=512, **kw3)
    rep, ok = departures(
        (rel_diff(k[1], p[1]) <= TOL) & (rel_diff(k[2], p[2]) <= TOL),
        torch.maximum((k[1] - p[1]).abs(), (k[2] - p[2]).abs()).double())
    r17[ops.SWEEP.name] = dict(halves_equal=eq, plain_chain0=rep,
                               ok=eq and ok, launch="main path's 4x4, 1024 "
                               "chains, n_steps=2048")
    # K4: the main path's fine launch
    args4, beta_c4 = carry(4.0)
    kw4 = dict(beta=4.0, beta_c=beta_c4, Mt=8, Mx=8, n_steps=256, t_sub=8)
    eq, _, k = chain0_halves(lambda lo, hi, c0: tl.schwinger_twolevel_chain(
        *(a[lo:hi] for a in args4), (1, 2), chain0=c0, **kw4), 1024)
    k = [t[:256] if i < 4 else t[:, :256] for i, t in enumerate(k)]
    p = tl.schwinger_twolevel_chain_plain(*(a[512:768] for a in args4),
                                          (1, 2), chain0=512, **kw4)
    dqc = rel_diff(k[5], p[5]).reshape(256, 8, -1).amax(dim=1)
    dec = rel_diff(k[6], p[6]).reshape(256, 8, -1).amax(dim=1)
    rep, ok = departures((rel_diff(k[4], p[4]) <= TOL) & (k[7] == p[7])
                         & (dqc <= TOL) & (dec <= TOL),
                         (k[4] - p[4]).abs().double())
    r17[tl.TWOLEVEL.name] = dict(halves_equal=eq, plain_chain0=rep,
                                 ok=eq and ok, launch="main path's 8x8, 1024 "
                                 "chains, n_steps=256, t_sub=8")
    # K3's and K4's block branches at phase 21's fields (the halves launch
    # smaller chain counts, so other team sizes, than the whole)
    r17[BLOCK_K3], r17[BLOCK_K4] = block_chain0_halves(dev, links)
    # K6: path C's launch (16 of its 64 steps, with the burn-in traces)
    qkw = dict(QM, a_lat=act.a_lat, nt=100, n_steps=16, t_sub=2,
               with_traces=True)

    def run6(lo, hi, c0):
        fine, xc6, sc6, dt6 = args6
        return qtl.qm_twolevel_chain(
            fine[:, lo:hi].contiguous(), xc6[lo:hi],
            sc6[:, lo:hi].contiguous(), dt6, (7, 8), chain0=c0, **qkw)

    eq, _, k = chain0_halves(run6, C6)
    fine, xc6, sc6, dt6 = args6
    p = qtl.qm_twolevel_chain_plain(
        fine[:, C6 // 2:].contiguous(), xc6[C6 // 2:],
        sc6[:, C6 // 2:].contiguous(), dt6, (7, 8), chain0=C6 // 2, **qkw)
    agree = ((rel_diff(k[3], p[3]) <= TOL) & (rel_diff(k[4], p[4]) <= TOL)
             & (k[7] == p[7]))
    for i in (5, 6):
        agree &= rel_diff(k[i], p[i]).reshape(16, 2, -1).amax(dim=1) <= TOL
    rep, ok = departures(agree, (k[3] - p[3]).abs().double())
    r17[qtl.QM_TWOLEVEL.name] = dict(
        halves_equal=eq, plain_chain0=rep, ok=eq and ok,
        launch=f"path C's {C6} chains, Mc={Mc}, nt=100, n_steps=16, "
               f"t_sub=2 with traces")
    # K7: path A's launch; K8: path B2's
    for counter, C, M, kern, plain_fn, kw in (
            (rotor.CLUSTER, A_C, A_M, rotor.rotor_cluster_chain,
             rotor.rotor_cluster_chain_plain,
             dict(kappa2=kappa2_A, M=A_M, n_steps=64, n_updates=5)),
            (rotor.SWEEP, B_C, B_M, rotor.rotor_sweep_chain,
             rotor.rotor_sweep_chain_plain,
             dict(kappa=kappa, M=B_M, n_steps=B_STEPS))):
        x = (torch.rand(C, M, generator=gen, device=dev) * 2 - 1) * math.pi
        eq, _, k = chain0_halves(
            lambda lo, hi, c0: kern(x[lo:hi], (3, 4), chain0=c0, **kw), C)
        p = plain_fn(x[C // 2:], (3, 4), chain0=C // 2, **kw)
        rep, ok = departures(rel_diff(k[1], p[1]) <= TOL,
                             (k[1] - p[1]).abs().double())
        rep["field_share_within_1e-4"] = angle_share(k[0], p[0], TOL)
        r17[counter.name] = dict(
            halves_equal=eq, plain_chain0=rep,
            ok=eq and ok and rep["field_share_within_1e-4"] >= SHARE_MIN,
            launch=f"{C} chains, " + ", ".join(f"{a}={b}" for a, b in
                                                kw.items()))
    # K9: path E's launch
    phi9 = torch.randn(PATH_E_CHAINS, E_M * E_M, generator=gen, device=dev)
    kw9 = dict(kappa=kappa_E, Mt=E_M, Mx=E_M, n_overrelax=1, n_heatbath=1)
    eq, _, k = chain0_halves(lambda lo, hi, c0: gff.gff_sweep(
        phi9[lo:hi], (3, 4), chain0=c0, **kw9), PATH_E_CHAINS)
    p = gff.gff_sweep_plain(phi9[PATH_E_CHAINS // 2:], (3, 4),
                            chain0=PATH_E_CHAINS // 2, **kw9)
    share = field_share(k[0], p, TOL)
    r17[gff.SWEEP.name] = dict(
        halves_equal=eq, ok=eq and share >= SHARE_MIN,
        plain_chain0={"share_within_1e-4": share,
                      "max_abs_err": float((k[0] - p).abs().max())},
        launch=f"path E's {PATH_E_CHAINS} chains, {E_M}x{E_M}, 1 + 1 "
               f"sweeps")
    # rng_fill: the kernel table's grid (stepped, K1) and the step-less
    # streams of P2's 33.5M-word grid
    for name, g in (("rng_fill", grids[0]),
                    ("rng_fill (step-less)", grids[2])):
        Cg = g["n_chains"]
        gk = {k_: v for k_, v in g.items() if k_ != "n_chains"}
        eq, _, k = chain0_halves(lambda lo, hi, c0: rng.rng_fill(
            (123456, -98765), n_chains=hi - lo, device=dev, chain0=c0,
            **gk), Cg)
        p = rng.rng_fill_plain((123456, -98765), n_chains=Cg // 2,
                               device=dev, chain0=Cg // 2, **gk)
        torch.cuda.synchronize()
        chk = {"bits_identical": bool(torch.equal(k[0], p[0])),
               "uniforms_identical": bool(torch.equal(k[1], p[1])),
               "normal_max_abs_err": float((k[2] - p[2]).abs().max())}
        r17[name] = dict(halves_equal=eq, plain_chain0=chk, launch=g,
                         ok=eq and chk["bits_identical"]
                         and chk["uniforms_identical"]
                         and chk["normal_max_abs_err"] <= 1e-6)
        del k, p
    torch.cuda.empty_cache()
    # every output's bits at chain0 = 0 are the recorded ones
    now = {"sweep.main_launch": sweep_res["main_launch"]["sha256"],
           "sweep.run_12": sweep_res["run_12"]["sha256"],
           "twolevel.main_launch": tl_res["main_launch"]["sha256"],
           "rotor_sweep.single_sweep": r8["single_sweep_sha256"],
           "rotor_sweep.main_launch": r8["main_launch_sha256"],
           "rotor_sweep.path_F2": r8["path_F2"]["sha256"],
           **{f"hmc.{k_}": v["sha256"] for k_, v in r10.items()}}
    sha_moved = {k_: [v, now.get(k_)] for k_, v in BASELINE_SHA256.items()
                 if now.get(k_) != v}
    emit({"phase": "chain0", **r17, "sha256_vs_baseline": {
        "compared": len(BASELINE_SHA256), "moved": sha_moved},
        "no_chain0": {hmc.HMC.name: "draws no random words: x, p and u "
                      "come from its caller", gff.NBSUM.name: "draws no "
                      "random words"}})
    if not all(r["ok"] for r in r17.values()):
        fail("a kernel's chain offset disagrees: "
             + ", ".join(n for n, r in r17.items() if not r["ok"]))
    if sha_moved:
        fail(f"outputs at chain0 = 0 moved from the recorded values: {sha_moved}")

    # ---- 18. the main path on two ranks of the card ---------------------
    # phase 5's run split over two gloo ranks (512 chains each, mesh=): its
    # estimate, error, tau_int(Y_0), t_sub and per-level samples must be
    # phase 5's exactly
    two, wall_two = two_rank_main_path(root, 1024, 2)
    keys = ("chit", "err", "tau_int_Y0", "t_sub", "level_samples")
    same = {k_: all(r[k_] == phase5[k_] for r in two) for k_ in keys}
    emit({"phase": "mlmc_two_ranks", "backend": "gloo", "ranks": two,
          "phase5": phase5, "equal_to_phase5": same,
          "wall_s_two_ranks": wall_two,
          "elapsed_s": {"phase5": phase5["elapsed_s"],
                        "two_ranks": [r["elapsed_s"] for r in two]},
          "baseline_chit": BASELINE_MAIN_CHI})
    if not all(same.values()):
        fail(f"the two-rank main path differs from phase 5: {same}")
    if any(r["launches"][ops.SWEEP.name] == 0
           or r["launches"][ops.TWOLEVEL.name] == 0
           or any(r["plain_calls_on_cuda"].values()) for r in two):
        fail("a rank of the two-rank main path missed a kernel or ran a "
             "plain version on CUDA")

    # ---- 19. checkpoint and resume on the card --------------------------
    import tempfile

    from mlmcpathintegral_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint,
    )
    mc19 = headline_mlmc()
    hb19 = OverrelaxedHeatBathSampler(mc19.actions[-1], use_pallas=True)
    s0 = hb19.init(torch.Generator(device=dev).manual_seed(21), 1024,
                   torch.float32, dev)

    def draws(state, g, n):
        for _ in range(n):
            state, _ = hb19.draw(g, state)
        return state

    ops.reset_counters()
    r19 = {}
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        g = torch.Generator().manual_seed(22)
        save_checkpoint(f"{tmp}/k3.npz", {"state": draws(s0, g, 64),
                                           "gen": g}, metadata={"draws": 64})
        back = load_checkpoint(f"{tmp}/k3.npz", {
            "state": hb19.init(torch.Generator(device=dev).manual_seed(9),
                               1024, torch.float32, dev),
            "gen": torch.Generator()})
        resumed = draws(back["state"], back["gen"], 64)
        whole = draws(s0, torch.Generator().manual_seed(22), 128)
        r19["k3_64_plus_64_equals_128"] = bool(torch.equal(resumed.x,
                                                           whole.x))
        # a two-level carry of the main path's fine level (K4)
        carries, _ = mc19.init_carries(
            torch.Generator(device=dev).manual_seed(23), 1024,
            torch.float32, dev)
        chunk = mc19._chunk(0)
        n19 = mc19._level_chunk(0)
        c1, _ = chunk(torch.tensor([1, 2], dtype=torch.int32), carries[0],
                      n19)
        save_checkpoint(f"{tmp}/k4.npz", c1)
        tmpl, _ = mc19.init_carries(
            torch.Generator(device=dev).manual_seed(24), 1024,
            torch.float32, dev)
        c1b = load_checkpoint(f"{tmp}/k4.npz", tmpl[0])
        seed = torch.tensor([3, 4], dtype=torch.int32)
        a, ya = chunk(seed, c1, n19)
        b, yb = chunk(seed, c1b, n19)
        from mlmcpathintegral_tpu_torch.utils.tree import tree_flatten
        r19["k4_resumed_chunk_equal"] = bool(torch.equal(ya, yb) and all(
            torch.equal(u, v) for u, v in zip(tree_flatten(a)[0],
                                              tree_flatten(b)[0])))
    torch.cuda.synchronize()
    r19["launches"] = {c.name: c.launches for c in ops.counters()
                       if c.launches}
    emit({"phase": "checkpoint", **r19})
    if not (r19["k3_64_plus_64_equals_128"]
            and r19["k4_resumed_chunk_equal"]):
        fail("a resumed run does not continue bit for bit")

    # ---- 20. the spatial sweeps at one rank on the card -----------------
    from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
    from mlmcpathintegral_tpu_torch.parallel import spatial
    space = chain_mesh(axis_name="space")
    gact = GFFAction(Lattice2D(256, 256, CoarseningType.BOTH), mass=1.0)
    phi = torch.randn(64, 256 * 256, generator=gen, device=dev)
    xi = torch.randn(64, 256 * 256, generator=gen, device=dev)
    gsw = spatial.make_sharded_gff_sweep(gact, space)
    r20 = {"gff_256x256_64_chains": {
        "equal_to_dense": bool(torch.equal(
            gsw(phi, xi), spatial.gff_heatbath_sweep_noise(gact, phi, xi))),
        "ms": cuda_ms(lambda: gsw(phi, xi), 5),
        "dense_ms": cuda_ms(lambda: spatial.gff_heatbath_sweep_noise(
            gact, phi, xi), 5)}}
    sact = QuenchedSchwingerAction(Lattice2D(64, 64, CoarseningType.BOTH),
                                   beta=4.0)
    theta = links(64, sact.ndof)
    noise = spatial.make_schwinger_sweep_noise(gen, sact, 64,
                                               dtype=torch.float32)
    ssw = spatial.make_sharded_schwinger_sweep(sact, space)
    r20["schwinger_64x64_64_chains"] = {
        "equal_to_dense": bool(torch.equal(
            ssw(theta, noise),
            spatial.schwinger_heatbath_sweep_noise(sact, theta, noise))),
        "ms": cuda_ms(lambda: ssw(theta, noise), 5),
        "dense_ms": cuda_ms(lambda: spatial.schwinger_heatbath_sweep_noise(
            sact, theta, noise), 5)}
    emit({"phase": "spatial", **r20})
    if not all(r["equal_to_dense"] for r in r20.values()):
        fail("a sharded sweep at one rank differs from its dense sweep")
    del phi, xi, noise, theta
    torch.cuda.empty_cache()

    # ---- 21. the scale study's launches and cut rows --------------------
    r21, failed21, k4_block, k3_block, scale_launches = scale_phase(dev,
                                                                    links)
    emit(r21)
    if failed21:
        fail("phase 21: " + "; ".join(failed21))

    # ---- 22. the hybrid draw's mixing sweep on K2 -----------------------
    r22, failed22, k2_mix, hybrid_launches = hybrid_phase(dev, root)
    emit(r22)
    if failed22:
        fail("phase 22: " + "; ".join(failed22))

    # ---- 23. the statistics kernel at the cells' records ----------------
    r23, failed23, stats_checks = stats_phase(dev)
    emit(r23)
    if failed23:
        fail("phase 23: " + "; ".join(failed23))

    # ---- the kernel table and the result line ---------------------------
    # every kernel with its launches on its own path: K3 and K4 on the
    # heat-bath main path (phase 5), K7 on path A (phase 9), K8 on path B2
    # (phase 8), K5 on path D (phase 12), K6 on path C (phase 13), K9 on
    # path E (phase 15), the probe kernels P1 and P2 on path E too (0); the
    # counter RNG (K1) is a device function inside all of
    # them, checked through its own rng_fill launcher, which no path
    # launches
    rows = []
    for counter, row, n in (
            (ops.SWEEP, sweep_row, launches[ops.SWEEP.name]),
            (ops.TWOLEVEL, tl_row, launches[ops.TWOLEVEL.name]),
            (rotor.CLUSTER, k7_row, launches_A[rotor.CLUSTER.name]),
            (rotor.SWEEP, k8_row,
             rep_b2["launches"][rotor.SWEEP.name]),
            (hmc.HMC, k5_row, rep_d["launches"][hmc.HMC.name]),
            (qtl.QM_TWOLEVEL, k6_row,
             rep_c["launches"][qtl.QM_TWOLEVEL.name]),
            (gff.SWEEP, k9_row, rep_e["launches"][gff.SWEEP.name]),
            (gff.NBSUM, p1_row, rep_e["launches"][gff.NBSUM.name])):
        rows.append({"name": counter.name, "route": "cuda",
                     "source": counter.source, "replaces": counter.replaces,
                     "launches": n, **row})
    # S: the statistics kernel, with its launches on the main path (phase
    # 5) and its times at the 8x8 c8192 trace record, the heaviest; every
    # shape of phase 23 under "records"
    s_top = stats_checks["8x8_c8192_trace"]
    rows.append({"name": ops.STATS.name, "route": "cuda",
                 "source": ops.STATS.source, "replaces": ops.STATS.replaces,
                 "launches": launches[ops.STATS.name],
                 **{key: s_top[key] for key in (
                     "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                     "bytes", "operations", "library_ms",
                     "layout")},
                 "records": {shape: {key: c[key] for key in (
                     "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                     "peak_bytes", "plain_peak_bytes")}
                     for shape, c in stats_checks.items()}})
    # P2: rng_fill's step-less mode, launched by no path
    rows.append({"name": "rng_fill (step-less)", "route": "cuda",
                 "source": "mlmcpathintegral_tpu_torch/csrc/rng_fill.cu",
                 "replaces": "tools/perf_probe.py:349",
                 "launches": rep_e["launches"][ops.RNG_FILL.name], **p2_row})
    rows[0]["also_replaces"] = "mlmcpathintegral_tpu/ops/" \
        "pallas_schwinger.py:233"   # schwinger_sweep: the same kernel
    rows[0]["ms_256x256_global"] = r14["schwinger_256x256"]["ms"]
    rows[3]["also_replaces"] = "mlmcpathintegral_tpu/ops/" \
        "pallas_rotor.py:140"       # rotor_sweep: the same kernel
    rows[2]["launches_path_B1"] = rep_b1["launches"][rotor.CLUSTER.name]
    # the qm_driver phase's launches of its path's kernels (K3, K8, K5)
    for i in (0, 3, 4):
        rows[i]["launches_qm_driver"] = qm_launches[rows[i]["name"]]
    rows[0]["launches_run_12"] = qm_rows["12_schwinger_temporal_twolevel"][
        "launches"][ops.SWEEP.name]
    rows[4]["launches_path_C"] = rep_c["launches"][hmc.HMC.name]
    # phase 21: the block branches' launches and the 16x16 scale row's
    for i, name, checks in ((0, ops.SWEEP.name, k3_block),
                            (1, ops.TWOLEVEL.name, k4_block)):
        rows[i]["launches_scale_16x16"] = scale_launches[name]
        rows[i]["block_branch"] = {
            shape: {key: c[key] for key in (
                "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                "sha256", "layout")}
            for shape, c in checks.items()}
    # phase 9 and 22: K2's launches as the hybrid draws' mixing sweep on
    # path A and on the cut 16x16 cluster row, its times at the cluster
    # rows' level-0 coarse launches
    rows[0]["launches_path_A"] = launches_A[ops.SWEEP.name]
    rows[0]["launches_cluster_16x16"] = hybrid_launches[ops.SWEEP.name]
    rows[0]["hybrid_mix"] = {
        shape: {key: c[key] for key in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "sha256",
            "layout")}
        for shape, c in k2_mix.items()}
    device_functions = [{
        "name": "CounterRng", "route": "cuda", "source": ops.RNG_FILL.source,
        "replaces": ops.RNG_FILL.replaces,
        "runs_inside": [r["name"] for r in rows
                        if r["name"] not in (hmc.HMC.name, gff.NBSUM.name,
                                             ops.STATS.name)],
        "checked_through": ops.RNG_FILL.name,
        "rng_fill_launches": launches[ops.RNG_FILL.name], **rng_row}]
    # the kernels whose global chain offset phase 17 checked, on the
    # block branches too for K3 and K4
    for r in rows:
        r["chain0"] = bool(r17.get(r["name"], {}).get("ok", False))
    rows[0]["block_branch_chain0"] = r17[BLOCK_K3]["ok"]
    rows[1]["block_branch_chain0"] = r17[BLOCK_K4]["ok"]
    for r in rows:
        if r["name"] in (hmc.HMC.name, gff.NBSUM.name, ops.STATS.name):
            r["chain0_note"] = "draws no random words: nothing to offset"
    device_functions[0]["chain0"] = r17[ops.RNG_FILL.name]["ok"]
    emit({"phase": "done", "seconds": time.monotonic() - start})
    print(card_line, flush=True)
    emit({"kernels": rows, "device_functions": device_functions})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
