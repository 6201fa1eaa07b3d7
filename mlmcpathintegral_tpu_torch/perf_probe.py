"""Device-time probe of the MLMC paths on one CUDA card.

    python -m mlmcpathintegral_tpu_torch.perf_probe [--out FILE]
        [--chunks 5] [--reps 3] [--trace FILE] [--cluster-chunks 1]
        [--qm-only] [--gff-only] [--main-only]

It builds the ``bench_schwinger_mlmc`` configuration (8x8, both-direction
coarsening, beta=4 nonperturbative, heat-bath coarse chains, 1024 chains,
f32, chunk 256), prepares its carries as ``evaluate`` does, and measures:

  steady  - ``--chunks`` chunks per level from those carries, after one
            warm chunk each, under ``torch.profiler``.  ``wall_ms`` is the
            host wall of the loop, synchronised at both ends;
            ``device_busy_ms`` is the length of the union of the kernel,
            memcpy and memset intervals in the trace, so overlapping
            device work counts once; ``idle_share`` = 1 - busy / wall.
            ``kernels`` gives the device time and count per kernel name,
            from the same intervals;
  scaling - ms per launch of the sweep-chain and two-level kernels at the
            main path's launch shapes for 256 .. 16384 chains (CUDA events
            around ``--reps`` launches after a warm one).  The fields are
            the 1024-chain carries, tiled or cut to the chain count
            (``--main-only`` stops here);
  cluster - the same configuration with hybrid cluster coarse chains
            (``bench_schwinger_mlmc(coarse="cluster")``, the unfused path):
            ``--cluster-chunks`` chunks per level after a warm one, timed
            once without the profiler (``wall_ms``) and once under it with
            device activity only (``device_busy_ms``, ``idle_share`` against
            the profiled wall, the kernel table and the share of the
            cluster kernel), and ``breakdown``: host ms of one subsampled
            coarse sample, of the pieces of one hybrid draw and of the
            batched screen of one chunk.  Its trace is parsed and deleted:
            it holds hundreds of thousands of small kernels.

  qm      - the QM paths: D (``harmonic_hmc``, ``bench_harmonic``'s HMC
            chain on the trajectory kernel) and C (``quartic_twolevel``,
            ``bench_quartic_twolevel``'s two-level run on the trajectory and
            two-level kernels), each once under the profiler (device
            activity only): the bench row's fields, then ``device_busy_ms``
            and ``idle_share`` over the profiled wall (path D: its 8
            measured chunks; path C: the whole measured call, set-up
            included, and the sampling phase alone: its four two-level
            launches against ``sampling_s``) and each kernel's device ms
            and launches.  ``--qm-only`` runs this probe alone.
  gff     - path E (``gff_heatbath``: the reference's GFF parameter file
            driven single-level through the port's QFT driver on the GFF
            sweep kernel) once under the profiler (device activity only):
            the driver's result, effective samples/s, host ms per draw,
            and over the sampling phase (its draws' device intervals
            against ``sampling_s``) the device-busy ms, idle share and
            device ms per draw, with the sweep kernel's device ms and
            launches.  ``--gff-only`` runs this probe alone.

With ``--accuracy-seeds`` it also runs :func:`cluster_accuracy` (path A
and its configuration with unfused heat-bath coarse chains at those seeds,
and the coarse samplers alone; ``--accuracy-configs`` picks among them,
``--accuracy-only`` skips the device probes).  It writes one JSON object
to ``--out`` (and the profiler's Chrome trace of the fused path to
``--trace``), and prints it.  ``bound_ms`` below is the
least time the card could take for a kernel's work, used by
``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]

N_CHAINS = 1024
SCALING_CHAINS = (256, 1024, 4096, 16384)
BUSY_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def headline_mlmc():
    """MonteCarloMultiLevel with the settings of ``bench_schwinger_mlmc``:
    the port's main path, which ``chip_smoke.py`` drives and this probe
    measures."""
    from mlmcpathintegral_tpu_torch.samplers import (
        OverrelaxedHeatBathSampler,
    )
    return _schwinger_mlmc(lambda a: OverrelaxedHeatBathSampler(
        a, n_sweep_heatbath=1, n_sweep_overrelax=1, n_burnin=100))


def headline_mlmc_cluster():
    """``bench_schwinger_mlmc(coarse="cluster")`` unchanged: the same
    configuration with the hybrid cluster coarse chains of the reference
    configuration's ``coarsesampler = 'cluster'``, which run the unfused
    path with the cluster kernel."""
    from mlmcpathintegral_tpu_torch.samplers import (
        QuenchedSchwingerClusterSampler,
    )
    return _schwinger_mlmc(lambda a: QuenchedSchwingerClusterSampler(
        a, n_burnin=20, n_updates=5, use_pallas=True))


def unfused_heatbath_mlmc():
    """The main path's configuration run unfused (``use_pallas=False``):
    heat-bath coarse chains drawn one sweep-kernel launch at a time,
    subsampled and screened by the same unfused code as path A's hybrid
    cluster chains."""
    from mlmcpathintegral_tpu_torch.samplers import (
        OverrelaxedHeatBathSampler,
    )
    return _schwinger_mlmc(lambda a: OverrelaxedHeatBathSampler(
        a, n_sweep_heatbath=1, n_sweep_overrelax=1, n_burnin=100,
        use_pallas=True), use_pallas=False)


def _schwinger_mlmc(coarse_sampler_factory, use_pallas=True):
    """8x8, both-direction coarsening, beta=4 nonperturbative, two levels,
    100 000 samples per level, chunk 256 (bench.py:414-517)."""
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        make_schwinger_conditioned_fine_action,
    )
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.mc import MonteCarloMultiLevel
    from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
    act = QuenchedSchwingerAction(
        Lattice2D(8, 8, CoarseningType.BOTH), beta=4.0,
        renormalisation=RenormalisationType.NONPERTURBATIVE)
    return MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=coarse_sampler_factory,
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=100, n_samples=100_000, chunk_size=256,
        use_pallas=use_pallas)


# -- the QM paths (bench.py's harmonic and quartic_twolevel rows) -------------

def _ref_run(run: str) -> dict:
    """One run of the C++ reference (``baselines/ref_baselines.json``);
    empty without the file."""
    try:
        return json.loads((REPO / "baselines" / "ref_baselines.json")
                          .read_text()).get("runs", {}).get(run, {})
    except (OSError, ValueError):
        return {}


def _ref_eff(run: str):
    """Effective samples/s of one run of the C++ reference times the
    host's core count (``baselines/ncores.txt``), as ``bench.py``'s
    ``_ref_eff(run, core_scaled=True)``; None without the files."""
    eff = _ref_run(run).get("eff_samples_per_sec")
    try:
        ncores = int((REPO / "baselines" / "ncores.txt").read_text().split()[0])
    except (OSError, ValueError):
        return None
    return None if eff is None else eff * ncores


def harmonic_hmc_sampler():
    """``bench_harmonic``'s model and sampler: M=64, T=4, m0=mu2=1, HMC
    with nt=20, dt=0.1, 50 burn-in draws, on the trajectory kernel."""
    from mlmcpathintegral_tpu_torch.lattice import Lattice1D
    from mlmcpathintegral_tpu_torch.models import HarmonicOscillatorAction
    from mlmcpathintegral_tpu_torch.samplers import HMCSampler
    action = HarmonicOscillatorAction(Lattice1D(64, 4.0), m0=1.0, mu2=1.0)
    return action, HMCSampler(action, nt=20, dt=0.1, n_burnin=50,
                              use_pallas=True)


def harmonic_hmc(seed=0, device="cuda", n_chains=8192, n_chunks=8,
                 steps=64, profile=False):
    """Path D, ``bench_harmonic`` (bench.py:173-247) unchanged: prepare
    (burn-in, autotune), one warm chunk of ``steps`` draws, a soft reset,
    then ``n_chunks`` chunks, each draw's mean x^2 recorded into
    Statistics("Q", 40).  Returns the bench row's fields (eff = n / (wall
    tau)) and, with ``profile``, the measured chunks' device-busy time."""
    from mlmcpathintegral_tpu_torch.qoi import qoi_x_squared
    from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
    from mlmcpathintegral_tpu_torch.utils.statistics import Statistics
    from mlmcpathintegral_tpu_torch.ops import _cuda
    from mlmcpathintegral_tpu_torch.utils.timer import sync
    device = _cuda.run_device(device)
    action, sampler = harmonic_hmc_sampler()
    qoi = qoi_x_squared(action.lattice)
    stats = Statistics("Q", 40)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.monotonic()
    state = sampler.prepare(gen, n_chains, torch.float32, device)
    sync(state)
    prepare_s = time.monotonic() - t0

    def chunk(state, st):
        for _ in range(steps):
            state, _ = sampler.draw(gen, state)
            st = stats_mod.record(st, qoi(state.x))
        return state, st

    st = stats.init(n_chains, torch.float32, device)
    state, st = chunk(state, st)
    sync(st)
    st = stats_mod.soft_reset(st)

    def measured(state, st):
        t0 = time.monotonic()
        for _ in range(n_chunks):
            state, st = chunk(state, st)
        sync(st)
        return state, st, time.monotonic() - t0

    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            state, st, wall = measured(state, st)
    else:
        state, st, wall = measured(state, st)
    n = n_chunks * steps * n_chains
    tau = stats.tau_int(st)
    avg, err = stats.average(st), stats.error(st)
    oracle = action.Xsquared_analytical()
    eff = n / wall / tau
    base = _ref_eff("harmonic_hmc")
    res = {"bench": "hmc_harmonic", "M": 64, "n_chains": n_chains,
           "nt": sampler.nt, "dt": float(state.dt), "prepare_s": prepare_s,
           "wall_s": wall, "samples_per_sec": n / wall, "tau_int": tau,
           "avg_x2": avg, "err": err, "oracle_x2": oracle,
           "sigma_dev": abs(avg - oracle) / err, "eff_samples_per_sec": eff,
           "vs_baseline": eff / base if base else None}
    return (res, prof) if profile else res


def qm_twolevel_mc(kind="quartic", n_chains=4096):
    """``bench_quartic_twolevel``'s MonteCarloTwoLevel (bench.py:606-681):
    M=64, T=4, m0=mu2=lam=x0=1, no renormalisation; coarse HMC (nt=100,
    dt=0.1, 100 burn-in draws) on the trajectory kernel; Gaussian fill;
    256 samples per chain in chunks of 64; windows 40; the fused two-level
    kernel.  ``kind="harmonic"`` takes HarmonicOscillatorAction(m0=mu2=1)
    with the same settings (path C', the analytic cross-check)."""
    from mlmcpathintegral_tpu_torch.conditioned import (
        make_conditioned_fine_action,
    )
    from mlmcpathintegral_tpu_torch.lattice import Lattice1D
    from mlmcpathintegral_tpu_torch.mc import MonteCarloTwoLevel
    from mlmcpathintegral_tpu_torch.models import (
        HarmonicOscillatorAction, QuarticOscillatorAction,
    )
    from mlmcpathintegral_tpu_torch.qoi import qoi_x_squared
    from mlmcpathintegral_tpu_torch.samplers import HMCSampler
    lat = Lattice1D(64, 4.0)
    if kind == "quartic":
        act = QuarticOscillatorAction(lat, m0=1.0, mu2=1.0, lam=1.0, x0=1.0)
    else:
        act = HarmonicOscillatorAction(lat, m0=1.0, mu2=1.0)
    return MonteCarloTwoLevel(
        act, qoi_x_squared,
        coarse_sampler_factory=lambda a: HMCSampler(
            a, nt=100, dt=0.1, n_burnin=100, use_pallas=True),
        conditioned_fine_action_factory=make_conditioned_fine_action,
        n_burnin=100, n_samples=256 * n_chains, chunk_size=64,
        n_autocorr_window=40, n_coarse_autocorr_window=40,
        n_fine_autocorr_window=40, n_delta_autocorr_window=40,
        use_pallas=True)


def quartic_twolevel(seed=14, kind="quartic", device="cuda", n_chains=4096,
                     profile=False):
    """Path C (C' with ``kind="harmonic"``), ``bench_quartic_twolevel``
    unchanged: one warm-up call at n_samples = n_chains (seed), then the
    measured call (seed + 1).  Returns the bench row's fields (eff = n_diff
    / (tau(Y) sampling_s)); the quartic fine <x^2> is held against the C++
    run's (combined sigma), the harmonic fine and coarse against their
    actions' Xsquared_analytical.  With ``profile`` the measured call runs
    under the profiler (device activity)."""
    mc = qm_twolevel_mc(kind, n_chains)
    mc.n_samples, real_n = n_chains, mc.n_samples
    mc.evaluate_difference(torch.Generator().manual_seed(seed),
                           n_chains=n_chains, device=device)
    mc.n_samples = real_n
    gen = torch.Generator().manual_seed(seed + 1)
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            stats = mc.evaluate_difference(gen, n_chains=n_chains,
                                           device=device)
    else:
        stats = mc.evaluate_difference(gen, n_chains=n_chains, device=device)
    wall = mc.timings["sampling_s"]
    fine_avg = mc.stats_fine.average(stats["fine"])
    fine_err = mc.stats_fine.error(stats["fine"])
    n_diff = mc.stats_diff.samples(stats["diff"])
    tau_d = mc.stats_diff.tau_int(stats["diff"])
    eff = n_diff / (tau_d * wall)
    res = {"bench": f"{kind}_twolevel", "M": 64, "n_chains": n_chains,
           "seed": seed, "avg_x2": fine_avg, "err": fine_err,
           "coarse_avg_x2": mc.stats_coarse.average(stats["coarse"]),
           "coarse_err": mc.stats_coarse.error(stats["coarse"]),
           "delta_avg": mc.stats_diff.average(stats["diff"]),
           "delta_var_over_fine_var": (
               mc.stats_diff.variance(stats["diff"])
               / mc.stats_fine.variance(stats["fine"])),
           "p_accept": mc.p_accept, "tau_int_delta": tau_d,
           "t_indep": mc.t_indep, "tau_slow": mc.tau_slow, "wall_s": wall,
           "wall_total_s": mc.elapsed_s, "timings": dict(mc.timings),
           "samples_per_sec": n_diff / wall,
           "eff_samples_per_sec": eff}
    if kind == "quartic":
        ref = _ref_run("quartic_twolevel").get("fine", {})
        base = _ref_eff("quartic_twolevel")
        res.update(ref_cpp_x2=ref.get("avg"), ref_cpp_err=ref.get("avg_err"),
                   sigma_dev=(abs(fine_avg - ref["avg"]) / math.hypot(
                       fine_err, ref.get("avg_err", 0.0))
                       if "avg" in ref else None),
                   vs_baseline=eff / base if base else None)
    else:
        oracles = [mc.fine_action.Xsquared_analytical(),
                   mc.coarse_action.Xsquared_analytical()]
        res.update(oracle_x2=oracles[0], coarse_oracle_x2=oracles[1],
                   sigma_dev=abs(fine_avg - oracles[0]) / fine_err,
                   coarse_sigma_dev=abs(res["coarse_avg_x2"] - oracles[1])
                   / res["coarse_err"], vs_baseline=None)
    return (res, prof) if profile else res


def _profile_summary(prof, wall_s, named, last=None):
    """Device-busy ms, idle share over ``wall_s`` and per-name device ms
    and launches of a profiler run (device activity).  ``last`` = (name,
    k, phase_s): also the device ms of that kernel's last k launches and
    the idle share they leave in a phase of ``phase_s`` host seconds."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        ivals = device_intervals(path)
    busy = union_ms([(s, e) for _, s, e in ivals])
    out = {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
           "idle_share": 1.0 - busy / (wall_s * 1e3),
           "device_events": len(ivals)}
    for sub in named:
        sel = [(e - s) / 1e3 for name, s, e in sorted(
            ivals, key=lambda iv: iv[1]) if sub in name]
        out[sub] = {"device_ms": sum(sel), "launches": len(sel),
                    "ms_per_launch": sum(sel) / len(sel) if sel else None}
        if last is not None and last[0] == sub:
            k_ms = sum(sel[-last[1]:])
            out[sub].update(last_launches=last[1], last_device_ms=k_ms,
                            phase_ms=last[2] * 1e3,
                            phase_idle_share=1.0 - k_ms / (last[2] * 1e3))
    return out


def qm_probe():
    """Paths D and C once each under the profiler (module docstring)."""
    from mlmcpathintegral_tpu_torch import ops
    res = {}
    ops.reset_counters()
    row, prof = harmonic_hmc(profile=True)
    res["path_D"] = {**row, **_profile_summary(
        prof, row["wall_s"], ("hmc_trajectory",)),
        "k5_launches": ops.HMC.launches}
    ops.reset_counters()
    row, prof = quartic_twolevel(profile=True)
    # the sampling phase: 256 samples per chain in chunks of 64
    n_sampling = -(-256 // 64)
    res["path_C"] = {**row, **_profile_summary(
        prof, row["wall_total_s"], ("hmc_trajectory", "qm_twolevel"),
        last=("qm_twolevel", n_sampling, row["timings"]["sampling_s"])),
        "k5_launches": ops.HMC.launches,
        "k6_launches": ops.QM_TWOLEVEL.launches}
    return res


# -- path E: the GFF heat bath through the QFT driver ------------------------

PATH_E_CONFIG = REPO / "baselines" / "configs" / "ref_qft_gff_twolevel.in"
PATH_E_CHAINS, PATH_E_DRAWS = 4096, 512


def gff_path_e_config():
    """Path E's configuration: the reference's GFF parameter file
    (``baselines/configs/ref_qft_gff_twolevel.in``: 16x16, mass 10,
    coarsening 'rotate', heat bath 1 overrelax + 1 heat-bath sweep with
    100 burn-in draws, single-level burn-in 1000, statistics window 100)
    driven with ``method = 'singlelevel'``, ``heatbath: use_pallas =
    true`` and 4096 f32 chains (the chain count of the JAX package's GFF
    kernel probe).  One cut: ``n_samples`` = 4096 x 512 in place of the
    file's 10 000 (at 4096 chains that would be 3 draws a chain, too few
    to time)."""
    from mlmcpathintegral_tpu_torch.utils.config import read_parameter_file
    cfg = read_parameter_file(PATH_E_CONFIG)
    cfg["general"]["method"] = "singlelevel"
    cfg["heatbath"]["use_pallas"] = True
    cfg["parallel"] = {"n_chains": PATH_E_CHAINS, "dtype": "float32"}
    cfg["singlelevelmc"]["n_samples"] = PATH_E_CHAINS * PATH_E_DRAWS
    return cfg


def gff_heatbath(seed=0, device="cuda", profile=False):
    """Path E through ``drivers.qft.run`` (its report captured, not
    printed).  Returns the driver's result with eff_samples_per_sec = n /
    (tau_int(phi^2) sampling_s) (the scope of the JAX package's GFF kernel
    probe) and host_ms_per_draw = sampling_s / sampling draws; with
    ``profile`` the run is traced (device activity) and the sampling
    phase's device-busy ms, idle share and device ms per draw are added
    (``_phase_summary``)."""
    import contextlib
    import io
    import warnings

    from mlmcpathintegral_tpu_torch.drivers.qft import run
    cfg = gff_path_e_config()
    out = io.StringIO()
    prof = None
    with contextlib.redirect_stdout(out), warnings.catch_warnings():
        # the file's heatbath.random_order, which a coloured sweep ignores
        warnings.simplefilter("ignore", UserWarning)
        if profile:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as tprofile
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                res = run(cfg, device=device, seed=seed)
        else:
            res = run(cfg, device=device, seed=seed)
    sampling_s = res["timings"]["sampling_s"]
    res.update(eff_samples_per_sec=res["samples"] / (res["tau_int"]
                                                     * sampling_s),
               host_ms_per_draw=sampling_s * 1e3 / res["sampling_draws"],
               report_tail=out.getvalue().splitlines()[-3:])
    if profile:
        res.update(_phase_summary(prof, "gff_sweep", res["sampling_draws"],
                                  sampling_s))
    return res


def _phase_summary(prof, name_sub, n_last, phase_s):
    """Device activity of a phase that starts with the last ``n_last``
    launches of the kernel named ``name_sub``: the union of every device
    interval from the first of them on (busy ms), the idle share it
    leaves in ``phase_s`` host seconds, device ms per launch of the
    phase, and the kernel's own device ms and launches in it."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        ivals = sorted(device_intervals(path), key=lambda iv: iv[1])
    mine = [(s, e) for name, s, e in ivals if name_sub in name]
    t0 = mine[-n_last][0]
    phase = [(s, e) for _, s, e in ivals if s >= t0]
    busy = union_ms(phase)
    k_ms = sum(e - s for s, e in mine[-n_last:]) / 1e3
    return {"phase_device_busy_ms": busy,
            "phase_idle_share": 1.0 - busy / (phase_s * 1e3),
            "device_ms_per_draw": busy / n_last,
            "phase_device_events": len(phase),
            f"{name_sub}_device_ms": k_ms, f"{name_sub}_launches": n_last,
            f"{name_sub}_ms_per_launch": k_ms / n_last,
            "run_device_events": len(ivals)}


def gff_probe():
    """Path E once under the profiler (module docstring)."""
    from mlmcpathintegral_tpu_torch import ops
    ops.reset_counters()
    row = gff_heatbath(profile=True)
    return {"path_E": {**row, "k9_launches": ops.GFF_SWEEP.launches,
                       "k9_plain_cuda_calls": ops.GFF_SWEEP.plain_cuda_calls}}


def union_ms(intervals) -> float:
    """Total length (ms) of the union of (start_us, end_us) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def device_intervals(trace_path: Path):
    """(name, start_us, end_us) of every device event in a Chrome trace
    written by ``torch.profiler``."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    return [(ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
            for ev in events
            if ev.get("ph") == "X" and ev.get("cat") in BUSY_CATEGORIES]


def steady_state(mc, carries, carry_L, seed_gen, n_chunks, trace_path,
                 cpu_activity=True, unprofiled=False, named=()):
    """Profile ``n_chunks`` chunks per level after one warm chunk each
    (with ``unprofiled``, time as many chunks without the profiler
    first); ``named``: substrings of kernel names whose device ms and
    count are totalled under ``named``."""
    from torch.profiler import ProfilerActivity, profile

    L = mc.n_level
    chunks = [mc._chunk(ell) for ell in range(L)]
    n_active = [mc._level_chunk(ell) for ell in range(L)]

    def seed():
        return torch.randint(-2**31, 2**31 - 1, (2,), generator=seed_gen,
                             dtype=torch.int32)

    def run(carries, carry_L, n):
        for _ in range(n):
            carry_L, _ = chunks[-1](seed(), carry_L, n_active[-1])
            for ell in range(L - 2, -1, -1):
                carries[ell], _ = chunks[ell](seed(), carries[ell],
                                              n_active[ell])
        return carries, carry_L

    def timed(n):
        t0 = time.perf_counter()
        out = run(carries, carry_L, n)
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    carries, carry_L = run(carries, carry_L, 1)
    torch.cuda.synchronize()
    res = {"chunks_per_level": n_chunks}
    if unprofiled:
        (carries, carry_L), res["wall_unprofiled_ms"] = timed(n_chunks)
    activities = [ProfilerActivity.CUDA]
    if cpu_activity:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        (carries, carry_L), wall_ms = timed(n_chunks)
    prof.export_chrome_trace(str(trace_path))
    ivals = device_intervals(trace_path)
    busy_ms = union_ms([(s, e) for _, s, e in ivals])
    per_name = {}
    for name, s, e in ivals:
        ms, n = per_name.get(name, (0.0, 0))
        per_name[name] = (ms + (e - s) / 1e3, n + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    res.update(wall_ms=wall_ms, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms,
               device_events=len(ivals),
               kernels=[{"name": k[:120], "device_ms": v[0], "count": v[1]}
                        for k, v in top[:12]],
               named={sub: [sum(v[i] for k, v in per_name.items()
                                if sub in k) for i in (0, 1)]
                      for sub in named})
    return res


def cuda_ms(fn, reps, warm=True):
    """Mean device milliseconds of ``fn()`` over ``reps`` calls (CUDA
    events around the whole run), after one warm-up call unless ``warm``
    is False (the caller has just run ``fn``)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_device_ms(fn, reps, name_sub):
    """(mean device ms of one kernel launch, launches seen) for the
    kernels whose name holds ``name_sub``, over ``reps`` calls of ``fn()``
    under ``torch.profiler`` after a warm one: the kernel's own time,
    without the host's launch overhead, which CUDA events around
    back-to-back short launches include.  (None, 0) when the profiler saw
    no such kernel."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        ivals = [(s, e) for name, s, e in device_intervals(path)
                 if name_sub in name]
    if not ivals:
        return None, 0
    return sum(e - s for s, e in ivals) / 1e3 / len(ivals), len(ivals)


#: the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s
#: and float32 operations/s outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


def bound_ms(nbytes, nops):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes a kernel must move over the memory rate and the
    operations it does over the f32 rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def host_ms(fn, reps):
    """Mean host milliseconds of ``fn()`` over ``reps`` calls, the device
    synchronised at both ends (eager code that reads back to the host)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def cluster_breakdown(mc, carries, gen, reps=20):
    """Host ms of the pieces of the hybrid-cluster fine level's chunk: one
    subsampled coarse sample and, within one hybrid draw, the cluster
    kernel call, the link reconstruction, the mix sweeps (the sweep
    kernel) and the path rebuild; then the batched screen of one chunk of
    coarse samples."""
    from mlmcpathintegral_tpu_torch.mc.twolevel import (
        make_batched_screen, make_coarse_subsampler,
    )
    from mlmcpathintegral_tpu_torch.samplers.cluster import ClusterState
    sampler = mc.coarse_samplers[0]
    cstate, tl, _, st_cs, _, t_accum = carries[0]
    sub = make_coarse_subsampler(sampler, mc.qois[1])
    xcs = []

    def sample():
        nonlocal cstate, st_cs, t_accum
        cstate, st_cs, t_accum = sub(gen, cstate, st_cs, t_accum)
        xcs.append(cstate.x)
    sample()
    t0 = float(t_accum[0])
    res = {"coarse_sample_ms": host_ms(sample, mc.chunk_size - 1),
           "draws_per_coarse_sample": (float(t_accum[0]) - t0)
           / (mc.chunk_size - 1)}
    x, psi = cstate.x, cstate.psi
    pieces = {
        "cluster_update": lambda: sampler.cluster.draw(
            gen, ClusterState(x=psi)),
        "reconstruct": lambda: sampler._reconstruct(gen, psi),
        "mix_sweeps": lambda: sampler.mix(gen, x),
        "psi_from_links": lambda: sampler._psi_from_links(gen, x),
        "draw": lambda: sampler.draw(gen, cstate)}
    res["draw_pieces_ms"] = {k: host_ms(f, reps) for k, f in pieces.items()}
    screen = make_batched_screen(
        mc.actions[0], mc.actions[1],
        mc.twolevel_steps[0].conditioned_fine_action, mc.qois[0],
        mc.qois[1])
    xs = torch.stack(xcs)
    res["screen_ms"] = host_ms(lambda: screen(gen, tl, xs), 1)
    res["screen_samples"] = xs.shape[0]
    return res


def cluster_probe(n_chunks, trace_path):
    """The hybrid-cluster configuration's steady state (see the module
    docstring); the trace file is deleted after parsing."""
    from mlmcpathintegral_tpu_torch.ops.rotor import CLUSTER
    dev = torch.device("cuda", 0)
    mc = headline_mlmc_cluster()
    gen = torch.Generator().manual_seed(3)
    t0 = time.perf_counter()
    carries, carry_L = mc.init_carries(
        torch.Generator(device=dev).manual_seed(3), N_CHAINS,
        torch.float32, dev)
    prepare_s = time.perf_counter() - t0
    res = steady_state(mc, carries, carry_L, gen, n_chunks, trace_path,
                       cpu_activity=False, unprofiled=True,
                       named=("rotor_cluster",))
    trace_path.unlink(missing_ok=True)
    k7_ms, k7_count = res["named"]["rotor_cluster"]
    res["breakdown"] = cluster_breakdown(
        mc, carries, torch.Generator(device=dev).manual_seed(4))
    res.update(prepare_s=prepare_s, cluster_kernel_device_ms=k7_ms,
               cluster_kernel_launches=k7_count,
               cluster_kernel_share_of_busy=k7_ms / res["device_busy_ms"],
               cluster_kernel_name=CLUSTER.name)
    return res


ACCURACY_CONFIGS = {"path_A": headline_mlmc_cluster,
                    "unfused_heatbath": unfused_heatbath_mlmc}


def cluster_accuracy(seeds, configs=("path_A", "unfused_heatbath",
                                     "samplers"),
                     n_draws=2500, n_chains=4096):
    """Accuracy of the hybrid-cluster configuration beyond chip_smoke's one
    seed.  At each seed, the estimate with each level's mean against its
    exact value (E[Y_0] = chi_f - chi_c, E[Y_1] = chi_c) of path A
    ("path_A") and of the same configuration with heat-bath coarse chains
    on the same unfused path ("unfused_heatbath", which tells a fault of
    the unfused subsampling and screen from one of the hybrid sampler).
    With "samplers", the coarse samplers alone on the coarsest action
    (chi_t per draw after 200 burn-in draws, the error from the spread of
    the independent chains' means): the hybrid sampler through the
    cluster kernel (f32) and through the plain cluster update (f64), and
    the heat bath through the sweep kernel (f32)."""
    import math

    from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
    from mlmcpathintegral_tpu_torch.samplers import (
        OverrelaxedHeatBathSampler, QuenchedSchwingerClusterSampler,
    )
    dev = torch.device("cuda", 0)
    out = {}
    for name in configs:
        if name not in ACCURACY_CONFIGS:
            continue
        out[name] = []
        for seed in seeds:
            mc = ACCURACY_CONFIGS[name]()
            t0 = time.perf_counter()
            st = mc.evaluate(torch.Generator().manual_seed(seed),
                             n_chains=N_CHAINS, device=dev)
            wall = time.perf_counter() - t0
            exact = [mc.actions[0].chit_exact()
                     - mc.actions[1].chit_exact(),
                     mc.actions[1].chit_exact()]
            num, err = mc.numerical_result(), mc.statistical_error()
            levels = []
            for ell in range(2):
                avg = mc.stats_qoi[ell].average(st[ell])
                e = mc.stats_qoi[ell].error(st[ell])
                levels.append({"avg": avg, "err": e, "exact": exact[ell],
                               "z": (avg - exact[ell]) / e})
            out[name].append({
                "seed": seed, "chit": num, "err": err,
                "z": (num - mc.actions[0].chit_exact()) / err,
                "levels": levels, "wall_s": wall})
    if "samplers" not in configs:
        return out
    act = headline_mlmc_cluster().actions[1]
    q = qoi_2d_susceptibility(act)
    samplers = {
        "hybrid_kernel_f32": (QuenchedSchwingerClusterSampler(
            act, n_burnin=20, n_updates=5, use_pallas=True), torch.float32),
        "hybrid_plain_f64": (QuenchedSchwingerClusterSampler(
            act, n_burnin=20, n_updates=5), torch.float64),
        "heatbath_kernel_f32": (OverrelaxedHeatBathSampler(
            act, n_burnin=100, use_pallas=True), torch.float32)}
    for i, (name, (s, dtype)) in enumerate(samplers.items()):
        g = torch.Generator(device=dev).manual_seed(i + 1)
        state = s.prepare(g, n_chains, dtype, dev)
        tot = torch.zeros(n_chains, dtype=torch.float64, device=dev)
        for k in range(n_draws + 200):
            state, _ = s.draw(g, state)
            if k >= 200:
                tot += q(s.x_of(state)).double()
        per_chain = tot / n_draws
        chi = float(per_chain.mean())
        err = float(per_chain.std()) / math.sqrt(n_chains)
        out[name] = {"chit": chi, "err": err, "exact": act.chit_exact(),
                     "z": (chi - act.chit_exact()) / err}
    return out


def scaling(mc, carries, carry_L, reps):
    """ms per launch of both kernels at the main path's launch shapes."""
    from mlmcpathintegral_tpu_torch.ops.schwinger import schwinger_sweep_chain
    from mlmcpathintegral_tpu_torch.ops.schwinger_twolevel import (
        schwinger_twolevel_chain,
    )
    act, cact = mc.actions[0], mc.actions[-1]
    lat, clat = act.lattice, cact.lattice
    t_sub, chunk = mc._t_sub[0], mc._level_chunk(0)
    cstate, tl = carries[0][0], carries[0][1]
    x_L = carry_L[0].x

    def tile(x, C):
        reps_ = -(-C // x.shape[0])
        return x.repeat(reps_, *([1] * (x.dim() - 1)))[:C].contiguous()

    rows = []
    for C in SCALING_CHAINS:
        xL = tile(x_L, C)
        args = (tile(tl.theta, C), tile(cstate.x, C), tile(tl.S_fine, C),
                tile(tl.S_cond, C))
        k3 = cuda_ms(lambda: schwinger_sweep_chain(
            xL, (5, 6), beta=cact.beta, Mt=clat.Mt_lat, Mx=clat.Mx_lat,
            n_steps=mc._level_chunk(mc.n_level - 1) * mc._t_sub[-1],
            with_energy=True), reps)
        k4 = cuda_ms(lambda: schwinger_twolevel_chain(
            *args, (1, 2), beta=act.beta, beta_c=cact.beta, Mt=lat.Mt_lat,
            Mx=lat.Mx_lat, n_steps=chunk, t_sub=t_sub), reps)
        rows.append({"chains": C, "sweep_chain_ms": k3,
                     "twolevel_chain_ms": k4})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/perf_probe.json")
    ap.add_argument("--trace", default="chiprun_out/perf_probe_trace.json")
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--cluster-chunks", type=int, default=1)
    ap.add_argument("--accuracy-seeds", type=int, nargs="*", default=[],
                    help="also run cluster_accuracy at these seeds")
    ap.add_argument("--accuracy-configs", nargs="+",
                    default=["path_A", "unfused_heatbath", "samplers"],
                    help="what cluster_accuracy runs")
    ap.add_argument("--accuracy-only", action="store_true",
                    help="run cluster_accuracy alone, no device probes")
    ap.add_argument("--qm-only", action="store_true",
                    help="run the QM paths' probe (qm) alone")
    ap.add_argument("--gff-only", action="store_true",
                    help="run path E's probe (gff) alone")
    ap.add_argument("--main-only", action="store_true",
                    help="run the main path's probes (steady, scaling) "
                         "alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("perf_probe: no CUDA device")
    out, trace = Path(args.out), Path(args.trace)
    out.parent.mkdir(parents=True, exist_ok=True)
    trace.parent.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    if args.accuracy_only or args.qm_only or args.gff_only:
        res = {"card": smi, "torch": torch.__version__}
        if args.accuracy_only:
            res["cluster_accuracy"] = cluster_accuracy(
                args.accuracy_seeds, args.accuracy_configs)
        if args.qm_only:
            res["qm"] = qm_probe()
        if args.gff_only:
            res["gff"] = gff_probe()
        out.write_text(json.dumps(res, indent=1))
        print(json.dumps(res))
        return 0

    mc = headline_mlmc()
    gen = torch.Generator().manual_seed(args.seed)
    setup_gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    carries, carry_L = mc.init_carries(setup_gen, N_CHAINS, torch.float32,
                                       dev)
    prepare_s = time.perf_counter() - t0
    res = {"card": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "n_chains": N_CHAINS,
           "t_sub": list(mc._t_sub), "prepare_s": prepare_s,
           "steady": steady_state(mc, carries, carry_L, gen, args.chunks,
                                  trace),
           "scaling": scaling(mc, carries, carry_L, args.reps)}
    if not args.main_only:
        res.update(cluster=cluster_probe(
                       args.cluster_chunks,
                       trace.with_name(trace.stem + "_cluster.json")),
                   qm=qm_probe(), gff=gff_probe())
    if args.accuracy_seeds:
        res["cluster_accuracy"] = cluster_accuracy(args.accuracy_seeds,
                                                   args.accuracy_configs)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
