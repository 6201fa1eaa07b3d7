"""Device-time probe of the MLMC paths on one CUDA card.

    python -m mlmcpathintegral_tpu_torch.perf_probe [--out FILE]
        [--chunks 5] [--reps 3] [--trace FILE] [--cluster-chunks 1]

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
            the 1024-chain carries, tiled or cut to the chain count;
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
import subprocess
import time
from pathlib import Path

import torch

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
    kernel call, the link reconstruction, the two mix sweeps and the path
    rebuild; then the batched screen of one chunk of coarse samples."""
    from mlmcpathintegral_tpu_torch.mc.twolevel import (
        make_batched_screen, make_coarse_subsampler,
    )
    from mlmcpathintegral_tpu_torch.samplers.cluster import ClusterState
    sampler = mc.coarse_samplers[0]
    act = sampler.action
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
        "overrelax_sweep": lambda: act.overrelaxation_sweep(x),
        "heatbath_sweep": lambda: act.heatbath_sweep(gen, x),
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
    if args.accuracy_only:
        res = {"card": smi, "torch": torch.__version__,
               "cluster_accuracy": cluster_accuracy(
                   args.accuracy_seeds, args.accuracy_configs)}
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
           "scaling": scaling(mc, carries, carry_L, args.reps),
           "cluster": cluster_probe(
               args.cluster_chunks,
               trace.with_name(trace.stem + "_cluster.json"))}
    if args.accuracy_seeds:
        res["cluster_accuracy"] = cluster_accuracy(args.accuracy_seeds,
                                                   args.accuracy_configs)
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
