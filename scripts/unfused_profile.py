#!/usr/bin/env python3
"""Where an unfused Schwinger MLMC level's time goes on one CUDA card: the
hybrid cluster coarse draws and the batched screen of one tree of the
port, for comparing two trees on one card.

    python scripts/unfused_profile.py [--tree DIR] [--configs path_A row128]
        [--samples N] [--evaluate] [--out FILE]

DIR is the root of a checkout whose ``mlmcpathintegral_tpu_torch`` is
imported and built (default: the checkout holding this script), so a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists can be run beside this one.  The configurations,
each at 1024 f32 chains, level 0:

  path_A - ``perf_probe.headline_mlmc_cluster`` (8x8, beta 4, two levels,
           hybrid cluster coarse chains on 4x4);
  row128 - the 128x128 row of the scale study with hybrid cluster coarse
           chains (``tools.schwinger_scale_study.make_mlmc``, beta 256,
           three levels): level 0 draws on 64x64 and screens on 128x128.

For each: the carries as ``evaluate`` prepares them, one warm chunk of the
level (``--warm-chunk`` samples, so the subsample clock has a history),
then N subsampled coarse samples through the tree's own subsampler and
chunk generator, timed on the host (the card synchronised at both ends)
and once more under ``torch.profiler`` (device activity only): host ms and
device-busy ms a draw and a sample, the idle share, the top kernels, the
host reads a sample (synchronising calls counted by
``torch.cuda.set_sync_debug_mode``); the host ms of the pieces of one
hybrid draw (cluster update, link reconstruction, mixing sweeps, path
rebuild, clock record); then the batched screen of those N samples, timed
and profiled the same way; and the share of a 256-sample chunk each takes.
With ``--evaluate`` it also runs path A's whole ``evaluate`` at each of
``--evaluate-seeds`` (default seed 2 at 100 000 samples a level, as
``chip_smoke.py`` phase 9; ``--evaluate-samples 1000000
--evaluate-seeds 2 3 4`` are ``bench.py``'s ``schwinger_mlmc_cluster``
cells): chi and each level's mean against their exact values, the timings
and each kernel's launches.  ``--configs`` with no name skips the
profiles.  It prints one
JSON object and writes it to ``--out``.  It needs one CUDA card and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch


def synced_ms(fn, reps=1):
    """Host ms of ``fn()`` a call, the card synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def profiled(fn, intervals_of, union_ms):
    """(host ms, device-busy ms, top kernels) of ``fn()`` under the
    profiler, device activity only."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = synced_ms(fn)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        ivals = intervals_of(path)
    per = {}
    for name, s, e in ivals:
        ms, n = per.get(name, (0.0, 0))
        per[name] = (ms + (e - s) / 1e3, n + 1)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:8]
    return wall, union_ms([(s, e) for _, s, e in ivals]), [
        {"name": k[:100], "device_ms": v[0], "count": v[1]} for k, v in top]


def host_reads(fn):
    """Synchronising calls (host reads of the card) made by ``fn()``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def build(config):
    from mlmcpathintegral_tpu_torch.perf_probe import headline_mlmc_cluster
    from mlmcpathintegral_tpu_torch.tools.schwinger_scale_study import (
        make_mlmc, scale_beta,
    )
    if config == "path_A":
        return headline_mlmc_cluster()
    return make_mlmc(128, 128, beta=scale_beta(128), coarse="cluster")


def profile_level0(config, dev, n_samples, warm_chunk):
    from mlmcpathintegral_tpu_torch.mc import twolevel
    from mlmcpathintegral_tpu_torch.perf_probe import (
        device_intervals, union_ms,
    )
    from mlmcpathintegral_tpu_torch.samplers.cluster import ClusterState
    from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
    mc = build(config)
    C = 1024
    t0 = time.perf_counter()
    carries, _ = mc.init_carries(torch.Generator(device=dev).manual_seed(3),
                                 C, torch.float32, dev)
    torch.cuda.synchronize()
    out = {"config": config, "chains": C, "prepare_s":
           time.perf_counter() - t0}
    # one warm chunk of the level, recording nothing: the clock's history
    mc.chunk_size = warm_chunk
    t0 = time.perf_counter()
    carries[0], _ = mc._chunk(0)((7, 8), carries[0], 0)
    torch.cuda.synchronize()
    out["warm_chunk"] = {"samples": warm_chunk,
                         "s": time.perf_counter() - t0}
    sampler = mc.coarse_samplers[0]
    sub = twolevel.make_coarse_subsampler(sampler, mc.qois[1])
    screen = twolevel.make_batched_screen(
        mc.actions[0], mc.actions[1],
        mc.twolevel_steps[0].conditioned_fine_action, mc.qois[0],
        mc.qois[1])
    cstate, tl, _, st_cs, _, t_acc = carries[0]
    gen = twolevel.chunk_generator((11, 12), dev)
    state = {"c": cstate, "s": st_cs, "t": t_acc, "x": []}

    def samples(n):
        def go():
            for _ in range(n):
                state["c"], state["s"], state["t"] = sub(
                    gen, state["c"], state["s"], state["t"])
                state["x"].append(sampler.x_of(state["c"]))
        return go

    samples(2)()
    state["x"].clear()
    reads_sample = host_reads(samples(1))
    state["x"].clear()
    t_before = float(state["t"][0])
    wall = synced_ms(samples(n_samples))
    draws = float(state["t"][0]) - t_before
    state["x"].clear()
    t_before = float(state["t"][0])
    p_wall, busy, top = profiled(samples(n_samples), device_intervals,
                                 union_ms)
    p_draws = float(state["t"][0]) - t_before
    coarse = {"samples": n_samples, "draws": draws,
              "draws_per_sample": draws / n_samples,
              "host_ms_per_sample": wall / n_samples,
              "host_ms_per_draw": wall / draws,
              "host_reads_per_sample": reads_sample,
              "profiled_host_ms_per_draw": p_wall / p_draws,
              "device_busy_ms_per_draw": busy / p_draws,
              "idle_share": 1.0 - busy / p_wall, "top_kernels": top}
    x, psi = state["c"].x, state["c"].psi
    act = sampler.action
    mix = getattr(sampler, "mix", None)
    pieces = {
        "cluster_update": lambda: sampler.cluster.draw(
            gen, ClusterState(x=psi)),
        "reconstruct": lambda: sampler._reconstruct(gen, psi),
        "mix_sweeps": (lambda: mix(gen, x)) if mix is not None else (
            lambda: act.heatbath_sweep(gen, act.overrelaxation_sweep(x))),
        "psi_from_links": lambda: sampler._psi_from_links(gen, x),
        "clock_record_and_read": lambda: (
            stats_mod.record(state["s"], sampler.subsample_observable(x)),
            int(torch.ceil(2.0 * stats_mod.tau_int_device(state["s"])))),
        "draw": lambda: sampler.draw(gen, state["c"])}
    coarse["draw_pieces_host_ms"] = {k: synced_ms(f, 10)
                                     for k, f in pieces.items()}
    coarse["host_reads_per_draw"] = host_reads(pieces["draw"])
    out["coarse"] = coarse
    xcs = torch.stack(state["x"])
    state["x"].clear()
    s_wall = synced_ms(lambda: screen(gen, tl, xcs))
    reads_screen = host_reads(lambda: screen(gen, tl, xcs))
    sp_wall, s_busy, s_top = profiled(lambda: screen(gen, tl, xcs),
                                      device_intervals, union_ms)
    out["screen"] = {"samples": n_samples, "host_ms": s_wall,
                     "host_ms_per_sample": s_wall / n_samples,
                     "host_reads": reads_screen,
                     "device_busy_ms": s_busy,
                     "idle_share": 1.0 - s_busy / sp_wall,
                     "top_kernels": s_top}
    chunk_coarse = 256 * coarse["host_ms_per_sample"]
    chunk_screen = 256 * out["screen"]["host_ms_per_sample"]
    out["chunk_256_host_ms"] = {
        "coarse": chunk_coarse, "screen": chunk_screen,
        "coarse_share": chunk_coarse / (chunk_coarse + chunk_screen)}
    return out


def evaluate_path_a(dev, seed=2, n_samples=100_000):
    """Path A's whole ``evaluate`` at ``n_samples`` a level: chi, each
    level's mean beside its exact value (E[Y_0] = chi_f - chi_c, E[Y_1] =
    chi_c), timings and launches."""
    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch.perf_probe import headline_mlmc_cluster
    mc = headline_mlmc_cluster()
    mc.n_samples = n_samples
    ops.reset_counters()
    t0 = time.perf_counter()
    stats = mc.evaluate(torch.Generator().manual_seed(seed), n_chains=1024,
                        dtype=torch.float32, device=dev)
    wall_s = time.perf_counter() - t0
    num, err = mc.numerical_result(), mc.statistical_error()
    oracle = mc.actions[0].chit_exact()
    tau0 = mc.stats_qoi[0].tau_int(stats[0])
    n0 = mc.stats_qoi[0].samples(stats[0])
    wall = mc.timings["cost_measure_s"] + mc.timings["sampling_s"]
    exact = [oracle - mc.actions[1].chit_exact(),
             mc.actions[1].chit_exact()]
    levels = []
    for ell in range(2):
        avg = mc.stats_qoi[ell].average(stats[ell])
        e = mc.stats_qoi[ell].error(stats[ell])
        levels.append({"avg": avg, "err": e, "exact": exact[ell],
                       "sigma_dev": (avg - exact[ell]) / e})
    return {"seed": seed, "n_samples": n_samples, "wall_s": wall_s,
            "chit": num, "err": err, "sigma_dev": (num - oracle) / err,
            "levels": levels, "reliable": mc.reliable,
            "tau_int_Y0": tau0, "method_wall_s": wall,
            "eff_samples_per_sec": n0 / (tau0 * wall),
            "cost_per_sample_us": mc.cost_per_sample,
            "timings_s": mc.timings,
            "launches": {c.name: c.launches for c in ops.counters()},
            "plain_calls_on_cuda": {c.name: c.plain_cuda_calls
                                    for c in ops.counters()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--configs", nargs="*", default=["path_A", "row128"])
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--warm-chunk", type=int, default=64)
    ap.add_argument("--evaluate", action="store_true")
    ap.add_argument("--evaluate-seeds", type=int, nargs="+", default=[2])
    ap.add_argument("--evaluate-samples", type=int, default=100_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("unfused_profile: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch.ops import _cuda
    assert Path(ops.__file__).resolve().is_relative_to(tree)
    _cuda.build()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    res = {"tree": str(tree), "card": card, "torch": torch.__version__}
    for config in args.configs:
        t0 = time.perf_counter()
        res[config] = profile_level0(config, dev, args.samples,
                                     args.warm_chunk)
        res[config]["probe_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    if args.evaluate:
        res["path_A_evaluate"] = [
            evaluate_path_a(dev, seed, args.evaluate_samples)
            for seed in args.evaluate_seeds]
    text = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
