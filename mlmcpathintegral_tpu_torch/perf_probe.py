"""Device-time probe of the fused MLMC path on one CUDA card.

    python -m mlmcpathintegral_tpu_torch.perf_probe [--out FILE]
        [--chunks 5] [--reps 3] [--trace FILE]

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
            the 1024-chain carries, tiled or cut to the chain count.

It writes one JSON object to ``--out`` (and the profiler's Chrome trace
to ``--trace``), and prints it.
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
    from mlmcpathintegral_tpu_torch.samplers import (
        OverrelaxedHeatBathSampler,
    )
    act = QuenchedSchwingerAction(
        Lattice2D(8, 8, CoarseningType.BOTH), beta=4.0,
        renormalisation=RenormalisationType.NONPERTURBATIVE)
    return MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: OverrelaxedHeatBathSampler(
            a, n_sweep_heatbath=1, n_sweep_overrelax=1, n_burnin=100),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=100, n_samples=100_000, chunk_size=256)


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


def steady_state(mc, carries, carry_L, seed_gen, n_chunks, trace_path):
    """Profile ``n_chunks`` chunks per level after one warm chunk each."""
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

    carries, carry_L = run(carries, carry_L, 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carries, carry_L = run(carries, carry_L, n_chunks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(trace_path))
    ivals = device_intervals(trace_path)
    busy_ms = union_ms([(s, e) for _, s, e in ivals])
    per_name = {}
    for name, s, e in ivals:
        ms, n = per_name.get(name, (0.0, 0))
        per_name[name] = (ms + (e - s) / 1e3, n + 1)
    top = sorted(per_name.items(), key=lambda kv: -kv[1][0])
    return {"chunks_per_level": n_chunks, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels": [{"name": k[:120], "device_ms": v[0], "count": v[1]}
                        for k, v in top[:12]]}


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
    out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
