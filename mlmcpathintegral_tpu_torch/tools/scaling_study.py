"""Scaling measurements on the port (the counterpart of the JAX package's
``tools/scaling_study.py``).

Two modes:

  --chains  Chain-count-vs-throughput curve of the fused kernels on the
            card (1k -> 16k chains) at the JAX tool's launch (8x8,
            beta=4, beta_c=1.06, 256 steps, t_sub=4): samples/s of the
            two-level kernel (K4) and link updates/s of the sweep-chain
            kernel (K3), each launch timed with CUDA events over 4
            repetitions after a warm one.

  --mesh    Weak scaling of the chain-sharded Schwinger two-level method
            (``MonteCarloTwoLevel.evaluate_difference(mesh=)``, unfused
            heat-bath coarse chains, f64) over 1, 2 and 4 gloo ranks on
            the CPU at a fixed per-rank chain count, then a control at a
            fixed total chain count.  Indicative of the sharding and
            collective overhead only: the ranks share the host's cores, so
            absolute throughput is not a device's, and the quantity of
            interest is wall(n)/wall(1) (ideal 1.0).  The chain axis is
            embarrassingly parallel, so deviations are partitioning
            overhead.

A failed run is not retried.

Usage:
  python -m mlmcpathintegral_tpu_torch.tools.scaling_study --chains \\
      --csv docs/h100/chain_scaling.csv
  python -m mlmcpathintegral_tpu_torch.tools.scaling_study --mesh \\
      --csv mesh_scaling_cpu.csv
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import tempfile
import time

import numpy as np
import torch

CHAIN_COUNTS = (1024, 2048, 4096, 8192, 16384)
MESH_RANKS = (1, 2, 4)


def run_chain_scaling(chain_counts=CHAIN_COUNTS, n_steps=256, reps=4,
                      device="cuda"):
    """The JAX tool's table, one row per chain count, and beside it the
    launch layouts of the two kernels (on the card) at each count."""
    from mlmcpathintegral_tpu_torch.ops import _cuda
    from mlmcpathintegral_tpu_torch.ops.schwinger import (
        schwinger_sweep_chain, sweep_launch,
    )
    from mlmcpathintegral_tpu_torch.ops.schwinger_twolevel import (
        schwinger_twolevel_chain, twolevel_launch,
    )
    device = _cuda.run_device(device)
    on_card = device.type == "cuda"
    rng = np.random.RandomState(0)
    rows, layouts = [], {}
    for C in chain_counts:
        xf = torch.as_tensor(rng.uniform(-3, 3, (C, 128)).astype(np.float32),
                             device=device)
        xc = torch.as_tensor(rng.uniform(-3, 3, (C, 32)).astype(np.float32),
                             device=device)
        s0 = torch.zeros(C, dtype=torch.float32, device=device)

        def tl():
            return schwinger_twolevel_chain(
                xf, xc, s0, s0, (1, 2), beta=4.0, beta_c=1.06, Mt=8, Mx=8,
                n_steps=n_steps, t_sub=4)

        def sw():
            return schwinger_sweep_chain(xf, (1, 2), beta=4.0, Mt=8, Mx=8,
                                         n_steps=n_steps)

        w_tl, w_sw = timed(tl, reps, on_card), timed(sw, reps, on_card)
        rows.append({
            "n_chains": C,
            "twolevel_samples_per_sec": round(n_steps * C / w_tl, 1),
            "twolevel_us_per_sample": round(w_tl / (n_steps * C) * 1e6, 4),
            "sweep_link_updates_per_sec": round(128 * n_steps * C / w_sw,
                                                1),
            "sweep_wall_s": round(w_sw, 4),
        })
        print(rows[-1], flush=True)
        if on_card:
            layouts[C] = {
                "twolevel": twolevel_launch(8, 8, C),
                "sweep": sweep_launch(8, 8, C, _cuda.max_smem_optin(
                    device.index or 0))}
    # the card saturates near 1k chains: report throughput relative to the
    # peak aggregate rate (about 1.0 once saturated) and a saturated flag
    peak = max(r["twolevel_samples_per_sec"] for r in rows)
    for r in rows:
        r["throughput_vs_peak"] = round(
            r["twolevel_samples_per_sec"] / peak, 3)
        r["saturated"] = int(r["throughput_vs_peak"] >= 0.95)
    return rows, layouts


def timed(fn, reps, on_card):
    """Seconds a call of ``fn``: one warm call, then ``reps`` calls between
    two CUDA events (the host clock on the CPU)."""
    fn()
    if not on_card:
        t0 = time.monotonic()
        for _ in range(reps):
            fn()
        return (time.monotonic() - t0) / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / reps


def _mesh_mc(n_samples, chunk_size):
    """The JAX tool's two-level method: 8x8 Schwinger, both-direction
    coarsening, beta=4 nonperturbative, heat-bath coarse chains."""
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        make_schwinger_conditioned_fine_action,
    )
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.mc import MonteCarloTwoLevel
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
    return MonteCarloTwoLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: OverrelaxedHeatBathSampler(
            a, n_sweep_heatbath=1, n_sweep_overrelax=1, n_burnin=20),
        conditioned_fine_action_factory=(
            make_schwinger_conditioned_fine_action),
        n_burnin=20, n_samples=n_samples, chunk_size=chunk_size)


def _mesh_rank(rank, world, store, out_dir, n_chains, n_samples,
               chunk_size):
    """One rank of a mesh row: the two-level run over the world's chain
    mesh, timed from a barrier to its end; rank 0 writes the wall."""
    import torch.distributed as dist

    from mlmcpathintegral_tpu_torch.parallel import chain_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    try:
        mc = _mesh_mc(n_samples, chunk_size)
        dist.barrier()
        t0 = time.monotonic()
        mc.evaluate_difference(torch.Generator().manual_seed(0),
                               n_chains=n_chains, dtype=torch.float64,
                               device="cpu", mesh=chain_mesh())
        dist.barrier()
        wall = time.monotonic() - t0
        if rank == 0:
            with open(os.path.join(out_dir, "wall.json"), "w") as fh:
                json.dump({"wall_s": wall}, fh)
    finally:
        dist.destroy_process_group()


def mesh_wall(world, n_chains, n_samples, chunk_size, timeout_s=1800.0):
    """Wall seconds of the two-level run on ``world`` gloo ranks of the
    CPU (spawned, joined; killed past ``timeout_s``)."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _mesh_rank, args=(world, f"{tmp}/store", tmp, n_chains,
                              n_samples, chunk_size),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"a world of {world} ranks did not "
                                   f"finish within {timeout_s} s")
        with open(os.path.join(tmp, "wall.json")) as fh:
            return json.load(fh)["wall_s"]


def run_mesh_scaling(per_rank_chains=256, chunk_size=32, n_chunks=4,
                     total_chains_control=1024, ranks=MESH_RANKS):
    """Two tables over gloo ranks of the CPU.

    mode=weak     fixed chains a rank; the ranks share the host's cores,
                  so the efficiency mixes host contention with
                  partitioning overhead.
    mode=control  fixed total chains (and samples) over every rank count:
                  the total host work is constant, so any wall growth with
                  the rank count is partitioning and collective overhead.
    """
    rows = []
    for mode in ("weak", "control"):
        table = []
        for W in ranks:
            C = per_rank_chains * W if mode == "weak" \
                else total_chains_control
            n = chunk_size * n_chunks * C
            wall = mesh_wall(W, C, n, chunk_size)
            table.append({"mode": mode, "n_devices": W, "n_chains": C,
                          "per_device_chains": C // W, "n_samples": n,
                          "wall_s": round(wall, 3),
                          "samples_per_sec": round(n / wall, 1)})
            print(table[-1], flush=True)
        for r in table:
            r["weak_efficiency"] = round(table[0]["wall_s"] / r["wall_s"],
                                         3)
        rows += table
    return rows


def main(argv=None):
    from mlmcpathintegral_tpu_torch.tools import write_csv
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--chains", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="--chains: cuda (the kernels) or cpu (their plain "
                         "versions)")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows = []
    if args.mesh:
        rows = run_mesh_scaling()
    elif args.chains:
        rows, layouts = run_chain_scaling(device=args.device)
        if layouts:
            print("layouts (lanes a chain, chains a block, shared bytes, "
                  "branch):", json.dumps(layouts), flush=True)
    if args.csv and rows:
        write_csv(args.csv, rows)
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
