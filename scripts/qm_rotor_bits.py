#!/usr/bin/env python3
"""The HMC trajectory and rotor sweep kernels of one tree of the port at
their paths' launches, for comparing two trees bit for bit and in time on
one card.

    python scripts/qm_rotor_bits.py [--tree DIR] [--reps N] [--scaling]

DIR is the root of a checkout whose ``mlmcpathintegral_tpu_torch`` is
imported and built (default: the checkout holding this script), so a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists can be run beside this one:

    python scripts/qm_rotor_bits.py --tree .scratch/parent

It prints one JSON line with:
  - K5 (``hmc_trajectory``) at path D's launch (8192 chains, M=64, nt=20,
    spacing 4/64) for the harmonic, quartic and rotor actions, and at path
    C's coarse launch (4096 chains, M=32, nt=100, spacing 4/32, quartic).
    The paths are made with numpy from fixed seeds and equilibrated by 30
    trajectories of the plain version on the card (numpy momenta and
    uniforms), so both trees start the compared launch from the same bits
    and some chains reject.  For each, the sha256 of x_out and accept, the
    accept rate, and the ms of one launch: CUDA events (mean of N launches
    after a warm one) and the profiler's device time;
  - K8 (``rotor_sweep_chain``) at path B2's launch (M=256, 4096 chains,
    128 steps, I/a = 16, k_rej = 8) from uniform paths, and one
    ``rotor_sweep`` of the same paths: the sha256 of the final paths and
    the winding-sum trace, and the ms;
  - each kernel's layout, registers and resident warps where the tree
    reports them, and for K5 the registers and local bytes of the warp
    branch at every sites-a-lane count it builds;
  - with ``--scaling``, each kernel's ms a launch from 128 to 16 384
    chains (K5 at both launches' shapes, by the profiler's device time, as
    its launches are shorter than the host takes to issue them; K8 at 16
    steps, CUDA events, in full and without the rounds past the first
    (k_rej=1), the overrelaxation or the heat bath), which tells a
    latency-bound launch (flat in the chains) from a throughput-bound one
    and where K8's time goes;
  - the paths as controls: path D's effective
    samples/s (``perf_probe.harmonic_hmc``), path C's effective samples/s
    and prepare seconds (``perf_probe.quartic_twolevel``), path B2's wall
    of 8 chunks of 128 steps from cluster-equilibrated paths and a warm
    chunk, with chi_t beside chit_exact, and the main path's chi_t bits and
    effective samples/s (``perf_probe.headline_mlmc``; it launches neither
    kernel);
  - the card's name and power limit (nvidia-smi).
It needs one CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

QM = dict(m0=1.0, mu2=1.0, lam=1.0, x0=1.0)
KINDS = {"harmonic": dict(m0=1.0, mu2=1.0), "quartic": QM,
         "rotor": dict(m0=1.0)}
#: (name, chains, sites, nt, spacing, kinds): path D's launch and path C's
#: coarse-chain launch (coarse spacing 2a = 4/32)
K5_LAUNCHES = (("path_D", 8192, 64, 20, 4.0 / 64, sorted(KINDS)),
               ("path_C_coarse", 4096, 32, 100, 4.0 / 32, ["quartic"]))
B_M, B_C, B_STEPS, B_T, B_I = 256, 4096, 128, 4.0, 0.25


def digest(tensors):
    """sha256 (16 hex digits) of each tensor's bytes and of all of them."""
    total = hashlib.sha256()
    each = []
    for t in tensors:
        b = t.detach().contiguous().cpu().numpy().tobytes()
        each.append(hashlib.sha256(b).hexdigest()[:16])
        total.update(b)
    return each, total.hexdigest()[:16]


def on_card(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def k5_inputs(hmc, C, M, nt, a, kind, seed, dev):
    """(x, p, u) of the compared launch: x from numpy, equilibrated by 30
    plain trajectories on the card with numpy momenta and uniforms."""
    rs = np.random.default_rng(seed)
    kw = dict(kind=kind, a_lat=a, nt=nt, **KINDS[kind])
    dt = torch.tensor(0.1, device=dev)
    x = on_card(0.5 * rs.standard_normal((C, M)) + KINDS[kind].get("x0", 0),
                dev)
    for _ in range(30):
        x, _ = hmc.hmc_trajectory_plain(
            x, on_card(rs.standard_normal((C, M)), dev),
            on_card(rs.uniform(size=C), dev), dt, **kw)
    p = on_card(rs.standard_normal((C, M)), dev)
    u = on_card(rs.uniform(size=C), dev)
    return x, p, u, dt, kw


def k5_launch(hmc, name, C, M):
    """The tree's launch layout and attributes of the trajectory kernel."""
    out = {}
    if hasattr(hmc, "hmc_launch"):
        out["layout"] = dict(zip(("branch", "lanes_per_chain",
                                  "sites_per_lane", "chains_per_block",
                                  "smem_bytes"), hmc.hmc_launch(M, C)))
        out["attrs"] = {k: hmc.hmc_attrs(M, C, k) for k in KINDS}
    else:
        out["layout"] = dict(zip(("threads_per_chain", "chains_per_block",
                                  "smem_bytes"), hmc.hmc_smem_bytes(M, C)))
    return out


def register_limit(_cuda, hmc):
    """Registers and local bytes a thread of the warp branch at every
    sites-a-lane count it builds (128 threads a block)."""
    if not hasattr(hmc, "hmc_attrs"):
        return None
    sites = [s for s in (1, 2, 4, 8, 16, 32) if s <= hmc.SITES_MAX]
    return {kind: {s: _cuda.kernel_attrs("mlmc_hmc_trajectory_attrs", 128,
                                         hmc.KINDS[kind], s, 0)
                   for s in sites} for kind in KINDS}


def k8_inputs(C, M, seed, dev):
    rs = np.random.default_rng(seed)
    return on_card(rs.uniform(-math.pi, math.pi, (C, M)), dev)


def k8_layout(_cuda, rotor, C, M):
    if hasattr(rotor, "sweep_attrs"):
        return {"layout": dict(zip(
                    ("chains_per_block", "smem_bytes", "table_words"),
                    rotor.sweep_launch(M, C, _cuda.max_smem_optin(0)))),
                "attrs": rotor.sweep_attrs(M, C)}
    return {"layout": dict(zip(("threads_per_chain", "chains_per_block",
                                "smem_bytes"),
                               rotor.sweep_smem_bytes(M, C)))}


def scaling(hmc, rotor, probe, dev):
    k5, k8 = {}, {}
    for C in (128, 256, 512, 1024, 2048, 4096, 8192, 16384):
        row = {}
        for name, _, M, nt, a, kinds in K5_LAUNCHES:
            kind = kinds[0] if name == "path_C_coarse" else "harmonic"
            x, p, u, dt, kw = k5_inputs(hmc, C, M, nt, a, kind, 11, dev)
            row[name] = probe.kernel_device_ms(
                lambda: hmc.hmc_trajectory(x, p, u, dt, **kw), 20, "hmc")[0]
        k5[C] = row
        xB = k8_inputs(C, B_M, 12, dev)
        kw = dict(kappa=B_I / (B_T / B_M), M=B_M, n_steps=16)
        k8[C] = {nm: probe.cuda_ms(lambda: rotor.rotor_sweep_chain(
                     xB, (5, 6), **kw, **v), 3)
                 for nm, v in (("full", {}), ("k_rej_1", dict(k_rej=1)),
                               ("heatbath_only", dict(n_overrelax=0)),
                               ("overrelax_only", dict(n_heatbath=0)))}
    return {"K5_ms": k5, "K8_ms_16_steps": k8}


def path_b2(ops, dev):
    """Path B2 as ``chip_smoke.py`` phase 8 drives it: the heat bath on the
    sweep kernel (bench_rotor_cluster_M(256)'s rotor) started from paths
    that the cluster sampler equilibrated (the heat bath alone hardly
    changes a winding number at this spacing), a warm chunk, then 8 chunks
    of 128 steps timed, chi_t from their winding sums."""
    from mlmcpathintegral_tpu_torch.lattice import Lattice1D
    from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
    from mlmcpathintegral_tpu_torch.samplers import ClusterSampler
    from mlmcpathintegral_tpu_torch.samplers.heatbath import (
        HeatBathState, OverrelaxedHeatBathSampler,
    )
    from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
    from mlmcpathintegral_tpu_torch.utils.statistics import Statistics
    act = RotorAction(Lattice1D(B_M, B_T), m0=B_I)
    start = ClusterSampler(act, n_burnin=100, n_updates=10,
                           use_pallas=True).prepare(
        torch.Generator(device=dev).manual_seed(3), B_C, torch.float32, dev)
    sampler = OverrelaxedHeatBathSampler(act, use_pallas=True)
    g = torch.Generator(device=dev).manual_seed(21)
    state, _ = sampler.draw_chain(g, HeatBathState(x=start.x), B_STEPS)
    st = Statistics("chi_t", 40)
    ss = st.init(B_C, torch.float32, dev)
    ops.reset_counters()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(8):
        state, w = sampler.draw_chain(g, state, B_STEPS)
        ss = stats_mod.record_many(ss, w * w / (4.0 * math.pi ** 2 * B_T))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    num, err = st.average(ss), st.error(ss)
    oracle = act.chit_exact()
    return {"wall_8_chunks_s": wall, "chit": repr(num), "err": repr(err),
            "chit_exact": oracle, "sigma_dev": abs(num - oracle) / err,
            "tau_int": st.tau_int(ss),
            "launches": {c.name: c.launches for c in ops.counters()
                         if c.launches}}


def main_path(ops, probe):
    mc = probe.headline_mlmc()
    ops.reset_counters()
    stats = mc.evaluate(torch.Generator().manual_seed(2), n_chains=1024,
                        dtype=torch.float32, device="cuda")
    num, err = mc.numerical_result(), mc.statistical_error()
    oracle = mc.actions[0].chit_exact()
    tau0 = mc.stats_qoi[0].tau_int(stats[0])
    n0 = mc.stats_qoi[0].samples(stats[0])
    wall = mc.timings["cost_measure_s"] + mc.timings["sampling_s"]
    return {"chit": repr(num), "err": repr(err),
            "sigma_dev": abs(num - oracle) / err, "method_wall_s": wall,
            "eff_samples_per_sec": n0 / (tau0 * wall),
            "launches": {c.name: c.launches for c in ops.counters()
                         if c.launches}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--scaling", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qm_rotor_bits: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch import perf_probe as probe
    from mlmcpathintegral_tpu_torch.ops import _cuda
    from mlmcpathintegral_tpu_torch.ops import hmc
    from mlmcpathintegral_tpu_torch.ops import rotor
    assert Path(ops.__file__).resolve().is_relative_to(tree)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.monotonic()
    so, nvcc_s = _cuda.build()
    _cuda.load_library()
    out = {"tree": str(tree), "card": smi, "library": so.name,
           "nvcc_seconds": nvcc_s,
           "build_and_load_seconds": time.monotonic() - t0}

    # K5: path D's and path C's coarse launches
    k5 = {"register_limit": register_limit(_cuda, hmc)}
    for i, (name, C, M, nt, a, kinds) in enumerate(K5_LAUNCHES):
        k5[name] = k5_launch(hmc, name, C, M)
        for j, kind in enumerate(kinds):
            x, p, u, dt, kw = k5_inputs(hmc, C, M, nt, a, kind,
                                        100 * i + j, dev)
            res = hmc.hmc_trajectory(x, p, u, dt, **kw)
            torch.cuda.synchronize()
            each, total = digest(res)
            launch = lambda: hmc.hmc_trajectory(  # noqa: E731
                x, p, u, dt, **kw)
            ms_dev, seen = probe.kernel_device_ms(launch, args.reps,
                                                  "hmc")
            k5[name][kind] = {
                "launch": dict(chains=C, M=M, nt=nt, a=a, dt=0.1),
                "outputs": ["x_out", "accept"], "sha256": each,
                "sha256_all": total,
                "accept_rate": float(res[1].double().mean()),
                "ms_cuda_events": probe.cuda_ms(launch, args.reps),
                "ms_device": ms_dev, "profiled_launches": seen}
    out["K5"] = k5

    # K8: path B2's launch and one rotor_sweep
    kappa = B_I / (B_T / B_M)
    xB = k8_inputs(B_C, B_M, 7, dev)
    bkw = dict(kappa=kappa, M=B_M, n_steps=B_STEPS)
    res = rotor.rotor_sweep_chain(xB, (5, 6), **bkw)
    torch.cuda.synchronize()
    each, total = digest(res)
    k8 = {"launch": dict(chains=B_C, k_rej=8, **bkw),
          "outputs": ["x", "wsum"], "sha256": each, "sha256_all": total,
          "ms_cuda_events": probe.cuda_ms(
              lambda: rotor.rotor_sweep_chain(xB, (5, 6), **bkw),
              max(3, args.reps // 4)),
          **k8_layout(_cuda, rotor, B_C, B_M)}
    one = rotor.rotor_sweep(xB, (7, 9), kappa=kappa, M=B_M)
    torch.cuda.synchronize()
    sweep = lambda: rotor.rotor_sweep(xB, (7, 9), kappa=kappa,  # noqa: E731
                                      M=B_M)
    k8["rotor_sweep"] = {"sha256": digest([one])[1],
                         "ms_cuda_events": probe.cuda_ms(sweep, args.reps),
                         "ms_device": probe.kernel_device_ms(
                             sweep, args.reps, "rotor_sweep")[0]}
    out["K8"] = k8

    if args.scaling:
        out["scaling"] = scaling(hmc, rotor, probe, dev)
    ops.reset_counters()
    ctl = {"path_D": probe.harmonic_hmc(device=dev)}
    ops.reset_counters()
    ctl["path_C"] = probe.quartic_twolevel(device=dev)
    ctl["path_B2"] = path_b2(ops, dev)
    ctl["main_path"] = main_path(ops, probe)
    out["controls"] = ctl
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
