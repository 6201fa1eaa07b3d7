#!/usr/bin/env python3
"""The Schwinger kernels of one tree of the port at the main path's
launches, for comparing two trees bit for bit and in time on one card.

    python scripts/schwinger_bits.py [--tree DIR] [--reps N] [--path-a]
                                      [--scaling]

DIR is the root of a checkout whose ``mlmcpathintegral_tpu_torch`` is
imported and built (default: the checkout holding this script), so a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists can be run beside this one:

    python scripts/schwinger_bits.py --tree .scratch/parent

It prints one JSON line with:
  - K3 (``schwinger_sweep_chain``) at the main path's coarsest-level
    launch: 4x4, the main path's beta_c, 1024 chains, n_steps=2048, with
    energy; K4 (``schwinger_twolevel_chain``) at its fine-level launch:
    8x8, beta=4, that beta_c, 1024 chains, n_steps=256, t_sub=8.  Inputs
    are made with numpy from fixed seeds (links uniform on [-pi, pi), the
    cached actions from the tree's own actions).  For each, the sha256 of
    every output's bytes and of all of them, the ms of one launch (CUDA
    events, mean of N launches after a warm one), and the kernels' layout,
    registers and resident warps where the tree reports them;
  - the main path (``perf_probe.headline_mlmc``, as ``chip_smoke.py``
    phase 5 drives it): chi_t with its error as exact decimal strings,
    sigma from ``chit_exact()``, the method wall and eff samples/s;
  - with ``--path-a``, path A (``perf_probe.headline_mlmc_cluster``) the
    same way: a control that launches neither kernel;
  - with ``--scaling``, each kernel's ms a launch from 128 to 16 384
    chains on fields drawn the same way (K3: 256 draws; full, overrelax
    only, heat bath only, k_rej=1; K4: 32 steps at t_sub 8 and 1, and at
    t_sub 1 with k_rej_bessel 1 and 48), which tells a latency-bound launch
    (flat in the chains) from a throughput-bound one (linear);
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

SEED_K3, SEED_K4 = (5, 6), (1, 2)
CHAINS = 1024


def digest(tensors):
    """sha256 of each tensor's bytes and of all of them in order."""
    total = hashlib.sha256()
    each = []
    for t in tensors:
        b = t.detach().contiguous().cpu().numpy().tobytes()
        each.append(hashlib.sha256(b).hexdigest()[:16])
        total.update(b)
    return each, total.hexdigest()[:16]


def cuda_ms(fn, reps):
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


def links(rs, C, n, dev):
    return torch.from_numpy(rs.uniform(-math.pi, math.pi, (C, n))
                            .astype(np.float32)).to(dev)


def drive(mc, dev):
    """One evaluate of a multilevel method on the card, as chip_smoke.py
    phase 5 drives it."""
    stats = mc.evaluate(torch.Generator().manual_seed(2), n_chains=CHAINS,
                        dtype=torch.float32, device=dev)
    num, err = mc.numerical_result(), mc.statistical_error()
    oracle = mc.actions[0].chit_exact()
    tau0 = mc.stats_qoi[0].tau_int(stats[0])
    n0 = mc.stats_qoi[0].samples(stats[0])
    wall = mc.timings["cost_measure_s"] + mc.timings["sampling_s"]
    return {"chit": repr(num), "err": repr(err),
            "sigma_dev": abs(num - oracle) / err, "method_wall_s": wall,
            "eff_samples_per_sec": n0 / (tau0 * wall),
            "timings_s": mc.timings}


def scaling(sw, tl, fine_act, cond, beta, beta_c, dev):
    """ms a launch of K3 and K4 against the chain count, in variants that
    take out parts of the work."""
    rs = np.random.default_rng(7)
    k3, k4 = {}, {}
    for C in (128, 256, 512, 1024, 2048, 4096, 8192, 16384):
        th = links(rs, C, 32, dev)
        kw = dict(beta=beta_c, Mt=4, Mx=4, n_steps=256, with_energy=True)
        k3[C] = {nm: cuda_ms(lambda: sw.schwinger_sweep_chain(
                     th, SEED_K3, **kw, **v), 3)
                 for nm, v in (("full", {}),
                               ("overrelax_only", dict(n_heatbath=0)),
                               ("heatbath_only", dict(n_overrelax=0)),
                               ("k_rej_1", dict(k_rej=1)))}
        if C > 4096:
            continue
        f = links(rs, C, 128, dev)
        c = links(rs, C, 32, dev)
        sf = fine_act.evaluate(f.cpu()).to(torch.float32).to(dev)
        sq = cond.evaluate(f.cpu()).to(torch.float32).to(dev)
        kw = dict(beta=beta, beta_c=beta_c, Mt=8, Mx=8, n_steps=32)
        k4[C] = {nm: cuda_ms(lambda: tl.schwinger_twolevel_chain(
                     f, c, sf, sq, SEED_K4, **kw, **v), 3)
                 for nm, v in (("t_sub_8", dict(t_sub=8)),
                               ("t_sub_1", dict(t_sub=1)),
                               ("t_sub_1_k_rej_bessel_1",
                                dict(t_sub=1, k_rej_bessel=1)),
                               ("t_sub_1_k_rej_bessel_48",
                                dict(t_sub=1, k_rej_bessel=48)))}
    return {"K3_ms_256_draws": k3, "K4_ms_32_steps": k4}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--path-a", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("schwinger_bits: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        QuenchedSchwingerConditionedFineAction,
    )
    from mlmcpathintegral_tpu_torch.ops import _cuda
    from mlmcpathintegral_tpu_torch.ops import schwinger as sw
    from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as tl
    from mlmcpathintegral_tpu_torch.perf_probe import (
        headline_mlmc, headline_mlmc_cluster,
    )
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

    mc = headline_mlmc()
    fine_act, coarse_act = mc.actions[0], mc.actions[-1]
    beta, beta_c = fine_act.beta, coarse_act.beta
    rs = np.random.default_rng(20240611)

    # K3: the coarsest level's launch
    th = links(rs, CHAINS, 32, dev)
    kw3 = dict(beta=beta_c, Mt=4, Mx=4, n_steps=2048, with_energy=True)
    res = sw.schwinger_sweep_chain(th, SEED_K3, **kw3)
    torch.cuda.synchronize()
    each, total = digest(res)
    k3 = {"launch": dict(chains=CHAINS, **kw3), "outputs": ["theta", "q",
                                                            "e"],
          "sha256": each, "sha256_all": total,
          "ms": cuda_ms(lambda: sw.schwinger_sweep_chain(th, SEED_K3, **kw3),
                        args.reps)}
    if hasattr(sw, "sweep_attrs"):
        k3["layout"] = sw.sweep_launch(4, 4, CHAINS,
                                       _cuda.max_smem_optin(0))
        k3["attrs"] = sw.sweep_attrs(4, 4, CHAINS)

    # K4: the fine level's launch
    fine = links(rs, CHAINS, 128, dev)
    coarse = links(rs, CHAINS, 32, dev)
    cond = QuenchedSchwingerConditionedFineAction(fine_act)
    fine_cpu = fine.cpu()
    sf = fine_act.evaluate(fine_cpu).to(torch.float32).to(dev)
    sq = cond.evaluate(fine_cpu).to(torch.float32).to(dev)
    kw4 = dict(beta=beta, beta_c=beta_c, Mt=8, Mx=8, n_steps=256, t_sub=8)
    res = tl.schwinger_twolevel_chain(fine, coarse, sf, sq, SEED_K4, **kw4)
    torch.cuda.synchronize()
    each, total = digest(res)
    k4 = {"launch": dict(chains=CHAINS, **kw4),
          "outputs": ["theta_fine", "theta_coarse", "S_fine", "S_cond", "y",
                      "qc", "ec", "acc"],
          "sha256": each, "sha256_all": total,
          "accept_rate": float(res[7].mean()),
          "ms": cuda_ms(lambda: tl.schwinger_twolevel_chain(
              fine, coarse, sf, sq, SEED_K4, **kw4), args.reps)}
    if hasattr(tl, "twolevel_attrs"):
        k4["layout"] = tl.twolevel_launch(8, 8, CHAINS)
        k4["attrs"] = tl.twolevel_attrs(8, 8, CHAINS)
    out.update(K3=k3, K4=k4)

    ops.reset_counters()
    out["main_path"] = drive(mc, dev)
    out["main_path"]["launches"] = {c.name: c.launches
                                    for c in ops.counters() if c.launches}
    if args.path_a:
        ops.reset_counters()
        out["path_A"] = drive(headline_mlmc_cluster(), dev)
    if args.scaling:
        out["scaling"] = scaling(sw, tl, fine_act, cond, beta, beta_c, dev)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
