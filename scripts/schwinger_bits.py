#!/usr/bin/env python3
"""The Schwinger kernels of one tree of the port at the main path's
launches, for comparing two trees bit for bit and in time on one card.

    python scripts/schwinger_bits.py [--tree DIR] [--reps N] [--path-a]
                                      [--scaling] [--block [--teams]]
                                      [--skip-main]

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
  - with ``--block``, the block branches of K3, K2 and K4 (fields beyond
    the warp design) at the launches ``BLOCK_LAUNCHES`` lists: the scale
    study's (``chip_smoke.py`` phase 21's and the rows' own fine and
    coarsest launches at 1024 chains), the hybrid draw's mixing sweep
    (phase 22's and 64x64 at 1024 chains), and three controls off those
    paths (an exact-fill K4 block at beta 4, an odd-sized K3 field, K3's
    largest field in shared memory, 128x128).  For
    each, the sha256 of every output, the ms of a launch (CUDA events,
    the mean over launches filling 20 ms, after the launch whose bits
    are hashed), its layout, registers and
    resident warps, and its bound (``chip_smoke.py``'s work counts, the
    rejection rounds counted on the plain version over the launch's first
    16 chains and a short run); with ``--teams`` (a tree with the team
    design) also every team size the block design takes at that launch,
    the chosen one too, each hashed (the bits equal the chosen one's) and
    timed twice, in ascending and then descending order; ``--skip-main``
    leaves out the main path's launches and run below;
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


#: --block: (name, kernel, M, chains, launch keywords); unless the
#: keywords set beta, or ``beta_of`` (the scale study's row and level of
#: ``chip_smoke.scale_betas``), it is the scale study's M x M row's beta
#: (K4), its level-1 beta_c (K2: the hybrid draw's level-0 coarse lattice
#: of the 2M x 2M row) or its coarsest beta (K3: the coarsest level of the
#: 4M x 4M row); K3 at 64x64 is the 128x128 row's unfused fine level's
#: coarse chain, a draw a launch
BLOCK_LAUNCHES = (
    ("K3 16x16 phase 21", "K3", 16, 64, dict(n_steps=4)),
    ("K3 32x32 phase 21", "K3", 32, 128, dict(n_steps=4)),
    ("K3 16x16 1024 chains", "K3", 16, 1024, dict(n_steps=64)),
    ("K3 32x32 1024 chains", "K3", 32, 1024, dict(n_steps=64)),
    ("K3 64x64 1024 chains", "K3", 64, 1024,
     dict(n_steps=1, beta_of=(128, 1))),
    ("K3 20x12 control", "K3", (20, 12), 64, dict(n_steps=8, beta=2.0)),
    ("K3 128x128 control", "K3", 128, 64, dict(n_steps=4, beta=16.0)),
    ("K2 32x32 phase 22", "K2", 32, 256, {}),
    ("K2 64x64 phase 22", "K2", 64, 256, {}),
    ("K2 64x64 1024 chains", "K2", 64, 1024, {}),
    ("K4 32x32 phase 21", "K4", 32, 256, dict(n_steps=16, t_sub=4)),
    ("K4 64x64 phase 21", "K4", 64, 256, dict(n_steps=16, t_sub=4)),
    ("K4 32x32 1024 chains t_sub 8", "K4", 32, 1024,
     dict(n_steps=256, t_sub=8)),
    ("K4 32x32 1024 chains t_sub 100", "K4", 32, 1024,
     dict(n_steps=81, t_sub=100)),
    ("K4 64x64 1024 chains t_sub 8", "K4", 64, 1024,
     dict(n_steps=256, t_sub=8)),
    ("K4 64x64 1024 chains t_sub 100", "K4", 64, 1024,
     dict(n_steps=81, t_sub=100)),
    ("K4 32x32 exact fill control", "K4", 32, 256,
     dict(n_steps=8, t_sub=2, beta=4.0)),
)


def events_ms(fn, reps):
    """Mean ms of ``reps`` launches by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_ms(fn, window_ms=20.0):
    """ms of one launch (the caller has run one already): one launch sets
    the count, then the mean over enough launches to fill ``window_ms``,
    one at least, so a short launch is timed over hundreds."""
    probe = events_ms(fn, 1)
    return events_ms(fn, max(1, math.ceil(window_ms / max(probe, 1e-3))))


def block_launch(kind, M, C, kw, dev, sw, tl):
    """(launch function, plain version on chains [0, c) for a short run,
    layout function, work function of the rejection rounds, the launch's
    keywords) of one --block launch, on inputs drawn with numpy from a
    seed of the launch."""
    import chip_smoke
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        QuenchedSchwingerConditionedFineAction,
    )
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral_tpu_torch.ops import _cuda
    Mx, Mt = (M, M) if isinstance(M, int) else M
    kw = dict(kw)
    rs = np.random.default_rng(Mx * 1000 + Mt * 10 + C)
    if kind in ("K3", "K2"):
        row, level = kw.pop("beta_of", (4 * Mx, 2) if kind == "K3"
                            else (2 * Mx, 1))
        if "beta" not in kw:
            kw["beta"] = chip_smoke.scale_betas(row)[level]
        th = links(rs, C, 2 * Mx * Mt, dev)
        n_steps = kw.pop("n_steps", 1)
        geo = dict(Mt=Mt, Mx=Mx)

        def layout():
            return (sw.sweep_launch(Mt, Mx, C, _cuda.max_smem_optin(0)),
                    sw.sweep_attrs(Mt, Mx, C))
        if kind == "K2":
            def run():
                return sw.schwinger_sweep(th, (Mx, 6), **geo, **kw)

            def plain(c):
                return sw.schwinger_sweep_chain_plain(
                    th[:c], (Mx, 6), **geo, n_steps=1, **kw)

            def work(r, _):
                return chip_smoke.work_k2(C, Mx, Mt, r)
        else:
            def run():
                return sw.schwinger_sweep_chain(
                    th, (Mx, 4), **geo, n_steps=n_steps, with_energy=True,
                    **kw)

            def plain(c):
                return sw.schwinger_sweep_chain_plain(
                    th[:c], (Mx, 4), **geo, n_steps=min(n_steps, 2),
                    with_energy=True, **kw)

            def work(r, _):
                return chip_smoke.work_k3(C, Mx, Mt, n_steps, r)
        return run, plain, layout, work, kw
    beta = kw.pop("beta", None)
    if beta is None:
        beta, beta_c, _ = chip_smoke.scale_betas(Mx)
    else:
        beta_c = QuenchedSchwingerAction(
            Lattice2D(Mx, Mt, CoarseningType.BOTH), beta=beta,
            renormalisation=RenormalisationType.NONPERTURBATIVE
        ).coarse_action().beta
    act = QuenchedSchwingerAction(Lattice2D(Mx, Mt, CoarseningType.BOTH),
                                  beta=beta)
    cond = QuenchedSchwingerConditionedFineAction(act)
    fine = links(rs, C, 2 * Mx * Mt, dev)
    coarse = links(rs, C, Mx * Mt // 2, dev)
    sf = act.evaluate(fine.cpu()).to(torch.float32).to(dev)
    sq = cond.evaluate(fine.cpu()).to(torch.float32).to(dev)
    kw.update(beta=beta, beta_c=beta_c, Mt=Mt, Mx=Mx)

    def run():
        return tl.schwinger_twolevel_chain(fine, coarse, sf, sq, (Mx, 21),
                                           **kw)

    def plain(c):
        short = dict(kw, n_steps=1, t_sub=min(kw["t_sub"], 2))
        return tl.schwinger_twolevel_chain_plain(
            fine[:c], coarse[:c], sf[:c], sq[:c], (Mx, 21), **short)

    def layout():
        return tl.twolevel_launch(Mt, Mx, C), tl.twolevel_attrs(Mt, Mx, C)

    def work(r, r_bessel):
        return chip_smoke.work_k4(C, Mx, Mt, kw["n_steps"], kw["t_sub"], r,
                                  r_bessel)
    return run, plain, layout, work, kw


def block_rows(dev, sw, tl, teams):
    """The --block launches: sha256, ms, layout and bound of each; with
    ``teams`` every other team size of the block design too."""
    import chip_smoke
    rows = {}
    for name, kind, M, C, kw in BLOCK_LAUNCHES:
        run, plain, layout, work, kw = block_launch(kind, M, C, kw, dev,
                                                    sw, tl)
        res = run()
        res = (res,) if isinstance(res, torch.Tensor) else res
        torch.cuda.synchronize()
        each, total = digest(res)
        row = {"kernel": kind, "chains": C,
               "launch": {k: v for k, v in kw.items()},
               "sha256": each, "sha256_all": total,
               "ms": timed_ms(run)}
        launch, attrs = layout()
        row["layout"] = chip_smoke.launch_layout(launch, attrs)
        _, rounds, _ = chip_smoke.tallied(lambda: plain(min(C, 16)))
        row.update(rejection_rounds=rounds, **chip_smoke.bound_ms_row(
            *work(rounds.get("expcos", 0.0), rounds.get("bessel", 0.0))))
        if teams and hasattr(sw, "block_threads"):
            row["teams"] = team_rows(run, launch, kind, M, C, sw, tl,
                                     total)
        rows[name] = row
        del res
        torch.cuda.empty_cache()
    return rows


def team_rows(run, launch, kind, M, C, sw, tl, total):
    """Every team size the block design takes at a launch (the chosen one
    too): its sha256 of all outputs (equal to the chosen one's) and ms,
    each size timed twice, in ascending and then descending order."""
    Mx, Mt = (M, M) if isinstance(M, int) else M
    n = Mx * Mt if kind != "K4" else (Mx // 2) * (Mt // 2)
    P = sw.team_slots(n)
    if launch[3] != "block":
        return {}
    sizes = []
    G = max(sw.TEAM_THREADS_MIN, P // sw.TEAM_SLOTS)
    while G <= P:
        sizes.append(G)
        G *= 2
    out = {G: {"ms": []} for G in sizes}
    saved = sw.block_threads, tl.block_threads
    try:
        for G in sizes + sizes[::-1]:
            def fixed(*a, G=G, **k):
                return G
            sw.block_threads = tl.block_threads = fixed
            if "sha256_all_equal" not in out[G]:
                res = run()
                res = (res,) if isinstance(res, torch.Tensor) else res
                torch.cuda.synchronize()
                out[G]["sha256_all_equal"] = digest(res)[1] == total
                del res
            out[G]["ms"].append(timed_ms(run))
    finally:
        sw.block_threads, tl.block_threads = saved
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--path-a", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--block", action="store_true")
    ap.add_argument("--teams", action="store_true")
    ap.add_argument("--skip-main", action="store_true",
                    help="leave out the warp launches and the main path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("schwinger_bits: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    # the tree's package first, this checkout's chip_smoke.py (the work
    # counts) after it
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
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

    if args.block:
        out["block"] = block_rows(dev, sw, tl, args.teams)
    if not args.skip_main:
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
