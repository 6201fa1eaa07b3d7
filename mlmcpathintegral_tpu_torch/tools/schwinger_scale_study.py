"""Reference-scale Schwinger MLMC study on the port (the counterpart of the
JAX package's ``tools/schwinger_scale_study.py``).

Two experiments, each emitting a CSV row per configuration, with the JAX
tool's columns in its order:

  * --scale: full MLMC at growing lattice sizes (16x16 .. 128x128) with a
    3-level hierarchy and nonperturbative beta matching, on the continuum
    trajectory beta = 4 (M/16)^2: per-level costs, t_sub, oracle
    deviation and effective samples/s.  The rows carry ``n_chains`` at
    the end, as ``docs/scale_study.csv`` does.
  * --epsilon: adaptive-target MLMC (n_samples=0) over an epsilon sweep,
    then a fit of the method wall to c0 + c2 eps^-2, reproducing the
    O(eps^-2) scaling of montecarlomultilevel.cc's allocation.

Runs on the card unless ``--device cpu`` (the kernels' plain versions).
A level whose fused kernel does not fit the card's shared memory runs
unfused (the 128x128 fine level); an unfused level's heat-bath coarse
chain then draws on the sweep kernel, ``--no-pallas`` puts every level
on the plain unfused path.  A failed run is not retried: the exception
ends the tool with a non-zero exit.

Usage:
  python -m mlmcpathintegral_tpu_torch.tools.schwinger_scale_study \\
      --scale --sizes 16,32,64 --csv docs/h100/scale_study.csv
  python -m mlmcpathintegral_tpu_torch.tools.schwinger_scale_study \\
      --epsilon --eps-sizes 16 --csv docs/h100/eps_study.csv
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def scale_beta(M: int) -> float:
    """The continuum-limit trajectory: fixed physical volume and coupling,
    a -> a/2 per doubling, so beta = 1/(a g)^2 grows as M^2 (normalised to
    the baseline beta = 4 at 16x16).  At fixed beta the two-level
    acceptance collapses with volume."""
    return 4.0 * (M / 16.0) ** 2


def make_mlmc(Mt, Mx, *, beta=4.0, n_level=3, n_samples=1_000_000,
              epsilon=1e-2, chunk_size=256, use_pallas=True,
              n_autocorr_window=64, coarse="heatbath"):
    """The JAX tool's ``MonteCarloMultiLevel``: both-direction coarsening,
    nonperturbative beta matching, heat-bath or hybrid cluster coarse
    chains (burn-in 100), burn-in 200."""
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
        OverrelaxedHeatBathSampler, QuenchedSchwingerClusterSampler,
    )

    act = QuenchedSchwingerAction(
        Lattice2D(Mt, Mx, CoarseningType.BOTH), beta=beta,
        renormalisation=RenormalisationType.NONPERTURBATIVE)
    if coarse == "cluster":
        # the reference's exact-sampler trick for the topological slowing
        # of the heat bath at large beta_c: plaquettes <-> rotor
        # increments, Wolff cluster, tau ~ 1 flat in a
        # (quenchedschwingerclustersampler.hh:22-37)
        def factory(a):
            return QuenchedSchwingerClusterSampler(a, n_burnin=100,
                                                   use_pallas=use_pallas)
    else:
        def factory(a):
            return OverrelaxedHeatBathSampler(a, n_burnin=100,
                                              use_pallas=use_pallas)
    return MonteCarloMultiLevel(
        act, qoi_2d_susceptibility, coarse_sampler_factory=factory,
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=n_level, n_burnin=200, n_samples=n_samples,
        epsilon=epsilon, chunk_size=chunk_size,
        n_autocorr_window=n_autocorr_window, use_pallas=use_pallas)


def run_mlmc(Mt, Mx, *, beta=4.0, n_level=3, n_samples=1_000_000,
             epsilon=1e-2, n_chains=1024, chunk_size=256, use_pallas=True,
             seed=0, n_autocorr_window=64, coarse="heatbath",
             device="cuda", dtype=torch.float32):
    """One MLMC run; returns the JAX tool's row (its keys, in its order).
    ``seed`` seeds the run's generator; ``device``: the card unless the
    caller asks for the CPU; ``dtype``: float32 (the kernels' type) unless
    the caller asks for another on the CPU."""
    from mlmcpathintegral_tpu_torch.ops import _cuda
    device = _cuda.run_device(device)
    mc = make_mlmc(Mt, Mx, beta=beta, n_level=n_level, n_samples=n_samples,
                   epsilon=epsilon, chunk_size=chunk_size,
                   use_pallas=use_pallas,
                   n_autocorr_window=n_autocorr_window, coarse=coarse)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.monotonic()
    stats = mc.evaluate(torch.Generator().manual_seed(seed),
                        n_chains=n_chains, dtype=dtype, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - t0
    num, err = mc.numerical_result(), mc.statistical_error()
    err_robust = mc.statistical_error_robust()
    oracle = mc.actions[0].chit_exact()
    tau0 = mc.stats_qoi[0].tau_int(stats[0])
    n0 = mc.stats_qoi[0].samples(stats[0])
    # per-level sampling work only, the scope of the reference's cost
    # breakdown (montecarlomultilevel.cc:207-252); set-up and burn-in are
    # in the timings column
    method_wall = max(mc.timings["cost_measure_s"]
                      + mc.timings["sampling_s"], 1e-9)
    sigma_dev = abs(num - oracle) / err
    flagged = [r["level"] for r in mc.reliability if r["flagged"]]
    return {
        "Mt": Mt, "Mx": Mx, "beta": beta, "n_level": n_level,
        "epsilon": epsilon if n_samples == 0 else "",
        "n_samples_level0": n0,
        "chit": round(num, 6), "err": round(err, 6),
        "oracle": round(oracle, 6),
        "sigma_dev": round(sigma_dev, 2),
        # the JAX tool's bench gate: > 3 sigma from the oracle = failed
        "failed": bool(sigma_dev > 3.0),
        "unreliable_levels": "/".join(map(str, flagged)) or "none",
        "err_robust": round(err_robust, 6),
        "sigma_dev_robust": round(abs(num - oracle) / err_robust, 2),
        "tau_capped": "/".join(
            str(int(r["window_capped"])) for r in mc.reliability),
        "tau_eff": "/".join(f"{r['tau_eff']:.2f}" for r in mc.reliability),
        "tau0": round(tau0, 3),
        "t_sub": "/".join(map(str, mc._t_sub)),
        "cost_us": "/".join(f"{c:.3f}" for c in mc.cost_per_sample),
        "n_target": "/".join(map(str, mc.n_target)),
        "n_recorded": "/".join(
            str(mc.stats_qoi[ell].samples(stats[ell]))
            for ell in range(mc.n_level)),
        "wall_s": round(wall, 2),
        "method_wall_s": round(method_wall, 3),
        "sampling_s": round(mc.timings["sampling_s"], 2),
        "timings": "/".join(f"{k}={v:.2f}" for k, v in mc.timings.items()),
        "eff_samples_per_sec": round(n0 / (tau0 * method_wall), 1),
    }


def eps_fit(rows):
    """Per lattice size with at least 3 rows: the fit method_wall = c0 +
    c2 eps^-2 and the log-log slope of its asymptotic (largest-cost) half
    in eps^-2 (1.0 for O(eps^-2)).  Returns {M: (c0, c2, slope)}."""
    by_M = {}
    for r in rows:
        by_M.setdefault(r["Mt"], []).append(r)
    out = {}
    for M, rs in by_M.items():
        if len(rs) < 3:
            continue
        x = np.array([1.0 / r["epsilon"] ** 2 for r in rs])
        y = np.array([r["method_wall_s"] for r in rs])
        A = np.stack([np.ones_like(x), x], axis=1)
        coef = np.linalg.lstsq(A, y, rcond=None)[0]
        order = np.argsort(x)
        xs, ys = x[order], y[order] - min(coef[0], 0.0)
        tail = slice(len(xs) // 2 - 1, None)
        slope = np.polyfit(np.log(xs[tail]),
                           np.log(np.maximum(ys[tail], 1e-9)), 1)[0]
        out[M] = (float(coef[0]), float(coef[1]), float(slope))
    return out


def main(argv=None):
    from mlmcpathintegral_tpu_torch.tools import launches, write_csv
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", action="store_true")
    ap.add_argument("--epsilon", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--n-chains", type=int, default=1024)
    ap.add_argument("--chunk-size", type=int, default=256)
    ap.add_argument("--n-samples", type=int, default=1_000_000)
    ap.add_argument("--sizes", default="16,32,64")
    ap.add_argument("--epsilons", default="2e-2,1e-2,5e-3,2.5e-3")
    ap.add_argument("--eps-sizes", default="16",
                    help="lattice sizes for the --epsilon sweep "
                         "(continuum trajectory beta = 4 (M/16)^2)")
    ap.add_argument("--coarse", default="heatbath",
                    choices=["heatbath", "cluster"])
    ap.add_argument("--no-pallas", action="store_true",
                    help="every level on the plain unfused path")
    ap.add_argument("--append", action="store_true",
                    help="append rows to --csv instead of overwriting")
    args = ap.parse_args(argv)
    from mlmcpathintegral_tpu_torch import ops
    kw = dict(n_chains=args.n_chains, chunk_size=args.chunk_size,
              coarse=args.coarse, use_pallas=not args.no_pallas,
              device=args.device)

    rows = []
    if args.scale:
        for M in [int(s) for s in args.sizes.split(",")]:
            ops.reset_counters()
            r = run_mlmc(M, M, beta=scale_beta(M), n_level=3,
                         n_samples=args.n_samples, **kw)
            r["n_chains"] = args.n_chains
            print(r, flush=True)
            print(f"M={M} launches={launches()}", flush=True)
            rows.append(r)
    eps_rows = []
    if args.epsilon:
        # adaptive-target MLMC (n_samples=0) over an epsilon ladder at
        # every size in --eps-sizes (montecarlomultilevel.cc:115-204)
        for M in [int(s) for s in args.eps_sizes.split(",")]:
            for eps in [float(s) for s in args.epsilons.split(",")]:
                ops.reset_counters()
                r = run_mlmc(M, M, beta=scale_beta(M), n_level=3,
                             n_samples=0, epsilon=eps, **kw)
                print(r, flush=True)
                print(f"M={M} eps={eps} launches={launches()}", flush=True)
                eps_rows.append(r)
        for M, (c0, c2, slope) in eps_fit(eps_rows).items():
            print(f"M={M}: cost fit = {c0:.2f}s + {c2:.3e} * eps^-2 ; "
                  f"log-log tail slope in eps^-2 = {slope:.3f} "
                  f"(O(eps^-2) <=> 1.0)", flush=True)
    rows += eps_rows
    if args.csv and rows:
        mode = write_csv(args.csv, rows, append=args.append)
        print(f"wrote {args.csv} ({mode})")


if __name__ == "__main__":
    main()
