"""Screen-bias regression of the fused two-level path at several couplings
on the port (the counterpart of the JAX package's
``tools/screen_bias_study.py``).

Delayed acceptance is exact only for independent coarse proposals; the
fused levels subsample their coarse chains by the measured slow-mode
clock (``MonteCarloMultiLevel._update_t_sub``).  This study drives the
fused two-level MLMC to a relative precision ``--rel-target`` (0.1% by
default) of the analytic oracle (``chit_exact``) at several couplings,
over several seeds each: a bias from under-decorrelated coarse proposals
would show as a coherent multi-sigma shift.  The rows have the columns of
``docs/screen_bias_r5.csv``.  A failed run is not retried.

Usage:
  python -m mlmcpathintegral_tpu_torch.tools.screen_bias_study \\
      --configs 8:4.0,8:2.0,16:8.0 --csv docs/h100/screen_bias.csv
"""

from __future__ import annotations

import argparse
import time

import torch


def run_one(M, beta, seed, *, rel_target=1e-3, n_chains=1024,
            chunk_size=256, use_pallas=True, device="cuda",
            dtype=torch.float32):
    """Two-level adaptive MLMC at M x M, ``beta``, to epsilon = rel_target
    chit_exact; returns the JAX tool's row (its keys, in its order)."""
    from mlmcpathintegral_tpu_torch.ops import _cuda
    from mlmcpathintegral_tpu_torch.tools.schwinger_scale_study import (
        make_mlmc,
    )
    device = _cuda.run_device(device)
    mc = make_mlmc(M, M, beta=beta, n_level=2, n_samples=0,
                   chunk_size=chunk_size, use_pallas=use_pallas,
                   n_autocorr_window=64)
    oracle = mc.actions[0].chit_exact()
    # adaptive allocation straight to the precision target
    mc.epsilon = rel_target * oracle
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.monotonic()
    stats = mc.evaluate(torch.Generator().manual_seed(seed),
                        n_chains=n_chains, dtype=dtype, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - t0
    num, err = mc.numerical_result(), mc.statistical_error()
    flagged = [r["level"] for r in mc.reliability if r["flagged"]]
    return {
        "M": M, "beta": beta, "seed": seed,
        "chit": round(num, 6), "err": round(err, 6),
        "oracle": round(oracle, 6),
        "rel_err": round(err / oracle, 6),
        "rel_dev": round((num - oracle) / oracle, 6),
        "sigma_dev": round((num - oracle) / err, 2),
        "t_sub": "/".join(map(str, mc._t_sub)),
        "n_recorded": "/".join(
            str(mc.stats_qoi[ell].samples(stats[ell]))
            for ell in range(mc.n_level)),
        "unreliable_levels": "/".join(map(str, flagged)) or "none",
        "wall_s": round(wall, 1),
    }


def main(argv=None):
    from mlmcpathintegral_tpu_torch.tools import write_csv
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", default=None)
    ap.add_argument("--configs", default="8:2.0,16:8.0",
                    help="comma list of M:beta")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--rel-target", type=float, default=1e-3)
    ap.add_argument("--n-chains", type=int, default=1024)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    rows = []
    for cfg in args.configs.split(","):
        M, beta = cfg.split(":")
        for seed in [int(s) for s in args.seeds.split(",")]:
            r = run_one(int(M), float(beta), seed,
                        rel_target=args.rel_target, n_chains=args.n_chains,
                        device=args.device)
            print(r, flush=True)
            rows.append(r)
    if args.csv and rows:
        write_csv(args.csv, rows)
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
