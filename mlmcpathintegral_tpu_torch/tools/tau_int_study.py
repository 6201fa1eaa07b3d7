"""tau_int against lattice spacing for the topological rotor on the port
(the counterpart of the JAX package's ``tools/tau_int_study.py``): the
data behind the reference's README figure 3 (left).  Single-level HMC's
autocorrelation grows as a -> 0, while the hierarchical delayed-acceptance
sampler with cluster coarse chains stays flat.

HMC runs on the trajectory kernel (K5) and the hierarchy's coarsest
cluster chains on the cluster kernel (K7); on the CPU their plain
versions, in float64.  The tool prints each run's kernel launches and the
layouts of the launches it made.  A failed run is not retried.

Usage:
  python -m mlmcpathintegral_tpu_torch.tools.tau_int_study \\
      --lattices 16,32,64 --csv docs/h100/tau_int_study.csv
"""

from __future__ import annotations

import argparse

import torch


def samplers(act, M):
    """The JAX tool's two samplers of the rotor action ``act`` on M sites,
    on their kernels."""
    from mlmcpathintegral_tpu_torch.conditioned import (
        make_conditioned_fine_action,
    )
    from mlmcpathintegral_tpu_torch.samplers import (
        ClusterSampler, HierarchicalSampler, HMCSampler,
    )
    return {
        "hmc": HMCSampler(act, nt=20, dt=0.2, n_burnin=50, use_pallas=True),
        "hierarchical": HierarchicalSampler(
            act,
            lambda a: ClusterSampler(a, n_burnin=50, n_updates=5,
                                     use_pallas=True),
            make_conditioned_fine_action,
            n_max_level=max(2, M.bit_length() - 3)),
    }


def layouts(M, n_chains):
    """The launch layouts of K5 at M sites and of K7 at the hierarchy's
    coarsest level (the card is needed for the occupancy numbers)."""
    from mlmcpathintegral_tpu_torch.ops.hmc import hmc_attrs, hmc_launch
    from mlmcpathintegral_tpu_torch.ops.rotor import (
        cluster_attrs, cluster_launch,
    )
    n_max_level = max(2, M.bit_length() - 3)
    Mc = M >> (n_max_level - 1)
    return {"hmc_trajectory": {"M": M, "launch": hmc_launch(M, n_chains),
                               **hmc_attrs(M, n_chains, "rotor")},
            "rotor_cluster_chain": {
                "M": Mc, "launch": cluster_launch(Mc, n_chains),
                **cluster_attrs(Mc, n_chains)}}


def run_tau_int(lattices=(16, 32, 64), n_samples=8000, n_chains=64,
                m0=1.0, T_final=4.0, device="cuda"):
    """One row per lattice and sampler: (M, a, sampler, tau_int, chi_t,
    err, sigma_dev, wall_s), the JAX tool's columns; and the kernel
    launches of each run."""
    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch.lattice import Lattice1D
    from mlmcpathintegral_tpu_torch.mc import MonteCarloSingleLevel
    from mlmcpathintegral_tpu_torch.models import (
        RenormalisationType, RotorAction,
    )
    from mlmcpathintegral_tpu_torch.ops import _cuda
    from mlmcpathintegral_tpu_torch.qoi import qoi_susceptibility
    from mlmcpathintegral_tpu_torch.tools import launches
    device = _cuda.run_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    rows, runs = [], []
    for M in lattices:
        lat = Lattice1D(M, T_final)
        act = RotorAction(lat, RenormalisationType.PERTURBATIVE, m0=m0)
        oracle = act.chit_exact()
        for name, sampler in samplers(act, M).items():
            mc = MonteCarloSingleLevel(
                act, qoi_susceptibility(act), sampler, n_burnin=200,
                n_samples=n_samples, n_autocorr_window=50, chunk_size=200)
            ops.reset_counters()
            _, st = mc.evaluate(torch.Generator().manual_seed(M), n_chains,
                                dtype, device)
            tau = mc.stats_Q.tau_int(st)
            num = mc.numerical_result(st)
            err = mc.statistical_error(st)
            dev = abs(num - oracle) / err
            rows.append((M, lat.a_lat, name, tau, num, err, dev,
                         mc.elapsed_s))
            runs.append({"M": M, "sampler": name, "oracle": oracle,
                         "launches": launches()})
            print(f"M={M:4d} a={lat.a_lat:.4f} {name:13s}: "
                  f"tau_int={tau:7.3f}  chi_t={num:.6f}+/-{err:.6f} "
                  f"({dev:.2f} sigma)  wall={mc.elapsed_s:.1f}s  "
                  f"launches={runs[-1]['launches']}", flush=True)
        if device.type == "cuda":
            print(f"M={M} layouts: {layouts(M, n_chains)}", flush=True)
    return rows, runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--lattices", default="16,32,64")
    ap.add_argument("--n-samples", type=int, default=8000)
    ap.add_argument("--n-chains", type=int, default=64)
    ap.add_argument("--m0", type=float, default=1.0)
    ap.add_argument("--T-final", type=float, default=4.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, f32) or cpu (their plain "
                         "versions, f64)")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows, _ = run_tau_int([int(m) for m in args.lattices.split(",")],
                          args.n_samples, args.n_chains, args.m0,
                          args.T_final, args.device)
    if args.csv:
        with open(args.csv, "w") as fh:
            fh.write("M,a,sampler,tau_int,chi_t,err,sigma_dev,wall_s\n")
            for r in rows:
                fh.write(",".join(str(v) for v in r) + "\n")
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
