"""Analyse a binary QoI log written by ``MonteCarloSingleLevel(
qoi_log_path=...)`` (the counterpart of the JAX package's
``tools/analyze_qoi_log.py``, on the port's numpy statistics in
``utils/statistics.py`` in place of the native engine): per-chain
tau_int, the aggregate estimate and a binning cross-check.

The log is float64 of shape [n_steps, n_chains] (a row a step).

Usage:
  python -m mlmcpathintegral_tpu_torch.tools.analyze_qoi_log qoi.bin \\
      --n-chains 64
"""

from __future__ import annotations

import argparse

import numpy as np


def analyze_samples(samples, k_max: int = 20) -> dict:
    """The reference's estimators of one chain's series: {n, avg,
    variance, variance_error, tau_int, error, autocorr}
    (statistics.cc:30-98; the numpy form of the native engine's
    mlmc_stats_process)."""
    samples = np.ascontiguousarray(samples, dtype=np.float64).ravel()
    n = samples.size
    avg = samples.mean()
    C = np.empty(k_max)
    for k in range(k_max):
        C[k] = np.mean(samples[k:] * samples[:n - k]) - avg * avg
    var = n / (n - 1.0) * C[0]
    k = np.arange(1, k_max)
    tau = max(1.0, 1.0 + 2.0 * np.sum((1.0 - k / n) * C[1:]) / C[0]) \
        if C[0] > 0 else 1.0
    m2, m3, m4 = (samples ** 2).mean(), (samples ** 3).mean(), \
        (samples ** 4).mean()
    var_err = np.sqrt(max(
        (m4 - 4 * avg * m3 + 8 * avg ** 2 * m2 - m2 ** 2 - 4 * avg ** 4)
        / n, 0.0))
    return {"n": n, "avg": float(avg), "variance": float(var),
            "variance_error": float(var_err), "tau_int": float(tau),
            "error": float(np.sqrt(tau * max(var, 0) / n)),
            "autocorr": C}


def analyze(data, k_max: int = 40):
    """The tool's report of a [T, C] log as a list of lines."""
    from mlmcpathintegral_tpu_torch.utils.statistics import binning_analysis
    T, C = data.shape
    per_chain = [analyze_samples(data[:, c], k_max) for c in range(C)]
    avg = np.mean([r["avg"] for r in per_chain])
    tau = np.mean([r["tau_int"] for r in per_chain])
    var = np.mean([r["variance"] for r in per_chain])
    err = np.sqrt(tau * var / (T * C))
    lines = [f"log: {T} steps x {C} chains (python engine)",
             f" Q: Avg +/- Err = {avg:.6f} +/- {err:.6f}",
             f" Q: Var         = {var:.6f}",
             f" Q: tau_int     = {tau:.3f}",
             " binning cross-check (chain 0):"]
    errs = binning_analysis(data[:, 0],
                            n_levels=min(12, int(np.log2(max(T, 4)))))
    lines += [f"   bin 2^{b:<2d}: err = {e:.6g}" for b, e in enumerate(errs)]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("logfile")
    ap.add_argument("--n-chains", type=int, required=True)
    ap.add_argument("--k-max", type=int, default=40)
    args = ap.parse_args(argv)
    data = np.fromfile(args.logfile, dtype=np.float64)
    if data.size % args.n_chains:
        raise SystemExit(f"log size {data.size} not divisible by "
                         f"n_chains={args.n_chains}")
    for line in analyze(data.reshape(-1, args.n_chains), args.k_max):
        print(line)


if __name__ == "__main__":
    main()
