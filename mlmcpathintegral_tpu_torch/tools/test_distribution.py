"""Standalone distribution tester on the port (the counterpart of the JAX
package's ``tools/test_distribution.py``, itself the analog of the
reference's ``test_distribution`` executable): draw from a chosen
distribution, time the cost a sample, and write the samples and the
density on a grid to ``distribution.txt`` in the JAX tool's format, which
``tools/plot_distribution.py`` plots as it is.

The draws are float64 tensor programs (no kernel), on the card unless
``--device cpu``.

Usage:
  python -m mlmcpathintegral_tpu_torch.tools.test_distribution \\
      --distribution=expsin2 --sigma=4.0
  python -m mlmcpathintegral_tpu_torch.tools.test_distribution \\
      --distribution=expcos --beta=4.0 --x-p=0.5 --x-m=-0.3
  python -m mlmcpathintegral_tpu_torch.tools.test_distribution \\
      --distribution=besselproduct --beta=4.0
  python -m mlmcpathintegral_tpu_torch.tools.test_distribution \\
      --distribution=approximatebesselproduct --beta=16.0
  python -m mlmcpathintegral_tpu_torch.tools.test_distribution \\
      --distribution=compactexp --sigma=2.0
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

DISTRIBUTIONS = ("expsin2", "expcos", "compactexp", "besselproduct",
                 "approximatebesselproduct")


def sampler(name, *, sigma=2.0, beta=4.0, x_p=0.5, x_m=-0.3, n=100000,
            device="cuda"):
    """(draw(generator) -> [n] samples, density(x) -> p(x), lo, hi) of the
    named distribution at the tool's parameters, float64 on ``device``."""
    from mlmcpathintegral_tpu_torch.distributions.approxbesselproduct import (
        ApproximateBesselProductDistribution,
    )
    from mlmcpathintegral_tpu_torch.distributions.besselproduct import (
        BesselProductDistribution,
    )
    from mlmcpathintegral_tpu_torch.distributions.compactexp import (
        CompactExpDistribution,
    )
    from mlmcpathintegral_tpu_torch.distributions.expcos import (
        ExpCosDistribution,
    )
    from mlmcpathintegral_tpu_torch.distributions.expsin2 import (
        ExpSin2Distribution,
    )

    def full(v):
        return torch.full((n,), v, dtype=torch.float64, device=device)

    def at(x, v):
        return torch.full_like(x, v)

    pi = math.pi
    if name == "expsin2":
        return (lambda g: ExpSin2Distribution.draw(g, full(sigma)),
                lambda x: ExpSin2Distribution.evaluate(x, at(x, sigma)),
                -pi, pi)
    if name == "expcos":
        return (lambda g: ExpCosDistribution.draw(g, beta, full(x_p),
                                                  full(x_m)),
                lambda x: ExpCosDistribution.evaluate(x, beta, at(x, x_p),
                                                      at(x, x_m)),
                -pi, pi)
    if name == "compactexp":
        return (lambda g: CompactExpDistribution.draw(g, full(sigma)),
                lambda x: CompactExpDistribution.evaluate(x, sigma),
                -1.0, 1.0)
    if name == "besselproduct":
        D = BesselProductDistribution(beta)
    elif name == "approximatebesselproduct":
        D = ApproximateBesselProductDistribution(beta)
    else:
        raise ValueError(f"unknown distribution {name!r}")
    return (lambda g: D.draw(g, full(x_p), full(x_m)),
            lambda x: D.evaluate(x, at(x, x_p), at(x, x_m)), -pi, pi)


def write_distribution(path, name, samples, xs, ps):
    """The JAX tool's ``distribution.txt``: header, samples, then the
    (x, p) grid."""
    with open(path, "w") as fh:
        fh.write(f"# distribution = {name}\n")
        fh.write(f"# n_samples = {samples.size}\n")
        fh.write("# === samples ===\n")
        np.savetxt(fh, samples)
        fh.write("# === density (x p) ===\n")
        np.savetxt(fh, np.column_stack([xs, ps]))


def main(argv=None):
    from mlmcpathintegral_tpu_torch.ops import _cuda
    ap = argparse.ArgumentParser()
    ap.add_argument("--distribution", required=True, choices=DISTRIBUTIONS)
    ap.add_argument("--sigma", type=float, default=2.0)
    ap.add_argument("--beta", type=float, default=4.0)
    ap.add_argument("--x-p", type=float, default=0.5)
    ap.add_argument("--x-m", type=float, default=-0.3)
    ap.add_argument("--n-samples", type=int, default=100000)
    ap.add_argument("--output", default="distribution.txt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    device = _cuda.run_device(args.device)
    n = args.n_samples
    draw, dens, lo, hi = sampler(args.distribution, sigma=args.sigma,
                                 beta=args.beta, x_p=args.x_p, x_m=args.x_m,
                                 n=n, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def synced():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # a warm draw, then the timed one (test_distribution.cc timing report)
    draw(gen)
    synced()
    t0 = time.monotonic()
    x = draw(gen)
    synced()
    dt = time.monotonic() - t0
    print(f"distribution = {args.distribution}")
    print(f"time per sample = {1e9 * dt / n:.2f} ns  "
          f"({n} samples in {dt * 1e3:.1f} ms) on {device}")
    xs = np.linspace(lo, hi, 1001)
    ps = dens(torch.as_tensor(xs, device=device)).cpu().numpy()
    write_distribution(args.output, args.distribution, x.cpu().numpy(), xs,
                       ps)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
