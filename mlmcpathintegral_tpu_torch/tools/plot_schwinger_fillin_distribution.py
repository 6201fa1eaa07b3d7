"""The exact (BesselProduct) and Gaussian-approximation fill-in
distributions of the interior vertical-link sum on the port (the
counterpart of the JAX package's
``tools/plot_schwinger_fillin_distribution.py``; the reference's
test_schwinger_fillin_distribution,
src/test_schwinger_fillin_distribution.cc:60-130).

The tool draws both fills and evaluates both densities on a grid, float64
on the card unless ``--device cpu``, and writes them to ``--data`` (an
``.npz``: ``xs``, ``x_approx``, ``p_approx`` and, for beta <= 8, where the
exact fill exists, ``x_exact`` and ``p_exact``).  With ``--plot`` it also
overlays them in ``--output`` with matplotlib, which only then is
imported.

Usage:
  python -m mlmcpathintegral_tpu_torch.tools.plot_schwinger_fillin_distribution \\
      --beta 4.0 --data schwinger_fillin.npz [--plot --output fillin.pdf]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def fillin_data(beta=4.0, x_p=0.5, x_m=-0.3, n=100000, seed=0,
                device="cuda"):
    """{name: numpy array}: the grid, both fills' samples and densities
    (the exact one for beta <= 8 only)."""
    from mlmcpathintegral_tpu_torch.distributions.approxbesselproduct import (
        ApproximateBesselProductDistribution,
    )
    from mlmcpathintegral_tpu_torch.distributions.besselproduct import (
        BesselProductDistribution,
    )
    gen = torch.Generator(device=device).manual_seed(seed)
    xp = torch.full((n,), x_p, dtype=torch.float64, device=device)
    xm = torch.full((n,), x_m, dtype=torch.float64, device=device)
    xs = torch.linspace(-np.pi, np.pi, 801, dtype=torch.float64,
                        device=device)
    out = {"xs": xs}
    dists = {"approx": ApproximateBesselProductDistribution(beta)}
    if beta <= 8.0:
        dists["exact"] = BesselProductDistribution(beta)
    for name, D in dists.items():
        out[f"x_{name}"] = D.draw(gen, xp, xm)
        out[f"p_{name}"] = D.evaluate(xs, torch.full_like(xs, x_p),
                                      torch.full_like(xs, x_m))
    return {k: v.cpu().numpy() for k, v in out.items()}


def plot(data, beta, x_p, x_m, output):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    xs = data["xs"]
    if "x_exact" in data:
        ax.hist(data["x_exact"], bins=80, density=True, alpha=0.4,
                label="exact samples")
        ax.plot(xs, data["p_exact"], "C0-", lw=2, label="exact density")
    ax.hist(data["x_approx"], bins=80, density=True, alpha=0.4, color="C3",
            label="approx samples")
    ax.plot(xs, data["p_approx"], "C3--", lw=2, label="approx density")
    ax.set_xlabel(r"$\tilde\theta$")
    ax.set_ylabel("p")
    ax.set_title(f"Schwinger fill-in, beta={beta}, x_p={x_p}, x_m={x_m}")
    ax.legend()
    fig.tight_layout()
    fig.savefig(output)


def main(argv=None):
    from mlmcpathintegral_tpu_torch.ops import _cuda
    ap = argparse.ArgumentParser()
    ap.add_argument("--beta", type=float, default=4.0)
    ap.add_argument("--x-p", type=float, default=0.5)
    ap.add_argument("--x-m", type=float, default=-0.3)
    ap.add_argument("--n-samples", type=int, default=100000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    ap.add_argument("--data", default="schwinger_fillin.npz")
    ap.add_argument("--plot", action="store_true",
                    help="also plot to --output (needs matplotlib)")
    ap.add_argument("--output", default="schwinger_fillin.pdf")
    args = ap.parse_args(argv)
    data = fillin_data(args.beta, args.x_p, args.x_m, args.n_samples,
                       args.seed, _cuda.run_device(args.device))
    np.savez(args.data, **data)
    print(f"wrote {args.data}")
    if args.plot:
        plot(data, args.beta, args.x_p, args.x_m, args.output)
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
