#!/usr/bin/env python3
"""The JAX package's hybrid-cluster MLMC at given seeds on the CPU: each
level's mean against its exact value.

    python scripts/jax_path_a_levels.py --seeds 2 3 4 [--out FILE]

The configuration is ``bench_schwinger_mlmc(coarse="cluster")``'s with the
port's sample count (``perf_probe.headline_mlmc_cluster``): 8x8,
both-direction coarsening, beta=4 nonperturbative, two levels,
``QuenchedSchwingerClusterSampler(n_burnin=20, n_updates=5)`` coarse
chains, 1024 chains, float32, chunk 256, 100 000 samples per level.  The
cluster updates take the vectorised core (the Pallas kernel runs only in
interpret mode on a CPU; both draw from the same distribution).  The
port's ``perf_probe --accuracy-seeds`` reads the same quantities on the
card, so the two runs tell a fault of the port from a property of the
method.  E[Y_0] = chi_f - chi_c and E[Y_1] = chi_c; z = (mean - exact) /
error.  Several GiB of host memory: the screen holds 256 proposals of
1024 chains at once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mlmcpathintegral_tpu.conditioned.schwinger import (  # noqa: E402
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral_tpu.lattice2d import (  # noqa: E402
    CoarseningType, Lattice2D,
)
from mlmcpathintegral_tpu.mc import MonteCarloMultiLevel  # noqa: E402
from mlmcpathintegral_tpu.models.base import (  # noqa: E402
    RenormalisationType,
)
from mlmcpathintegral_tpu.models.qft.schwinger import (  # noqa: E402
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu.qoi import qoi_2d_susceptibility  # noqa: E402
from mlmcpathintegral_tpu.samplers import (  # noqa: E402
    QuenchedSchwingerClusterSampler,
)


def path_a(seed: int) -> dict:
    act = QuenchedSchwingerAction(
        Lattice2D(8, 8, CoarseningType.BOTH), beta=4.0,
        renormalisation=RenormalisationType.NONPERTURBATIVE)
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: QuenchedSchwingerClusterSampler(
            a, n_burnin=20, n_updates=5, use_pallas=False),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=100, n_samples=100_000, chunk_size=256,
        use_pallas=True)
    t0 = time.monotonic()
    st = mc.evaluate(jax.random.PRNGKey(seed), n_chains=1024,
                     dtype=jnp.float32)
    exact = [act.chit_exact() - mc.actions[1].chit_exact(),
             mc.actions[1].chit_exact()]
    levels = []
    for ell in range(2):
        avg = mc.stats_qoi[ell].average(st[ell])
        err = mc.stats_qoi[ell].error(st[ell])
        levels.append({"avg": avg, "err": err, "exact": exact[ell],
                       "z": (avg - exact[ell]) / err,
                       "samples": mc.stats_qoi[ell].samples(st[ell])})
    num, err = mc.numerical_result(), mc.statistical_error()
    return {"seed": seed, "chit": num, "err": err,
            "chit_exact": act.chit_exact(),
            "z": (num - act.chit_exact()) / err, "levels": levels,
            "wall_s": time.monotonic() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[2])
    ap.add_argument("--out", default="chiprun_out/jax_path_a_levels.json")
    args = ap.parse_args(argv)
    jax.config.update("jax_default_device",
                      jax.local_devices(backend="cpu")[0])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    runs = []
    for seed in args.seeds:
        runs.append(path_a(seed))
        print(json.dumps(runs[-1]), flush=True)
        out.write_text(json.dumps({"backend": "cpu", "runs": runs},
                                  indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
