#!/usr/bin/env python3
"""The JAX package's estimate for a QM parameter file run single-level,
on the CPU in f64: the reference value a port run of the same
configuration is held to where the method itself departs from the
analytic value.

    JAX_PLATFORMS=cpu python scripts/jax_qm_reference.py FILE \\
        [--set SECTION.KEY=VALUE ...] [--chains 512] [--samples 2048] \\
        [--burnin 256] [--seed 0]

It reads FILE with the JAX package's reader, applies each ``--set`` (a
value is read as the parameter files read it: 'text', true/false, a
number), builds the action, QoI and sampler with the JAX driver's own
functions (``drivers/qm.py`` ``build_action``, ``drivers/common.py``
``make_sampler_factory``) and runs ``MonteCarloSingleLevel`` with
``--burnin`` burn-in draws and ``--chains`` x ``--samples`` samples, the
file's autocorrelation window.  It prints one JSON line: the estimate, its
error, tau_int, the analytic value, the deviation from it in units of the
error, the settings and the seconds taken.

The hierarchical sampler with heat-bath coarse chains on the reference's
rotor file (``baselines/configs/ref_qm_rotor_cluster.in`` with
``--set singlelevelmc.sampler='hierarchical'``) is the case it was
written for: the checkerboard heat bath is not reversible (its even and
odd half-sweeps run in a fixed order), so as the coarsest move of the
delayed-acceptance walk it biases the estimate; with a reversible
coarse move (cluster, HMC, exact draws) the same walk is exact.  The
multilevel sampler on the reference's harmonic file
(``baselines/configs/ref_qm_harmonic_hmc.in`` with ``--set
singlelevelmc.sampler='multilevel' --chains 1024 --samples 1024``) is the
other: its coarse proposals come from persistent chains only ceil(tau)
draws apart, not independent of the fine state.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--set", action="append", default=[],
                    help="SECTION.KEY=VALUE, as in a parameter file")
    ap.add_argument("--chains", type=int, default=512)
    ap.add_argument("--samples", type=int, default=2048)
    ap.add_argument("--burnin", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from mlmcpathintegral_tpu.conditioned import (
        make_conditioned_fine_action,
    )
    from mlmcpathintegral_tpu.drivers import qm
    from mlmcpathintegral_tpu.drivers.common import make_sampler_factory
    from mlmcpathintegral_tpu.lattice import Lattice1D
    from mlmcpathintegral_tpu.mc import MonteCarloSingleLevel
    from mlmcpathintegral_tpu.models import RotorAction
    from mlmcpathintegral_tpu.qoi import qoi_susceptibility, qoi_x_squared
    from mlmcpathintegral_tpu.utils.config import (
        Section, _parse_value, read_parameter_file,
    )

    config = read_parameter_file(args.config)
    for item in args.set:
        key, raw = item.split("=", 1)
        sec, name = key.split(".", 1)
        config.setdefault(sec, {})[name] = _parse_value(raw)
    lat = Section(config, "lattice", defaults={"M_lat": 32, "T_final": 4.0})
    action = qm.build_action(config, Lattice1D(lat.get_int("M_lat"),
                                               lat.get_float("T_final")))
    qoi_factory = (qoi_susceptibility if isinstance(action, RotorAction)
                   else qoi_x_squared)
    window = Section(config, "statistics",
                     defaults={"n_autocorr_window": 20}).get_int(
        "n_autocorr_window")
    name = Section(config, "singlelevelmc",
                   defaults={"sampler": "HMC"}).get_string("sampler")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # random_order
        sampler = make_sampler_factory(
            name, config, cond_factory=make_conditioned_fine_action,
            qoi_factory=qoi_factory)(action)
    mc = MonteCarloSingleLevel(action, qoi_factory(action), sampler,
                               n_burnin=args.burnin,
                               n_samples=args.chains * args.samples,
                               n_autocorr_window=window)
    t0 = time.monotonic()
    _, stats = mc.evaluate(jax.random.PRNGKey(args.seed), args.chains,
                           jnp.float64)
    num, err = mc.numerical_result(stats), mc.statistical_error(stats)
    ana = qm.analytical_results(action).get("analytical")
    print(json.dumps({
        "config": args.config, "set": args.set, "action":
        action.info_string(), "sampler": name, "chains": args.chains,
        "samples_per_chain": args.samples, "burnin": args.burnin,
        "seed": args.seed, "estimate": num, "error": err,
        "tau_int": mc.stats_Q.tau_int(stats), "analytical": ana,
        "sigma_from_analytical": None if ana is None else (num - ana) / err,
        "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
