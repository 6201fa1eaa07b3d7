#!/usr/bin/env python3
"""The JAX package's estimate for a QFT parameter file, on the CPU in f64:
the reference value a port run of the same configuration is held to where
the model has no analytic value (the O(3) sigma model's magnetic
susceptibility).

    JAX_PLATFORMS=cpu python scripts/jax_qft_reference.py FILE \\
        [--set SECTION.KEY=VALUE ...] [--chains 512] [--samples 512] \\
        [--burnin 1000] [--seed 0]

It reads FILE with the JAX package's reader, applies each ``--set`` (a
value is read as the parameter files read it: 'text', true/false, a
number), builds the lattice, action, QoI and sampler with the JAX QFT
driver's own functions (``drivers/qft.py`` ``build_action``,
``select_qoi``, ``select_cond_factory``; ``drivers/common.py``
``make_sampler_factory``) and runs the file's method on ``--chains``
chains: single-level with ``--burnin`` burn-in draws and ``--chains`` x
``--samples`` samples; two-level as the JAX driver runs it, with the
``twolevelmc`` section's burn-in, samples and sampler (``--samples`` and
``--burnin`` unused).  Both with the file's autocorrelation windows.  It
prints one JSON line: the estimate (the fine level's, two-level), its
error, tau_int, the two-level acceptance, the analytic value where the
model has one, the deviation from it in units of the error, the settings
and the seconds taken.

The sigma model's reference file (``baselines/configs/
ref_qft_sigma_heatbath.in``: 16x16, beta = 1.5, one overrelaxation and
one heat-bath sweep a draw) is the case it was written for, single-level
and with ``--set general.method='twolevel'``.
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
    ap.add_argument("--samples", type=int, default=512)
    ap.add_argument("--burnin", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from mlmcpathintegral_tpu.drivers import qft
    from mlmcpathintegral_tpu.drivers.common import make_sampler_factory
    from mlmcpathintegral_tpu.lattice2d import Lattice2D
    from mlmcpathintegral_tpu.mc import (
        MonteCarloMultiLevel, MonteCarloSingleLevel, MonteCarloTwoLevel,
    )
    from mlmcpathintegral_tpu.utils.config import (
        Section, _parse_value, read_parameter_file,
    )

    config = read_parameter_file(args.config)
    for item in args.set:
        key, raw = item.split("=", 1)
        sec, name = key.split(".", 1)
        config.setdefault(sec, {})[name] = _parse_value(raw)
    lat = Section(config, "lattice", defaults={"Mt_lat": 16, "Mx_lat": 16,
                                               "coarsening": "both"})
    lattice = Lattice2D(lat.get_int("Mt_lat"), lat.get_int("Mx_lat"),
                        qft.COARSEN[lat.get_string("coarsening")])
    action = qft.build_action(config, lattice)
    qoi_factory, qoi_name = qft.select_qoi(action)
    window = Section(config, "statistics",
                     defaults={"n_autocorr_window": 20}).get_int(
        "n_autocorr_window")
    method = Section(config, "general",
                     defaults={"method": "singlelevel"}).get_string(
        "method", {"singlelevel", "twolevel", "multilevel"})
    sec = Section(config, {"singlelevel": "singlelevelmc",
                           "twolevel": "twolevelmc",
                           "multilevel": "multilevelmc"}[method],
                  defaults={"sampler": "heatbath", "n_samples": 0})
    name = sec.get_string("sampler")
    if method == "multilevel":
        # the coarse chains of every level, as the JAX driver picks them
        name = Section(config, "hierarchical",
                       defaults={"coarsesampler": "heatbath"}).get_string(
            "coarsesampler")
    cond_factory = qft.select_cond_factory(action)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # random_order
        factory = make_sampler_factory(name, config,
                                       cond_factory=cond_factory,
                                       qoi_factory=qoi_factory)
    key = jax.random.PRNGKey(args.seed)
    t0 = time.monotonic()
    if method == "singlelevel":
        mc = MonteCarloSingleLevel(action, qoi_factory(action),
                                   factory(action), n_burnin=args.burnin,
                                   n_samples=args.chains * args.samples,
                                   n_autocorr_window=window)
        _, stats = mc.evaluate(key, args.chains, jnp.float64)
        num, err = mc.numerical_result(stats), mc.statistical_error(stats)
        tau, extra = mc.stats_Q.tau_int(stats), {
            "samples_per_chain": args.samples, "burnin": args.burnin}
    elif method == "multilevel":
        mc = MonteCarloMultiLevel(
            action, qoi_factory, factory, cond_factory,
            n_level=sec.get_int("n_level"), epsilon=sec.get_float("epsilon"),
            n_burnin=sec.get_int("n_burnin"),
            n_samples=sec.get_int("n_samples"), n_autocorr_window=window,
            n_min_samples_qoi=Section(
                config, "statistics",
                defaults={"n_min_samples_qoi": 100}).get_int(
                "n_min_samples_qoi"))
        mc.evaluate(key, args.chains, jnp.float64)
        num, err = mc.numerical_result(), mc.statistical_error()
        st = mc._final_stats
        tau = [mc.stats_qoi[ell].tau_int(s) for ell, s in enumerate(st)]
        extra = {"n_level": sec.get_int("n_level"),
                 "epsilon": sec.get_float("epsilon"),
                 "burnin": sec.get_int("n_burnin"),
                 "level_estimates": [mc.stats_qoi[ell].average(s)
                                     for ell, s in enumerate(st)],
                 "level_errors": [mc.stats_qoi[ell].error(s)
                                  for ell, s in enumerate(st)],
                 "level_samples": [mc.stats_qoi[ell].samples(s)
                                   for ell, s in enumerate(st)]}
    else:
        windows = {k: sec.get_int(k) for k in (
            "n_coarse_autocorr_window", "n_fine_autocorr_window",
            "n_delta_autocorr_window")}
        mc = MonteCarloTwoLevel(action, qoi_factory, factory, cond_factory,
                                n_burnin=sec.get_int("n_burnin"),
                                n_samples=sec.get_int("n_samples"),
                                n_autocorr_window=window, **windows)
        stats = mc.evaluate_difference(key, args.chains, jnp.float64)
        num = mc.stats_fine.average(stats["fine"])
        err = mc.stats_fine.error(stats["fine"])
        tau, extra = mc.stats_fine.tau_int(stats["fine"]), {
            "n_samples": sec.get_int("n_samples"),
            "burnin": sec.get_int("n_burnin"), "p_accept": mc.p_accept,
            "t_indep": mc.t_indep}
    ana = qft.analytical_results(action).get("analytical")
    print(json.dumps({
        "config": args.config, "set": args.set, "action":
        action.info_string(), "qoi": qoi_name, "method": method,
        "sampler": name, "chains": args.chains, **extra,
        "seed": args.seed, "estimate": num, "error": err, "tau_int": tau,
        "analytical": ana,
        "sigma_from_analytical": None if ana is None else (num - ana) / err,
        "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
