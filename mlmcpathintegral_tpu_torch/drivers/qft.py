"""QFT driver: the analog of the reference's ``driver_qft`` executable
(src/driver_qft.cc:100-459); PyTorch port of
``mlmcpathintegral_tpu/drivers/qft.py``.

    python -m mlmcpathintegral_tpu_torch.drivers.qft <parameters.in>
        [--device cpu] [--seed 0]

Runs on the card unless ``--device cpu`` asks for the CPU (where the
kernels' plain versions run).  Ported so far: the Gaussian free field
single-level (heat bath, with ``heatbath: use_pallas`` on the fused sweep
kernel, or exact draws), the quenched Schwinger model single-level (with
the average-plaquette report) and the Schwinger multilevel on the ported
samplers.  Every other combination raises ``NotImplementedError`` naming
its ROADMAP.md item.  :func:`run` returns the result (estimate, error,
analytical value, timings) as a dict.
"""

from __future__ import annotations

import argparse
import sys

import torch

from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.drivers.common import (
    SAMPLER_CHOICES, make_sampler_factory, parallel_setup,
)
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.mc.multilevel import MonteCarloMultiLevel
from mlmcpathintegral_tpu_torch.mc.singlelevel import MonteCarloSingleLevel
from mlmcpathintegral_tpu_torch.mc.twolevel import (
    chunk_generator, run_generators,
)
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.qoi import (
    qoi_2d_phi_squared, qoi_2d_susceptibility, qoi_avg_plaquette,
)
from mlmcpathintegral_tpu_torch.samplers.cluster import ClusterSampler
from mlmcpathintegral_tpu_torch.samplers.schwingercluster import (
    QuenchedSchwingerClusterSampler,
)
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
from mlmcpathintegral_tpu_torch.utils.config import (
    Section, read_parameter_file,
)
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics

RENORM = {"none": RenormalisationType.NONE,
          "perturbative": RenormalisationType.PERTURBATIVE,
          "nonperturbative": RenormalisationType.NONPERTURBATIVE}

COARSEN = {"both": CoarseningType.BOTH, "temporal": CoarseningType.TEMPORAL,
           "spatial": CoarseningType.SPATIAL,
           "alternate": CoarseningType.ALTERNATE,
           "rotate": CoarseningType.ROTATE}


def build_action(config, lattice):
    qft = Section(config, "quantumfieldtheory",
                  defaults={"action": "quenchedschwinger"})
    name = qft.get_string("action", {"quenchedschwinger", "nonlinearsigma",
                                     "gff"})
    if name == "quenchedschwinger":
        sec = Section(config, "schwinger",
                      defaults={"beta": 1.0, "renormalisation": "none"})
        return QuenchedSchwingerAction(
            lattice, beta=sec.get_float("beta", positive=True),
            renormalisation=RENORM[sec.get_string("renormalisation")])
    if name == "gff":
        sec = Section(config, "gff",
                      defaults={"mass": 1.0, "renormalisation": "none"})
        return GFFAction(lattice, mass=sec.get_float("mass", positive=True))
    raise NotImplementedError("the O(3) nonlinear sigma model is not ported "
                              "yet (ROADMAP.md, open item 12)")


def select_qoi(action):
    if isinstance(action, QuenchedSchwingerAction):
        return qoi_2d_susceptibility, "V chi_t"
    return qoi_2d_phi_squared, "<phi^2>"


def analytical_results(action):
    """driver_qft.cc:280-316 (the Schwinger model's perturbative and
    continuum values are not ported)."""
    if isinstance(action, QuenchedSchwingerAction):
        return {"analytical": action.chit_exact()}
    return {"analytical": action.phi_squared_analytical()}


def _unported_method(method, action):
    if isinstance(action, GFFAction):
        return NotImplementedError(
            f"the GFF {method} method needs the conditioned GFF fill "
            f"(conditioned/gff.py), not ported yet (ROADMAP.md, open item "
            f"11)")
    return NotImplementedError(
        f"the driver's {method} method on the Schwinger model is not "
        f"ported yet (ROADMAP.md, open item 9); its multilevel method is")


def run(config, device="cuda", seed=0):
    """Run the configuration (a dict from ``read_parameter_file``) on
    ``device``; prints the reference driver's report and returns
    {"method", "action", "qoi", "numerical", "error", "analytical",
    "sigma_dev", "timings", ...}."""
    n_chains, dtype, device = parallel_setup(config, device)
    general = Section(config, "general", defaults={"method": "singlelevel"})
    method = general.get_string("method",
                                {"singlelevel", "twolevel", "multilevel"})
    lat_sec = Section(config, "lattice",
                      defaults={"Mt_lat": 16, "Mx_lat": 16,
                                "coarsening": "both"})
    lattice = Lattice2D(lat_sec.get_int("Mt_lat", positive=True),
                        lat_sec.get_int("Mx_lat", positive=True),
                        COARSEN[lat_sec.get_string("coarsening")])
    stats_sec = Section(config, "statistics",
                        defaults={"n_autocorr_window": 20,
                                  "n_min_samples_qoi": 100})
    n_autocorr = stats_sec.get_int("n_autocorr_window", positive=True)
    n_min_samples = stats_sec.get_int("n_min_samples_qoi", positive=True)

    action = build_action(config, lattice)
    qoi_factory, qoi_name = select_qoi(action)
    is_schwinger = isinstance(action, QuenchedSchwingerAction)
    cluster_cls = (QuenchedSchwingerClusterSampler if is_schwinger
                   else ClusterSampler)
    if method == "twolevel" or (method == "multilevel" and not is_schwinger):
        raise _unported_method(method, action)

    print("+--------------------------------+")
    print("! multilevel MCMC (PyTorch)      !")
    print("+--------------------------------+")
    print(f"action  : {action.info_string()}")
    print(f"method  : {method}")
    print(f"chains  : {n_chains}  dtype: {dtype}  device: {device}")
    print()

    generator = torch.Generator().manual_seed(int(seed))
    result = {"method": method, "action": action.info_string(),
              "qoi": qoi_name, "n_chains": n_chains, "device": str(device)}
    if method == "singlelevel":
        sec = Section(config, "singlelevelmc",
                      defaults={"n_burnin": 100, "n_samples": 0,
                                "epsilon": 1e-2, "sampler": "heatbath"})
        factory = make_sampler_factory(
            sec.get_string("sampler", SAMPLER_CHOICES), config, cluster_cls)
        mc = MonteCarloSingleLevel(
            action, qoi_factory(action), factory(action),
            n_burnin=sec.get_int("n_burnin", positive=True),
            n_samples=sec.get_int("n_samples", non_negative=True),
            epsilon=sec.get_float("epsilon", positive=True),
            n_autocorr_window=n_autocorr,
            n_min_samples_qoi=n_min_samples,
            qoi_log_path=config.get("singlelevelmc", {}).get(
                "qoi_log_path"),
            save_states_path=config.get("singlelevelmc", {}).get(
                "save_states_path"))
        _, stats = mc.evaluate(generator, n_chains, dtype, device,
                               verbose=True)
        mc.show_statistics(stats)
        print(f" sampler acceptance p = {mc.p_accept:.5f}")
        numerical = mc.numerical_result(stats)
        stat_err = mc.statistical_error(stats)
        result.update(tau_int=mc.stats_Q.tau_int(stats),
                      samples=mc.stats_Q.samples(stats),
                      sampling_draws=mc.n_sampling_draws,
                      p_accept=mc.p_accept, timings=dict(mc.timings))
        if is_schwinger:
            result["avg_plaquette"] = _report_plaquette(
                action, factory, n_chains, dtype, device, generator)
    else:
        sec = Section(config, "multilevelmc",
                      defaults={"n_level": 3, "n_burnin": 100,
                                "epsilon": 1.0, "n_samples": 0,
                                "show_detailed_stats": False,
                                "sampler": "hierarchical"})
        coarse_name = Section(
            config, "hierarchical",
            defaults={"coarsesampler": "heatbath",
                      "n_max_level": 3}).get_string("coarsesampler",
                                                    SAMPLER_CHOICES)
        mc = MonteCarloMultiLevel(
            action, qoi_factory,
            make_sampler_factory(coarse_name, config, cluster_cls),
            make_schwinger_conditioned_fine_action,
            n_level=sec.get_int("n_level", positive=True),
            epsilon=sec.get_float("epsilon", positive=True),
            n_burnin=sec.get_int("n_burnin", positive=True),
            n_samples=sec.get_int("n_samples", non_negative=True),
            n_autocorr_window=n_autocorr,
            n_min_samples_qoi=n_min_samples)
        stats = mc.evaluate(generator, n_chains, dtype, device,
                            verbose=True)
        numerical, stat_err = mc.numerical_result(), mc.statistical_error()
        print(f" Q: Avg +/- Err = {numerical:.6f} +/- {stat_err:.6f}")
        print(f" [timer MultilevelMC] : {mc.elapsed_s:.4f} s")
        if sec.get_bool("show_detailed_stats"):
            print("=== Statistics of QoI ===")
            for ell in range(mc.n_level):
                print(f"level = {ell}")
                print(mc.stats_qoi[ell].summary(stats[ell]))
        result.update(timings=dict(mc.timings))

    print()
    ana = analytical_results(action)
    for label, value in ana.items():
        print(f" {qoi_name} [{label}]  = {value:.6f}")
    dev = abs(numerical - ana["analytical"]) / stat_err
    print(f" |numerical - analytical| = "
          f"{abs(numerical - ana['analytical']):.6f} = {dev:.2f} * "
          f"statistical error")
    result.update(numerical=numerical, error=stat_err,
                  analytical=ana["analytical"], sigma_dev=dev)
    return result


def _report_plaquette(action, factory, n_chains, dtype, device, generator):
    """Short extra average-plaquette measurement for the Schwinger model
    (the reference driver reports both QoIs) over 200 draws: (average,
    error)."""
    sampler = factory(action)
    qoi = qoi_avg_plaquette(action)
    next_seed, setup_gen = run_generators(generator, device)
    state = sampler.prepare(setup_gen, n_chains, dtype, device)
    gen = chunk_generator(next_seed(), "cpu" if sampler.host_seeded
                          else device)
    qs = []
    for _ in range(200):
        state, _ = sampler.draw(gen, state)
        qs.append(qoi(sampler.x_of(state)))
    stats = Statistics("plaq", 20)
    st = stats_mod.record_block(stats.init(n_chains, dtype, device),
                                torch.stack(qs))
    avg, err = stats.average(st), stats.error(st)
    print(f" avg plaquette = {avg:.6f} +/- {err:.6f}")
    return avg, err


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mlmcpathintegral_tpu_torch.drivers.qft",
        description="Run a QFT parameter file on the port.")
    ap.add_argument("config", help="parameter file (.in)")
    ap.add_argument("--device", default=device,
                    help="'cuda' (the default: the card) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(read_parameter_file(args.config), device=args.device, seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
