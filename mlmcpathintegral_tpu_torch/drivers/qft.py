"""QFT driver: the analog of the reference's ``driver_qft`` executable
(src/driver_qft.cc:100-459); PyTorch port of
``mlmcpathintegral_tpu/drivers/qft.py``.

    python -m mlmcpathintegral_tpu_torch.drivers.qft <parameters.in>
        [--device cpu] [--seed 0]

Runs on the card unless ``--device cpu`` asks for the CPU (where the
kernels' plain versions run).  The quenched Schwinger model (any
coarsening, with the average-plaquette report), the Gaussian free field
and the O(3) nonlinear sigma model, each single-level (any sampler, the
hierarchical and multilevel ones included), two-level and multilevel; as
in the reference (driver_qft.cc:406-411), the multilevel method is
refused for the sigma model.  :func:`run` returns the result (estimate,
error, analytical value, timings) as a dict.
"""

from __future__ import annotations

import argparse
import sys

import torch

from mlmcpathintegral_tpu_torch.conditioned.gff import (
    GFFConditionedFineAction,
)
from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.conditioned.sigma import (
    NonlinearSigmaConditionedFineAction,
)
from mlmcpathintegral_tpu_torch.drivers.common import (
    SAMPLER_CHOICES, banner, make_sampler_factory, parallel_setup, report,
    run_multilevel, run_singlelevel, run_twolevel, statistics_settings,
)
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.mc.twolevel import (
    chunk_generator, run_generators,
)
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
from mlmcpathintegral_tpu_torch.models.qft.nonlinearsigma import (
    NonlinearSigmaAction, qoi_magnetic_susceptibility,
)
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
    sec = Section(config, "nonlinearsigma",
                  defaults={"beta": 1.0, "renormalisation": "none"})
    return NonlinearSigmaAction(
        lattice, beta=sec.get_float("beta", positive=True),
        renormalisation=RENORM[sec.get_string("renormalisation")])


def select_qoi(action):
    if isinstance(action, QuenchedSchwingerAction):
        return qoi_2d_susceptibility, "V chi_t"
    if isinstance(action, GFFAction):
        return qoi_2d_phi_squared, "<phi^2>"
    return qoi_magnetic_susceptibility, "chi_m"


def select_cond_factory(action):
    if isinstance(action, QuenchedSchwingerAction):
        return make_schwinger_conditioned_fine_action
    if isinstance(action, GFFAction):
        return GFFConditionedFineAction
    return NonlinearSigmaConditionedFineAction


def analytical_results(action):
    """driver_qft.cc:280-316."""
    if isinstance(action, QuenchedSchwingerAction):
        return {"analytical": action.chit_exact(),
                "perturbative": action.chit_perturbative(),
                "continuum variance": action.chit_continuum_variance()}
    if isinstance(action, GFFAction):
        return {"analytical": action.phi_squared_analytical()}
    return {}


#: the line the reference prints for a refused combination
SIGMA_MULTILEVEL_ERROR = ("ERROR: multilevel method not supported for the "
                          "nonlinear sigma model (matches "
                          "driver_qft.cc:406-411)")


def _method_and_lattice(config):
    general = Section(config, "general", defaults={"method": "singlelevel"})
    method = general.get_string("method",
                                {"singlelevel", "twolevel", "multilevel"})
    lat_sec = Section(config, "lattice",
                      defaults={"Mt_lat": 16, "Mx_lat": 16,
                                "coarsening": "both"})
    lattice = Lattice2D(lat_sec.get_int("Mt_lat", positive=True),
                        lat_sec.get_int("Mx_lat", positive=True),
                        COARSEN[lat_sec.get_string("coarsening")])
    return method, lattice


def refusal(config):
    """The reference's error line for a combination it refuses (the
    multilevel method on the sigma model), else None."""
    qft = Section(config, "quantumfieldtheory",
                  defaults={"action": "quenchedschwinger"})
    if (qft.get_string("action") == "nonlinearsigma"
            and _method_and_lattice(config)[0] == "multilevel"):
        return SIGMA_MULTILEVEL_ERROR
    return None


def run(config, device="cuda", seed=0, sampling_scope=None):
    """Run the configuration (a dict from ``read_parameter_file``) on
    ``device`` (a combination the reference refuses raises ValueError
    after its error line); prints the reference driver's report and
    returns
    {"method", "action", "qoi", "numerical", "error", "analytical",
    "sigma_dev", "timings", ...}.  ``sampling_scope``: a context manager
    (a profiler, say) the method enters around the phase that records its
    samples."""
    n_chains, dtype, device = parallel_setup(config, device)
    method, lattice = _method_and_lattice(config)
    action = build_action(config, lattice)
    qoi_factory, qoi_name = select_qoi(action)
    cond_factory = select_cond_factory(action)
    is_schwinger = isinstance(action, QuenchedSchwingerAction)
    cluster_cls = (QuenchedSchwingerClusterSampler if is_schwinger
                   else ClusterSampler)
    error = refusal(config)
    if error is not None:
        print(error)
        raise ValueError(error)

    def sampler_factory_by(name):
        return make_sampler_factory(name, config, cond_factory=cond_factory,
                                    cluster_cls=cluster_cls,
                                    qoi_factory=qoi_factory)

    banner(action, method, n_chains, dtype, device)
    generator = torch.Generator().manual_seed(int(seed))
    result = {"method": method, "action": action.info_string(),
              "qoi": qoi_name, "n_chains": n_chains, "device": str(device)}
    if method == "singlelevel":
        sec = Section(config, "singlelevelmc",
                      defaults={"n_burnin": 100, "n_samples": 0,
                                "epsilon": 1e-2, "sampler": "heatbath"})
        factory = sampler_factory_by(sec.get_string("sampler",
                                                    SAMPLER_CHOICES))
        numerical, stat_err, res = run_singlelevel(
            config, sec, action, qoi_factory(action), factory(action),
            generator, n_chains, dtype, device, sampling_scope)
        result.update(res)
        if is_schwinger:
            result["avg_plaquette"] = _report_plaquette(
                action, factory, n_chains, dtype, device, generator)
    elif method == "twolevel":
        sec = Section(config, "twolevelmc",
                      defaults={"n_burnin": 100, "n_samples": 1000,
                                "sampler": "heatbath",
                                "n_coarse_autocorr_window": 20,
                                "n_fine_autocorr_window": 20,
                                "n_delta_autocorr_window": 20})
        windows = {k: sec.get_int(k, positive=True) for k in (
            "n_coarse_autocorr_window", "n_fine_autocorr_window",
            "n_delta_autocorr_window")}
        numerical, stat_err, res = run_twolevel(
            sec, action, qoi_factory,
            sampler_factory_by(sec.get_string("sampler", SAMPLER_CHOICES)),
            cond_factory, generator, n_chains, dtype, device, sampling_scope,
            n_autocorr_window=statistics_settings(config)[0], **windows)
        result.update(res)
    else:
        coarse_name = Section(
            config, "hierarchical",
            defaults={"coarsesampler": "heatbath",
                      "n_max_level": 3}).get_string("coarsesampler",
                                                    SAMPLER_CHOICES)
        numerical, stat_err, res = run_multilevel(
            config, action, qoi_factory, sampler_factory_by(coarse_name),
            cond_factory, generator, n_chains, dtype, device,
            sampling_scope)
        result.update(res)
    result.update(report(analytical_results(action), qoi_name, numerical,
                         stat_err))
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
    config = read_parameter_file(args.config)
    error = refusal(config)
    if error is not None:
        print(error)
        return 1
    run(config, device=args.device, seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
