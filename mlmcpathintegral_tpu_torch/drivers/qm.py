"""Quantum-mechanics driver: the analog of the reference's ``driver_qm``
executable (src/driver_qm.cc:98-429); PyTorch port of
``mlmcpathintegral_tpu/drivers/qm.py``.

    python -m mlmcpathintegral_tpu_torch.drivers.qm <parameters.in>
        [--device cpu] [--seed 0]

Runs the selected method (singlelevel with any sampler, the hierarchical
and multilevel samplers included; twolevel; multilevel) on the selected
1-D action (harmonic, quartic or rotor), on the card unless ``--device
cpu`` asks for the CPU (where the kernels' plain versions run), and
prints the statistics and the |numerical - analytical| comparison in units
of the statistical error.  :func:`run` returns the result (estimate,
error, analytical value, timings) as a dict.
"""

from __future__ import annotations

import argparse
import sys

import torch

from mlmcpathintegral_tpu_torch.conditioned.qm import (
    make_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.drivers.common import (
    SAMPLER_CHOICES, banner, make_sampler_factory, parallel_setup, report,
    run_multilevel, run_singlelevel, run_twolevel, statistics_settings,
)
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.models import (
    HarmonicOscillatorAction, QuarticOscillatorAction, RenormalisationType,
    RotorAction,
)
from mlmcpathintegral_tpu_torch.qoi import qoi_susceptibility, qoi_x_squared
from mlmcpathintegral_tpu_torch.utils.config import (
    Section, read_parameter_file,
)

RENORM = {"none": RenormalisationType.NONE,
          "perturbative": RenormalisationType.PERTURBATIVE,
          "nonperturbative": RenormalisationType.NONPERTURBATIVE}


def build_action(config, lattice):
    """driver_qm.cc:226-268: construct the QM action from its section."""
    qm = Section(config, "quantummechanics", defaults={"action": "rotor"})
    name = qm.get_string("action", {"harmonicoscillator",
                                    "quarticoscillator", "rotor"})
    if name == "harmonicoscillator":
        sec = Section(config, "harmonicoscillator",
                      defaults={"m0": 1.0, "mu2": 1.0,
                                "renormalisation": "none"})
        return HarmonicOscillatorAction(
            lattice, RENORM[sec.get_string("renormalisation")],
            m0=sec.get_float("m0", positive=True),
            mu2=sec.get_float("mu2"))
    if name == "quarticoscillator":
        sec = Section(config, "quarticoscillator",
                      defaults={"m0": 1.0, "mu2": 1.0, "lambda": 1.0,
                                "x0": 0.0, "renormalisation": "none"})
        return QuarticOscillatorAction(
            lattice, RENORM[sec.get_string("renormalisation")],
            m0=sec.get_float("m0", positive=True),
            mu2=sec.get_float("mu2"), lam=sec.get_float("lambda"),
            x0=sec.get_float("x0"))
    sec = Section(config, "rotor",
                  defaults={"m0": 0.25, "renormalisation": "none"})
    return RotorAction(lattice, RENORM[sec.get_string("renormalisation")],
                       m0=sec.get_float("m0", positive=True))


def analytical_results(action):
    """Exact / perturbative values for the model's QoI
    (driver_qm.cc:273-311)."""
    if isinstance(action, HarmonicOscillatorAction):
        return {"analytical": action.Xsquared_analytical(),
                "continuum": action.Xsquared_analytical_continuum()}
    if isinstance(action, RotorAction):
        return {"analytical": action.chit_exact(),
                "perturbative": action.chit_perturbative(),
                "continuum": action.chit_continuum()}
    return {}


def run(config, device="cuda", seed=0, sampling_scope=None):
    """Run the configuration (a dict from ``read_parameter_file``) on
    ``device``; prints the reference driver's report and returns
    {"method", "action", "qoi", "numerical", "error", "analytical",
    "sigma_dev", "timings", ...} ("analytical" and "sigma_dev" are None
    for the quartic oscillator, which has no analytic value).
    ``sampling_scope``: a context manager (a profiler, say) the method
    enters around the phase that records its samples."""
    n_chains, dtype, device = parallel_setup(config, device)
    general = Section(config, "general", defaults={"method": "singlelevel"})
    method = general.get_string("method",
                                {"singlelevel", "twolevel", "multilevel"})
    lat_sec = Section(config, "lattice",
                      defaults={"M_lat": 32, "T_final": 4.0})
    lattice = Lattice1D(lat_sec.get_int("M_lat", positive=True),
                        lat_sec.get_float("T_final", positive=True))

    action = build_action(config, lattice)
    is_rotor = isinstance(action, RotorAction)
    qoi_factory = qoi_susceptibility if is_rotor else qoi_x_squared
    qoi_name = "chi_t" if is_rotor else "<x^2>"

    def sampler_factory_by(name):
        return make_sampler_factory(
            name, config, cond_factory=make_conditioned_fine_action,
            qoi_factory=qoi_factory)

    banner(action, method, n_chains, dtype, device)
    generator = torch.Generator().manual_seed(int(seed))
    result = {"method": method, "action": action.info_string(),
              "qoi": qoi_name, "n_chains": n_chains, "device": str(device)}
    if method == "singlelevel":
        sec = Section(config, "singlelevelmc",
                      defaults={"n_burnin": 100, "n_samples": 0,
                                "epsilon": 1e-2, "sampler": "HMC"})
        factory = sampler_factory_by(sec.get_string("sampler",
                                                    SAMPLER_CHOICES))
        numerical, stat_err, res = run_singlelevel(
            config, sec, action, qoi_factory(action), factory(action),
            generator, n_chains, dtype, device, sampling_scope)
    elif method == "twolevel":
        sec = Section(config, "twolevelmc",
                      defaults={"n_burnin": 100, "n_samples": 1000,
                                "sampler": "HMC"})
        numerical, stat_err, res = run_twolevel(
            sec, action, qoi_factory,
            sampler_factory_by(sec.get_string("sampler", SAMPLER_CHOICES)),
            make_conditioned_fine_action, generator, n_chains, dtype,
            device, sampling_scope,
            n_autocorr_window=statistics_settings(config)[0])
    else:
        coarse_name = Section(
            config, "hierarchical",
            defaults={"coarsesampler": "HMC",
                      "n_max_level": 3}).get_string("coarsesampler",
                                                    SAMPLER_CHOICES)
        numerical, stat_err, res = run_multilevel(
            config, action, qoi_factory, sampler_factory_by(coarse_name),
            make_conditioned_fine_action, generator, n_chains, dtype,
            device, sampling_scope)
    result.update(res)
    result.update(report(analytical_results(action), qoi_name, numerical,
                         stat_err))
    return result


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mlmcpathintegral_tpu_torch.drivers.qm",
        description="Run a QM parameter file on the port.")
    ap.add_argument("config", help="parameter file (.in)")
    ap.add_argument("--device", default=device,
                    help="'cuda' (the default: the card) or 'cpu'")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    run(read_parameter_file(args.config), device=args.device, seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
