"""The port's QM driver (drivers/qm.py), the QFT driver's Schwinger
two-level run and analytic lines (drivers/qft.py) and the sampler factory's
hierarchical and multilevel branches (drivers/common.py) on the CPU: the
analytic values against the JAX package's to 1e-12; every QM parameter file
of the repository read into the same action, method and sampler parameters
by both drivers; the driver end to end with ``--device cpu`` for each
method and sampler on the three actions at a small size; the errors JAX
raises (the entry points' default device: tests/test_torch_drivers.py)."""

import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.conditioned import (
    make_conditioned_fine_action as j_cond,
)
from mlmcpathintegral_tpu.drivers import common as jcommon
from mlmcpathintegral_tpu.drivers import qm as jqm
from mlmcpathintegral_tpu.lattice import Lattice1D as JLattice1D
from mlmcpathintegral_tpu.models.qft import schwinger as jschwinger
from mlmcpathintegral_tpu.qoi import qoi_susceptibility as j_qoi_sus
from mlmcpathintegral_tpu.qoi import qoi_x_squared as j_qoi_x2
from mlmcpathintegral_tpu.utils import special as jspecial
from mlmcpathintegral_tpu_torch.conditioned import (
    make_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.drivers import common, qft, qm
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.models.qft import schwinger as tschwinger
from mlmcpathintegral_tpu_torch.qoi import qoi_susceptibility, qoi_x_squared
from mlmcpathintegral_tpu_torch.utils import config as tconfig
from mlmcpathintegral_tpu_torch.utils import special as tspecial

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
QM_FILES = sorted(str(p.relative_to(REPO)) for p in
                  list((REPO / "baselines/configs").glob("ref_qm_*.in"))
                  + list((REPO / "configs").glob("qm_*.in")))


@pytest.mark.parametrize("beta, n_plaq", [(4.0, 64), (2.0, 16), (8.0, 256)])
def test_schwinger_analytic_values_match_jax(beta, n_plaq):
    for name in ("Phi_chit_perturbative", "Phi_chit"):
        assert getattr(tspecial, name)(beta, n_plaq) == pytest.approx(
            getattr(jspecial, name)(beta, n_plaq), rel=0, abs=1e-12)
    for name in ("chit_perturbative", "chit_var_continuum",
                 "chit_analytical"):
        assert getattr(tschwinger, name)(beta, n_plaq) == pytest.approx(
            getattr(jschwinger, name)(beta, n_plaq), rel=0, abs=1e-12)


def _read(name):
    cfg = tconfig.read_parameter_file(REPO / name)
    return cfg, jqm.read_parameter_file(REPO / name)


def _actions(cfg, jcfg):
    lat = tconfig.Section(cfg, "lattice",
                          defaults={"M_lat": 32, "T_final": 4.0})
    M, T = lat.get_int("M_lat"), lat.get_float("T_final")
    return (qm.build_action(cfg, Lattice1D(M, T)),
            jqm.build_action(jcfg, JLattice1D(M, T)))


PARAMS = ("nt", "dt0", "n_rep", "n_burnin", "use_pallas",
          "n_sweep_heatbath", "n_sweep_overrelax", "n_updates", "n_level")


def _params(sampler):
    """The sampler's type and parameters, the coarse sampler's nested."""
    out = {"type": type(sampler).__name__}
    out.update({k: getattr(sampler, k) for k in PARAMS
                if hasattr(sampler, k)})
    if hasattr(sampler, "coarse_sampler"):
        out["coarse"] = _params(sampler.coarse_sampler)
    return out


@pytest.mark.parametrize("name", QM_FILES)
def test_config_gives_the_same_objects_as_jax(name):
    cfg, jcfg = _read(name)
    act, jact = _actions(cfg, jcfg)
    assert act.info_string() == jact.info_string()
    for got, want in zip(qm.analytical_results(act).items(),
                         jqm.analytical_results(jact).items()):
        assert got[0] == want[0]
        assert got[1] == pytest.approx(want[1], rel=0, abs=1e-12)
    sec = ("general", {"method": "singlelevel"}, "method",
           {"singlelevel", "twolevel", "multilevel"})
    assert tconfig.Section(cfg, *sec[:2]).get_string(*sec[2:]) \
        == jqm.Section(jcfg, *sec[:2]).get_string(*sec[2:])
    rotor = type(act).__name__ == "RotorAction"
    names = {"HMC", "heatbath", "cluster", "hierarchical", "multilevel"}
    for key, sec_name in (("sampler", "singlelevelmc"),
                          ("sampler", "twolevelmc"),
                          ("coarsesampler", "hierarchical")):
        if key in cfg.get(sec_name, {}):
            names.add(cfg[sec_name][key])
    names.discard("exact" if rotor else "")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # random_order
        for sampler in sorted(names):
            t = common.make_sampler_factory(
                sampler, cfg, cond_factory=make_conditioned_fine_action,
                qoi_factory=qoi_susceptibility if rotor else qoi_x_squared)
            j = jcommon.make_sampler_factory(
                sampler, jcfg, cond_factory=j_cond,
                qoi_factory=j_qoi_sus if rotor else j_qoi_x2)
            assert _params(t(act)) == _params(j(jact)), sampler


SMALL = """
general:
  method = '{method}'
quantummechanics:
  action = '{action}'
lattice:
  M_lat = 16
  T_final = 4.0
rotor:
  m0 = 0.25
quarticoscillator:
  m0 = 1.0
  mu2 = 1.0
  lambda = 1.0
  x0 = 1.0
singlelevelmc:
  n_burnin = 10
  n_samples = 256
  sampler = '{sampler}'
twolevelmc:
  n_burnin = 10
  n_samples = 64
  sampler = '{sampler}'
multilevelmc:
  n_level = 2
  n_burnin = 10
  n_samples = 64
hierarchical:
  n_max_level = 2
  coarsesampler = '{coarse}'
hmc:
  nt = 5
  dt = 0.2
  n_burnin = 5
  use_pallas = true
heatbath:
  n_burnin = 5
  use_pallas = true
clusteralgorithm:
  n_burnin = 5
  n_updates = 2
parallel:
  n_chains = 8
  dtype = 'float64'
"""

RUNS = [  # (method, action, sampler, coarse sampler)
    ("singlelevel", "harmonicoscillator", "HMC", "HMC"),
    ("singlelevel", "harmonicoscillator", "exact", "HMC"),
    ("singlelevel", "harmonicoscillator", "hierarchical", "HMC"),
    ("singlelevel", "quarticoscillator", "multilevel", "HMC"),
    ("singlelevel", "rotor", "heatbath", "HMC"),
    ("singlelevel", "rotor", "cluster", "HMC"),
    ("singlelevel", "rotor", "hierarchical", "heatbath"),
    ("twolevel", "quarticoscillator", "HMC", "HMC"),
    ("twolevel", "rotor", "cluster", "HMC"),
    ("multilevel", "harmonicoscillator", "HMC", "exact"),
    ("multilevel", "rotor", "HMC", "cluster"),
]


class _Scope:
    """A ``sampling_scope`` that records how long each entry lasted."""

    def __init__(self):
        self.spans = []

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.spans.append(time.monotonic() - self.t0)
        return False


@pytest.mark.parametrize("method, action, sampler, coarse", RUNS,
                         ids=["-".join(r[:3]) for r in RUNS])
def test_qm_driver_runs_on_the_cpu(tmp_path, capsys, method, action,
                                   sampler, coarse):
    p = tmp_path / "run.in"
    p.write_text(SMALL.format(method=method, action=action, sampler=sampler,
                              coarse=coarse))
    if method == "singlelevel" and sampler == "HMC":
        # the command line once: the file through main()
        assert qm.main([str(p), "--device", "cpu", "--seed", "1"]) == 0
        out = capsys.readouterr().out
        assert "device: cpu" in out and "statistical error" in out
        assert "<x^2> [analytical]" in out
        return
    scope = _Scope()
    res = qm.run(tconfig.read_parameter_file(p), device="cpu", seed=2,
                 sampling_scope=scope)
    out = capsys.readouterr().out
    assert f"method  : {method}" in out and "device: cpu" in out
    # the scope is entered once, around the phases that record the
    # samples (MLMC: its cost measurement and adaptive loop)
    recording = sum(res["timings"].get(k, 0.0)
                    for k in ("cost_measure_s", "sampling_s"))
    assert len(scope.spans) == 1 and scope.spans[0] >= recording
    assert res["device"] == "cpu" and np.isfinite(res["numerical"])
    assert res["error"] > 0.0
    if action == "quarticoscillator":
        assert res["analytical"] is None and res["sigma_dev"] is None
        return
    assert "[analytical]" in out and "statistical error" in out
    assert np.isfinite(res["sigma_dev"])
    if sampler == "hierarchical":
        assert "Per-level sampler statistics" in out
        assert len(res["level_acceptance"]) == 2


def test_schwinger_twolevel_and_report_lines(tmp_path, capsys):
    p = tmp_path / "s.in"
    p.write_text("""
general:
  method = 'twolevel'
quantumfieldtheory:
  action = 'quenchedschwinger'
lattice:
  Mt_lat = 4
  Mx_lat = 4
  coarsening = 'both'
schwinger:
  beta = 1.0
  renormalisation = 'none'
twolevelmc:
  n_burnin = 10
  n_samples = 128
  sampler = 'heatbath'
  n_fine_autocorr_window = 7
heatbath:
  n_burnin = 10
  use_pallas = true
parallel:
  n_chains = 8
  dtype = 'float64'
""")
    res = qft.run(tconfig.read_parameter_file(p), device="cpu")
    out = capsys.readouterr().out
    for line in ("V chi_t [analytical]", "V chi_t [perturbative]",
                 "V chi_t [continuum variance]", "two-level acceptance",
                 "statistical error"):
        assert line in out
    assert res["method"] == "twolevel" and np.isfinite(res["numerical"])
    assert res["samples"] == 128 and 0.0 < res["p_accept"] <= 1.0


def test_sampler_factory_errors_match_jax():
    cfg = {"hierarchical": {"n_max_level": 3, "coarsesampler": "exact"}}
    for name, kw, match in (
            ("hierarchical", {}, "conditioned fine action factory"),
            ("multilevel", {"cond_factory": make_conditioned_fine_action},
             "conditioned fine action and QoI factories"),
            ("nosuch", {}, "unknown sampler")):
        with pytest.raises(ValueError, match=match):
            common.make_sampler_factory(name, cfg, **kw)
        jkw = {"cond_factory": j_cond} if kw else {}
        with pytest.raises(ValueError, match=match):
            jcommon.make_sampler_factory(name, cfg, **jkw)
    cfg1 = {"hierarchical": {"n_max_level": 1, "coarsesampler": "exact"}}
    act = qm.build_action({"quantummechanics": {
        "action": "harmonicoscillator"}}, Lattice1D(16, 4.0))
    for name in ("hierarchical", "multilevel"):
        f = common.make_sampler_factory(
            name, cfg1, cond_factory=make_conditioned_fine_action,
            qoi_factory=qoi_x_squared)
        with pytest.raises(ValueError, match="need >= 2 levels"):
            f(act)


@pytest.mark.parametrize("variant", ["hierarchical", "multilevel"])
def test_gff_hierarchical_samplers_name_item_11(tmp_path, variant):
    p = tmp_path / "g.in"
    p.write_text(f"""
general:
  method = 'singlelevel'
quantumfieldtheory:
  action = 'gff'
lattice:
  Mt_lat = 4
  Mx_lat = 4
singlelevelmc:
  sampler = '{variant}'
hierarchical:
  coarsesampler = 'exact'
parallel:
  n_chains = 4
  dtype = 'float64'
""")
    # the GFF's hierarchical samplers run now; on the file's default
    # both-direction coarsening the conditioned fill refuses the
    # hierarchy, with the JAX package's error
    from mlmcpathintegral_tpu.drivers import qft as jqft
    errors = []
    for main, args in ((qft.main, [str(p), "--device", "cpu"]),
                       (jqft.main, [str(p)])):
        with pytest.raises(ValueError) as e:
            main(args)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "only coarse nearest" in errors[0]
    # on the rotate hierarchy the run holds the oracle
    p.write_text(p.read_text().replace(
        "Mx_lat = 4", "Mx_lat = 4\n  coarsening = 'rotate'").replace(
        "singlelevelmc:", "singlelevelmc:\n  n_burnin = 10\n"
        "  n_samples = 1024").replace("n_chains = 4", "n_chains = 16"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = qft.run(tconfig.read_parameter_file(p), device="cpu")
    assert np.isfinite(res["numerical"]) and res["sigma_dev"] < 4.0, res

