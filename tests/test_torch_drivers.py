"""The port's config reader (utils/config.py), single-level method
(mc/singlelevel.py) and QFT driver (drivers/common.py, drivers/qft.py) on
the CPU: the reader against the JAX package's on the repository's
parameter files; MonteCarloSingleLevel's adaptive target against JAX's on
the same statistics (numpy-made QoI series, carried over with
``convert``) and its draw schedule; the driver end to end with
``--device cpu`` against the analytic oracles (4 sigma), every model,
method and coarsening the JAX driver runs among them; the combinations
the JAX driver refuses, refused with its error; and the card as the
driver's default device."""

import inspect
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.mc import MonteCarloSingleLevel as JSingleLevel
from mlmcpathintegral_tpu.utils import config as jconfig
from mlmcpathintegral_tpu.utils import statistics as jstats
from mlmcpathintegral_tpu_torch import convert
from mlmcpathintegral_tpu_torch.drivers import common, qft, qm
from mlmcpathintegral_tpu_torch.mc import MonteCarloSingleLevel
from mlmcpathintegral_tpu_torch.mc import singlelevel as msl
from mlmcpathintegral_tpu_torch.samplers import ExactState, Sampler
from mlmcpathintegral_tpu_torch.utils import config as tconfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PARAMETER_FILES = ["parameters_qm_template.in", "parameters_qft_template.in",
                   "configs/qft_gff_twolevel.in",
                   "configs/qft_schwinger_multilevel.in",
                   "configs/qm_harmonic_singlelevel.in",
                   "configs/qm_rotor_multilevel.in",
                   "baselines/configs/ref_qft_gff_twolevel.in"]

GFF_SMOKE = """
general:
  method = 'singlelevel'
quantumfieldtheory:
  action = 'gff'
lattice:
  Mt_lat = 4
  Mx_lat = 4
  coarsening = 'rotate'
gff:
  mass = 2.0
  renormalisation = 'none'
singlelevelmc:
  n_burnin = 10
  n_samples = 400
  epsilon = 1.0E-2
  sampler = 'exact'
parallel:
  n_chains = 16
  dtype = 'float64'
"""

HEATBATH = """
heatbath:
  n_sweep_overrelax = 1
  n_sweep_heatbath = 1
  n_burnin = 20
  use_pallas = true
"""


@pytest.mark.parametrize("name", PARAMETER_FILES)
def test_config_reader_matches_jax(name):
    got = tconfig.read_parameter_file(REPO / name)
    assert got == jconfig.read_parameter_file(REPO / name)
    assert "general" in got and "lattice" in got


def test_section_checks_match_jax(tmp_path):
    p = tmp_path / "t.in"
    p.write_text("general:\n  method = 'twolevel'  # comment\n"
                 "lattice:\n  M_lat = 32\n  T_final = 4.0\n  n = -1\n"
                 "flags:\n  on = true\n")
    for mod in (tconfig, jconfig):
        cfg = mod.read_parameter_file(p)
        lat = mod.Section(cfg, "lattice", defaults={"extra": 7})
        assert lat.get_int("M_lat", positive=True) == 32
        assert lat.get_float("T_final", positive=True) == 4.0
        assert lat.get_float("M_lat") == 32.0 and lat.get_int("extra") == 7
        assert mod.Section(cfg, "flags").get_bool("on") is True
        with pytest.raises(KeyError):
            lat.get_int("missing")
        with pytest.raises(TypeError):
            lat.get_string("M_lat")
        with pytest.raises(ValueError, match="non-negative"):
            lat.get_int("n", non_negative=True)
        with pytest.raises(ValueError, match="not in"):
            mod.Section(cfg, "general").get_string("method",
                                                   {"singlelevel"})
    bad = tmp_path / "bad.in"
    bad.write_text("general:\n  this is not = = valid\n")
    with pytest.raises(ValueError, match="cannot parse"):
        tconfig.read_parameter_file(bad)
    bad.write_text("key = 1\n")
    with pytest.raises(ValueError, match="outside any section"):
        tconfig.read_parameter_file(bad)


@pytest.mark.parametrize("rho, window, n_samples", [
    (0.0, 20, 0),        # iid: the windowed tau
    (0.9, 20, 0),        # correlated, inside the window
    (0.98, 5, 0),        # window-capped: the binning cross-check
    (0.5, 20, 12345),    # a fixed target
])
def test_singlelevel_target_matches_jax(rho, window, n_samples):
    C, T = 32, 600
    rs = np.random.default_rng(int(100 * rho) + window)
    Q = np.empty((T, C))
    Q[0] = rs.normal(size=C)
    for t in range(1, T):
        Q[t] = rho * Q[t - 1] + np.sqrt(1 - rho * rho) * rs.normal(size=C)
    Q = 1.0 + 0.3 * Q
    kw = dict(n_samples=n_samples, epsilon=2e-3, n_autocorr_window=window,
              n_min_samples_qoi=1000)
    jmc = JSingleLevel(None, None, None, **kw)
    tmc = MonteCarloSingleLevel(None, None, None, **kw)
    jst = jstats.record_many(jmc.stats_Q.init(C, jnp.float64),
                             jnp.asarray(Q))
    tst = convert.to_torch(jst, device="cpu")
    jmc._qbar_history = [jnp.asarray(Q.mean(axis=1))]
    tmc._qbar_history = [torch.from_numpy(Q.mean(axis=1))]
    two_eps_inv2 = 2.0 / kw["epsilon"] ** 2
    want = jmc._target(jst, two_eps_inv2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the capped-window warning
        assert tmc._target(tst, two_eps_inv2) == want
        assert tmc.stats_Q.window_capped(tst) == (window == 5)
    assert want > 1000 or n_samples


class _CountingSampler(Sampler):
    """Counts draws and the devices of the generators it is handed."""

    def __init__(self, host_seeded):
        super().__init__(None)
        self.host_seeded = host_seeded
        self.draws = 0

    def init(self, generator, n_chains, dtype, device):
        return ExactState(x=torch.zeros(n_chains, 4, dtype=dtype))

    def draw(self, generator, state):
        self.draws += 1
        return (ExactState(x=torch.randn(state.x.shape, generator=generator,
                                         dtype=state.x.dtype)),
                torch.ones(state.x.shape[0], dtype=torch.bool))

    def prepare(self, generator, n_chains, dtype, device):
        return super().prepare(generator, n_chains, dtype, device, 100)


@pytest.mark.parametrize("host_seeded", [True, False])
def test_singlelevel_draw_schedule(monkeypatch, host_seeded):
    """Path E's schedule: 100 sampler burn-in draws, the method's 1000
    burn-in samples in 4 chunks of 256 draws (a chunk always runs
    chunk_size draws, as JAX's scan does), 512 samples a chain in 2
    chunks; a host-seeded sampler's chunks draw from CPU generators."""
    devices = []
    real = msl.chunk_generator

    def recording(seed, device):
        devices.append(torch.device(device).type)
        return real(seed, "cpu")
    monkeypatch.setattr(msl, "chunk_generator", recording)
    C = 8
    sampler = _CountingSampler(host_seeded)
    mc = MonteCarloSingleLevel(None, lambda x: torch.mean(x * x, dim=-1),
                               sampler, n_burnin=1000, n_samples=C * 512,
                               chunk_size=256)
    _, st = mc.evaluate(torch.Generator().manual_seed(0), C, torch.float64,
                        "cpu")
    assert sampler.draws == 100 + 4 * 256 + 512
    assert mc.n_sampling_draws == 512 and mc.p_accept == 1.0
    assert mc.stats_Q.samples(st) == C * 512
    assert sum(h.shape[0] for h in mc._qbar_history) == 512
    assert len(devices) == 6 and set(devices) == {"cpu"}
    assert set(mc.timings) == {"prepare_s", "burnin_s", "sampling_s"}
    assert abs(mc.numerical_result(st) - 1.0) < 4 * mc.statistical_error(st)


def _cfg(tmp_path, text):
    p = tmp_path / "run.in"
    p.write_text(text)
    return p


@pytest.mark.parametrize("variant", ["exact", "heatbath_use_pallas"])
def test_gff_driver_smoke(tmp_path, capsys, variant):
    text = GFF_SMOKE if variant == "exact" else \
        GFF_SMOKE.replace("sampler = 'exact'", "sampler = 'heatbath'") \
        + HEATBATH
    assert qft.main([str(_cfg(tmp_path, text)), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "<phi^2> [analytical]" in out and "statistical error" in out
    res = qft.run(tconfig.read_parameter_file(_cfg(tmp_path, text)),
                  device="cpu", seed=3)
    assert res["device"] == "cpu" and res["samples"] == 400
    assert res["sigma_dev"] < 4.0
    assert set(res["timings"]) == {"prepare_s", "burnin_s", "sampling_s"}


def test_schwinger_driver_singlelevel_smoke(tmp_path, capsys):
    text = """
general:
  method = 'singlelevel'
quantumfieldtheory:
  action = 'quenchedschwinger'
lattice:
  Mt_lat = 4
  Mx_lat = 4
  coarsening = 'both'
schwinger:
  beta = 1.0
  renormalisation = 'none'
singlelevelmc:
  n_burnin = 8
  n_samples = 256
  sampler = 'heatbath'
heatbath:
  n_burnin = 10
  use_pallas = true
parallel:
  n_chains = 4
  dtype = 'float64'
"""
    res = qft.run(tconfig.read_parameter_file(_cfg(tmp_path, text)),
                  device="cpu")
    assert "avg plaquette" in capsys.readouterr().out
    assert np.isfinite(res["numerical"]) and res["sigma_dev"] < 4.0
    avg, err = res["avg_plaquette"]
    assert 0.0 < avg < 1.0 and err > 0.0


#: the combinations the driver once refused, each run on the CPU now:
#: the file and what its estimate is held to (the model's analytic value
#: at 4 sigma; the sigma model has none).  The sigma run uses the heat
#: bath (the JAX driver has no exact sigma sampler either, below) and the
#: semi-coarsened MLMC two levels (a third cannot halve 4 x 4 in time
#: twice, below)
COMBINATIONS = {
    "gff_twolevel": GFF_SMOKE.replace("'singlelevel'", "'twolevel'"),
    "gff_multilevel": GFF_SMOKE.replace("'singlelevel'", "'multilevel'"),
    "schwinger_twolevel": GFF_SMOKE.replace(
        "'singlelevel'", "'twolevel'").replace(
        "'gff'", "'quenchedschwinger'").replace("'rotate'", "'temporal'"),
    "sigma": GFF_SMOKE.replace("'gff'", "'nonlinearsigma'").replace(
        "'exact'", "'heatbath'"),
    "hierarchical_sampler": GFF_SMOKE.replace("'exact'", "'hierarchical'"),
    "schwinger_semicoarsened_mlmc": GFF_SMOKE.replace(
        "'singlelevel'", "'multilevel'").replace(
        "'gff'", "'quenchedschwinger'").replace(
        "'rotate'", "'temporal'") + "multilevelmc:\n  n_level = 2\n",
}


@pytest.mark.parametrize("name", list(COMBINATIONS))
def test_unported_combinations_raise(tmp_path, name):
    """Every combination the driver once refused (the GFF's two-level and
    multilevel methods and hierarchical sampler, the semi-coarsened
    Schwinger fills, the sigma model) runs on the CPU, within 4 sigma of
    the model's analytic value where it has one."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        res = qft.run(tconfig.read_parameter_file(
            _cfg(tmp_path, COMBINATIONS[name])), device="cpu")
    assert np.isfinite(res["numerical"]) and res["error"] > 0.0
    if name == "sigma":
        assert res["qoi"] == "chi_m" and res["analytical"] is None
        assert 0.0 < res["numerical"] < 16.0    # |m|^2 / N <= N
    else:
        assert res["sigma_dev"] < 4.0, res


#: combinations the JAX driver refuses, refused by the port with the same
#: error type and text
REFUSED = {
    "sigma_multilevel": GFF_SMOKE.replace("'gff'", "'nonlinearsigma'").replace(
        "'singlelevel'", "'multilevel'"),
    "sigma_exact": GFF_SMOKE.replace("'gff'", "'nonlinearsigma'"),
    "schwinger_semicoarsened_too_deep": GFF_SMOKE.replace(
        "'singlelevel'", "'multilevel'").replace(
        "'gff'", "'quenchedschwinger'").replace("'rotate'", "'temporal'"),
    "gff_fill_both_coarsening": GFF_SMOKE.replace(
        "'singlelevel'", "'twolevel'").replace("'rotate'", "'both'"),
    # sampler = 'cluster' picks the 1-D Wolff sampler for any action but
    # Schwinger's, in both drivers: it fails on the 2-D actions' hooks
    "sigma_cluster": GFF_SMOKE.replace("'gff'", "'nonlinearsigma'").replace(
        "'exact'", "'cluster'"),
    "gff_cluster": GFF_SMOKE.replace("'exact'", "'cluster'"),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_refused_combinations_match_jax(tmp_path, capsys, name):
    from mlmcpathintegral_tpu.drivers import qft as jqft
    path = str(_cfg(tmp_path, REFUSED[name]))
    errors = []
    for main, args in ((qft.main, [path, "--device", "cpu"]),
                       (jqft.main, [path])):
        try:
            rc = main(args)
            errors.append((rc, capsys.readouterr().out.splitlines()[-1]))
        except Exception as e:
            errors.append((type(e), str(e)))
    assert errors[0] == errors[1], errors
    if name == "sigma_multilevel":
        assert errors[0] == (1, qft.SIGMA_MULTILEVEL_ERROR)
        # run raises after the same line, with no run
        with pytest.raises(ValueError, match="multilevel method not "
                                             "supported"):
            qft.run(tconfig.read_parameter_file(path), device="cpu")
        assert capsys.readouterr().out.strip() == qft.SIGMA_MULTILEVEL_ERROR


def test_driver_entry_points_default_to_the_card(tmp_path):
    for fn in (qft.main, qft.run, qm.main, qm.run, common.parallel_setup):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    n, dtype, dev = common.parallel_setup(
        tconfig.read_parameter_file(_cfg(tmp_path, GFF_SMOKE)), "cpu")
    assert (n, dtype, dev.type) == (16, torch.float64, "cpu")
    if not torch.cuda.is_available():
        # no silent CPU run: without a card the default raises
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qft.main([str(_cfg(tmp_path, GFF_SMOKE))])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            qm.main([str(REPO / "configs/qm_harmonic_singlelevel.in")])
