"""The multilevel report of the port's drivers against the JAX drivers'
(``MonteCarloMultiLevel.show_statistics`` and, with
``show_detailed_stats``, ``show_detailed_statistics``: the estimate and
timer lines, then per level its statistics, target number of samples and
cost per sample).

The port's driver runs a small multilevel file on the CPU, for QM and for
QFT, with chunks of 8 samples (the driver's method takes 128, which would
make the plain versions' chunks long here).  The JAX driver then runs the
same file with its ``MonteCarloMultiLevel.evaluate`` replaced by one that takes the port's
final statistics (carried across by ``convert.to_numpy``), targets, costs
and wall, so it prints its report without sampling.  From the estimate
line to the end, the two outputs must agree line by line with every
number masked.
"""

import re

import pytest
import torch

from mlmcpathintegral_tpu.drivers import qft as jqft
from mlmcpathintegral_tpu.drivers import qm as jqm
from mlmcpathintegral_tpu.mc import multilevel as jml
from mlmcpathintegral_tpu.utils import statistics as jstats
from mlmcpathintegral_tpu_torch.convert import to_numpy
from mlmcpathintegral_tpu_torch.drivers import qft, qm
from mlmcpathintegral_tpu_torch.mc import multilevel as tml
from mlmcpathintegral_tpu_torch.utils import config as tconfig

QM_FILE = """
general:
  method = 'multilevel'
quantummechanics:
  action = 'harmonicoscillator'
lattice:
  M_lat = 16
  T_final = 4.0
statistics:
  n_autocorr_window = 10
  n_min_samples_qoi = 16
harmonicoscillator:
  m0 = 1.0
  mu2 = 1.0
multilevelmc:
  n_level = 2
  n_burnin = 16
  n_samples = 64
  show_detailed_stats = true
hierarchical:
  coarsesampler = 'HMC'
hmc:
  nt = 10
  dt = 0.2
  n_burnin = 10
parallel:
  n_chains = 8
  dtype = 'float64'
"""

QFT_FILE = """
general:
  method = 'multilevel'
quantumfieldtheory:
  action = 'quenchedschwinger'
lattice:
  Mt_lat = 4
  Mx_lat = 4
  coarsening = 'both'
statistics:
  n_autocorr_window = 10
  n_min_samples_qoi = 16
schwinger:
  beta = 2.0
  renormalisation = 'none'
multilevelmc:
  n_level = 2
  n_burnin = 16
  n_samples = 64
  show_detailed_stats = true
hierarchical:
  coarsesampler = 'heatbath'
heatbath:
  n_burnin = 10
parallel:
  n_chains = 8
  dtype = 'float64'
"""

NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _report_lines(out: str):
    """The lines from the estimate line to the end, numbers masked."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith(" Q: Avg +/- Err"))
    return [NUMBER.sub("#", ln) for ln in lines[start:]]


@pytest.mark.parametrize("kind", ["qm", "qft"])
def test_multilevel_report_matches_jax_line_by_line(kind, tmp_path, capsys,
                                                    monkeypatch):
    path = tmp_path / f"{kind}.in"
    path.write_text(QM_FILE if kind == "qm" else QFT_FILE)
    driver, jdriver = (qm, jqm) if kind == "qm" else (qft, jqft)

    runs = []
    init = tml.MonteCarloMultiLevel.__init__

    def small_chunks(self, *args, **kw):
        init(self, *args, **dict(kw, chunk_size=8))
        runs.append(self)

    monkeypatch.setattr(tml.MonteCarloMultiLevel, "__init__", small_chunks)
    torch.set_num_threads(1)
    driver.run(tconfig.read_parameter_file(path), device="cpu")
    port_out = capsys.readouterr().out
    mc = runs[0]

    def from_port(self, key, n_chains, dtype=None, verbose=False,
                  mesh=None):
        self._final_stats = [
            to_numpy(st, types={"StatsState": jstats.StatsState})
            for st in mc._final_stats]
        self.n_target = list(mc.n_target)
        self.cost_per_sample = list(mc.cost_per_sample)
        self.elapsed_s = mc.elapsed_s
        return self._final_stats

    monkeypatch.setattr(jml.MonteCarloMultiLevel, "evaluate", from_port)
    assert jdriver.main([str(path)]) == 0
    jax_out = capsys.readouterr().out

    port, ref = _report_lines(port_out), _report_lines(jax_out)
    assert port == ref
    # the detailed block: per level its statistics, target and cost
    assert sum(ln.startswith(" target number of samples") for ln in port) \
        == 2
    assert sum(ln.startswith(" cost per sample") for ln in port) == 2
