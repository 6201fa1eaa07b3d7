"""No part of the benchmark loads JAX or the JAX package, and the run's
own check of ``sys.modules`` compares whole top-level names."""

import subprocess
import sys
import types

from perfbench import harness

from conftest import ROOT, TINY

PROBE = """
import sys, time
sys.path.insert(0, {root!r})
from pathlib import Path
from perfbench import (check, control, drive, estimate, harness, trace,
                       work)
from perfbench.reference import physics, schwinger
root = Path({tiny!r})
_, cfg, _, _, per_layer = harness.load_cell({cell!r}, root)
harness.load_path(cfg, root)
for m in per_layer:
    harness.metric_reader(m["name"], root)
harness.run_cell({cell!r}, 1, 0.01, False, t_start=time.monotonic(),
                 device="cpu", root=root)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_no_jax_after_a_run(tiny_root):
    out = subprocess.run(
        [sys.executable, "-c",
         PROBE.format(root=str(ROOT), tiny=str(tiny_root), cell=TINY)],
        capture_output=True, text=True, timeout=300, check=True)
    top = eval(out.stdout.strip().splitlines()[-1])
    assert "mlmcpathintegral_tpu_torch" in top
    assert not set(top) & {"jax", "jaxlib", "flax", "mlmcpathintegral_tpu"}


def test_forbidden_names_compare_whole(monkeypatch):
    for name in ("jaxfoo", "mlmcpathintegral_tpu_torch_extra"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mlmcpathintegral_tpu.mc",
                        types.ModuleType("mlmcpathintegral_tpu.mc"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib", "mlmcpathintegral_tpu"]
