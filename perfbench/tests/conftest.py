"""Fixtures of the benchmark's tests: the repository root on the path, a
tiny cell on the CPU, and the ``chip`` marker with its fixture."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: a cell small enough for the CPU: the 8x8 configuration with chunks of
#: 8 samples, a short burn-in and 8 chains
TINY = "tiny.t8"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided here, when
    the test runs, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def make_tiny_root(dest: Path) -> Path:
    """A copy of BENCHMARK.json and perfbench/ at ``dest`` with the tiny
    cell added as files."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    cfg = json.loads((dest / "perfbench/configs/schwinger_mlmc_8x8.json")
                     .read_text())
    cfg.update(name="tiny", n_autocorr_window=8)
    cfg["multilevelmc"].update(n_burnin=8, chunk_size=8)
    cfg["check"]["steps"] = 2
    (dest / "perfbench/configs/tiny.json").write_text(json.dumps(cfg))
    (dest / "perfbench/traffic/t8.json").write_text(
        json.dumps({"chains": 8}))
    conf = dict(bench["configs"][1], name="tiny",
                file="perfbench/configs/tiny.json")
    bench["configs"].append(conf)
    bench["workloads"].append(dict(bench["workloads"][1], name=TINY,
                                   config="tiny", traffic="t8"))
    # the tiny cell reports what the 8x8 cells report
    for m in bench["per_layer"]:
        if "schwinger_mlmc_8x8.c1024" in m.get("workloads", []):
            m["workloads"].append(TINY)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
