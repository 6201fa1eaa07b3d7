"""A configuration names its run path as a file: ``paths/<name>.py`` is
found and used, an unknown name is refused, and a path whose every level
runs unfused (cluster coarse chains) runs a whole window on the CPU with
no edit to any other file of the benchmark."""

import json
import math
import time

import pytest

from perfbench import control, drive, harness

from conftest import TINY

#: a run path written by the test: the tiny 8x8 hierarchy with the
#: program's cluster coarse sampler, so that no level runs fused.  It taps
#: the chunk function itself, and its check reads the Y statistics'
#: update of the checked chunk, whose samples the ring holds (a chunk is
#: no longer than the ring), and the samples the window ran.
CLUSTER_PATH = '''
from perfbench import check
from perfbench.drive import set_up, timings, with_fresh_y, y_stats


def make_mlmc(cfg, n_samples):
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        make_schwinger_conditioned_fine_action)
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D)
    from mlmcpathintegral_tpu_torch.mc import MonteCarloMultiLevel
    from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction)
    from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
    from mlmcpathintegral_tpu_torch.samplers import (
        QuenchedSchwingerClusterSampler)

    act = QuenchedSchwingerAction(
        Lattice2D(cfg["Mt_lat"], cfg["Mx_lat"],
                  CoarseningType(cfg["coarsening"])),
        beta=cfg["beta"],
        renormalisation=RenormalisationType(cfg["renormalisation"]))
    cl = cfg["cluster"]
    mlmc = cfg["multilevelmc"]
    return MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: QuenchedSchwingerClusterSampler(
            a, n_burnin=cl["n_burnin"], n_updates=cl["n_updates"],
            use_pallas=True),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=mlmc["n_level"], n_burnin=mlmc["n_burnin"],
        epsilon=mlmc["epsilon"], n_samples=n_samples,
        n_autocorr_window=cfg["n_autocorr_window"],
        n_min_samples_qoi=cfg["n_min_samples_qoi"],
        chunk_size=mlmc["chunk_size"], use_pallas=True)


def levels(mc):
    out = []
    for ell in range(mc.n_level):
        assert not mc._is_fused(ell)
        lat = mc.actions[ell].lattice
        out.append({"kind": "unfused", "Mt": lat.Mt_lat, "Mx": lat.Mx_lat,
                    "beta": mc.actions[ell].beta, "t_sub": None,
                    "chunk": mc._level_chunk(ell)})
    return out


def chunk_functions(mc, wrap):
    return [wrap(ell, "chunk", mc._chunk(ell)) for ell in range(mc.n_level)]


def judge(cfg, t_sub, kept, recorded, expected):
    per_level = []
    for ell, missing in enumerate(check.samples_missing(recorded,
                                                        expected)):
        lv = {"stats_disagree": 1.0, "samples_missing": missing}
        if ell in kept:
            k = kept[ell]
            T = k["call"][0][2]
            y = k["after"].ring[:, :T].flip(1).T
            st, lv["stats_dev"] = check.stats_level(y, k["before"],
                                                    k["after"])
            lv["stats_disagree"] = float(st.double().mean())
        per_level.append(lv)
    return ({k: max(lv[k] for lv in per_level)
             for k in ("stats_disagree", "samples_missing")}, per_level)
'''


def add_cell(root, config, path=None, source=None, **changes):
    """A configuration ``config`` (the tiny one with ``changes`` and, where
    given, its run path ``path``, whose file holds ``source``) and its cell
    ``<config>.t8``, added to the copy of the benchmark at ``root``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "perfbench/configs/tiny.json").read_text())
    cfg.update(name=config, **changes)
    if path is not None:
        cfg["path"] = path
    if source is not None:
        (root / f"perfbench/paths/{path}.py").write_text(source)
    (root / f"perfbench/configs/{config}.json").write_text(json.dumps(cfg))
    tiny = [c for c in bench["configs"] if c["name"] == "tiny"][0]
    bench["configs"].append(dict(tiny, name=config,
                                 file=f"perfbench/configs/{config}.json"))
    cell = f"{config}.t8"
    bench["workloads"].append(dict(
        [w for w in bench["workloads"] if w["name"] == TINY][0],
        name=cell, config=config))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


def _run(cell, root, seed=5):
    return harness.run_cell(cell, seed, 0.01, False,
                            t_start=time.monotonic(), device="cpu",
                            root=root)


def test_path_file_found_by_name(tiny_root):
    fused = (tiny_root / "perfbench/paths/fused.py").read_text()
    cell = add_cell(tiny_root, "tiny_copied", "copied", fused + (
        "\n\ndef timings(mc):\n    return dict(mc.timings, copied=1.0)\n"))
    res, info = _run(cell, tiny_root)
    want, want_info = _run(TINY, tiny_root)
    assert info["setup_timings"]["copied"] == 1.0
    assert "copied" not in want_info["setup_timings"]
    assert info["rounds"] == want_info["rounds"]
    assert res["check"] == want["check"]
    assert res["correct"] is want["correct"] is True


@pytest.mark.parametrize("name", ["nosuch", "../harness"])
def test_unknown_path_is_refused(tiny_root, name):
    cell = add_cell(tiny_root, "tiny_lost", name)
    with pytest.raises(harness.CellError):
        _run(cell, tiny_root)


def test_unfused_path_runs_a_window(tiny_root):
    cell = add_cell(
        tiny_root, "tiny_cluster", "cluster_test", CLUSTER_PATH,
        coarsesampler="cluster", cluster={"n_burnin": 8, "n_updates": 2},
        check={"limits": {"stats_disagree": 0.05, "samples_missing": 0.0}})
    res, info = _run(cell, tiny_root)
    assert res["correct"] is True, res["check"]
    assert list(res["check"]) == ["stats_disagree", "samples_missing"]
    assert res["check"]["samples_missing"][0] == 0.0
    assert info["t_sub"] == [None, None]
    for lv in info["levels"]:
        assert lv["kind"] == "unfused"
        assert math.isfinite(lv["var"]) and math.isfinite(lv["tau"])
    for lv in info["check_levels"]:
        assert lv["stats_disagree"] == 0.0 and lv["samples_missing"] == 0.0
    # the path plants no control or fault: control.py refuses to run it
    with pytest.raises(harness.CellError):
        control.cell_hooks(cell, "half", tiny_root)


def test_fused_path_refuses_an_unfused_level(tiny_root):
    _, cfg, traffic, _, _ = harness.load_cell(TINY, tiny_root)
    mc = drive.make_mlmc(cfg, n_samples=traffic["chains"])
    mc.use_pallas = False
    with pytest.raises(harness.CellError):
        drive.levels(mc)
    with pytest.raises(harness.CellError):
        drive.make_mlmc(dict(cfg, coarsesampler="cluster"), n_samples=8)
