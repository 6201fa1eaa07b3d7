"""The port's device-time probe (mlmcpathintegral_tpu_torch/perf_probe.py):
its busy-time arithmetic on hand-made traces, and the shared-memory
refusal of the kernel wrappers (ops/_cuda.py) with the device limit
stubbed.  Neither needs a card."""

import json

import pytest
import torch

from mlmcpathintegral_tpu_torch import perf_probe
from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops.schwinger import sweep_smem_bytes
from mlmcpathintegral_tpu_torch.ops.schwinger_twolevel import (
    twolevel_smem_bytes,
)

H100_SMEM_OPTIN = 232448


@pytest.mark.parametrize("intervals, want_ms", [
    ([], 0.0),
    ([(0.0, 1000.0)], 1.0),
    # overlapping and nested intervals count once
    ([(0.0, 1000.0), (500.0, 1500.0), (600.0, 700.0)], 1.5),
    # disjoint intervals add; order does not matter
    ([(3000.0, 3500.0), (0.0, 1000.0), (1000.0, 2000.0)], 2.5),
])
def test_union_ms(intervals, want_ms):
    assert perf_probe.union_ms(intervals) == pytest.approx(want_ms, abs=1e-12)


def test_device_intervals_reads_device_events_only(tmp_path):
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 12, "dur": 4},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0,
         "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 9, "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3},
    ]}))
    ivals = perf_probe.device_intervals(trace)
    assert ivals == [("k", 10.0, 15.0), ("m", 12.0, 16.0)]
    assert perf_probe.union_ms([(s, e) for _, s, e in ivals]) == \
        pytest.approx(6e-3)


@pytest.mark.parametrize("size_of, Mx, fits", [
    (sweep_smem_bytes, 8, True),
    (twolevel_smem_bytes, 8, True),
    (sweep_smem_bytes, 512, False),
    (twolevel_smem_bytes, 512, False),
])
def test_check_smem_refuses_fields_beyond_one_block(monkeypatch, size_of,
                                                    Mx, fits):
    monkeypatch.setattr(_cuda, "max_smem_optin",
                        lambda device_index: H100_SMEM_OPTIN)
    nbytes = size_of(Mx, Mx, 1024)[2]
    dev = torch.device("cuda", 0)
    if fits:
        _cuda.check_smem(nbytes, dev, "field")
    else:
        with pytest.raises(NotImplementedError, match="runs such levels unfused"):
            _cuda.check_smem(nbytes, dev, "field")


@pytest.mark.parametrize("name, unfused, sampler", [
    ("main", [], "OverrelaxedHeatBathSampler"),
    ("path_A", [0, 1], "QuenchedSchwingerClusterSampler"),
    ("unfused_heatbath", [0, 1], "OverrelaxedHeatBathSampler"),
])
def test_probe_configurations(name, unfused, sampler):
    """The probe's configurations: bench_schwinger_mlmc's settings, fused
    with heat-bath coarse chains, and unfused with hybrid cluster or
    heat-bath ones (the accuracy witness of the unfused path)."""
    build = {"main": perf_probe.headline_mlmc,
             **perf_probe.ACCURACY_CONFIGS}[name]
    mc = build()
    assert sorted(mc._unfused) == unfused
    assert type(mc.coarse_samplers[0]).__name__ == sampler
    assert (mc.n_level, mc.chunk_size, mc.n_samples) == (2, 256, 100_000)
    assert mc.actions[0].lattice.Mt_lat == 8 and mc.actions[0].beta == 4.0


@pytest.mark.parametrize("nbytes, nops, want", [
    (3.35e9, 0.0, (1.0, "bytes")),
    (0.0, 67e9, (1.0, "operations")),
    (3.35e9, 134e9, (2.0, "operations")),
])
def test_bound_ms_takes_the_larger_of_bytes_and_operations(nbytes, nops,
                                                           want):
    t, by = perf_probe.bound_ms(nbytes, nops)
    assert t == pytest.approx(want[0], rel=1e-12) and by == want[1]


def test_path_e_configuration():
    """Path E: the reference's GFF file driven single-level on the fused
    sweep kernel at 4096 f32 chains, 512 sampling draws a chain; the one
    cut is n_samples."""
    from mlmcpathintegral_tpu_torch.drivers import common, qft
    from mlmcpathintegral_tpu_torch.lattice2d import Lattice2D
    from mlmcpathintegral_tpu_torch.utils.config import read_parameter_file
    cfg = perf_probe.gff_path_e_config()
    ref = read_parameter_file(perf_probe.PATH_E_CONFIG)
    assert cfg["general"]["method"] == "singlelevel"
    assert cfg["parallel"] == {"n_chains": 4096, "dtype": "float32"}
    assert cfg["singlelevelmc"]["n_samples"] == 4096 * 512
    changed = {(sec, k) for sec in cfg for k in cfg[sec]
               if ref.get(sec, {}).get(k) != cfg[sec][k]}
    assert changed == {("general", "method"), ("heatbath", "use_pallas"),
                       ("parallel", "n_chains"), ("parallel", "dtype"),
                       ("singlelevelmc", "n_samples")}
    act = qft.build_action(cfg, Lattice2D(16, 16))
    assert (act.mass, act.ndof) == (10.0, 256)
    with pytest.warns(UserWarning, match="random_order"):
        factory = common.make_sampler_factory("heatbath", cfg)
    sampler = factory(act)
    assert sampler._kind == "gff" and sampler.host_seeded
    assert (sampler.n_burnin, sampler.n_sweep_overrelax,
            sampler.n_sweep_heatbath) == (100, 1, 1)
