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
        with pytest.raises(NotImplementedError, match="later slice"):
            _cuda.check_smem(nbytes, dev, "field")
