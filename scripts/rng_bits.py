#!/usr/bin/env python3
"""The counter RNG's launcher ``rng_fill`` of one tree of the port at its
grids, for comparing two trees bit for bit and in time on one card.

    python scripts/rng_bits.py [--tree DIR] [--reps N]

DIR is the root of a checkout whose ``mlmcpathintegral_tpu_torch`` is
imported and built (default: the checkout holding this script), so a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists can be run beside this one:

    python scripts/rng_bits.py --tree .scratch/parent

It prints one JSON line with, for each grid of ``GRIDS`` (the kernel
table's grid, 64 sites x 1024 chains x 4 steps x 8 counters; two grids of
33.5M words where the stores dominate, one stepped and one step-less;
``chip_smoke.py``'s long parity grid and the JAX probe's step-less one):
the sha256 of the bits, uniforms and normals as the wrapper returns them,
whether the bits and uniforms equal the plain version's and the normals'
largest difference from it, and for the timed grids the kernel's device
ms a launch from the profiler (without the wrapper's allocations and its
widening of the bits to int64), the whole call's ms by CUDA events, and
the bound (10 bytes a word over 3.35 TB/s, ``chip_smoke.work_rng``);
the launch layout where the tree has ``fill_launch``; and the card's name
and power limit (nvidia-smi).  It needs one CUDA card and imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

#: (name, n_sites, n_chains, n_steps, n_ctr, step0, timed)
GRIDS = (("table_2.1M", 64, 1024, 4, 8, 0, True),
         ("stepped_33.5M", 64, 4096, 4, 32, 0, True),
         ("stepless_33.5M", 256, 4096, 1, 32, None, True),
         ("parity_long", 16, 4, 2304, 320, 0, False),
         ("probe_stepless", 64, 512, 1, 3, None, False))
SEED = (123456, -98765)


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rng_bits: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(tree))
    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch import perf_probe as probe
    from mlmcpathintegral_tpu_torch.ops import _cuda, rng
    assert Path(ops.__file__).resolve().is_relative_to(tree)
    sys.path.insert(1, str(repo))
    from chip_smoke import work_rng
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.monotonic()
    so, nvcc_s = _cuda.build()
    _cuda.load_library()
    out = {"tree": str(tree), "card": smi, "library": so.name,
           "nvcc_seconds": nvcc_s,
           "build_and_load_seconds": time.monotonic() - t0, "grids": {}}
    for name, S, C, T, K, step0, is_timed in GRIDS:
        kw = dict(n_sites=S, n_chains=C, n_steps=T, n_ctr=K, step0=step0,
                  device=dev)
        b, u, n = rng.rng_fill(SEED, **kw)
        bp, up, np_ = rng.rng_fill_plain(SEED, **kw)
        torch.cuda.synchronize()
        row = {"grid": dict(n_sites=S, n_chains=C, n_steps=T, n_ctr=K,
                            step0=step0),
               "words": S * C * T * K, "sha256": digest((b, u, n)),
               "bits_identical": bool(torch.equal(b, bp)),
               "uniforms_identical": bool(torch.equal(u, up)),
               "normal_max_abs_err": float((n - np_).abs().max())
               if n.numel() else 0.0}
        del b, u, n, bp, up, np_
        if hasattr(rng, "fill_launch"):
            row["launch"] = dict(zip(("threads", "blocks_x", "blocks_y"),
                                     rng.fill_launch(S, C, T, K)))
        if is_timed:
            def call():
                return rng.rng_fill(SEED, **kw)
            ms, seen = probe.kernel_device_ms(call, args.reps, "rng_fill")
            nbytes, nops = work_rng(S, C, T, K)
            bound, by = probe.bound_ms(nbytes, nops)
            row.update(ms_device=ms, profiled_launches=seen,
                       ms_call_cuda_events=probe.cuda_ms(call, args.reps),
                       bound_ms=bound, bound_by=by,
                       share_of_bound=None if ms is None else bound / ms)
        torch.cuda.empty_cache()
        out["grids"][name] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
