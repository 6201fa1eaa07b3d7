#!/usr/bin/env python3
"""The GFF sweep and neighbour-sum kernels of one tree of the port at
their launches, for comparing two trees bit for bit and in time on one
card.

    python scripts/gff_bits.py [--tree DIR] [--reps N] [--scaling]
                               [--boundary]

DIR is the root of a checkout whose ``mlmcpathintegral_tpu_torch`` is
imported and built (default: the checkout holding this script), so a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists can be run beside this one:

    python scripts/gff_bits.py --tree .scratch/parent

It prints one JSON line with:
  - K9 (``gff_sweep``) at path E's launch (4096 chains, 16x16, mass 10 at
    a = 1/16, 1 overrelaxation + 1 heat-bath sweep), at 128x128 and at
    256x256 (64 chains each, mass 10 at a = 1/M; 256x256 takes the
    global-memory branch), and at path E's shape with no heat bath (1 + 0)
    and with two heat-bath sweeps (0 + 2).  The fields are made with numpy
    from fixed seeds.  For each, the sha256 of the output, the ms of one
    launch by the profiler's device time and by CUDA events (mean of N
    launches after a warm one), the launch layout and, where the tree
    reports them, the registers a thread and resident warps an SM;
  - P1 (``gff_nbsum``) at the JAX probe's shapes (256 chains; 16x16, 8x8,
    16x8, 8x16), at path E's field (4096 x 16x16) and at 64 x 256x256,
    and on rows that are not a multiple of four sites (64 x 30x30): the
    sha256 of each output, and the ms at the probe's shape and the two
    large ones;
  - with ``--scaling``, K9's device ms a launch at path E's shape from
    128 to 16 384 chains;
  - with ``--boundary`` (a tree whose sweep kernel has the warp and block
    branches), both branches' device ms at several field sizes and chain
    counts, launched directly, with the sha256 of each output (the
    branches give the same bits);
  - path E as a control (``perf_probe.gff_heatbath``, profiled: phi^2, its
    sigma from phi_squared_analytical, effective samples/s, the idle share
    of the sampling phase, device ms a draw and K9's launches);
  - the card's name and power limit (nvidia-smi).
It needs one CUDA card and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: (name, chains, M, n_overrelax, n_heatbath) of the K9 launches
K9_LAUNCHES = (("path_E", 4096, 16, 1, 1), ("128x128", 64, 128, 1, 1),
               ("256x256", 64, 256, 1, 1), ("path_E_overrelax", 4096, 16,
                                            1, 0),
               ("path_E_two_heatbath", 4096, 16, 0, 2))
#: (name, chains, Mx, Mt, timed) of the P1 launches
P1_LAUNCHES = (("probe_16x16", 256, 16, 16, True),
               ("probe_8x8", 256, 8, 8, False),
               ("probe_16x8", 256, 8, 16, False),
               ("probe_8x16", 256, 16, 8, False),
               ("path_E_field", 4096, 16, 16, True),
               ("64x256x256", 64, 256, 256, True),
               ("64x30x30", 64, 30, 30, False))
#: field sizes and chain counts of the branch boundary's measurement
BOUNDARY_M = (16, 24, 32, 48, 64)
BOUNDARY_C = (64, 512, 1024, 2048, 4096)


def kappa_of(M):
    """kappa = 4 + (mass a)^2 at mass 10, a = 1/M (path E's file at
    16x16)."""
    return 4.0 + (10.0 / M) ** 2


def digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def field(C, n, seed, dev):
    rs = np.random.default_rng(seed)
    return torch.from_numpy(rs.standard_normal((C, n)).astype(
        np.float32)).to(dev)


def timed(probe, fn, reps, name_sub):
    ms, seen = probe.kernel_device_ms(fn, reps, name_sub)
    return {"ms_device": ms, "profiled_launches": seen,
            "ms_cuda_events": probe.cuda_ms(fn, reps)}


def k9_layout(_cuda, gff, C, M):
    launch = gff.sweep_launch(M, M, C, _cuda.max_smem_optin(0))
    if hasattr(gff, "sweep_attrs"):
        return {"layout": dict(zip(("lanes_per_chain", "chains_per_block",
                                    "smem_bytes", "branch"), launch)),
                "attrs": gff.sweep_attrs(M, M, C)}
    return {"layout": dict(zip(("threads_per_chain", "chains_per_block",
                                "smem_bytes", "in_global"), launch))}


def boundary(_cuda, gff, probe, dev, reps):
    """Both branches of the sweep kernel at each (M, chains), launched
    directly through the library with the launch layouts of
    ``gff.sweep_launch``'s warp and block branches."""
    lib = _cuda.load_library()
    out = {}
    for M in BOUNDARY_M:
        n = M * M
        kappa = kappa_of(M)
        for C in BOUNDARY_C:
            x = field(C, n, 1000 + M + C, dev)
            y = torch.empty_like(x)
            row = {}
            for branch, code in (("warp", 0), ("block", 1)):
                if branch == "warp":
                    lanes, cpb = 32, _cuda.WARPS_PER_BLOCK
                else:
                    lanes, cpb = min(1024, _cuda.next_pow2(n // 2)), 1
                smem = 4 * cpb * n

                # a tree whose kernels take a chain offset gets chain0 = 0
                chain0 = (0,) if len(lib.mlmc_gff_sweep.argtypes) == 17 \
                    else ()

                def launch():
                    err = lib.mlmc_gff_sweep(
                        x.data_ptr(), y.data_ptr(), C, M, M, 1, 1, kappa,
                        gff._sigma(kappa), 3, 4, *chain0, lanes, cpb, code,
                        smem, _cuda.stream_ptr(dev))
                    _cuda.check_status(err, "gff_sweep")
                launch()
                torch.cuda.synchronize()
                row[branch] = {"sha256": digest(y), **timed(
                    probe, launch, reps, "gff_sweep"),
                    "attrs": _cuda.kernel_attrs(
                        "mlmc_gff_sweep_attrs", lanes * cpb, smem, code)}
            out[f"{M}x{M}, {C} chains"] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve()
                                          .parents[1]))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--boundary", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gff_bits: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from mlmcpathintegral_tpu_torch import ops
    from mlmcpathintegral_tpu_torch import perf_probe as probe
    from mlmcpathintegral_tpu_torch.ops import _cuda
    from mlmcpathintegral_tpu_torch.ops import gff
    assert Path(ops.__file__).resolve().is_relative_to(tree)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    t0 = time.monotonic()
    so, nvcc_s = _cuda.build()
    _cuda.load_library()
    out = {"tree": str(tree), "card": smi, "library": so.name,
           "nvcc_seconds": nvcc_s,
           "build_and_load_seconds": time.monotonic() - t0}

    k9 = {}
    for i, (name, C, M, n_or, n_hb) in enumerate(K9_LAUNCHES):
        x = field(C, M * M, 10 + i, dev)
        kw = dict(kappa=kappa_of(M), Mt=M, Mx=M, n_overrelax=n_or,
                  n_heatbath=n_hb)
        y = gff.gff_sweep(x, (7 + i, -9 - i), **kw)
        torch.cuda.synchronize()
        k9[name] = {"launch": dict(chains=C, **kw), "sha256": digest(y),
                    **timed(probe, lambda: gff.gff_sweep(
                        x, (7 + i, -9 - i), **kw), args.reps, "gff_sweep"),
                    **k9_layout(_cuda, gff, C, M)}
    out["K9"] = k9

    p1 = {}
    for i, (name, C, Mx, Mt, is_timed) in enumerate(P1_LAUNCHES):
        x = field(C, Mx * Mt, 50 + i, dev)
        y = gff.gff_nbsum(x, Mt, Mx)
        torch.cuda.synchronize()
        p1[name] = {"launch": dict(chains=C, Mx=Mx, Mt=Mt),
                    "sha256": digest(y),
                    "identical_to_plain": bool(torch.equal(
                        y, gff.gff_nbsum_plain(x, Mt, Mx)))}
        if is_timed:
            p1[name].update(timed(probe, lambda: gff.gff_nbsum(x, Mt, Mx),
                                  args.reps, "gff_nbsum"))
    out["P1"] = p1

    if args.scaling:
        sc = {}
        kw = dict(kappa=kappa_of(16), Mt=16, Mx=16, n_overrelax=1,
                  n_heatbath=1)
        for C in (128, 256, 512, 1024, 2048, 4096, 8192, 16384):
            x = field(C, 256, 20, dev)
            sc[C] = timed(probe, lambda: gff.gff_sweep(x, (1, 2), **kw),
                          args.reps, "gff_sweep")
        out["K9_scaling_path_E_shape"] = sc
    if args.boundary:
        out["boundary"] = boundary(_cuda, gff, probe, dev, args.reps)

    ops.reset_counters()
    rep = probe.gff_heatbath(device=dev, profile=True)
    out["path_E"] = {k: rep[k] for k in (
        "numerical", "error", "analytical", "sigma_dev", "tau_int",
        "eff_samples_per_sec", "host_ms_per_draw", "phase_idle_share",
        "phase_device_busy_ms", "device_ms_per_draw",
        "gff_sweep_ms_per_launch") if k in rep}
    out["path_E"]["launches"] = {c.name: c.launches for c in ops.counters()
                                 if c.launches}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
