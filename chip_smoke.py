#!/usr/bin/env python3
"""Drive the PyTorch port (``mlmcpathintegral_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

  1. build   - compile the kernels of ``csrc/`` with nvcc (timed) and
               print the card's name and power limit;
  2. rng     - the counter RNG (csrc/rng.cuh, through csrc/rng_fill.cu)
               against its plain PyTorch version over two id grids: all
               1024 chains x 64 sites at steps 0-3, counters 1-8, and the
               main path's whole step x counter range (steps 0-2303,
               counters 1-320) at 16 sites x 4 chains; bits and uniforms
               identical, normals within 1e-6;
  3. sweep   - the sweep-chain kernel: overrelax-only against the plain
               version (max |d theta| <= 1e-5), n_steps=N against N
               single draws (bit-identical), with heat bath at 8x8 and
               4x4 the share of chains agreeing with the plain version to
               1e-4 after 4 draws (>= SHARE_MIN), and the main path's
               coarsest-level launch (4x4, beta_c=1, 1024 chains,
               n_steps=2048) against the plain version on its per-step
               Q and E traces (see ``departures``);
  4. twolevel - the two-level kernel at the main path's launch (8x8,
               beta=4, 1024 chains, n_steps=256, t_sub=8) against the
               plain version on its per-step y, accept, qc and ec traces
               (see ``departures``), and at beta=10 (the beta > 8 fill)
               for 4 steps: the share of chains whose y, acc, S_fine,
               S_cond and fine field agree to 1e-4 (>= SHARE_MIN);
  5. mlmc    - the main path: MonteCarloMultiLevel with the settings of
               bench.py's bench_schwinger_mlmc, as
               ``perf_probe.headline_mlmc`` builds it (8x8, both-direction
               coarsening, beta=4 nonperturbative, heat-bath coarse chains,
               1024 chains, f32, 100k samples per level, chunk 256) on
               the card; it must go through the kernels (launch counters
               > 0, no plain-version call on CUDA) and land within 4 sigma
               of the analytic chi_t.

A kernel and its plain version compute the same thing in f32 with
transcendentals and sums rounded differently, so a chain departs from its
plain twin where a rounding flips a rejection or accept test, and then
stays apart.  Over a long launch the checks therefore follow each chain
until it departs: few chains may depart in the first step, few in the
first 16, and at no later step may more than MAX_HAZARD of the chains
still together depart at once (a fault tied to step or counter ids would
move them all).

Then the card line of nvidia-smi, the kernel table as one JSON object, and
as the last line ``{"ok": true, "device": {...}}``.  Without a CUDA card,
or without the package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

#: relative agreement of a kernel output with its plain version
#: (differences over max(|plain|, 1))
TOL = 1e-4
#: least share of chains agreeing after a few steps
SHARE_MIN = 0.98
#: long launches: most chains that may depart in the first step, steps
#: the early share is taken over, and the largest share of the chains
#: still together that may depart at one later step (taken where at
#: least HAZARD_MIN_ALIVE chains are still together)
MAX_STEP0_DEPARTURES = 3
HEAD_STEPS = 16
MAX_HAZARD = 0.05
HAZARD_MIN_ALIVE = 100


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def field_share(a, b, tol):
    d = (a.double() - b.double()).abs().reshape(a.shape[0], -1)
    return float((d.amax(dim=1) <= tol).double().mean())


def rel_diff(a, b):
    return (a.double() - b.double()).abs() / b.double().abs().clamp(min=1.0)


def trace_share(a, b, tol):
    d = rel_diff(a, b)
    if d.dim() == 1:
        return float((d <= tol).double().mean())
    return float((d.amax(dim=0) <= tol).double().mean())


def departures(agree, diffs):
    """Follow each chain of a long launch until it departs from its plain
    twin.  ``agree``: bool [n_steps, C], True where all of chain c's
    outputs of step s agree; ``diffs``: [n_steps, C] absolute differences
    of the outputs.  Returns the report and whether it passes."""
    n, C = agree.shape
    steps = torch.arange(n, device=agree.device)[:, None]
    first = torch.where(agree, n, steps).amin(dim=0)       # [C]
    counts = torch.bincount(first, minlength=n + 1)[:n]      # per step
    alive = C - torch.cumsum(counts, 0) + counts             # entering s
    hazard = torch.where(alive >= HAZARD_MIN_ALIVE,
                         counts / alive.clamp(min=1), 0.0)
    together = steps < first[None, :]
    rep = {"chains": C, "steps": n,
           "departed_at_step0": int(counts[0]),
           f"share_together_{HEAD_STEPS}_steps":
               float((first >= HEAD_STEPS).double().mean()),
           "share_together_all_steps": float((first >= n).double().mean()),
           "median_departure_step": float(first.double().median()),
           "max_hazard": float(hazard.max()),
           "max_hazard_step": int(hazard.argmax()),
           "max_abs_err_while_together": float(
               torch.where(together, diffs, 0.0).max())}
    ok = (rep["departed_at_step0"] <= MAX_STEP0_DEPARTURES
          and rep[f"share_together_{HEAD_STEPS}_steps"] >= SHARE_MIN
          and rep["max_hazard"] <= MAX_HAZARD)
    return rep, ok


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from mlmcpathintegral_tpu_torch import ops
        from mlmcpathintegral_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        QuenchedSchwingerConditionedFineAction,
    )
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral_tpu_torch.ops import rng, schwinger
    from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as tl
    from mlmcpathintegral_tpu_torch.perf_probe import cuda_ms, headline_mlmc
    from mlmcpathintegral_tpu_torch.samplers import (
        OverrelaxedHeatBathSampler,
    )

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{kind}, power limit not readable"

    # ---- 1. build --------------------------------------------------------
    t0 = time.monotonic()
    so, nvcc_s = _cuda.build()
    _cuda.load_library()
    emit({"phase": "build", "library": so.name,
          "nvcc_seconds": round(nvcc_s, 3),
          "build_and_load_seconds": round(time.monotonic() - t0, 3),
          "card": card_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. K1: counter RNG ---------------------------------------------
    # all chains and sites at a few ids; then the main path's whole step x
    # counter range (two-level steps s*(t_sub+1)+t up to 255*9+8 = 2303,
    # fill and accept counters up to 292) at the 16 sites of its grids
    grids = (dict(n_sites=64, n_chains=1024, n_steps=4, n_ctr=8),
             dict(n_sites=16, n_chains=4, n_steps=2304, n_ctr=320))
    bits_eq = uni_eq = True
    nrm_err, n_ids = 0.0, 0
    for g in grids:
        b, u, n = rng.rng_fill((123456, -98765), device=dev, **g)
        bp, up, np_ = rng.rng_fill_plain((123456, -98765), device=dev, **g)
        torch.cuda.synchronize()
        bits_eq &= torch.equal(b, bp)
        uni_eq &= torch.equal(u, up)
        nrm_err = max(nrm_err, float((n - np_).abs().max()))
        n_ids += b.numel()
        del b, u, n, bp, up, np_
    rkw = dict(grids[0], device=dev)
    ms = cuda_ms(lambda: rng.rng_fill((1, 2), **rkw), 20)
    plain_ms = cuda_ms(lambda: rng.rng_fill_plain((1, 2), **rkw), 3)
    emit({"phase": "rng", "ids": n_ids, "grids": grids,
          "bits_identical": bits_eq, "uniforms_identical": uni_eq,
          "normal_max_abs_err": nrm_err, "ms": ms, "plain_ms": plain_ms,
          "timed_grid": grids[0]})
    if not (bits_eq and uni_eq and nrm_err <= 1e-6):
        fail("counter RNG disagrees with its plain version")
    rng_row = dict(max_abs_err=nrm_err, ms=ms, plain_ms=plain_ms)

    # ---- 3. K2/K3: sweep chain ------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1)

    def links(C, n_links):
        return (torch.rand(C, n_links, generator=gen, device=dev) * 2 - 1) \
            * math.pi

    sweep_res = {}
    th8 = links(1024, 128)
    skw = dict(beta=2.0, Mt=8, Mx=8, n_steps=4, with_energy=True)
    k = schwinger.schwinger_sweep_chain(th8, (7, 9), n_heatbath=0, **skw)
    p = schwinger.schwinger_sweep_chain_plain(th8, (7, 9), n_heatbath=0,
                                              **skw)
    or_err = float((k[0] - p[0]).abs().max())
    sweep_res["overrelax_max_abs_err"] = or_err
    sweep_res["overrelax_qsum_max_abs_err"] = float(
        (k[1] - p[1]).abs().max())
    t = th8
    for s in range(4):
        t = schwinger.schwinger_sweep(t, (7, 9), beta=2.0, Mt=8, Mx=8,
                                      step_offset=s)
    k3 = schwinger.schwinger_sweep_chain(th8, (7, 9), beta=2.0, Mt=8, Mx=8,
                                         n_steps=4)
    sweep_res["chain_equals_stepwise"] = bool(torch.equal(t, k3[0]))
    shares = {}
    for (Mx, Mt, beta) in ((8, 8, 2.0), (4, 4, 1.0)):
        th = links(1024, 2 * Mx * Mt)
        hkw = dict(beta=beta, Mt=Mt, Mx=Mx, n_steps=4, with_energy=True)
        k = schwinger.schwinger_sweep_chain(th, (3, 4), **hkw)
        p = schwinger.schwinger_sweep_chain_plain(th, (3, 4), **hkw)
        shares[f"{Mx}x{Mt}"] = field_share(k[0], p[0], TOL)
    sweep_res["heatbath_share_within_1e-4"] = shares
    # the main path's coarsest-level launch: 4x4, beta_c=1, 256 x 8 sweeps
    thL = links(1024, 32)
    mkw = dict(beta=1.0, Mt=4, Mx=4, n_steps=2048, with_energy=True)
    k = schwinger.schwinger_sweep_chain(thL, (5, 6), **mkw)
    p = schwinger.schwinger_sweep_chain_plain(thL, (5, 6), **mkw)
    torch.cuda.synchronize()
    dq, de = rel_diff(k[1], p[1]), rel_diff(k[2], p[2])
    main_rep, main_ok = departures(
        (dq <= TOL) & (de <= TOL),
        torch.maximum((k[1] - p[1]).abs(), (k[2] - p[2]).abs()).double())
    sweep_res["main_launch"] = main_rep
    plain_ms = cuda_ms(lambda: schwinger.schwinger_sweep_chain_plain(
        thL, (5, 6), **mkw), 1, warm=False)
    ms = cuda_ms(lambda: schwinger.schwinger_sweep_chain(thL, (5, 6),
                                                         **mkw), 5)
    sweep_res.update(ms=ms, plain_ms=plain_ms,
                     main_shape="4x4, 1024 chains, n_steps=2048")
    emit({"phase": "sweep", **sweep_res})
    if or_err > 1e-5 or not sweep_res["chain_equals_stepwise"] \
            or min(shares.values()) < SHARE_MIN or not main_ok:
        fail("sweep kernel disagrees with its plain version")
    sweep_row = dict(max_abs_err=main_rep["max_abs_err_while_together"],
                     ms=ms, plain_ms=plain_ms)

    # ---- 4. K4: two-level chain -----------------------------------------
    def carry(beta, C=1024):
        lat = Lattice2D(8, 8, CoarseningType.BOTH)
        act = QuenchedSchwingerAction(lat, beta=beta)
        cact = act.coarse_action()
        hb = OverrelaxedHeatBathSampler(cact, n_burnin=50, use_pallas=True)
        xc = hb.prepare(torch.Generator().manual_seed(3), C, torch.float32,
                        dev).x
        cond = QuenchedSchwingerConditionedFineAction(act)
        xf = cond.fill_fine_points(gen, act.prolongate(
            xc, act.initialise_state(gen, C, torch.float32, dev)))
        return (xf, xc, act.evaluate(xf), cond.evaluate(xf)), cact.beta

    tl_res = {}
    # the main path's fine-level launch: 8x8, beta=4, 256 steps, t_sub=8
    args, beta_c = carry(4.0)
    mkw = dict(beta=4.0, beta_c=beta_c, Mt=8, Mx=8, n_steps=256, t_sub=8)
    k = tl.schwinger_twolevel_chain(*args, (1, 2), **mkw)
    p = tl.schwinger_twolevel_chain_plain(*args, (1, 2), **mkw)
    torch.cuda.synchronize()

    # [n_steps * t_sub, C] coarse-sweep traces -> worst sweep of each step
    dqc = rel_diff(k[5], p[5]).reshape(256, 8, -1).amax(dim=1)
    dec = rel_diff(k[6], p[6]).reshape(256, 8, -1).amax(dim=1)
    agree = (rel_diff(k[4], p[4]) <= TOL) & (k[7] == p[7]) \
        & (dqc <= TOL) & (dec <= TOL)
    main_rep, main_ok = departures(agree, (k[4] - p[4]).abs().double())
    main_rep["accept_rate"] = float(k[7].mean())
    main_rep["accept_rate_plain"] = float(p[7].mean())
    tl_res["main_launch"] = main_rep
    plain_ms = cuda_ms(lambda: tl.schwinger_twolevel_chain_plain(
        *args, (1, 2), **mkw), 1, warm=False)
    ms = cuda_ms(lambda: tl.schwinger_twolevel_chain(*args, (1, 2), **mkw),
                 3)
    tl_res.update(ms=ms, plain_ms=plain_ms,
                  main_shape="8x8, 1024 chains, n_steps=256, t_sub=8")
    # the beta > 8 fill (Gaussian mixture), off the main path: 4 steps
    args, beta_c = carry(10.0)
    kw = dict(beta=10.0, beta_c=beta_c, Mt=8, Mx=8, n_steps=4, t_sub=8)
    k = tl.schwinger_twolevel_chain(*args, (11, -12), **kw)
    p = tl.schwinger_twolevel_chain_plain(*args, (11, -12), **kw)
    res = {nm: trace_share(k[i], p[i], TOL)
           for nm, i in (("S_fine", 2), ("S_cond", 3), ("y", 4),
                         ("acc", 7))}
    res["theta_fine"] = field_share(k[0], p[0], TOL)
    tl_res["beta=10, 4 steps"] = res
    emit({"phase": "twolevel", **tl_res})
    if not main_ok or min(res.values()) < SHARE_MIN:
        fail("two-level kernel disagrees with its plain version")
    tl_row = dict(max_abs_err=main_rep["max_abs_err_while_together"],
                  ms=ms, plain_ms=plain_ms)

    # ---- 5. the main path -----------------------------------------------
    mc = headline_mlmc()
    ops.reset_counters()
    stats = mc.evaluate(torch.Generator().manual_seed(2), n_chains=1024,
                        dtype=torch.float32, device=dev)
    launches = {c.name: c.launches for c in ops.counters()}
    plain_cuda = {c.name: c.plain_cuda_calls for c in ops.counters()}
    num, err = mc.numerical_result(), mc.statistical_error()
    oracle = mc.actions[0].chit_exact()
    sigma_dev = abs(num - oracle) / err
    tau0 = mc.stats_qoi[0].tau_int(stats[0])
    n0 = mc.stats_qoi[0].samples(stats[0])
    method_wall = mc.timings["cost_measure_s"] + mc.timings["sampling_s"]
    eff = n0 / (tau0 * method_wall)
    emit({"phase": "mlmc", "chit": num, "err": err, "chit_exact": oracle,
          "sigma_dev": sigma_dev, "tau_int_Y0": tau0, "n0": n0,
          "t_sub": mc._t_sub, "timings_s": mc.timings,
          "cost_per_sample_us": mc.cost_per_sample,
          "method_wall_s": method_wall, "eff_samples_per_sec": eff,
          "launches": launches, "plain_calls_on_cuda": plain_cuda,
          "reliable": mc.reliable})
    if not math.isfinite(num) or not math.isfinite(err) or err <= 0:
        fail("main path gave a non-finite estimate")
    if sigma_dev > 4.0:
        fail(f"main path {sigma_dev:.2f} sigma from chit_exact")
    if launches["schwinger_sweep_chain"] == 0 \
            or launches["schwinger_twolevel_chain"] == 0:
        fail("main path did not launch the sweep and two-level kernels")
    if any(plain_cuda.values()):
        fail("main path ran a plain version on CUDA")

    # ---- the kernel table and the result line ---------------------------
    # the two kernels the main path launches, with their launch counts from
    # that run; the counter RNG (K1) is a device function inside both,
    # checked through its own rng_fill launcher, which the main path does
    # not launch
    rows = []
    for counter, row in ((ops.SWEEP, sweep_row), (ops.TWOLEVEL, tl_row)):
        rows.append({"name": counter.name, "route": "cuda",
                     "source": counter.source, "replaces": counter.replaces,
                     "launches": launches[counter.name], **row})
    rows[0]["also_replaces"] = "mlmcpathintegral_tpu/ops/" \
        "pallas_schwinger.py:233"   # schwinger_sweep: the same kernel
    device_functions = [{
        "name": "CounterRng", "route": "cuda", "source": ops.RNG_FILL.source,
        "replaces": ops.RNG_FILL.replaces,
        "runs_inside": [ops.SWEEP.name, ops.TWOLEVEL.name],
        "checked_through": ops.RNG_FILL.name,
        "rng_fill_launches": launches[ops.RNG_FILL.name], **rng_row}]
    print(card_line, flush=True)
    emit({"kernels": rows, "device_functions": device_functions})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
