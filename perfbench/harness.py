"""One run of one benchmark cell: set-up, a timed window, the metrics and
the check.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` names a configuration
(``configs/<name>.json``: the lattice, couplings, hierarchy, samplers and
the check's steps and limits) and a traffic mix (``traffic/<name>.json``:
the chains).  Each per-layer metric is read by ``metrics/<name>.py``.
A configuration's ``path`` names its run path, ``paths/<name>.py``
(``fused`` where it names none).  The harness finds all four by name, so
a configuration, a mix, a metric or a run path is added as a file.

A run path holds the program's names that its cell calls, its check and
the reference that check uses.  The harness reaches the program only
through it:

* ``make_mlmc(cfg, n_samples)``: the program's ``MonteCarloMultiLevel``;
* ``set_up(mc, seed, n_chains, dtype, device)``: (generator, the carries
  of every level, finest first) after the set-up a user's run pays;
* ``levels(mc)``: per level, finest first, a dict with ``kind``, ``Mt``,
  ``Mx``, ``beta``, ``t_sub`` (None where the level subsamples by its own
  clock) and ``chunk`` (recorded samples a chunk call);
* ``chunk_functions(mc, wrap)``: each level's ``chunk(seed, carry,
  n_active) -> (carry, ybar)``, with the call the path taps passed
  through ``wrap(ell, kind, fn)`` (a kernel on the fused path; an
  unfused path may tap the chunk function itself);
* ``with_fresh_y(mc, ell, carry, n_chains, dtype, device)``,
  ``y_stats(mc, ell, carry)``: a level's carry with its Y statistics
  started empty, and its Y statistics;
* ``timings(mc)``: the set-up's seconds by phase;
* ``judge(cfg, t_sub, kept, recorded, expected)``: the check's numbers,
  each the largest over the levels, and each level's own; the names are
  those of the configuration's ``check.limits``;
* optionally ``hooks(mode)``: a control's or fault's ``wrap`` and
  ``record`` for ``control.py``, None for a mode it cannot plant.

The window runs rounds.  A round records the same number of samples a
chain on every level, one chunk of the longest level, coarsest first,
through the path's level chunk functions, and synchronises after each
level's batch.  Rounds start until ``seconds`` have passed; the window
ends with the last round.
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from perfbench import check, drive, estimate
from perfbench.trace import SPAN_PREFIX, Trace, device_events

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level modules no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "mlmcpathintegral_tpu")
#: a name of the benchmark (a run path's among them)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


class CellError(RuntimeError):
    """A cell that cannot run as named: no result is printed."""


def load_cell(name: str, root: Path = ROOT):
    """(workload entry, configuration, traffic, per-layer metric entries
    of this cell) from ``root``'s ``BENCHMARK.json`` and the files it
    names."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    work = work[0]
    conf = [c for c in bench["configs"] if c["name"] == work["config"]][0]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic"
                          / f"{work['traffic']}.json").read_text())
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    return work, cfg, traffic, end_to_end, per_layer


def load_path(cfg: dict, root: Path = ROOT):
    """The configuration's run path: the module ``perfbench/paths/<name>.py``
    of its ``path`` (``fused`` where it names none).  Raises ``CellError``
    where no such file is found."""
    name = cfg.get("path", "fused")
    file = root / "perfbench" / "paths" / f"{name}.py"
    if not NAME.fullmatch(name) or not file.is_file():
        raise CellError(f"no run path {name!r} (perfbench/paths/{name}.py)")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_path_{name.replace('.', '_')}", file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """``read(run)`` of the per-layer metric ``name``
    (``perfbench/metrics/<name>.py``)."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def seed_streams(seed: int):
    """(set-up seed, window chunk-seed generator, check's numpy generator):
    three independent streams of ``seed``."""
    ss = np.random.SeedSequence(int(seed))
    a, b, c = ss.spawn(3)
    setup = int(a.generate_state(1, np.uint64)[0] >> np.uint64(1))
    gen = torch.Generator().manual_seed(
        int(b.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return setup, gen, np.random.default_rng(c)


def chunk_seed(gen):
    """A chunk's int32 seed pair, as ``evaluate`` draws them."""
    return torch.randint(-2**31, 2**31 - 1, (2,), generator=gen,
                         dtype=torch.int32)


class Tap:
    """Keeps the inputs and outputs of the tapped calls of one checked
    chunk a level: the harness arms it before a chunk it may check, and
    the first tapped call of that level after arming is kept, once per
    armed chunk.  The run path decides which call it taps (see the
    module's docstring)."""

    def __init__(self):
        self.armed = None          # the level whose next call is kept
        self.pending = {}

    def wrap(self, ell, kind, kernel):
        def tapped(*args, **kw):
            out = kernel(*args, **kw)
            if self.armed == ell:
                self.pending[ell] = (args, kw, out)
                self.armed = None
            return out
        return tapped


@dataclass
class Run:
    """What a window measured, for the metric readers."""
    chains: int
    window_s: float
    rounds: int
    levels: list
    trace: Trace | None = None
    notes: list = field(default_factory=list)

    def roofline(self, kernels, bound_s, launches):
        """100 x bound / device time of ``kernels`` over the window, the
        bound ``bound_s`` of the window's ``launches`` of them.  The
        profiler now and then loses one launch's record (seen on the
        card: one of 1342 K4 launches in a 51 s window): where at most
        one in a thousand, or one, lacks its record, the bound is taken
        over the traced share of the launches, so that time and work
        cover the same launches (exact where they are of one shape).
        None without a trace, with more launches lost, or with more
        traced than run."""
        if self.trace is None:
            return None
        t, n = self.trace.kernel_s(kernels)
        lost = launches - n
        if lost:
            self.notes.append(f"{kernels[0]}: {n} traced launches, "
                              f"{launches} run")
        if not 0 <= lost <= max(1, launches // 1000) or t <= 0.0:
            return None
        return 100.0 * bound_s * (n / launches) / t


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(path, mc, fns, carries, levels, per_round, seed_for, pick,
               tap, device, *, seconds=math.inf, max_rounds=None,
               spans=None):
    """The timed window of run path ``path``: rounds of ``per_round``
    samples a chain on every level, coarsest first, each level's batch
    synchronised.  Rounds start until ``seconds`` have passed (or
    ``max_rounds`` ran).  ``carries`` (a list, finest first) is advanced
    in place; ``levels`` gathers each level's host seconds and launches;
    ``seed_for(round, level)`` gives each chunk's seed pair; ``spans``,
    where given, gathers the host spans ``(start_ns, end_ns, name)`` on
    the wall clock, the window's first.  Returns (rounds, seconds, the
    checked chunk of each level: ``{level: {"call": (args, kwargs,
    outputs) of its tapped call, "before": Y statistics, "after": Y
    statistics}}``)."""
    L = len(levels)
    kept, rounds = {}, 0
    w0 = time.time_ns()
    t0 = time.monotonic()
    while max_rounds is None or rounds < max_rounds:
        # reservoir of one: round r replaces the checked round with
        # probability 1/(r+1), so each round is checked alike
        arm = pick.random() * (rounds + 1) < 1.0
        round_kept = {}
        for ell in range(L - 1, -1, -1):
            lv = levels[ell]
            ns0, td0 = time.time_ns(), time.monotonic()
            done = 0
            while done < per_round:
                n = min(lv["chunk"], per_round - done)
                if arm and done == 0 and n == lv["chunk"]:
                    tap.armed = ell
                    before = path.y_stats(mc, ell, carries[ell])
                carries[ell], _ = fns[ell](seed_for(rounds, ell),
                                           carries[ell], n)
                if ell in tap.pending:
                    round_kept[ell] = {
                        "call": tap.pending.pop(ell), "before": before,
                        "after": path.y_stats(mc, ell, carries[ell])}
                done += n
                lv["launches"] += 1
            ns1, td1 = time.time_ns(), time.monotonic()
            sync(device)
            ns2, td2 = time.time_ns(), time.monotonic()
            lv["dispatch_s"] += td1 - td0
            lv["span_s"] += td2 - td0
            if spans is not None:
                spans.append((ns0, ns1, f"{SPAN_PREFIX}level{ell}.dispatch"))
                spans.append((ns1, ns2, f"{SPAN_PREFIX}level{ell}.sync"))
        if arm:
            kept = round_kept
        rounds += 1
        if time.monotonic() - t0 >= seconds:
            break
    window_s = time.monotonic() - t0
    if spans is not None:
        spans.insert(0, (w0, time.time_ns(), f"{SPAN_PREFIX}window"))
    return rounds, window_s, kept


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", root: Path = ROOT,
             wrap=None, record=None):
    """Run one cell once; returns (result dict, info dict).  ``device``
    "cpu" runs the program's plain versions (the tests).  A control or a
    fault replaces part of the program: ``wrap(tap)`` returns the wrapper
    of the run path's ``chunk_functions`` in place of the tap's own (it
    must still call the tap), ``record`` the statistics' update
    (``drive.record_replaced``) for the whole run."""
    with drive.record_replaced(record):
        return _run_cell(name, seed, seconds, trace, t_start=t_start,
                         device=device, root=root, wrap=wrap)


def _run_cell(name, seed, seconds, trace, *, t_start, device, root, wrap):
    work, cfg, traffic, end_to_end, per_layer = load_cell(name, root)
    path = load_path(cfg, root)
    device = torch.device(device)
    dtype = getattr(torch, cfg["dtype"])
    C = int(traffic["chains"])
    build_s = drive.build_kernels() if device.type == "cuda" else 0.0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    setup_seed, seed_gen, pick = seed_streams(seed)
    mc = path.make_mlmc(cfg, n_samples=C)
    _, carries = path.set_up(mc, setup_seed, C, dtype, device)
    levels = path.levels(mc)
    L = len(levels)
    per_round = max(lv["chunk"] for lv in levels)
    carries = [path.with_fresh_y(mc, ell, carries[ell], C, dtype, device)
               for ell in range(L)]
    tap = Tap()
    fns = path.chunk_functions(mc, wrap(tap) if wrap else tap.wrap)
    for lv in levels:
        lv.update(span_s=0.0, dispatch_s=0.0, launches=0)
    sync(device)
    setup_s = time.monotonic() - t_start

    profiler, spans = None, None
    if trace:
        # the device's activity alone (see trace.py)
        profiler = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU])
        profiler.__enter__()
        spans = []
    rounds, window_s, kept = run_window(
        path, mc, fns, carries, levels, per_round,
        lambda r, ell: chunk_seed(seed_gen), pick, tap, device,
        seconds=seconds, spans=spans)
    trace_obj, trace_s = None, {}
    if profiler is not None:
        t = time.monotonic()
        profiler.__exit__(None, None, None)
        trace_s["stop"] = time.monotonic() - t
        t = time.monotonic()
        events = device_events(profiler)
        window = spans.pop(0)
        trace_obj = Trace(events, window[0], window[1], spans)
        trace_s["read"] = time.monotonic() - t
        trace_s["events"] = len(events)
        del profiler, events

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)

    # the window's statistics: per level V, tau and the cost a sample
    samples = C * per_round * rounds
    recorded = []
    for ell, lv in enumerate(levels):
        st = path.y_stats(mc, ell, carries[ell])
        var, tau, n = estimate.level_moments(
            st.avg_lt.cpu(), st.S_k.cpu(), int(st.n_lt))
        recorded.append(n)
        lv.update(var=var, tau=tau, samples=samples,
                  cost_s=lv["span_s"] / samples)
    eps = cfg["multilevelmc"]["epsilon"]
    t_eps = estimate.time_to_eps(eps, [lv["var"] for lv in levels],
                                 [lv["tau"] for lv in levels],
                                 [lv["cost_s"] for lv in levels])
    e2e = {"samples_per_s": (samples / window_s, "samples/s"),
           "time_to_eps_s": (t_eps, "s"),
           "setup_s": (setup_s, "s")}
    run = Run(chains=C, window_s=window_s, rounds=rounds, levels=levels,
              trace=trace_obj)
    metrics = {}
    if trace:
        for m in per_layer:
            v = metric_reader(m["name"], root)(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in end_to_end:
            v, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": unit}
    timings = path.timings(mc)
    info = {
        "workload": name, "seed": seed, "rounds": rounds,
        "samples_per_round": per_round, "chains": C,
        "window_s": window_s, "build_s": build_s,
        "eff_samples_per_s": estimate.effective_samples_per_s(
            samples, levels[0]["tau"], window_s),
        "eps_time_share": estimate.eps_time_shares(
            [lv["var"] for lv in levels], [lv["tau"] for lv in levels],
            [lv["cost_s"] for lv in levels]),
        "t_sub": [lv["t_sub"] for lv in levels],
        "levels": [{k: lv[k] for k in ("kind", "Mt", "Mx", "beta", "chunk",
                                       "launches", "span_s", "dispatch_s",
                                       "var", "tau", "cost_s")}
                   for lv in levels],
        "setup_timings": timings,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "device_count": (torch.cuda.device_count()
                         if device.type == "cuda" else 0),
        "power": power_limit() if device.type == "cuda" else None,
        "notes": run.notes,
        "trace_s": trace_s,
    }

    # the check, once the window's state is freed but for the checked
    # chunk's kernel calls
    expected = [samples] * L
    t_sub = [lv["t_sub"] for lv in levels]
    del carries, fns, mc
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    numbers, per_level = path.judge(cfg, t_sub, kept, recorded, expected)
    correct, table, failed = check.verdict(numbers, per_level,
                                           cfg["check"]["limits"])
    info["check_s"] = time.monotonic() - t_check
    info["check_levels"] = per_level

    # the answers judged are the checked chunks, one a level
    result = {
        "correct": bool(correct),
        "attempted": L,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": info["device_name"],
            "count": int(work["chips"]),
            "memory_peak_bytes": int(memory_peak),
        },
    }
    if trace_obj is not None:
        result["device"]["busy_s"] = trace_obj.busy_s
        result["device"]["window_s"] = trace_obj.window_s
        result["breakdown"] = {"device_ops": trace_obj.device_ops(),
                               "idle_gaps": trace_obj.idle_gaps()}
    result["check"] = table
    found = forbidden_modules()
    if found:
        raise CellError(f"modules of JAX or the JAX package loaded: {found}")
    return result, info
