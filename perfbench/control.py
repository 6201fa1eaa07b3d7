"""The check's control and planted faults, and the readings the check's
limits were set from.

The control is the reference put in the program's place, computed one
precision below the configuration's float32: bfloat16, in the kernels'
place and in the statistics update's (``reference/statistics``), for
the whole run.  A fault breaks the timed path underneath the harness, in
the kernel call that a level's chunk makes or in its statistics update:

* ``unchanged``: the chunk's kernel returns its input state unchanged
  (and the traces the state gives);
* ``half``: half of the chains are left out: the kernel runs the first
  half, and the second half repeats it, so every mean is the first
  half's;
* ``altered``: Y is altered where the kernel produces it (+1e-2);
* ``lagged``: the statistics update drops the lagged products: S_k of
  every lag from 1 on keeps its value from before the update (tau_int
  then reads 1).

A chip has no exchange between chips in these cells, so that fault has
no place here.

    python3 perfbench/control.py --workload <cell> --seconds <s> \\
        --seeds 1 2 3 [--mode sound|control|unchanged|half|altered|lagged]

prints one JSON line a seed: the check's numbers and each level's, in
one process (the kernels built once).  ``sound`` reads the program
itself.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402
from perfbench.reference import schwinger as ref  # noqa: E402
from perfbench.reference import statistics as stats_ref  # noqa: E402

MODES = ("sound", "control", "unchanged", "half", "altered", "lagged")
#: the chain axis of each output of K4 (fine, coarse, S_fine, S_cond, Y,
#: qc, ec, accept) and of K3 (links, Q, energy)
CHAIN_DIM = {"k4": (0, 0, 0, 0, 1, 1, 1, 1), "k3": (0, 1, 1)}


def _reference_kernel(kind, dtype):
    """The reference in ``dtype`` in a kernel's place: float32 in and out,
    as the kernel takes and gives."""
    fn = ref.twolevel_chain if kind == "k4" else ref.sweep_chain

    def kernel(*args, **kw):
        args = [a.to(dtype) if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args]
        return tuple(o.to(torch.float32) for o in fn(*args, **kw))
    return kernel


def _reference_record(dtype):
    """The reference's statistics update in ``dtype`` in the place of the
    program's ``record_block``: the running mean, the ring and S_k that
    the benchmark reads; the other moments as the program keeps them."""
    def make(original):
        def record_block(state, Qs, n_valid=None):
            new = original(state, Qs, n_valid)
            T = Qs.shape[0]
            v = T if n_valid is None else max(0, min(int(n_valid), T))
            if v == 0:
                return new
            _, avg, ring, S = stats_ref.record(
                int(state.n_lt), state.avg_lt.to(dtype),
                state.ring.to(dtype), state.S_k.to(dtype),
                Qs[:v].to(dtype))
            f = state.avg_lt.dtype
            return new._replace(avg_lt=avg.to(f), ring=ring.to(f),
                                S_k=S.to(f))
        return record_block
    return make


def _dropped_lags(original):
    def record_block(state, Qs, n_valid=None):
        new = original(state, Qs, n_valid)
        return new._replace(S_k=torch.cat(
            [new.S_k[:, :1], state.S_k[:, 1:]], dim=1))
    return record_block


def _faulty_kernel(kind, kernel, mode):
    def broken(*args, **kw):
        out = list(kernel(*args, **kw))
        if mode == "unchanged":
            # the state comes back as it went in: K4 (fine, coarse, S_f,
            # S_q), K3 (links); the traces are left as the kernel gave them
            n_state = 4 if kind == "k4" else 1
            out[:n_state] = [a.clone() for a in args[:n_state]]
        elif mode == "half":
            for i, o in enumerate(out):
                dim = CHAIN_DIM[kind][i]
                h = o.shape[dim] // 2
                idx = torch.arange(o.shape[dim], device=o.device) % h
                out[i] = o.index_select(dim, idx)
        elif mode == "altered":
            if kind == "k4":
                out[4] = out[4] + 1e-2
            else:
                out[1] = out[1] + 1e-2
        return tuple(out)
    return broken


def hooks(mode: str) -> dict:
    """``run_cell``'s ``wrap`` and ``record`` for a mode (neither for the
    sound program)."""
    if mode == "sound":
        return {}
    if mode == "lagged":
        return {"record": _dropped_lags}

    def wrap(tap):
        def make(ell, kind, kernel):
            if mode == "control":
                k = _reference_kernel(kind, torch.bfloat16)
            else:
                k = _faulty_kernel(kind, kernel, mode)
            return tap.wrap(ell, kind, k)
        return make
    if mode == "control":
        return {"wrap": wrap, "record": _reference_record(torch.bfloat16)}
    return {"wrap": wrap}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the check's readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", choices=MODES, default="sound")
    args = p.parse_args(argv)
    t = T_START
    for seed in args.seeds:
        result, info = harness.run_cell(
            args.workload, seed, args.seconds, False, t_start=t,
            **hooks(args.mode))
        print(json.dumps({
            "workload": args.workload, "mode": args.mode, "seed": seed,
            "correct": result["correct"], "check": result["check"],
            "levels": info["check_levels"], "check_s": info["check_s"],
            "rounds": info["rounds"], "t_sub": info["t_sub"],
            "metrics": result["metrics"]}), flush=True)
        t = time.monotonic()
    return 0


if __name__ == "__main__":
    sys.exit(main())
