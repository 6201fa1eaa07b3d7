"""The check's control and planted faults, and the readings the check's
limits were set from.

The control is the reference put in the program's place, computed one
precision below the configuration's float32, for the whole run.  A fault
breaks the timed path underneath the harness, in the call that a level's
chunk makes or in its statistics update.  The modes:

* ``control``: the reference in bfloat16 in the program's place and in
  the statistics update's (``reference/statistics``);
* ``unchanged``: the chunk returns its input state unchanged;
* ``half``: half of the chains are left out, the means taken over the
  rest;
* ``altered``: Y is altered where it is produced;
* ``lagged``: the statistics update drops the lagged products: S_k of
  every lag from 1 on keeps its value from before the update (tau_int
  then reads 1).

The cell's run path plants a mode (its ``hooks(mode)``: ``run_cell``'s
``wrap`` and ``record``, or None for a mode it cannot plant); the
statistics' two replacements below serve every path.  A mode that the
path cannot plant is refused: the sound program never runs under a
control's name.  A chip has no exchange between chips in these cells, so
that fault has no place here.

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
from perfbench.reference import statistics as stats_ref  # noqa: E402

MODES = ("sound", "control", "unchanged", "half", "altered", "lagged")


def reference_record(dtype):
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


def dropped_lags(original):
    """The program's ``record_block`` with the lagged products dropped."""
    def record_block(state, Qs, n_valid=None):
        new = original(state, Qs, n_valid)
        return new._replace(S_k=torch.cat(
            [new.S_k[:, :1], state.S_k[:, 1:]], dim=1))
    return record_block


def cell_hooks(name: str, mode: str, root: Path = ROOT) -> dict:
    """``run_cell``'s ``wrap`` and ``record`` for ``mode`` on cell
    ``name``'s run path (neither for the sound program).  Raises
    ``harness.CellError`` where the path cannot plant the mode."""
    if mode == "sound":
        return {}
    path = harness.load_path(harness.load_cell(name, root)[1], root)
    planted = path.hooks(mode) if hasattr(path, "hooks") else None
    if planted is None:
        raise harness.CellError(f"the run path of {name} cannot plant "
                                f"mode {mode!r}")
    return planted


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the check's readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--mode", choices=MODES, default="sound")
    args = p.parse_args(argv)
    try:
        hooks = cell_hooks(args.workload, args.mode)
    except harness.CellError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    t = T_START
    for seed in args.seeds:
        result, info = harness.run_cell(
            args.workload, seed, args.seconds, False, t_start=t, **hooks)
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
