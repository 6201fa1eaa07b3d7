"""Run one benchmark cell once on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The last line of standard output is the
result (JSON: correct, attempted, failed, metrics, device, with --trace 1
breakdown, and last the check's numbers beside their limits); the line
before it holds what else the run read (eff samples/s, t_sub, set-up by
phase, each level's variance, tau and cost).  The check's numbers are
also the last lines of standard error.  Exits non-zero, with no result,
without a card or with fewer cards than the cell asks for, or when a
module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: the caches a run may fill, at fixed paths inside the checkout, so that
#: only a checkout's first run builds
CACHE = ROOT / ".perfbench_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from perfbench import harness

    try:
        work = harness.load_cell(args.workload)[0]
        if not torch.cuda.is_available():
            raise harness.CellError("no CUDA device")
        if torch.cuda.device_count() < int(work["chips"]):
            raise harness.CellError(
                f"{torch.cuda.device_count()} CUDA devices, the cell asks "
                f"for {work['chips']}")
        result, info = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            t_start=T_START)
    except harness.CellError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    print(json.dumps({"info": info}))
    for k, (v, lim) in result["check"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
