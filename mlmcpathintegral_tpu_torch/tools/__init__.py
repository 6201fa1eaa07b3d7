"""The port's study tools: counterparts of the JAX package's ``tools/``
scripts that drive this package, each run as
``python -m mlmcpathintegral_tpu_torch.tools.<name>``.  A tool does its
work inside its ``main`` and ``run_*`` functions, never when imported, and
does not retry a failed run: an exception ends the run with a non-zero
exit.  The CSVs keep the JAX tools' columns, so the two packages' rows
line up column for column."""

from __future__ import annotations

import csv
from pathlib import Path


def write_csv(path, rows, append: bool = False) -> str:
    """Write ``rows`` (dicts with the first row's keys) to ``path``;
    ``append`` adds them to an existing file without a header.  Returns
    the mode used ("w" or "a")."""
    mode = "a" if append and Path(path).exists() else "w"
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, mode, newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        if mode == "w":
            w.writeheader()
        w.writerows(rows)
    return mode


def launches():
    """{kernel: launches} of every kernel wrapper with launches > 0, and
    the names of those whose plain version ran on a CUDA tensor."""
    from mlmcpathintegral_tpu_torch import ops
    return ({c.name: c.launches for c in ops.counters() if c.launches},
            [c.name for c in ops.counters() if c.plain_cuda_calls])
