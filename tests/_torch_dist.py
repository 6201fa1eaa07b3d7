"""Run a function on a world of gloo ranks on the CPU, once, and hand its
per-rank results back to the test process.

``run_world(world, fn, tmp_path)`` spawns ``world`` processes with
``torch.multiprocessing``; rank r joins the process group through a file
store in ``tmp_path`` (no TCP port, so concurrent test workers cannot
collide), calls ``fn(rank, world)`` and writes what it returns with
``torch.save``; the test process reads the files back, one result per
rank.  A world that does not finish within ``timeout`` seconds is killed
and the call raises: a rank left waiting in a collective fails the test
instead of hanging it.  The module imports only torch and the port, so a
rank starts in seconds.
"""

from __future__ import annotations

import datetime
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, world, fn, tmp, init):
    torch.set_num_threads(1)
    store = f"file://{tmp}/store"
    if init == "multihost":
        from mlmcpathintegral_tpu_torch.parallel import initialize_multihost
        initialize_multihost(store, world, rank, device="cpu")
    else:
        dist.init_process_group(
            "gloo", init_method=store, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=120))
    try:
        out = fn(rank, world)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_world(world: int, fn, tmp_path, timeout: float = 240.0,
              init: str = "gloo", during=None):
    """([fn(0, world), ..., fn(world - 1, world)], during()): each fn
    computed on its own gloo rank, ``during`` (if given) in this process
    while the ranks run.  ``init="multihost"`` joins the group through
    ``parallel.initialize_multihost`` instead."""
    tmp = str(Path(tmp_path))
    ctx = mp.start_processes(_entry, args=(world, fn, tmp, init),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    here = during() if during is not None else None
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"a world of {world} ranks did not finish "
                               f"within {timeout} s")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(world)], here
