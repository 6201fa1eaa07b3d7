"""Multi-process set-up (PyTorch port of
``mlmcpathintegral_tpu/parallel/multihost.py``).

The reference scales across nodes with ``mpirun`` (one chain per rank).
Here every process runs the same program on its own card: call
:func:`initialize_multihost` once at start-up (under ``torchrun`` its
arguments come from the environment), build the global ``chains`` mesh
with :func:`global_chain_mesh`, and hand it to the MC methods as
``mesh=``; each rank then runs its block of the chains, and the
statistics getters gather the per-chain accumulators over the group.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.parallel.chains import chain_mesh


def _init_method(coordinator_address: str | None) -> str:
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            raise ValueError(
                "no coordinator address: pass coordinator_address "
                "('host:port', 'tcp://...' or 'file://...') or run under "
                "torchrun (MASTER_ADDR, MASTER_PORT)")
        return f"tcp://{addr}:{port}"
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def _env_int(name: str, value):
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"{name.lower()} not given and ${name} not set "
                         f"(run under torchrun or pass it)")
    return int(os.environ[name])


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, *,
                         device="cuda", backend: str | None = None) -> None:
    """Thin wrapper over ``torch.distributed.init_process_group``; the
    arguments default to the ``torchrun`` environment (MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK).  The backend is NCCL for ranks on the
    card (``device``, the card unless the caller asks for the CPU; the
    rank takes card LOCAL_RANK, else process_id modulo the cards) and
    gloo on the CPU.  ``backend`` names another explicitly — gloo for
    several ranks on one card, which NCCL refuses; nothing switches it
    behind the caller's back."""
    device = _cuda.run_device(device)
    world = _env_int("WORLD_SIZE", num_processes)
    rank = _env_int("RANK", process_id)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=_init_method(
        coordinator_address), world_size=world, rank=rank)


def global_chain_mesh(axis_name: str = "chains"):
    """1-D mesh over every rank of every host."""
    return chain_mesh(axis_name=axis_name)


def per_host_chains(n_chains_global: int) -> int:
    """Local chain count for an even split of the global batch."""
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    if n_chains_global % n_proc:
        raise ValueError(
            f"global chain count {n_chains_global} must divide evenly over "
            f"{n_proc} hosts")
    return n_chains_global // n_proc
