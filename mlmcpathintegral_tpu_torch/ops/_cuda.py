"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface and bound through ctypes (no PyTorch
headers, so a build takes seconds).  The build happens at first use, into
``mlmcpathintegral_tpu_torch/_build/``, keyed by a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is not.
Nothing here runs when the module is imported.

Every kernel wrapper keeps a :class:`KernelCounter`: ``launches`` counts
kernel launches, ``plain_cuda_calls`` counts calls of the kernel's plain
PyTorch version on CUDA tensors (a run that should go through the kernels
must leave it at 0).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
#: no --use_fast_math; --fmad=false keeps every multiply and add rounded
#: on its own, as the plain PyTorch version (one operation per kernel)
#: rounds them, so kernel and plain version agree to the last bit more
#: often
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-lineinfo")

c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_float = ctypes.c_float
c_u32 = ctypes.c_uint32
c_size = ctypes.c_size_t

#: argtypes of every exported C function (all return a cudaError_t as int)
_SIGNATURES = {
    "mlmc_max_smem_optin": [c_int, ctypes.POINTER(c_int)],
    "mlmc_rng_fill": [c_ptr, c_ptr, c_ptr, c_u32, c_u32, c_u32]
    + [c_int] * 9 + [c_ptr],
    "mlmc_schwinger_sweep": [c_ptr] * 6 + [c_int] * 8
    + [c_float, c_u32, c_u32, c_u32, c_int, c_int, c_size, c_ptr],
    "mlmc_gff_sweep": [c_ptr, c_ptr, c_int, c_int, c_int, c_int, c_int,
                       c_float, c_float, c_u32, c_u32, c_u32, c_int, c_int,
                       c_int, c_size, c_ptr],
    "mlmc_gff_nbsum": [c_ptr, c_ptr] + [c_int] * 8 + [c_ptr],
    "mlmc_gff_sweep_attrs": [c_int, c_size, c_int, ctypes.POINTER(c_int)],
    "mlmc_schwinger_sweep_attrs": [c_int, c_size, c_int, c_int,
                                   ctypes.POINTER(c_int)],
    "mlmc_schwinger_twolevel": [c_ptr] * 14 + [c_int] * 13 + [c_float] * 5
    + [c_u32, c_u32, c_u32, c_int, c_int, c_size, c_ptr],
    "mlmc_schwinger_twolevel_attrs": [c_int, c_size, c_int, c_int,
                                      ctypes.POINTER(c_int)],
    "mlmc_rotor_sweep": [c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int,
                         c_int, c_int, c_float, c_u32, c_u32, c_u32, c_int,
                         c_int, c_size, c_ptr],
    "mlmc_rotor_sweep_attrs": [c_int, c_size, ctypes.POINTER(c_int)],
    "mlmc_rotor_cluster": [c_ptr, c_ptr, c_ptr, c_int, c_int, c_int, c_int,
                           c_float, c_u32, c_u32, c_u32, c_int, c_int,
                           c_size, c_ptr],
    "mlmc_rotor_cluster_attrs": [c_int, c_size, ctypes.POINTER(c_int)],
    "mlmc_hmc_trajectory": [c_ptr] * 6 + [c_int] * 4 + [c_float] * 9
    + [c_int, c_int, c_int, c_size, c_ptr],
    "mlmc_hmc_trajectory_attrs": [c_int, c_int, c_int, c_size,
                                  ctypes.POINTER(c_int)],
    "mlmc_qm_twolevel": [c_ptr] * 12 + [c_int] * 6 + [c_float] * 17
    + [c_u32, c_u32, c_u32, c_int, c_int, c_int, c_ptr],
    "mlmc_qm_twolevel_attrs": [c_int, c_int, ctypes.POINTER(c_int)],
    "mlmc_stats_record": [c_ptr, c_ptr] + [c_int] * 8 + [c_size, c_ptr],
    "mlmc_stats_record_attrs": [c_int, c_int, c_int, c_size,
                                ctypes.POINTER(c_int)],
}


class KernelCounter:
    """Launch count of one kernel wrapper and call count of its plain
    version on CUDA tensors."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.plain_cuda_calls = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_cuda_calls = 0

    def count_plain(self, t: torch.Tensor) -> None:
        if t.is_cuda:
            self.plain_cuda_calls += 1


def _sources():
    return sorted(p for p in CSRC_DIR.iterdir()
                  if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (CUDA_HOME or "
                           "/usr/local/cuda)")
    return found


def library_path() -> Path:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmlmc_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless this source hash is built already;
    returns (library path, build seconds — 0.0 when it was cached).  Each
    ``.cu`` file is compiled by its own nvcc process, all started
    together, and the objects are linked into one library."""
    so = library_path()
    if so.exists():
        return so, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.monotonic()
    cmds, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o",
               str(BUILD_DIR / f"{tag}.{src.stem}.o"), str(src)]
        cmds.append(cmd)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    objs = [cmd[-2] for cmd in cmds]
    results = [(cmd, proc, *proc.communicate())
               for cmd, proc in zip(cmds, procs)]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = [_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *objs]
    if all(proc.returncode == 0 for _, proc, _, _ in results):
        res = subprocess.run(link, capture_output=True, text=True)
        results.append((link, res, res.stdout, res.stderr))
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    for cmd, proc, out, err in results:
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}\n{err}")
    os.replace(tmp, so)
    return so, time.monotonic() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c_int
    return lib


def check_status(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


@functools.lru_cache(maxsize=None)
def max_smem_optin(device_index: int) -> int:
    """Largest dynamic shared memory one block may opt in to."""
    out = c_int(0)
    check_status(load_library().mlmc_max_smem_optin(device_index,
                                                    ctypes.byref(out)),
                 "cudaDeviceGetAttribute")
    return out.value


def check_smem(nbytes: int, device: torch.device, what: str) -> None:
    """Refuse a launch whose block needs more dynamic shared memory than
    the device lets one block opt in to.  The fused two-level, rotor and
    HMC kernels keep a chain's whole field in one block;
    ``MonteCarloMultiLevel`` runs a level whose field does not fit unfused
    by itself, and this guard stops a direct call.  (The sweep kernels of
    the Schwinger model and the GFF move such fields to global memory
    instead.)"""
    limit = max_smem_optin(device.index or 0)
    if nbytes > limit:
        raise NotImplementedError(
            f"{what} needs {nbytes} B of shared memory per block; the "
            f"device allows {limit}.  The fused kernels take no larger "
            f"fields: MonteCarloMultiLevel runs such levels unfused")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, t: torch.Tensor, shape, dtype=torch.float32):
    """Validate a tensor handed to a kernel: CUDA, dtype, shape,
    contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def block_layout(n_items: int, target_threads: int = 64,
                 max_threads: int = 1024):
    """(threads per chain, chains per block) for kernels that put one
    chain on a power-of-two group of threads: at most ``max_threads``
    threads per chain (a group loops over more items than threads; a
    kernel whose threads hold many registers takes fewer), and several
    chains per block while a block has fewer than ``target_threads``."""
    tpc = min(max_threads, next_pow2(n_items))
    cpb = max(1, target_threads // tpc)
    return tpc, cpb


#: the warp-per-chain kernels (K3-K8): warps a block, and the dynamic
#: shared memory a block stays within unless one chain needs more
WARPS_PER_BLOCK = 4
SMEM_DEFAULT = 48 * 1024


def warp_chains(n_lanes: int, n_chains: int | None = None):
    """(lanes per chain, chains per block) of a warp-per-chain launch:
    ``warp_layout``'s share of a warp, up to WARPS_PER_BLOCK warps a block,
    fewer where the chains run out first."""
    lanes, per_warp = warp_layout(n_lanes)
    warps = WARPS_PER_BLOCK
    if n_chains is not None:
        warps = max(1, min(warps, -(-n_chains // per_warp)))
    return lanes, warps * per_warp


def warp_layout(n_lanes: int):
    """(lanes per chain, chains per warp) for kernels that put a chain on
    one warp, or on a power-of-two share of one when it needs fewer than
    32 lanes: the shares are aligned, so a chain never straddles warps and
    its reductions are warp shuffles."""
    lanes = min(32, next_pow2(n_lanes))
    return lanes, 32 // lanes


def kernel_attrs(fn_name: str, *args) -> dict:
    """Registers a thread, spilled (local) bytes a thread and resident
    blocks an SM of one kernel at one launch shape, from the library's
    ``<fn_name>(*args, int out[3])`` (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor); ``args`` starts with
    the block's threads, which give the resident warps."""
    out = (c_int * 3)()
    check_status(getattr(load_library(), fn_name)(*args, out), fn_name)
    return {"registers_per_thread": out[0], "local_bytes_per_thread": out[1],
            "blocks_per_sm": out[2], "warps_per_sm": out[2] * args[0] // 32}


def run_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  A CUDA device on a machine without one raises; nothing
    falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def dispatch_device(t: torch.Tensor) -> str:
    """'cpu' for the plain version, 'cuda' for the kernel; anything else
    raises (a wrapper never falls back from CUDA to the plain version)."""
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"unsupported device {t.device}: the kernels run on "
                     f"CUDA, their plain versions on the CPU")
