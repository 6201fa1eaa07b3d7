"""Fused kernels of the ported path.  Each wrapper launches a
hand-written CUDA kernel (``csrc/``) for CUDA tensors and its plain
PyTorch version for CPU tensors; :func:`counters` lists their launch
counters."""

from mlmcpathintegral_tpu_torch.ops.gff import NBSUM as GFF_NBSUM
from mlmcpathintegral_tpu_torch.ops.gff import SWEEP as GFF_SWEEP
from mlmcpathintegral_tpu_torch.ops.hmc import HMC
from mlmcpathintegral_tpu_torch.ops.qm_twolevel import QM_TWOLEVEL
from mlmcpathintegral_tpu_torch.ops.rng import RNG_FILL
from mlmcpathintegral_tpu_torch.ops.rotor import CLUSTER as ROTOR_CLUSTER
from mlmcpathintegral_tpu_torch.ops.rotor import SWEEP as ROTOR_SWEEP
from mlmcpathintegral_tpu_torch.ops.schwinger import SWEEP
from mlmcpathintegral_tpu_torch.ops.schwinger_twolevel import TWOLEVEL
from mlmcpathintegral_tpu_torch.ops.statistics import STATS


def counters():
    """The :class:`~mlmcpathintegral_tpu_torch.ops._cuda.KernelCounter`
    of every kernel wrapper."""
    return [RNG_FILL, SWEEP, TWOLEVEL, ROTOR_SWEEP, ROTOR_CLUSTER, HMC,
            QM_TWOLEVEL, GFF_SWEEP, GFF_NBSUM, STATS]


def reset_counters() -> None:
    for c in counters():
        c.reset()
