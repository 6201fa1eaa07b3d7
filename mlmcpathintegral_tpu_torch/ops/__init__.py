"""Fused kernels of the ported path.  Each wrapper launches a
hand-written CUDA kernel (``csrc/``) for CUDA tensors and its plain
PyTorch version for CPU tensors; :func:`counters` lists their launch
counters."""

from mlmcpathintegral_tpu_torch.ops.rng import RNG_FILL
from mlmcpathintegral_tpu_torch.ops.schwinger import SWEEP
from mlmcpathintegral_tpu_torch.ops.schwinger_twolevel import TWOLEVEL


def counters():
    """The :class:`~mlmcpathintegral_tpu_torch.ops._cuda.KernelCounter`
    of every kernel wrapper."""
    return [RNG_FILL, SWEEP, TWOLEVEL]


def reset_counters() -> None:
    for c in counters():
        c.reset()
