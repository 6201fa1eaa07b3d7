"""mlmcpathintegral_tpu_torch — the PyTorch and CUDA port of
``mlmcpathintegral_tpu``: multilevel MCMC for lattice path integrals on an
NVIDIA H100.

The package mirrors the JAX package's layout and names, so that each
module's counterpart is easy to find.  It imports ``torch`` and never
``jax``.  Every Pallas kernel on the ported path has a hand-written CUDA
C++ counterpart under ``csrc/``, built with ``nvcc`` at first use (see
``ops/_build.py``); each wrapper runs the kernel for CUDA tensors and the
plain PyTorch version of the same function for CPU tensors.

Ported so far: the two-level MLMC main path of the quenched Schwinger
model (heat-bath coarse chains, both-direction coarsening).
"""

__version__ = "0.1.0"
