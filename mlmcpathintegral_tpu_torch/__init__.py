"""mlmcpathintegral_tpu_torch — the PyTorch and CUDA port of
``mlmcpathintegral_tpu``: multilevel MCMC for lattice path integrals on an
NVIDIA H100.

The package mirrors the JAX package's layout and names, so that each
module's counterpart is easy to find.  It imports ``torch`` and never
``jax``.  Every Pallas kernel on the ported path has a hand-written CUDA
C++ counterpart under ``csrc/``, built with ``nvcc`` at first use (see
``ops/_cuda.py``); each wrapper runs the kernel for CUDA tensors and the
plain PyTorch version of the same function for CPU tensors.  Entry points
run on the card unless the caller passes ``device="cpu"``.

Ported so far: the two-level MLMC of the quenched Schwinger model with
both-direction coarsening, with heat-bath coarse chains (the fused path)
or hybrid cluster coarse chains (the unfused path); the topological rotor
with its heat-bath and Wolff cluster samplers; the QM family: the
harmonic and quartic oscillators, HMC on the fused trajectory kernel, the
exact harmonic sampler, the QM conditioned fills and the two-level method
``MonteCarloTwoLevel`` with its fused QM chain kernel; the Gaussian
free field with its fused sweep kernel and its conditioned fill; the
O(3) sigma model with its heat bath, conditioned fill and 2-D cluster
sampler; the Gaussian and semi-coarsened Schwinger fills; the
single-level method ``MonteCarloSingleLevel``, the config reader and the
QM and QFT drivers (``python -m mlmcpathintegral_tpu_torch.drivers.qft``),
which take every model, method and coarsening the JAX drivers take.
"""

__version__ = "0.1.0"
