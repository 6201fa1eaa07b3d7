// The counted instantiations of the Schwinger sweep kernel
// (schwinger_sweep_kernel.cuh), in a file of their own so that nvcc builds
// them beside the uncounted ones (schwinger_sweep.cu).

#include "schwinger_sweep_kernel.cuh"

namespace mlmc {

SweepKernel sweep_kernel_counted(bool warp) {
  return warp ? schwinger_sweep_kernel<true, true>
              : schwinger_sweep_kernel<false, true>;
}

}  // namespace mlmc
