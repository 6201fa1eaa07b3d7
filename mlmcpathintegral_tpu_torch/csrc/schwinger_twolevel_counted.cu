// The counted instantiations of the fused two-level kernels
// (schwinger_twolevel.cuh), in a file of their own so that nvcc builds
// them beside the uncounted ones (schwinger_twolevel.cu).

#include "schwinger_twolevel.cuh"

namespace mlmc {

TwoLevelKernel twolevel_kernel_counted(bool warp) {
  return warp ? schwinger_twolevel_kernel<true>
              : schwinger_twolevel_team_kernel<true>;
}

}  // namespace mlmc
