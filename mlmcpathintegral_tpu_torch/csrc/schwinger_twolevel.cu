// Fused two-level MLMC chain of the quenched Schwinger model: the launch
// of the uncounted kernels and the library's C interface of the kernel
// (schwinger_twolevel.cuh, which describes it).

#include <cuda_runtime.h>

#include "schwinger_twolevel.cuh"

namespace mlmc {

// the kernel of a launch of G lanes a chain: the warp design up to 32;
// the counted instantiation where counted
inline TwoLevelKernel twolevel_kernel(bool warp, bool counted) {
  if (counted) return twolevel_kernel_counted(warp);
  return warp ? schwinger_twolevel_kernel<false>
              : schwinger_twolevel_team_kernel<false>;
}

}  // namespace mlmc

// fine: [C, 2*Mt*Mx], coarse: [C, 2*Mt*Mx/4], caches [C]; outputs as the
// Pallas kernel: fine', coarse', S_fine', S_cond', y [n_steps, C],
// qc/ec [n_steps*t_sub, C], acc [n_steps, C]; all f32, inputs and outputs
// distinct.  alphas: n_alpha rescaled series coefficients (exact branch).
// lanes per chain (a power of two: <= 32 the warp design, else the team of
// the block design, schwinger_sweep.cuh team_layout_ok), cpb chains per
// block, smem bytes of dynamic shared memory.  chain0: the global index of
// the launch's chain 0, which the chain words hash.  rounds: null, or 9
// zeroed int64 to which the counted kernel adds the draws, rounds needed
// and rounds evaluated of the coarse heat bath, the BesselProduct draws
// and the ExpCos fill, in that order.
extern "C" int mlmc_schwinger_twolevel(
    const float* fine_in, const float* coarse_in, const float* sf_in,
    const float* sq_in, float* fine_out, float* coarse_out, float* sf_out,
    float* sq_out, float* y, float* qc, float* ec, float* acc,
    const float* alphas, unsigned long long* rounds, int n_alpha, int C,
    int Mx, int Mt, int n_steps, int t_sub, int n_overrelax_c,
    int n_heatbath_c, int k_rej,
    int k_rej_fill, int k_rej_bessel, int exact, int small_beta, float beta,
    float beta_c, float two_L, float sigma_beta, float sigma_half,
    uint32_t seed1, uint32_t seed2, uint32_t chain0, int lanes, int cpb,
    size_t smem, void* stream) {
  mlmc::TwoLevelArgs a{C,          Mx / 2,       Mt / 2,       n_steps,
                       t_sub,      n_overrelax_c, n_heatbath_c, k_rej,
                       k_rej_fill, k_rej_bessel, exact,        small_beta,
                       n_alpha,    beta,         beta_c,       2.0f * beta,
                       two_L,      sigma_beta,   sigma_half,   seed1,
                       seed2,      chain0,       lanes,        cpb};
  if (lanes > 32 && !mlmc::team_layout_ok(lanes, cpb, (Mx / 2) * (Mt / 2)))
    return (int)cudaErrorInvalidValue;
  const mlmc::TwoLevelKernel k =
      mlmc::twolevel_kernel(lanes <= 32, rounds != nullptr);
  const cudaError_t e = mlmc::allow_twolevel_smem(k, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(C + cpb - 1) / cpb, lanes * cpb, smem, (cudaStream_t)stream>>>(
      fine_in, coarse_in, sf_in, sq_in, fine_out, coarse_out, sf_out, sq_out,
      y, qc, ec, acc, alphas, rounds, a);
  return (int)cudaGetLastError();
}

// Registers a thread, local (spilled) bytes a thread and resident blocks
// an SM of the launch with these threads and shared bytes (the warp design
// when warp != 0; the counted kernel when counted != 0): out[0..2].
extern "C" int mlmc_schwinger_twolevel_attrs(int threads, size_t smem,
                                             int warp, int counted,
                                             int* out) {
  const mlmc::TwoLevelKernel k =
      mlmc::twolevel_kernel(warp != 0, counted != 0);
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (e == cudaSuccess) e = mlmc::allow_twolevel_smem(k, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], k, threads,
                                                      smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)e;
}
