// Fused overrelax + heat-bath sweep chain of the quenched Schwinger model:
// the launch of the uncounted kernels and the library's C interface of the
// kernel (schwinger_sweep_kernel.cuh, which describes it).

#include <cuda_runtime.h>

#include "schwinger_sweep_kernel.cuh"

namespace mlmc {

// the kernel of a launch: the warp design where warp, counted where
// counted
inline SweepKernel sweep_kernel(bool warp, bool counted) {
  if (counted) return sweep_kernel_counted(warp);
  return warp ? schwinger_sweep_kernel<true, false>
              : schwinger_sweep_kernel<false, false>;
}

}  // namespace mlmc

extern "C" int mlmc_max_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// theta_in/theta_out: [C, 2*Mx*Mt] f32 (may not alias); qsum/esum:
// [n_steps, C] f32 or null; work: null, or [C, 2*Mx*Mt] f32 scratch for
// the global-memory branch (then one chain per block).  chain0: the global
// index of chain 0 of this launch, which the chain words hash (0 for a
// launch over all chains; a rank's first chain under a chain mesh).
// lanes per chain (a power of two: <= 32 the warp design, else the team of
// the block design, team_layout_ok), cpb chains per block, smem bytes of
// dynamic shared memory.  rounds: null, or 3 zeroed int64 to which the
// counted kernel adds the heat bath's draws, rounds needed and rounds
// evaluated.
extern "C" int mlmc_schwinger_sweep(const float* theta_in, float* theta_out,
                                    float* qsum, float* esum, float* work,
                                    unsigned long long* rounds, int C, int Mx,
                                    int Mt, int n_steps, int step_offset,
                                    int n_overrelax, int n_heatbath,
                                    int k_rej, float beta, uint32_t seed1,
                                    uint32_t seed2, uint32_t chain0,
                                    int lanes, int cpb, size_t smem,
                                    void* stream) {
  mlmc::SweepArgs a{C,         Mx,   Mt,    n_steps, step_offset, n_overrelax,
                    n_heatbath, k_rej, beta, seed1,  seed2,       chain0,
                    lanes,     cpb};
  if (lanes > 32 && !mlmc::team_layout_ok(lanes, cpb, Mx * Mt))
    return (int)cudaErrorInvalidValue;
  const mlmc::SweepKernel k =
      mlmc::sweep_kernel(lanes <= 32, rounds != nullptr);
  const cudaError_t e = mlmc::allow_sweep_smem(k, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(C + cpb - 1) / cpb, lanes * cpb, smem, (cudaStream_t)stream>>>(
      theta_in, theta_out, qsum, esum, work, rounds, a);
  return (int)cudaGetLastError();
}

// Registers a thread, local (spilled) bytes a thread and resident blocks
// an SM of the launch with these threads and shared bytes (the warp design
// when warp != 0; the counted kernel when counted != 0): out[0..2].
extern "C" int mlmc_schwinger_sweep_attrs(int threads, size_t smem, int warp,
                                          int counted, int* out) {
  const mlmc::SweepKernel k = mlmc::sweep_kernel(warp != 0, counted != 0);
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  if (e == cudaSuccess) e = mlmc::allow_sweep_smem(k, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], k, threads,
                                                      smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)e;
}
