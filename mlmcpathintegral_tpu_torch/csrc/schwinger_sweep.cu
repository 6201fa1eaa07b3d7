// Fused overrelax + heat-bath sweep chain of the quenched Schwinger model.
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_schwinger.py
// schwinger_sweep (_sweep_kernel) and schwinger_sweep_chain
// (_chain_kernel).  One kernel serves both: n_steps draws with stream
// indices step_offset + s, so n_steps = 1 is schwinger_sweep and the chain
// equals n_steps single draws with step_offset = 0 .. n_steps-1 bit for
// bit.  Per step it emits Q = sum_P mod_2pi(theta_P) and, with esum,
// E = sum_P cos(theta_P).
//
// What bounds it on the H100: latency, not bandwidth.  A chain's field
// (2 Mx Mt floats, 128 B for the 4x4 coarsest level of the 8x8 headline)
// is read once and written once per launch; between, every draw is
// 8 quarter-sweeps of stencil reads from shared memory, counter hashing
// and a data-dependent rejection loop, separated by block barriers.
// The design keeps the whole chain resident in shared memory for all
// n_steps draws (one global round trip per launch, as the Pallas kernel
// keeps it in VMEM) and packs several chains into a block so that small
// lattices still give each block a few warps.  Q and E are per-chain
// shared-memory tree sums.
//
// A field beyond the shared memory one block may opt in to (227 KB on
// the H100: a 256x128 lattice's links are 256 KB a chain) takes the second
// branch: the chain's two planes live in its slice of a global scratch
// buffer the wrapper allocates (work != nullptr), one chain per block,
// updated in place with the same __syncthreads() between link groups;
// only the reduction scratch stays in shared memory.  The sweeps are the
// same device functions on the same planes, so both branches compute the
// same bits.

#include <cuda_runtime.h>

#include "schwinger_sweep.cuh"

namespace mlmc {

struct SweepArgs {
  int C, Mx, Mt, n_steps, step_offset, n_overrelax, n_heatbath, k_rej;
  float beta;
  uint32_t seed1, seed2;
  int tpc, cpb;
};

__global__ void schwinger_sweep_kernel(const float* __restrict__ theta_in,
                                       float* __restrict__ theta_out,
                                       float* __restrict__ qsum,
                                       float* __restrict__ esum,
                                       float* work, SweepArgs a) {
  extern __shared__ float smem[];
  const int nsites = a.Mx * a.Mt;
  const int lc = threadIdx.x / a.tpc;
  const int lt = threadIdx.x - lc * a.tpc;
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < a.C;
  // the planes in shared memory, or in global memory (one chain a block)
  float* T = work != nullptr ? work + (size_t)chain * 2 * nsites
                             : smem + (size_t)lc * 2 * nsites;
  float* X = T + nsites;
  float* red = work != nullptr ? smem : smem + (size_t)a.cpb * 2 * nsites;

  const float* src = theta_in + (size_t)chain * 2 * nsites;
  for (int s = lt; s < nsites; s += a.tpc) {
    T[s] = valid ? src[2 * s] : 0.0f;
    X[s] = valid ? src[2 * s + 1] : 0.0f;
  }
  __syncthreads();

  for (int st = 0; st < a.n_steps; ++st) {
    sweep_step(T, X, a.Mx, a.Mt, lt, a.tpc, valid, a.seed1, a.seed2,
               (uint32_t)chain, (uint32_t)(a.step_offset + st), a.beta,
               a.n_overrelax, a.n_heatbath, a.k_rej);
    if (qsum != nullptr) {
      float v[2];
      plaquette_sums(T, X, a.Mx, a.Mt, lt, a.tpc, &v[0], &v[1]);
      chain_sum<2>(v, red, a.tpc);
      if (valid && lt == 0) {
        qsum[(size_t)st * a.C + chain] = v[0];
        if (esum != nullptr) esum[(size_t)st * a.C + chain] = v[1];
      }
    }
  }

  if (valid) {
    float* dst = theta_out + (size_t)chain * 2 * nsites;
    for (int s = lt; s < nsites; s += a.tpc) {
      dst[2 * s] = T[s];
      dst[2 * s + 1] = X[s];
    }
  }
}

}  // namespace mlmc

extern "C" int mlmc_max_smem_optin(int device, int* out) {
  return (int)cudaDeviceGetAttribute(
      out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// theta_in/theta_out: [C, 2*Mx*Mt] f32 (may not alias); qsum/esum:
// [n_steps, C] f32 or null; work: null, or [C, 2*Mx*Mt] f32 scratch for
// the global-memory branch (then cpb = 1).  tpc threads per chain (a
// power of two), cpb chains per block, smem bytes of dynamic shared
// memory.
extern "C" int mlmc_schwinger_sweep(const float* theta_in, float* theta_out,
                                    float* qsum, float* esum, float* work,
                                    int C, int Mx,
                                    int Mt, int n_steps, int step_offset,
                                    int n_overrelax, int n_heatbath,
                                    int k_rej, float beta, uint32_t seed1,
                                    uint32_t seed2, int tpc, int cpb,
                                    size_t smem, void* stream) {
  mlmc::SweepArgs a{C, Mx, Mt, n_steps, step_offset, n_overrelax,
                    n_heatbath, k_rej, beta, seed1, seed2, tpc, cpb};
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlmc::schwinger_sweep_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + cpb - 1) / cpb;
  mlmc::schwinger_sweep_kernel<<<blocks, tpc * cpb, smem,
                                 (cudaStream_t)stream>>>(
      theta_in, theta_out, qsum, esum, work, a);
  return (int)cudaGetLastError();
}
