// Fused even/odd overrelax + ExpCos heat-bath sweep chain of the
// topological rotor.
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_rotor.py rotor_sweep_chain
// (_chain_kernel, _one_step, _winding_sum) and rotor_sweep (the chain at
// n_steps = 1, step 0).  Per step it emits the winding sum
// W = sum_j mod_2pi(x_{j+1} - x_j).
//
// The conditional of site j given its neighbours is
// exp[kappa (cos(x - x_{j-1}) + cos(x - x_{j+1}))], kappa = I/a: the same
// ExpCos draw as a Schwinger link given its two staples, so the rejection
// device code of schwinger_sweep.cuh is reused with tp = x_{j-1},
// tm = x_{j+1}.  The overrelaxation reflection is
// mod_2pi(x_{j-1} + x_{j+1} - x_j).
//
// What bounds it on the H100: latency, not bandwidth or arithmetic.  A
// chain's path (M floats, 1 KB at M = 256) is read once and written once
// per launch; between, every step is two dependent half-sweeps per sweep
// kind, each a barrier-separated pass of counter hashing and a
// data-dependent rejection loop (3 words a round, at most k_rej rounds).
// The design keeps the path in shared memory for all n_steps draws, gives
// one thread to each site pair (2k, 2k+1): the thread updates its even
// site, the block synchronises, then it updates its odd site, so one
// group of M/2 threads serves a chain and small paths share a block.  Both
// sites of a pair use RNG site id k; a thread computes each word's counter
// from (sweep, parity, round) and leaves a rejection loop at its first
// accepted round without drawing the rounds it skips, which the reference
// draws for every site.

#include <cuda_runtime.h>

#include "schwinger_sweep.cuh"

namespace mlmc {

struct RotorSweepArgs {
  int C, M, n_steps, n_overrelax, n_heatbath, k_rej;
  float kappa;
  uint32_t seed1, seed2;
  int tpc, cpb;
};

__global__ void rotor_sweep_kernel(const float* __restrict__ x_in,
                                   float* __restrict__ x_out,
                                   float* __restrict__ wsum,
                                   RotorSweepArgs a) {
  extern __shared__ float smem[];
  const int M = a.M;
  const int H = M / 2;
  const int lc = threadIdx.x / a.tpc;
  const int lt = threadIdx.x - lc * a.tpc;
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < a.C;
  float* x = smem + (size_t)lc * M;
  float* red = smem + (size_t)a.cpb * M;

  const float* src = x_in + (size_t)chain * M;
  for (int s = lt; s < M; s += a.tpc) x[s] = valid ? src[s] : 0.0f;
  __syncthreads();

  for (int st = 0; st < a.n_steps; ++st) {
    for (int r = 0; r < a.n_overrelax; ++r) {
      for (int par = 0; par < 2; ++par) {
        for (int k = lt; k < H && valid; k += a.tpc) {
          const int j = 2 * k + par;
          const float xm = x[j == 0 ? M - 1 : j - 1];
          const float xp = x[j == M - 1 ? 0 : j + 1];
          x[j] = mod_2pi(xm + xp - x[j]);
        }
        __syncthreads();
      }
    }
    for (int h = 0; h < a.n_heatbath; ++h) {
      for (int par = 0; par < 2; ++par) {
        const uint32_t ctr0 = (uint32_t)((h * 2 + par) * a.k_rej * 3);
        for (int k = lt; k < H && valid; k += a.tpc) {
          const int j = 2 * k + par;
          const float xm = x[j == 0 ? M - 1 : j - 1];
          const float xp = x[j == M - 1 ? 0 : j + 1];
          const CounterRng rng(a.seed1, a.seed2, (uint32_t)k,
                               (uint32_t)chain, (uint32_t)st);
          float out;
          if (expcos_draw(rng, ctr0, xm, xp, a.kappa, a.k_rej, &out)) {
            x[j] = out;
          }
        }
        __syncthreads();
      }
    }
    if (wsum != nullptr) {
      float v[1] = {0.0f};
      for (int k = lt; k < H; k += a.tpc) {
        const float e = x[2 * k];
        const float o = x[2 * k + 1];
        const float e1 = x[2 * k + 2 == M ? 0 : 2 * k + 2];
        v[0] += mod_2pi(o - e) + mod_2pi(e1 - o);
      }
      chain_sum<1>(v, red, a.tpc);
      if (valid && lt == 0) wsum[(size_t)st * a.C + chain] = v[0];
    }
  }

  if (valid) {
    float* dst = x_out + (size_t)chain * M;
    for (int s = lt; s < M; s += a.tpc) dst[s] = x[s];
  }
}

}  // namespace mlmc

// x_in/x_out: [C, M] f32 (may not alias, M even); wsum: [n_steps, C] f32
// or null.  tpc threads per chain (a power of two), cpb chains per block,
// smem bytes of dynamic shared memory.
extern "C" int mlmc_rotor_sweep(const float* x_in, float* x_out, float* wsum,
                                int C, int M, int n_steps, int n_overrelax,
                                int n_heatbath, int k_rej, float kappa,
                                uint32_t seed1, uint32_t seed2, int tpc,
                                int cpb, size_t smem, void* stream) {
  mlmc::RotorSweepArgs a{C,     M,     n_steps, n_overrelax, n_heatbath,
                         k_rej, kappa, seed1,   seed2,       tpc,
                         cpb};
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlmc::rotor_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + cpb - 1) / cpb;
  mlmc::rotor_sweep_kernel<<<blocks, tpc * cpb, smem,
                             (cudaStream_t)stream>>>(x_in, x_out, wsum, a);
  return (int)cudaGetLastError();
}
