// Fused chain of closed-form 1-D Wolff cluster updates of the topological
// rotor.
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_rotor.py rotor_cluster_chain
// (_cluster_kernel).  n_steps draws of n_updates cluster updates each; per
// step it emits the winding sum W = sum_j mod_2pi(x_{j+1} - x_j).
//
// One update (samplers/cluster.py _vector_core): a reflection angle xbar
// and a seed site i0, both from site 0's words; the bond energies
// s_b = -kappa2 cos(x_b - xbar) cos(x_{b+1} - xbar) of the configuration
// from before the update give each bond's opening probability with one
// flipped endpoint (p_one = 1 - exp(min(0, s_b))) and with two
// (p_two = 1 - exp(min(0, -s_b))).  F_raw is the walk order of the first
// closed forward bond (M if none), B_raw that of the first closed backward
// bond, capped at B_lim; the terminal links of a full forward or backward
// wrap are tested with p_two.  A site flips, x -> mod_2pi(pi + 2 xbar - x),
// when it is covered an odd number of times.  Update u of step s draws
// CounterRng(site, chain, step = s n_updates + u) words 1 (u_refl),
// 2 (u_seed), 3 (u_f), 4 (u_b).
//
// What bounds it on the H100: latency.  A chain's path (M floats) is read
// once and written once per launch; each update is a cosine per site, two
// per-chain min-reductions and a flip, separated by barriers, with only a
// few hundred operations per site between them.  The design keeps the
// path and its cosines in shared memory for the whole launch, gives one
// thread to each site and one power-of-two group of threads to each chain
// (several chains share a block when M is small), and reduces F_raw and
// B_raw with a shared-memory tree per chain.  Every thread hashes site 0's
// two words itself instead of waiting for a broadcast.

#include <cuda_runtime.h>

#include "rng.cuh"

namespace mlmc {

struct RotorClusterArgs {
  int C, M, n_steps, n_updates;
  float kappa2;
  uint32_t seed1, seed2;
  int tpc, cpb;
};

// Minimum of one int per thread over the tpc consecutive threads of one
// chain; every thread of the block must call it and gets its chain's
// minimum.  red: shared scratch of blockDim.x ints.
__device__ __forceinline__ int chain_min(int v, int* red, int tpc) {
  const int tid = threadIdx.x;
  const int lt = tid & (tpc - 1);
  red[tid] = v;
  __syncthreads();
  for (int off = tpc >> 1; off > 0; off >>= 1) {
    if (lt < off) red[tid] = min(red[tid], red[tid + off]);
    __syncthreads();
  }
  v = red[tid - lt];
  __syncthreads();
  return v;
}

// opening probabilities of bond (m, m+1) with one and with two flipped
// endpoints
__device__ __forceinline__ void bond_probs(const float* c, int m, int M,
                                           float kappa2, float* p_one,
                                           float* p_two) {
  const float s = -kappa2 * c[m] * c[m == M - 1 ? 0 : m + 1];
  *p_one = 1.0f - expf(fminf(s, 0.0f));
  *p_two = 1.0f - expf(fminf(-s, 0.0f));
}

__global__ void rotor_cluster_kernel(const float* __restrict__ x_in,
                                     float* __restrict__ x_out,
                                     float* __restrict__ wsum,
                                     RotorClusterArgs a) {
  extern __shared__ float smem[];
  const int M = a.M;
  const int lc = threadIdx.x / a.tpc;
  const int lt = threadIdx.x - lc * a.tpc;
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < a.C;
  const uint32_t ch = (uint32_t)chain;
  float* x = smem + (size_t)lc * M;
  float* c = smem + (size_t)a.cpb * M + (size_t)lc * M;
  float* red = smem + (size_t)2 * a.cpb * M;
  int* ired = reinterpret_cast<int*>(red);

  const float* src = x_in + (size_t)chain * M;
  for (int m = lt; m < M; m += a.tpc) x[m] = valid ? src[m] : 0.0f;
  __syncthreads();

  for (int st = 0; st < a.n_steps; ++st) {
    for (int u = 0; u < a.n_updates; ++u) {
      const uint32_t step = (uint32_t)(st * a.n_updates + u);
      const CounterRng rng0(a.seed1, a.seed2, 0u, ch, step);
      const float xbar = (2.0f * rng0.uniform(1u) - 1.0f) * PI_F;
      const float u_seed = rng0.uniform(2u);
      const int i0 = min((int)floorf((1.0f - u_seed) * (float)M), M - 1);

      for (int m = lt; m < M && valid; m += a.tpc) c[m] = cosf(x[m] - xbar);
      __syncthreads();

      // forward walk: first closed bond in walk order rel = (m - i0) mod M
      int f_min = M;
      for (int m = lt; m < M && valid; m += a.tpc) {
        float p_one, p_two;
        bond_probs(c, m, M, a.kappa2, &p_one, &p_two);
        const int d = m - i0;
        const int rel = d < 0 ? d + M : d;
        const CounterRng rng(a.seed1, a.seed2, (uint32_t)m, ch, step);
        if (rng.uniform(3u) >= (rel == M - 1 ? p_two : p_one)) {
          f_min = min(f_min, rel);
        }
      }
      const int F_raw = chain_min(f_min, ired, a.tpc);
      const int B_lim = F_raw >= M ? 1 : M - F_raw;

      // backward walk: bond m is tested (rel_b - 1)-th, rel_b = (i0 - m)
      // mod M; its terminal link re-flips the forward walk's last site
      int b_min = M;
      for (int m = lt; m < M && valid; m += a.tpc) {
        float p_one, p_two;
        bond_probs(c, m, M, a.kappa2, &p_one, &p_two);
        const int d = m - i0;
        const int rel = d < 0 ? d + M : d;
        const int rel_b = rel == 0 ? 0 : M - rel;
        const int k_bw = rel_b == 0 ? M - 1 : rel_b - 1;
        const bool term = k_bw == B_lim - 1 && F_raw < M;
        const CounterRng rng(a.seed1, a.seed2, (uint32_t)m, ch, step);
        if (rng.uniform(4u) >= (term ? p_two : p_one)) {
          b_min = min(b_min, k_bw);
        }
      }
      const int B = min(chain_min(b_min, ired, a.tpc), B_lim);

      for (int m = lt; m < M && valid; m += a.tpc) {
        const int d = m - i0;
        const int rel = d < 0 ? d + M : d;
        const int rel_b = rel == 0 ? 0 : M - rel;
        const int n_flips = (rel == 0) + (rel >= 1 && rel <= F_raw) +
                            (rel_b >= 1 && rel_b <= B) +
                            (rel == 0 && F_raw >= M) + (rel == 0 && B >= M);
        if (n_flips & 1) x[m] = mod_2pi(PI_F + 2.0f * xbar - x[m]);
      }
      __syncthreads();
    }
    float v[1] = {0.0f};
    for (int m = lt; m < M && valid; m += a.tpc) {
      v[0] += mod_2pi(x[m == M - 1 ? 0 : m + 1] - x[m]);
    }
    chain_sum<1>(v, red, a.tpc);
    if (valid && lt == 0) wsum[(size_t)st * a.C + chain] = v[0];
  }

  if (valid) {
    float* dst = x_out + (size_t)chain * M;
    for (int m = lt; m < M; m += a.tpc) dst[m] = x[m];
  }
}

}  // namespace mlmc

// x_in/x_out: [C, M] f32 (may not alias); wsum: [n_steps, C] f32.  tpc
// threads per chain (a power of two), cpb chains per block, smem bytes of
// dynamic shared memory.
extern "C" int mlmc_rotor_cluster(const float* x_in, float* x_out,
                                  float* wsum, int C, int M, int n_steps,
                                  int n_updates, float kappa2, uint32_t seed1,
                                  uint32_t seed2, int tpc, int cpb,
                                  size_t smem, void* stream) {
  mlmc::RotorClusterArgs a{C,      M,     n_steps, n_updates, kappa2,
                           seed1,  seed2, tpc,     cpb};
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlmc::rotor_cluster_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + cpb - 1) / cpb;
  mlmc::rotor_cluster_kernel<<<blocks, tpc * cpb, smem,
                               (cudaStream_t)stream>>>(x_in, x_out, wsum, a);
  return (int)cudaGetLastError();
}
