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
// One pass for both extents.  The backward walk depends on F_raw only
// through its terminal bond k* = B_lim - 1, which is the bond that closed
// the forward walk (walk order rel = F_raw).  So each site tests its bond
// once: forward as above, backward with p_one for every bond (minimum m1),
// and remembers, for the first forward-closed bond it holds, whether its
// u_b also passes p_two.  Then B = min(m1, 1) when F_raw = M, else
// B = m1 if m1 < k*, k* if bond k*'s u_b >= p_two, B_lim otherwise: the
// same float comparisons on the same values as the two-pass form
// (ops/rotor.py _cluster_update), so the same F_raw and B for every input.
//
// What bounds it on the H100: latency and instruction throughput.  A
// chain's path (M floats) is read once and written once per launch; an
// update is a cosine, an exponential and two counter words per site, then
// two per-chain minima and the flip.  The design puts a chain on one
// warp, or on a power-of-two share of one when M < 32 (several chains a
// warp), with site m on lane m mod lanes: the path and the update's
// cosines live in the chain's own slice of shared memory, the minima are
// warp reductions (__reduce_min_sync, or a shuffle butterfly inside a
// warp), and nothing waits on a block-wide barrier.  The site and chain
// halves of every counter word are hashed once a launch (rng.cuh
// split_bits), and site 0's reflection and seed words once a chain, by its
// lane 0, while the previous update's minima are in flight.

#include <cuda_runtime.h>

#include "rng.cuh"

namespace mlmc {

constexpr int CLUSTER_THREADS_MAX = 128;

struct RotorClusterArgs {
  int C, M, n_steps, n_updates;
  float kappa2;
  uint32_t seed1, seed2;
  uint32_t chain0;  // global index of the launch's first chain
  int lanes;  // lanes per chain: a power of two <= 32
};

__global__ void __launch_bounds__(CLUSTER_THREADS_MAX)
    rotor_cluster_kernel(const float* __restrict__ x_in,
                         float* __restrict__ x_out, float* __restrict__ wsum,
                         RotorClusterArgs a) {
  extern __shared__ float smem[];
  const unsigned FULL = 0xffffffffu;
  const int M = a.M;
  const int G = a.lanes;
  const int lc = threadIdx.x / G;
  const int lt = threadIdx.x & (G - 1);
  const int chain = blockIdx.x * (blockDim.x / G) + lc;
  const bool valid = chain < a.C;
  const uint32_t ch = a.chain0 + (uint32_t)chain;
  // this chain's lanes among the warp's (for the ballot)
  const unsigned group =
      G == 32 ? FULL : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  float* x = smem + (size_t)lc * 2 * M;
  float* c = x + M;

  const uint32_t cw1 = chain_word(a.seed2, ch, 1u);
  const uint32_t cw2 = chain_word(a.seed2, ch, 2u);
  const uint32_t cw3 = chain_word(a.seed2, ch, 3u);
  const uint32_t cw4 = chain_word(a.seed2, ch, 4u);
  const uint32_t h0 = site_hash(a.seed1, 0u);

  const float* src = x_in + (size_t)chain * M;
  for (int m = lt; m < M; m += G) x[m] = valid ? src[m] : 0.0f;
  __syncwarp();

  // site 0's reflection and seed words of update `step`, hashed by the
  // chain's lane 0 (one update ahead, beside the minima) and broadcast
  auto site0_words = [&](uint32_t step, float* u_refl, float* u_seed) {
    float r = 0.0f, q = 0.0f;
    if (lt == 0) {
      const uint32_t b0 = step_base(h0, step);
      r = bits_uniform(split_bits(b0, cw1, 1u));
      q = bits_uniform(split_bits(b0, cw2, 2u));
    }
    *u_refl = __shfl_sync(FULL, r, 0, G);
    *u_seed = __shfl_sync(FULL, q, 0, G);
  };
  float u_refl, u_seed;
  site0_words(0u, &u_refl, &u_seed);

  for (int st = 0; st < a.n_steps; ++st) {
    for (int u = 0; u < a.n_updates; ++u) {
      const uint32_t step = (uint32_t)(st * a.n_updates + u);
      const float xbar = (2.0f * u_refl - 1.0f) * PI_F;
      const int i0 = min((int)floorf((1.0f - u_seed) * (float)M), M - 1);

      for (int m = lt; m < M; m += G) c[m] = cosf(x[m] - xbar);
      __syncwarp();

      // bond m = (m, m+1): forward walk order rel = (m - i0) mod M,
      // backward order k_bw (rel_b - 1, rel_b = (i0 - m) mod M)
      int f_min = M, b_min = M;
      bool f_two = false;
      for (int m = lt; m < M; m += G) {
        // of 1 - exp(min(0, s)) and 1 - exp(min(0, -s)) one is
        // 1 - exp(0) = 0: one exponential gives both, to the bit
        const float s = -a.kappa2 * c[m] * c[m == M - 1 ? 0 : m + 1];
        const float p = 1.0f - expf(-fabsf(s));
        const float p_one = s < 0.0f ? p : 0.0f;
        const float p_two = s > 0.0f ? p : 0.0f;
        const uint32_t bs = step_base(site_hash(a.seed1, (uint32_t)m), step);
        const float u_f = bits_uniform(split_bits(bs, cw3, 3u));
        const float u_b = bits_uniform(split_bits(bs, cw4, 4u));
        const int d = m - i0;
        const int rel = d < 0 ? d + M : d;
        const int rel_b = rel == 0 ? 0 : M - rel;
        const int k_bw = rel_b == 0 ? M - 1 : rel_b - 1;
        if (u_f >= (rel == M - 1 ? p_two : p_one) && rel < f_min) {
          f_min = rel;
          f_two = u_b >= p_two;
        }
        if (u_b >= p_one) b_min = min(b_min, k_bw);
      }
      const int F_raw = lanes_min(f_min, G);
      const int m1 = lanes_min(b_min, G);
      site0_words(step + 1u, &u_refl, &u_seed);
      // the lane holding the bond that closed the forward walk tells
      // whether its backward word passes p_two
      const bool t_two =
          (__ballot_sync(FULL, f_two && f_min == F_raw) & group) != 0u;
      int B;
      if (F_raw >= M) {
        B = min(m1, 1);
      } else {
        const int k_star = M - F_raw - 1;  // B_lim - 1
        B = m1 < k_star ? m1 : (t_two ? k_star : k_star + 1);
      }

      for (int m = lt; m < M; m += G) {
        const int d = m - i0;
        const int rel = d < 0 ? d + M : d;
        const int rel_b = rel == 0 ? 0 : M - rel;
        const int n_flips = (rel == 0) + (rel >= 1 && rel <= F_raw) +
                            (rel_b >= 1 && rel_b <= B) +
                            (rel == 0 && F_raw >= M) + (rel == 0 && B >= M);
        if (n_flips & 1) x[m] = mod_2pi(PI_F + 2.0f * xbar - x[m]);
      }
      __syncwarp();
    }
    float v = 0.0f;
    for (int m = lt; m < M; m += G) {
      v += mod_2pi(x[m == M - 1 ? 0 : m + 1] - x[m]);
    }
    v = lanes_sum(v, G);
    if (valid && lt == 0) wsum[(size_t)st * a.C + chain] = v;
  }

  if (valid) {
    float* dst = x_out + (size_t)chain * M;
    for (int m = lt; m < M; m += G) dst[m] = x[m];
  }
}

static cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(rotor_cluster_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace mlmc

// x_in/x_out: [C, M] f32 (may not alias); wsum: [n_steps, C] f32.  lanes
// per chain (a power of two <= 32), threads per block (a multiple of 32,
// at most 128), smem bytes of dynamic shared memory (2 M floats a chain).
// chain0: the global index of the launch's chain 0, which the chain words
// hash.
extern "C" int mlmc_rotor_cluster(const float* x_in, float* x_out,
                                  float* wsum, int C, int M, int n_steps,
                                  int n_updates, float kappa2, uint32_t seed1,
                                  uint32_t seed2, uint32_t chain0, int lanes,
                                  int threads, size_t smem, void* stream) {
  mlmc::RotorClusterArgs a{C,      M,     n_steps, n_updates,
                           kappa2, seed1, seed2,   chain0,
                           lanes};
  cudaError_t e = mlmc::allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  const int cpb = threads / lanes;
  const int blocks = (C + cpb - 1) / cpb;
  mlmc::rotor_cluster_kernel<<<blocks, threads, smem,
                               (cudaStream_t)stream>>>(x_in, x_out, wsum, a);
  return (int)cudaGetLastError();
}

// Registers a thread, local (spilled) bytes a thread and resident blocks
// an SM of a launch with these threads and shared bytes: out[0..2].
extern "C" int mlmc_rotor_cluster_attrs(int threads, size_t smem, int* out) {
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, mlmc::rotor_cluster_kernel);
  if (e == cudaSuccess) e = mlmc::allow_smem(smem);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], mlmc::rotor_cluster_kernel, threads, smem);
  }
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)e;
}
