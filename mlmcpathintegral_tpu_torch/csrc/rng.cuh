// Counter-based RNG and shared device helpers of the Schwinger kernels.
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_rng.py (fmix32, CounterRng,
// element_ids), the device function every fused Pallas kernel draws from.
//
// The bits equal the JAX ones for every (seed, seed2, site, chain, step,
// ctr):
//   base_s = fmix32(fmix32(site*0x9E3779B9 ^ seed) + step*0x165667B1)
//            (step-less streams: fmix32(site*0x9E3779B9 ^ seed))
//   base_c = fmix32(chain*0x85EBCA77 ^ seed2)
//   bits   = fmix32(fmix32(base_s + ctr*0xC2B2AE3D)
//                   + fmix32(base_c + ctr*0x27D4EB2F))
// with the first word of a stream at ctr = 1.  Uniforms on (0, 1] come
// from the exponent bits: 2 - float((b >> 9) | 0x3F800000).
//
// What bounds it on the H100: integer throughput — one word is 3 fmix32
// (2 multiplies, 3 shifts, 3 xors each) plus 2 multiply-adds, all in
// registers; nothing touches memory.  The design draws a word only where
// it is used and computes its counter directly, so a thread that leaves a
// rejection loop early never draws the rounds it skips, and its later
// counters stay where the reference (which draws every round for every
// element) puts them.

#pragma once

#include <stdint.h>

namespace mlmc {

constexpr float PI_F = 3.14159265358979323846f;
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr float HALF_PI_F = 1.57079632679489661923f;      // 0.5 * pi
constexpr float PI2_F = 9.86960440108935861883f;          // pi * pi
constexpr float FOURPI2_INV_F = 0.02533029591058444286f;  // 1 / (4 pi^2)

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

struct CounterRng {
  uint32_t base_s;
  uint32_t base_c;

  __device__ __forceinline__ CounterRng(uint32_t seed1, uint32_t seed2,
                                        uint32_t site, uint32_t chain,
                                        uint32_t step) {
    const uint32_t s0 = fmix32((site * 0x9E3779B9u) ^ seed1);
    base_s = fmix32(s0 + step * 0x165667B1u);
    base_c = fmix32((chain * 0x85EBCA77u) ^ seed2);
  }

  // step-less stream (the JAX class with step=None): base_s is the site
  // lane's first hash alone, base_s = fmix32(site*0x9E3779B9 ^ seed1).
  // The GFF sweep (gff_sweep.cu) draws from it, in the split form below.
  __device__ __forceinline__ CounterRng(uint32_t seed1, uint32_t seed2,
                                        uint32_t site, uint32_t chain) {
    base_s = fmix32((site * 0x9E3779B9u) ^ seed1);
    base_c = fmix32((chain * 0x85EBCA77u) ^ seed2);
  }

  __device__ __forceinline__ uint32_t bits(uint32_t ctr) const {
    return fmix32(fmix32(base_s + ctr * 0xC2B2AE3Du) +
                  fmix32(base_c + ctr * 0x27D4EB2Fu));
  }

  // (0, 1] uniform of word ctr
  __device__ __forceinline__ float uniform(uint32_t ctr) const {
    const float f = __uint_as_float((bits(ctr) >> 9) | 0x3F800000u);
    return 2.0f - f;
  }

  // Box-Muller normal of words ctr (radius) and ctr + 1 (angle)
  __device__ __forceinline__ float normal(uint32_t ctr) const {
    const float u1 = uniform(ctr);
    const float u2 = uniform(ctr + 1);
    return sqrtf(-2.0f * logf(u1)) * cosf(TWO_PI_F * u2);
  }
};

// The same bits split into the parts a kernel can hoist out of its loops
// (rotor_cluster.cu, qm_twolevel.cu, gff_sweep.cu): for every (site,
// chain, step, ctr)
//   split_bits(step_base(site_hash(seed1, site), step),
//              chain_word(seed2, chain, ctr), ctr)
//     == CounterRng(seed1, seed2, site, chain, step).bits(ctr),
// and for the step-less streams
//   split_bits(site_hash(seed1, site), chain_word(seed2, chain, ctr), ctr)
//     == CounterRng(seed1, seed2, site, chain).bits(ctr).
// site_hash is fixed for a launch, chain_word for a chain and a counter.
__device__ __forceinline__ uint32_t site_hash(uint32_t seed1, uint32_t site) {
  return fmix32((site * 0x9E3779B9u) ^ seed1);
}

__device__ __forceinline__ uint32_t step_base(uint32_t site_h, uint32_t step) {
  return fmix32(site_h + step * 0x165667B1u);
}

// chain_word in two parts: the chain's hash (base_c), fixed for a chain,
// and its word at a counter
__device__ __forceinline__ uint32_t chain_base(uint32_t seed2, uint32_t chain) {
  return fmix32((chain * 0x85EBCA77u) ^ seed2);
}

__device__ __forceinline__ uint32_t base_word(uint32_t base_c, uint32_t ctr) {
  return fmix32(base_c + ctr * 0x27D4EB2Fu);
}

__device__ __forceinline__ uint32_t chain_word(uint32_t seed2, uint32_t chain,
                                               uint32_t ctr) {
  return base_word(chain_base(seed2, chain), ctr);
}

__device__ __forceinline__ uint32_t split_bits(uint32_t base_s, uint32_t cw,
                                               uint32_t ctr) {
  return fmix32(fmix32(base_s + ctr * 0xC2B2AE3Du) + cw);
}

// (0, 1] uniform of a word's bits, as CounterRng::uniform
__device__ __forceinline__ float bits_uniform(uint32_t b) {
  return 2.0f - __uint_as_float((b >> 9) | 0x3F800000u);
}

// Box-Muller normal of a radius and an angle uniform, as CounterRng::normal
__device__ __forceinline__ float box_muller(float u1, float u2) {
  return sqrtf(-2.0f * logf(u1)) * cosf(TWO_PI_F * u2);
}

// [-pi, pi) wrap (utils.special.mod_2pi)
__device__ __forceinline__ float mod_2pi(float x) {
  return x - TWO_PI_F * floorf(0.5f * (x + PI_F) / PI_F);
}

// Sum of K per-thread values over the tpc consecutive threads of one chain
// (tpc a power of two dividing blockDim.x).  Every thread of the block
// must call it; on return every thread holds its chain's sums.
// red: shared scratch of K * blockDim.x floats.
template <int K>
__device__ __forceinline__ void chain_sum(float (&v)[K], float* red,
                                          int tpc) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lt = tid & (tpc - 1);
#pragma unroll
  for (int k = 0; k < K; ++k) red[k * nt + tid] = v[k];
  __syncthreads();
  for (int off = tpc >> 1; off > 0; off >>= 1) {
    if (lt < off) {
#pragma unroll
      for (int k = 0; k < K; ++k) red[k * nt + tid] += red[k * nt + tid + off];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = red[k * nt + tid - lt];
  __syncthreads();
}

// Sum and minimum over the `lanes` consecutive lanes of one chain (a power
// of two <= 32, aligned, so a chain never straddles two warps); every lane
// of the warp must call them and every lane gets its chain's value.  The
// sum's butterfly leaves the same bits in every lane of the chain.
__device__ __forceinline__ float lanes_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ int lanes_min(int v, int lanes) {
  if (lanes == 32) return __reduce_min_sync(0xffffffffu, v);
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

}  // namespace mlmc
