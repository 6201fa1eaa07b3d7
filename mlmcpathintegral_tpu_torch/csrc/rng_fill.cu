// Writes the counter RNG's words for a grid of ids, so that the device
// function of rng.cuh can be held against its plain PyTorch version.
//
// Replaces: nothing launched on the TPU — mlmcpathintegral_tpu/ops/
// pallas_rng.py is a device function inside the fused kernels; this
// launcher only exposes it.  Its step-less mode (stepless != 0: streams
// without a step index, one step) replaces tools/perf_probe.py
// probe_verify_rng's rng_kernel, which held the Pallas generator's
// step-less stream compiled against interpret mode.
//
// What bounds it on the H100: the stores, 10 bytes a word (bits and
// uniform, half a normal); a word's hash is 3 fmix32 and a pair's
// Box-Muller normal a precise log, square root and cosine.  The design
// hashes each id once: a thread owns one (step, chain, site) and walks its
// counters in word pairs, so the site lane (site_hash, step_base) and the
// chain lane (chain_base) are hashed once a thread and a word costs one
// base_word and one split_bits.  A 2-D grid with 32-bit indices: x runs
// over the (chain, site) plane, neighbouring threads on neighbouring
// sites, so every store of a warp is one contiguous run; y runs over the
// steps (looping where there are more than gridDim.y).  The wrapper
// (ops/rng.py fill_launch) refuses a grid whose plane or whole output
// passes 2^31 words, so no index wraps.

#include <cuda_runtime.h>

#include "rng.cuh"

namespace mlmc {

// bits/uni: [n_steps, n_ctr, n_chains, n_sites] at ctr = 1 .. n_ctr;
// nrm: [n_steps, n_ctr / 2, n_chains, n_sites] from words (2j+1, 2j+2);
// stepless: the streams take no step index (n_steps is 1)
__global__ void rng_fill_kernel(uint32_t* __restrict__ bits,
                                float* __restrict__ uni,
                                float* __restrict__ nrm, uint32_t seed1,
                                uint32_t seed2, uint32_t chain0,
                                int n_sites, int n_chains, int step0,
                                int n_steps, int n_ctr, int stepless) {
  const int plane = n_chains * n_sites;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const int chain = i / n_sites;
  const int site = i - chain * n_sites;
  const uint32_t site_h = site_hash(seed1, (uint32_t)site);
  const uint32_t base_c = chain_base(seed2, chain0 + (uint32_t)chain);
  const int n_pairs = n_ctr / 2;
  for (int st = blockIdx.y; st < n_steps; st += gridDim.y) {
    const uint32_t base_s =
        stepless ? site_h : step_base(site_h, (uint32_t)(step0 + st));
    uint32_t* b = bits + st * n_ctr * plane + i;
    float* u = uni + st * n_ctr * plane + i;
    float* z = nrm + st * n_pairs * plane + i;
    for (int j = 0; j < n_pairs; ++j) {
      const uint32_t c1 = (uint32_t)(2 * j + 1);
      const uint32_t w1 = split_bits(base_s, base_word(base_c, c1), c1);
      const uint32_t w2 =
          split_bits(base_s, base_word(base_c, c1 + 1u), c1 + 1u);
      const float u1 = bits_uniform(w1);
      const float u2 = bits_uniform(w2);
      b[(2 * j) * plane] = w1;
      b[(2 * j + 1) * plane] = w2;
      u[(2 * j) * plane] = u1;
      u[(2 * j + 1) * plane] = u2;
      z[j * plane] = box_muller(u1, u2);
    }
    if (n_ctr & 1) {
      const uint32_t c = (uint32_t)n_ctr;
      const uint32_t w = split_bits(base_s, base_word(base_c, c), c);
      b[(n_ctr - 1) * plane] = w;
      u[(n_ctr - 1) * plane] = bits_uniform(w);
    }
  }
}

}  // namespace mlmc

// threads, blocks_x, blocks_y: the launch of ops/rng.py fill_launch;
// chain0: the global index of the grid's chain 0, which the chain lane
// hashes
extern "C" int mlmc_rng_fill(uint32_t* bits, float* uni, float* nrm,
                             uint32_t seed1, uint32_t seed2, uint32_t chain0,
                             int n_sites,
                             int n_chains, int step0, int n_steps, int n_ctr,
                             int stepless, int threads, int blocks_x,
                             int blocks_y, void* stream) {
  mlmc::rng_fill_kernel<<<dim3(blocks_x, blocks_y), threads, 0,
                          (cudaStream_t)stream>>>(
      bits, uni, nrm, seed1, seed2, chain0, n_sites, n_chains, step0, n_steps,
      n_ctr, stepless);
  return (int)cudaGetLastError();
}
