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
// What bounds it on the H100: the stores (12 bytes a word for bits,
// uniforms and half as many normals); the hashing is a few dozen integer
// instructions a word.  One thread per (step, ctr, chain, site) tuple in
// a grid-stride loop, neighbouring threads on neighbouring sites so the
// stores coalesce.

#include <cuda_runtime.h>

#include "rng.cuh"

namespace mlmc {

// bits/uni: [n_steps, n_ctr, n_chains, n_sites] at ctr = 1 .. n_ctr;
// nrm: [n_steps, n_ctr / 2, n_chains, n_sites] from words (2k+1, 2k+2);
// stepless: the streams take no step index (n_steps is 1)
__global__ void rng_fill_kernel(uint32_t* __restrict__ bits,
                                float* __restrict__ uni,
                                float* __restrict__ nrm, uint32_t seed1,
                                uint32_t seed2, int n_sites, int n_chains,
                                int step0, int n_steps, int n_ctr,
                                int stepless) {
  const size_t per_step = (size_t)n_ctr * n_chains * n_sites;
  const size_t total = per_step * n_steps;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int site = (int)(idx % n_sites);
    const int chain = (int)((idx / n_sites) % n_chains);
    const int k = (int)((idx / ((size_t)n_sites * n_chains)) % n_ctr);
    const int st = (int)(idx / per_step);
    const CounterRng rng =
        stepless ? CounterRng(seed1, seed2, (uint32_t)site, (uint32_t)chain)
                 : CounterRng(seed1, seed2, (uint32_t)site, (uint32_t)chain,
                              (uint32_t)(step0 + st));
    bits[idx] = rng.bits((uint32_t)(k + 1));
    uni[idx] = rng.uniform((uint32_t)(k + 1));
    if (k < n_ctr / 2) {
      const size_t o = (((size_t)st * (n_ctr / 2) + k) * n_chains + chain) *
                           n_sites + site;
      nrm[o] = rng.normal((uint32_t)(2 * k + 1));
    }
  }
}

}  // namespace mlmc

extern "C" int mlmc_rng_fill(uint32_t* bits, float* uni, float* nrm,
                             uint32_t seed1, uint32_t seed2, int n_sites,
                             int n_chains, int step0, int n_steps, int n_ctr,
                             int stepless, void* stream) {
  const size_t total = (size_t)n_steps * n_ctr * n_chains * n_sites;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 ? (want > 0 ? want : 1) : 65535);
  mlmc::rng_fill_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      bits, uni, nrm, seed1, seed2, n_sites, n_chains, step0, n_steps, n_ctr,
      stepless);
  return (int)cudaGetLastError();
}
