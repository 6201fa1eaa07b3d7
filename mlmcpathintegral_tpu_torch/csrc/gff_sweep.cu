// Red/black overrelax + Gaussian heat-bath sweeps of the plain 2-D
// Gaussian free field, and its raw neighbour sum.
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_gff.py gff_sweep
// (_sweep_kernel, _nbsum, _colour_mask) and the neighbour-sum probe of
// tools/perf_probe.py (probe_verify_gff.nb_kernel).
//
// One draw: n_overrelax reflections phi -> 2 nb/kappa - phi, then
// n_heatbath heat-bath sweeps phi ~ nb/kappa + sigma N(0, 1), each as red
// ((i + j) even) then black, with nb the 4-point periodic neighbour sum in
// the Pallas kernel's order ((phi[j-1] + phi[j+1]) + phi[i-1]) + phi[i+1].
// The normals come from the step-less counter streams of rng.cuh at the
// site l = Mt*j + i and the global chain index: heat-bath sweep h, colour c
// draws words 4h + 2c + 1 and 4h + 2c + 2 (the Pallas kernel draws a
// normal for every site of every half-sweep; a thread draws only those of
// the sites it updates, computing their counters directly).
//
// What bounds it on the H100: latency.  A chain's field (Mx*Mt floats,
// 1 KB at 16x16) is read once and written once per launch; between, each
// half-sweep is a 4-point stencil from shared memory and, in the heat
// bath, one Box-Muller normal per site, separated by block barriers.  The
// design keeps the field in shared memory (one global round trip per
// launch, as the Pallas kernel keeps it in VMEM), one group of threads per
// chain striding over the sites, several chains per block on small
// lattices.  A field beyond the shared memory one block may opt in to
// (from 256x256, 256 KB per chain) is updated in place in the output
// tensor instead, one chain per block, with the same barriers.  The
// in-place update within a colour needs even Mt and Mx (every neighbour
// of a site has the other colour); the wrapper refuses odd sizes.

#include <cuda_runtime.h>

#include "rng.cuh"

namespace mlmc {

struct GffArgs {
  int C, Mx, Mt, n_overrelax, n_heatbath;
  float kappa, sigma;
  uint32_t seed1, seed2;
  int tpc, cpb, in_global;
};

// 4-point periodic neighbour sum of site (j, i) on a [Mx][Mt] plane, in
// the Pallas kernel's order
__device__ __forceinline__ float gff_nb(const float* P, int j, int i,
                                        int Mx, int Mt) {
  const int jm = j == 0 ? Mx - 1 : j - 1;
  const int jp = j == Mx - 1 ? 0 : j + 1;
  const int im = i == 0 ? Mt - 1 : i - 1;
  const int ip = i == Mt - 1 ? 0 : i + 1;
  return ((P[jm * Mt + i] + P[jp * Mt + i]) + P[j * Mt + im]) + P[j * Mt + ip];
}

__global__ void gff_sweep_kernel(const float* __restrict__ phi_in,
                                 float* phi_out, GffArgs a) {
  extern __shared__ float smem[];
  const int n = a.Mx * a.Mt;
  const int lc = threadIdx.x / a.tpc;
  const int lt = threadIdx.x - lc * a.tpc;
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < a.C;
  float* dst = phi_out + (size_t)chain * n;
  float* P = a.in_global ? dst : smem + (size_t)lc * n;

  if (valid) {
    const float* src = phi_in + (size_t)chain * n;
    for (int s = lt; s < n; s += a.tpc) P[s] = src[s];
  }
  __syncthreads();

  for (int o = 0; o < a.n_overrelax; ++o) {
    for (int colour = 0; colour < 2; ++colour) {
      for (int s = lt; s < n && valid; s += a.tpc) {
        const int j = s / a.Mt;
        const int i = s - j * a.Mt;
        if (((i + j) & 1) != colour) continue;
        const float nb = gff_nb(P, j, i, a.Mx, a.Mt);
        P[s] = 2.0f * nb / a.kappa - P[s];
      }
      __syncthreads();
    }
  }
  for (int h = 0; h < a.n_heatbath; ++h) {
    for (int colour = 0; colour < 2; ++colour) {
      const uint32_t ctr = (uint32_t)(4 * h + 2 * colour + 1);
      for (int s = lt; s < n && valid; s += a.tpc) {
        const int j = s / a.Mt;
        const int i = s - j * a.Mt;
        if (((i + j) & 1) != colour) continue;
        const float nb = gff_nb(P, j, i, a.Mx, a.Mt);
        const CounterRng rng(a.seed1, a.seed2, (uint32_t)s, (uint32_t)chain);
        P[s] = nb / a.kappa + a.sigma * rng.normal(ctr);
      }
      __syncthreads();
    }
  }

  if (valid && !a.in_global) {
    for (int s = lt; s < n; s += a.tpc) dst[s] = P[s];
  }
}

// P1: out[c, l] = the neighbour sum of site l of chain c
__global__ void gff_nbsum_kernel(const float* __restrict__ phi,
                                 float* __restrict__ out, int C, int Mx,
                                 int Mt) {
  const int n = Mx * Mt;
  const size_t total = (size_t)C * n;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
       idx < total; idx += (size_t)gridDim.x * blockDim.x) {
    const int s = (int)(idx % n);
    const int j = s / Mt;
    const int i = s - j * Mt;
    out[idx] = gff_nb(phi + (idx - s), j, i, Mx, Mt);
  }
}

}  // namespace mlmc

// phi_in/phi_out: [C, Mx*Mt] f32 (may not alias).  tpc threads per chain
// (a power of two), cpb chains per block, smem bytes of dynamic shared
// memory; in_global: the fields are updated in phi_out (then cpb = 1 and
// smem = 0).
extern "C" int mlmc_gff_sweep(const float* phi_in, float* phi_out, int C,
                              int Mx, int Mt, int n_overrelax,
                              int n_heatbath, float kappa, float sigma,
                              uint32_t seed1, uint32_t seed2, int tpc,
                              int cpb, int in_global, size_t smem,
                              void* stream) {
  mlmc::GffArgs a{C,     Mx,    Mt,    n_overrelax, n_heatbath, kappa,
                  sigma, seed1, seed2, tpc,         cpb,        in_global};
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlmc::gff_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + cpb - 1) / cpb;
  mlmc::gff_sweep_kernel<<<blocks, tpc * cpb, smem, (cudaStream_t)stream>>>(
      phi_in, phi_out, a);
  return (int)cudaGetLastError();
}

// phi/out: [C, Mx*Mt] f32
extern "C" int mlmc_gff_nbsum(const float* phi, float* out, int C, int Mx,
                              int Mt, void* stream) {
  const size_t total = (size_t)C * Mx * Mt;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 65535 ? (want > 0 ? want : 1) : 65535);
  mlmc::gff_nbsum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      phi, out, C, Mx, Mt);
  return (int)cudaGetLastError();
}
