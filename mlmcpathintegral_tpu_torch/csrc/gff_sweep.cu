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
// What bounds it on the H100: instruction issue, above all the integer
// pipe.  A chain's field (Mx*Mt floats, 1 KB at 16x16) is read once and
// written once per launch; between, each half-sweep is a 4-point stencil
// from shared memory and, in the heat bath, one Box-Muller normal per site
// (five fmix32, a precise log, square root and cosine, and a division),
// which is most of the instructions, the hashes' shifts and xors on the
// half-rate integer pipe.  So the design keeps every lane busy with sites
// it updates and keeps work that does not change out of the loops:
//   - A half-sweep walks only the n/2 sites of its colour: k = lt, lt +
//     lanes, .. (lt the thread's lane in its chain's group of `lanes`),
//     row j = k / (Mt/2), column i = 2 (k mod Mt/2) + ((j + c) & 1).
//     The row and column are stepped by increments fixed once a launch,
//     with no division a site, and the neighbours are offsets from the
//     site.
//   - The chain's hash (base_c) is taken once a launch and the chain word
//     of each of a half-sweep's two counters once a half-sweep (both are
//     the same in every lane of the chain); a site's hash once a
//     heat-bath sweep (once a launch at path E's one sweep).  A word is
//     then split_bits: two fmix32.
// The field lives in shared memory (one global round trip per launch, as
// the Pallas kernel keeps it in VMEM).  Three branches, a template
// parameter each (so the field's loads are shared-memory loads where it
// is there); ops/gff.py sweep_launch picks them by the field's size and
// the chain count:
//   - warp: a chain on one warp, four chains a block, each in its warp's
//     slice of shared memory; a __syncwarp separates the half-sweeps, so
//     there is no block barrier and a 16x16 launch of 4096 chains is one
//     wave of ~31 warps an SM.  Fields up to 48x48 sites and from 2048
//     chains, where it was measured faster than the block design.
//   - block: a chain on a block of min(1024, next_pow2(n/2)) threads,
//     half-sweeps separated by block barriers: larger fields, or fewer
//     chains, which a warp a chain would leave most of the card idle for.
//   - global: a field beyond the shared memory one block may opt in to
//     (from 256x256, 256 KB per chain) is updated in place in the output
//     tensor instead, as the block design with the same walk and barriers.
// Every per-site expression and its order are those of the Pallas
// kernel's source arithmetic, so every branch gives the same bits.  The
// in-place update within a colour needs even Mt and Mx (every neighbour
// of a site has the other colour); the wrapper refuses odd sizes.
//
// P1 (gff_nbsum_kernel): a memory-bound stencil.  A 2-D grid, chains on
// blockIdx.y, groups of rows on blockIdx.x; each thread writes V
// consecutive sites of one row (V = 4, 16-byte loads and stores, where
// Mt % 4 == 0 and the pointers allow, else V = 1), with 32-bit indices.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rng.cuh"

namespace mlmc {

struct GffArgs {
  int C, Mx, Mt, n_overrelax, n_heatbath;
  float kappa, sigma;
  uint32_t seed1, seed2;
  uint32_t chain0;  // global index of the launch's first chain
};

// the kernel's branches (ops/gff.py sweep_launch)
constexpr int BR_WARP = 0, BR_BLOCK = 1, BR_GLOBAL = 2;

// 4-point periodic neighbour sum of site s = j Mt + i on a [Mx][Mt]
// plane, in the Pallas kernel's order ((j-1) + (j+1)) + (i-1)) + (i+1),
// each neighbour an offset from s
__device__ __forceinline__ float gff_nb(const float* P, int s, int j, int i,
                                        int Mx, int Mt) {
  const float* p = P + s;
  const int up = j == 0 ? (Mx - 1) * Mt : -Mt;
  const int dn = j == Mx - 1 ? -(Mx - 1) * Mt : Mt;
  const int lf = i == 0 ? Mt - 1 : -1;
  const int rt = i == Mt - 1 ? 1 - Mt : 1;
  return ((p[up] + p[dn]) + p[lf]) + p[rt];
}

// n floats (n % 4 == 0) from src to dst by the `lanes` threads of a group,
// 16 bytes a load where both pointers allow
__device__ __forceinline__ void copy_field(const float* src, float* dst,
                                           int n, int lt, int lanes) {
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int q = lt; q < n / 4; q += lanes) d4[q] = s4[q];
  } else {
    for (int s = lt; s < n; s += lanes) dst[s] = src[s];
  }
}

// The sites of one colour that lane lt of a group of `lanes` updates:
// k = lt, lt + lanes, .. < n/2, as (row j, half-column m) with k = j half
// + m, half = Mt/2 (so k < n/2 while j < Mx); colour c's column is
// i = 2m + ((j + c) & 1).  The start and the step are fixed once a
// launch; a step adds them and carries m into j.
struct ColourWalk {
  int j0, m0, dj, dm, half;

  __device__ __forceinline__ ColourWalk(int lt, int lanes, int Mt)
      : half(Mt >> 1) {
    j0 = lt / half;
    m0 = lt - j0 * half;
    dj = lanes / half;
    dm = lanes - dj * half;
  }

  __device__ __forceinline__ void step(int& j, int& m) const {
    m += dm;
    j += dj;
    if (m >= half) {
      m -= half;
      ++j;
    }
  }
};

template <bool WARP>
__device__ __forceinline__ void group_sync() {
  if (WARP) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// BR_WARP: a chain on each warp of the block; else a chain on the block.
// The branch is a template parameter so that the field's address space is
// known where it is read (shared-memory loads with 32-bit addresses in the
// first two).
template <int BR>
__global__ void gff_sweep_kernel(const float* __restrict__ phi_in,
                                 float* phi_out, GffArgs a) {
  constexpr bool WARP = BR == BR_WARP;
  extern __shared__ __align__(16) float smem[];
  const int n = a.Mx * a.Mt;
  const int lanes = WARP ? 32 : blockDim.x;
  const int g = WARP ? threadIdx.x >> 5 : 0;
  const int lt = WARP ? threadIdx.x & 31 : threadIdx.x;
  const int chain = WARP ? blockIdx.x * (blockDim.x >> 5) + g : blockIdx.x;
  if (WARP && chain >= a.C) return;  // a whole warp: no barrier waits on it
  float* dst = phi_out + (size_t)chain * n;
  float* P = BR == BR_GLOBAL ? dst : smem + g * n;

  copy_field(phi_in + (size_t)chain * n, P, n, lt, lanes);
  group_sync<WARP>();

  const ColourWalk w(lt, lanes, a.Mt);
  for (int o = 0; o < a.n_overrelax; ++o) {
    for (int colour = 0; colour < 2; ++colour) {
      for (int j = w.j0, m = w.m0; j < a.Mx; w.step(j, m)) {
        const int i = 2 * m + ((j + colour) & 1);
        const int s = j * a.Mt + i;
        const float nb = gff_nb(P, s, j, i, a.Mx, a.Mt);
        P[s] = 2.0f * nb / a.kappa - P[s];
      }
      group_sync<WARP>();
    }
  }
  if (a.n_heatbath > 0) {
    const uint32_t base_c = chain_base(a.seed2, a.chain0 + (uint32_t)chain);
    for (int h = 0; h < a.n_heatbath; ++h) {
      for (int colour = 0; colour < 2; ++colour) {
        const uint32_t ctr = (uint32_t)(4 * h + 2 * colour + 1);
        const uint32_t cw1 = base_word(base_c, ctr);
        const uint32_t cw2 = base_word(base_c, ctr + 1);
        for (int j = w.j0, m = w.m0; j < a.Mx; w.step(j, m)) {
          const int i = 2 * m + ((j + colour) & 1);
          const int s = j * a.Mt + i;
          const float nb = gff_nb(P, s, j, i, a.Mx, a.Mt);
          const uint32_t hs = site_hash(a.seed1, (uint32_t)s);
          const float z = box_muller(bits_uniform(split_bits(hs, cw1, ctr)),
                                     bits_uniform(split_bits(hs, cw2,
                                                             ctr + 1)));
          P[s] = nb / a.kappa + a.sigma * z;
        }
        group_sync<WARP>();
      }
    }
  }

  if (BR != BR_GLOBAL) copy_field(P, dst, n, lt, lanes);
}

// P1: out[c, l] = the neighbour sum of site l of chain c.  Thread t of a
// block takes row blockIdx.x rpb + t / tpr (rpb = blockDim.x / tpr rows a
// block) at sites V (t mod tpr) + V tpr q .. + V - 1, of chains
// blockIdx.y, + gridDim.y, ..
template <int V>
__global__ void gff_nbsum_kernel(const float* __restrict__ phi,
                                 float* __restrict__ out, int C, int Mx,
                                 int Mt, int tpr) {
  const int j = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  if (j >= Mx) return;
  const int n = Mx * Mt;
  const int r = j * Mt;
  const int rm = (j == 0 ? Mx - 1 : j - 1) * Mt;
  const int rp = (j == Mx - 1 ? 0 : j + 1) * Mt;
  for (int c = blockIdx.y; c < C; c += gridDim.y) {
    const float* P = phi + (size_t)c * n;
    float* O = out + (size_t)c * n;
    for (int i0 = V * (threadIdx.x % tpr); i0 < Mt; i0 += V * tpr) {
      const int im = i0 == 0 ? Mt - 1 : i0 - 1;    // left of the first site
      const int ip = i0 + V == Mt ? 0 : i0 + V;    // right of the last
      if (V == 4) {
        const float4 a = *reinterpret_cast<const float4*>(P + rm + i0);
        const float4 b = *reinterpret_cast<const float4*>(P + rp + i0);
        const float4 x = *reinterpret_cast<const float4*>(P + r + i0);
        const float left = P[r + im];
        const float right = P[r + ip];
        float4 o;
        o.x = ((a.x + b.x) + left) + x.y;
        o.y = ((a.y + b.y) + x.x) + x.z;
        o.z = ((a.z + b.z) + x.y) + x.w;
        o.w = ((a.w + b.w) + x.z) + right;
        *reinterpret_cast<float4*>(O + r + i0) = o;
      } else {
        O[r + i0] = ((P[rm + i0] + P[rp + i0]) + P[r + im]) + P[r + ip];
      }
    }
  }
}

}  // namespace mlmc

namespace mlmc {

static const void* sweep_kernel_for(int branch) {
  if (branch == BR_WARP) return (const void*)gff_sweep_kernel<BR_WARP>;
  if (branch == BR_BLOCK) return (const void*)gff_sweep_kernel<BR_BLOCK>;
  if (branch == BR_GLOBAL) return (const void*)gff_sweep_kernel<BR_GLOBAL>;
  return nullptr;
}

}  // namespace mlmc

// phi_in/phi_out: [C, Mx*Mt] f32 (may not alias).  branch 0 (warp): a
// chain a warp, cpb warps a block, lanes = 32; 1 (block): a chain on a
// block of `lanes` threads (cpb = 1); 2 (global): as 1 with the fields
// updated in place in phi_out (smem = 0).  smem: dynamic shared bytes.
// chain0: the global index of the launch's chain 0, which the chain hash
// takes.
extern "C" int mlmc_gff_sweep(const float* phi_in, float* phi_out, int C,
                              int Mx, int Mt, int n_overrelax,
                              int n_heatbath, float kappa, float sigma,
                              uint32_t seed1, uint32_t seed2,
                              uint32_t chain0, int lanes, int cpb,
                              int branch, size_t smem, void* stream) {
  mlmc::GffArgs a{C,     Mx,    Mt,    n_overrelax, n_heatbath,
                  kappa, sigma, seed1, seed2,       chain0};
  const void* fn = mlmc::sweep_kernel_for(branch);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = branch == mlmc::BR_WARP ? 32 * cpb : lanes;
  void* args[] = {&phi_in, &phi_out, &a};
  cudaError_t e = cudaLaunchKernel(fn, dim3((C + cpb - 1) / cpb),
                                   dim3(threads), args, smem,
                                   (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Registers a thread, local bytes a thread and resident blocks an SM of
// the sweep kernel's branch at this launch's threads and shared bytes:
// out[0..2].
extern "C" int mlmc_gff_sweep_attrs(int threads, size_t smem, int branch,
                                    int* out) {
  const void* fn = mlmc::sweep_kernel_for(branch);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, fn);
  if (e == cudaSuccess && smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn, threads,
                                                      smem);
  }
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)e;
}

// phi/out: [C, Mx*Mt] f32.  V sites a thread (4: 16-byte loads and
// stores, for Mt % 4 == 0 and 16-byte aligned pointers; else 1), tpr
// threads a row, rpb rows a block, a gx x gy grid (ops/gff.py
// nbsum_launch).
extern "C" int mlmc_gff_nbsum(const float* phi, float* out, int C, int Mx,
                              int Mt, int V, int tpr, int rpb, int gx,
                              int gy, void* stream) {
  const dim3 grid(gx, gy);
  cudaStream_t st = (cudaStream_t)stream;
  if (V == 4) {
    mlmc::gff_nbsum_kernel<4><<<grid, rpb * tpr, 0, st>>>(phi, out, C, Mx,
                                                          Mt, tpr);
  } else {
    mlmc::gff_nbsum_kernel<1><<<grid, rpb * tpr, 0, st>>>(phi, out, C, Mx,
                                                          Mt, tpr);
  }
  return (int)cudaGetLastError();
}
