// Fused HMC trajectory + Metropolis test of the 1-D QM actions.
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_hmc.py hmc_trajectory
// (_trajectory_kernel, _force_and_action).  Per chain: kinetic and
// potential energy of (x, p), nt leapfrog steps with half kicks at both
// ends (nt + 1 force evaluations), the new energies, and the accept
// decision dH < 0 or u < exp(-dH); the output path is the trajectory's end
// where accepted, else the input.  Kinds: 0 harmonic, 1 quartic, 2 rotor.
//
// What bounds it on the H100: latency.  A launch reads x and p and writes
// x once (3 M floats per chain); between, each of the nt + 1 force
// evaluations is a few operations per site that need the neighbours'
// positions from the step before, so the trajectory is nt dependent
// kick/drift rounds, and a round's time is its dependent chain and the
// instructions it issues.
//
// The design (the warp branch, M up to 128 sites): a chain on one
// warp, or on an aligned power-of-two share of one when M < 32, with x and
// p in registers for the whole trajectory.  Lane l holds sites l + G k,
// k < S (G lanes, G S = next_pow2(M), S a template parameter: qm.cuh
// StridedRing), so a round is one register pass (the kick, then the
// drift) whose neighbours come by shuffles from lanes fixed once a launch,
// with no shared memory and no barrier.  The four energies are a tree
// over a lane's slots and a shuffle butterfly, which add in the order of
// the block branch's tree (thread t = site t) and leave the same bits in
// every lane, so every lane takes the same accept decision and the kernel
// keeps the block branch's bits.  The kind is a template parameter too.
// Up to S = 4 no kind spills (ptxas, sm_90a); at S = 8 the rotor kind
// does, and at S = 16 the quartic one.
//
// Longer paths take the block branch: one thread per site on a
// power-of-two group of up to 1024 threads (several sites a thread
// beyond), x and p in the chain's slice of shared memory, each kick and
// drift a pass followed by a group barrier, the sums in the shared-memory
// tree (rng.cuh chain_sum).  Both read the step size from device memory,
// so a sampler whose dt lives on the card launches without a host sync.

#include <cuda_runtime.h>

#include "qm.cuh"

namespace mlmc {

constexpr int HMC_WARP_THREADS = 128;

struct HmcArgs {
  int C, M, nt, kind;
  Quartic q;    // harmonic and quartic constants (rotor: kf = I/a)
  float k_act;  // prefactor of the summed action density
  int tpc, cpb;
};

__device__ __forceinline__ float hmc_force(int kind, const Quartic& q,
                                          float x, float xm, float xp) {
  if (kind == 0) return q.kf * (q.c * x - xm - xp);
  if (kind == 1) return q.force(x, xm, xp);
  return q.kf * (sinf(x - xm) + sinf(x - xp));
}

__device__ __forceinline__ float hmc_density(int kind, const Quartic& q,
                                            float x, float xm) {
  if (kind == 0) {
    const float dx = x - xm;
    return dx * dx / q.a2 + q.mu2 * x * x;
  }
  if (kind == 1) return q.density(x, xm);
  return 1.0f - cosf(x - xm);
}

// ---- the block branch ------------------------------------------------------

// S of the chain's path x (every thread of the group gets it)
__device__ __forceinline__ float hmc_action(const HmcArgs& a, const float* x,
                                           float* red, int lt) {
  float v = 0.0f;
  for (int m = lt; m < a.M; m += a.tpc) {
    v += hmc_density(a.kind, a.q, x[m], x[m == 0 ? a.M - 1 : m - 1]);
  }
  return a.k_act * group_sum(v, red, a.tpc);
}

// p -= h F(x) on the chain's sites
__device__ __forceinline__ void hmc_kick(const HmcArgs& a, const float* x,
                                         float* p, float h, int lt) {
  for (int m = lt; m < a.M; m += a.tpc) {
    const float xm = x[m == 0 ? a.M - 1 : m - 1];
    const float xp = x[m == a.M - 1 ? 0 : m + 1];
    p[m] = p[m] - h * hmc_force(a.kind, a.q, x[m], xm, xp);
  }
}

__global__ void hmc_trajectory_block(const float* __restrict__ x_in,
                                     const float* __restrict__ p_in,
                                     const float* __restrict__ u_in,
                                     const float* __restrict__ dt_in,
                                     float* __restrict__ x_out,
                                     bool* __restrict__ acc_out, HmcArgs a) {
  extern __shared__ float smem[];
  const int M = a.M;
  const int lc = threadIdx.x / a.tpc;
  const int lt = threadIdx.x - lc * a.tpc;
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < a.C;
  float* x = smem + (size_t)lc * 2 * M;
  float* p = x + M;
  float* red = smem + (size_t)a.cpb * 2 * M;

  const float* xsrc = x_in + (size_t)chain * M;
  const float* psrc = p_in + (size_t)chain * M;
  for (int m = lt; m < M; m += a.tpc) {
    x[m] = valid ? xsrc[m] : 0.0f;
    p[m] = valid ? psrc[m] : 0.0f;
  }
  group_sync(a.tpc);
  const float dt = dt_in[0];
  const float hdt = 0.5f * dt;

  float pp = 0.0f;
  for (int m = lt; m < M; m += a.tpc) pp += p[m] * p[m];
  const float T_cur = 0.5f * group_sum(pp, red, a.tpc);
  const float S_cur = hmc_action(a, x, red, lt);

  hmc_kick(a, x, p, hdt, lt);
  group_sync(a.tpc);
  for (int m = lt; m < M; m += a.tpc) x[m] = x[m] + dt * p[m];
  group_sync(a.tpc);
  for (int k = 0; k < a.nt - 1; ++k) {
    hmc_kick(a, x, p, dt, lt);
    group_sync(a.tpc);
    for (int m = lt; m < M; m += a.tpc) x[m] = x[m] + dt * p[m];
    group_sync(a.tpc);
  }
  hmc_kick(a, x, p, hdt, lt);
  group_sync(a.tpc);

  pp = 0.0f;
  for (int m = lt; m < M; m += a.tpc) pp += p[m] * p[m];
  const float T_new = 0.5f * group_sum(pp, red, a.tpc);
  const float S_new = hmc_action(a, x, red, lt);
  const float dH = (S_new - S_cur) + (T_new - T_cur);
  const float u = valid ? u_in[chain] : 1.0f;
  const bool accept = dH < 0.0f || u < expf(-dH);

  if (valid) {
    float* dst = x_out + (size_t)chain * M;
    for (int m = lt; m < M; m += a.tpc) dst[m] = accept ? x[m] : xsrc[m];
    if (lt == 0) acc_out[chain] = accept;
  }
}

// ---- the warp branch -------------------------------------------------------

template <int K, int S>
__device__ __forceinline__ float warp_action(const HmcArgs& a,
                                            const StridedRing<S>& r,
                                            const float (&x)[S]) {
  float xm[S], xp[S], t[S];
  r.neighbours(x, xm, xp);
#pragma unroll
  for (int k = 0; k < S; ++k) t[k] = hmc_density(K, a.q, x[k], xm[k]);
  return a.k_act * r.total(t);
}

template <int K, int S>
__device__ __forceinline__ void warp_kick(const HmcArgs& a,
                                          const StridedRing<S>& r,
                                          const float (&x)[S], float (&p)[S],
                                          float h) {
  ring_kick(r, x, p, h, [&](float xj, float xm, float xp) {
    return hmc_force(K, a.q, xj, xm, xp);
  });
}

// a.tpc is the chain's lanes G here
template <int K, int S>
__global__ void __launch_bounds__(HMC_WARP_THREADS)
    hmc_trajectory_warp(const float* __restrict__ x_in,
                        const float* __restrict__ p_in,
                        const float* __restrict__ u_in,
                        const float* __restrict__ dt_in,
                        float* __restrict__ x_out, bool* __restrict__ acc_out,
                        HmcArgs a) {
  const int M = a.M;
  const int G = a.tpc;
  const int lc = threadIdx.x / G;
  const int lt = threadIdx.x & (G - 1);
  const int chain = blockIdx.x * (blockDim.x / G) + lc;
  const bool valid = chain < a.C;
  const StridedRing<S> r(G, lt, M);
  const float* xsrc = x_in + (size_t)chain * M;
  const float* psrc = p_in + (size_t)chain * M;

  float x[S], p[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const bool real = valid && r.real(k);
    x[k] = real ? xsrc[lt + G * k] : 0.0f;
    p[k] = real ? psrc[lt + G * k] : 0.0f;
  }
  const float dt = dt_in[0];
  const float hdt = 0.5f * dt;

  const float T_cur = 0.5f * r.sum_sq(p);
  const float S_cur = warp_action<K>(a, r, x);

  warp_kick<K>(a, r, x, p, hdt);
  drift(x, p, dt);
  for (int k = 0; k < a.nt - 1; ++k) {
    warp_kick<K>(a, r, x, p, dt);
    drift(x, p, dt);
  }
  warp_kick<K>(a, r, x, p, hdt);

  const float T_new = 0.5f * r.sum_sq(p);
  const float S_new = warp_action<K>(a, r, x);
  const float dH = (S_new - S_cur) + (T_new - T_cur);
  const float u = valid ? u_in[chain] : 1.0f;
  const bool accept = dH < 0.0f || u < expf(-dH);

  if (valid) {
    float* dst = x_out + (size_t)chain * M;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (r.real(k)) {
        const int m = lt + G * k;
        dst[m] = accept ? x[k] : xsrc[m];
      }
    }
    if (lt == 0) acc_out[chain] = accept;
  }
}

template <int K>
static const void* warp_kernel_of_kind(int sites) {
  switch (sites) {
    case 1: return (const void*)hmc_trajectory_warp<K, 1>;
    case 2: return (const void*)hmc_trajectory_warp<K, 2>;
    case 4: return (const void*)hmc_trajectory_warp<K, 4>;
    default: return nullptr;
  }
}

// the kernel of a launch: the warp branch's for `sites` sites a lane (1, 2
// or 4), the block branch's for sites = 0; null otherwise
static const void* kernel_for(int kind, int sites) {
  if (sites == 0) return (const void*)hmc_trajectory_block;
  if (kind == 0) return warp_kernel_of_kind<0>(sites);
  if (kind == 1) return warp_kernel_of_kind<1>(sites);
  if (kind == 2) return warp_kernel_of_kind<2>(sites);
  return nullptr;
}

}  // namespace mlmc

// x/p/x_out: [C, M] f32 (x_out may not alias x); u: [C]; dt: one f32 in
// device memory; acc: [C] bool.  kind 0 harmonic, 1 quartic, 2 rotor; the
// constants are folded on the host (ops/hmc.py).  The warp branch (sites
// > 0): lanes per chain (a power of two <= 32) with `sites` sites a lane
// (1, 2 or 4; lanes * sites = next_pow2(M)), cpb chains a block, no
// shared memory.
// The block branch (sites = 0): lanes = threads per chain (a power of
// two), cpb chains per block, smem bytes of dynamic shared memory.
extern "C" int mlmc_hmc_trajectory(const float* x, const float* p,
                                   const float* u, const float* dt,
                                   float* x_out, bool* acc, int C, int M,
                                   int nt, int kind, float kf, float c,
                                   float al, float x0, float a2, float mu2,
                                   float m0, float hl, float k_act, int lanes,
                                   int cpb, int sites, size_t smem,
                                   void* stream) {
  mlmc::HmcArgs a{C, M, nt, kind, {kf, c, al, x0, a2, mu2, m0, hl},
                  k_act, lanes, cpb};
  const void* kernel = mlmc::kernel_for(kind, sites);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  void* args[] = {&x, &p, &u, &dt, &x_out, &acc, &a};
  cudaError_t e = cudaLaunchKernel(kernel, dim3((C + cpb - 1) / cpb),
                                   dim3(lanes * cpb), args, smem,
                                   (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Registers a thread, local (spilled) bytes a thread and resident blocks
// an SM of the launch's kernel (kind, sites as above) at `threads` a
// block with smem bytes of dynamic shared memory: out[0..2].
extern "C" int mlmc_hmc_trajectory_attrs(int threads, int kind, int sites,
                                         size_t smem, int* out) {
  const void* kernel = mlmc::kernel_for(kind, sites);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess && smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      threads, smem);
  }
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)e;
}
