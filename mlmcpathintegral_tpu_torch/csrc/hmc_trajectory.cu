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
// kick/drift rounds.  The design keeps the path and momenta in shared
// memory for the whole trajectory, one thread per site and one
// power-of-two thread group per chain; at M <= 32 a group is inside one
// warp, so its barriers are warp barriers and its two energy sums warp
// shuffles (qm.cuh).  The step size is read from device memory, so a
// sampler whose dt lives on the card launches without a host sync.

#include <cuda_runtime.h>

#include "qm.cuh"

namespace mlmc {

struct HmcArgs {
  int C, M, nt, kind;
  Quartic q;    // harmonic and quartic constants (rotor: kf = I/a)
  float k_act;  // prefactor of the summed action density
  int tpc, cpb;
};

__device__ __forceinline__ float hmc_force(const HmcArgs& a, float x,
                                          float xm, float xp) {
  if (a.kind == 0) return a.q.kf * (a.q.c * x - xm - xp);
  if (a.kind == 1) return a.q.force(x, xm, xp);
  return a.q.kf * (sinf(x - xm) + sinf(x - xp));
}

__device__ __forceinline__ float hmc_density(const HmcArgs& a, float x,
                                            float xm) {
  if (a.kind == 0) {
    const float dx = x - xm;
    return dx * dx / a.q.a2 + a.q.mu2 * x * x;
  }
  if (a.kind == 1) return a.q.density(x, xm);
  return 1.0f - cosf(x - xm);
}

// S of the chain's path x (every thread of the group gets it)
__device__ __forceinline__ float hmc_action(const HmcArgs& a, const float* x,
                                           float* red, int lt) {
  float v = 0.0f;
  for (int m = lt; m < a.M; m += a.tpc) {
    v += hmc_density(a, x[m], x[m == 0 ? a.M - 1 : m - 1]);
  }
  return a.k_act * group_sum(v, red, a.tpc);
}

// p -= h F(x) on the chain's sites
__device__ __forceinline__ void hmc_kick(const HmcArgs& a, const float* x,
                                         float* p, float h, int lt) {
  for (int m = lt; m < a.M; m += a.tpc) {
    const float xm = x[m == 0 ? a.M - 1 : m - 1];
    const float xp = x[m == a.M - 1 ? 0 : m + 1];
    p[m] = p[m] - h * hmc_force(a, x[m], xm, xp);
  }
}

__global__ void hmc_trajectory_kernel(const float* __restrict__ x_in,
                                      const float* __restrict__ p_in,
                                      const float* __restrict__ u_in,
                                      const float* __restrict__ dt_in,
                                      float* __restrict__ x_out,
                                      bool* __restrict__ acc_out,
                                      HmcArgs a) {
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

}  // namespace mlmc

// x/p/x_out: [C, M] f32 (x_out may not alias x); u: [C]; dt: one f32 in
// device memory; acc: [C] bool.  kind 0 harmonic, 1 quartic, 2 rotor; the
// constants are folded on the host (ops/hmc.py).  tpc threads per chain (a
// power of two), cpb chains per block, smem bytes of dynamic shared memory.
extern "C" int mlmc_hmc_trajectory(const float* x, const float* p,
                                   const float* u, const float* dt,
                                   float* x_out, bool* acc, int C, int M,
                                   int nt, int kind, float kf, float c,
                                   float al, float x0, float a2, float mu2,
                                   float m0, float hl, float k_act, int tpc,
                                   int cpb, size_t smem, void* stream) {
  mlmc::HmcArgs a{C, M, nt, kind, {kf, c, al, x0, a2, mu2, m0, hl},
                  k_act, tpc, cpb};
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlmc::hmc_trajectory_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + cpb - 1) / cpb;
  mlmc::hmc_trajectory_kernel<<<blocks, tpc * cpb, smem,
                                (cudaStream_t)stream>>>(x, p, u, dt, x_out,
                                                        acc, a);
  return (int)cudaGetLastError();
}
