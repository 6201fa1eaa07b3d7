// Fused QM two-level Metropolis chain: coarse HMC + Gaussian fill + screen.
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_qm_twolevel.py
// qm_twolevel_chain (_qm_twolevel_kernel, _coarse_force, _coarse_action,
// _fine_action, _w_min_curv).  Per step s of n_steps:
//   t_sub coarse HMC trajectories at spacing 2a (momenta from the counter
//   RNG, CounterRng(site j, chain, step = s (t_sub + 1) + t) words 1-2;
//   accept uniform word 3 of site 0), optionally recording per trajectory
//   the coarse QoI mean(x^2) and the coarse action after the test;
//   the trial: even sites = the coarse path, odd site j from
//   N(Wminimum, 1/Wcurvature) of its even neighbours at spacing a (the
//   quartic fixed point, curvature at xbar), with the normal of words 1-2
//   at step s (t_sub + 1) + t_sub;
//   the three-term screen dS = (S_f' - S_f) + (S_c(xe) - S_c(xc)) +
//   (S_q - S_q') accepted on word 3 of site 0; then the fine and coarse
//   QoIs and the accept bit of the step.
// The fine path is kept as its even and odd planes [Mc] each.
//
// What bounds it on the H100: latency.  A launch reads and writes the
// chain's planes and coarse path once (3 Mc floats) and writes a few
// floats per step; between, each step runs t_sub * nt dependent leapfrog
// rounds.  The design keeps the planes, the coarse path, the trajectory and
// its momenta in shared memory for the whole launch, one thread per coarse
// site and one power-of-two thread group per chain: at Mc <= 32 the group
// is inside one warp, so its barriers are warp barriers and its sums
// shuffles (qm.cuh).  Every thread hashes site 0's accept word itself.

#include <cuda_runtime.h>

#include "qm.cuh"

namespace mlmc {

struct QmTwolevelArgs {
  int C, Mc, nt, n_steps, t_sub, with_traces;
  Quartic coarse;  // at spacing 2a
  float kac;       // coarse action prefactor (2a)/2
  // fine action at spacing a: kaf = a/2, a2f = a^2
  float kaf, a2f;
  // single-site conditioned action at spacing a: rho = 1/(1 + a^2 mu2/2),
  // ccw = a^2 lam/(2 m0), kcurv = (2/a + a mu2) m0, k3 = 3 lam a
  float rho, ccw, kcurv, k3;
  float inv_M, inv_Mc;
  uint32_t seed1, seed2;
  int tpc, cpb;
};

// S_c of the chain's coarse path x at spacing 2a
__device__ __forceinline__ float coarse_action(const QmTwolevelArgs& a,
                                               const float* x, float* red,
                                               int lt) {
  float v = 0.0f;
  for (int j = lt; j < a.Mc; j += a.tpc) {
    v += a.coarse.density(x[j], x[j == 0 ? a.Mc - 1 : j - 1]);
  }
  return a.kac * group_sum(v, red, a.tpc);
}

__device__ __forceinline__ void coarse_kick(const QmTwolevelArgs& a,
                                            const float* x, float* p,
                                            float h, int lt) {
  for (int j = lt; j < a.Mc; j += a.tpc) {
    const float xm = x[j == 0 ? a.Mc - 1 : j - 1];
    const float xp = x[j == a.Mc - 1 ? 0 : j + 1];
    p[j] = p[j] - h * a.coarse.force(x[j], xm, xp);
  }
}

__device__ __forceinline__ float sum_sq(const float* x, float* red, int n,
                                        int lt, int tpc) {
  float v = 0.0f;
  for (int j = lt; j < n; j += tpc) v += x[j] * x[j];
  return group_sum(v, red, tpc);
}

__global__ void qm_twolevel_kernel(
    const float* __restrict__ fine_in, const float* __restrict__ xc_in,
    const float* __restrict__ sc_in, const float* __restrict__ dt_in,
    float* __restrict__ fine_out, float* __restrict__ xc_out,
    float* __restrict__ sc_out, float* __restrict__ qf_out,
    float* __restrict__ qc_out, float* __restrict__ cs_out,
    float* __restrict__ ec_out, float* __restrict__ acc_out,
    QmTwolevelArgs a) {
  extern __shared__ float smem[];
  const int Mc = a.Mc;
  const int C = a.C;
  const int lc = threadIdx.x / a.tpc;
  const int lt = threadIdx.x - lc * a.tpc;
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < C;
  const uint32_t ch = (uint32_t)chain;
  float* xe = smem + (size_t)lc * 5 * Mc;  // fine even plane
  float* xo = xe + Mc;                     // fine odd plane
  float* xc = xo + Mc;                     // coarse chain
  float* xt = xc + Mc;                     // trajectory position
  float* p = xt + Mc;                      // momenta, then the odd trial
  float* red = smem + (size_t)a.cpb * 5 * Mc;

  for (int j = lt; j < Mc; j += a.tpc) {
    const size_t o = (size_t)chain * Mc + j;
    xe[j] = valid ? fine_in[o] : 0.0f;
    xo[j] = valid ? fine_in[(size_t)C * Mc + o] : 0.0f;
    xc[j] = valid ? xc_in[o] : 0.0f;
  }
  float S_f = valid ? sc_in[chain] : 0.0f;
  float S_q = valid ? sc_in[C + chain] : 0.0f;
  const float dt = dt_in[0];
  const float hdt = 0.5f * dt;
  group_sync(a.tpc);

  for (int s = 0; s < a.n_steps; ++s) {
    const int base = s * (a.t_sub + 1);
    // ---- t_sub coarse HMC trajectories ----
    for (int t = 0; t < a.t_sub; ++t) {
      const uint32_t step = (uint32_t)(base + t);
      for (int j = lt; j < Mc; j += a.tpc) {
        const CounterRng rng(a.seed1, a.seed2, (uint32_t)j, ch, step);
        p[j] = rng.normal(1u);
        xt[j] = xc[j];
      }
      group_sync(a.tpc);
      const float T_cur = 0.5f * sum_sq(p, red, Mc, lt, a.tpc);
      const float S_cur = coarse_action(a, xc, red, lt);
      coarse_kick(a, xt, p, hdt, lt);
      group_sync(a.tpc);
      for (int j = lt; j < Mc; j += a.tpc) xt[j] = xt[j] + dt * p[j];
      group_sync(a.tpc);
      for (int k = 0; k < a.nt - 1; ++k) {
        coarse_kick(a, xt, p, dt, lt);
        group_sync(a.tpc);
        for (int j = lt; j < Mc; j += a.tpc) xt[j] = xt[j] + dt * p[j];
        group_sync(a.tpc);
      }
      coarse_kick(a, xt, p, hdt, lt);
      group_sync(a.tpc);
      const float S_new = coarse_action(a, xt, red, lt);
      const float dH =
          (S_new - S_cur) + (0.5f * sum_sq(p, red, Mc, lt, a.tpc) - T_cur);
      const CounterRng rng0(a.seed1, a.seed2, 0u, ch, step);
      const bool accept = dH < 0.0f || rng0.uniform(3u) < expf(-dH);
      if (accept) {
        for (int j = lt; j < Mc; j += a.tpc) xc[j] = xt[j];
      }
      group_sync(a.tpc);
      if (a.with_traces) {
        const float cs = a.inv_Mc * sum_sq(xc, red, Mc, lt, a.tpc);
        if (valid && lt == 0) {
          const size_t row = (size_t)(s * a.t_sub + t) * C + chain;
          cs_out[row] = cs;
          ec_out[row] = accept ? S_new : S_cur;
        }
      }
    }

    // ---- trial: prolongate + Gaussian conditional fill ----
    const uint32_t fstep = (uint32_t)(base + a.t_sub);
    float sq = 0.0f;
    for (int j = lt; j < Mc; j += a.tpc) {
      const float xbar = 0.5f * (xc[j] + xc[j == Mc - 1 ? 0 : j + 1]);
      float w = xbar;
      for (int it = 0; it < 4; ++it) {
        const float xs = w - a.coarse.x0;
        w = a.rho * (xbar - a.ccw * xs * xs * xs);
      }
      const float xs = xbar - a.coarse.x0;
      const float curv = a.kcurv + a.k3 * xs * xs;
      const CounterRng rng(a.seed1, a.seed2, (uint32_t)j, ch, fstep);
      const float xo_t = w + rng.normal(1u) * rsqrtf(curv);
      p[j] = xo_t;
      const float d = xo_t - w;
      sq += 0.5f * curv * d * d - 0.5f * logf(curv);
    }
    group_sync(a.tpc);
    const float S_q_trial = group_sum(sq, red, a.tpc);
    // fine action of (xc, xo_t): site 2j has neighbours (xo_{j-1}, xo_j)
    float sf = 0.0f;
    for (int j = lt; j < Mc; j += a.tpc) {
      const float e = xc[j];
      const float o = p[j];
      const float d1 = o - e;
      const float d2 = p[j == 0 ? Mc - 1 : j - 1] - e;
      const float qe0 = e - a.coarse.x0;
      const float qo0 = o - a.coarse.x0;
      const float qe = qe0 * qe0;
      const float qo = qo0 * qo0;
      sf += a.coarse.m0 * ((d1 * d1 + d2 * d2) / a.a2f +
                           a.coarse.mu2 * (e * e + o * o)) +
            a.coarse.hl * (qe * qe + qo * qo);
    }
    const float S_f_trial = a.kaf * group_sum(sf, red, a.tpc);

    // ---- three-term dS ----
    const float dS_coarse =
        coarse_action(a, xe, red, lt) - coarse_action(a, xc, red, lt);
    const float dS = (S_f_trial - S_f) + dS_coarse + (S_q - S_q_trial);
    const CounterRng rng0(a.seed1, a.seed2, 0u, ch, fstep);
    const bool accept = dS < 0.0f || rng0.uniform(3u) < expf(-dS);
    if (accept) {
      for (int j = lt; j < Mc; j += a.tpc) {
        xe[j] = xc[j];
        xo[j] = p[j];
      }
      S_f = S_f_trial;
      S_q = S_q_trial;
    }
    group_sync(a.tpc);

    // ---- QoI traces ----
    const float se = sum_sq(xe, red, Mc, lt, a.tpc);
    const float so = sum_sq(xo, red, Mc, lt, a.tpc);
    const float qc = a.inv_Mc * sum_sq(xc, red, Mc, lt, a.tpc);
    if (valid && lt == 0) {
      const size_t row = (size_t)s * C + chain;
      qf_out[row] = a.inv_M * (se + so);
      qc_out[row] = qc;
      acc_out[row] = accept ? 1.0f : 0.0f;
    }
  }

  if (valid) {
    for (int j = lt; j < Mc; j += a.tpc) {
      const size_t o = (size_t)chain * Mc + j;
      fine_out[o] = xe[j];
      fine_out[(size_t)C * Mc + o] = xo[j];
      xc_out[o] = xc[j];
    }
    if (lt == 0) {
      sc_out[chain] = S_f;
      sc_out[C + chain] = S_q;
      if (!a.with_traces) {
        cs_out[chain] = 0.0f;
        ec_out[chain] = 0.0f;
      }
    }
  }
}

}  // namespace mlmc

// fine_in/fine_out: [2, C, Mc] f32 even/odd planes; xc_in/xc_out: [C, Mc];
// sc_in/sc_out: [2, C] (S_fine, S_cond); dt: one f32 in device memory;
// qf/qc/acc: [n_steps, C]; cs/ec: [n_steps * t_sub, C] with traces, else
// [1, C] (written as zeros).  Outputs may not alias inputs.  The constants
// are folded on the host (ops/qm_twolevel.py).  tpc threads per chain (a
// power of two), cpb chains per block, smem bytes of dynamic shared memory.
extern "C" int mlmc_qm_twolevel(
    const float* fine_in, const float* xc_in, const float* sc_in,
    const float* dt, float* fine_out, float* xc_out, float* sc_out,
    float* qf, float* qc, float* cs, float* ec, float* acc, int C, int Mc,
    int nt, int n_steps, int t_sub, int with_traces, float kf_c, float c_c,
    float al_c, float x0, float a2_c, float mu2, float m0, float hl,
    float kac, float kaf, float a2f, float rho, float ccw, float kcurv,
    float k3, float inv_M, float inv_Mc, uint32_t seed1, uint32_t seed2,
    int tpc, int cpb, size_t smem, void* stream) {
  mlmc::QmTwolevelArgs a{C,
                         Mc,
                         nt,
                         n_steps,
                         t_sub,
                         with_traces,
                         {kf_c, c_c, al_c, x0, a2_c, mu2, m0, hl},
                         kac,
                         kaf,
                         a2f,
                         rho,
                         ccw,
                         kcurv,
                         k3,
                         inv_M,
                         inv_Mc,
                         seed1,
                         seed2,
                         tpc,
                         cpb};
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlmc::qm_twolevel_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + cpb - 1) / cpb;
  mlmc::qm_twolevel_kernel<<<blocks, tpc * cpb, smem,
                             (cudaStream_t)stream>>>(
      fine_in, xc_in, sc_in, dt, fine_out, xc_out, sc_out, qf, qc, cs, ec,
      acc, a);
  return (int)cudaGetLastError();
}
