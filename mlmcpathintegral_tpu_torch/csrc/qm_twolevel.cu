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
// rounds.  The design puts a chain on one warp (on a power-of-two share of
// one when Mc < 32, several chains a warp) and holds everything in
// registers: lane l keeps sites l S .. l S + S - 1 of the coarse path, the
// trajectory, its momenta and both fine planes, S a template parameter
// (Mc / 32 rounded up to a power of two; qm.cuh Ring).  A leapfrog round
// reads the two neighbours across lane boundaries with one shuffle each
// way and touches no memory; the lanes and wrap of those shuffles are
// fixed once a launch.
// The sums are shuffle butterflies, which leave the same bits in every
// lane, so each lane takes the same accept decisions.  The coarse action
// of the current path is carried from one trajectory's test to the next
// (it equals the recomputed value bit for bit), and site 0's accept word
// is hashed by lane 0 and broadcast.

#include <cuda_runtime.h>

#include "qm.cuh"

namespace mlmc {

constexpr int QM_TWOLEVEL_THREADS_MAX = 128;

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
  uint32_t chain0;  // global index of the launch's first chain
  int lanes;  // lanes per chain: a power of two <= 32
};

template <int S>
__device__ __forceinline__ float coarse_action(const QmTwolevelArgs& a,
                                               const Ring<S>& r,
                                               const float (&x)[S]) {
  float xm[S], xp[S], t[S];
  r.neighbours(x, xm, xp);
#pragma unroll
  for (int k = 0; k < S; ++k) t[k] = a.coarse.density(x[k], xm[k]);
  return a.kac * r.total(t);
}

// normals of words 1-2 of this lane's sites at `step` into out; returns
// site 0's accept uniform (word 3), hashed by the chain's lane 0
template <int S>
__device__ __forceinline__ float draw_momenta(const QmTwolevelArgs& a,
                                              const Ring<S>& r, int lt,
                                              uint32_t cw1, uint32_t cw2,
                                              uint32_t cw3, uint32_t step,
                                              float (&out)[S]) {
  uint32_t b0 = 0u;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint32_t bs =
        step_base(site_hash(a.seed1, (uint32_t)(lt * S + k)), step);
    if (k == 0) b0 = bs;
    out[k] = box_muller(bits_uniform(split_bits(bs, cw1, 1u)),
                        bits_uniform(split_bits(bs, cw2, 2u)));
  }
  float u = 0.0f;
  if (lt == 0) u = bits_uniform(split_bits(b0, cw3, 3u));
  return __shfl_sync(0xffffffffu, u, 0, r.G);
}

template <int S>
__device__ __forceinline__ void coarse_kick(const QmTwolevelArgs& a,
                                            const Ring<S>& r,
                                            const float (&x)[S],
                                            float (&p)[S], float h) {
  ring_kick(r, x, p, h, [&](float xj, float xm, float xp) {
    return a.coarse.force(xj, xm, xp);
  });
}

template <int S>
__global__ void __launch_bounds__(QM_TWOLEVEL_THREADS_MAX)
    qm_twolevel_kernel(const float* __restrict__ fine_in,
                       const float* __restrict__ xc_in,
                       const float* __restrict__ sc_in,
                       const float* __restrict__ dt_in,
                       float* __restrict__ fine_out,
                       float* __restrict__ xc_out,
                       float* __restrict__ sc_out, float* __restrict__ qf_out,
                       float* __restrict__ qc_out, float* __restrict__ cs_out,
                       float* __restrict__ ec_out,
                       float* __restrict__ acc_out, QmTwolevelArgs a) {
  const int Mc = a.Mc;
  const int C = a.C;
  const int G = a.lanes;
  const int lc = threadIdx.x / G;
  const int lt = threadIdx.x & (G - 1);
  const int chain = blockIdx.x * (blockDim.x / G) + lc;
  const bool valid = chain < C;
  const uint32_t ch = a.chain0 + (uint32_t)chain;
  const int L = (Mc + S - 1) / S;  // lanes holding sites
  Ring<S> r;
  r.n = max(0, min(S, Mc - lt * S));
  r.G = G;
  r.prev = lt == 0 ? L - 1 : lt - 1;
  r.next = lt == L - 1 ? 0 : lt + 1;
  const uint32_t cw1 = chain_word(a.seed2, ch, 1u);
  const uint32_t cw2 = chain_word(a.seed2, ch, 2u);
  const uint32_t cw3 = chain_word(a.seed2, ch, 3u);

  float xe[S], xo[S], xc[S], xt[S], p[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const size_t o = (size_t)chain * Mc + lt * S + k;
    const bool real = valid && k < r.n;
    xe[k] = real ? fine_in[o] : 0.0f;
    xo[k] = real ? fine_in[(size_t)C * Mc + o] : 0.0f;
    xc[k] = real ? xc_in[o] : 0.0f;
  }
  float S_f = valid ? sc_in[chain] : 0.0f;
  float S_q = valid ? sc_in[C + chain] : 0.0f;
  const float dt = dt_in[0];
  const float hdt = 0.5f * dt;
  // S_c of the current coarse path, carried through the accept tests
  float S_cur = coarse_action(a, r, xc);

  for (int s = 0; s < a.n_steps; ++s) {
    const int base = s * (a.t_sub + 1);
    // ---- t_sub coarse HMC trajectories ----
    for (int t = 0; t < a.t_sub; ++t) {
      const float u_acc =
          draw_momenta(a, r, lt, cw1, cw2, cw3, (uint32_t)(base + t), p);
#pragma unroll
      for (int k = 0; k < S; ++k) xt[k] = xc[k];
      const float T_cur = 0.5f * r.sum_sq(p);
      coarse_kick(a, r, xt, p, hdt);
      drift(xt, p, dt);
#pragma unroll 2
      for (int k = 0; k < a.nt - 1; ++k) {
        coarse_kick(a, r, xt, p, dt);
        drift(xt, p, dt);
      }
      coarse_kick(a, r, xt, p, hdt);
      const float S_new = coarse_action(a, r, xt);
      const float dH = (S_new - S_cur) + (0.5f * r.sum_sq(p) - T_cur);
      const bool accept = dH < 0.0f || u_acc < expf(-dH);
      if (accept) {
#pragma unroll
        for (int k = 0; k < S; ++k) xc[k] = xt[k];
        S_cur = S_new;
      }
      if (a.with_traces) {
        const float cs = a.inv_Mc * r.sum_sq(xc);
        if (valid && lt == 0) {
          const size_t row = (size_t)(s * a.t_sub + t) * C + chain;
          cs_out[row] = cs;
          ec_out[row] = S_cur;
        }
      }
    }

    // ---- trial: prolongate + Gaussian conditional fill (odd plane in p) --
    const float u_acc = draw_momenta(a, r, lt, cw1, cw2, cw3,
                                     (uint32_t)(base + a.t_sub), p);
    float cm[S], cp[S], terms[S];
    r.neighbours(xc, cm, cp);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float xbar = 0.5f * (xc[k] + cp[k]);
      float w = xbar;
      for (int it = 0; it < 4; ++it) {
        const float xs = w - a.coarse.x0;
        w = a.rho * (xbar - a.ccw * xs * xs * xs);
      }
      const float xs = xbar - a.coarse.x0;
      const float curv = a.kcurv + a.k3 * xs * xs;
      p[k] = w + p[k] * rsqrtf(curv);
      const float d = p[k] - w;
      terms[k] = 0.5f * curv * d * d - 0.5f * logf(curv);
    }
    const float S_q_trial = r.total(terms);
    // fine action of (xc, p): site 2j has neighbours (p_{j-1}, p_j)
    float pm[S], pp[S];
    r.neighbours(p, pm, pp);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float e = xc[k];
      const float o = p[k];
      const float d1 = o - e;
      const float d2 = pm[k] - e;
      const float qe0 = e - a.coarse.x0;
      const float qo0 = o - a.coarse.x0;
      const float qe = qe0 * qe0;
      const float qo = qo0 * qo0;
      terms[k] = a.coarse.m0 * ((d1 * d1 + d2 * d2) / a.a2f +
                            a.coarse.mu2 * (e * e + o * o)) +
             a.coarse.hl * (qe * qe + qo * qo);
    }
    const float S_f_trial = a.kaf * r.total(terms);

    // ---- three-term dS ----
    const float dS_coarse = coarse_action(a, r, xe) - S_cur;
    const float dS = (S_f_trial - S_f) + dS_coarse + (S_q - S_q_trial);
    const bool accept = dS < 0.0f || u_acc < expf(-dS);
    if (accept) {
#pragma unroll
      for (int k = 0; k < S; ++k) {
        xe[k] = xc[k];
        xo[k] = p[k];
      }
      S_f = S_f_trial;
      S_q = S_q_trial;
    }

    // ---- QoI traces ----
    const float se = r.sum_sq(xe);
    const float so = r.sum_sq(xo);
    const float qc = a.inv_Mc * r.sum_sq(xc);
    if (valid && lt == 0) {
      const size_t row = (size_t)s * C + chain;
      qf_out[row] = a.inv_M * (se + so);
      qc_out[row] = qc;
      acc_out[row] = accept ? 1.0f : 0.0f;
    }
  }

  if (valid) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (k < r.n) {
        const size_t o = (size_t)chain * Mc + lt * S + k;
        fine_out[o] = xe[k];
        fine_out[(size_t)C * Mc + o] = xo[k];
        xc_out[o] = xc[k];
      }
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

// the kernel for `sites` sites a lane (a power of two, 1 .. 32), or null
static const void* kernel_for(int sites) {
  switch (sites) {
    case 1: return (const void*)qm_twolevel_kernel<1>;
    case 2: return (const void*)qm_twolevel_kernel<2>;
    case 4: return (const void*)qm_twolevel_kernel<4>;
    case 8: return (const void*)qm_twolevel_kernel<8>;
    case 16: return (const void*)qm_twolevel_kernel<16>;
    case 32: return (const void*)qm_twolevel_kernel<32>;
    default: return nullptr;
  }
}

}  // namespace mlmc

// fine_in/fine_out: [2, C, Mc] f32 even/odd planes; xc_in/xc_out: [C, Mc];
// sc_in/sc_out: [2, C] (S_fine, S_cond); dt: one f32 in device memory;
// qf/qc/acc: [n_steps, C]; cs/ec: [n_steps * t_sub, C] with traces, else
// [1, C] (written as zeros).  Outputs may not alias inputs.  The constants
// are folded on the host (ops/qm_twolevel.py).  lanes per chain (a power
// of two <= 32), threads per block (a multiple of 32, at most 128), sites
// a lane (a power of two <= 32, with lanes * sites >= Mc).  chain0: the
// global index of the launch's chain 0, which the chain words hash.
extern "C" int mlmc_qm_twolevel(
    const float* fine_in, const float* xc_in, const float* sc_in,
    const float* dt, float* fine_out, float* xc_out, float* sc_out,
    float* qf, float* qc, float* cs, float* ec, float* acc, int C, int Mc,
    int nt, int n_steps, int t_sub, int with_traces, float kf_c, float c_c,
    float al_c, float x0, float a2_c, float mu2, float m0, float hl,
    float kac, float kaf, float a2f, float rho, float ccw, float kcurv,
    float k3, float inv_M, float inv_Mc, uint32_t seed1, uint32_t seed2,
    uint32_t chain0, int lanes, int threads, int sites, void* stream) {
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
                         chain0,
                         lanes};
  const void* kernel = mlmc::kernel_for(sites);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int cpb = threads / lanes;
  void* args[] = {&fine_in, &xc_in, &sc_in, &dt, &fine_out, &xc_out,
                  &sc_out,  &qf,    &qc,    &cs, &ec,       &acc,
                  &a};
  cudaError_t e = cudaLaunchKernel(kernel, dim3((C + cpb - 1) / cpb),
                                   dim3(threads), args, 0,
                                   (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Registers a thread, local (spilled) bytes a thread and resident blocks
// an SM of the kernel for `sites` sites a lane at `threads` a block:
// out[0..2].
extern "C" int mlmc_qm_twolevel_attrs(int threads, int sites, int* out) {
  const void* kernel = mlmc::kernel_for(sites);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      threads, 0);
  }
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)e;
}
