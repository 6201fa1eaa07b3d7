// Device functions of the quenched Schwinger link sweep, shared by the
// sweep-chain kernel (schwinger_sweep.cu) and the two-level kernel
// (schwinger_twolevel.cu, whose coarse chain runs the same sweeps).
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_schwinger.py _staples,
// _group_update, _one_step, _expcos_rejection, _expcos_draw.
//
// A chain's link field lives in shared memory as two [Mx][Mt] planes
// (T = temporal links theta_0, X = spatial links theta_1; row j, column
// i).  One group of tpc threads serves one chain; a thread owns the sites
// s = lt, lt + tpc, ... and updates the links of its sites that belong to
// the active (mu, parity) group.  Links of one group share no plaquette,
// so they update in place; __syncthreads() separates the groups.

#pragma once

#include "rng.cuh"

namespace mlmc {

// A(i + di, j + dj) on a periodic [Mx][Mt] plane
__device__ __forceinline__ float at(const float* A, int j, int i, int dj,
                                    int di, int Mx, int Mt) {
  int jj = j + dj;
  int ii = i + di;
  jj = jj < 0 ? jj + Mx : (jj >= Mx ? jj - Mx : jj);
  ii = ii < 0 ? ii + Mt : (ii >= Mt ? ii - Mt : ii);
  return A[jj * Mt + ii];
}

// staples (theta_p, theta_m) of link (mu, j, i)
// (models/qft/schwinger.py staple_angles_mu)
__device__ __forceinline__ void staples(const float* T, const float* X,
                                        int mu, int j, int i, int Mx, int Mt,
                                        float* tp, float* tm) {
  if (mu == 0) {
    *tp = mod_2pi(at(T, j, i, 1, 0, Mx, Mt) + X[j * Mt + i] -
                  at(X, j, i, 0, 1, Mx, Mt));
    *tm = mod_2pi(at(T, j, i, -1, 0, Mx, Mt) + at(X, j, i, -1, 1, Mx, Mt) -
                  at(X, j, i, -1, 0, Mx, Mt));
  } else {
    *tp = mod_2pi(T[j * Mt + i] + at(X, j, i, 0, 1, Mx, Mt) -
                  at(T, j, i, 1, 0, Mx, Mt));
    *tm = mod_2pi(at(T, j, i, 1, -1, Mx, Mt) + at(X, j, i, 0, -1, Mx, Mt) -
                  at(T, j, i, 0, -1, Mx, Mt));
  }
}

// Centred x ~ exp(tau cos x) on [-pi, pi) by mixed-envelope rejection
// (uniform proposals for tau < 0.45, a tight Gaussian otherwise), at
// most k_rej rounds of 3 words: round r uses words ctr0 + 3r + 1 (radius),
// + 2 (uniform proposal / Box-Muller angle), + 3 (accept).  Returns
// whether a round accepted; x stays 0 otherwise.
__device__ __forceinline__ bool expcos_rejection(const CounterRng& rng,
                                                 uint32_t ctr0, float tau,
                                                 int k_rej, float* x) {
  const bool use_uni = tau < 0.45f;
  const float sigma = HALF_PI_F / sqrtf(fmaxf(tau, 1e-12f));
  *x = 0.0f;
  for (int r = 0; r < k_rej; ++r) {
    const uint32_t c = ctr0 + 3u * (uint32_t)r;
    const float u2 = rng.uniform(c + 2u);
    float prop;
    if (use_uni) {
      prop = PI_F * (2.0f * u2 - 1.0f);
    } else {
      const float u1 = rng.uniform(c + 1u);
      prop = sigma * (sqrtf(-2.0f * logf(u1)) * cosf(TWO_PI_F * u2));
    }
    const float u = rng.uniform(c + 3u);
    float log_ratio = tau * (cosf(prop) - 1.0f);
    if (!use_uni) log_ratio = log_ratio + 2.0f * tau * prop * prop / PI2_F;
    if (-PI_F <= prop && prop < PI_F && logf(u) <= log_ratio) {
      *x = prop;
      return true;
    }
  }
  return false;
}

// ExpCos heat-bath draw from p(x) ~ exp[beta(cos(x-tp) + cos(x-tm))];
// writes the draw to *out and returns true, or returns false (the
// caller keeps the current link or force-rejects)
__device__ __forceinline__ bool expcos_draw(const CounterRng& rng,
                                            uint32_t ctr0, float tp,
                                            float tm, float beta, int k_rej,
                                            float* out) {
  const float dx = tm - tp;
  const float tau = 2.0f * beta * fabsf(cosf(0.5f * dx));
  const float shift = 0.5f * (tp + tm) + (fabsf(dx) > PI_F ? PI_F : 0.0f);
  float x;
  const bool acc = expcos_rejection(rng, ctr0, tau, k_rej, &x);
  *out = mod_2pi(x + shift);
  return acc;
}

// One draw of the chain (pallas_schwinger._one_step): n_overrelax
// reflection sweeps, then n_heatbath ExpCos sweeps, each as the 4 groups
// (mu, parity) = (0,0), (0,1), (1,0), (1,1).  Heat-bath group g of sweep
// h reads counters from ((h*4 + g) * k_rej) * 3 on, as the reference
// draws 3 k_rej words for every element of every group.
__device__ __forceinline__ void sweep_step(float* T, float* X, int Mx, int Mt,
                                           int lt, int tpc, bool valid,
                                           uint32_t seed1, uint32_t seed2,
                                           uint32_t chain, uint32_t step,
                                           float beta, int n_overrelax,
                                           int n_heatbath, int k_rej) {
  const int nsites = Mx * Mt;
  for (int o = 0; o < n_overrelax; ++o) {
    for (int g = 0; g < 4; ++g) {
      const int mu = g >> 1;
      const int parity = g & 1;
      for (int s = lt; s < nsites && valid; s += tpc) {
        const int j = s / Mt;
        const int i = s - j * Mt;
        if (((mu == 0 ? j : i) & 1) != parity) continue;
        float tp, tm;
        staples(T, X, mu, j, i, Mx, Mt, &tp, &tm);
        float* L = mu == 0 ? T : X;
        L[s] = mod_2pi(tp + tm - L[s]);
      }
      __syncthreads();
    }
  }
  for (int h = 0; h < n_heatbath; ++h) {
    for (int g = 0; g < 4; ++g) {
      const int mu = g >> 1;
      const int parity = g & 1;
      const uint32_t ctr0 = (uint32_t)((h * 4 + g) * k_rej * 3);
      for (int s = lt; s < nsites && valid; s += tpc) {
        const int j = s / Mt;
        const int i = s - j * Mt;
        if (((mu == 0 ? j : i) & 1) != parity) continue;
        float tp, tm;
        staples(T, X, mu, j, i, Mx, Mt, &tp, &tm);
        const CounterRng rng(seed1, seed2, (uint32_t)s, chain, step);
        float out;
        if (expcos_draw(rng, ctr0, tp, tm, beta, k_rej, &out)) {
          float* L = mu == 0 ? T : X;
          L[s] = out;
        }
      }
      __syncthreads();
    }
  }
}

// per-thread partial sums over its sites of mod_2pi(theta_P) and
// cos(theta_P), theta_P = T + X(i+1) - T(j+1) - X
__device__ __forceinline__ void plaquette_sums(const float* T, const float* X,
                                               int Mx, int Mt, int lt,
                                               int tpc, float* q, float* e) {
  float qs = 0.0f, es = 0.0f;
  for (int s = lt; s < Mx * Mt; s += tpc) {
    const int j = s / Mt;
    const int i = s - j * Mt;
    const float p = mod_2pi(T[s] + at(X, j, i, 0, 1, Mx, Mt) -
                            at(T, j, i, 1, 0, Mx, Mt) - X[s]);
    qs += p;
    es += cosf(p);
  }
  *q = qs;
  *e = es;
}

}  // namespace mlmc
