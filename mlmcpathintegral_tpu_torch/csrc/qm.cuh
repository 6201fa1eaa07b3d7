// Device helpers of the QM kernels: per-chain barriers and sums over a
// chain's power-of-two thread group (the block branch of
// hmc_trajectory.cu), the rings of a chain's sites on the lanes of a warp
// (the register designs of hmc_trajectory.cu and qm_twolevel.cu) with
// their kick and drift, and the quartic-oscillator force and action
// density (both QM kernels).
//
// A chain lives on one group of tpc consecutive threads (a power of two);
// when tpc <= 32 the group lies inside one warp, so a warp barrier and a
// shuffle butterfly serve it and no block-wide barrier is needed.  Every
// thread of the block must call group_sync/group_sum at the same point.
// The butterfly leaves the same bits in every lane (each pairwise add is
// commutative), so each thread of a chain takes the same accept decision.

#pragma once

#include "rng.cuh"

namespace mlmc {

__device__ __forceinline__ void group_sync(int tpc) {
  if (tpc <= 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Sum of v over the chain's group; every thread gets the sum.  red: shared
// scratch of blockDim.x floats (used when tpc > 32).
__device__ __forceinline__ float group_sum(float v, float* red, int tpc) {
  if (tpc <= 32) {
    for (int off = tpc >> 1; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
  }
  float s[1] = {v};
  chain_sum<1>(s, red, tpc);
  return s[0];
}

// The ring of a chain's Mc sites on its G lanes, contiguous (K6): lane l
// holds sites l S + k, k < S, of which the first n are real (n < S only
// on the last lane, and 0 on idle lanes).  Every lane of the warp must
// call the shuffling members.
template <int S>
struct Ring {
  int n;     // real sites of this lane
  int G;     // lanes per chain
  int prev;  // lane holding the site before this lane's first
  int next;  // lane holding the site after this lane's last real one

  // values at j-1 (vm) and j+1 (vp) of this lane's sites j
  __device__ __forceinline__ void neighbours(const float (&v)[S],
                                             float (&vm)[S],
                                             float (&vp)[S]) const {
    float last = v[S - 1];
#pragma unroll
    for (int k = 0; k < S - 1; ++k) {
      if (k == n - 1) last = v[k];
    }
    const float from_prev = __shfl_sync(0xffffffffu, last, prev, G);
    const float from_next = __shfl_sync(0xffffffffu, v[0], next, G);
#pragma unroll
    for (int k = 0; k < S; ++k) {
      vm[k] = k == 0 ? from_prev : v[k > 0 ? k - 1 : 0];
      vp[k] = (k == S - 1 || k == n - 1) ? from_next
                                         : v[k < S - 1 ? k + 1 : k];
    }
  }

  // sum over the chain of t over this lane's real sites, in site order
  // within the lane, then the butterfly
  __device__ __forceinline__ float total(const float (&t)[S]) const {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      if (k < n) v += t[k];
    }
    return lanes_sum(v, G);
  }

  __device__ __forceinline__ float sum_sq(const float (&v)[S]) const {
    float t[S];
#pragma unroll
    for (int k = 0; k < S; ++k) t[k] = v[k] * v[k];
    return total(t);
  }
};

// The ring of a chain's M sites on its G lanes, strided (K5): lane l
// holds sites l + G k, k < S, with G S = next_pow2(M) (G = min(32, G S)),
// the layout of the block branch's thread t = site t.  Sites l + G k >= M
// are padding: they take part in the shuffles and are left out of the
// sums.  The shuffles' source lanes and the wrap are fixed once a launch.
// Every lane of the warp must call the shuffling members.
template <int S>
struct StridedRing {
  int G;         // lanes per chain
  int lt;        // this lane's place in the chain
  int M;         // real sites
  int up, down;  // lanes holding sites m - 1 and m + 1 (m not at a seam)
  int last_lane, last_slot;  // where site M - 1 lives
  bool padded;   // M < G S: the seams M-1 | 0 need the wrap shuffles

  __device__ __forceinline__ StridedRing(int G_, int lt_, int M_)
      : G(G_), lt(lt_), M(M_) {
    up = (lt - 1) & (G - 1);
    down = (lt + 1) & (G - 1);
    last_lane = (M - 1) & (G - 1);
    last_slot = (M - 1) / G;
    padded = M < G * S;
  }

  __device__ __forceinline__ bool real(int k) const {
    return lt + G * k < M;
  }

  // values at m-1 (vm) and m+1 (vp) of this lane's sites m: lane l reads
  // slot k of lane l -+ 1; lane 0's site G k - 1 is slot k - 1 of lane
  // G - 1 and lane G - 1's site G k + G is slot k + 1 of lane 0, so those
  // two lanes send the shifted slot (at M = G S the shift wraps to the
  // periodic neighbours); with padding, sites M - 1 and 0 exchange values
  // by two more shuffles
  __device__ __forceinline__ void neighbours(const float (&v)[S],
                                             float (&vm)[S],
                                             float (&vp)[S]) const {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float to_up = lt == 0 ? v[(k + 1) % S] : v[k];
      const float to_down = lt == G - 1 ? v[(k + S - 1) % S] : v[k];
      vm[k] = __shfl_sync(0xffffffffu, to_down, up, G);
      vp[k] = __shfl_sync(0xffffffffu, to_up, down, G);
    }
    if (padded) {
      float last = v[0];
#pragma unroll
      for (int k = 1; k < S; ++k) {
        if (k == last_slot) last = v[k];
      }
      const float x_last = __shfl_sync(0xffffffffu, last, last_lane, G);
      const float x_first = __shfl_sync(0xffffffffu, v[0], 0, G);
      if (lt == 0) vm[0] = x_last;
      if (lt == last_lane) {
#pragma unroll
        for (int k = 0; k < S; ++k) {
          if (k == last_slot) vp[k] = x_first;
        }
      }
    }
  }

  // sum over the chain's real sites in the block tree's order (rng.cuh
  // chain_sum over G S threads, thread t = site t): the lane's slots in
  // pairs at distance S/2, S/4, .., 1, then the butterfly over the lanes
  __device__ __forceinline__ float total(const float (&t)[S]) const {
    float v[S];
#pragma unroll
    for (int k = 0; k < S; ++k) v[k] = real(k) ? 0.0f + t[k] : 0.0f;
#pragma unroll
    for (int off = S / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < off; ++k) v[k] += v[k + off];
    }
    return lanes_sum(v[0], G);
  }

  __device__ __forceinline__ float sum_sq(const float (&v)[S]) const {
    float t[S];
#pragma unroll
    for (int k = 0; k < S; ++k) t[k] = v[k] * v[k];
    return total(t);
  }
};

// p -= h F(x, x_{j-1}, x_{j+1}) on a lane's sites of either ring
template <class R, int S, class Force>
__device__ __forceinline__ void ring_kick(const R& r, const float (&x)[S],
                                          float (&p)[S], float h,
                                          const Force& force) {
  float xm[S], xp[S];
  r.neighbours(x, xm, xp);
#pragma unroll
  for (int k = 0; k < S; ++k) p[k] = p[k] - h * force(x[k], xm[k], xp[k]);
}

// x += dt p on a lane's sites
template <int S>
__device__ __forceinline__ void drift(float (&x)[S], const float (&p)[S],
                                      float dt) {
#pragma unroll
  for (int k = 0; k < S; ++k) x[k] = x[k] + dt * p[k];
}

// Quartic oscillator at spacing a (lam = 0: the harmonic formulas of the
// two-level kernel), constants folded on the host as the plain version
// folds them: kf = m0/a, c = 2 + a^2 mu2, al = a lam, a2 = a^2,
// hl = lam/2.
struct Quartic {
  float kf, c, al, x0, a2, mu2, m0, hl;

  // force at site x with neighbours xm (j-1) and xp (j+1)
  __device__ __forceinline__ float force(float x, float xm, float xp) const {
    const float xs = x - x0;
    return kf * (c * x - xm - xp) + al * xs * xs * xs;
  }

  // action density m0 ((dx)^2/a^2 + mu2 x^2) + lam/2 (x - x0)^4, dx = x - xm
  __device__ __forceinline__ float density(float x, float xm) const {
    const float dx = x - xm;
    const float d = x - x0;
    const float xs2 = d * d;
    return m0 * (dx * dx / a2 + mu2 * x * x) + hl * xs2 * xs2;
  }
};

}  // namespace mlmc
