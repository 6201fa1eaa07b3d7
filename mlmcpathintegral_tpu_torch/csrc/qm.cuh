// Device helpers of the QM kernels: per-chain barriers and sums over a
// chain's power-of-two thread group (hmc_trajectory.cu), and the
// quartic-oscillator force and action density (both QM kernels).
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
