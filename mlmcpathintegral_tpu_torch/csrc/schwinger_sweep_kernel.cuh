// Fused overrelax + heat-bath sweep chain of the quenched Schwinger model.
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_schwinger.py
// schwinger_sweep (_sweep_kernel) and schwinger_sweep_chain
// (_chain_kernel).  One kernel serves both: n_steps draws with stream
// indices step_offset + s, so n_steps = 1 is schwinger_sweep and the chain
// equals n_steps single draws with step_offset = 0 .. n_steps-1 bit for
// bit.  Per step it emits Q = sum_P mod_2pi(theta_P) and, with esum,
// E = sum_P cos(theta_P).
//
// What bounds it on the H100: latency, not bandwidth.  A chain's field
// (2 Mx Mt floats, 128 B for the 4x4 coarsest level of the 8x8 headline)
// is read once and written once per launch; between, every draw is
// 8 quarter-sweeps of stencil reads from shared memory, counter hashing
// and a data-dependent rejection loop, each a dependent chain that only
// more resident warps and a shorter critical path can hide.
//
// The design (kWarp, fields up to 64 sites): a chain on one warp, or on an
// aligned power-of-two share of one, two lanes a site (lanes =
// min(32, next_pow2(2 Mx Mt))), up to four warps a block.  The field and
// the chain's counter-word table (schwinger_sweep.cuh ChainWords) stay in
// the chain's slice of shared memory for all n_steps draws.  Each lane's
// link in each of the four link groups, with the links its staples read,
// is fixed once a launch (LaneLink), so a group does no index arithmetic;
// groups are separated by __syncwarp(); each link gets the lanes its group
// leaves idle, which run its rejection rounds ahead, W at a time, with one
// warp-wide ballot a batch (first_accepted); Q and E are shuffle
// butterflies over the lanes that hold the sites, site s on lane s, adding
// in the order of the block-wide tree so the sums keep its bits.
//
// Fields beyond 64 sites take the block design (schwinger_sweep.cuh,
// sweep_step_team): a chain on a team of G threads, a block a chain, G
// from the field and the chain count (64 to 512, several chains an SM
// when the launch has many), __syncthreads() between the groups, each
// thread's heat-bath links drawing their rounds interleaved (or, one link
// a thread, pooled across the warp after round 0), and Q and E summed in
// the order of the earlier one-site-a-thread tree with one barrier
// (team_sum).  A field beyond shared memory keeps the earlier threads a
// chain (up to 1024).  A field beyond the shared memory one block may opt
// in to (227 KB on the H100: a 256x128 lattice's links are 256 KB a
// chain) keeps its two planes in its slice of a global scratch buffer the
// wrapper allocates (work != nullptr), updated in place; only the word
// table and the sums' scratch stay in shared memory.  Every branch gives
// a link the same arithmetic on the same planes and the sums the same
// order, so they compute the same bits.
//
// The counted instantiations (kCount, launched where rounds != nullptr,
// while the program records) also count the heat bath's rejection loop:
// draws, rounds needed and rounds evaluated (schwinger_sweep.cuh
// RegCount), summed by each warp and added to rounds[0..2] at the end.
// Their draws and outputs are the uncounted kernel's.  This header holds
// the kernel; schwinger_sweep.cu instantiates the uncounted kernels and
// schwinger_sweep_counted.cu the counted ones, so nvcc builds the two
// side by side.


#pragma once

#include <cuda_runtime.h>

#include "schwinger_sweep.cuh"

namespace mlmc {

struct SweepArgs {
  int C, Mx, Mt, n_steps, step_offset, n_overrelax, n_heatbath, k_rej;
  float beta;
  uint32_t seed1, seed2;
  uint32_t chain0;  // global index of the launch's first chain
  int lanes, cpb;
};

template <bool kWarp, bool kCount>
__global__ void __launch_bounds__(kWarp ? 128 : 1024)
    schwinger_sweep_kernel(const float* __restrict__ theta_in,
                           float* __restrict__ theta_out,
                           float* __restrict__ qsum,
                           float* __restrict__ esum, float* work,
                           unsigned long long* rounds, SweepArgs a) {
  extern __shared__ float smem[];
  const int nsites = a.Mx * a.Mt;
  const int G = a.lanes;
  const int lc = threadIdx.x / G;
  const int lt = threadIdx.x & (G - 1);
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < a.C;
  // the chain's slice: its word table, then its planes (unless they live
  // in global memory, which only the block-wide form takes); the block's
  // reduction scratch after all slices
  const bool in_global = !kWarp && work != nullptr;
  const int slice = SWEEP_WORDS + (in_global ? 0 : 2 * nsites);
  float* mine = smem + (size_t)lc * slice;
  float* T = mine + SWEEP_WORDS;
  if constexpr (!kWarp) {
    if (in_global) T = work + (size_t)chain * 2 * nsites;
  }
  float* X = T + nsites;
  float* red = smem + (size_t)a.cpb * slice;
  // the sums' slots: in the warp design the lanes holding the chain's
  // sites, in the block design the threads a chain of the one-site-a-
  // thread tree, whose order it keeps
  const int P = kWarp ? min(G, pow2_ceil(nsites))
                      : min(1024, pow2_ceil(nsites));
  int rb = 0;  // team_sum's buffer
  std::conditional_t<kCount, RegCount, NoCount> cnt;  // the heat bath's

  const ChainWords cw =
      chain_words(reinterpret_cast<uint32_t*>(mine), SWEEP_WORDS, a.seed2,
                  a.chain0 + (uint32_t)chain, lt, G);
  const float* src = theta_in + (size_t)chain * 2 * nsites;
  if constexpr (kWarp) {
    for (int s = lt; s < nsites; s += G) {
      T[s] = valid ? src[2 * s] : 0.0f;
      X[s] = valid ? src[2 * s + 1] : 0.0f;
    }
  } else {
    // a site's two links in one 8-byte load, four loads in flight
    const float2* src2 = reinterpret_cast<const float2*>(src);
#pragma unroll 4
    for (int s = lt; s < nsites; s += G) {
      const float2 tx = valid ? src2[s] : make_float2(0.0f, 0.0f);
      T[s] = tx.x;
      X[s] = tx.y;
    }
  }
  chain_sync<kWarp>();

  // the warp design's links and plaquettes of this lane, fixed for the
  // launch
  LaneLinks ll;
  LanePlaq pl;
  if constexpr (kWarp) {
    ll = lane_links(lt, G, a.Mx, a.Mt, a.seed1);
    pl = lane_plaq(lt & (P - 1), P, a.Mx, a.Mt);
  }

  for (int st = 0; st < a.n_steps; ++st) {
    const uint32_t step = (uint32_t)(a.step_offset + st);
    if constexpr (kWarp) {
      sweep_step_warp(T, X, ll, cw, step, a.beta, a.n_overrelax,
                      a.n_heatbath, a.k_rej, &cnt);
    } else {
      sweep_step_team(T, X, a.Mx, a.Mt, lt, G, a.seed1, cw, step, a.beta,
                      a.n_overrelax, a.n_heatbath, a.k_rej, &cnt);
    }
    if (qsum != nullptr) {
      float v[2];
      if constexpr (kWarp) {
        plaquette_sums_warp(T, X, pl, &v[0], &v[1]);
        warp_reduce(v, P);
      } else {
        // its barrier follows the reads, before the next draw's writes
        team_sum(v, red, rb, lt, G, P,
                 PlaquetteSlot{T, X, a.Mx, a.Mt, P});
      }
      if (valid && lt == 0) {
        qsum[(size_t)st * a.C + chain] = v[0];
        if (esum != nullptr) esum[(size_t)st * a.C + chain] = v[1];
      }
      // the next draw writes links the sums read
      if constexpr (kWarp) chain_sync<kWarp>();
    }
  }

  if (valid) {
    float* dst = theta_out + (size_t)chain * 2 * nsites;
    if constexpr (kWarp) {
      for (int s = lt; s < nsites; s += G) {
        dst[2 * s] = T[s];
        dst[2 * s + 1] = X[s];
      }
    } else {
      float2* dst2 = reinterpret_cast<float2*>(dst);
#pragma unroll 4
      for (int s = lt; s < nsites; s += G) dst2[s] = make_float2(T[s], X[s]);
    }
  }
  if constexpr (kCount) flush_counts(cnt, valid, rounds);
}

// the kernel of a launch: the warp design where kWarp, counted or not
using SweepKernel = void (*)(const float*, float*, float*, float*, float*,
                             unsigned long long*, SweepArgs);

// the counted kernel of the warp design (warp) or of the block design
// (schwinger_sweep_counted.cu)
SweepKernel sweep_kernel_counted(bool warp);

inline cudaError_t allow_sweep_smem(SweepKernel k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace mlmc
