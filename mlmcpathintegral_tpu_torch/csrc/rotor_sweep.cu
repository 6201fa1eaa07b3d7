// Fused even/odd overrelax + ExpCos heat-bath sweep chain of the
// topological rotor.
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_rotor.py rotor_sweep_chain
// (_chain_kernel, _one_step, _winding_sum) and rotor_sweep (the chain at
// n_steps = 1, step 0).  Per step it emits the winding sum
// W = sum_j mod_2pi(x_{j+1} - x_j).
//
// The conditional of site j given its neighbours is
// exp[kappa (cos(x - x_{j-1}) + cos(x - x_{j+1}))], kappa = I/a: the same
// ExpCos draw as a Schwinger link given its two staples, so the rejection
// device code of schwinger_sweep.cuh is reused with tp = x_{j-1},
// tm = x_{j+1}.  The overrelaxation reflection is
// mod_2pi(x_{j-1} + x_{j+1} - x_j).  Both sites of pair (2k, 2k+1) use
// RNG site id k; heat-bath half-sweep (h, parity) reads counters from
// (2 h + parity) 3 k_rej on.
//
// What bounds it on the H100: latency and instruction issue, not bandwidth.
// A chain's path (M floats, 1 KB at M = 256) is read once and written once
// per launch; between, every step is two dependent half-sweeps per sweep
// kind, each a pass of counter hashing and a data-dependent rejection loop
// (3 words a round, at most k_rej rounds) whose lanes end at different
// rounds.
//
// The design: a chain on one warp, up to four warps a block.  The path
// and the chain's counter-word table (schwinger_sweep.cuh ChainWords) stay
// in the chain's slice of shared memory for all n_steps draws, half-sweeps
// are separated by __syncwarp() only, and pair k sits on lane k mod 32,
// whose first site hashes are fixed once a launch.  In a heat-bath
// half-sweep each lane takes the first round of up to four of its draws in
// straight-line code (no draw waits on another's rounds); the draws it
// rejects join a queue in the chain's slice, which the warp drains breadth
// first: each pass gives the pending draws the next round, one lane a draw
// while they are at least 32, else W lanes a draw running rounds
// r .. r + W - 1 ahead, a ballot taking a group's first accepting round as
// the sequential loop does.  So no lane waits for the slowest lane's
// rounds of its own draws, and a half-sweep with fewer draws than lanes
// (M < 64) runs each draw's rounds on the lanes it leaves idle.  The
// winding sum adds in the order of the block-wide tree (rng.cuh chain_sum
// over next_pow2(M/2) threads, at most 1024, thread t summing pairs t,
// t + 1024, ..): the lane's virtual threads in the chain's scratch, then
// a butterfly, so W keeps that tree's bits.  Every draw takes the
// sequential loop's round, so the paths keep them too.

#include <cuda_runtime.h>

#include "schwinger_sweep.cuh"

namespace mlmc {

constexpr int ROTOR_SWEEP_THREADS = 128;
// draws a lane sets up at once in a half-sweep, and the queue of a chunk's
// pending draws (6 words an item)
constexpr int ROTOR_CHUNK = 4;
constexpr int ROTOR_QUEUE = 32 * ROTOR_CHUNK;

struct RotorSweepArgs {
  int C, M, n_steps, n_overrelax, n_heatbath, k_rej;
  float kappa;
  uint32_t seed1, seed2;
  uint32_t chain0;  // global index of the launch's first chain
  int cpb, words;
};

__device__ __forceinline__ int site_before(int j, int M) {
  return j == 0 ? M - 1 : j - 1;
}

__device__ __forceinline__ int site_after(int j, int M) {
  return j == M - 1 ? 0 : j + 1;
}

// The queue of a chain's pending draws in its slice of shared memory: per
// item the pair k, the next round r and the draw's tau, sigma, shift and
// stream base, in a ring of ROTOR_QUEUE items (the draws of one chunk).
struct DrawQueue {
  int* k;
  int* r;
  float* tau;
  float* sigma;
  float* shift;
  uint32_t* bs;

  __device__ __forceinline__ DrawQueue(float* base) {
    k = reinterpret_cast<int*>(base);
    r = k + ROTOR_QUEUE;
    tau = reinterpret_cast<float*>(r + ROTOR_QUEUE);
    sigma = tau + ROTOR_QUEUE;
    shift = sigma + ROTOR_QUEUE;
    bs = reinterpret_cast<uint32_t*>(shift + ROTOR_QUEUE);
  }

  __device__ __forceinline__ void put(int at, int kk, int rr, float t,
                                      float sg, float sf, uint32_t b) const {
    at &= ROTOR_QUEUE - 1;
    k[at] = kk;
    r[at] = rr;
    tau[at] = t;
    sigma[at] = sg;
    shift[at] = sf;
    bs[at] = b;
  }
};

// The heat-bath half-sweep of parity `par`: pairs k = lt + 32 i < H, a
// chunk of ROTOR_CHUNK a lane at a time.  Each lane takes the first round
// of its chunk's draws in straight-line code; the draws it rejects join
// the chain's queue, and the warp then drains the queue breadth first:
// each pass gives every pending draw its next round, W lanes a draw with
// rounds r .. r + W - 1 ahead once the draws are fewer than the lanes, and
// a ballot takes a group's first accepting round, as the sequential loop
// does.  sh holds the site hashes of the lane's first ROTOR_CHUNK pairs.
__device__ __forceinline__ void heatbath_draws(
    float* x, const DrawQueue& qu, const RotorSweepArgs& a,
    const ChainWords& cw, int lt, uint32_t step, int par, uint32_t ctr0,
    const uint32_t (&sh)[ROTOR_CHUNK]) {
  const int M = a.M;
  const int H = M / 2;
  const unsigned below = (1u << lt) - 1u;
  for (int i0 = 0; 32 * i0 < H; i0 += ROTOR_CHUNK) {
    int tail = 0;
#pragma unroll
    for (int q = 0; q < ROTOR_CHUNK; ++q) {
      const int k = lt + 32 * (i0 + q);
      const bool active = k < H && a.k_rej > 0;
      const int kk = min(k, H - 1);
      const int j = 2 * kk + par;
      const uint32_t bs = step_base(
          i0 == 0 ? sh[q] : site_hash(a.seed1, (uint32_t)kk), step);
      // the first round's field-free part, then the neighbours
      const ExpcosPre first = expcos_pre(StreamUniform{bs, cw}, ctr0, 0,
                                         true);
      float tau, shift;
      expcos_shift(x[site_before(j, M)], x[site_after(j, M)], a.kappa, &tau,
                   &shift);
      const float sigma = expcos_sigma(tau);
      float prop;
      const bool ok = expcos_test(first, tau, sigma, &prop);
      if (active && ok) x[j] = mod_2pi(prop + shift);
      const bool pend = active && !ok && a.k_rej > 1;
      const unsigned pm = __ballot_sync(0xffffffffu, pend);
      if (pend) qu.put(tail + __popc(pm & below), kk, 1, tau, sigma, shift, bs);
      tail += __popc(pm);
    }
    __syncwarp();
    int head = 0;
    while (head != tail) {
      const int n = tail - head;
      const int W = n >= 32 ? 1 : 32 / pow2_ceil(n);
      const int i = lt / W;
      const int q = lt & (W - 1);
      const bool valid = i < n;
      const int at = (head + (valid ? i : 0)) & (ROTOR_QUEUE - 1);
      const int kk = qu.k[at];
      const int r = qu.r[at];
      const float tau = qu.tau[at];
      const float sigma = qu.sigma[at];
      const float shift = qu.shift[at];
      const uint32_t bs = qu.bs[at];
      float prop = 0.0f;
      const bool ok = valid && r + q < a.k_rej &&
                      expcos_test(expcos_pre(StreamUniform{bs, cw}, ctr0,
                                             r + q, true),
                                  tau, sigma, &prop);
      const unsigned group =
          W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (lt & ~(W - 1));
      const unsigned hits = __ballot_sync(0xffffffffu, ok) & group;
      const float took = __shfl_sync(0xffffffffu, prop,
                                     hits != 0u ? __ffs(hits) - 1 : lt);
      const bool lead = valid && q == 0;
      if (lead && hits != 0u) x[2 * kk + par] = mod_2pi(took + shift);
      const bool again = lead && hits == 0u && r + W < a.k_rej;
      const unsigned am = __ballot_sync(0xffffffffu, again);
      head += min(n, 32 / W);
      __syncwarp();
      if (again)
        qu.put(tail + __popc(am & below), kk, r + W, tau, sigma, shift, bs);
      tail += __popc(am);
      __syncwarp();
    }
  }
}

// mod_2pi(x_{2k+1} - x_{2k}) + mod_2pi(x_{2k+2} - x_{2k+1})
__device__ __forceinline__ float pair_winding(const float* x, int k, int M) {
  const float e = x[2 * k];
  const float o = x[2 * k + 1];
  const float e1 = x[2 * k + 2 == M ? 0 : 2 * k + 2];
  return mod_2pi(o - e) + mod_2pi(e1 - o);
}

__global__ void __launch_bounds__(ROTOR_SWEEP_THREADS, 8)
    rotor_sweep_kernel(const float* __restrict__ x_in,
                       float* __restrict__ x_out, float* __restrict__ wsum,
                       RotorSweepArgs a) {
  extern __shared__ float smem[];
  const int M = a.M;
  const int H = M / 2;
  const int lc = threadIdx.x >> 5;
  const int lt = threadIdx.x & 31;
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < a.C;
  // the winding sum's tree: tpc virtual threads, P lanes holding them
  // (lanes P.. hold copies), nm a lane, summed in the scratch when nm > 1
  const int tpc = min(1024, pow2_ceil(H));
  const int P = min(32, tpc);
  const int nm = tpc / P;
  const int lp = lt & (P - 1);
  // the chain's slice: word table, path, then the pending-draw queue and
  // the winding sum's scratch (nm > 1), one over the other
  const int pool = max(nm > 1 ? tpc : 0, 6 * ROTOR_QUEUE);
  float* mine = smem + (size_t)lc * (a.words + M + pool);
  float* x = mine + a.words;
  float* red = x + M;
  const DrawQueue qu(red);

  const ChainWords cw =
      chain_words(reinterpret_cast<uint32_t*>(mine), a.words, a.seed2,
                  a.chain0 + (uint32_t)chain, lt, 32);
  const float* src = x_in + (size_t)chain * M;
  for (int s = lt; s < M; s += 32) x[s] = valid ? src[s] : 0.0f;
  __syncwarp();

  // the site hashes of the lane's first pairs, fixed for the launch
  uint32_t sh[ROTOR_CHUNK];
#pragma unroll
  for (int q = 0; q < ROTOR_CHUNK; ++q) {
    sh[q] = site_hash(a.seed1, (uint32_t)(lt + 32 * q));
  }

  for (int st = 0; st < a.n_steps; ++st) {
    const uint32_t step = (uint32_t)st;
    for (int r = 0; r < a.n_overrelax; ++r) {
      for (int par = 0; par < 2; ++par) {
        for (int k = lt; k < H; k += 32) {
          const int j = 2 * k + par;
          x[j] = mod_2pi(x[site_before(j, M)] + x[site_after(j, M)] - x[j]);
        }
        __syncwarp();
      }
    }
    for (int h = 0; h < a.n_heatbath; ++h) {
      for (int par = 0; par < 2; ++par) {
        const uint32_t ctr0 = (uint32_t)((h * 2 + par) * a.k_rej * 3);
        heatbath_draws(x, qu, a, cw, lt, step, par, ctr0, sh);
        __syncwarp();
      }
    }
    if (wsum != nullptr) {
      // virtual thread t = lp + P m sums pairs t, t + tpc, .. from 0
      float v = 0.0f;
      if (nm == 1) {
        for (int k = lp; k < H; k += tpc) v += pair_winding(x, k, M);
      } else {
        for (int m = 0; m < nm; ++m) {
          float vm = 0.0f;
          for (int k = lp + P * m; k < H; k += tpc)
            vm += pair_winding(x, k, M);
          red[lp + P * m] = vm;
        }
        // the tree over the lane's own virtual threads: pairs at distance
        // nm/2, nm/4, .., 1
        for (int off = nm >> 1; off > 0; off >>= 1) {
          for (int m = 0; m < off; ++m)
            red[lp + P * m] += red[lp + P * (m + off)];
        }
        v = red[lp];
      }
      v = lanes_sum(v, P);
      if (valid && lt == 0) wsum[(size_t)st * a.C + chain] = v;
    }
  }

  if (valid) {
    float* dst = x_out + (size_t)chain * M;
    for (int s = lt; s < M; s += 32) dst[s] = x[s];
  }
}

}  // namespace mlmc

// x_in/x_out: [C, M] f32 (may not alias, M even); wsum: [n_steps, C] f32
// or null.  cpb chains (warps) per block, words of the chain-word table
// and smem bytes of dynamic shared memory (ops/rotor.py sweep_launch).
// chain0: the global index of the launch's chain 0, which the chain words
// hash.
extern "C" int mlmc_rotor_sweep(const float* x_in, float* x_out, float* wsum,
                                int C, int M, int n_steps, int n_overrelax,
                                int n_heatbath, int k_rej, float kappa,
                                uint32_t seed1, uint32_t seed2,
                                uint32_t chain0, int cpb, int words,
                                size_t smem, void* stream) {
  mlmc::RotorSweepArgs a{C,     M,     n_steps, n_overrelax, n_heatbath,
                         k_rej, kappa, seed1,   seed2,       chain0,
                         cpb,   words};
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlmc::rotor_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + cpb - 1) / cpb;
  mlmc::rotor_sweep_kernel<<<blocks, 32 * cpb, smem,
                             (cudaStream_t)stream>>>(x_in, x_out, wsum, a);
  return (int)cudaGetLastError();
}

// Registers a thread, local (spilled) bytes a thread and resident blocks
// an SM of the sweep kernel at `threads` a block with smem bytes of
// dynamic shared memory: out[0..2].
extern "C" int mlmc_rotor_sweep_attrs(int threads, size_t smem, int* out) {
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, mlmc::rotor_sweep_kernel);
  if (e == cudaSuccess && smem > 48 * 1024) {
    e = cudaFuncSetAttribute(mlmc::rotor_sweep_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], mlmc::rotor_sweep_kernel, threads, smem);
  }
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)e;
}
