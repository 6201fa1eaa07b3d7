// Record a [T, C] block of samples into the batched statistics
// accumulators (utils/statistics.py record_block) in one pass: the running
// mean, the long-term moments, the ring of the last k_max samples, the
// lagged products S_k and the two sample counters.
//
// Replaces: no Pallas kernel.  The JAX package leaves this update to XLA
// (mlmcpathintegral_tpu/utils/statistics.py record_block).  It was added
// because the H100 profile of the fused Schwinger MLMC at 8x8 put 19-23%
// of the device time in the plain version's three PyTorch kernels: its
// lagged products gather a [C, k_max, T] window tensor, multiply it into
// a second one and reduce that, 2 x 6.7 GB written and read back a record
// at 8192 chains, T = 2048, k_max = 100.
//
// What bounds it on the H100: the C k_max T multiply-adds of the lagged
// products (1.68 G at 8192 x 100 x 2048), against T C samples read and
// 2 C k_max words written.  The design keeps the products out of device
// memory.  A chain's series ext = ring (oldest first) ++ block is staged in
// shared memory, TILE samples at a time, as doubles.  Each thread owns R
// consecutive lags (R odd, so the lanes of a warp read distinct banks) and
// slides over t with the R lagged values in a register window that takes
// one new shared load a sample: R fused multiply-adds for two loads.  A
// chain is one warp (several where k_max > 32 * 7), a block CB chains, so
// a tile's rows of the time-major block are read CB neighbouring chains at
// a time (32-byte runs for float32 at CB = 8).
//
// The sums are in double.  Each lag's runs over t = 0 .. v-1 in order in
// one thread (a product of two float32 samples is exact in double); the
// moments run lane-strided (lane l the samples t = l mod 32, in order) and
// meet in a fixed butterfly.  So a chain's sums depend on (T, k_max,
// n_valid) alone, not on the chain count, the block or the launch shape: a
// rank's block of a chain-split run keeps the one-process bits.  A double
// state sums the same way, its products rounded once by the fma: a few
// float64 steps times sqrt(T) of the sum.  The update goes to new arrays;
// the input state is left as it was.  The counters are read and written on the
// device, so a record reads nothing back to the host.  One launch serves
// every shape the port records: T from 1 to 8192 and beyond (tiled), any
// chain count, k_max up to 8 warps x 32 lanes x 7 lags.

#include <cuda_runtime.h>

namespace mlmc {

// samples a chain stages in shared memory at a time, and the zeroed
// doubles in front of its series (read by the lags past k_max of the last
// lag group, whose sums are dropped); a block has at most STATS_THREADS
// threads
constexpr int STATS_TILE = 512;
constexpr int STATS_PAD = 8;
constexpr int STATS_THREADS = 256;

struct StatsArgs {
  int C;    // chains
  int K;    // k_max
  int ld;   // elements from one sample row of the block to the next
  int v;    // samples recorded: the leading v rows
  int cb;   // chains a block
  int wpc;  // warps a chain
};

template <typename S>
struct StatsPtrs {
  const S* q;                    // [v, ld] rows, chains contiguous
  const int* n;                  // counters, one int each
  const int* n_lt;
  const S* mom[5];               // avg, avg_lt, avg2_lt, avg3_lt, avg4_lt
  const S* ring;                 // [C, K], newest first
  const S* s_k;                  // [C, K]
  int* n_out;
  int* n_lt_out;
  S* mom_out[5];
  S* ring_out;
  S* s_k_out;
};

// the sum of every lane's s over a warp, in a fixed butterfly: the same
// in every lane
__device__ inline double warp_sum(double s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// (n_old * old + sum) / n_new in double, the running form of every moment
// and S_k (rounded to the state's type once, by the caller).  For a
// float32 state every product of two samples is exact in double, so the
// fma rounds once, as a plain multiply and add would, and the sum's error
// is far under a float32 step.
__device__ inline double running(double n_old, double old, double sum,
                                 double n_new) {
  return (n_old * old + sum) / n_new;
}

template <typename S, int R>
__global__ void __launch_bounds__(STATS_THREADS)
    stats_record_kernel(StatsPtrs<S> p, StatsArgs a) {
  extern __shared__ double sh[];
  const int K = a.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp / a.wpc, lw = warp - w * a.wpc;
  const int c0 = blockIdx.x * a.cb, c = c0 + w;
  const bool live = c < a.C;
  const int span = STATS_PAD + K + STATS_TILE;
  // b[t]: sample t of the tile; b[t - k]: the sample lag k before it
  const double* b = sh + w * span + STATS_PAD + K;
  const int k0 = (lw * 32 + lane) * R;
  const int n_old = *p.n, nlt_old = *p.n_lt;
  const int v = a.v;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *p.n_out = n_old + v;
    *p.n_lt_out = nlt_old + v;
  }
  if (v == 0) {  // nothing recorded: the state as it was
    if (!live) return;
    for (int k = lw * 32 + lane; k < K; k += 32 * a.wpc) {
      const size_t at = (size_t)c * K + k;
      p.ring_out[at] = p.ring[at];
      p.s_k_out[at] = p.s_k[at];
    }
    if (lw == 0 && lane == 0) {
#pragma unroll
      for (int m = 0; m < 5; ++m) p.mom_out[m][c] = p.mom[m][c];
    }
    return;
  }

  for (int i = threadIdx.x; i < a.cb * STATS_PAD; i += blockDim.x)
    sh[(i / STATS_PAD) * span + i % STATS_PAD] = 0.0;
  double lag[R];
#pragma unroll
  for (int r = 0; r < R; ++r) lag[r] = 0.0;
  double m1 = 0.0, m2 = 0.0, m3 = 0.0, m4 = 0.0;
  for (int ts = 0; ts < v; ts += STATS_TILE) {
    const int tn = min(STATS_TILE, v - ts);
    __syncthreads();  // the last tile is summed
    // ext positions ts .. ts + K + tn - 1: the ring before position K,
    // the block's row (position - K) from it; neighbouring threads on
    // neighbouring chains
    for (int i = threadIdx.x; i < (K + tn) * a.cb; i += blockDim.x) {
      const int r = i / a.cb, ww = i - r * a.cb, cc = c0 + ww;
      if (cc >= a.C) continue;
      const int g = ts + r;
      const S x = g < K ? p.ring[(size_t)cc * K + (K - 1 - g)]
                        : p.q[(size_t)(g - K) * a.ld + cc];
      sh[ww * span + STATS_PAD + r] = (double)x;
    }
    __syncthreads();
    if (!live) continue;
    if (k0 < K) {
      // win[(d mod R)] holds b[t0 + d - k0] for the window's d in
      // (u - R, u] at step u of a group of R samples from t0
      double win[R];
#pragma unroll
      for (int r = 1; r < R; ++r) win[R - r] = b[-k0 - r];
      int t = 0;
      for (; t + R <= tn; t += R) {
#pragma unroll
        for (int u = 0; u < R; ++u) {
          win[u] = b[t + u - k0];
          const double q = b[t + u];
#pragma unroll
          for (int r = 0; r < R; ++r) lag[r] = fma(q, win[(u - r + R) % R], lag[r]);
        }
      }
      for (; t < tn; ++t) {
        const double q = b[t];
#pragma unroll
        for (int r = 0; r < R; ++r) lag[r] = fma(q, b[t - k0 - r], lag[r]);
      }
    }
    if (lw == 0) {
      for (int t = lane; t < tn; t += 32) {
        const double q = b[t], q2 = q * q;
        m1 += q;
        m2 += q2;
        m3 += q2 * q;
        m4 += q2 * q2;
      }
    }
  }
  if (!live) return;

  if (lw == 0) {
    m1 = warp_sum(m1);
    m2 = warp_sum(m2);
    m3 = warp_sum(m3);
    m4 = warp_sum(m4);
    if (lane == 0) {
      const double no = (double)n_old, nlo = (double)nlt_old;
      const double nn = (double)(n_old + v), nl = (double)(nlt_old + v);
      p.mom_out[0][c] = (S)running(no, (double)p.mom[0][c], m1, nn);
      p.mom_out[1][c] = (S)running(nlo, (double)p.mom[1][c], m1, nl);
      p.mom_out[2][c] = (S)running(nlo, (double)p.mom[2][c], m2, nl);
      p.mom_out[3][c] = (S)running(nlo, (double)p.mom[3][c], m3, nl);
      p.mom_out[4][c] = (S)running(nlo, (double)p.mom[4][c], m4, nl);
    }
  }
  // S_k over N_k = n_lt - k pairs: (N_old S_k + P_k) / N_new, left as it
  // was while no pair of lag k exists
  if (k0 < K) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int k = k0 + r;
      if (k < K) {
        const size_t at = (size_t)c * K + k;
        const S old = p.s_k[at];
        const int n_new = nlt_old + v - k;
        p.s_k_out[at] = n_new > 0 ? (S)running((double)max(nlt_old - k, 0),
                                               (double)old, lag[r],
                                               (double)n_new)
                                  : old;
      }
    }
  }
  // the ring, newest first: the block's last samples, then the old ring
  for (int k = lw * 32 + lane; k < K; k += 32 * a.wpc) {
    const size_t at = (size_t)c * K + k;
    p.ring_out[at] = k < v ? p.q[(size_t)(v - 1 - k) * a.ld + c]
                           : p.ring[(size_t)c * K + (k - v)];
  }
}

template <typename S>
static const void* stats_kernel_of_type(int lags) {
  switch (lags) {
    case 1: return (const void*)stats_record_kernel<S, 1>;
    case 3: return (const void*)stats_record_kernel<S, 3>;
    case 5: return (const void*)stats_record_kernel<S, 5>;
    case 7: return (const void*)stats_record_kernel<S, 7>;
    default: return nullptr;
  }
}

// the kernel of a launch: double or float32 state, `lags` lags a thread
static const void* stats_kernel_for(int is_double, int lags) {
  return is_double ? stats_kernel_of_type<double>(lags)
                   : stats_kernel_of_type<float>(lags);
}

template <typename S>
static cudaError_t stats_launch(const void* kernel, void* const* in,
                                void* const* out, StatsArgs a, size_t smem,
                                cudaStream_t stream) {
  StatsPtrs<S> p;
  p.q = (const S*)in[0];
  p.n = (const int*)in[1];
  p.n_lt = (const int*)in[2];
  for (int m = 0; m < 5; ++m) p.mom[m] = (const S*)in[3 + m];
  p.ring = (const S*)in[8];
  p.s_k = (const S*)in[9];
  p.n_out = (int*)out[0];
  p.n_lt_out = (int*)out[1];
  for (int m = 0; m < 5; ++m) p.mom_out[m] = (S*)out[2 + m];
  p.ring_out = (S*)out[7];
  p.s_k_out = (S*)out[8];
  void* args[] = {&p, &a};
  return cudaLaunchKernel(kernel, dim3((a.C + a.cb - 1) / a.cb),
                          dim3(32 * a.wpc * a.cb), args, smem, stream);
}

static cudaError_t allow_stats_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace mlmc

// in: 10 device pointers in StatsPtrs' order: the block q (rows ld
// elements apart, chains contiguous), the counters n and n_lt (int32),
// avg, avg_lt, avg2_lt, avg3_lt, avg4_lt ([C]), ring and s_k ([C, K]);
// out: 9 in the same order without q, none aliasing an input.  Floats of the state's type
// (is_double: double, else float32).  v: the leading rows recorded (0 ..
// T); lags a thread (1, 3, 5 or 7), wpc warps a chain, cb chains a block,
// smem = cb * (8 + K + 512) * 8 bytes of dynamic shared memory
// (ops/statistics.py record_launch).
extern "C" int mlmc_stats_record(void* const* in, void* const* out, int C,
                                 int K, int ld, int v, int is_double,
                                 int lags, int wpc, int cb, size_t smem,
                                 void* stream) {
  const void* kernel = mlmc::stats_kernel_for(is_double, lags);
  if (kernel == nullptr || C < 1 || wpc * cb * 32 > mlmc::STATS_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = mlmc::allow_stats_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const mlmc::StatsArgs a{C, K, ld, v, cb, wpc};
  e = is_double ? mlmc::stats_launch<double>(kernel, in, out, a, smem,
                                             (cudaStream_t)stream)
                : mlmc::stats_launch<float>(kernel, in, out, a, smem,
                                            (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Registers a thread, local (spilled) bytes a thread and resident blocks
// an SM of the launch's kernel at `threads` a block with smem bytes of
// dynamic shared memory: out[0..2].
extern "C" int mlmc_stats_record_attrs(int threads, int is_double, int lags,
                                       size_t smem, int* out) {
  const void* kernel = mlmc::stats_kernel_for(is_double, lags);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes fa{};
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e == cudaSuccess) e = mlmc::allow_stats_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      threads, smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)e;
}
