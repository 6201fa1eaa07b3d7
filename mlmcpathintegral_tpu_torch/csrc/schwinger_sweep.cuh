// Device functions of the quenched Schwinger link sweep, shared by the
// sweep-chain kernel (schwinger_sweep.cu) and the two-level kernel
// (schwinger_twolevel.cu, whose coarse chain runs the same sweeps); the
// rotor sweep (rotor_sweep.cu) reuses the ExpCos draw.
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_schwinger.py _staples,
// _group_update, _one_step, _expcos_rejection, _expcos_draw.
//
// A chain's link field lives in shared memory as two [Mx][Mt] planes
// (T = temporal links theta_0, X = spatial links theta_1; row j, column
// i), served by G lanes: an aligned power-of-two share of one warp (the
// warp design, kWarp), or a whole block (G = blockDim.x) for fields beyond
// it.  Links of one (mu, parity) group share no plaquette, so they update
// in place; a chain barrier (__syncwarp() in the warp design,
// __syncthreads() in a block) separates the groups.  A group's n links
// are spread over the G lanes, W = G / next_pow2(n) lanes a link when
// n < G: those lanes run the link's rejection rounds W at a time, and a
// ballot takes the first round that accepts, as the sequential loop does.

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

// The parts of round r of the centred ExpCos rejection x ~ exp(tau cos x)
// on [-pi, pi) that read no field value: words ctr0 + 3r + 1 (radius),
// + 2 (uniform proposal / Box-Muller angle), + 3 (accept), each the (0, 1]
// uniform uni(ctr).  The Gaussian envelope's normal is taken only when
// `gauss` (a kernel that does not know tau yet takes it always).
struct ExpcosPre {
  float prop_uni;  // pi (2 u2 - 1)
  float nrm;       // sqrt(-2 log u1) cos(2 pi u2)
  float log_u;     // log u
};

template <class Uniform>
__device__ __forceinline__ ExpcosPre expcos_pre(const Uniform& uni,
                                                uint32_t ctr0, int r,
                                                bool gauss) {
  const uint32_t c = ctr0 + 3u * (uint32_t)r;
  const float u2 = uni(c + 2u);
  ExpcosPre e;
  e.prop_uni = PI_F * (2.0f * u2 - 1.0f);
  e.nrm = gauss ? sqrtf(-2.0f * logf(uni(c + 1u))) * cosf(TWO_PI_F * u2)
                : 0.0f;
  e.log_u = logf(uni(c + 3u));
  return e;
}

// The round's test (mixed envelope: uniform proposals for tau < 0.45, a
// tight Gaussian of width sigma otherwise): writes the proposal, returns
// whether the round accepts.
__device__ __forceinline__ bool expcos_test(const ExpcosPre& e, float tau,
                                            float sigma, float* prop) {
  const bool use_uni = tau < 0.45f;
  const float p = use_uni ? e.prop_uni : sigma * e.nrm;
  float log_ratio = tau * (cosf(p) - 1.0f);
  if (!use_uni) log_ratio = log_ratio + 2.0f * tau * p * p / PI2_F;
  *prop = p;
  return -PI_F <= p && p < PI_F && e.log_u <= log_ratio;
}

// Round r of the rejection, both parts
template <class Uniform>
__device__ __forceinline__ bool expcos_round(const Uniform& uni,
                                             uint32_t ctr0, int r, float tau,
                                             float sigma, float* prop) {
  return expcos_test(expcos_pre(uni, ctr0, r, !(tau < 0.45f)), tau, sigma,
                     prop);
}

// Gaussian envelope width of the ExpCos rejection at tau
__device__ __forceinline__ float expcos_sigma(float tau) {
  return HALF_PI_F / sqrtf(fmaxf(tau, 1e-12f));
}

// (tau, shift) of the ExpCos draw from the two staples
__device__ __forceinline__ void expcos_shift(float tp, float tm, float beta,
                                             float* tau, float* shift) {
  const float dx = tm - tp;
  *tau = 2.0f * beta * fabsf(cosf(0.5f * dx));
  *shift = 0.5f * (tp + tm) + (fabsf(dx) > PI_F ? PI_F : 0.0f);
}

// The sequential rejection loop: at most k_rej rounds.  Returns whether a
// round accepted; x stays 0 otherwise.
__device__ __forceinline__ bool expcos_rejection(const CounterRng& rng,
                                                 uint32_t ctr0, float tau,
                                                 int k_rej, float* x) {
  const float sigma = expcos_sigma(tau);
  const auto uni = [&](uint32_t c) { return rng.uniform(c); };
  *x = 0.0f;
  for (int r = 0; r < k_rej; ++r) {
    float prop;
    if (expcos_round(uni, ctr0, r, tau, sigma, &prop)) {
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
  float tau, shift, x;
  expcos_shift(tp, tm, beta, &tau, &shift);
  const bool acc = expcos_rejection(rng, ctr0, tau, k_rej, &x);
  *out = mod_2pi(x + shift);
  return acc;
}

// Words a chain keeps in shared memory: the chain half of every counter
// word below its table's size (rng.cuh chain_word), computed once a launch;
// a counter beyond it is hashed where it is drawn.  The sweep chain's
// draws read counters up to 12 k_rej (72 at the main path's k_rej = 6),
// the two-level chain's fill up to 292 at the main path's settings.
constexpr int SWEEP_WORDS = 96;
constexpr int TWOLEVEL_WORDS = 320;

struct ChainWords {
  const uint32_t* tab;  // n words in the chain's shared slice
  uint32_t base_c;      // fmix32(chain * 0x85EBCA77 ^ seed2)
  uint32_t n;

  __device__ __forceinline__ uint32_t operator()(uint32_t ctr) const {
    return ctr < n ? tab[ctr] : fmix32(base_c + ctr * 0x27D4EB2Fu);
  }
};

// fill a chain's table of n words: every lane of the chain calls it; a
// chain barrier must follow before the words are read
__device__ __forceinline__ ChainWords chain_words(uint32_t* tab, int n,
                                                  uint32_t seed2,
                                                  uint32_t chain, int lt,
                                                  int G) {
  const uint32_t base_c = fmix32((chain * 0x85EBCA77u) ^ seed2);
  for (int c = lt; c < n; c += G)
    tab[c] = fmix32(base_c + (uint32_t)c * 0x27D4EB2Fu);
  return ChainWords{tab, base_c, (uint32_t)n};
}

// the (0, 1] uniform of word ctr of the stream (base_s, chain): the bits of
// CounterRng(seed1, seed2, site, chain, step).uniform(ctr) with
// base_s = step_base(site_hash(seed1, site), step)
struct StreamUniform {
  uint32_t base_s;
  const ChainWords& cw;

  __device__ __forceinline__ float operator()(uint32_t ctr) const {
    return bits_uniform(split_bits(base_s, cw(ctr), ctr));
  }
};

template <bool kWarp>
__device__ __forceinline__ void chain_sync() {
  if constexpr (kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// lanes an item of a set of n items gets from a chain of G lanes: a power
// of two <= 32, more than one only while the items leave lanes idle
__device__ __forceinline__ int lanes_per_item(int G, int n) {
  if (n >= G) return 1;
  return min(32, G / pow2_ceil(n));
}

// The W aligned lanes of one group (q = this lane's place in it) evaluate
// rounds q, q + W, q + 2W, ... of a rejection loop of k rounds, W at a
// time; round(r, &prop) returns whether round r accepts.  Every lane of
// an active group gets the proposal of the first accepting round and true,
// or 0 and false when none of the k rounds accepts: the sequential loop's
// result, with the same bits.  All 32 lanes of the warp call it together
// (lanes with no item pass active = false, W is the same for the whole
// warp): each batch is one ballot and one shuffle for the warp, whichever
// groups are still drawing, and the loop ends when every group is done.
template <class Round>
__device__ __forceinline__ bool first_accepted(const Round& round, int k,
                                               int W, int q, bool active,
                                               float* x) {
  const int lane = threadIdx.x & 31;
  const unsigned group =
      W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (lane & ~(W - 1));
  bool done = !active, acc = false;
  float res = 0.0f;
  for (int rb = 0; rb < k; rb += W) {
    float prop = 0.0f;
    const bool ok = !done && rb + q < k && round(rb + q, &prop);
    const unsigned hits = __ballot_sync(0xffffffffu, ok) & group;
    const float first =
        W == 1 ? prop
               : __shfl_sync(0xffffffffu, prop,
                             hits != 0u ? __ffs(hits) - 1 : lane);
    if (!done && hits != 0u) {
      res = first;
      acc = true;
      done = true;
    }
    if (__all_sync(0xffffffffu, done)) break;
  }
  *x = res;
  return acc;
}

// links of group (mu, parity) on an [Mx][Mt] grid: temporal links of the
// rows j = parity (mod 2), spatial links of the columns i = parity (mod 2)
__device__ __forceinline__ int group_size(int mu, int parity, int Mx,
                                          int Mt) {
  return mu == 0 ? ((Mx - parity + 1) >> 1) * Mt
                 : Mx * ((Mt - parity + 1) >> 1);
}

// site (j, i) of the group's k-th link
__device__ __forceinline__ int group_site(int mu, int parity, int k, int Mx,
                                          int Mt, int* j, int* i) {
  if (mu == 0) {
    const int r = k / Mt;
    *j = parity + 2 * r;
    *i = k - r * Mt;
  } else {
    const int nc = (Mt - parity + 1) >> 1;
    const int r = k / nc;
    *j = r;
    *i = parity + 2 * (k - r * nc);
  }
  return *j * Mt + *i;
}

// One draw of the chain (pallas_schwinger._one_step): n_overrelax
// reflection sweeps, then n_heatbath ExpCos sweeps, each as the 4 groups
// (mu, parity) = (0,0), (0,1), (1,0), (1,1).  Heat-bath group g of sweep
// h reads counters from ((h*4 + g) * k_rej) * 3 on, as the reference
// draws 3 k_rej words for every element of every group.
//
// The block-wide form: a chain on the block's G threads, which loop over
// a group's links (any field); lt is this thread's place.
__device__ __forceinline__ void sweep_step_block(
    float* T, float* X, int Mx, int Mt, int lt, int G, uint32_t seed1,
    const ChainWords& cw, uint32_t step, float beta, int n_overrelax,
    int n_heatbath, int k_rej) {
  for (int o = 0; o < n_overrelax; ++o) {
    for (int g = 0; g < 4; ++g) {
      const int mu = g >> 1;
      const int parity = g & 1;
      const int n = group_size(mu, parity, Mx, Mt);
      float* L = mu == 0 ? T : X;
      for (int k = lt; k < n; k += G) {
        int j, i;
        const int s = group_site(mu, parity, k, Mx, Mt, &j, &i);
        float tp, tm;
        staples(T, X, mu, j, i, Mx, Mt, &tp, &tm);
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
      const int n = group_size(mu, parity, Mx, Mt);
      const int W = lanes_per_item(G, n);
      const int q = lt & (W - 1);
      float* L = mu == 0 ? T : X;
      // every lane runs the same passes (first_accepted is warp-wide)
      for (int k0 = 0; k0 < n; k0 += G / W) {
        const int k = k0 + lt / W;
        const bool active = k < n;
        int j, i;
        const int s =
            group_site(mu, parity, active ? k : 0, Mx, Mt, &j, &i);
        float tp, tm, tau, shift;
        staples(T, X, mu, j, i, Mx, Mt, &tp, &tm);
        expcos_shift(tp, tm, beta, &tau, &shift);
        const float sigma = expcos_sigma(tau);
        const StreamUniform uni{step_base(site_hash(seed1, (uint32_t)s),
                                          step),
                                cw};
        const auto round = [&](int r, float* prop) {
          return expcos_round(uni, ctr0, r, tau, sigma, prop);
        };
        float x;
        if (first_accepted(round, k_rej, W, q, active, &x) && q == 0)
          L[s] = mod_2pi(x + shift);
      }
      __syncthreads();
    }
  }
}

// periodic index (j + dj, i + di) of an [Mx][Mt] plane, as at() reads it
__device__ __forceinline__ int wrap_index(int j, int i, int Mx, int Mt) {
  j = j < 0 ? j + Mx : (j >= Mx ? j - Mx : j);
  i = i < 0 ? i + Mt : (i >= Mt ? i - Mt : i);
  return j * Mt + i;
}

// The warp design's lane in one link group, fixed for a launch: the site
// of its link, the five other links the link's staples read (as
// staples() reads them), the site's counter hash, and its place q among
// the W lanes of the link; a lane past the group's links is not active.
// The design takes fields whose every group fits the chain's lanes.
struct LaneLink {
  int s, a0, a1, a2, a3, a4;
  uint32_t site_h;
  int W, q;
  bool active;
};

__device__ __forceinline__ LaneLink lane_link(int g, int lt, int G, int Mx,
                                              int Mt, uint32_t seed1) {
  const int mu = g >> 1;
  const int parity = g & 1;
  const int n = group_size(mu, parity, Mx, Mt);
  LaneLink l;
  l.W = lanes_per_item(G, n);
  l.q = lt & (l.W - 1);
  const int k = lt / l.W;
  l.active = k < n;
  int j, i;
  l.s = group_site(mu, parity, l.active ? k : 0, Mx, Mt, &j, &i);
  if (mu == 0) {
    l.a0 = wrap_index(j + 1, i, Mx, Mt);      // T(j+1, i)
    l.a1 = wrap_index(j, i + 1, Mx, Mt);      // X(j, i+1)
    l.a2 = wrap_index(j - 1, i, Mx, Mt);      // T(j-1, i)
    l.a3 = wrap_index(j - 1, i + 1, Mx, Mt);  // X(j-1, i+1)
    l.a4 = l.a2;                              // X(j-1, i)
  } else {
    l.a0 = wrap_index(j, i + 1, Mx, Mt);      // X(j, i+1)
    l.a1 = wrap_index(j + 1, i, Mx, Mt);      // T(j+1, i)
    l.a2 = wrap_index(j + 1, i - 1, Mx, Mt);  // T(j+1, i-1)
    l.a3 = wrap_index(j, i - 1, Mx, Mt);      // X(j, i-1)
    l.a4 = l.a3;                              // T(j, i-1)
  }
  l.site_h = site_hash(seed1, (uint32_t)l.s);
  return l;
}

struct LaneLinks {
  LaneLink g[4];
};

__device__ __forceinline__ LaneLinks lane_links(int lt, int G, int Mx,
                                                int Mt, uint32_t seed1) {
  LaneLinks ll;
#pragma unroll
  for (int g = 0; g < 4; ++g) ll.g[g] = lane_link(g, lt, G, Mx, Mt, seed1);
  return ll;
}

// staples() of the lane's link, from its fixed indices
__device__ __forceinline__ void link_staples(const float* T, const float* X,
                                             int mu, const LaneLink& l,
                                             float* tp, float* tm) {
  if (mu == 0) {
    *tp = mod_2pi(T[l.a0] + X[l.s] - X[l.a1]);
    *tm = mod_2pi(T[l.a2] + X[l.a3] - X[l.a4]);
  } else {
    *tp = mod_2pi(T[l.s] + X[l.a0] - T[l.a1]);
    *tm = mod_2pi(T[l.a2] + X[l.a3] - T[l.a4]);
  }
}

// v[g] of a four-entry register array at a group index known only at run
// time, by selects (an indexed array would go to local memory)
template <class V>
__device__ __forceinline__ V pick4(const V (&v)[4], int g) {
  V r = v[0];
  if (g == 1) r = v[1];
  if (g == 2) r = v[2];
  if (g == 3) r = v[3];
  return r;
}

// The warp design's draw: the lane's links fixed for the launch (ll), at
// most one link a lane in a group.  In a heat-bath group each lane first
// takes the parts of its link's first round that read no field value (its
// counter words, the Box-Muller normal, the logs), which do not wait on
// the staples; the W lanes of a link then test their rounds together.
__device__ __forceinline__ void sweep_step_warp(
    float* T, float* X, const LaneLinks& ll, const ChainWords& cw,
    uint32_t step, float beta, int n_overrelax, int n_heatbath, int k_rej) {
  for (int o = 0; o < n_overrelax; ++o) {
#pragma unroll 1
    for (int g = 0; g < 4; ++g) {
      const LaneLink l = pick4(ll.g, g);
      float* L = g < 2 ? T : X;
      if (l.active && l.q == 0) {
        float tp, tm;
        link_staples(T, X, g >> 1, l, &tp, &tm);
        L[l.s] = mod_2pi(tp + tm - L[l.s]);
      }
      __syncwarp();
    }
  }
  for (int h = 0; h < n_heatbath; ++h) {
#pragma unroll 1
    for (int g = 0; g < 4; ++g) {
      const LaneLink l = pick4(ll.g, g);
      float* L = g < 2 ? T : X;
      const uint32_t ctr0 = (uint32_t)((h * 4 + g) * k_rej * 3);
      const StreamUniform uni{step_base(l.site_h, step), cw};
      const ExpcosPre first = expcos_pre(uni, ctr0, l.q, true);
      float tp, tm, tau, shift;
      link_staples(T, X, g >> 1, l, &tp, &tm);
      expcos_shift(tp, tm, beta, &tau, &shift);
      const float sigma = expcos_sigma(tau);
      const int W = l.W;
      const auto round = [&](int r, float* prop) {
        const ExpcosPre p = r < W ? first : expcos_pre(uni, ctr0, r, true);
        return expcos_test(p, tau, sigma, prop);
      };
      float x;
      if (first_accepted(round, k_rej, W, l.q, l.active, &x) && l.q == 0)
        L[l.s] = mod_2pi(x + shift);
      __syncwarp();
    }
  }
}

// The chain's sums of K per-lane values, every lane of the chain getting
// them: in the warp design a butterfly over the P lanes that hold the
// chain's sites (lanes P.. hold copies), else the block's tree
// (rng.cuh chain_sum over G threads).  With site s on lane s mod P, the
// butterfly adds in the tree's order.
template <bool kWarp, int K>
__device__ __forceinline__ void chain_reduce(float (&v)[K], float* red,
                                             int G, int P) {
  if constexpr (kWarp) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = lanes_sum(v[k], P);
  } else {
    chain_sum<K>(v, red, G);
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

// The warp design's plaquettes of a lane for the chain's sums: sites
// s = lp and s + P (lp = the lane's place mod P), with the X(j, i+1) and
// T(j+1, i) links each reads; n of them lie in the field (a field of up
// to 2 P sites)
struct LanePlaq {
  int s[2], x[2], t[2];
  int n;
};

__device__ __forceinline__ LanePlaq lane_plaq(int lp, int P, int Mx,
                                              int Mt) {
  LanePlaq p;
  p.n = 0;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int s = lp + k * P;
    const int ss = s < Mx * Mt ? s : 0;
    const int j = ss / Mt;
    const int i = ss - j * Mt;
    p.s[k] = ss;
    p.x[k] = wrap_index(j, i + 1, Mx, Mt);
    p.t[k] = wrap_index(j + 1, i, Mx, Mt);
    if (s < Mx * Mt) p.n = k + 1;
  }
  return p;
}

// plaquette_sums over the lane's fixed plaquettes, in the same order
__device__ __forceinline__ void plaquette_sums_warp(const float* T,
                                                    const float* X,
                                                    const LanePlaq& p,
                                                    float* q, float* e) {
  float qs = 0.0f, es = 0.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (k < p.n) {
      const float v = mod_2pi(T[p.s[k]] + X[p.x[k]] - T[p.t[k]] - X[p.s[k]]);
      qs += v;
      es += cosf(v);
    }
  }
  *q = qs;
  *e = es;
}

}  // namespace mlmc
