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
// warp design, kWarp), or a team of whole warps, a block a chain, for
// fields beyond it (the block design, at the end of this file).  Links of
// one (mu, parity) group share no plaquette, so they update in place; a
// chain barrier (__syncwarp() in the warp design, __syncthreads() in a
// block) separates the groups.  A group's n links are spread over the G
// lanes, W = G / next_pow2(n) lanes a link when n < G: those lanes run the
// link's rejection rounds W at a time, and a ballot takes the first round
// that accepts, as the sequential loop does.

#pragma once

#include <type_traits>

#include "rng.cuh"

namespace mlmc {

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

// The counts of one rejection loop over a launch, added by the lane that
// owns each draw: draws, rounds needed (the sequential loop's rounds: the
// first accepting round + 1, or k when none accepts) and rounds evaluated
// (each (draw, round) a lane drew and tested, so a round tried W at a time
// after an earlier one accepted counts too).  The loops take a counter
// class: NoCount keeps nothing and its calls compile away (an uncounted
// kernel is the code it was); RegCount keeps a lane's counts in
// registers.
struct NoCount {
  static constexpr bool kOn = false;
  __device__ __forceinline__ void draw(int, int) {}
};

struct RegCount {
  static constexpr bool kOn = true;
  uint32_t c[3] = {0u, 0u, 0u};

  __device__ __forceinline__ void draw(int rounds, int evaluated) {
    c[0] += 1u;
    c[1] += (uint32_t)rounds;
    c[2] += (uint32_t)evaluated;
  }
  __device__ __forceinline__ uint32_t get(int k) const { return c[k]; }
};

// rounds evaluated by a draw whose W lanes ran its rounds W at a time
// (rounds rb + q < k) until the batch that held round need - 1
__device__ __forceinline__ int rounds_run(int need, int W, int k) {
  return min((need + W - 1) & ~(W - 1), k);
}

// adds the warp's counts (draws, rounds needed, rounds evaluated) to
// out[0..2] with one atomic each from lane 0; every lane of the warp calls
// it, with zero counts where its chain lies past the launch's chains
template <class Cnt>
__device__ __forceinline__ void flush_counts(const Cnt& c, bool valid,
                                             unsigned long long* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint32_t s = __reduce_add_sync(0xffffffffu, valid ? c.get(k) : 0u);
    if ((threadIdx.x & 31) == 0) atomicAdd(out + k, (unsigned long long)s);
  }
}

// the place + 1 of the first hit of a ballot in this lane's group of W
// lanes: the rounds a draw needs is the batch's first round + this
__device__ __forceinline__ int hit_in_group(unsigned hits, int W) {
  return __ffs(hits) - ((threadIdx.x & 31) & ~(W - 1));
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
// cnt, where given, counts the loop: lane q = 0 of an active group owns
// its draw.
template <class Round, class Cnt = NoCount>
__device__ __forceinline__ bool first_accepted(const Round& round, int k,
                                               int W, int q, bool active,
                                               float* x,
                                               Cnt* cnt = nullptr) {
  const int lane = threadIdx.x & 31;
  const unsigned group =
      W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (lane & ~(W - 1));
  bool done = !active, acc = false;
  float res = 0.0f;
  int need = k;  // counted: the rounds the draw needs
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
      if constexpr (Cnt::kOn) need = rb + hit_in_group(hits, W);
    }
    if (__all_sync(0xffffffffu, done)) break;
  }
  if constexpr (Cnt::kOn) {
    if (active && q == 0) cnt->draw(need, rounds_run(need, W, k));
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
// cnt, where given, counts the heat-bath draws.
template <class Cnt = NoCount>
__device__ __forceinline__ void sweep_step_warp(
    float* T, float* X, const LaneLinks& ll, const ChainWords& cw,
    uint32_t step, float beta, int n_overrelax, int n_heatbath, int k_rej,
    Cnt* cnt = nullptr) {
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
      if (first_accepted(round, k_rej, W, l.q, l.active, &x, cnt) &&
          l.q == 0)
        L[l.s] = mod_2pi(x + shift);
      __syncwarp();
    }
  }
}

// The warp design's sums of K per-lane values, every lane of the chain
// getting them: a butterfly over the P lanes that hold the chain's sites
// (lanes P.. hold copies).  With site s on lane s mod P, the butterfly adds
// in the order of the block-wide tree (rng.cuh chain_sum over P threads).
template <int K>
__device__ __forceinline__ void warp_reduce(float (&v)[K], int P) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = lanes_sum(v[k], P);
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

// the sums of mod_2pi(theta_P) and cos(theta_P), theta_P = T + X(i+1) -
// T(j+1) - X, over the lane's fixed plaquettes in order
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

// ---- The block design: a chain on a team of whole warps ------------------
//
// A field beyond the warp design puts a chain on a team of G threads (a
// power of two from 64 to 512), a block a chain.  The launch function
// (ops/schwinger.py block_threads) takes G from the field and the chain
// count: the threads of the earlier block design (P = min(1024,
// next_pow2(items)), one item a thread), at most 512, while the launch has
// few chains an SM, fewer threads a chain when it has more, so that
// several chains are resident on an SM and a barrier of one chain stalls
// its own warps while the other chains' warps run.  A thread takes the
// items k = lt, lt + G, ... of each link group (or cell set), their grid
// places walked without a division (GridWalk) and their neighbours
// wrapped by compares.  A thread's heat-bath links run their rejection
// rounds interleaved, a flat loop over (link, round), so a warp waits for
// the slowest thread's total rounds, not for the slowest link of every
// pass; with one link a thread the warp pools the links still drawing
// after round 0 (pooled_heatbath_link).  The chain's sums add in the
// order of chain_sum's tree over the earlier design's P threads with one
// barrier (team_sum).  Every link and every sum takes the bits it took
// there.

// The places (row r, column c) of the items k0, k0 + step, ... of a grid
// with rows of len items, one step without a division
struct GridWalk {
  int r, c, dr, dc, len;

  __device__ __forceinline__ GridWalk(int k0, int step, int len_)
      : len(len_) {
    const int l = len_ > 0 ? len_ : 1;
    r = k0 / l;
    c = k0 - r * l;
    dr = step / l;
    dc = step - dr * l;
  }

  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= len) {
      c -= len;
      ++r;
    }
  }
};

// links a row of group (mu, parity) holds (group_site's row length)
__device__ __forceinline__ int group_len(int mu, int parity, int Mt) {
  return mu == 0 ? Mt : (Mt - parity + 1) >> 1;
}

// the link of group (mu, parity) at a walk's place with the five other
// links its staples read (lane_link's indices, wrapped by compares)
__device__ __forceinline__ LaneLink block_link(int mu, int parity,
                                               const GridWalk& w, int Mx,
                                               int Mt) {
  const int j = mu == 0 ? parity + 2 * w.r : w.r;
  const int i = mu == 0 ? w.c : parity + 2 * w.c;
  const int jp = j + 1 == Mx ? 0 : j + 1;
  const int jm = j == 0 ? Mx - 1 : j - 1;
  const int ip = i + 1 == Mt ? 0 : i + 1;
  const int im = i == 0 ? Mt - 1 : i - 1;
  LaneLink l;
  l.s = j * Mt + i;
  if (mu == 0) {
    l.a0 = jp * Mt + i;   // T(j+1, i)
    l.a1 = j * Mt + ip;   // X(j, i+1)
    l.a2 = jm * Mt + i;   // T(j-1, i)
    l.a3 = jm * Mt + ip;  // X(j-1, i+1)
    l.a4 = l.a2;          // X(j-1, i)
  } else {
    l.a0 = j * Mt + ip;   // X(j, i+1)
    l.a1 = jp * Mt + i;   // T(j+1, i)
    l.a2 = jp * Mt + im;  // T(j+1, i-1)
    l.a3 = j * Mt + im;   // X(j, i-1)
    l.a4 = l.a3;          // T(j, i-1)
  }
  return l;
}

// A heat-bath group with one link at most a thread: every thread runs
// round 0 of its link, then the warp pools the links still drawing and
// runs their next rounds breadth first, W = 32 / next_pow2(pending) lanes
// a link, W rounds at a time, the first accepting one taken by ballot, so
// a warp waits for about three round times instead of its slowest link's
// four or five.  A link's state moves to its lanes by shuffles; every
// link takes the first of its k_rej rounds that accepts, as the
// sequential loop does, and stays when none does.  cnt, where given,
// counts the draws (a link's own thread owns it).
template <class Cnt = NoCount>
__device__ __forceinline__ void pooled_heatbath_link(
    const float* T, const float* X, float* L, int mu, int parity, int lt,
    int n, int len, int Mx, int Mt, uint32_t seed1, const ChainWords& cw,
    uint32_t step, uint32_t ctr0, float beta, int k_rej,
    Cnt* cnt = nullptr) {
  const int lane = threadIdx.x & 31;
  const bool active = lt < n;
  float tau = 0.0f, shift = 0.0f, sigma = 0.0f;
  uint32_t base_s = 0u;
  int s = 0;
  if (active) {
    const LaneLink l = block_link(mu, parity, GridWalk(lt, 0, len), Mx, Mt);
    float tp, tm;
    link_staples(T, X, mu, l, &tp, &tm);
    expcos_shift(tp, tm, beta, &tau, &shift);
    sigma = expcos_sigma(tau);
    base_s = step_base(site_hash(seed1, (uint32_t)l.s), step);
    s = l.s;
  }
  float prop = 0.0f;
  const bool ok0 = active && k_rej > 0 &&
                   expcos_round(StreamUniform{base_s, cw}, ctr0, 0, tau,
                                sigma, &prop);
  if (ok0) L[s] = mod_2pi(prop + shift);
  // the link's rounds needed (k_rej unless one accepts) and evaluated
  int need = ok0 ? 1 : k_rej, evals = min(k_rej, 1);
  // the links still drawing, all at round r
  unsigned pm = __ballot_sync(0xffffffffu, active && !ok0);
  for (int r = 1; pm != 0u && r < k_rej;) {
    const int np = __popc(pm);
    const int W = 32 / pow2_ceil(np);
    const int j = lane / W, q = lane & (W - 1);
    const bool has = j < np;
    const int src = has ? (int)__fns(pm, 0, j + 1) : lane;
    const float tau_j = __shfl_sync(0xffffffffu, tau, src);
    const float sigma_j = __shfl_sync(0xffffffffu, sigma, src);
    const float shift_j = __shfl_sync(0xffffffffu, shift, src);
    const uint32_t base_j = __shfl_sync(0xffffffffu, base_s, src);
    const int s_j = __shfl_sync(0xffffffffu, s, src);
    float p = 0.0f;
    const bool ok = has && r + q < k_rej &&
                    expcos_round(StreamUniform{base_j, cw}, ctr0, r + q,
                                 tau_j, sigma_j, &p);
    const unsigned group =
        W == 32 ? 0xffffffffu : ((1u << W) - 1u) << (lane & ~(W - 1));
    const unsigned hits = __ballot_sync(0xffffffffu, ok) & group;
    const float first =
        __shfl_sync(0xffffffffu, p, hits != 0u ? __ffs(hits) - 1 : lane);
    if (has && q == 0 && hits != 0u) L[s_j] = mod_2pi(first + shift_j);
    // each pending link's owner learns from its group's first lane
    const int rank = __popc(pm & ((1u << lane) - 1u));
    const bool mine = (pm >> lane) & 1u;
    bool took;
    if constexpr (Cnt::kOn) {
      // the hit's place in the group, 0 for none, from its first lane
      const int at = __shfl_sync(
          0xffffffffu, hits != 0u ? hit_in_group(hits, W) : 0,
          mine ? rank * W : lane);
      took = at != 0;
      if (mine) {
        evals += min(W, k_rej - r);
        if (took) need = r + at;
      }
    } else {
      took = __shfl_sync(0xffffffffu, hits != 0u ? 1 : 0,
                         mine ? rank * W : lane) != 0;
    }
    pm = __ballot_sync(0xffffffffu, mine && !took);
    r += W;
  }
  if constexpr (Cnt::kOn) {
    if (active) cnt->draw(need, evals);
  }
}

// One draw of the chain (pallas_schwinger._one_step): n_overrelax
// reflection sweeps, then n_heatbath ExpCos sweeps, each as the 4 groups
// (mu, parity) = (0,0), (0,1), (1,0), (1,1).  Heat-bath group g of sweep
// h reads counters from ((h*4 + g) * k_rej) * 3 on, as the reference
// draws 3 k_rej words for every element of every group.  The block
// design's form: lt is this thread's place in the chain's team of G.
// cnt, where given, counts the heat-bath draws.
template <class Cnt = NoCount>
__device__ __forceinline__ void sweep_step_team(
    float* T, float* X, int Mx, int Mt, int lt, int G, uint32_t seed1,
    const ChainWords& cw, uint32_t step, float beta, int n_overrelax,
    int n_heatbath, int k_rej, Cnt* cnt = nullptr) {
  for (int o = 0; o < n_overrelax; ++o) {
    for (int g = 0; g < 4; ++g) {
      const int mu = g >> 1;
      const int parity = g & 1;
      const int n = group_size(mu, parity, Mx, Mt);
      float* L = mu == 0 ? T : X;
      GridWalk w(lt, G, group_len(mu, parity, Mt));
      for (int k = lt; k < n; k += G, w.next()) {
        const LaneLink l = block_link(mu, parity, w, Mx, Mt);
        float tp, tm;
        link_staples(T, X, mu, l, &tp, &tm);
        L[l.s] = mod_2pi(tp + tm - L[l.s]);
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
      const int len = group_len(mu, parity, Mt);
      float* L = mu == 0 ? T : X;
      const int W = lanes_per_item(G, n);
      if (n == 0) {
        // an empty group (a field one link wide)
      } else if (W > 1) {
        // fewer links than threads: W lanes a link run its rounds W at a
        // time (one link at most a lane)
        const int q = lt & (W - 1);
        const bool active = lt / W < n;
        const LaneLink l = block_link(
            mu, parity, GridWalk(active ? lt / W : 0, 0, len), Mx, Mt);
        float tp, tm, tau, shift;
        link_staples(T, X, mu, l, &tp, &tm);
        expcos_shift(tp, tm, beta, &tau, &shift);
        const float sigma = expcos_sigma(tau);
        const StreamUniform uni{
            step_base(site_hash(seed1, (uint32_t)l.s), step), cw};
        const auto round = [&](int r, float* prop) {
          return expcos_round(uni, ctr0, r, tau, sigma, prop);
        };
        float x;
        if (first_accepted(round, k_rej, W, q, active, &x, cnt) && q == 0)
          L[l.s] = mod_2pi(x + shift);
      } else if (n <= G) {
        pooled_heatbath_link(T, X, L, mu, parity, lt, n, len, Mx, Mt, seed1,
                             cw, step, ctr0, beta, k_rej, cnt);
      } else {
        // the thread's links one round at a time: a link that accepts (or
        // runs out of rounds) hands the next round to the next link
        GridWalk w(lt, G, len);
        int k = lt, r = 0, s = 0;
        float tau = 0.0f, shift = 0.0f, sigma = 0.0f;
        uint32_t base_s = 0u;
        bool fresh = true;  // at a new link
        while (k < n) {
          if (fresh) {
            const LaneLink l = block_link(mu, parity, w, Mx, Mt);
            float tp, tm;
            link_staples(T, X, mu, l, &tp, &tm);
            expcos_shift(tp, tm, beta, &tau, &shift);
            sigma = expcos_sigma(tau);
            base_s = step_base(site_hash(seed1, (uint32_t)l.s), step);
            s = l.s;
            r = 0;
            fresh = false;
          }
          float prop = 0.0f;
          const bool ok =
              r < k_rej &&
              expcos_round(StreamUniform{base_s, cw}, ctr0, r, tau, sigma,
                           &prop);
          if (ok) L[s] = mod_2pi(prop + shift);
          if (ok || ++r >= k_rej) {
            // rounds run one at a time: the accepting one not yet in r
            if constexpr (Cnt::kOn) cnt->draw(ok ? r + 1 : r, ok ? r + 1 : r);
            k += G;
            w.next();
            fresh = true;
          }
        }
      }
      __syncthreads();
    }
  }
}

// slots a thread sums in team_sum, at most: P / G <= TEAM_SLOTS
constexpr int TEAM_SLOTS = 8;

// whether G threads a chain and cpb chains a block is a block-design
// launch for a chain of n sites or cells: a chain a block, G a power of
// two from 64 (a smaller share of a warp is the warp design's) to P =
// min(1024, next_pow2(n)), and at least P / TEAM_SLOTS
__host__ __device__ inline bool team_layout_ok(int G, int cpb, int n) {
  int P = 1;
  while (P < n && P < 1024) P <<= 1;
  return cpb == 1 && G >= 64 && (G & (G - 1)) == 0 && G <= P &&
         G * TEAM_SLOTS >= P;
}

// team_sum's slots k and k + 4 of a thread (base its first), added; an
// absent slot (past the thread's m) is +0
template <int K, class Slot>
__device__ __forceinline__ void slot_pair(const Slot& slot, int base, int G,
                                          int m, int k, float (&o)[K]) {
  float b[K];
#pragma unroll
  for (int x = 0; x < K; ++x) {
    o[x] = 0.0f;
    b[x] = 0.0f;
  }
  if (k < m) slot(base + G * k, o);
  if (k + 4 < m) slot(base + G * (k + 4), b);
#pragma unroll
  for (int x = 0; x < K; ++x) o[x] = o[x] + b[x];
}

// The chain's sums of K values over P slots (the threads a chain of the
// earlier block design), every thread of the team of G (G <= P <=
// TEAM_SLOTS G) getting them, in the order of rng.cuh chain_sum's tree over
// P threads, which adds the highest bit of the slot index first.  Thread
// lt = 32 w + l takes slots w + (G/32) l + G k, k < P/G: the slot index's
// highest bits are k, then l, then w.  So the thread adds its slots in
// pairs at distance 4, 2, 1 (an absent slot is +0, which leaves a sum's
// bits as they are: a slot's sum starts at +0 and never holds -0), then
// the butterfly over the lanes (offsets 16 .. 1), then, through shared
// memory, the butterfly over the warps (offsets G/64 .. 1), which every
// warp takes.  slot(sl, v) adds slot sl's values to v, in the earlier
// design's order.  red: two buffers of K G/32 floats, used in turn (rb
// flips), so one barrier a call suffices: a thread writes a buffer only
// after the barrier of the call that followed its last read of it.  The
// barrier also follows every read slot() makes.
template <int K, class Slot>
__device__ __forceinline__ void team_sum(float (&v)[K], float* red, int& rb,
                                         int lt, int G, int P,
                                         const Slot& slot) {
  const int nw = G >> 5;
  const int w = lt >> 5;
  const int lane = lt & 31;
  const int base = w + nw * lane;
  const int m = P / G;
  float s0[K], s1[K], t[K];
  slot_pair(slot, base, G, m, 0, s0);
  slot_pair(slot, base, G, m, 2, t);
#pragma unroll
  for (int x = 0; x < K; ++x) s0[x] = s0[x] + t[x];
  slot_pair(slot, base, G, m, 1, s1);
  slot_pair(slot, base, G, m, 3, t);
#pragma unroll
  for (int x = 0; x < K; ++x) {
    s1[x] = s1[x] + t[x];
    v[x] = s0[x] + s1[x];
  }
#pragma unroll
  for (int x = 0; x < K; ++x) v[x] = lanes_sum(v[x], 32);
  float* buf = red + rb * K * nw;
  rb ^= 1;
  if (lane == 0) {
#pragma unroll
    for (int x = 0; x < K; ++x) buf[x * nw + w] = v[x];
  }
  __syncthreads();
#pragma unroll
  for (int x = 0; x < K; ++x) {
    float u = lane < nw ? buf[x * nw + lane] : 0.0f;
    for (int off = nw >> 1; off > 0; off >>= 1)
      u += __shfl_xor_sync(0xffffffffu, u, off);
    v[x] = __shfl_sync(0xffffffffu, u, 0);
  }
}

// team_sum's slot of the plaquette sums: mod_2pi(theta_P) and
// cos(theta_P) at the sites sl, sl + P, ... in that order
struct PlaquetteSlot {
  const float* T;
  const float* X;
  int Mx, Mt, P;

  __device__ __forceinline__ void operator()(int sl, float (&v)[2]) const {
    GridWalk w(sl, P, Mt);
    for (int s = sl; s < Mx * Mt; s += P, w.next()) {
      const int ip = w.c + 1 == Mt ? 0 : w.c + 1;
      const int jp = w.r + 1 == Mx ? 0 : w.r + 1;
      const float p =
          mod_2pi(T[s] + X[w.r * Mt + ip] - T[jp * Mt + w.c] - X[s]);
      v[0] += p;
      v[1] += cosf(p);
    }
  }
};

}  // namespace mlmc
