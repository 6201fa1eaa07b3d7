// Fused two-level MLMC chain of the quenched Schwinger model (the fine
// level of the main path).
//
// Replaces: mlmcpathintegral_tpu/ops/pallas_schwinger_twolevel.py
// schwinger_twolevel_chain (_twolevel_kernel, prolongate_fill,
// _bessel_draw, _approx_bessel_draw, _expcos_fill_draw, s_fine, s_cond,
// s_cond_approx, s_coarse, restrict_comps, q_topological, kernel_log_i0).
//
// Per step s, with stream index base = s (t_sub + 1):
//   t_sub coarse heat-bath sweeps (streams base + t) emitting the coarse
//   Q and energy traces;
//   prolongate + 3-step conditioned fill (stream base + t_sub): per coarse
//   cell the words u_t, u_x, the BesselProduct rounds (4 words each, 2 in
//   the small-beta branch; or 3 words of the beta > 8 Gaussian mixture),
//   u, then the two ExpCos fills at 3 k_rej_fill words each; a cell whose
//   truncated rejection fails force-rejects its chain's move;
//   the three-term dS Metropolis test with the uniform of cell (0, 0);
//   Y = (Q_f^2 - Q_c^2) / 4 pi^2 and the accept bit.
//
// What bounds it on the H100: latency of a long dependent chain per step
// (t_sub x 8 quarter-sweeps, three fill phases, four per-chain reductions)
// with data-dependent rejection loops; the fields are 128 + 32 floats per
// chain at the 8x8 headline, so neither bandwidth nor shared memory is
// scarce.  A chain keeps its fine field, trial field, coarse field,
// restricted coarse field and counter-word table (TWOLEVEL_WORDS words) in
// its slice of shared memory for the whole launch.
//
// The warp design (up to 64 coarse cells): a chain on one warp, or on an
// aligned power-of-two share of one, two lanes a site or cell (lanes =
// min(32, next_pow2(2 n))), __syncwarp() between phases, shuffle
// butterflies for the sums (cell c on lane c, in the order of the
// block-wide tree, so with its bits), and lanes a phase leaves idle run
// rejection rounds ahead: four a link in the coarse sweeps, two a cell in
// the BesselProduct draws, the two ExpCos fills of all cells side by side
// (schwinger_sweep.cuh first_accepted); the halves of the warp share a
// cell's cosines in phase D.  A larger field takes a block a chain, one
// cell a thread, with __syncthreads() and the shared-memory tree.  The special functions
// are the Abramowitz-Stegun forms of the reference kernel so the
// arithmetic matches its plain version.

#include <cuda_runtime.h>

#include "schwinger_sweep.cuh"

namespace mlmc {

struct TwoLevelArgs {
  int C, Mxc, Mtc, n_steps, t_sub, n_overrelax_c, n_heatbath_c, k_rej,
      k_rej_fill, k_rej_bessel, exact, small_beta, n_alpha;
  float beta, beta_c, two_beta, two_L, sigma_beta, sigma_half;
  uint32_t seed1, seed2;
  uint32_t chain0;  // global index of the launch's first chain
  int lanes, cpb;
};

__constant__ float I0_SMALL[7] = {1.0f, 3.5156229f, 3.0899424f, 1.2067492f,
                                  0.2659732f, 0.0360768f, 0.0045813f};
__constant__ float I0_LARGE[9] = {0.39894228f,  0.01328592f, 0.00225319f,
                                  -0.00157565f, 0.00916281f, -0.02057706f,
                                  0.02635537f,  -0.01647633f, 0.00392377f};

// log I0(x), A&S 9.8.1/9.8.2 (pallas_schwinger_twolevel.kernel_log_i0)
__device__ __forceinline__ float kernel_log_i0(float x) {
  const float z = fabsf(x);
  const float y = z / 3.75f;
  const float t2 = y * y;
  float ps = 0.0f;
  for (int k = 6; k >= 0; --k) ps = ps * t2 + I0_SMALL[k];
  const float zs = fmaxf(z, 3.75f);
  const float u = 3.75f / zs;
  float pl = 0.0f;
  for (int k = 8; k >= 0; --k) pl = pl * u + I0_LARGE[k];
  if (z < 3.75f) return logf(ps);
  return zs - 0.5f * logf(zs) + logf(pl);
}

// The per-draw constants of the BesselProduct two-piece Gaussian-envelope
// rejection (pallas_schwinger_twolevel._bessel_draw)
struct BesselSetup {
  float sign, dx, log_C_p, log_C_m, p_right;
};

__device__ __forceinline__ BesselSetup bessel_setup(float x_p, float x_m,
                                                    const TwoLevelArgs& a) {
  BesselSetup b;
  const float dx0 = x_m - x_p;
  b.sign = dx0 < 0.0f ? -1.0f : 1.0f;
  b.dx = fabsf(dx0);
  const float dm = b.dx - TWO_PI_F;
  b.log_C_p = a.two_L * (1.0f - b.dx * b.dx * FOURPI2_INV_F);
  b.log_C_m = a.two_L * (1.0f - dm * dm * FOURPI2_INV_F);
  const float d = fminf(fmaxf(b.log_C_p - b.log_C_m, -60.0f), 60.0f);
  b.p_right = 1.0f / (1.0f + expf(-d));
  return b;
}

// Round r of the BesselProduct draw (words from ctr0 + 1: 2 a round in
// the small-beta branch, 4 otherwise): writes the proposal, returns whether
// it is accepted
template <class Uniform>
__device__ __forceinline__ bool bessel_round(const Uniform& uni,
                                             uint32_t ctr0, int r,
                                             const BesselSetup& b,
                                             const TwoLevelArgs& a,
                                             float* prop_out) {
  float prop, log_rho, xi;
  bool in_interval = true;
  if (a.small_beta) {
    const uint32_t c = ctr0 + 2u * (uint32_t)r;
    prop = PI_F * (2.0f * uni(c + 1u) - 1.0f);
    log_rho = kernel_log_i0(a.two_beta * cosf(0.5f * prop)) +
              kernel_log_i0(a.two_beta * cosf(0.5f * (prop - b.dx))) -
              a.two_L;
    xi = uni(c + 2u);
  } else {
    const uint32_t c = ctr0 + 4u * (uint32_t)r;
    const bool right = uni(c + 1u) < b.p_right;
    const float mu = right ? 0.5f * b.dx : 0.5f * b.dx - PI_F;
    const float a_min = right ? -PI_F + b.dx : -PI_F;
    const float a_max = right ? PI_F : -PI_F + b.dx;
    const float log_C = right ? b.log_C_p : b.log_C_m;
    prop = mu + a.sigma_half * box_muller(uni(c + 2u), uni(c + 3u));
    in_interval = prop >= a_min && prop < a_max;
    const float u = (prop - mu) / a.sigma_beta;
    log_rho = kernel_log_i0(a.two_beta * cosf(0.5f * prop)) +
              kernel_log_i0(a.two_beta * cosf(0.5f * (prop - b.dx))) -
              log_C + u * u;
    xi = uni(c + 4u);
  }
  *prop_out = prop;
  return in_interval && logf(xi) <= log_rho;
}

// A coarse cell c = (J, I) with its neighbours (J, I+1) and (J+1, I) on
// the periodic coarse grid (nb's reads) and its counter hash
struct Cell {
  int c, r, d;
  uint32_t h;
};

__device__ __forceinline__ Cell cell_at(int c, int Mxc, int Mtc,
                                        uint32_t seed1) {
  const int J = c / Mtc, I = c - J * Mtc;
  Cell x;
  x.c = c;
  x.r = J * Mtc + (I + 1 >= Mtc ? I + 1 - Mtc : I + 1);
  x.d = (J + 1 >= Mxc ? J + 1 - Mxc : J + 1) * Mtc + I;
  x.h = site_hash(seed1, (uint32_t)c);
  return x;
}

// x_p - x_m folded to [0, pi] with its sign (_approx_fold)
__device__ __forceinline__ void approx_fold(float x0, float* x0f,
                                            float* sign) {
  float s = x0 < 0.0f ? -1.0f : 1.0f;
  x0 = fabsf(x0);
  if (x0 > PI_F) {
    s = -s;
    x0 = TWO_PI_F - x0;
  }
  *x0f = x0;
  *sign = s;
}

// (N_p, s2p, s2m) of the large-beta mixture (_approx_params)
__device__ __forceinline__ void approx_params(float x0, float beta,
                                              float* N_p, float* s2p,
                                              float* s2m) {
  const float eps = 0.125f * PI_F;
  const float sp = x0 < eps ? beta : beta * cosf(0.25f * x0);
  const float sm_raw = beta * sinf(0.25f * x0);
  const float sm_c = fmaxf(sm_raw, 1e-20f);
  const float log_rho =
      1.5f * (logf(sp) - logf(sm_c)) - 4.0f * (sp - sm_raw);
  *N_p = x0 < eps ? 1.0f
                  : 1.0f / (1.0f + expf(fminf(fmaxf(log_rho, -60.0f),
                                              60.0f)));
  *s2p = sp;
  *s2m = x0 < eps ? 0.0f : sm_raw;
}

// large-beta Gaussian-mixture draw (_approx_bessel_draw), 3 words
template <class Uniform>
__device__ __forceinline__ float approx_bessel_draw(const Uniform& uni,
                                                    uint32_t ctr0, float x_p,
                                                    float x_m, float beta) {
  float x0, sign, N_p, s2p, s2m;
  approx_fold(x_p - x_m, &x0, &sign);
  approx_params(x0, beta, &N_p, &s2p, &s2m);
  const bool is_main = uni(ctr0 + 1u) <= N_p;
  const float sigma = is_main ? rsqrtf(s2p) : rsqrtf(fmaxf(s2m, 1e-20f));
  const float xshift = is_main ? 0.0f : PI_F;
  const float x =
      sigma * box_muller(uni(ctr0 + 2u), uni(ctr0 + 3u)) + 0.5f * x0 - xshift;
  return mod_2pi(sign * x + x_m);
}

// log of the mixture density with 9 periodic copies (_approx_log_eval)
__device__ __forceinline__ float approx_log_eval(float x, float x_p,
                                                 float x_m, float beta) {
  float x0, sign, N_p, s2p, s2m;
  approx_fold(x_p - x_m, &x0, &sign);
  const float z = sign * (x - x_m);
  approx_params(x0, beta, &N_p, &s2p, &s2m);
  float s_p = 0.0f, s_m = 0.0f;
  for (int k = -4; k <= 4; ++k) {
    float zs = z - 0.5f * x0 + (float)(2.0 * k * 3.141592653589793);
    s_p = s_p + sqrtf(s2p) * expf(-0.5f * s2p * zs * zs);
    zs = zs + PI_F;
    s_m = s_m + sqrtf(fmaxf(s2m, 0.0f)) * expf(-0.5f * s2m * zs * zs);
  }
  const float dens =
      0.3989422804014327f * (N_p * s_p + (1.0f - N_p) * s_m);
  return logf(fmaxf(dens, 1e-30f));
}

// log p(x | tp, tm) of ExpCos (_expcos_log_eval)
__device__ __forceinline__ float expcos_log_eval(float x, float beta,
                                                 float tp, float tm) {
  const float sigma = 2.0f * beta * fabsf(cosf(0.5f * (tp - tm)));
  const float s = beta * (cosf(x - tp) + cosf(x - tm));
  return s - 1.8378770664093453f - kernel_log_i0(sigma);
}

// component planes of a field: k = mu*4 + a*2 + b holds link mu at fine
// site (j, i) = (2J + a, 2I + b) of coarse cell (J, I)
enum { T00 = 0, T01, T10, T11, X00, X01, X10, X11 };

template <bool kWarp>
__global__ void __launch_bounds__(kWarp ? 128 : 1024)
    schwinger_twolevel_kernel(
        const float* __restrict__ fine_in,
        const float* __restrict__ coarse_in,
        const float* __restrict__ sf_in, const float* __restrict__ sq_in,
        float* __restrict__ fine_out, float* __restrict__ coarse_out,
        float* __restrict__ sf_out, float* __restrict__ sq_out,
        float* __restrict__ y_out, float* __restrict__ qc_out,
        float* __restrict__ ec_out, float* __restrict__ acc_out,
        const float* __restrict__ alphas, TwoLevelArgs a) {
  extern __shared__ float smem[];
  const int Mxc = a.Mxc, Mtc = a.Mtc;
  const int n = Mxc * Mtc;
  const int Mt = 2 * Mtc;
  const int G = a.lanes;
  const int lc = threadIdx.x / G;
  const int lt = threadIdx.x & (G - 1);
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < a.C;
  const uint32_t ch = a.chain0 + (uint32_t)chain;
  const int slice = TWOLEVEL_WORDS + 20 * n;
  float* mine = smem + (size_t)lc * slice;
  float* F = mine + TWOLEVEL_WORDS;  // current fine components [8][n]
  float* Tr = F + 8 * n;             // trial components [8][n]
  float* Tc = Tr + 8 * n;            // coarse links [n]
  float* Xc = Tc + n;
  float* Rc = Xc + n;                // restrict(current) [2][n]
  float* red = smem + (size_t)a.cpb * slice;
  // lanes holding the chain's cells for the sums; this chain's lanes
  const int P = min(G, pow2_ceil(n));
  const unsigned chain_mask =
      G >= 32 ? 0xffffffffu
              : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));

  const ChainWords cw =
      chain_words(reinterpret_cast<uint32_t*>(mine), TWOLEVEL_WORDS, a.seed2,
                  ch, lt, G);
  // load: fine index ((j*Mt + i)*2 + mu), coarse ((J*Mtc + I)*2 + mu)
  for (int c = lt; c < n; c += G) {
    const int J = c / Mtc, I = c - (c / Mtc) * Mtc;
    for (int k = 0; k < 8; ++k) {
      const int mu = k >> 2, ja = (k >> 1) & 1, ib = k & 1;
      const size_t o = (size_t)chain * 8 * n +
                       (size_t)(((2 * J + ja) * Mt + 2 * I + ib) * 2 + mu);
      F[k * n + c] = valid ? fine_in[o] : 0.0f;
    }
    Tc[c] = valid ? coarse_in[(size_t)chain * 2 * n + 2 * c] : 0.0f;
    Xc[c] = valid ? coarse_in[(size_t)chain * 2 * n + 2 * c + 1] : 0.0f;
  }
  float S_f = valid ? sf_in[chain] : 0.0f;
  float S_q = valid ? sq_in[chain] : 0.0f;
  chain_sync<kWarp>();

  // counters of the fill stream
  const uint32_t n_bessel = a.exact ? (a.small_beta ? 2u : 4u) *
                                          (uint32_t)a.k_rej_bessel
                                    : 3u;
  const uint32_t ctr_u = 2u + n_bessel + 1u;
  const uint32_t ctr_e = ctr_u;                    // T10 words after u
  const uint32_t ctr_o = ctr_e + 3u * (uint32_t)a.k_rej_fill;
  const uint32_t ctr_acc = ctr_o + 3u * (uint32_t)a.k_rej_fill + 1u;
  // lanes a cell in the BesselProduct draws (phase B), and a draw in the
  // ExpCos fills (phase C, two draws a cell); the first item of this lane
  // in each phase, fixed for the launch: its cell in A (its own), B, C and
  // in the sums of D and E (lane mod P)
  const int W_b = lanes_per_item(G, n);
  const int W_e = lanes_per_item(G, 2 * n);
  const int q_b = lt & (W_b - 1), q_e = lt & (W_e - 1);
  const int kB = lt / W_b, kC = lt / W_e, kD = lt & (P - 1);
  const Cell cA = cell_at(lt < n ? lt : 0, Mxc, Mtc, a.seed1);
  const Cell cB = cell_at(kB < n ? kB : 0, Mxc, Mtc, a.seed1);
  const Cell cC = cell_at(kC < n ? kC : (kC < 2 * n ? kC - n : 0), Mxc,
                          Mtc, a.seed1);
  const Cell cD = cell_at(kD < n ? kD : 0, Mxc, Mtc, a.seed1);
  // the warp design's coarse links and plaquettes of this lane
  LaneLinks ll;
  LanePlaq pl;
  if constexpr (kWarp) {
    ll = lane_links(lt, G, Mxc, Mtc, a.seed1);
    pl = lane_plaq(kD, P, Mxc, Mtc);
  }

  for (int s = 0; s < a.n_steps; ++s) {
    const uint32_t base = (uint32_t)s * (uint32_t)(a.t_sub + 1);

    // ---- t_sub coarse heat-bath sweeps + per-sweep traces ----
    for (int t = 0; t < a.t_sub; ++t) {
      float v[2];
      if constexpr (kWarp) {
        sweep_step_warp(Tc, Xc, ll, cw, base + (uint32_t)t, a.beta_c,
                        a.n_overrelax_c, a.n_heatbath_c, a.k_rej);
        plaquette_sums_warp(Tc, Xc, pl, &v[0], &v[1]);
      } else {
        sweep_step_block(Tc, Xc, Mxc, Mtc, lt, G, a.seed1, cw,
                         base + (uint32_t)t, a.beta_c, a.n_overrelax_c,
                         a.n_heatbath_c, a.k_rej);
        plaquette_sums(Tc, Xc, Mxc, Mtc, lt, P, &v[0], &v[1]);
      }
      chain_reduce<kWarp>(v, red, G, P);
      if (valid && lt == 0) {
        const size_t o = (size_t)(s * a.t_sub + t) * a.C + chain;
        qc_out[o] = v[0];
        ec_out[o] = v[1];
      }
      chain_sync<kWarp>();
    }
    const uint32_t stp = base + (uint32_t)a.t_sub;
    bool failed = false;
    // ---- A: prolongate + perimeter randomisation; restrict(current) ----
    for (int k = lt; k < n; k += G) {
      const Cell cl = k == lt ? cA : cell_at(k, Mxc, Mtc, a.seed1);
      const int c = cl.c;
      const StreamUniform uni{step_base(cl.h, stp), cw};
      const float u_t = PI_F * (2.0f * uni(1u) - 1.0f);
      const float u_x = PI_F * (2.0f * uni(2u) - 1.0f);
      Tr[T00 * n + c] = mod_2pi(0.5f * Tc[c] + u_t);
      Tr[T01 * n + c] = mod_2pi(0.5f * Tc[c] - u_t);
      Tr[X00 * n + c] = mod_2pi(0.5f * Xc[c] + u_x);
      Tr[X10 * n + c] = mod_2pi(0.5f * Xc[c] - u_x);
      Rc[c] = mod_2pi(F[T00 * n + c] + F[T01 * n + c]);
      Rc[n + c] = mod_2pi(F[X00 * n + c] + F[X10 * n + c]);
    }
    chain_sync<kWarp>();

    // ---- B: interior vertical links (sum from BesselProduct), W_b lanes
    // a cell running its rounds ahead ----
    // every lane runs the same passes (first_accepted is warp-wide)
    for (int k0 = 0; k0 < n; k0 += G / W_b) {
      const int k = k0 + kB;
      const bool active = k < n;
      const Cell cl =
          k0 == 0 ? cB : cell_at(active ? k : 0, Mxc, Mtc, a.seed1);
      const int c = cl.c;
      const StreamUniform uni{step_base(cl.h, stp), cw};
      const float t00 = Tr[T00 * n + c], t01 = Tr[T01 * n + c];
      const float x00 = Tr[X00 * n + c], x10 = Tr[X10 * n + c];
      const float theta_p = mod_2pi(t01 + Tr[X00 * n + cl.r] +
                                    Tr[X10 * n + cl.r] - Tr[T01 * n + cl.d]);
      const float theta_m = mod_2pi(x00 + x10 + Tr[T00 * n + cl.d] - t00);
      float tt;
      if (a.exact) {
        const BesselSetup bs = bessel_setup(theta_p, theta_m, a);
        const auto round = [&](int r, float* prop) {
          return bessel_round(uni, 2u, r, bs, a, prop);
        };
        float x;
        if (!first_accepted(round, a.k_rej_bessel, W_b, q_b, active, &x) &&
            active)
          failed = true;
        tt = mod_2pi(bs.sign * x + theta_p);
      } else {
        tt = approx_bessel_draw(uni, 2u, theta_p, theta_m, a.beta);
      }
      if (active && q_b == 0) {
        const float u = PI_F * (2.0f * uni(ctr_u) - 1.0f);
        Tr[X01 * n + c] = mod_2pi(0.5f * tt + u);
        Tr[X11 * n + c] = mod_2pi(0.5f * tt - u);
      }
    }
    chain_sync<kWarp>();

    // ---- C: interior horizontal links from ExpCos: draw d < n is cell
    // d's T10, draw d >= n cell d - n's T11, W_e lanes a draw ----
    for (int d0 = 0; d0 < 2 * n; d0 += G / W_e) {
      const int d = d0 + kC;
      const bool active = d < 2 * n;
      const bool odd = d >= n;
      const Cell cl = d0 == 0 ? cC
                              : cell_at(!active ? 0 : (odd ? d - n : d), Mxc,
                                        Mtc, a.seed1);
      const int c = cl.c;
      const StreamUniform uni{step_base(cl.h, stp), cw};
      float tp, tm;
      if (!odd) {
        tp = mod_2pi(Tr[T00 * n + c] + Tr[X01 * n + c] - Tr[X00 * n + c]);
        tm = mod_2pi(Tr[X10 * n + c] + Tr[T00 * n + cl.d] -
                     Tr[X11 * n + c]);
      } else {
        tp = mod_2pi(Tr[T01 * n + c] + Tr[X00 * n + cl.r] -
                     Tr[X01 * n + c]);
        tm = mod_2pi(Tr[X11 * n + c] + Tr[T01 * n + cl.d] -
                     Tr[X10 * n + cl.r]);
      }
      float tau, shift;
      expcos_shift(tp, tm, a.beta, &tau, &shift);
      const float sigma = expcos_sigma(tau);
      const uint32_t ctr0 = odd ? ctr_o : ctr_e;
      const auto round = [&](int r, float* prop) {
        return expcos_round(uni, ctr0, r, tau, sigma, prop);
      };
      float x;
      if (!first_accepted(round, a.k_rej_fill, W_e, q_e, active, &x) &&
          active)
        failed = true;
      if (active && q_e == 0)
        Tr[(odd ? T11 : T10) * n + c] = mod_2pi(x + shift);
    }
    // a cell whose truncated rejection found no draw force-rejects
    bool any_failed;
    if constexpr (kWarp) {
      any_failed = (__ballot_sync(0xffffffffu, failed) & chain_mask) != 0u;
    } else {
      any_failed = __syncthreads_or(failed) != 0;
    }
    chain_sync<kWarp>();

    // ---- D: the three dS terms ----
    float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (kWarp && a.exact && 2 * P <= G) {
      // twice the lanes the cells need: lanes l and l + P share cell
      // l's cosines, each taking one of every pair in the same instruction
      // and the other by a shuffle, then both add them in the reference
      // order (the same bits in both halves)
      const int h = (lt & P) != 0;
      const Cell& cl = cD;
      const int c = cl.c;
      const float t00 = Tr[T00 * n + c], t01 = Tr[T01 * n + c];
      const float t10 = Tr[T10 * n + c], t11 = Tr[T11 * n + c];
      const float x00 = Tr[X00 * n + c], x01 = Tr[X01 * n + c];
      const float x10 = Tr[X10 * n + c], x11 = Tr[X11 * n + c];
      const float sx00 = Tr[X00 * n + cl.r];
      const float sx10 = Tr[X10 * n + cl.r];
      const float st00 = Tr[T00 * n + cl.d];
      const float st01 = Tr[T01 * n + cl.d];
      const float P00 = t00 + x01 - t10 - x00;
      const float P01 = t01 + sx00 - t11 - x01;
      const float P10 = t10 + x11 - st00 - x10;
      const float P11 = t11 + sx10 - st01 - x11;
      const float Pr = Rc[c] + Rc[n + cl.r] - Rc[cl.d] - Rc[n + c];
      const float Pc = Tc[c] + Xc[cl.r] - Tc[cl.d] - Xc[c];
      const float phi_12 = x10 + st00;
      const float phi_23 = st01 - sx10;
      const float phi_34 = -t01 - sx00;
      const float phi_41 = -t00 + x00;
      const float th_1 = t10, th_2 = -x11, th_3 = -t11, th_4 = x01;
      const float Phi = phi_12 + phi_23 + phi_34 + phi_41;
      // cos of (lo, hi): this lane's in one instruction, the other's by
      // the shuffle
      const auto cos_pair = [&](float lo, float hi, float* c_lo,
                                float* c_hi) {
        const float own = cosf(h ? hi : lo);
        const float other = __shfl_xor_sync(0xffffffffu, own, P);
        *c_lo = h ? other : own;
        *c_hi = h ? own : other;
      };
      float c00, c01, c10, c11, cr, cc, k1, k2, k3, k4;
      cos_pair(P00, P01, &c00, &c01);
      cos_pair(P10, P11, &c10, &c11);
      cos_pair(Pr, Pc, &cr, &cc);
      cos_pair(th_1 - th_2 - phi_12, th_2 - th_3 - phi_23, &k1, &k2);
      cos_pair(th_3 - th_4 - phi_34, th_4 - th_1 - phi_41, &k3, &k4);
      float series = 1.0f;
      for (int m = 0; m < a.n_alpha; m += 2) {
        float ce, co;
        cos_pair((float)(m + 1) * Phi, (float)(m + 2) * Phi, &ce, &co);
        series = series + alphas[m] * ce;
        if (m + 1 < a.n_alpha) series = series + alphas[m + 1] * co;
      }
      if (kD < n) {
        v[0] += (1.0f - c00) + (1.0f - c01) + (1.0f - c10) + (1.0f - c11);
        v[1] += 1.0f - cr;
        v[2] += 1.0f - cc;
        v[3] += k1 + k2 + k3 + k4;
        v[4] += logf(series);
      }
    } else {
      for (int k = kD; k < n; k += P) {
        const Cell cl = k == kD ? cD : cell_at(k, Mxc, Mtc, a.seed1);
        const int c = cl.c;
        const float t00 = Tr[T00 * n + c], t01 = Tr[T01 * n + c];
        const float t10 = Tr[T10 * n + c], t11 = Tr[T11 * n + c];
        const float x00 = Tr[X00 * n + c], x01 = Tr[X01 * n + c];
        const float x10 = Tr[X10 * n + c], x11 = Tr[X11 * n + c];
        const float sx00 = Tr[X00 * n + cl.r];
        const float sx10 = Tr[X10 * n + cl.r];
        const float st00 = Tr[T00 * n + cl.d];
        const float st01 = Tr[T01 * n + cl.d];
        // s_fine of the trial: the four sub-plaquettes of the cell
        const float P00 = t00 + x01 - t10 - x00;
        const float P01 = t01 + sx00 - t11 - x01;
        const float P10 = t10 + x11 - st00 - x10;
        const float P11 = t11 + sx10 - st01 - x11;
        v[0] += (1.0f - cosf(P00)) + (1.0f - cosf(P01)) +
                (1.0f - cosf(P10)) + (1.0f - cosf(P11));
        // s_coarse of restrict(current) and of the coarse state
        const float Pr = Rc[c] + Rc[n + cl.r] - Rc[cl.d] - Rc[n + c];
        const float Pc = Tc[c] + Xc[cl.r] - Tc[cl.d] - Xc[c];
        v[1] += 1.0f - cosf(Pr);
        v[2] += 1.0f - cosf(Pc);
        if (a.exact) {
          // s_cond: plaquette staples + log of the normalisation series
          const float phi_12 = x10 + st00;
          const float phi_23 = st01 - sx10;
          const float phi_34 = -t01 - sx00;
          const float phi_41 = -t00 + x00;
          const float th_1 = t10, th_2 = -x11, th_3 = -t11, th_4 = x01;
          const float Phi = phi_12 + phi_23 + phi_34 + phi_41;
          v[3] += cosf(th_1 - th_2 - phi_12) + cosf(th_2 - th_3 - phi_23) +
                  cosf(th_3 - th_4 - phi_34) + cosf(th_4 - th_1 - phi_41);
          float series = 1.0f;
          for (int m = 0; m < a.n_alpha; ++m)
            series = series + alphas[m] * cosf((float)(m + 1) * Phi);
          v[4] += logf(series);
        } else {
          // s_cond_approx: vertical-sum mixture + horizontal ExpCos terms
          const float theta_p = mod_2pi(t01 + sx00 + sx10 - st01);
          const float theta_m = mod_2pi(x00 + x10 + st00 - t00);
          const float th_v = mod_2pi(x01 + x11);
          v[3] += approx_log_eval(th_v, theta_p, theta_m, a.beta);
          const float tp_e = mod_2pi(t00 + x01 - x00);
          const float tm_e = mod_2pi(x10 + st00 - x11);
          const float tp_o = mod_2pi(t01 + sx00 - x01);
          const float tm_o = mod_2pi(x11 + st01 - sx10);
          v[4] += expcos_log_eval(t10, a.beta, tp_e, tm_e) +
                  expcos_log_eval(t11, a.beta, tp_o, tm_o);
        }
      }
    }
    chain_reduce<kWarp>(v, red, G, P);
    const float S_f_trial = a.beta * v[0];
    const float dS_coarse = a.beta_c * v[1] - a.beta_c * v[2];
    const float S_q_trial = a.exact ? -a.beta * v[3] + v[4] : -v[3] - v[4];
    const float dS = (S_f_trial - S_f) + dS_coarse + (S_q - S_q_trial);
    const StreamUniform uni0{step_base(site_hash(a.seed1, 0u), stp), cw};
    const float u_acc = uni0(ctr_acc);
    const bool accept = !any_failed && (dS < 0.0f || u_acc < expf(-dS));
    if (accept) {
      for (int c = lt; c < n; c += G)
        for (int k = 0; k < 8; ++k) F[k * n + c] = Tr[k * n + c];
      S_f = S_f_trial;
      S_q = S_q_trial;
    }
    chain_sync<kWarp>();

    // ---- E: Y = (Q_f^2 - Q_c^2) / 4 pi^2 ----
    float w[2] = {0.0f, 0.0f};
    for (int k = kD; k < n; k += P) {
      const Cell cl = k == kD ? cD : cell_at(k, Mxc, Mtc, a.seed1);
      const int c = cl.c;
      const float t00 = F[T00 * n + c], t01 = F[T01 * n + c];
      const float t10 = F[T10 * n + c], t11 = F[T11 * n + c];
      const float x00 = F[X00 * n + c], x01 = F[X01 * n + c];
      const float x10 = F[X10 * n + c], x11 = F[X11 * n + c];
      w[0] += mod_2pi(t00 + x01 - t10 - x00) +
              mod_2pi(t01 + F[X00 * n + cl.r] - t11 - x01) +
              mod_2pi(t10 + x11 - F[T00 * n + cl.d] - x10) +
              mod_2pi(t11 + F[X10 * n + cl.r] - F[T01 * n + cl.d] - x11);
      w[1] += mod_2pi(Tc[c] + Xc[cl.r] - Tc[cl.d] - Xc[c]);
    }
    chain_reduce<kWarp>(w, red, G, P);
    if (valid && lt == 0) {
      y_out[(size_t)s * a.C + chain] =
          FOURPI2_INV_F * (w[0] * w[0] - w[1] * w[1]);
      acc_out[(size_t)s * a.C + chain] = accept ? 1.0f : 0.0f;
    }
    // the next step's sweeps write the coarse links E read
    chain_sync<kWarp>();
  }

  if (valid) {
    for (int c = lt; c < n; c += G) {
      const int J = c / Mtc, I = c - (c / Mtc) * Mtc;
      for (int k = 0; k < 8; ++k) {
        const int mu = k >> 2, ja = (k >> 1) & 1, ib = k & 1;
        fine_out[(size_t)chain * 8 * n +
                 (size_t)(((2 * J + ja) * Mt + 2 * I + ib) * 2 + mu)] =
            F[k * n + c];
      }
      coarse_out[(size_t)chain * 2 * n + 2 * c] = Tc[c];
      coarse_out[(size_t)chain * 2 * n + 2 * c + 1] = Xc[c];
    }
    if (lt == 0) {
      sf_out[chain] = S_f;
      sq_out[chain] = S_q;
    }
  }
}

template <bool kWarp>
cudaError_t allow_twolevel_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(schwinger_twolevel_kernel<kWarp>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace mlmc

// fine: [C, 2*Mt*Mx], coarse: [C, 2*Mt*Mx/4], caches [C]; outputs as the
// Pallas kernel: fine', coarse', S_fine', S_cond', y [n_steps, C],
// qc/ec [n_steps*t_sub, C], acc [n_steps, C]; all f32, inputs and outputs
// distinct.  alphas: n_alpha rescaled series coefficients (exact branch).
// lanes per chain (a power of two: <= 32 the warp design, else the block's
// threads), cpb chains per block, smem bytes of dynamic shared memory.
// chain0: the global index of the launch's chain 0, which the chain words
// hash.
extern "C" int mlmc_schwinger_twolevel(
    const float* fine_in, const float* coarse_in, const float* sf_in,
    const float* sq_in, float* fine_out, float* coarse_out, float* sf_out,
    float* sq_out, float* y, float* qc, float* ec, float* acc,
    const float* alphas, int n_alpha, int C, int Mx, int Mt, int n_steps,
    int t_sub, int n_overrelax_c, int n_heatbath_c, int k_rej,
    int k_rej_fill, int k_rej_bessel, int exact, int small_beta, float beta,
    float beta_c, float two_L, float sigma_beta, float sigma_half,
    uint32_t seed1, uint32_t seed2, uint32_t chain0, int lanes, int cpb,
    size_t smem, void* stream) {
  mlmc::TwoLevelArgs a{C,          Mx / 2,       Mt / 2,       n_steps,
                       t_sub,      n_overrelax_c, n_heatbath_c, k_rej,
                       k_rej_fill, k_rej_bessel, exact,        small_beta,
                       n_alpha,    beta,         beta_c,       2.0f * beta,
                       two_L,      sigma_beta,   sigma_half,   seed1,
                       seed2,      chain0,       lanes,        cpb};
  const int blocks = (C + cpb - 1) / cpb;
  cudaError_t e;
  if (lanes <= 32) {
    e = mlmc::allow_twolevel_smem<true>(smem);
    if (e != cudaSuccess) return (int)e;
    mlmc::schwinger_twolevel_kernel<true><<<blocks, lanes * cpb, smem,
                                            (cudaStream_t)stream>>>(
        fine_in, coarse_in, sf_in, sq_in, fine_out, coarse_out, sf_out,
        sq_out, y, qc, ec, acc, alphas, a);
  } else {
    e = mlmc::allow_twolevel_smem<false>(smem);
    if (e != cudaSuccess) return (int)e;
    mlmc::schwinger_twolevel_kernel<false><<<blocks, lanes * cpb, smem,
                                             (cudaStream_t)stream>>>(
        fine_in, coarse_in, sf_in, sq_in, fine_out, coarse_out, sf_out,
        sq_out, y, qc, ec, acc, alphas, a);
  }
  return (int)cudaGetLastError();
}

// Registers a thread, local (spilled) bytes a thread and resident blocks
// an SM of the launch with these threads and shared bytes (the warp design
// when warp != 0): out[0..2].
extern "C" int mlmc_schwinger_twolevel_attrs(int threads, size_t smem,
                                             int warp, int* out) {
  cudaFuncAttributes fa{};
  cudaError_t e;
  if (warp) {
    e = cudaFuncGetAttributes(&fa, mlmc::schwinger_twolevel_kernel<true>);
    if (e == cudaSuccess) e = mlmc::allow_twolevel_smem<true>(smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[2], mlmc::schwinger_twolevel_kernel<true>, threads, smem);
  } else {
    e = cudaFuncGetAttributes(&fa, mlmc::schwinger_twolevel_kernel<false>);
    if (e == cudaSuccess) e = mlmc::allow_twolevel_smem<false>(smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[2], mlmc::schwinger_twolevel_kernel<false>, threads, smem);
  }
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return (int)e;
}
