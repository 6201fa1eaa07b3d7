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
// cell's cosines in phase D.  A larger field takes the block design
// (schwinger_twolevel_team_kernel): a chain on a team of 64 to 512
// threads, a block a chain, several chains an SM when the launch has
// many.  The special functions are the Abramowitz-Stegun forms of the
// reference kernel so the arithmetic matches its plain version.
//
// The counted instantiations (kCount, launched where rounds != nullptr,
// while the program records) also count the three rejection loops, the
// coarse heat bath, the BesselProduct draws and the ExpCos fill: draws,
// rounds needed and rounds evaluated each (schwinger_sweep.cuh RegCount),
// summed by each warp and added to rounds[3 loop + count] at the end.
// Their draws and outputs are the uncounted kernel's.  This header holds
// the kernels; schwinger_twolevel.cu instantiates the uncounted kernels
// and schwinger_twolevel_counted.cu the counted ones, so nvcc builds the
// two side by side.

#pragma once

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

static __constant__ float I0_SMALL[7] = {
    1.0f, 3.5156229f, 3.0899424f, 1.2067492f,
    0.2659732f, 0.0360768f, 0.0045813f};
static __constant__ float I0_LARGE[9] = {
    0.39894228f, 0.01328592f, 0.00225319f,
    -0.00157565f, 0.00916281f, -0.02057706f,
    0.02635537f, -0.01647633f, 0.00392377f};

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

__device__ __forceinline__ Cell cell_of(int J, int I, int Mxc, int Mtc,
                                        uint32_t seed1) {
  Cell x;
  x.c = J * Mtc + I;
  x.r = J * Mtc + (I + 1 >= Mtc ? I + 1 - Mtc : I + 1);
  x.d = (J + 1 >= Mxc ? J + 1 - Mxc : J + 1) * Mtc + I;
  x.h = site_hash(seed1, (uint32_t)x.c);
  return x;
}

__device__ __forceinline__ Cell cell_at(int c, int Mxc, int Mtc,
                                        uint32_t seed1) {
  const int J = c / Mtc;
  return cell_of(J, c - J * Mtc, Mxc, Mtc, seed1);
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

// A chain's slice of shared memory: its counter-word table, then its
// current fine components [8][n], trial components [8][n], coarse links
// [n] + [n] and restrict(current) [2][n]
struct TwoLevelSlice {
  float *F, *Tr, *Tc, *Xc, *Rc;
};

__device__ __forceinline__ TwoLevelSlice twolevel_slice(float* mine,
                                                        int n) {
  TwoLevelSlice f;
  f.F = mine + TWOLEVEL_WORDS;
  f.Tr = f.F + 8 * n;
  f.Tc = f.Tr + 8 * n;
  f.Xc = f.Tc + n;
  f.Rc = f.Xc + n;
  return f;
}

// a chain's fields into its slice (zeros for a block's chain past C):
// fine index ((j*Mt + i)*2 + mu), coarse ((J*Mtc + I)*2 + mu)
__device__ __forceinline__ void load_fields(const TwoLevelSlice& f,
                                            const float* fine_in,
                                            const float* coarse_in,
                                            int chain, bool valid, int Mtc,
                                            int n, int lt, int G) {
  const int Mt = 2 * Mtc;
  for (int c = lt; c < n; c += G) {
    const int J = c / Mtc, I = c - (c / Mtc) * Mtc;
    for (int k = 0; k < 8; ++k) {
      const int mu = k >> 2, ja = (k >> 1) & 1, ib = k & 1;
      const size_t o = (size_t)chain * 8 * n +
                       (size_t)(((2 * J + ja) * Mt + 2 * I + ib) * 2 + mu);
      f.F[k * n + c] = valid ? fine_in[o] : 0.0f;
    }
    f.Tc[c] = valid ? coarse_in[(size_t)chain * 2 * n + 2 * c] : 0.0f;
    f.Xc[c] = valid ? coarse_in[(size_t)chain * 2 * n + 2 * c + 1] : 0.0f;
  }
}

__device__ __forceinline__ void store_fields(const TwoLevelSlice& f,
                                             float* fine_out,
                                             float* coarse_out, int chain,
                                             int Mtc, int n, int lt, int G) {
  const int Mt = 2 * Mtc;
  for (int c = lt; c < n; c += G) {
    const int J = c / Mtc, I = c - (c / Mtc) * Mtc;
    for (int k = 0; k < 8; ++k) {
      const int mu = k >> 2, ja = (k >> 1) & 1, ib = k & 1;
      fine_out[(size_t)chain * 8 * n +
               (size_t)(((2 * J + ja) * Mt + 2 * I + ib) * 2 + mu)] =
          f.F[k * n + c];
    }
    coarse_out[(size_t)chain * 2 * n + 2 * c] = f.Tc[c];
    coarse_out[(size_t)chain * 2 * n + 2 * c + 1] = f.Xc[c];
  }
}

// counters of the fill stream: u of phase B, the T10 (e) and T11 (o)
// ExpCos fills of phase C, the accept uniform
struct FillCounters {
  uint32_t u, e, o, acc;
};

__device__ __forceinline__ FillCounters fill_counters(const TwoLevelArgs& a) {
  const uint32_t n_bessel = a.exact ? (a.small_beta ? 2u : 4u) *
                                          (uint32_t)a.k_rej_bessel
                                    : 3u;
  FillCounters k;
  k.u = 2u + n_bessel + 1u;
  k.e = k.u;  // T10 words after u
  k.o = k.e + 3u * (uint32_t)a.k_rej_fill;
  k.acc = k.o + 3u * (uint32_t)a.k_rej_fill + 1u;
  return k;
}

// A: cell c's trial perimeter links (prolongate + randomisation, words 1
// and 2) and restrict(current)
__device__ __forceinline__ void perimeter_fill(const TwoLevelSlice& f,
                                               int n, int c,
                                               const StreamUniform& uni) {
  const float u_t = PI_F * (2.0f * uni(1u) - 1.0f);
  const float u_x = PI_F * (2.0f * uni(2u) - 1.0f);
  f.Tr[T00 * n + c] = mod_2pi(0.5f * f.Tc[c] + u_t);
  f.Tr[T01 * n + c] = mod_2pi(0.5f * f.Tc[c] - u_t);
  f.Tr[X00 * n + c] = mod_2pi(0.5f * f.Xc[c] + u_x);
  f.Tr[X10 * n + c] = mod_2pi(0.5f * f.Xc[c] - u_x);
  f.Rc[c] = mod_2pi(f.F[T00 * n + c] + f.F[T01 * n + c]);
  f.Rc[n + c] = mod_2pi(f.F[X00 * n + c] + f.F[X10 * n + c]);
}

// B: the staples of a cell's interior vertical links' sum
__device__ __forceinline__ void vertical_staples(const float* Tr, int n,
                                                 const Cell& cl,
                                                 float* theta_p,
                                                 float* theta_m) {
  const int c = cl.c;
  *theta_p = mod_2pi(Tr[T01 * n + c] + Tr[X00 * n + cl.r] +
                     Tr[X10 * n + cl.r] - Tr[T01 * n + cl.d]);
  *theta_m = mod_2pi(Tr[X00 * n + c] + Tr[X10 * n + c] +
                     Tr[T00 * n + cl.d] - Tr[T00 * n + c]);
}

// B: the vertical links from their sum tt and the word u
__device__ __forceinline__ void vertical_split(float* Tr, int n, int c,
                                               float tt,
                                               const StreamUniform& uni,
                                               uint32_t ctr_u) {
  const float u = PI_F * (2.0f * uni(ctr_u) - 1.0f);
  Tr[X01 * n + c] = mod_2pi(0.5f * tt + u);
  Tr[X11 * n + c] = mod_2pi(0.5f * tt - u);
}

// C: the staples of a cell's T10 (even) or T11 (odd) ExpCos draw
__device__ __forceinline__ void horizontal_staples(const float* Tr, int n,
                                                   const Cell& cl, bool odd,
                                                   float* tp, float* tm) {
  const int c = cl.c;
  if (!odd) {
    *tp = mod_2pi(Tr[T00 * n + c] + Tr[X01 * n + c] - Tr[X00 * n + c]);
    *tm = mod_2pi(Tr[X10 * n + c] + Tr[T00 * n + cl.d] - Tr[X11 * n + c]);
  } else {
    *tp = mod_2pi(Tr[T01 * n + c] + Tr[X00 * n + cl.r] - Tr[X01 * n + c]);
    *tm = mod_2pi(Tr[X11 * n + c] + Tr[T01 * n + cl.d] -
                  Tr[X10 * n + cl.r]);
  }
}

// D: a cell's five dS terms, added to v: s_fine of the trial, s_coarse of
// restrict(current) and of the coarse state, s_cond (the plaquette
// staples and the log of the normalisation series, or the approximate
// fill's two terms)
__device__ __forceinline__ void ds_terms(const TwoLevelSlice& f, int n,
                                         const Cell& cl,
                                         const TwoLevelArgs& a,
                                         const float* alphas,
                                         float (&v)[5]) {
  const float* Tr = f.Tr;
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
  v[0] += (1.0f - cosf(P00)) + (1.0f - cosf(P01)) + (1.0f - cosf(P10)) +
          (1.0f - cosf(P11));
  // s_coarse of restrict(current) and of the coarse state
  const float Pr = f.Rc[c] + f.Rc[n + cl.r] - f.Rc[cl.d] - f.Rc[n + c];
  const float Pc = f.Tc[c] + f.Xc[cl.r] - f.Tc[cl.d] - f.Xc[c];
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

// E: a cell's four fine charges (field Fs) and its coarse charge, added
// to w
__device__ __forceinline__ void charge_terms(const float* Fs,
                                             const float* Tc,
                                             const float* Xc, int n,
                                             const Cell& cl,
                                             float (&w)[2]) {
  const int c = cl.c;
  const float t00 = Fs[T00 * n + c], t01 = Fs[T01 * n + c];
  const float t10 = Fs[T10 * n + c], t11 = Fs[T11 * n + c];
  const float x00 = Fs[X00 * n + c], x01 = Fs[X01 * n + c];
  const float x10 = Fs[X10 * n + c], x11 = Fs[X11 * n + c];
  w[0] += mod_2pi(t00 + x01 - t10 - x00) +
          mod_2pi(t01 + Fs[X00 * n + cl.r] - t11 - x01) +
          mod_2pi(t10 + x11 - Fs[T00 * n + cl.d] - x10) +
          mod_2pi(t11 + Fs[X10 * n + cl.r] - Fs[T01 * n + cl.d] - x11);
  w[1] += mod_2pi(Tc[c] + Xc[cl.r] - Tc[cl.d] - Xc[c]);
}

// The three-term dS Metropolis test of the trial from the chain's D sums
// (the uniform of cell (0, 0)); a cell whose truncated rejection found no
// draw force-rejects
struct TrialTest {
  float S_f, S_q;
  bool accept;
};

__device__ __forceinline__ TrialTest trial_test(const float (&v)[5],
                                                float S_f, float S_q,
                                                bool any_failed,
                                                const TwoLevelArgs& a,
                                                const ChainWords& cw,
                                                uint32_t stp,
                                                uint32_t ctr_acc) {
  TrialTest t;
  t.S_f = a.beta * v[0];
  const float dS_coarse = a.beta_c * v[1] - a.beta_c * v[2];
  t.S_q = a.exact ? -a.beta * v[3] + v[4] : -v[3] - v[4];
  const float dS = (t.S_f - S_f) + dS_coarse + (S_q - t.S_q);
  const StreamUniform uni0{step_base(site_hash(a.seed1, 0u), stp), cw};
  const float u_acc = uni0(ctr_acc);
  t.accept = !any_failed && (dS < 0.0f || u_acc < expf(-dS));
  return t;
}

// the three loops' counts of a launch into rounds[0..8], a row a loop
template <class Cnt>
__device__ __forceinline__ void flush_loops(const Cnt& hb, const Cnt& bes,
                                            const Cnt& fill, bool valid,
                                            unsigned long long* rounds) {
  if constexpr (Cnt::kOn) {
    flush_counts(hb, valid, rounds);
    flush_counts(bes, valid, rounds + 3);
    flush_counts(fill, valid, rounds + 6);
  }
}

// The warp design (coarse grids up to 64 cells): a chain on one warp or
// an aligned share of one
template <bool kCount>
__global__ void __launch_bounds__(128)
    schwinger_twolevel_kernel(
        const float* __restrict__ fine_in,
        const float* __restrict__ coarse_in,
        const float* __restrict__ sf_in, const float* __restrict__ sq_in,
        float* __restrict__ fine_out, float* __restrict__ coarse_out,
        float* __restrict__ sf_out, float* __restrict__ sq_out,
        float* __restrict__ y_out, float* __restrict__ qc_out,
        float* __restrict__ ec_out, float* __restrict__ acc_out,
        const float* __restrict__ alphas, unsigned long long* rounds,
        TwoLevelArgs a) {
  extern __shared__ float smem[];
  const int Mxc = a.Mxc, Mtc = a.Mtc;
  const int n = Mxc * Mtc;
  const int G = a.lanes;
  const int lc = threadIdx.x / G;
  const int lt = threadIdx.x & (G - 1);
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < a.C;
  const uint32_t ch = a.chain0 + (uint32_t)chain;
  const int slice = TWOLEVEL_WORDS + 20 * n;
  float* mine = smem + (size_t)lc * slice;
  const TwoLevelSlice f = twolevel_slice(mine, n);
  float* Tr = f.Tr;
  const float* Tc = f.Tc;
  const float* Xc = f.Xc;
  // lanes holding the chain's cells for the sums; this chain's lanes
  const int P = min(G, pow2_ceil(n));
  const unsigned chain_mask =
      G >= 32 ? 0xffffffffu
              : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));

  const ChainWords cw =
      chain_words(reinterpret_cast<uint32_t*>(mine), TWOLEVEL_WORDS, a.seed2,
                  ch, lt, G);
  load_fields(f, fine_in, coarse_in, chain, valid, Mtc, n, lt, G);
  float S_f = valid ? sf_in[chain] : 0.0f;
  float S_q = valid ? sq_in[chain] : 0.0f;
  __syncwarp();

  const FillCounters ctr = fill_counters(a);
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
  // the coarse links and plaquettes of this lane
  const LaneLinks ll = lane_links(lt, G, Mxc, Mtc, a.seed1);
  const LanePlaq pl = lane_plaq(kD, P, Mxc, Mtc);
  // the counters of the coarse heat bath, BesselProduct draws and fill
  std::conditional_t<kCount, RegCount, NoCount> c_hb, c_bes, c_fill;

  for (int s = 0; s < a.n_steps; ++s) {
    const uint32_t base = (uint32_t)s * (uint32_t)(a.t_sub + 1);

    // ---- t_sub coarse heat-bath sweeps + per-sweep traces ----
    for (int t = 0; t < a.t_sub; ++t) {
      float v[2];
      sweep_step_warp(f.Tc, f.Xc, ll, cw, base + (uint32_t)t, a.beta_c,
                      a.n_overrelax_c, a.n_heatbath_c, a.k_rej, &c_hb);
      plaquette_sums_warp(Tc, Xc, pl, &v[0], &v[1]);
      warp_reduce(v, P);
      if (valid && lt == 0) {
        const size_t o = (size_t)(s * a.t_sub + t) * a.C + chain;
        qc_out[o] = v[0];
        ec_out[o] = v[1];
      }
      __syncwarp();
    }
    const uint32_t stp = base + (uint32_t)a.t_sub;
    bool failed = false;
    // ---- A: prolongate + perimeter randomisation; restrict(current) ----
    for (int k = lt; k < n; k += G) {
      const Cell cl = k == lt ? cA : cell_at(k, Mxc, Mtc, a.seed1);
      perimeter_fill(f, n, cl.c, StreamUniform{step_base(cl.h, stp), cw});
    }
    __syncwarp();

    // ---- B: interior vertical links (sum from BesselProduct), W_b lanes
    // a cell running its rounds ahead ----
    // every lane runs the same passes (first_accepted is warp-wide)
    for (int k0 = 0; k0 < n; k0 += G / W_b) {
      const int k = k0 + kB;
      const bool active = k < n;
      const Cell cl =
          k0 == 0 ? cB : cell_at(active ? k : 0, Mxc, Mtc, a.seed1);
      const StreamUniform uni{step_base(cl.h, stp), cw};
      float theta_p, theta_m;
      vertical_staples(Tr, n, cl, &theta_p, &theta_m);
      float tt;
      if (a.exact) {
        const BesselSetup bs = bessel_setup(theta_p, theta_m, a);
        const auto round = [&](int r, float* prop) {
          return bessel_round(uni, 2u, r, bs, a, prop);
        };
        float x;
        if (!first_accepted(round, a.k_rej_bessel, W_b, q_b, active, &x,
                            &c_bes) &&
            active)
          failed = true;
        tt = mod_2pi(bs.sign * x + theta_p);
      } else {
        tt = approx_bessel_draw(uni, 2u, theta_p, theta_m, a.beta);
      }
      if (active && q_b == 0) vertical_split(Tr, n, cl.c, tt, uni, ctr.u);
    }
    __syncwarp();

    // ---- C: interior horizontal links from ExpCos: draw d < n is cell
    // d's T10, draw d >= n cell d - n's T11, W_e lanes a draw ----
    for (int d0 = 0; d0 < 2 * n; d0 += G / W_e) {
      const int d = d0 + kC;
      const bool active = d < 2 * n;
      const bool odd = d >= n;
      const Cell cl = d0 == 0 ? cC
                              : cell_at(!active ? 0 : (odd ? d - n : d), Mxc,
                                        Mtc, a.seed1);
      const StreamUniform uni{step_base(cl.h, stp), cw};
      float tp, tm;
      horizontal_staples(Tr, n, cl, odd, &tp, &tm);
      float tau, shift;
      expcos_shift(tp, tm, a.beta, &tau, &shift);
      const float sigma = expcos_sigma(tau);
      const uint32_t ctr0 = odd ? ctr.o : ctr.e;
      const auto round = [&](int r, float* prop) {
        return expcos_round(uni, ctr0, r, tau, sigma, prop);
      };
      float x;
      if (!first_accepted(round, a.k_rej_fill, W_e, q_e, active, &x,
                          &c_fill) &&
          active)
        failed = true;
      if (active && q_e == 0)
        Tr[(odd ? T11 : T10) * n + cl.c] = mod_2pi(x + shift);
    }
    // a cell whose truncated rejection found no draw force-rejects
    const bool any_failed =
        (__ballot_sync(0xffffffffu, failed) & chain_mask) != 0u;
    __syncwarp();

    // ---- D: the three dS terms ----
    float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (a.exact && 2 * P <= G) {
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
      const float* Rc = f.Rc;
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
      for (int k = kD; k < n; k += P)
        ds_terms(f, n, k == kD ? cD : cell_at(k, Mxc, Mtc, a.seed1), a,
                 alphas, v);
    }
    warp_reduce(v, P);
    const TrialTest tr = trial_test(v, S_f, S_q, any_failed, a, cw, stp,
                                    ctr.acc);
    if (tr.accept) {
      for (int c = lt; c < n; c += G)
        for (int k = 0; k < 8; ++k) f.F[k * n + c] = Tr[k * n + c];
      S_f = tr.S_f;
      S_q = tr.S_q;
    }
    __syncwarp();

    // ---- E: Y = (Q_f^2 - Q_c^2) / 4 pi^2 ----
    float w[2] = {0.0f, 0.0f};
    for (int k = kD; k < n; k += P)
      charge_terms(f.F, Tc, Xc, n,
                   k == kD ? cD : cell_at(k, Mxc, Mtc, a.seed1), w);
    warp_reduce(w, P);
    if (valid && lt == 0) {
      y_out[(size_t)s * a.C + chain] =
          FOURPI2_INV_F * (w[0] * w[0] - w[1] * w[1]);
      acc_out[(size_t)s * a.C + chain] = tr.accept ? 1.0f : 0.0f;
    }
    // the next step's sweeps write the coarse links E read
    __syncwarp();
  }

  if (valid) {
    store_fields(f, fine_out, coarse_out, chain, Mtc, n, lt, G);
    if (lt == 0) {
      sf_out[chain] = S_f;
      sq_out[chain] = S_q;
    }
  }
  flush_loops(c_hb, c_bes, c_fill, valid, rounds);
}

// team_sum's slot of phase D: the dS terms of the cells sl, sl + P, ...
struct DsSlot {
  const TwoLevelSlice& f;
  const TwoLevelArgs& a;
  const float* alphas;
  int P;

  __device__ __forceinline__ void operator()(int sl, float (&v)[5]) const {
    const int n = a.Mxc * a.Mtc;
    GridWalk w(sl, P, a.Mtc);
    for (int k = sl; k < n; k += P, w.next())
      ds_terms(f, n, cell_of(w.r, w.c, a.Mxc, a.Mtc, 0u), a, alphas, v);
  }
};

// team_sum's slot of phase E: the charges of the cells sl, sl + P, ...
struct ChargeSlot {
  const float* Fs;
  const TwoLevelSlice& f;
  const TwoLevelArgs& a;
  int P;

  __device__ __forceinline__ void operator()(int sl, float (&w)[2]) const {
    const int n = a.Mxc * a.Mtc;
    GridWalk wk(sl, P, a.Mtc);
    for (int k = sl; k < n; k += P, wk.next())
      charge_terms(Fs, f.Tc, f.Xc, n, cell_of(wk.r, wk.c, a.Mxc, a.Mtc, 0u),
                   w);
  }
};

// The block design (coarse grids beyond 64 cells): a chain on a team of G
// threads, a block a chain (schwinger_sweep.cuh, the block design).  A
// thread takes the cells lt, lt + G, ... in phases A, B and C, walked
// without a division; its BesselProduct draws (B) and the two ExpCos
// draws of each of its cells (C, independent: neither reads T10 or T11)
// run their rejection rounds interleaved; the coarse traces and the D and
// E sums add in the order of the one-cell-a-thread tree (team_sum, one
// barrier each).  E reads the state the step ends in (the trial where it
// was accepted, beside its copy to F), so no barrier waits for the copy.
template <bool kCount>
__global__ void __launch_bounds__(1024)
    schwinger_twolevel_team_kernel(
        const float* __restrict__ fine_in,
        const float* __restrict__ coarse_in,
        const float* __restrict__ sf_in, const float* __restrict__ sq_in,
        float* __restrict__ fine_out, float* __restrict__ coarse_out,
        float* __restrict__ sf_out, float* __restrict__ sq_out,
        float* __restrict__ y_out, float* __restrict__ qc_out,
        float* __restrict__ ec_out, float* __restrict__ acc_out,
        const float* __restrict__ alphas, unsigned long long* rounds,
        TwoLevelArgs a) {
  extern __shared__ float smem[];
  const int Mxc = a.Mxc, Mtc = a.Mtc;
  const int n = Mxc * Mtc;
  const int G = a.lanes;
  const int lt = threadIdx.x;
  const int chain = blockIdx.x;
  const bool valid = chain < a.C;
  const TwoLevelSlice f = twolevel_slice(smem, n);
  float* Tr = f.Tr;
  float* red = smem + TWOLEVEL_WORDS + 20 * n;
  // the sums' slots: the threads a chain of the one-cell-a-thread tree
  const int P = min(1024, pow2_ceil(n));
  int rb = 0;  // team_sum's buffer

  const ChainWords cw =
      chain_words(reinterpret_cast<uint32_t*>(smem), TWOLEVEL_WORDS, a.seed2,
                  a.chain0 + (uint32_t)chain, lt, G);
  load_fields(f, fine_in, coarse_in, chain, valid, Mtc, n, lt, G);
  float S_f = valid ? sf_in[chain] : 0.0f;
  float S_q = valid ? sq_in[chain] : 0.0f;
  __syncthreads();
  const FillCounters ctr = fill_counters(a);
  using Cnt = std::conditional_t<kCount, RegCount, NoCount>;
  Cnt c_hb, c_bes, c_fill;  // as in the warp design

  for (int s = 0; s < a.n_steps; ++s) {
    const uint32_t base = (uint32_t)s * (uint32_t)(a.t_sub + 1);

    // ---- t_sub coarse heat-bath sweeps + per-sweep traces ----
    for (int t = 0; t < a.t_sub; ++t) {
      sweep_step_team(f.Tc, f.Xc, Mxc, Mtc, lt, G, a.seed1, cw,
                      base + (uint32_t)t, a.beta_c, a.n_overrelax_c,
                      a.n_heatbath_c, a.k_rej, &c_hb);
      float v[2];
      team_sum(v, red, rb, lt, G, P,
               PlaquetteSlot{f.Tc, f.Xc, Mxc, Mtc, P});
      if (valid && lt == 0) {
        const size_t o = (size_t)(s * a.t_sub + t) * a.C + chain;
        qc_out[o] = v[0];
        ec_out[o] = v[1];
      }
    }
    const uint32_t stp = base + (uint32_t)a.t_sub;
    bool failed = false;
    // ---- A: prolongate + perimeter randomisation; restrict(current) ----
    {
      GridWalk w(lt, G, Mtc);
      for (int k = lt; k < n; k += G, w.next()) {
        const Cell cl = cell_of(w.r, w.c, Mxc, Mtc, a.seed1);
        perimeter_fill(f, n, cl.c, StreamUniform{step_base(cl.h, stp), cw});
      }
    }
    __syncthreads();

    // ---- B: interior vertical links (sum from BesselProduct) ----
    if (a.exact) {
      // the thread's cells one round at a time
      GridWalk w(lt, G, Mtc);
      int k = lt, r = 0;
      Cell cl{};
      float theta_p = 0.0f;
      BesselSetup bs{};
      uint32_t base_s = 0u;
      bool fresh = true;  // at a new cell
      while (k < n) {
        if (fresh) {
          cl = cell_of(w.r, w.c, Mxc, Mtc, a.seed1);
          float theta_m;
          vertical_staples(Tr, n, cl, &theta_p, &theta_m);
          bs = bessel_setup(theta_p, theta_m, a);
          base_s = step_base(cl.h, stp);
          r = 0;
          fresh = false;
        }
        const StreamUniform uni{base_s, cw};
        float prop = 0.0f;
        const bool ok =
            r < a.k_rej_bessel && bessel_round(uni, 2u, r, bs, a, &prop);
        if (ok || ++r >= a.k_rej_bessel) {
          // rounds run one at a time: the accepting one not yet in r
          if constexpr (Cnt::kOn) c_bes.draw(ok ? r + 1 : r, ok ? r + 1 : r);
          if (!ok) failed = true;
          vertical_split(Tr, n, cl.c,
                         mod_2pi(bs.sign * (ok ? prop : 0.0f) + theta_p),
                         uni, ctr.u);
          k += G;
          w.next();
          fresh = true;
        }
      }
    } else {
      GridWalk w(lt, G, Mtc);
      for (int k = lt; k < n; k += G, w.next()) {
        const Cell cl = cell_of(w.r, w.c, Mxc, Mtc, a.seed1);
        const StreamUniform uni{step_base(cl.h, stp), cw};
        float theta_p, theta_m;
        vertical_staples(Tr, n, cl, &theta_p, &theta_m);
        vertical_split(Tr, n, cl.c,
                       approx_bessel_draw(uni, 2u, theta_p, theta_m, a.beta),
                       uni, ctr.u);
      }
    }
    __syncthreads();

    // ---- C: interior horizontal links from ExpCos: the T10 (even) and
    // T11 (odd) draws of each of the thread's cells, one round at a time
    {
      GridWalk w(lt, G, Mtc);
      int k = lt, r = 0;
      bool odd = false, fresh = true;
      Cell cl{};
      float tau = 0.0f, shift = 0.0f, sigma = 0.0f;
      uint32_t base_s = 0u;
      while (k < n) {
        if (fresh) {
          if (!odd) {
            cl = cell_of(w.r, w.c, Mxc, Mtc, a.seed1);
            base_s = step_base(cl.h, stp);
          }
          float tp, tm;
          horizontal_staples(Tr, n, cl, odd, &tp, &tm);
          expcos_shift(tp, tm, a.beta, &tau, &shift);
          sigma = expcos_sigma(tau);
          r = 0;
          fresh = false;
        }
        float prop = 0.0f;
        const bool ok = r < a.k_rej_fill &&
                        expcos_round(StreamUniform{base_s, cw},
                                     odd ? ctr.o : ctr.e, r, tau, sigma,
                                     &prop);
        if (ok || ++r >= a.k_rej_fill) {
          if constexpr (Cnt::kOn) c_fill.draw(ok ? r + 1 : r, ok ? r + 1 : r);
          if (!ok) failed = true;
          Tr[(odd ? T11 : T10) * n + cl.c] =
              mod_2pi((ok ? prop : 0.0f) + shift);
          if (odd) {
            k += G;
            w.next();
          }
          odd = !odd;
          fresh = true;
        }
      }
    }
    // a cell whose truncated rejection found no draw force-rejects
    const bool any_failed = __syncthreads_or(failed) != 0;

    // ---- D: the three dS terms ----
    float v[5];
    team_sum(v, red, rb, lt, G, P, DsSlot{f, a, alphas, P});
    const TrialTest tr = trial_test(v, S_f, S_q, any_failed, a, cw, stp,
                                    ctr.acc);
    if (tr.accept) {
      for (int c = lt; c < n; c += G)
        for (int k = 0; k < 8; ++k) f.F[k * n + c] = Tr[k * n + c];
      S_f = tr.S_f;
      S_q = tr.S_q;
    }

    // ---- E: Y = (Q_f^2 - Q_c^2) / 4 pi^2 ----
    float w[2];
    team_sum(w, red, rb, lt, G, P,
             ChargeSlot{tr.accept ? Tr : f.F, f, a, P});
    if (valid && lt == 0) {
      y_out[(size_t)s * a.C + chain] =
          FOURPI2_INV_F * (w[0] * w[0] - w[1] * w[1]);
      acc_out[(size_t)s * a.C + chain] = tr.accept ? 1.0f : 0.0f;
    }
  }

  if (valid) {
    store_fields(f, fine_out, coarse_out, chain, Mtc, n, lt, G);
    if (lt == 0) {
      sf_out[chain] = S_f;
      sq_out[chain] = S_q;
    }
  }
  flush_loops(c_hb, c_bes, c_fill, valid, rounds);
}

// the kernel of a launch of G lanes a chain: the warp design up to 32,
// counted or not
using TwoLevelKernel = void (*)(const float*, const float*, const float*,
                                const float*, float*, float*, float*, float*,
                                float*, float*, float*, float*, const float*,
                                unsigned long long*, TwoLevelArgs);

// the counted kernel of the warp design (warp) or of the block design
// (schwinger_twolevel_counted.cu)
TwoLevelKernel twolevel_kernel_counted(bool warp);

inline cudaError_t allow_twolevel_smem(TwoLevelKernel k, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace mlmc
