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
// (t_sub x 8 barriered quarter-sweeps, three barriered fill phases, four
// per-chain reductions) with data-dependent rejection loops; the fields
// are 128 + 32 floats per chain at the 8x8 headline, so neither bandwidth
// nor shared memory is scarce.  The design keeps one chain's fine field,
// trial field, coarse field and restricted coarse field in shared memory
// for the whole launch (20 floats per coarse cell) and gives each coarse
// cell one thread, so the fill's per-cell rejection loops run in parallel;
// the special functions are the Abramowitz-Stegun forms of the reference
// kernel so the arithmetic matches its plain version.

#include <cuda_runtime.h>

#include "schwinger_sweep.cuh"

namespace mlmc {

struct TwoLevelArgs {
  int C, Mxc, Mtc, n_steps, t_sub, n_overrelax_c, n_heatbath_c, k_rej,
      k_rej_fill, k_rej_bessel, exact, small_beta, n_alpha;
  float beta, beta_c, two_beta, two_L, sigma_beta, sigma_half;
  uint32_t seed1, seed2;
  int tpc, cpb;
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

// neighbour A(J + dJ, I + dI) of cell c on the periodic coarse grid
__device__ __forceinline__ float nb(const float* A, int J, int I, int dJ,
                                    int dI, int Mxc, int Mtc) {
  const int jj = J + dJ >= Mxc ? J + dJ - Mxc : J + dJ;
  const int ii = I + dI >= Mtc ? I + dI - Mtc : I + dI;
  return A[jj * Mtc + ii];
}

// BesselProduct two-piece Gaussian-envelope rejection draw, truncated at
// k rounds (pallas_schwinger_twolevel._bessel_draw); words from ctr0 + 1
__device__ __forceinline__ bool bessel_draw(const CounterRng& rng,
                                            uint32_t ctr0, float x_p,
                                            float x_m, const TwoLevelArgs& a,
                                            float* out) {
  const float sb = a.sigma_beta;
  const float dx0 = x_m - x_p;
  const float sign = dx0 < 0.0f ? -1.0f : 1.0f;
  const float dx = fabsf(dx0);
  const float dm = dx - TWO_PI_F;
  const float log_C_p = a.two_L * (1.0f - dx * dx * FOURPI2_INV_F);
  const float log_C_m = a.two_L * (1.0f - dm * dm * FOURPI2_INV_F);
  const float d = fminf(fmaxf(log_C_p - log_C_m, -60.0f), 60.0f);
  const float p_right = 1.0f / (1.0f + expf(-d));
  float x = 0.0f;
  bool acc = false;
  for (int r = 0; r < a.k_rej_bessel && !acc; ++r) {
    float prop, log_rho, xi;
    bool in_interval = true;
    if (a.small_beta) {
      const uint32_t c = ctr0 + 2u * (uint32_t)r;
      prop = PI_F * (2.0f * rng.uniform(c + 1u) - 1.0f);
      log_rho = kernel_log_i0(a.two_beta * cosf(0.5f * prop)) +
                kernel_log_i0(a.two_beta * cosf(0.5f * (prop - dx))) -
                a.two_L;
      xi = rng.uniform(c + 2u);
    } else {
      const uint32_t c = ctr0 + 4u * (uint32_t)r;
      const bool right = rng.uniform(c + 1u) < p_right;
      const float mu = right ? 0.5f * dx : 0.5f * dx - PI_F;
      const float a_min = right ? -PI_F + dx : -PI_F;
      const float a_max = right ? PI_F : -PI_F + dx;
      const float log_C = right ? log_C_p : log_C_m;
      prop = mu + a.sigma_half * rng.normal(c + 2u);
      in_interval = prop >= a_min && prop < a_max;
      const float u = (prop - mu) / sb;
      log_rho = kernel_log_i0(a.two_beta * cosf(0.5f * prop)) +
                kernel_log_i0(a.two_beta * cosf(0.5f * (prop - dx))) -
                log_C + u * u;
      xi = rng.uniform(c + 4u);
    }
    if (in_interval && logf(xi) <= log_rho) {
      x = prop;
      acc = true;
    }
  }
  *out = mod_2pi(sign * x + x_p);
  return acc;
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
__device__ __forceinline__ float approx_bessel_draw(const CounterRng& rng,
                                                    uint32_t ctr0, float x_p,
                                                    float x_m, float beta) {
  float x0, sign, N_p, s2p, s2m;
  approx_fold(x_p - x_m, &x0, &sign);
  approx_params(x0, beta, &N_p, &s2p, &s2m);
  const bool is_main = rng.uniform(ctr0 + 1u) <= N_p;
  const float sigma = is_main ? rsqrtf(s2p) : rsqrtf(fmaxf(s2m, 1e-20f));
  const float xshift = is_main ? 0.0f : PI_F;
  const float x = sigma * rng.normal(ctr0 + 2u) + 0.5f * x0 - xshift;
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

__global__ void schwinger_twolevel_kernel(
    const float* __restrict__ fine_in, const float* __restrict__ coarse_in,
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
  const int lc = threadIdx.x / a.tpc;
  const int lt = threadIdx.x - lc * a.tpc;
  const int chain = blockIdx.x * a.cpb + lc;
  const bool valid = chain < a.C;
  float* F = smem + (size_t)lc * 20 * n;  // current fine components [8][n]
  float* Tr = F + 8 * n;                  // trial components [8][n]
  float* Tc = Tr + 8 * n;                 // coarse links [n]
  float* Xc = Tc + n;
  float* Rc = Xc + n;                     // restrict(current) [2][n]
  float* red = smem + (size_t)a.cpb * 20 * n;

  // load: fine index ((j*Mt + i)*2 + mu), coarse ((J*Mtc + I)*2 + mu)
  for (int c = lt; c < n; c += a.tpc) {
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
  __syncthreads();

  // counters of the fill stream
  const uint32_t n_bessel = a.exact ? (a.small_beta ? 2u : 4u) *
                                          (uint32_t)a.k_rej_bessel
                                    : 3u;
  const uint32_t ctr_u = 2u + n_bessel + 1u;
  const uint32_t ctr_e = ctr_u;                    // T10 words after u
  const uint32_t ctr_o = ctr_e + 3u * (uint32_t)a.k_rej_fill;
  const uint32_t ctr_acc = ctr_o + 3u * (uint32_t)a.k_rej_fill + 1u;

  for (int s = 0; s < a.n_steps; ++s) {
    const uint32_t base = (uint32_t)s * (uint32_t)(a.t_sub + 1);

    // ---- t_sub coarse heat-bath sweeps + per-sweep traces ----
    for (int t = 0; t < a.t_sub; ++t) {
      sweep_step(Tc, Xc, Mxc, Mtc, lt, a.tpc, valid, a.seed1, a.seed2,
                 (uint32_t)chain, base + (uint32_t)t, a.beta_c,
                 a.n_overrelax_c, a.n_heatbath_c, a.k_rej);
      float v[2];
      plaquette_sums(Tc, Xc, Mxc, Mtc, lt, a.tpc, &v[0], &v[1]);
      chain_sum<2>(v, red, a.tpc);
      if (valid && lt == 0) {
        const size_t o = (size_t)(s * a.t_sub + t) * a.C + chain;
        qc_out[o] = v[0];
        ec_out[o] = v[1];
      }
    }
    const uint32_t stp = base + (uint32_t)a.t_sub;
    float fails = 0.0f;

    // ---- A: prolongate + perimeter randomisation; restrict(current) ----
    for (int c = lt; c < n && valid; c += a.tpc) {
      const CounterRng rng(a.seed1, a.seed2, (uint32_t)c, (uint32_t)chain,
                           stp);
      const float u_t = PI_F * (2.0f * rng.uniform(1u) - 1.0f);
      const float u_x = PI_F * (2.0f * rng.uniform(2u) - 1.0f);
      Tr[T00 * n + c] = mod_2pi(0.5f * Tc[c] + u_t);
      Tr[T01 * n + c] = mod_2pi(0.5f * Tc[c] - u_t);
      Tr[X00 * n + c] = mod_2pi(0.5f * Xc[c] + u_x);
      Tr[X10 * n + c] = mod_2pi(0.5f * Xc[c] - u_x);
      Rc[c] = mod_2pi(F[T00 * n + c] + F[T01 * n + c]);
      Rc[n + c] = mod_2pi(F[X00 * n + c] + F[X10 * n + c]);
    }
    __syncthreads();

    // ---- B: interior vertical links (sum from BesselProduct) ----
    for (int c = lt; c < n && valid; c += a.tpc) {
      const int J = c / Mtc, I = c - (c / Mtc) * Mtc;
      const CounterRng rng(a.seed1, a.seed2, (uint32_t)c, (uint32_t)chain,
                           stp);
      const float t00 = Tr[T00 * n + c], t01 = Tr[T01 * n + c];
      const float x00 = Tr[X00 * n + c], x10 = Tr[X10 * n + c];
      const float theta_p =
          mod_2pi(t01 + nb(Tr + X00 * n, J, I, 0, 1, Mxc, Mtc) +
                  nb(Tr + X10 * n, J, I, 0, 1, Mxc, Mtc) -
                  nb(Tr + T01 * n, J, I, 1, 0, Mxc, Mtc));
      const float theta_m =
          mod_2pi(x00 + x10 + nb(Tr + T00 * n, J, I, 1, 0, Mxc, Mtc) - t00);
      float tt;
      if (a.exact) {
        if (!bessel_draw(rng, 2u, theta_p, theta_m, a, &tt)) fails += 1.0f;
      } else {
        tt = approx_bessel_draw(rng, 2u, theta_p, theta_m, a.beta);
      }
      const float u = PI_F * (2.0f * rng.uniform(ctr_u) - 1.0f);
      Tr[X01 * n + c] = mod_2pi(0.5f * tt + u);
      Tr[X11 * n + c] = mod_2pi(0.5f * tt - u);
    }
    __syncthreads();

    // ---- C: interior horizontal links from ExpCos ----
    for (int c = lt; c < n && valid; c += a.tpc) {
      const int J = c / Mtc, I = c - (c / Mtc) * Mtc;
      const CounterRng rng(a.seed1, a.seed2, (uint32_t)c, (uint32_t)chain,
                           stp);
      const float t00 = Tr[T00 * n + c], t01 = Tr[T01 * n + c];
      const float x00 = Tr[X00 * n + c], x01 = Tr[X01 * n + c];
      const float x10 = Tr[X10 * n + c], x11 = Tr[X11 * n + c];
      const float tp_e = mod_2pi(t00 + x01 - x00);
      const float tm_e =
          mod_2pi(x10 + nb(Tr + T00 * n, J, I, 1, 0, Mxc, Mtc) - x11);
      float t10, t11;
      if (!expcos_draw(rng, ctr_e, tp_e, tm_e, a.beta, a.k_rej_fill, &t10))
        fails += 1.0f;
      const float tp_o =
          mod_2pi(t01 + nb(Tr + X00 * n, J, I, 0, 1, Mxc, Mtc) - x01);
      const float tm_o =
          mod_2pi(x11 + nb(Tr + T01 * n, J, I, 1, 0, Mxc, Mtc) -
                  nb(Tr + X10 * n, J, I, 0, 1, Mxc, Mtc));
      if (!expcos_draw(rng, ctr_o, tp_o, tm_o, a.beta, a.k_rej_fill, &t11))
        fails += 1.0f;
      Tr[T10 * n + c] = t10;
      Tr[T11 * n + c] = t11;
    }
    __syncthreads();

    // ---- D: the three dS terms ----
    float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, fails};
    for (int c = lt; c < n && valid; c += a.tpc) {
      const int J = c / Mtc, I = c - (c / Mtc) * Mtc;
      const float t00 = Tr[T00 * n + c], t01 = Tr[T01 * n + c];
      const float t10 = Tr[T10 * n + c], t11 = Tr[T11 * n + c];
      const float x00 = Tr[X00 * n + c], x01 = Tr[X01 * n + c];
      const float x10 = Tr[X10 * n + c], x11 = Tr[X11 * n + c];
      const float sx00 = nb(Tr + X00 * n, J, I, 0, 1, Mxc, Mtc);
      const float sx10 = nb(Tr + X10 * n, J, I, 0, 1, Mxc, Mtc);
      const float st00 = nb(Tr + T00 * n, J, I, 1, 0, Mxc, Mtc);
      const float st01 = nb(Tr + T01 * n, J, I, 1, 0, Mxc, Mtc);
      // s_fine of the trial: the four sub-plaquettes of the cell
      const float P00 = t00 + x01 - t10 - x00;
      const float P01 = t01 + sx00 - t11 - x01;
      const float P10 = t10 + x11 - st00 - x10;
      const float P11 = t11 + sx10 - st01 - x11;
      v[0] += (1.0f - cosf(P00)) + (1.0f - cosf(P01)) + (1.0f - cosf(P10)) +
              (1.0f - cosf(P11));
      // s_coarse of restrict(current) and of the coarse state
      const float Pr = Rc[c] + nb(Rc + n, J, I, 0, 1, Mxc, Mtc) -
                       nb(Rc, J, I, 1, 0, Mxc, Mtc) - Rc[n + c];
      const float Pc = Tc[c] + nb(Xc, J, I, 0, 1, Mxc, Mtc) -
                       nb(Tc, J, I, 1, 0, Mxc, Mtc) - Xc[c];
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
        for (int k = 0; k < a.n_alpha; ++k)
          series = series + alphas[k] * cosf((float)(k + 1) * Phi);
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
    chain_sum<6>(v, red, a.tpc);
    const float S_f_trial = a.beta * v[0];
    const float dS_coarse = a.beta_c * v[1] - a.beta_c * v[2];
    const float S_q_trial = a.exact ? -a.beta * v[3] + v[4] : -v[3] - v[4];
    const float dS = (S_f_trial - S_f) + dS_coarse + (S_q - S_q_trial);
    const CounterRng rng0(a.seed1, a.seed2, 0u, (uint32_t)chain, stp);
    const float u_acc = rng0.uniform(ctr_acc);
    const bool accept = v[5] == 0.0f && (dS < 0.0f || u_acc < expf(-dS));
    if (accept) {
      for (int c = lt; c < n && valid; c += a.tpc)
        for (int k = 0; k < 8; ++k) F[k * n + c] = Tr[k * n + c];
      S_f = S_f_trial;
      S_q = S_q_trial;
    }
    __syncthreads();

    // ---- E: Y = (Q_f^2 - Q_c^2) / 4 pi^2 ----
    float w[2] = {0.0f, 0.0f};
    for (int c = lt; c < n && valid; c += a.tpc) {
      const int J = c / Mtc, I = c - (c / Mtc) * Mtc;
      const float t00 = F[T00 * n + c], t01 = F[T01 * n + c];
      const float t10 = F[T10 * n + c], t11 = F[T11 * n + c];
      const float x00 = F[X00 * n + c], x01 = F[X01 * n + c];
      const float x10 = F[X10 * n + c], x11 = F[X11 * n + c];
      w[0] += mod_2pi(t00 + x01 - t10 - x00) +
              mod_2pi(t01 + nb(F + X00 * n, J, I, 0, 1, Mxc, Mtc) - t11 -
                      x01) +
              mod_2pi(t10 + x11 - nb(F + T00 * n, J, I, 1, 0, Mxc, Mtc) -
                      x10) +
              mod_2pi(t11 + nb(F + X10 * n, J, I, 0, 1, Mxc, Mtc) -
                      nb(F + T01 * n, J, I, 1, 0, Mxc, Mtc) - x11);
      w[1] += mod_2pi(Tc[c] + nb(Xc, J, I, 0, 1, Mxc, Mtc) -
                      nb(Tc, J, I, 1, 0, Mxc, Mtc) - Xc[c]);
    }
    chain_sum<2>(w, red, a.tpc);
    if (valid && lt == 0) {
      y_out[(size_t)s * a.C + chain] =
          FOURPI2_INV_F * (w[0] * w[0] - w[1] * w[1]);
      acc_out[(size_t)s * a.C + chain] = accept ? 1.0f : 0.0f;
    }
  }

  if (valid) {
    for (int c = lt; c < n; c += a.tpc) {
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

}  // namespace mlmc

// fine: [C, 2*Mt*Mx], coarse: [C, 2*Mt*Mx/4], caches [C]; outputs as the
// Pallas kernel: fine', coarse', S_fine', S_cond', y [n_steps, C],
// qc/ec [n_steps*t_sub, C], acc [n_steps, C]; all f32, inputs and outputs
// distinct.  alphas: n_alpha rescaled series coefficients (exact branch).
extern "C" int mlmc_schwinger_twolevel(
    const float* fine_in, const float* coarse_in, const float* sf_in,
    const float* sq_in, float* fine_out, float* coarse_out, float* sf_out,
    float* sq_out, float* y, float* qc, float* ec, float* acc,
    const float* alphas, int n_alpha, int C, int Mx, int Mt, int n_steps,
    int t_sub, int n_overrelax_c, int n_heatbath_c, int k_rej,
    int k_rej_fill, int k_rej_bessel, int exact, int small_beta, float beta,
    float beta_c, float two_L, float sigma_beta, float sigma_half,
    uint32_t seed1, uint32_t seed2, int tpc, int cpb, size_t smem,
    void* stream) {
  mlmc::TwoLevelArgs a{C,          Mx / 2,       Mt / 2,       n_steps,
                       t_sub,      n_overrelax_c, n_heatbath_c, k_rej,
                       k_rej_fill, k_rej_bessel, exact,        small_beta,
                       n_alpha,    beta,         beta_c,       2.0f * beta,
                       two_L,      sigma_beta,   sigma_half,   seed1,
                       seed2,      tpc,          cpb};
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlmc::schwinger_twolevel_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (C + cpb - 1) / cpb;
  mlmc::schwinger_twolevel_kernel<<<blocks, tpc * cpb, smem,
                                    (cudaStream_t)stream>>>(
      fine_in, coarse_in, sf_in, sq_in, fine_out, coarse_out, sf_out, sq_out,
      y, qc, ec, acc, alphas, a);
  return (int)cudaGetLastError();
}
