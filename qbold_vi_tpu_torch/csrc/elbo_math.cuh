// Per-voxel decode + reconstruction NLL math shared by the decode+NLL
// kernel (decode_nll.cu, kernel G) and the fused ELBO kernel
// (fused_elbo.cu, kernel F), as qbold_vi_tpu/ops/pallas_elbo.py imports
// _nll_row / _nll_row_grads from ops/pallas_decode.py. The plain versions
// are qbold_vi_tpu_torch/ops/decode_nll.py (nll_row_plain,
// nll_row_grads_plain) and ops/fused_elbo.py.
//
//   (oef, dbv) -> full SDR signal per tau (Chebyshev surrogate of the
//   tissue integral, or the 16-node Gauss-Jacobi J0 lattice) + blood
//   -> spin-echo normalised predicted and measured series
//   -> Student-t (df < 50) or Gaussian NLL summed over taus;
//   the backward gives d/doef, d/ddbv and the per-tau d/dsigma, d/dy in
//   closed form, recomputing the signal (no stored residuals).
//
// Every per-scan constant is formed in double on the host and rounded once
// to float32 (ops/decode_nll.py::decode_consts): the scalars arrive in
// QvDecodeConsts, the per-tau and table words in a float table that each
// block stages in shared memory. No coefficient of a table is typed here.
//
// Also here: the whitening of the sampled MVG KL and the counter-based
// generator of the device-noise mode (Philox4x32-10 + Box-Muller).
#pragma once

#include <cuda_runtime.h>

#define QV_NCHEB 21
#define QV_NGJ 16
#define QV_EPS 1e-3f

// Scalars of one configuration (ops/decode_nll.py::QvDecodeConsts).
struct QvDecodeConsts {
  int n_taus, se, multi, log_data, student, use_blood, cheb;
  float envelope, bc, mnb, inv_cmax2;
  float df, df1, half_df1, t_const, half_log_2pi, wk;
  float oef_range, min_oef, dbv_range, min_dbv, kl_bound;
};

// Offsets into the staged table (T = n_taus); the layout of
// ops/decode_nll.py::DecodeConsts.table:
//   tk[T] = taus k, tk15[T] = 1.5 taus k, dc[T] = 4 taus k / cmax^2,
//   beta[T], gj_u[16], gj_wg[16], ci[21], cd[20], gj_d[T][16]
static __device__ __forceinline__ int qv_table_len(int T) {
  return 20 * T + 2 * QV_NGJ + QV_NCHEB + (QV_NCHEB - 1);
}
struct QvTable {
  const float *tk, *tk15, *dc, *beta, *gj_u, *gj_wg, *ci, *cd, *gj_d;
};
static __device__ __forceinline__ QvTable qv_table(const float* s, int T) {
  QvTable t;
  t.tk = s;
  t.tk15 = s + T;
  t.dc = s + 2 * T;
  t.beta = s + 3 * T;
  t.gj_u = s + 4 * T;
  t.gj_wg = t.gj_u + QV_NGJ;
  t.ci = t.gj_wg + QV_NGJ;
  t.cd = t.ci + QV_NCHEB;
  t.gj_d = t.cd + (QV_NCHEB - 1);
  return t;
}

// Copy the table into shared memory (whole block; the caller syncs).
static __device__ __forceinline__ void qv_stage_table(const float* src,
                                                      float* dst, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) dst[i] = src[i];
}

// ---- Bessel functions (ops/bessel.py, A&S 9.4.1-9.4.6) --------------------
// Coefficients are Python floats in the plain version, rounded to float32
// where they meet a float32 tensor: (float) of the double literal is the
// same rounding.
#define QV_F(x) ((float)(x))

static __device__ __forceinline__ float qv_poly7(float t, double c0, double c1,
                                                 double c2, double c3,
                                                 double c4, double c5,
                                                 double c6) {
  float acc = QV_F(c6);
  acc = acc * t + QV_F(c5);
  acc = acc * t + QV_F(c4);
  acc = acc * t + QV_F(c3);
  acc = acc * t + QV_F(c2);
  acc = acc * t + QV_F(c1);
  acc = acc * t + QV_F(c0);
  return acc;
}

static __device__ __forceinline__ float qv_j0(float x) {
  float ax = fabsf(x);
  float ts = fminf(ax, 3.0f) / 3.0f;
  ts = ts * ts;
  float small = qv_poly7(ts, 1.0000000, -2.2499997, 1.2656208, -0.3163866,
                         0.0444479, -0.0039444, 0.0002100);
  float big = fmaxf(ax, 3.0f);
  float z = 3.0f / big;
  float f = qv_poly7(z, 0.79788456, -0.00000077, -0.00552740, -0.00009512,
                     0.00137237, -0.00072805, 0.00014476);
  float th = ax + qv_poly7(z, -0.78539816, -0.04166397, -0.00003954,
                           0.00262573, -0.00054125, -0.00029333, 0.00013558);
  float large = f * cosf(th) * rsqrtf(big);
  return ax <= 3.0f ? small : large;
}

static __device__ __forceinline__ float qv_j1(float x) {
  float ax = fabsf(x);
  float ts = fminf(ax, 3.0f) / 3.0f;
  ts = ts * ts;
  float small = qv_poly7(ts, 0.50000000, -0.56249985, 0.21093573, -0.03954289,
                         0.00443319, -0.00031761, 0.00001109) * ax;
  float big = fmaxf(ax, 3.0f);
  float z = 3.0f / big;
  float f = qv_poly7(z, 0.79788456, 0.00000156, 0.01659667, 0.00017105,
                     -0.00249511, 0.00113653, -0.00020033);
  float th = ax + qv_poly7(z, -2.35619449, 0.12499612, 0.00005650,
                           -0.00637879, 0.00074348, 0.00079824, -0.00029166);
  float large = f * cosf(th) * rsqrtf(big);
  float mag = ax <= 3.0f ? small : large;
  float sgn = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return sgn * mag;
}

static __device__ __forceinline__ float qv_one_minus_j0(float x) {
  float ax = fabsf(x);
  float q = fminf(ax, 1.0f);
  q = (q * q) * 0.25f;
  float series = q * (1.0f + q * (-0.25f + q * (QV_F(1.0 / 36.0) + q * (
      QV_F(-1.0 / 576.0) + q / 14400.0f))));
  return ax <= 1.0f ? series : 1.0f - qv_j0(x);
}

// ---- signal ---------------------------------------------------------------
static __device__ __forceinline__ float qv_clenshaw(float x, const float* a,
                                                    int n) {
  float b0 = 0.0f, b1 = 0.0f;
  for (int j = n - 1; j >= 1; --j) {
    float nb = 2.0f * x * b0 - b1 + a[j];
    b1 = b0;
    b0 = nb;
  }
  return x * b0 - b1 + a[0];
}

struct QvSignal {
  float pred, tissue, integral, blood, w;
};

// Signal at tau t for one (oef, dbv) (pallas_decode._signal_tiles).
static __device__ __forceinline__ QvSignal qv_signal(const QvDecodeConsts& C,
                                                     const QvTable& tb, int t,
                                                     float oef, float dbv) {
  float integral;
  if (C.cheb) {
    float c = tb.tk[t] * oef;
    float x = fminf(2.0f * ((c * c) * C.inv_cmax2) - 1.0f, 1.0f);
    integral = qv_clenshaw(x, tb.ci, QV_NCHEB);
  } else {
    float c = tb.tk15[t] * oef;
    integral = 0.0f;
    for (int i = 0; i < QV_NGJ; ++i)
      integral = integral + tb.gj_wg[i] * qv_one_minus_j0(c * tb.gj_u[i]);
  }
  QvSignal s;
  s.integral = integral;
  s.tissue = expf(-dbv * integral) * C.envelope;
  if (C.use_blood) {
    s.w = C.mnb * dbv;
    s.blood = C.bc * expf((-tb.beta[t] * oef) * oef);
    s.pred = (1.0f - s.w) * s.tissue + s.w * s.blood;
  } else {
    s.w = dbv;
    s.blood = 0.0f;
    s.pred = (1.0f - s.w) * s.tissue;
  }
  return s;
}

// dI/doef at tau t: the exact derivative of the surrogate (0 where its
// abscissa clamps), or the J1 lattice.
static __device__ __forceinline__ float qv_dintegral(const QvDecodeConsts& C,
                                                     const QvTable& tb, int t,
                                                     float oef) {
  if (C.cheb) {
    float cc = tb.tk[t] * oef;
    float raw = 2.0f * ((cc * cc) * C.inv_cmax2) - 1.0f;
    float x = fminf(raw, 1.0f);
    float d = qv_clenshaw(x, tb.cd, QV_NCHEB - 1) * tb.dc[t] * cc;
    return raw <= 1.0f ? d : 0.0f;
  }
  float c = tb.tk15[t] * oef;
  float d = 0.0f;
  for (int i = 0; i < QV_NGJ; ++i)
    d = d + tb.gj_d[t * QV_NGJ + i] * qv_j1(c * tb.gj_u[i]);
  return d;
}

// Spin-echo normaliser (+ eps) of the measured series and of the
// predicted one (only the window's taus are evaluated).
static __device__ __forceinline__ float qv_ref_y(const QvDecodeConsts& C,
                                                 const float* y) {
  int se = C.se;
  float r = C.multi ? (y[se - 1] + y[se] + y[se + 1]) / 3.0f : y[se];
  return r + QV_EPS;
}
static __device__ __forceinline__ float qv_ref_pred(const QvDecodeConsts& C,
                                                    const QvTable& tb,
                                                    float oef, float dbv) {
  int se = C.se;
  float r;
  if (C.multi)
    r = (qv_signal(C, tb, se - 1, oef, dbv).pred
         + qv_signal(C, tb, se, oef, dbv).pred
         + qv_signal(C, tb, se + 1, oef, dbv).pred) / 3.0f;
  else
    r = qv_signal(C, tb, se, oef, dbv).pred;
  return r + QV_EPS;
}

static __device__ __forceinline__ bool qv_in_window(const QvDecodeConsts& C,
                                                    int t) {
  return C.multi ? (t >= C.se - 1 && t <= C.se + 1) : t == C.se;
}

// (nll, dnll/dr, dnll/dsigma) of one residual (pallas_decode._nll_terms).
static __device__ __forceinline__ void qv_nll_terms(const QvDecodeConsts& C,
                                                    float r, float sig,
                                                    float* nll, float* d_r,
                                                    float* d_sig) {
  if (C.student) {
    float dss = (C.df * sig) * sig;
    float denom = dss + r * r;
    *nll = (C.t_const + logf(sig)) + C.half_df1 * log1pf((r * r) / dss);
    *d_r = (C.df1 * r) / denom;
    *d_sig = 1.0f / sig - ((C.df1 * r) * r) / (sig * denom);
  } else {
    float rs = r / sig;
    *nll = (logf(sig) + C.half_log_2pi) + 0.5f * (rs * rs);
    *d_r = r / (sig * sig);
    *d_sig = 1.0f / sig - (r * r) / (sig * (sig * sig));
  }
}

// One tau's NLL term of a draw (the body of pallas_decode._nll_row), given
// the measured and predicted normalisers; y and sig point at the voxel's T
// values.
static __device__ __forceinline__ float qv_nll_tau(const QvDecodeConsts& C,
                                                   const QvTable& tb, int t,
                                                   float oef, float dbv,
                                                   const float* y,
                                                   const float* sig,
                                                   float mask, float t_ref,
                                                   float p_ref) {
  float yh = y[t] / t_ref;
  float q = qv_signal(C, tb, t, oef, dbv).pred / p_ref;
  if (C.log_data) {
    yh = mask > 0.0f ? logf(yh) : 0.0f;
    q = mask > 0.0f ? logf(q) : 0.0f;
  }
  float nll, d_r, d_sig;
  qv_nll_terms(C, yh - q, sig[t], &nll, &d_r, &d_sig);
  return nll;
}

// Summed-over-tau NLL of one draw (pallas_decode._nll_row).
static __device__ __forceinline__ float qv_nll_row(const QvDecodeConsts& C,
                                                   const QvTable& tb,
                                                   float oef, float dbv,
                                                   const float* y,
                                                   const float* sig,
                                                   float mask) {
  float t_ref = qv_ref_y(C, y);
  float p_ref = qv_ref_pred(C, tb, oef, dbv);
  float acc = 0.0f;
  for (int t = 0; t < C.n_taus; ++t)
    acc = acc + qv_nll_tau(C, tb, t, oef, dbv, y, sig, mask, t_ref, p_ref);
  return acc;
}

// Closed-form gradients of qv_nll_row for one draw
// (pallas_decode._nll_row_grads), in one pass over the taus: the window
// terms of the normaliser chain are summed on the way (QvNllSums) and
// applied after (qv_nll_grads_tail). d/doef and d/ddbv are returned
// unscaled; ct * d/dsigma and ct * d/dy are written to dsig/dy (first draw)
// or added to them (later draws), tau by tau (qv_nll_tau_grads).
struct QvNllSums {
  float eq, cy, a_oef, a_dbv, w_oef, w_dbv;
};

static __device__ __forceinline__ void qv_nll_tau_grads(
    const QvDecodeConsts& C, const QvTable& tb, int t, float oef, float dbv,
    const float* y, const float* sig, float mask, float ct, bool first,
    float t_ref, float p_ref, float* dsig, float* dy, QvNllSums* s) {
  QvSignal sg = qv_signal(C, tb, t, oef, dbv);
  float di = qv_dintegral(C, tb, t, oef);
  float dt_doef = (-dbv * di) * sg.tissue;
  float dt_ddbv = (-sg.integral) * sg.tissue;
  float dpo, dpd;
  if (C.use_blood) {
    float db_doef = ((-2.0f * tb.beta[t]) * oef) * sg.blood;
    dpo = (1.0f - sg.w) * dt_doef + sg.w * db_doef;
    dpd = (1.0f - sg.w) * dt_ddbv + C.mnb * (sg.blood - sg.tissue);
  } else {
    dpo = (1.0f - sg.w) * dt_doef;
    dpd = (1.0f - sg.w) * dt_ddbv - sg.tissue;
  }
  float yh_lin = y[t] / t_ref;
  float q_lin = sg.pred / p_ref;
  float yh = yh_lin, z = q_lin;
  if (C.log_data) {
    yh = mask > 0.0f ? logf(yh_lin) : 0.0f;
    z = mask > 0.0f ? logf(q_lin) : 0.0f;
  }
  float nll, d_r, d_sig;
  qv_nll_terms(C, yh - z, sig[t], &nll, &d_r, &d_sig);
  float e = -d_r, c = d_r;
  if (C.log_data) {
    e = e / q_lin;
    c = mask > 0.0f ? d_r / fmaxf(yh_lin, 1e-30f) : 0.0f;
  }
  s->eq = s->eq + e * q_lin;
  s->cy = s->cy + c * yh_lin;
  float ep = e / p_ref;
  s->a_oef = s->a_oef + ep * dpo;
  s->a_dbv = s->a_dbv + ep * dpd;
  if (qv_in_window(C, t)) {
    s->w_oef = s->w_oef + dpo;
    s->w_dbv = s->w_dbv + dpd;
  }
  float vs = ct * d_sig, vy = ct * (c / t_ref);
  dsig[t] = first ? vs : dsig[t] + vs;
  dy[t] = first ? vy : dy[t] + vy;
}

// d/doef and d/ddbv of a draw from its summed taus; returns ct times the
// normaliser's share, which each tau of the window subtracts from dy.
static __device__ __forceinline__ float qv_nll_grads_tail(
    const QvDecodeConsts& C, const QvNllSums& s, float ct, float t_ref,
    float p_ref, float* doef, float* ddbv) {
  float kp = s.eq * (C.wk / p_ref);
  *doef = s.a_oef - kp * s.w_oef;
  *ddbv = s.a_dbv - kp * s.w_dbv;
  return ct * (s.cy * (C.wk / t_ref));
}

static __device__ __forceinline__ void qv_nll_row_grads(
    const QvDecodeConsts& C, const QvTable& tb, float oef, float dbv,
    const float* y, const float* sig, float mask, float ct, bool first,
    float* dsig, float* dy, float* doef, float* ddbv) {
  float t_ref = qv_ref_y(C, y);
  float p_ref = qv_ref_pred(C, tb, oef, dbv);
  QvNllSums s = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < C.n_taus; ++t)
    qv_nll_tau_grads(C, tb, t, oef, dbv, y, sig, mask, ct, first, t_ref,
                     p_ref, dsig, dy, &s);
  float ky = qv_nll_grads_tail(C, s, ct, t_ref, p_ref, doef, ddbv);
  for (int t = 0; t < C.n_taus; ++t)
    if (qv_in_window(C, t)) dy[t] = dy[t] - ky;
}

// ---- posterior draws -------------------------------------------------------
static __device__ __forceinline__ float qv_sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Raw head row (K = 5 MVG, 4 diagonal) -> squashed (mu0, ls0, mu1, ls1, od)
// and the tanh chain factors of ls0, ls1, od (dist.logit_mvn.unpack).
struct QvPost {
  float mu0, ls0, mu1, ls1, od, c1, c3, c4;
};
static __device__ __forceinline__ QvPost qv_unpack(const float* r, bool mvg) {
  QvPost u;
  u.mu0 = r[0];
  float t1 = tanhf(r[1]);
  u.ls0 = t1 * 3.0f - 1.0f;
  u.mu1 = r[2];
  float t3 = tanhf(r[3]);
  u.ls1 = t3 * 3.0f - 1.0f;
  if (mvg) {
    float t4 = tanhf(r[4]);
    u.od = t4 * QV_F(0.1353352832366127);
    u.c4 = QV_F(0.1353352832366127) * (1.0f - t4 * t4);
  } else {
    u.od = 0.0f;
    u.c4 = 0.0f;
  }
  u.c1 = 3.0f * (1.0f - t1 * t1);
  u.c3 = 3.0f * (1.0f - t3 * t3);
  return u;
}

// Whitening factors (inv_tl, inv_br, inv_bl) of a distribution
// (dist/logit_mvn.py::whiten_factors).
struct QvWhite {
  float itl, ibr, ibl;
};
static __device__ __forceinline__ QvWhite qv_white(const QvPost& u) {
  QvWhite w;
  w.itl = expf(-u.ls0);
  w.ibr = expf(-u.ls1);
  w.ibl = -expf(-u.ls0 - u.ls1) * u.od;
  return w;
}

// ---- Philox4x32-10 + Box-Muller (ops/fused_elbo.py::philox_normals) --------
// Counter (voxel lo, voxel hi, draw, 0), key (seed lo, seed hi): each
// (voxel, draw) pair has its own normals, so the backward replays every
// draw bit for bit from the seed alone. Each round's two products take
// their high and low words from one 32 x 32 -> 64-bit multiply.
// Box-Muller: logf (a cheaper log loses the small radii near u1 = 1), the
// root as x rsqrt(x), and the angle from __sincosf on [-pi, pi): no slow
// path (cosf/sinf keep one), ~1e-6 of the normals' scale off the exact
// values, inside every device-noise gate against philox_normals (rtol
// 1e-4); PERF.md has the measured gain.
static __device__ __forceinline__ void qv_philox(long long v, unsigned ctr,
                                                 unsigned k0, unsigned k1,
                                                 unsigned c[4]) {
  unsigned c0 = (unsigned)v, c1 = (unsigned)((unsigned long long)v >> 32);
  unsigned c2 = ctr, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    unsigned long long p0 = (unsigned long long)0xD2511F53u * c0;
    unsigned long long p1 = (unsigned long long)0xCD9E8D57u * c2;
    unsigned n0 = (unsigned)(p1 >> 32) ^ c1 ^ k0;
    unsigned n2 = (unsigned)(p0 >> 32) ^ c3 ^ k1;
    c0 = n0;
    c1 = (unsigned)p1;
    c2 = n2;
    c3 = (unsigned)p0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  c[0] = c0;
  c[1] = c1;
  c[2] = c2;
  c[3] = c3;
}

// Two normals from two Philox words (the top 24 bits of each).
static __device__ __forceinline__ void qv_box_muller(unsigned a, unsigned b,
                                                     float* z0, float* z1) {
  float u1 = (float)((a >> 8) + 1u) * 5.9604644775390625e-8f;
  float u2 = (float)(b >> 8) * 5.9604644775390625e-8f;
  float x = -2.0f * logf(u1);
  float r = x > 0.0f ? x * rsqrtf(x) : 0.0f;
  // 2 pi u2 = pi + t, t = 2 pi (u2 - 1/2) in [-pi, pi) (u2 - 1/2 exact),
  // where the hardware's sine and cosine keep their stated accuracy
  float sn, cs;
  __sincosf(6.2831855f * (u2 - 0.5f), &sn, &cs);
  *z0 = -(r * cs);
  *z1 = -(r * sn);
}

// Kernel F's normals: pair `draw` of voxel v from words 0 and 1 of the
// block with counter (v, draw).
static __device__ __forceinline__ void qv_normal2(long long v, int draw,
                                                  unsigned k0, unsigned k1,
                                                  float* z0, float* z1) {
  unsigned c[4];
  qv_philox(v, (unsigned)draw, k0, k1, c);
  qv_box_muller(c[0], c[1], z0, z1);
}
