// Kernel G: physics decode + reconstruction NLL of given (oef, dbv) draws,
// forward and closed-form backward.
//
// Replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_decode.py::
// make_fused_decode_nll (_fwd_kernel / _bwd_kernel, pallas_call at :399 and
// :431), the fine-tune likelihood when the fused ELBO kernel is off or does
// not cover the configuration (a diagonal posterior with a population
// prior). The TPU version packs the voxels into (8 x 256) tiles with the
// taus on a leading axis and pads N; here a block takes a tile of
// QV_G_TILE rows, one a thread, and writes exactly N rows:
//
// * the tile's y and sigma rows, a contiguous slab of QV_G_TILE x T floats
//   each, are copied into shared memory by asynchronous 16-byte copies
//   (cp.async); while they are in flight each thread evaluates its row's
//   T predictions (the backward: with their derivatives in oef and dbv),
//   which need only (oef, dbv), into shared memory: each tau's signal
//   once, the normaliser formed from them as the plain version forms it;
//   then each thread reads its row there (a stride of T = 11 words is
//   free of bank conflicts), and the backward's dsigma and dy go back
//   through shared memory, stored coalesced;
// * the backward writes dy only when it is asked for (a compile-time
//   variant): the measured images need no gradient on the fine-tune path;
// * the surrogate's Chebyshev coefficients come in a kernel parameter
//   (QvDecodeCoeffs), so each unrolled Clenshaw step takes its coefficient
//   from the constant bank as an operand; the per-tau words and the
//   Gauss-Jacobi lattice are staged in shared memory;
// * the forward rounds as the plain version does (IEEE expf, logf and
//   divisions, the same operations in the same order; its divisions by
//   the two normalisers from hoisted reciprocals, corrected to the IEEE
//   quotient): a row sums terms of up to ~1e3 that can cancel to near 0,
//   where the row gate (rtol and atol 1e-5) leaves no room for an
//   approximation; the backward, gated on the gradients' scale, takes the
//   hardware's exponential, log and reciprocal (__expf, __logf,
//   __fdividef) and FMAs in its Clenshaw sums; log1pf of the Student-t
//   term stays IEEE.
//
// Bound: bytes on paper, operations in practice. A row reads 2 T + 3
// floats (+ the cotangent) and writes one (the backward 2 T + 2, or
// T + 2 without dy); at 190,000 rows the ~20 MB of inputs stay in the
// card's 50 MB L2 between calls, and the time is the math: the earlier
// one-thread-a-row kernel's forward was its math, its backward its
// strided stores (PERF.md §6 has the split and this design's times).

#include <stdint.h>

#include "elbo_math.cuh"

#define QV_G_TILE 128  // rows a block, one a thread

// The surrogate's coefficients and those of its derivative, the table's
// ci and cd (ops/decode_nll.py::DecodeConsts.coeffs).
struct QvDecodeCoeffs {
  float ci[QV_NCHEB], cd[QV_NCHEB - 1];
};

static __host__ __device__ __forceinline__ int qv_g_pad4(int x) {
  return (x + 3) & ~3;
}

// elbo_math.cuh::qv_clenshaw, unrolled over coefficients in parameter
// space; with FMA (the backward) each step is one FMA after the add.
template <bool FMA, int N>
static __device__ __forceinline__ float qv_g_clenshaw(float x,
                                                      const float (&a)[N]) {
  float x2 = 2.0f * x;
  float b0 = 0.0f, b1 = 0.0f;
#pragma unroll
  for (int j = N - 1; j >= 1; --j) {
    float nb = FMA ? fmaf(x2, b0, a[j] - b1) : x2 * b0 - b1 + a[j];
    b1 = b0;
    b0 = nb;
  }
  return x * b0 - b1 + a[0];
}

// One tau's prediction and, for the backward, its derivatives in oef and
// dbv (pallas_decode._signal_tiles and the chain of _nll_row_grads).
struct QvGTau {
  float pred, dpo, dpd;
};

template <bool GRADS>
static __device__ __forceinline__ QvGTau qv_g_tau(const QvDecodeConsts& C,
                                                  const QvDecodeCoeffs& k,
                                                  const QvTable& tb, int t,
                                                  float oef, float dbv) {
  float integral, di = 0.0f;
  if (C.cheb) {
    float c = tb.tk[t] * oef;
    float raw = 2.0f * ((c * c) * C.inv_cmax2) - 1.0f;
    float x = fminf(raw, 1.0f);
    integral = qv_g_clenshaw<GRADS>(x, k.ci);
    if (GRADS) {
      float d = qv_g_clenshaw<true>(x, k.cd) * tb.dc[t] * c;
      di = raw <= 1.0f ? d : 0.0f;
    }
  } else {
    float c = tb.tk15[t] * oef;
    integral = 0.0f;
#pragma unroll 1
    for (int i = 0; i < QV_NGJ; ++i) {
      float u = c * tb.gj_u[i];
      integral = integral + tb.gj_wg[i] * qv_one_minus_j0(u);
      if (GRADS) di = di + tb.gj_d[t * QV_NGJ + i] * qv_j1(u);
    }
  }
  float tissue = (GRADS ? __expf(-dbv * integral) : expf(-dbv * integral))
                 * C.envelope;
  QvGTau r;
  r.dpo = r.dpd = 0.0f;
  float dt_doef = (-dbv * di) * tissue;
  float dt_ddbv = (-integral) * tissue;
  if (C.use_blood) {
    float w = C.mnb * dbv;
    float arg = (-tb.beta[t] * oef) * oef;
    float blood = C.bc * (GRADS ? __expf(arg) : expf(arg));
    r.pred = (1.0f - w) * tissue + w * blood;
    if (GRADS) {
      float db_doef = ((-2.0f * tb.beta[t]) * oef) * blood;
      r.dpo = (1.0f - w) * dt_doef + w * db_doef;
      r.dpd = (1.0f - w) * dt_ddbv + C.mnb * (blood - tissue);
    }
  } else {
    float w = dbv;
    r.pred = (1.0f - w) * tissue;
    if (GRADS) {
      r.dpo = (1.0f - w) * dt_doef;
      r.dpd = (1.0f - w) * dt_ddbv - tissue;
    }
  }
  return r;
}

// a / b rounded as the IEEE division, from inv = 1 / b (IEEE): with inv
// correctly rounded and q within an ulp of a / b, the residual a - q b is
// exact in one FMA and q + r inv rounds to the correctly rounded quotient
// (Markstein), for the normal operands here; the reciprocal is hoisted
// out of the loop over the taus, which the IEEE division cannot be.
static __device__ __forceinline__ float qv_g_div_rn(float a, float b,
                                                    float inv) {
  float q = a * inv;
  float r = fmaf(-q, b, a);
  return fmaf(r, inv, q);
}

// Summed-over-tau NLL of one draw (pallas_decode._nll_row), rounded as
// elbo_math.cuh::qv_nll_row; y, s and pr point at the row's measured
// series, sigma and predictions in shared memory.
static __device__ __forceinline__ float qv_g_nll_row(const QvDecodeConsts& C,
                                                     const float* y,
                                                     const float* s,
                                                     const float* pr,
                                                     float mask) {
  float t_ref = qv_ref_y(C, y), p_ref = qv_ref_y(C, pr);
  float inv_t = 1.0f / t_ref, inv_p = 1.0f / p_ref;
  float acc = 0.0f;
  for (int t = 0; t < C.n_taus; ++t) {
    float yh = qv_g_div_rn(y[t], t_ref, inv_t);
    float q = qv_g_div_rn(pr[t], p_ref, inv_p);
    if (C.log_data) {
      yh = mask > 0.0f ? logf(yh) : 0.0f;
      q = mask > 0.0f ? logf(q) : 0.0f;
    }
    float nll, d_r, d_sig;
    qv_nll_terms(C, yh - q, s[t], &nll, &d_r, &d_sig);
    acc = acc + nll;
  }
  return acc;
}

// Closed-form gradients of qv_g_nll_row (pallas_decode._nll_row_grads),
// given each tau's prediction and its derivatives in oef and dbv (pr, po,
// pd): returns d/doef and d/ddbv unscaled; ct * d/dsigma replaces the
// row's sigma in s and, under DY, ct * d/dy replaces its y, tau by tau
// after each is read. The window's terms of the normaliser chain are
// summed on the way and applied after, as elbo_math.cuh::qv_nll_row_grads
// does.
template <bool DY>
static __device__ __forceinline__ void qv_g_row_grads(
    const QvDecodeConsts& C, float* y, float* s, const float* pr,
    const float* po, const float* pd, float mask, float ct, float* doef,
    float* ddbv) {
  float t_ref = qv_ref_y(C, y), p_ref = qv_ref_y(C, pr);
  float inv_t = __fdividef(1.0f, t_ref), inv_p = __fdividef(1.0f, p_ref);
  float eq = 0.0f, cy = 0.0f, a_oef = 0.0f, a_dbv = 0.0f, w_oef = 0.0f,
        w_dbv = 0.0f;
  for (int t = 0; t < C.n_taus; ++t) {
    float yh_lin = y[t] * inv_t;
    float q_lin = pr[t] * inv_p;
    float yh = yh_lin, z = q_lin;
    if (C.log_data) {
      yh = mask > 0.0f ? __logf(yh_lin) : 0.0f;
      z = mask > 0.0f ? __logf(q_lin) : 0.0f;
    }
    float r = yh - z, sig = s[t], d_r, d_sig;
    float is = __fdividef(1.0f, sig);
    if (C.student) {
      float id = __fdividef(1.0f, (C.df * sig) * sig + r * r);
      d_r = (C.df1 * r) * id;
      d_sig = is - ((C.df1 * r) * r) * (is * id);
    } else {
      d_r = r * (is * is);
      d_sig = is - (r * r) * (is * (is * is));
    }
    float e = -d_r, c = d_r;
    if (C.log_data) {
      e = __fdividef(e, q_lin);
      c = mask > 0.0f ? __fdividef(d_r, fmaxf(yh_lin, 1e-30f)) : 0.0f;
    }
    eq = eq + e * q_lin;
    cy = cy + c * yh_lin;
    float ep = e * inv_p;
    a_oef = a_oef + ep * po[t];
    a_dbv = a_dbv + ep * pd[t];
    if (qv_in_window(C, t)) {
      w_oef = w_oef + po[t];
      w_dbv = w_dbv + pd[t];
    }
    s[t] = ct * d_sig;
    if (DY) y[t] = ct * (c * inv_t);
  }
  float kp = eq * (C.wk * inv_p);
  *doef = a_oef - kp * w_oef;
  *ddbv = a_dbv - kp * w_dbv;
  if (DY) {
    float ky = ct * (cy * (C.wk * inv_t));
    for (int t = C.multi ? C.se - 1 : C.se; t <= (C.multi ? C.se + 1 : C.se);
         ++t)
      y[t] = y[t] - ky;
  }
}

// Asynchronous copies from global into shared memory (cp.async): the
// thread goes on while the words are in flight, until qv_g_wait.
static __device__ __forceinline__ void qv_g_copy16(float* dst,
                                                   const float* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
static __device__ __forceinline__ void qv_g_copy4(float* dst,
                                                  const float* src) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
static __device__ __forceinline__ void qv_g_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
}

// Start copying count floats of global src into shared dst, the whole
// block: 16-byte copies where src is 16-byte aligned (dst always is), then
// the rest one by one.
static __device__ __forceinline__ void qv_g_load(float* dst,
                                                 const float* __restrict__ src,
                                                 int count) {
  int first = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    int n4 = count >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      qv_g_copy16(dst + 4 * i, src + 4 * i);
    first = n4 << 2;
  }
  for (int i = first + threadIdx.x; i < count; i += blockDim.x)
    qv_g_copy4(dst + i, src + i);
}

// Store count floats of shared src to global dst, the whole block, as
// qv_g_load reads them; the global side is written once (streaming).
static __device__ __forceinline__ void qv_g_store(float* __restrict__ dst,
                                                  const float* src,
                                                  int count) {
  int first = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    int n4 = count >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) __stcs(d4 + i, s4[i]);
    first = n4 << 2;
  }
  for (int i = first + threadIdx.x; i < count; i += blockDim.x)
    __stcs(dst + i, src[i]);
}

// Shared memory: the table (padded to 16 bytes), then the tile's y and
// sigma rows and its predictions (the backward: and their derivatives in
// oef and dbv), QV_G_TILE x T floats each.
static __host__ __device__ __forceinline__ int qv_g_smem_floats(int table_len,
                                                                int T,
                                                                bool grads) {
  return qv_g_pad4(table_len) + (grads ? 5 : 3) * QV_G_TILE * T;
}

__global__ void qv_decode_nll_fwd_kernel(
    const float* __restrict__ oef, const float* __restrict__ dbv,
    const float* __restrict__ y, const float* __restrict__ sig,
    const float* __restrict__ mask, long long n, QvDecodeConsts C,
    const __grid_constant__ QvDecodeCoeffs k,
    const float* __restrict__ table, float* __restrict__ rows) {
  extern __shared__ float4 qv_g_smem[];
  float* tab = reinterpret_cast<float*>(qv_g_smem);
  const int T = C.n_taus, len = qv_table_len(T);
  qv_stage_table(table, tab, len);
  QvTable tb = qv_table(tab, T);
  float* ys = tab + qv_g_pad4(len);
  float* ss = ys + QV_G_TILE * T;
  int i = threadIdx.x;
  float* pr = ss + QV_G_TILE * T + i * T;
  for (long long r0 = (long long)blockIdx.x * QV_G_TILE; r0 < n;
       r0 += (long long)gridDim.x * QV_G_TILE) {
    int live = (int)min((long long)QV_G_TILE, n - r0);
    long long v = r0 + i;
    float o = 0.0f, d = 0.0f, m = 0.0f;
    if (i < live) {
      o = oef[v];
      d = dbv[v];
      m = mask[v];
    }
    __syncthreads();  // the table is staged; the last tile's rows are read
    qv_g_load(ys, y + r0 * T, live * T);
    qv_g_load(ss, sig + r0 * T, live * T);
    // the predictions need only (oef, dbv): evaluated while the rows are
    // in flight
    if (i < live)
      for (int t = 0; t < T; ++t)
        pr[t] = qv_g_tau<false>(C, k, tb, t, o, d).pred;
    qv_g_wait();
    __syncthreads();
    if (i < live)
      rows[v] = qv_g_nll_row(C, ys + i * T, ss + i * T, pr, m) * m;
  }
}

template <bool DY>
__global__ void qv_decode_nll_bwd_kernel(
    const float* __restrict__ oef, const float* __restrict__ dbv,
    const float* __restrict__ y, const float* __restrict__ sig,
    const float* __restrict__ mask, const float* __restrict__ ct,
    long long n, QvDecodeConsts C, const __grid_constant__ QvDecodeCoeffs k,
    const float* __restrict__ table, float* __restrict__ doef,
    float* __restrict__ ddbv, float* __restrict__ dsig,
    float* __restrict__ dy) {
  extern __shared__ float4 qv_g_smem[];
  float* tab = reinterpret_cast<float*>(qv_g_smem);
  const int T = C.n_taus, len = qv_table_len(T);
  qv_stage_table(table, tab, len);
  QvTable tb = qv_table(tab, T);
  float* ys = tab + qv_g_pad4(len);
  float* ss = ys + QV_G_TILE * T;
  int i = threadIdx.x;
  float* pr = ss + QV_G_TILE * T + i * T;
  float* po = pr + QV_G_TILE * T;
  float* pd = po + QV_G_TILE * T;
  for (long long r0 = (long long)blockIdx.x * QV_G_TILE; r0 < n;
       r0 += (long long)gridDim.x * QV_G_TILE) {
    int live = (int)min((long long)QV_G_TILE, n - r0);
    long long v = r0 + i;
    float o = 0.0f, d = 0.0f, m = 0.0f, c = 0.0f;
    if (i < live) {
      o = oef[v];
      d = dbv[v];
      m = mask[v];
      c = ct[v] * m;  // the row was masked
    }
    __syncthreads();  // the table is staged; the last tile is stored
    qv_g_load(ys, y + r0 * T, live * T);
    qv_g_load(ss, sig + r0 * T, live * T);
    if (i < live)
      for (int t = 0; t < T; ++t) {
        QvGTau g = qv_g_tau<true>(C, k, tb, t, o, d);
        pr[t] = g.pred;
        po[t] = g.dpo;
        pd[t] = g.dpd;
      }
    qv_g_wait();
    __syncthreads();
    float go = 0.0f, gd = 0.0f;
    if (i < live)
      qv_g_row_grads<DY>(C, ys + i * T, ss + i * T, pr, po, pd, m, c, &go,
                         &gd);
    __syncthreads();
    qv_g_store(dsig + r0 * T, ss, live * T);
    if (DY) qv_g_store(dy + r0 * T, ys, live * T);
    if (i < live) {
      doef[v] = c * go;
      ddbv[v] = c * gd;
    }
  }
}

static int qv_g_grid(long long n) {
  long long tiles = (n + QV_G_TILE - 1) / QV_G_TILE;
  return (int)(tiles < (1LL << 20) ? tiles : (1LL << 20));
}

// Shared memory past the default 48 KB (the backward past 18 taus) is
// asked for before the launch.
template <class K>
static int qv_g_smem_attr(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int qv_decode_nll_fwd(const float* oef, const float* dbv,
                                 const float* y, const float* sig,
                                 const float* mask, long long n,
                                 QvDecodeConsts C, QvDecodeCoeffs k,
                                 const float* table, int table_len,
                                 float* rows, void* stream) {
  size_t smem = qv_g_smem_floats(table_len, C.n_taus, false) * sizeof(float);
  int err = qv_g_smem_attr(qv_decode_nll_fwd_kernel, smem);
  if (err) return err;
  qv_decode_nll_fwd_kernel<<<qv_g_grid(n), QV_G_TILE, smem,
                             (cudaStream_t)stream>>>(oef, dbv, y, sig, mask, n,
                                                     C, k, table, rows);
  return (int)cudaGetLastError();
}

// dy may be null: the backward then leaves the measured series' gradient
// out.
extern "C" int qv_decode_nll_bwd(const float* oef, const float* dbv,
                                 const float* y, const float* sig,
                                 const float* mask, const float* ct,
                                 long long n, QvDecodeConsts C,
                                 QvDecodeCoeffs k, const float* table,
                                 int table_len, float* doef, float* ddbv,
                                 float* dsig, float* dy, void* stream) {
  size_t smem = qv_g_smem_floats(table_len, C.n_taus, true) * sizeof(float);
  if (dy != nullptr) {
    int err = qv_g_smem_attr(qv_decode_nll_bwd_kernel<true>, smem);
    if (err) return err;
    qv_decode_nll_bwd_kernel<true><<<qv_g_grid(n), QV_G_TILE, smem,
                                     (cudaStream_t)stream>>>(
        oef, dbv, y, sig, mask, ct, n, C, k, table, doef, ddbv, dsig, dy);
  } else {
    int err = qv_g_smem_attr(qv_decode_nll_bwd_kernel<false>, smem);
    if (err) return err;
    qv_decode_nll_bwd_kernel<false><<<qv_g_grid(n), QV_G_TILE, smem,
                                      (cudaStream_t)stream>>>(
        oef, dbv, y, sig, mask, ct, n, C, k, table, doef, ddbv, dsig, dy);
  }
  return (int)cudaGetLastError();
}
