// Per-voxel quadrature posterior summaries: the device routine shared by
// quadrature.cu (kernel A) and encode_quad.cu (kernel B), as
// qbold_vi_tpu/ops/quadrature.py::quad_tile_summaries is shared by the two
// Pallas kernels it replaces. Line-for-line the arithmetic of the plain
// version, qbold_vi_tpu_torch/ops/quadrature.py:
//   raw (q0..q4) -> squashed (ls0, ls1, od) -> sigmoid moments by a
//   16-node Gauss-Hermite rule (s < 1.5) or an exact step + 16-node
//   Gauss-Laguerre split (s >= 1.5) -> third-order od-Taylor cross moments
//   -> means and biased variances of (OEF, DBV, R2').
// The normal CDF is the Abramowitz-Stegun 7.1.26 rational erf, and the
// sigmoid is 1 / (1 + e^-x): both formulas are part of the model, so no
// normcdff/erff. How each exponential and reciprocal is rounded is not:
// the sigmoids, the normal densities and the erf's exponential take the
// hardware's (MUFU.EX2 through __expf, MUFU.RCP through __fdividef; a few
// ulp, within the card gates against the plain version, chip_smoke.py
// CHECKS), which cut kernel A by 18% on the H100 (PERF.md). The
// log-std transforms keep the IEEE tanhf: they are outputs of kernel B,
// held against float64, and a fast tanh saved nothing.
//
// The 16-node loops are unrolled by 4 (11% off kernel A on the H100):
// fully unrolled, A took 255 registers and ~4.7 k instructions and ran 28%
// slower, and kernel B's tail 8% slower (PERF.md).
//
// Each 1-D moment routine branches on its own std (s < 1.5: Gauss-Hermite,
// else the step + Gauss-Laguerre split), so a warp whose voxels straddle
// the split runs both sides: on real heads nearly every warp does.
// qv_quad_block (kernels A and B) first sorts the block's problems by side,
// so that one warp at most runs both.
//
// Node constants are not typed here: the caller stages the float32 table
// ops/quadrature.py::QUAD_CONSTS (built in float64 by numpy, rounded once)
// in shared memory and passes a pointer to it. Layout (QV_NCONST floats):
//   XH[16] WH[16] TL[16] P1..P5[16 each] M1..M5[16 each].
#pragma once

#define QV_QH 16
#define QV_QL 16
#define QV_NCONST (3 * 16 + 10 * 16)
#define QV_SPLIT 1.5f

// Physical ranges and the scalar products the summaries use, each
// computed in double on the host and rounded once to float32, as the plain
// version's Python-float coefficients are (ops/_cuda.py::QvRanges).
// oef = a + b sig(l0), dbv = c + d sig(l1), r2p = dw * oef * dbv.
struct QvRanges {
  float a, b, c, d;
  float aa, ab2, bb, cc, cd2, dd, ac, ad, cb, bd;
  float dw, dw2;
};

static __device__ __forceinline__ const float* qv_xh(const float* c) { return c; }
static __device__ __forceinline__ const float* qv_wh(const float* c) { return c + 16; }
static __device__ __forceinline__ const float* qv_tl(const float* c) { return c + 32; }
// P_k (k = 1..5) and M_k rows
static __device__ __forceinline__ const float* qv_p(const float* c, int k) {
  return c + 48 + 16 * (k - 1);
}
static __device__ __forceinline__ const float* qv_m(const float* c, int k) {
  return c + 128 + 16 * (k - 1);
}

// 1 / (1 + e^-x) by the hardware's exponential and reciprocal (1 / inf = 0
// where e^-x overflows)
static __device__ __forceinline__ float qv_sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

static __device__ __forceinline__ float qv_npdf(float z) {
  return 0.3989422804014327f * __expf(-0.5f * z * z);
}

static __device__ __forceinline__ float qv_ndtr(float x) {
  float z = x * 0.7071067811865476f;
  float az = fabsf(z);
  float t = 1.0f / (1.0f + 0.3275911f * az);
  float poly = t * (0.254829592f + t * (-0.284496736f + t * (
      1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  float erf_abs = 1.0f - poly * __expf(-az * az);
  float erf = z < 0.0f ? -erf_abs : erf_abs;
  return 0.5f * (1.0f + erf);
}

// (E[sig(m+sZ)], E[sig^2(m+sZ)])
static __device__ __forceinline__ void qv_mom1d(const float* c, float m,
                                                float s, float* e1, float* e2) {
  if (s < QV_SPLIT) {
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll 4
    for (int i = 0; i < QV_QH; ++i) {
      float sg = qv_sigmoid(m + s * qv_xh(c)[i]);
      float w = qv_wh(c)[i] * sg;
      a1 += w;
      a2 += w * sg;
    }
    *e1 = a1;
    *e2 = a2;
    return;
  }
  float inv_s = 1.0f / s;
  float zs = -m * inv_s;
  float c1 = 0.0f, c2 = 0.0f;
#pragma unroll 4
  for (int j = 0; j < QV_QL; ++j) {
    float na = qv_npdf(zs + qv_tl(c)[j] * inv_s);
    float nb = qv_npdf(zs - qv_tl(c)[j] * inv_s);
    c1 = c1 + qv_p(c, 1)[j] * na + qv_m(c, 1)[j] * nb;
    c2 = c2 + qv_p(c, 2)[j] * na + qv_m(c, 2)[j] * nb;
  }
  float phi = qv_ndtr(m * inv_s);
  *e1 = phi + c1 * inv_s;
  *e2 = phi + c2 * inv_s;
}

// E[sig^p(m+sZ) Z^j], p = 1, 2, j = 0..3, ordered (1,0) (2,0) (1,1) (2,1)
// (1,2) (2,2) (1,3) (2,3)
static __device__ __forceinline__ void qv_omom1d(const float* c, float m,
                                                 float s, float out[8]) {
  if (s < QV_SPLIT) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < QV_QH; ++i) {
      float x = qv_xh(c)[i];
      float sg = qv_sigmoid(m + s * x);
      float w1 = qv_wh(c)[i] * sg;
      float w2 = w1 * sg;
      float x2 = x * x;
      out[0] += w1;
      out[1] += w2;
      out[2] += w1 * x;
      out[3] += w2 * x;
      out[4] += w1 * x2;
      out[5] += w2 * x2;
      out[6] += (w1 * x2) * x;
      out[7] += (w2 * x2) * x;
    }
    return;
  }
  float inv_s = 1.0f / s;
  float zs = -m * inv_s;
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < QV_QL; ++j) {
    float za = zs + qv_tl(c)[j] * inv_s;
    float zb = zs - qv_tl(c)[j] * inv_s;
    float na = qv_npdf(za);
    float nb = qv_npdf(zb);
    float za2 = za * za, zb2 = zb * zb;
    float p1a = qv_p(c, 1)[j] * na, m1b = qv_m(c, 1)[j] * nb;
    float p2a = qv_p(c, 2)[j] * na, m2b = qv_m(c, 2)[j] * nb;
    acc[0] = acc[0] + p1a + m1b;
    acc[1] = acc[1] + p2a + m2b;
    acc[2] = acc[2] + p1a * za + m1b * zb;
    acc[3] = acc[3] + p2a * za + m2b * zb;
    acc[4] = acc[4] + p1a * za2 + m1b * zb2;
    acc[5] = acc[5] + p2a * za2 + m2b * zb2;
    acc[6] = acc[6] + p1a * za2 * za + m1b * zb2 * zb;
    acc[7] = acc[7] + p2a * za2 * za + m2b * zb2 * zb;
  }
  float phi = qv_ndtr(m * inv_s);
  float nm = qv_npdf(zs);
  float s2m = phi + zs * nm;
  float s3m = (2.0f + zs * zs) * nm;
  float step[8] = {phi, phi, nm, nm, s2m, s2m, s3m, s3m};
#pragma unroll
  for (int k = 0; k < 8; ++k) out[k] = step[k] + acc[k] * inv_s;
}

// E[sig^k(m+sZ)], k = 1..5
static __device__ __forceinline__ void qv_gmom1d(const float* c, float m,
                                                 float s, float g[5]) {
  if (s < QV_SPLIT) {
#pragma unroll
    for (int k = 0; k < 5; ++k) g[k] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < QV_QH; ++i) {
      float sg = qv_sigmoid(m + s * qv_xh(c)[i]);
      float w = qv_wh(c)[i] * sg;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        g[k] += w;
        w *= sg;
      }
    }
    return;
  }
  float inv_s = 1.0f / s;
  float zs = -m * inv_s;
  float acc[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) acc[k] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < QV_QL; ++j) {
    float na = qv_npdf(zs + qv_tl(c)[j] * inv_s);
    float nb = qv_npdf(zs - qv_tl(c)[j] * inv_s);
#pragma unroll
    for (int k = 0; k < 5; ++k)
      acc[k] = acc[k] + qv_p(c, k + 1)[j] * na + qv_m(c, k + 1)[j] * nb;
  }
  float phi = qv_ndtr(m * inv_s);
#pragma unroll
  for (int k = 0; k < 5; ++k) g[k] = phi + acc[k] * inv_s;
}

// A voxel's three 1-D moment problems: omom at (mu0, s0), mom at
// (mu1, sm1) and gmom at (mu1, s1), and the off-diagonal od.
struct QvQuadIn {
  float mu0, mu1, s0, s1, sm1, od;
};

// Raw head (q0..q4; q4 ignored unless mvg) -> the voxel's problems and
// the squashed raw log-stds raw[3] = (ls0, ls1, od).
static __device__ __forceinline__ QvQuadIn qv_quad_squash(
    float q0, float q1, float q2, float q3, float q4, bool mvg,
    float raw[3]) {
  QvQuadIn in;
  in.mu0 = q0;
  in.mu1 = q2;
  float ls0 = tanhf(q1) * 3.0f - 1.0f;
  float ls1 = tanhf(q3) * 3.0f - 1.0f;
  in.od = mvg ? tanhf(q4) * 0.1353352832366127f : 0.0f;
  raw[0] = ls0;
  raw[1] = ls1;
  raw[2] = in.od;
  in.s0 = expf(ls0);
  in.s1 = expf(ls1);
  in.sm1 = sqrtf(in.od * in.od + in.s1 * in.s1);
  return in;
}

// The moments -> means[3], vars[3] (third-order od-Taylor cross moments).
static __device__ __forceinline__ void qv_quad_combine(
    const float o[8], float D1, float D2, const float g[5], float od,
    const QvRanges& r, float mean[3], float var[3]) {
  float O1 = o[0], O2 = o[1], U1 = o[2], U2 = o[3];
  float V1 = o[4], V2 = o[5], W1 = o[6], W2 = o[7];

  float G1d1 = g[0] - g[1];
  float G1d2 = g[0] - 3.0f * g[1] + 2.0f * g[2];
  float G1d3 = g[0] - 7.0f * g[1] + 12.0f * g[2] - 6.0f * g[3];
  float G2d1 = 2.0f * (g[1] - g[2]);
  float G2d2 = 2.0f * (2.0f * g[1] - 5.0f * g[2] + 3.0f * g[3]);
  float G2d3 = 2.0f * (4.0f * g[1] - 19.0f * g[2] + 27.0f * g[3]
                       - 12.0f * g[4]);

  float h2 = 0.5f * od * od;
  float h3 = h2 * od * (1.0f / 3.0f);
  float t1_1 = od * U1, t1_2 = od * U2;
  float t2_1 = h2 * (V1 - O1), t2_2 = h2 * (V2 - O2);
  float t3_1 = h3 * W1, t3_2 = h3 * W2;
  float J11 = O1 * D1 + t1_1 * G1d1 + t2_1 * G1d2 + t3_1 * G1d3;
  float J12 = O1 * D2 + t1_1 * G2d1 + t2_1 * G2d2 + t3_1 * G2d3;
  float J21 = O2 * D1 + t1_2 * G1d1 + t2_2 * G1d2 + t3_2 * G1d3;
  float J22 = O2 * D2 + t1_2 * G2d1 + t2_2 * G2d2 + t3_2 * G2d3;

  float mean_o = r.a + r.b * O1;
  float eo2 = r.aa + r.ab2 * O1 + r.bb * O2;
  float mean_d = r.c + r.d * D1;
  float ed2 = r.cc + r.cd2 * D1 + r.dd * D2;
  float er = r.ac + r.ad * D1 + r.cb * O1 + r.bd * J11;
  float er2 = r.aa * (r.cc + r.cd2 * D1 + r.dd * D2)
      + r.ab2 * (r.cc * O1 + r.cd2 * J11 + r.dd * J12)
      + r.bb * (r.cc * O2 + r.cd2 * J21 + r.dd * J22);
  float mean_r = r.dw * er;
  mean[0] = mean_o;
  mean[1] = mean_d;
  mean[2] = mean_r;
  var[0] = fmaxf(eo2 - mean_o * mean_o, 0.0f);
  var[1] = fmaxf(ed2 - mean_d * mean_d, 0.0f);
  var[2] = fmaxf(r.dw2 * er2 - mean_r * mean_r, 0.0f);
}

// Shared-memory words qv_quad_block needs for a block of T threads: the
// counts (2 a warp, 32 warps), the sorted problems (3 x (m, s) x T) and
// their moments (8 + 2 + 5 a problem set, x T).
#define QV_QUAD_SCRATCH(T) (2 * 32 + 21 * (T))

// The threads that share qv_quad_block's sort, and their barrier: the
// whole block (kernels A and B), or its first n threads on the named
// barrier id (encode_stream_wg.cu's consumer warpgroups, beside a producer
// warpgroup that takes no part).
struct QvBlockSync {
  __device__ __forceinline__ int threads() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};
struct QvNamedSync {
  int id, n;
  __device__ __forceinline__ int threads() const { return n; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
  }
};

// The block's voxels, their moments computed with the problems of each
// routine sorted by side (kernels A and B). Every thread of the block (of
// `sync`'s threads) calls it, ``live`` or not (at most 32 warps); a live
// thread gets its voxel's moments, bit-equal to solving them on its own
// lane. Thread t solves problem t of each routine: omom's and gmom's
// Gauss-Hermite problems come first, then their Gauss-Laguerre ones, and
// mom's the other way round (so that no warp takes the costlier side in
// all three), each side in voxel order; only the warp at a boundary runs
// both sides. Three barriers: counts, problems, moments. Each warp's
// counts are summed by every thread (no shuffles, no arrays indexed at run
// time, which took registers and stack: PERF.md).
template <class Sync = QvBlockSync>
static __device__ __forceinline__ void qv_quad_block(
    const float* c, float* sc, bool live, const QvQuadIn& in, float o[8],
    float* D1, float* D2, float g[5], Sync sync = Sync()) {
  const int T = sync.threads(), W = T >> 5, t = threadIdx.x;
  const int lane = t & 31, w = t >> 5;
  float* task = sc + 2 * 32;                      // [3][2][T]: m, s
  float* res = task + 6 * T;                      // o[8][T] d[2][T] g[5][T]
  const float m[3] = {in.mu0, in.mu1, in.mu1};
  const float s[3] = {in.s0, in.sm1, in.s1};
  const unsigned below = (1u << lane) - 1u;
  const unsigned lv = __ballot_sync(0xffffffffu, live);
  // per warp, 16-bit fields of two words: the live problems and omom's
  // Gauss-Laguerre ones, mom's and gmom's (a block holds at most 1,024)
  unsigned gl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    gl[k] = __ballot_sync(0xffffffffu, live && s[k] >= QV_SPLIT);
  unsigned* counts = reinterpret_cast<unsigned*>(sc);
  if (lane == 0) {
    counts[2 * w] = __popc(lv) | (__popc(gl[0]) << 16);
    counts[2 * w + 1] = __popc(gl[1]) | (__popc(gl[2]) << 16);
  }
  sync.sync();
  unsigned before[2] = {0u, 0u}, all[2] = {0u, 0u};  // earlier warps, block
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned x = counts[2 * i + h];
      before[h] += i < w ? x : 0u;
      all[h] += x;
    }
  }
  const int n_live = (int)(all[0] & 0xffffu);
  int slot[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int l_all = (int)((all[(k + 1) / 2] >> (16 * ((k + 1) % 2)))
                            & 0xffffu);
    const int l_before = (int)((before[(k + 1) / 2] >> (16 * ((k + 1) % 2)))
                               & 0xffffu);
    const int h_before = (int)(before[0] & 0xffffu) - l_before;
    // mom (k = 1) places its Gauss-Laguerre problems first
    const bool on_gl = (gl[k] >> lane) & 1u;
    slot[k] = on_gl ? (k == 1 ? 0 : n_live - l_all) + l_before
                          + __popc(gl[k] & below)
                    : (k == 1 ? l_all : 0) + h_before
                          + __popc(lv & ~gl[k] & below);
    if (live) {
      task[2 * k * T + slot[k]] = m[k];
      task[(2 * k + 1) * T + slot[k]] = s[k];
    }
  }
  sync.sync();
  if (t < n_live) {
    float out[8];
    qv_omom1d(c, task[t], task[T + t], out);
#pragma unroll
    for (int j = 0; j < 8; ++j) res[j * T + t] = out[j];
    qv_mom1d(c, task[2 * T + t], task[3 * T + t], &res[8 * T + t],
             &res[9 * T + t]);
    qv_gmom1d(c, task[4 * T + t], task[5 * T + t], out);
#pragma unroll
    for (int j = 0; j < 5; ++j) res[(10 + j) * T + t] = out[j];
  }
  sync.sync();
  if (live) {
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = res[j * T + slot[0]];
    *D1 = res[8 * T + slot[1]];
    *D2 = res[9 * T + slot[1]];
#pragma unroll
    for (int j = 0; j < 5; ++j) g[j] = res[(10 + j) * T + slot[2]];
  }
}

// Copy the node table into shared memory (whole block; caller syncs).
static __device__ __forceinline__ void qv_stage_consts(const float* src,
                                                       float* dst) {
  for (int i = threadIdx.x; i < QV_NCONST; i += blockDim.x) dst[i] = src[i];
}
