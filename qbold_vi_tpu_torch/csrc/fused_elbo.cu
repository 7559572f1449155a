// Kernel F: the fused fine-tune ELBO -- posterior sampling + physics decode
// + reconstruction NLL + sampled MVG KL (or the analytic diagonal KL) per
// voxel, forward and closed-form backward.
//
// Replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_elbo.py::
// make_fused_elbo (_elbo_fwd_kernel / _elbo_bwd_kernel, pallas_call at :464
// and :492). Reads q and p (N, K), y and sigma (N, T) and the mask once and
// writes two (N,) rows (+ the (N, 6) KL state below); the backward writes
// dq, dp (N, K), dsigma, dy (N, T). None of the TPU's (8 x 512) packing,
// padding, VMEM budget or trial-fold rules is carried over.
//
// Noise: host mode reads z_nll (s_nll, N, 2) and z_kl (s_kl, N, 2) as the
// JAX layout has them; device mode draws each (voxel, draw) pair from a
// Philox4x32-10 counter keyed by the seed (elbo_math.cuh::qv_normal2), so
// the backward replays the forward's draws exactly with no per-program
// reseeding. Draws 0..s_nll-1 feed the NLL, s_nll.. the KL. The counter of
// row v is offset + v: a launch over rows [a, b) of a larger set of rows
// draws what one launch over the whole set draws for them.
//
// Bound: operations. Per voxel the forward runs s_nll decodes (T + 1
// Clenshaw evaluations each) and s_kl = 70 KL draws (a Philox block, a
// Box-Muller and ~30 flops each) against 33 floats read and 8 written. It
// issues instructions as fast as it can: the draws are most of its time
// (tools/bench_fused_elbo.py: normals from a constant cut the earlier
// kernel's forward by 64%). The design, measured against that kernel
// (one thread a voxel, no KL state; PERF.md):
// * The forward keeps one thread a voxel on hardware-scheduled blocks.
//   Spreading a voxel over 2-8 lanes, or cutting the grid to one wave of
//   resident blocks, measured slower: they add instructions (the lanes'
//   shuffles and repeated per-voxel work) to a kernel that is not short of
//   parallel work.
// * Draws. Each Philox product is one wide multiply, the angle and the
//   root come from the special function unit (elbo_math.cuh).
// * The KL state. With z the draw's normals and no draw clamped at
//   +-kl_bound, every residual of the KL backward is affine in (z0, z1),
//   so its ten sums are polynomials of degree <= 2 in z: five moments per
//   voxel (sum z0, z1, z0^2, z0 z1, z1^2) give them in closed form
//   (qv_kl_grads_moments). The forward writes the moments and a flag "some
//   draw clamped" (QV_STATE floats a voxel); the backward given them draws
//   only its s_nll NLL draws. It spreads a voxel over QV_BWD_LANES lanes
//   (the taus of each decode dealt out, sums reduced by a fixed butterfly:
//   the same bits on every lane and in every run). A flagged voxel has
//   its KL draws replayed by the whole warp, so that a few clamped voxels
//   do not hold their warps for all 70 draws; without a state, every
//   voxel's KL draws are replayed on its own lanes, dealt out by draw.
// * Dead voxels. A voxel whose mask is 0 writes its masked results (rows,
//   state, gradients 0) without decoding or drawing, so a warp of dead
//   voxels does no work.

#include "elbo_math.cuh"

#define QV_ELBO_BLOCK 128
#define QV_BWD_LANES 2  // lanes a backward voxel (best of 1, 2, 4)
#define QV_STATE 6  // sum z0, z1, z0^2, z0 z1, z1^2 over the KL draws; flag

struct QvNoise {
  const float* zn;  // (s_nll, n, 2) or null: device noise
  const float* zk;  // (s_kl, n, 2) or null
  unsigned k0, k1;  // Philox key (the seed)
  long long n;
  long long offset;  // the Philox counter of row 0
};

static __device__ __forceinline__ void qv_draw(const QvNoise& nz,
                                               const float* z, long long v,
                                               int s, int draw, float* z0,
                                               float* z1) {
  if (z != nullptr) {
    const float* p = z + ((long long)s * nz.n + v) * 2;
    *z0 = p[0];
    *z1 = p[1];
  } else {
    qv_normal2(nz.offset + v, draw, nz.k0, nz.k1, z0, z1);
  }
}

// ---- a voxel's group of lanes ----------------------------------------------
struct QvGroup {
  unsigned mask;  // the group's lanes
  int j;          // this lane's place in the group
};

static __device__ __forceinline__ QvGroup qv_group(int lanes) {
  int lane = threadIdx.x & 31;
  QvGroup g;
  g.j = lane % lanes;
  g.mask = (lanes == 32 ? 0xffffffffu : ((1u << lanes) - 1u))
           << (lane - g.j);
  return g;
}

// The sum of x over `width` lanes (a voxel's group, or 32 for the warp) by
// a butterfly: bit-equal on every lane of them.
static __device__ __forceinline__ float qv_lanes_sum(unsigned mask, int width,
                                                     float x) {
#pragma unroll
  for (int o = 1; o < width; o <<= 1)
    x = x + __shfl_xor_sync(mask, x, o, width);
  return x;
}

// ---- the KL backward -------------------------------------------------------
// Its ten sums over the draws: d/d(mu0, ls0, mu1, ls1, od) of q, then of p.
struct QvKlGrads {
  float qm0, qls0, qm1, qls1, qod, pm0, pls0, pm1, pls1, pod;
};

// One draw's terms (pallas_elbo._elbo_bwd_kernel), added to k.
static __device__ __forceinline__ void qv_kl_draw_grads(
    const QvPost& q, const QvPost& p, const QvWhite& qf, const QvWhite& pf,
    float p_ee, float std0, float std1, float bound, float z0, float z1,
    QvKlGrads* k) {
  float l0 = fminf(fmaxf(q.mu0 + z0 * std0, -bound), bound);
  float l1 = fminf(fmaxf(q.mu1 + z0 * q.od + z1 * std1, -bound), bound);
  float rq0 = l0 - q.mu0, rq1 = l1 - q.mu1;
  float rp0 = l0 - p.mu0, rp1 = l1 - p.mu1;
  float wq0 = rq0 * qf.itl, wq1 = rq1 * qf.ibr + rq0 * qf.ibl;
  float wp0 = rp0 * pf.itl, wp1 = rp1 * pf.ibr + rp0 * pf.ibl;
  float dp_l0 = wp0 * pf.itl + wp1 * pf.ibl;
  float dp_l1 = wp1 * pf.ibr;
  float dl0 = dp_l0 - (wq0 * qf.itl + wq1 * qf.ibl);
  float dl1 = dp_l1 - wq1 * qf.ibr;
  k->qm0 = k->qm0 + dl0;
  k->qls0 = k->qls0 + dl0 * z0 * std0;
  k->qm1 = k->qm1 + dl1;
  k->qls1 = k->qls1 + dl1 * z1 * std1;
  k->qod = k->qod + dl1 * z0;
  k->pm0 = k->pm0 - dp_l0;
  k->pls0 = k->pls0 - (wp0 * wp0 + wp1 * rp0 * pf.ibl);
  k->pm1 = k->pm1 - dp_l1;
  k->pls1 = k->pls1 - wp1 * wp1;
  k->pod = k->pod - wp1 * rp0 * p_ee;
}

// One lane's share of voxel v's KL draws: the ten sums over the draws
// first, first + step, ... (qv_kl_reduce adds the lanes' shares).
static __device__ __forceinline__ QvKlGrads qv_kl_grads_part(
    const QvNoise& nz, long long v, const QvPost& q, const QvPost& p,
    float std0, float std1, int s_nll, int s_kl, float bound, int first,
    int step) {
  QvWhite qf = qv_white(q), pf = qv_white(p);
  float p_ee = expf(-p.ls0 - p.ls1);
  QvKlGrads k = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = first; s < s_kl; s += step) {
    float z0, z1;
    qv_draw(nz, nz.zk, v, s, s_nll + s, &z0, &z1);
    qv_kl_draw_grads(q, p, qf, pf, p_ee, std0, std1, bound, z0, z1, &k);
  }
  return k;
}

static __device__ __forceinline__ void qv_kl_reduce(unsigned mask, int width,
                                                    QvKlGrads* k) {
  k->qm0 = qv_lanes_sum(mask, width, k->qm0);
  k->qls0 = qv_lanes_sum(mask, width, k->qls0);
  k->qm1 = qv_lanes_sum(mask, width, k->qm1);
  k->qls1 = qv_lanes_sum(mask, width, k->qls1);
  k->qod = qv_lanes_sum(mask, width, k->qod);
  k->pm0 = qv_lanes_sum(mask, width, k->pm0);
  k->pls0 = qv_lanes_sum(mask, width, k->pls0);
  k->pm1 = qv_lanes_sum(mask, width, k->pm1);
  k->pls1 = qv_lanes_sum(mask, width, k->pls1);
  k->pod = qv_lanes_sum(mask, width, k->pod);
}

// c + a z0 + b z1, and its sums over the draws from the moments
// m = (S, sum z0, sum z1, sum z0^2, sum z0 z1, sum z1^2).
struct QvAff {
  float c, a, b;
};
static __device__ __forceinline__ QvAff qv_aff_lin(QvAff x, float sx, QvAff y,
                                                   float sy) {
  QvAff r = {x.c * sx + y.c * sy, x.a * sx + y.a * sy, x.b * sx + y.b * sy};
  return r;
}
static __device__ __forceinline__ QvAff qv_aff_scale(QvAff x, float s) {
  QvAff r = {x.c * s, x.a * s, x.b * s};
  return r;
}
static __device__ __forceinline__ float qv_sum1(QvAff x, const float* m) {
  return (x.c * m[0] + x.a * m[1]) + x.b * m[2];
}
static __device__ __forceinline__ float qv_sum_z0(QvAff x, const float* m) {
  return (x.c * m[1] + x.a * m[3]) + x.b * m[4];
}
static __device__ __forceinline__ float qv_sum_z1(QvAff x, const float* m) {
  return (x.c * m[2] + x.a * m[4]) + x.b * m[5];
}
static __device__ __forceinline__ float qv_sum2(QvAff x, QvAff y,
                                                const float* m) {
  return (((((x.c * y.c) * m[0] + (x.c * y.a + x.a * y.c) * m[1])
            + (x.c * y.b + x.b * y.c) * m[2]) + (x.a * y.a) * m[3])
          + (x.a * y.b + x.b * y.a) * m[4]) + (x.b * y.b) * m[5];
}

// The ten sums in closed form, no draw clamped: l0 - mu0 = z0 std0 and
// l1 - mu1 = z0 od + z1 std1, so each residual of qv_kl_draw_grads is
// affine in (z0, z1) and each summand a polynomial of degree <= 2.
static __device__ __forceinline__ QvKlGrads qv_kl_grads_moments(
    const QvPost& q, const QvPost& p, const QvWhite& qf, const QvWhite& pf,
    float p_ee, float std0, float std1, const float* m) {
  QvAff rq0 = {0.0f, std0, 0.0f}, rq1 = {0.0f, q.od, std1};
  QvAff rp0 = {q.mu0 - p.mu0, std0, 0.0f};
  QvAff rp1 = {q.mu1 - p.mu1, q.od, std1};
  QvAff wq0 = qv_aff_scale(rq0, qf.itl);
  QvAff wq1 = qv_aff_lin(rq1, qf.ibr, rq0, qf.ibl);
  QvAff wp0 = qv_aff_scale(rp0, pf.itl);
  QvAff wp1 = qv_aff_lin(rp1, pf.ibr, rp0, pf.ibl);
  QvAff dp_l0 = qv_aff_lin(wp0, pf.itl, wp1, pf.ibl);
  QvAff dp_l1 = qv_aff_scale(wp1, pf.ibr);
  QvAff dl0 = qv_aff_lin(dp_l0, 1.0f, qv_aff_lin(wq0, qf.itl, wq1, qf.ibl),
                         -1.0f);
  QvAff dl1 = qv_aff_lin(dp_l1, 1.0f, qv_aff_scale(wq1, qf.ibr), -1.0f);
  float w1r0 = qv_sum2(wp1, rp0, m);
  QvKlGrads k;
  k.qm0 = qv_sum1(dl0, m);
  k.qls0 = qv_sum_z0(dl0, m) * std0;
  k.qm1 = qv_sum1(dl1, m);
  k.qls1 = qv_sum_z1(dl1, m) * std1;
  k.qod = qv_sum_z0(dl1, m);
  k.pm0 = -qv_sum1(dp_l0, m);
  k.pls0 = -(qv_sum2(wp0, wp0, m) + w1r0 * pf.ibl);
  k.pm1 = -qv_sum1(dp_l1, m);
  k.pls1 = -qv_sum2(wp1, wp1, m);
  k.pod = -(w1r0 * p_ee);
  return k;
}

// ---- forward ----------------------------------------------------------------
// One thread a voxel, grid-stride (the wrapper launches ceil(n / block)
// blocks, up to 2^20).
__global__ void __launch_bounds__(QV_ELBO_BLOCK) qv_elbo_fwd_kernel(
    const float* __restrict__ qr, const float* __restrict__ pr,
    const float* __restrict__ y, const float* __restrict__ sig,
    const float* __restrict__ mask, QvNoise nz, int mvg, int s_nll, int s_kl,
    QvDecodeConsts C, const float* __restrict__ table,
    float* __restrict__ nll_out, float* __restrict__ kl_out,
    float* __restrict__ state) {
  extern __shared__ float smem[];
  int T = C.n_taus, K = mvg ? 5 : 4;
  qv_stage_table(table, smem, qv_table_len(T));
  __syncthreads();
  QvTable tb = qv_table(smem, T);
  const bool host = nz.zn != nullptr;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < nz.n; v += stride) {
    float m = mask[v];
    float* st = (mvg && state != nullptr) ? state + v * QV_STATE : nullptr;
    if (m == 0.0f) {
      nll_out[v] = 0.0f;
      kl_out[v] = 0.0f;
      if (st != nullptr)
        for (int i = 0; i < QV_STATE; ++i) st[i] = 0.0f;
      continue;
    }
    QvPost q = qv_unpack(qr + v * K, mvg);
    QvPost p = qv_unpack(pr + v * K, mvg);
    float std0 = expf(q.ls0), std1 = expf(q.ls1);
    const float* yv = y + v * T;
    const float* sv = sig + v * T;

    float nll = 0.0f;
    for (int s = 0; s < s_nll; ++s) {
      float z0, z1;
      qv_draw(nz, host ? nz.zn : nullptr, v, s, s, &z0, &z1);
      float l0 = q.mu0 + z0 * std0;
      float l1 = q.mu1 + z0 * q.od + z1 * std1;
      float oef = qv_sigmoid_f(l0) * C.oef_range + C.min_oef;
      float dbv = qv_sigmoid_f(l1) * C.dbv_range + C.min_dbv;
      nll = nll + qv_nll_row(C, tb, oef, dbv, yv, sv, m);
    }

    float kl;
    if (mvg) {
      QvWhite qf = qv_white(q), pf = qv_white(p);
      float acc = 0.0f, reach = 0.0f;
      float m1 = 0.0f, m2 = 0.0f, m11 = 0.0f, m12 = 0.0f, m22 = 0.0f;
      for (int s = 0; s < s_kl; ++s) {
        float z0, z1;
        qv_draw(nz, host ? nz.zk : nullptr, v, s, s_nll + s, &z0, &z1);
        float u0 = q.mu0 + z0 * std0;
        float u1 = q.mu1 + z0 * q.od + z1 * std1;
        float l0 = fminf(fmaxf(u0, -C.kl_bound), C.kl_bound);
        float l1 = fminf(fmaxf(u1, -C.kl_bound), C.kl_bound);
        float rq0 = l0 - q.mu0, rq1 = l1 - q.mu1;
        float rp0 = l0 - p.mu0, rp1 = l1 - p.mu1;
        float wq0 = rq0 * qf.itl, wq1 = rq1 * qf.ibr + rq0 * qf.ibl;
        float wp0 = rp0 * pf.itl, wp1 = rp1 * pf.ibr + rp0 * pf.ibl;
        acc = acc + 0.5f * ((wp0 * wp0 + wp1 * wp1) - (wq0 * wq0 + wq1 * wq1));
        // the state: the moments, and how far the logits reached
        reach = fmaxf(reach, fmaxf(fabsf(u0), fabsf(u1)));
        m1 = m1 + z0;
        m2 = m2 + z1;
        m11 = fmaf(z0, z0, m11);
        m12 = fmaf(z0, z1, m12);
        m22 = fmaf(z1, z1, m22);
      }
      kl = acc * (1.0f / (float)s_kl) + ((p.ls0 + p.ls1) - (q.ls0 + q.ls1));
      if (st != nullptr) {
        // fmaxf passes over a NaN logit: a NaN in q or in a normal shows
        // in the probe, and flags the voxel as a clamped one does
        float probe = ((q.mu0 + q.mu1) + (std0 + std1 + q.od)) + (m11 + m22);
        st[0] = m1;
        st[1] = m2;
        st[2] = m11;
        st[3] = m12;
        st[4] = m22;
        st[5] = (!(reach <= C.kl_bound) || probe != probe) ? 1.0f : 0.0f;
      }
    } else {
      float vr0 = expf(2.0f * (q.ls0 - p.ls0));
      float vr1 = expf(2.0f * (q.ls1 - p.ls1));
      float d0 = (q.mu0 - p.mu0) * expf(-p.ls0);
      float d1 = (q.mu1 - p.mu1) * expf(-p.ls1);
      kl = 0.5f * (vr0 + d0 * d0 - 1.0f) + p.ls0 - q.ls0
           + 0.5f * (vr1 + d1 * d1 - 1.0f) + p.ls1 - q.ls1;
    }
    nll_out[v] = nll * m;
    kl_out[v] = m > 0.0f ? kl : 0.0f;
  }
}

// ---- backward ---------------------------------------------------------------
// QV_BWD_LANES lanes a voxel, 32 / QV_BWD_LANES voxels a warp turn,
// grid-stride. Every lane of a warp takes the same turns and meets the
// others at the end of each (the ballot of the voxels to replay).
__global__ void __launch_bounds__(QV_ELBO_BLOCK) qv_elbo_bwd_kernel(
    const float* __restrict__ qr, const float* __restrict__ pr,
    const float* __restrict__ y, const float* __restrict__ sig,
    const float* __restrict__ mask, QvNoise nz, int mvg, int s_nll, int s_kl,
    const float* __restrict__ ctn, const float* __restrict__ ctk,
    const float* __restrict__ state, QvDecodeConsts C,
    const float* __restrict__ table, float* __restrict__ dq,
    float* __restrict__ dp, float* __restrict__ dsig,
    float* __restrict__ dy) {
  extern __shared__ float smem[];
  int T = C.n_taus, K = mvg ? 5 : 4;
  qv_stage_table(table, smem, qv_table_len(T));
  __syncthreads();
  QvTable tb = qv_table(smem, T);
  const QvGroup g = qv_group(QV_BWD_LANES);
  const int lane = threadIdx.x & 31;
  const bool host = nz.zn != nullptr;
  const int per_warp = 32 / QV_BWD_LANES;
  long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long base = warp * per_warp; base < nz.n;
       base += warps * per_warp) {
    long long v = base + lane / QV_BWD_LANES;
    bool in = v < nz.n;
    float m = in ? mask[v] : 0.0f;
    bool live = in && m != 0.0f;
    float* dqv = dq + v * K;
    float* dpv = dp + v * K;
    float* dsv = dsig + v * T;
    float* dyv = dy + v * T;
    if (in && !live) {
      if (g.j == 0)
        for (int i = 0; i < K; ++i) dqv[i] = dpv[i] = 0.0f;
      for (int t = g.j; t < T; t += QV_BWD_LANES) dsv[t] = dyv[t] = 0.0f;
    }
    float ct_n = 0.0f, ct_k = 0.0f;
    float g_mu0 = 0.0f, g_ls0 = 0.0f, g_mu1 = 0.0f, g_ls1 = 0.0f, g_od = 0.0f;
    QvKlGrads k = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    bool replay = false;
    if (live) {
      QvPost q = qv_unpack(qr + v * K, mvg);
      QvPost p = qv_unpack(pr + v * K, mvg);
      float std0 = expf(q.ls0), std1 = expf(q.ls1);
      ct_n = ctn[v] * m;                       // the nll row was masked
      ct_k = ctk[v] * (m > 0.0f ? 1.0f : 0.0f);
      const float* yv = y + v * T;
      const float* sv = sig + v * T;

      // NLL side: pathwise gradients through each draw, the taus dealt out
      for (int s = 0; s < s_nll; ++s) {
        float z0, z1;
        qv_draw(nz, host ? nz.zn : nullptr, v, s, s, &z0, &z1);
        float l0 = q.mu0 + z0 * std0;
        float l1 = q.mu1 + z0 * q.od + z1 * std1;
        float s0 = qv_sigmoid_f(l0), s1 = qv_sigmoid_f(l1);
        float oef = s0 * C.oef_range + C.min_oef;
        float dbv = s1 * C.dbv_range + C.min_dbv;
        float t_ref = qv_ref_y(C, yv);
        float p_ref = qv_ref_pred(C, tb, oef, dbv);
        QvNllSums ns = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int t = g.j; t < T; t += QV_BWD_LANES)
          qv_nll_tau_grads(C, tb, t, oef, dbv, yv, sv, m, ct_n, s == 0,
                           t_ref, p_ref, dsv, dyv, &ns);
        ns.eq = qv_lanes_sum(g.mask, QV_BWD_LANES, ns.eq);
        ns.cy = qv_lanes_sum(g.mask, QV_BWD_LANES, ns.cy);
        ns.a_oef = qv_lanes_sum(g.mask, QV_BWD_LANES, ns.a_oef);
        ns.a_dbv = qv_lanes_sum(g.mask, QV_BWD_LANES, ns.a_dbv);
        ns.w_oef = qv_lanes_sum(g.mask, QV_BWD_LANES, ns.w_oef);
        ns.w_dbv = qv_lanes_sum(g.mask, QV_BWD_LANES, ns.w_dbv);
        float doef, ddbv;
        float ky = qv_nll_grads_tail(C, ns, ct_n, t_ref, p_ref, &doef, &ddbv);
        for (int t = g.j; t < T; t += QV_BWD_LANES)
          if (qv_in_window(C, t)) dyv[t] = dyv[t] - ky;
        float dl0 = doef * ((C.oef_range * s0) * (1.0f - s0));
        float dl1 = ddbv * ((C.dbv_range * s1) * (1.0f - s1));
        g_mu0 = g_mu0 + dl0;
        g_ls0 = g_ls0 + dl0 * z0 * std0;
        g_mu1 = g_mu1 + dl1;
        g_ls1 = g_ls1 + dl1 * z1 * std1;
        g_od = g_od + dl1 * z0;
      }

      // KL side: replayed on the voxel's lanes (no state), from the
      // moments, by the warp below (flagged), or analytic (diagonal)
      if (mvg && state == nullptr) {
        k = qv_kl_grads_part(nz, v, q, p, std0, std1, s_nll, s_kl,
                             C.kl_bound, g.j, QV_BWD_LANES);
        qv_kl_reduce(g.mask, QV_BWD_LANES, &k);
      } else if (mvg) {
        const float* st = state + v * QV_STATE;
        replay = st[5] != 0.0f;
        if (!replay) {
          QvWhite qf = qv_white(q), pf = qv_white(p);
          float p_ee = expf(-p.ls0 - p.ls1);
          float mom[6] = {(float)s_kl, st[0], st[1], st[2], st[3], st[4]};
          k = qv_kl_grads_moments(q, p, qf, pf, p_ee, std0, std1, mom);
        }
      } else {
        float vr0 = expf(2.0f * (q.ls0 - p.ls0));
        float vr1 = expf(2.0f * (q.ls1 - p.ls1));
        float ip0 = expf(-2.0f * p.ls0), ip1 = expf(-2.0f * p.ls1);
        float dm0 = (q.mu0 - p.mu0) * ip0, dm1 = (q.mu1 - p.mu1) * ip1;
        k.qm0 = dm0;
        k.qm1 = dm1;
        k.qls0 = vr0 - 1.0f;
        k.qls1 = vr1 - 1.0f;
        k.pm0 = -dm0;
        k.pm1 = -dm1;
        k.pls0 = 1.0f - vr0 - (q.mu0 - p.mu0) * dm0;
        k.pls1 = 1.0f - vr1 - (q.mu1 - p.mu1) * dm1;
      }
    }

    // the warp replays its flagged voxels one by one
    unsigned todo = __ballot_sync(0xffffffffu, replay && g.j == 0);
    while (todo != 0u) {
      int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      long long u = base + src / QV_BWD_LANES;
      QvPost q = qv_unpack(qr + u * 5, true);
      QvPost p = qv_unpack(pr + u * 5, true);
      QvKlGrads kr = qv_kl_grads_part(nz, u, q, p, expf(q.ls0), expf(q.ls1),
                                      s_nll, s_kl, C.kl_bound, lane, 32);
      qv_kl_reduce(0xffffffffu, 32, &kr);
      if (lane / QV_BWD_LANES == src / QV_BWD_LANES) k = kr;
    }

    if (live) {
      if (mvg) {
        float inv_n = 1.0f / (float)s_kl;
        k.qm0 *= inv_n;
        k.qls0 *= inv_n;
        k.qm1 *= inv_n;
        k.qls1 *= inv_n;
        k.qod *= inv_n;
        k.pm0 *= inv_n;
        k.pls0 = k.pls0 * inv_n + 1.0f;   // det term; q's log-det is detached
        k.pm1 *= inv_n;
        k.pls1 = k.pls1 * inv_n + 1.0f;
        k.pod *= inv_n;
      }
      if (g.j == 0) {
        // the chain factors of the squashes (qv_unpack), read again here so
        // that no QvPost lives across the replay
        QvPost q = qv_unpack(qr + v * K, mvg);
        QvPost p = qv_unpack(pr + v * K, mvg);
        dqv[0] = ct_n * g_mu0 + ct_k * k.qm0;
        dqv[1] = (ct_n * g_ls0 + ct_k * k.qls0) * q.c1;
        dqv[2] = ct_n * g_mu1 + ct_k * k.qm1;
        dqv[3] = (ct_n * g_ls1 + ct_k * k.qls1) * q.c3;
        dpv[0] = ct_k * k.pm0;
        dpv[1] = ct_k * k.pls0 * p.c1;
        dpv[2] = ct_k * k.pm1;
        dpv[3] = ct_k * k.pls1 * p.c3;
        if (mvg) {
          dqv[4] = (ct_n * g_od + ct_k * k.qod) * q.c4;
          dpv[4] = ct_k * k.pod * p.c4;
        }
      }
    }
  }
}

static QvNoise qv_noise(const float* zn, const float* zk, long long seed,
                        long long offset, long long n) {
  QvNoise nz = {zn, zk, (unsigned)seed,
                (unsigned)((unsigned long long)seed >> 32), n, offset};
  return nz;
}

extern "C" int qv_elbo_fwd(const float* q, const float* p, const float* y,
                           const float* sig, const float* mask,
                           const float* zn, const float* zk, long long seed,
                           long long offset, long long n, int mvg, int s_nll,
                           int s_kl, QvDecodeConsts C, const float* table, int table_len,
                           float* nll, float* kl, float* state, int grid,
                           void* stream) {
  qv_elbo_fwd_kernel<<<grid, QV_ELBO_BLOCK, table_len * sizeof(float),
                       (cudaStream_t)stream>>>(
      q, p, y, sig, mask, qv_noise(zn, zk, seed, offset, n), mvg, s_nll,
      s_kl, C, table, nll, kl, state);
  return (int)cudaGetLastError();
}

extern "C" int qv_elbo_bwd(const float* q, const float* p, const float* y,
                           const float* sig, const float* mask,
                           const float* zn, const float* zk, long long seed,
                           long long offset, long long n, int mvg, int s_nll,
                           int s_kl, const float* ctn, const float* ctk,
                           const float* state, QvDecodeConsts C,
                           const float* table, int table_len, float* dq,
                           float* dp, float* dsig, float* dy, int grid,
                           void* stream) {
  qv_elbo_bwd_kernel<<<grid, QV_ELBO_BLOCK, table_len * sizeof(float),
                       (cudaStream_t)stream>>>(
      q, p, y, sig, mask, qv_noise(zn, zk, seed, offset, n), mvg, s_nll,
      s_kl, ctn, ctk, state, C, table, dq, dp, dsig, dy);
  return (int)cudaGetLastError();
}
