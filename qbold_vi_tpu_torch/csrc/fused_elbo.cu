// Kernel F: the fused fine-tune ELBO -- posterior sampling + physics decode
// + reconstruction NLL + sampled MVG KL (or the analytic diagonal KL) per
// voxel, forward and closed-form backward.
//
// Replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_elbo.py::
// make_fused_elbo (_elbo_fwd_kernel / _elbo_bwd_kernel, pallas_call at :464
// and :492). One thread per voxel, grid-stride, reading q and p (N, K),
// y and sigma (N, T) and the mask once and writing two (N,) rows; the
// backward recomputes every draw and writes dq, dp (N, K), dsigma, dy
// (N, T). None of the TPU's (8 x 512) packing, padding, VMEM budget or
// trial-fold rules is carried over.
//
// Noise: host mode reads z_nll (s_nll, N, 2) and z_kl (s_kl, N, 2) as the
// JAX layout has them; device mode draws each (voxel, draw) pair from a
// Philox4x32-10 counter keyed by the seed (elbo_math.cuh::qv_normal2), so
// the backward replays the forward's draws exactly with no per-program
// reseeding. Draws 0..s_nll-1 feed the NLL, s_nll.. the KL.
//
// Bound: operations. Per voxel the forward runs s_nll decodes (T + 1
// Clenshaw evaluations each) and s_kl = 70 KL draws (a Philox block, a
// Box-Muller and ~20 flops each) against 33 floats read and 2 written;
// the backward about twice that. Register pressure is held down by
// keeping no per-tau arrays: dsigma and dy go straight to their output
// rows (elbo_math.cuh::qv_nll_row_grads).

#include "elbo_math.cuh"

struct QvNoise {
  const float* zn;  // (s_nll, n, 2) or null: device noise
  const float* zk;  // (s_kl, n, 2) or null
  unsigned k0, k1;  // Philox key (the seed)
  long long n;
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
    qv_normal2(v, draw, nz.k0, nz.k1, z0, z1);
  }
}

__global__ void qv_elbo_fwd_kernel(
    const float* __restrict__ qr, const float* __restrict__ pr,
    const float* __restrict__ y, const float* __restrict__ sig,
    const float* __restrict__ mask, QvNoise nz, int mvg, int s_nll, int s_kl,
    QvDecodeConsts C, const float* __restrict__ table,
    float* __restrict__ nll_out, float* __restrict__ kl_out) {
  extern __shared__ float smem[];
  int T = C.n_taus, K = mvg ? 5 : 4;
  qv_stage_table(table, smem, qv_table_len(T));
  __syncthreads();
  QvTable tb = qv_table(smem, T);
  bool host = nz.zn != nullptr;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < nz.n; v += stride) {
    QvPost q = qv_unpack(qr + v * K, mvg);
    QvPost p = qv_unpack(pr + v * K, mvg);
    float std0 = expf(q.ls0), std1 = expf(q.ls1);
    float m = mask[v];
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
      float acc = 0.0f;
      for (int s = 0; s < s_kl; ++s) {
        float z0, z1;
        qv_draw(nz, host ? nz.zk : nullptr, v, s, s_nll + s, &z0, &z1);
        float l0 = fminf(fmaxf(q.mu0 + z0 * std0, -C.kl_bound), C.kl_bound);
        float l1 = fminf(fmaxf(q.mu1 + z0 * q.od + z1 * std1, -C.kl_bound),
                         C.kl_bound);
        float rq0 = l0 - q.mu0, rq1 = l1 - q.mu1;
        float rp0 = l0 - p.mu0, rp1 = l1 - p.mu1;
        float wq0 = rq0 * qf.itl, wq1 = rq1 * qf.ibr + rq0 * qf.ibl;
        float wp0 = rp0 * pf.itl, wp1 = rp1 * pf.ibr + rp0 * pf.ibl;
        acc = acc + 0.5f * ((wp0 * wp0 + wp1 * wp1) - (wq0 * wq0 + wq1 * wq1));
      }
      kl = acc * (1.0f / (float)s_kl) + ((p.ls0 + p.ls1) - (q.ls0 + q.ls1));
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

__global__ void qv_elbo_bwd_kernel(
    const float* __restrict__ qr, const float* __restrict__ pr,
    const float* __restrict__ y, const float* __restrict__ sig,
    const float* __restrict__ mask, QvNoise nz, int mvg, int s_nll, int s_kl,
    const float* __restrict__ ctn, const float* __restrict__ ctk,
    QvDecodeConsts C, const float* __restrict__ table,
    float* __restrict__ dq, float* __restrict__ dp, float* __restrict__ dsig,
    float* __restrict__ dy) {
  extern __shared__ float smem[];
  int T = C.n_taus, K = mvg ? 5 : 4;
  qv_stage_table(table, smem, qv_table_len(T));
  __syncthreads();
  QvTable tb = qv_table(smem, T);
  bool host = nz.zn != nullptr;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < nz.n; v += stride) {
    QvPost q = qv_unpack(qr + v * K, mvg);
    QvPost p = qv_unpack(pr + v * K, mvg);
    float std0 = expf(q.ls0), std1 = expf(q.ls1);
    float m = mask[v];
    float ct_n = ctn[v] * m;                   // the nll row was masked
    float ct_k = ctk[v] * (m > 0.0f ? 1.0f : 0.0f);
    const float* yv = y + v * T;
    const float* sv = sig + v * T;

    // NLL side: pathwise gradients through each draw
    float g_mu0 = 0.0f, g_ls0 = 0.0f, g_mu1 = 0.0f, g_ls1 = 0.0f, g_od = 0.0f;
    for (int s = 0; s < s_nll; ++s) {
      float z0, z1;
      qv_draw(nz, host ? nz.zn : nullptr, v, s, s, &z0, &z1);
      float l0 = q.mu0 + z0 * std0;
      float l1 = q.mu1 + z0 * q.od + z1 * std1;
      float s0 = qv_sigmoid_f(l0), s1 = qv_sigmoid_f(l1);
      float oef = s0 * C.oef_range + C.min_oef;
      float dbv = s1 * C.dbv_range + C.min_dbv;
      float doef, ddbv;
      qv_nll_row_grads(C, tb, oef, dbv, yv, sv, m, ct_n, s == 0,
                       dsig + v * T, dy + v * T, &doef, &ddbv);
      float dl0 = doef * ((C.oef_range * s0) * (1.0f - s0));
      float dl1 = ddbv * ((C.dbv_range * s1) * (1.0f - s1));
      g_mu0 = g_mu0 + dl0;
      g_ls0 = g_ls0 + dl0 * z0 * std0;
      g_mu1 = g_mu1 + dl1;
      g_ls1 = g_ls1 + dl1 * z1 * std1;
      g_od = g_od + dl1 * z0;
    }

    // KL side
    float k_qm0, k_qls0, k_qm1, k_qls1, k_qod, k_pm0, k_pls0, k_pm1, k_pls1,
        k_pod;
    if (mvg) {
      QvWhite qf = qv_white(q), pf = qv_white(p);
      float p_ee = expf(-p.ls0 - p.ls1);
      k_qm0 = k_qls0 = k_qm1 = k_qls1 = k_qod = 0.0f;
      k_pm0 = k_pls0 = k_pm1 = k_pls1 = k_pod = 0.0f;
      for (int s = 0; s < s_kl; ++s) {
        float z0, z1;
        qv_draw(nz, host ? nz.zk : nullptr, v, s, s_nll + s, &z0, &z1);
        float l0 = fminf(fmaxf(q.mu0 + z0 * std0, -C.kl_bound), C.kl_bound);
        float l1 = fminf(fmaxf(q.mu1 + z0 * q.od + z1 * std1, -C.kl_bound),
                         C.kl_bound);
        float rq0 = l0 - q.mu0, rq1 = l1 - q.mu1;
        float rp0 = l0 - p.mu0, rp1 = l1 - p.mu1;
        float wq0 = rq0 * qf.itl, wq1 = rq1 * qf.ibr + rq0 * qf.ibl;
        float wp0 = rp0 * pf.itl, wp1 = rp1 * pf.ibr + rp0 * pf.ibl;
        float dp_l0 = wp0 * pf.itl + wp1 * pf.ibl;
        float dp_l1 = wp1 * pf.ibr;
        float dl0 = dp_l0 - (wq0 * qf.itl + wq1 * qf.ibl);
        float dl1 = dp_l1 - wq1 * qf.ibr;
        k_qm0 = k_qm0 + dl0;
        k_qls0 = k_qls0 + dl0 * z0 * std0;
        k_qm1 = k_qm1 + dl1;
        k_qls1 = k_qls1 + dl1 * z1 * std1;
        k_qod = k_qod + dl1 * z0;
        k_pm0 = k_pm0 - dp_l0;
        k_pls0 = k_pls0 - (wp0 * wp0 + wp1 * rp0 * pf.ibl);
        k_pm1 = k_pm1 - dp_l1;
        k_pls1 = k_pls1 - wp1 * wp1;
        k_pod = k_pod - wp1 * rp0 * p_ee;
      }
      float inv_n = 1.0f / (float)s_kl;
      k_qm0 *= inv_n;
      k_qls0 *= inv_n;
      k_qm1 *= inv_n;
      k_qls1 *= inv_n;
      k_qod *= inv_n;
      k_pm0 *= inv_n;
      k_pls0 = k_pls0 * inv_n + 1.0f;   // det term; q's log-det is detached
      k_pm1 *= inv_n;
      k_pls1 = k_pls1 * inv_n + 1.0f;
      k_pod *= inv_n;
    } else {
      float vr0 = expf(2.0f * (q.ls0 - p.ls0));
      float vr1 = expf(2.0f * (q.ls1 - p.ls1));
      float ip0 = expf(-2.0f * p.ls0), ip1 = expf(-2.0f * p.ls1);
      float dm0 = (q.mu0 - p.mu0) * ip0, dm1 = (q.mu1 - p.mu1) * ip1;
      k_qm0 = dm0;
      k_qm1 = dm1;
      k_qls0 = vr0 - 1.0f;
      k_qls1 = vr1 - 1.0f;
      k_pm0 = -dm0;
      k_pm1 = -dm1;
      k_pls0 = 1.0f - vr0 - (q.mu0 - p.mu0) * dm0;
      k_pls1 = 1.0f - vr1 - (q.mu1 - p.mu1) * dm1;
      k_qod = 0.0f;
      k_pod = 0.0f;
    }

    float* dqv = dq + v * K;
    float* dpv = dp + v * K;
    dqv[0] = ct_n * g_mu0 + ct_k * k_qm0;
    dqv[1] = (ct_n * g_ls0 + ct_k * k_qls0) * q.c1;
    dqv[2] = ct_n * g_mu1 + ct_k * k_qm1;
    dqv[3] = (ct_n * g_ls1 + ct_k * k_qls1) * q.c3;
    dpv[0] = ct_k * k_pm0;
    dpv[1] = ct_k * k_pls0 * p.c1;
    dpv[2] = ct_k * k_pm1;
    dpv[3] = ct_k * k_pls1 * p.c3;
    if (mvg) {
      dqv[4] = (ct_n * g_od + ct_k * k_qod) * q.c4;
      dpv[4] = ct_k * k_pod * p.c4;
    }
  }
}

extern "C" int qv_elbo_fwd(const float* q, const float* p, const float* y,
                           const float* sig, const float* mask,
                           const float* zn, const float* zk, long long seed,
                           long long n, int mvg, int s_nll, int s_kl,
                           QvDecodeConsts C, const float* table, int table_len,
                           float* nll, float* kl, int grid, int block,
                           void* stream) {
  QvNoise nz = {zn, zk, (unsigned)seed, (unsigned)((unsigned long long)seed >> 32),
                n};
  qv_elbo_fwd_kernel<<<grid, block, table_len * sizeof(float),
                       (cudaStream_t)stream>>>(q, p, y, sig, mask, nz, mvg,
                                               s_nll, s_kl, C, table, nll, kl);
  return (int)cudaGetLastError();
}

extern "C" int qv_elbo_bwd(const float* q, const float* p, const float* y,
                           const float* sig, const float* mask,
                           const float* zn, const float* zk, long long seed,
                           long long n, int mvg, int s_nll, int s_kl,
                           const float* ctn, const float* ctk,
                           QvDecodeConsts C, const float* table, int table_len,
                           float* dq, float* dp, float* dsig, float* dy,
                           int grid, int block, void* stream) {
  QvNoise nz = {zn, zk, (unsigned)seed, (unsigned)((unsigned long long)seed >> 32),
                n};
  qv_elbo_bwd_kernel<<<grid, block, table_len * sizeof(float),
                       (cudaStream_t)stream>>>(q, p, y, sig, mask, nz, mvg,
                                               s_nll, s_kl, ctn, ctk, C, table,
                                               dq, dp, dsig, dy);
  return (int)cudaGetLastError();
}
