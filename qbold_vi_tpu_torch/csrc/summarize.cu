// Kernels D and E: the sampled posterior summaries and the sampled KL map.
//
// D replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_summarize.py::
// mc_posterior_summaries[_packed] (_summarize_kernel, pallas_call at :319):
// per voxel, S logit-Normal draws of the raw head q, forward-transformed to
// (OEF, DBV) with R2' = dw OEF DBV, and their means and biased variances
// E[x^2] - E[x]^2 (clamped at 0). Draws come in antithetic pairs (z, -z),
// z accumulated first, unless S is odd or below 2 (then S iid draws).
// E replaces mc_kl_map (_kl_kernel, pallas_call at :221): the reduced
// sampled KL(q || p) of dist/logit_mvn.py::mvg_kl_samples,
//   mean_s 0.5 (swr_p(l_s) - swr_q(l_s)) + (ls_p0 + ls_p1) - (ls_q0 + ls_q1),
// l_s a draw of q clamped at +-KL_BOUND, the whitening factors of q and p
// hoisted out of the draw loop (elbo_math.cuh::qv_white).
//
// One kernel D serves both layouts through strides: the (N, 4|5) rows of
// the encoder path and the channel-major (5, N) q of the fused stream-1
// encode (kernel C), writing (N, 3) or (3, N) outputs to match. The TPU's
// (5, 8, N/8) packing and padding are TPU layouts and are not carried over.
//
// Noise: host normals z (draws, N, 2) in the JAX layout, or device noise:
// pairs 2k and 2k + 1 of voxel v from words (0, 1) and (2, 3) of the
// Philox4x32-10 block with counter (offset + v, k) keyed by the seed
// (elbo_math.cuh::qv_philox, replayed on the host by ops/summarize.py::
// mc_philox_normals): one block for two pairs. Kernel F keeps one block a
// pair (qv_normal2), so its stream is not D's or E's. ``offset`` is the
// index of the first voxel in the request, so a chunked request draws
// what a whole one would. The TPU kernels reseed per grid program
// instead, which ties their streams to the tile size.
//
// Bound: operations. Per voxel D reads 20 B and writes 24 B against S/4
// Philox blocks, S/2 Box-Muller pairs and S sigmoids pairs (~40 float
// operations a draw); E reads 40 B and writes 4 B against S draws of ~40.
// D: one thread per voxel, float32 accumulators in registers, the sums in
// the plain versions' order (ops/summarize.py). The work a draw is what D's
// time is made of (PERF.md: a voxel's own work is ~2% of it): one Philox
// block serves two pairs, and the sigmoids take an approximate reciprocal
// of 1 + __expf(-x) (MUFU.EX2 and MUFU.RCP, a few ulp) in place of expf and
// the IEEE division, within the rtol 1e-4 gate on the means.
// E runs on one subject (73,728 voxels), too few threads to fill the card
// at one a voxel (PERF.md: 4x the voxels took 3.2x the time), and drawing is
// 71% of it: L lanes take a voxel, lane j its Philox blocks k = j (mod L)
// -- the same draws -- and the lanes' sums meet in a fixed shuffle tree.

#include "elbo_math.cuh"
#include "quad_math.cuh"

struct QvMcNoise {
  const float* z;   // (draws, n, 2), or null: Philox draws
  long long offset;  // global index of voxel 0
  unsigned k0, k1;   // Philox key (the seed)
};

// Pairs d and d + 1 (d even; d + 1 only where below draws) of voxel v as
// z[0..1] and z[2..3].
static __device__ __forceinline__ void qv_mc_normals(const QvMcNoise& nz,
                                                     long long n, long long v,
                                                     int d, int draws,
                                                     float z[4]) {
  if (nz.z != nullptr) {
    const float* p = nz.z + ((long long)d * n + v) * 2;
    z[0] = p[0];
    z[1] = p[1];
    if (d + 1 < draws) {
      z[2] = p[2 * n];
      z[3] = p[2 * n + 1];
    }
  } else {
    unsigned c[4];
    qv_philox(nz.offset + v, (unsigned)(d >> 1), nz.k0, nz.k1, c);
    qv_box_muller(c[0], c[1], &z[0], &z[1]);
    if (d + 1 < draws) qv_box_muller(c[2], c[3], &z[2], &z[3]);
  }
}

// sigmoid(x) = 1 / (1 + e^-x) by the hardware's exponential and reciprocal
// (1 / inf = 0 where e^-x overflows).
static __device__ __forceinline__ float qv_sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

struct QvMoments {
  float o, o2, d, d2, r, r2;
};

// One draw's (OEF, DBV, R2') added to the running sums
// (dist/logit_mvn.py::LogitMVN.sample, then the r2p product).
static __device__ __forceinline__ void qv_mc_accumulate(
    const QvPost& u, float std0, float std1, bool mvg, const QvRanges& r,
    float z0, float z1, QvMoments* m) {
  float oef_l = u.mu0 + z0 * std0;
  float dbv_l = mvg ? (u.mu1 + z0 * u.od) + z1 * std1 : u.mu1 + z1 * std1;
  float oef = qv_sigmoid_fast(oef_l) * r.b + r.a;
  float dbv = qv_sigmoid_fast(dbv_l) * r.d + r.c;
  float r2p = (r.dw * oef) * dbv;
  m->o = m->o + oef;
  m->o2 = m->o2 + oef * oef;
  m->d = m->d + dbv;
  m->d2 = m->d2 + dbv * dbv;
  m->r = m->r + r2p;
  m->r2 = m->r2 + r2p * r2p;
}

__global__ void qv_mc_summaries_kernel(
    const float* __restrict__ params, long long n, long long p_vox,
    long long p_chan, int mvg, QvRanges r, QvMcNoise nz, int draws,
    int antithetic, float inv_n, float* __restrict__ means,
    float* __restrict__ vars, long long o_vox, long long o_chan) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += stride) {
    float raw[5];
#pragma unroll
    for (int j = 0; j < 4; ++j) raw[j] = params[v * p_vox + j * p_chan];
    raw[4] = mvg ? params[v * p_vox + 4 * p_chan] : 0.0f;
    QvPost u = qv_unpack(raw, mvg != 0);
    float std0 = expf(u.ls0), std1 = expf(u.ls1);
    QvMoments m = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int d = 0; d < draws; d += 2) {
      float z[4];
      qv_mc_normals(nz, n, v, d, draws, z);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (d + h == draws) break;
        qv_mc_accumulate(u, std0, std1, mvg != 0, r, z[2 * h], z[2 * h + 1],
                         &m);
        if (antithetic)
          qv_mc_accumulate(u, std0, std1, mvg != 0, r, -z[2 * h],
                           -z[2 * h + 1], &m);
      }
    }
    float mo = m.o * inv_n, md = m.d * inv_n, mr = m.r * inv_n;
    means[v * o_vox] = mo;
    means[v * o_vox + o_chan] = md;
    means[v * o_vox + 2 * o_chan] = mr;
    vars[v * o_vox] = fmaxf(m.o2 * inv_n - mo * mo, 0.0f);
    vars[v * o_vox + o_chan] = fmaxf(m.d2 * inv_n - md * md, 0.0f);
    vars[v * o_vox + 2 * o_chan] = fmaxf(m.r2 * inv_n - mr * mr, 0.0f);
  }
}

// One draw's reduced-KL term 0.5 (swr_p(l) - swr_q(l)).
static __device__ __forceinline__ float qv_kl_draw(const QvPost& q,
                                                   const QvPost& p,
                                                   const QvWhite& qf,
                                                   const QvWhite& pf,
                                                   float std0, float std1,
                                                   float bound, float z0,
                                                   float z1) {
  float l0 = fminf(fmaxf(q.mu0 + z0 * std0, -bound), bound);
  float l1 = fminf(fmaxf((q.mu1 + z0 * q.od) + z1 * std1, -bound), bound);
  float rq0 = l0 - q.mu0, rq1 = l1 - q.mu1;
  float rp0 = l0 - p.mu0, rp1 = l1 - p.mu1;
  float wq0 = rq0 * qf.itl, wq1 = rq1 * qf.ibr + rq0 * qf.ibl;
  float wp0 = rp0 * pf.itl, wp1 = rp1 * pf.ibr + rp0 * pf.ibl;
  return 0.5f * ((wp0 * wp0 + wp1 * wp1) - (wq0 * wq0 + wq1 * wq1));
}

// Kernel E, QV_KL_LANES lanes a voxel (the grid covers n L threads): lane j
// sums the draws of the voxel's Philox blocks k = j, j + L, ... (draws 2k,
// then 2k + 1 where below S) in order, then the lanes' sums meet in the
// xor-shuffle tree ((a0 + a1) + (a2 + a3)) + ..., the same on every lane
// (float addition commutes). Lanes past n take voxel n - 1 and write nothing, so every lane
// of a warp reaches the shuffles. ops/summarize.py::KL_LANES mirrors L for
// the host replay; other L were timed with edited copies (PERF.md).
#define QV_KL_LANES 2

__global__ void qv_mc_kl_kernel(const float* __restrict__ qr,
                                const float* __restrict__ pr, long long n,
                                int mvg, QvMcNoise nz, int draws, float bound,
                                float* __restrict__ kl) {
  const int K = mvg ? 5 : 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int L = QV_KL_LANES;
  const long long v = i / L < n ? i / L : n - 1;
  const int j = (int)(i % L);
  QvPost q = qv_unpack(qr + v * K, mvg != 0);
  QvPost p = qv_unpack(pr + v * K, mvg != 0);
  float std0 = expf(q.ls0), std1 = expf(q.ls1);
  QvWhite qf = qv_white(q), pf = qv_white(p);
  float acc = 0.0f;
  for (int d = 2 * j; d < draws; d += 2 * L) {
    float z[4];
    qv_mc_normals(nz, n, v, d, draws, z);
    acc = acc + qv_kl_draw(q, p, qf, pf, std0, std1, bound, z[0], z[1]);
    if (d + 1 < draws)
      acc = acc + qv_kl_draw(q, p, qf, pf, std0, std1, bound, z[2], z[3]);
  }
#pragma unroll
  for (int m = 1; m < L; m <<= 1)
    acc = acc + __shfl_xor_sync(0xffffffffu, acc, m);
  if (j == 0 && i / L < n)
    kl[v] = acc * (1.0f / (float)draws) + ((p.ls0 + p.ls1) - (q.ls0 + q.ls1));
}

static QvMcNoise qv_mc_noise(const float* z, long long offset,
                             long long seed) {
  QvMcNoise nz = {z, offset, (unsigned)seed,
                  (unsigned)((unsigned long long)seed >> 32)};
  return nz;
}

extern "C" int qv_mc_summaries(const float* params, long long n,
                               long long p_vox, long long p_chan, int mvg,
                               QvRanges r, const float* z, long long offset,
                               long long seed, int draws, int antithetic,
                               float inv_n, float* means, float* vars,
                               long long o_vox, long long o_chan, int grid,
                               int block, void* stream) {
  qv_mc_summaries_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      params, n, p_vox, p_chan, mvg, r, qv_mc_noise(z, offset, seed), draws,
      antithetic, inv_n, means, vars, o_vox, o_chan);
  return (int)cudaGetLastError();
}

extern "C" int qv_mc_kl_map(const float* q, const float* p, long long n,
                            int mvg, const float* z, long long offset,
                            long long seed, int draws, float bound, float* kl,
                            int block, void* stream) {
  if (block % 32 != 0 || block < 32 || block > 1024)
    return (int)cudaErrorInvalidValue;
  const long long grid = (n * QV_KL_LANES + block - 1) / block;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  qv_mc_kl_kernel<<<(int)grid, block, 0, (cudaStream_t)stream>>>(
      q, p, n, mvg, qv_mc_noise(z, offset, seed), draws, bound, kl);
  return (int)cudaGetLastError();
}
