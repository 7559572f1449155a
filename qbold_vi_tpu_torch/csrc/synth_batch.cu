// Kernel S: the streaming synthetic pretraining batch.
//
// No TPU kernel stands behind it: in the JAX package the batch is
// qbold_vi_tpu/train/steps.py::stream_synthetic_batch (:389), which XLA
// fuses into the jitted pretrain step. Its plain version here is
// qbold_vi_tpu_torch/train/steps.py::stream_synthetic_batch, a chain of
// eager elementwise launches (the Clenshaw sum alone is 21 terms a tau).
//
// Per voxel v of the batch:
//   (oef, dbv) from the population mixture (synth.sample_batch_params: a
//   uniform_prop share uniform on the range, the rest a clipped normal for
//   OEF and a truncated normal for DBV, the latter by erfinvf of a uniform
//   on [erf(a / sqrt 2), erf(b / sqrt 2)), as synth.truncated_normal);
//   y = (oef, dbv, r2') with r2' = (dw_coeff hct oef) dbv;
//   where misalign_prob > 0, the taus after a drawn index see a perturbed
//   (oef, dbv) (physics.misalign_params);
//   x = the full SDR + blood signal per tau (elbo_math.cuh::qv_signal, the
//   Chebyshev surrogate or the 16-node Gauss-Jacobi lattice);
// then, where the scan simulates noise, x += z mean_t / snr_{v,t}, with the
// batch-mean signal per tau and snr = U(50, 120) times the tau's profile
// (physics.add_acquisition_noise).
//
// Draws: Philox4x32-10 keyed by the step's seed (elbo_math.cuh::qv_philox),
// counter (v, k), each 32-bit word's top 24 bits as a uniform on [0, 1),
// pairs of words as two Box-Muller normals (qv_box_muller):
//   k = 0: sel_o, sel_d, oef_u, dbv_u;
//   k = 1: (oef_n, z_oef) from words 0, 1; dbv_n (a uniform), mis_u;
//   k = 2: (z_dbv, -) from words 0, 1; from_idx = 4 + the top 24 bits of
//          word 2 times (T - 5), shifted down 24; snr_u;
//   k = 3 + j: noise normals 4j .. 4j + 3 of the voxel's taus.
// ops/synth_batch.py::synth_philox_draws replays them on the host.
//
// Two passes. Pass 1 (qv_synth_batch_kernel), a fixed grid striding over
// the voxels, writes y and x and per block the per-tau sums of x in
// double. Pass 2 (qv_synth_noise_kernel): every block sums those partials
// in the same fixed order (lane-strided, then a shuffle tree) to the
// batch mean per tau, then adds each voxel's noise, its normals drawn
// again from the same counters, so the batch is deterministic.
//
// A trial axis (qv_synth_batch_trials): P batches of n voxels each, one
// launch of each pass for all of them. Block row blockIdx.y is trial j:
// it draws under seeds[j] with the counters (v, k) of its own voxels, and
// writes x, y and its partials at trial j's offsets; pass 2's row j sums
// only trial j's partials. Each trial's blocks do what a single launch
// under seeds[j] does, in the same order, so trial j's batch is bit-equal
// to it (the noise of a batch scales with its own mean signal, so P
// batches are not one batch of P n voxels). qv_synth_batch is the
// one-trial launch (seeds NULL: the key is the scalar seed).
//
// Bound: bytes. A voxel writes 3 + T floats, and the noise pass reads and
// writes the T again (36.9 MB at 256,000 voxels and 11 taus); its math is
// ~100 float operations and 2 exponentials a tau (the surrogate) and ~20
// special functions a voxel. A simple kernel: the batch is not fused into
// the step, and the step's launches are not captured.

#include "elbo_math.cuh"

#define QV_SYNTH_BLOCK 128
#define QV_SYNTH_MAX_T 32

// Scalars of the population mixture, the misalignment and the noise, each a
// float32 rounding of the config's value (ops/synth_batch.py::SynthConsts).
struct QvSynthConsts {
  int misalign, noise;
  float oef_lo, oef_hi, oef_mean, oef_std;
  float dbv_lo, dbv_hi, dbv_mean, dbv_std;
  float tn_a, tn_b;            // the truncated normal's standardised bounds
  float uniform_prop, misalign_prob, k_r2p, snr_lo, snr_hi;
};

static __device__ __forceinline__ float qv_unit(unsigned w) {
  return (float)(w >> 8) * 5.9604644775390625e-8f;
}

// physics.uniform_map: max(lo, u (hi - lo) + lo), hi - lo in float32.
static __device__ __forceinline__ float qv_umap(float u, float lo, float hi) {
  return fmaxf(lo, u * (hi - lo) + lo);
}

static __device__ __forceinline__ float qv_clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// The voxel's population draws, misalignment and label.
struct QvSynthVoxel {
  float oef, dbv, r2p, mis_oef, mis_dbv;
  int from;  // first tau index NOT perturbed is from + 1; -1: no misalignment
};

static __device__ __forceinline__ QvSynthVoxel qv_synth_voxel(
    const QvSynthConsts& S, int T, long long v, unsigned k0, unsigned k1) {
  unsigned c0[4], c1[4], c2[4];
  qv_philox(v, 0u, k0, k1, c0);
  qv_philox(v, 1u, k0, k1, c1);
  QvSynthVoxel o;
  float oef_n, z_oef;
  qv_box_muller(c1[0], c1[1], &oef_n, &z_oef);
  float oef_u = qv_umap(qv_unit(c0[2]), S.oef_lo, S.oef_hi);
  oef_n = qv_clip(oef_n * S.oef_std + S.oef_mean, S.oef_lo, S.oef_hi);
  o.oef = qv_unit(c0[0]) < S.uniform_prop ? oef_u : oef_n;

  float dbv_u = qv_umap(qv_unit(c0[3]), S.dbv_lo, S.dbv_hi);
  const float sqrt2 = 1.41421353816986083984375f;  // float32(sqrt(2))
  float va = qv_umap(qv_unit(c1[2]), erff(S.tn_a / sqrt2),
                     erff(S.tn_b / sqrt2));
  float zt = sqrt2 * erfinvf(va);
  const float inf = __int_as_float(0x7f800000);
  zt = qv_clip(zt, nextafterf(S.tn_a, inf), nextafterf(S.tn_b, -inf));
  float dbv_n = zt * S.dbv_std + S.dbv_mean;
  o.dbv = qv_unit(c0[1]) < S.uniform_prop ? dbv_u : dbv_n;
  o.r2p = (S.k_r2p * o.oef) * o.dbv;

  o.from = -1;
  o.mis_oef = o.oef;
  o.mis_dbv = o.dbv;
  if (S.misalign) {
    qv_philox(v, 2u, k0, k1, c2);
    float z_dbv, unused;
    qv_box_muller(c2[0], c2[1], &z_dbv, &unused);
    if (qv_unit(c1[3]) < S.misalign_prob) {
      o.from = 4 + (int)(((unsigned long long)(c2[2] >> 8)
                          * (unsigned long long)(T - 5)) >> 24);
      o.mis_oef = qv_clip(z_oef * 0.15f + o.oef, 0.05f, 0.8f);
      o.mis_dbv = qv_clip(z_dbv * 0.05f + o.dbv, 0.002f, 0.3f);
    }
  }
  return o;
}

// Block row blockIdx.y's key: seeds[trial], or k0/k1 as given when seeds
// is NULL (the one-trial launch).
static __device__ __forceinline__ void qv_synth_key(
    const unsigned long long* seeds, unsigned* k0, unsigned* k1) {
  if (seeds != nullptr) {
    const unsigned long long s = seeds[blockIdx.y];
    *k0 = (unsigned)s;
    *k1 = (unsigned)(s >> 32);
  }
}

__global__ void __launch_bounds__(QV_SYNTH_BLOCK) qv_synth_batch_kernel(
    long long n, QvDecodeConsts C, const float* __restrict__ table,
    int table_len, QvSynthConsts S, unsigned k0, unsigned k1,
    const unsigned long long* __restrict__ seeds,
    float* __restrict__ x, float* __restrict__ y,
    double* __restrict__ partial) {
  extern __shared__ float smem[];
  __shared__ double acc[QV_SYNTH_MAX_T * QV_SYNTH_BLOCK];
  const int T = C.n_taus;
  qv_synth_key(seeds, &k0, &k1);
  x += (long long)blockIdx.y * n * T;
  y += (long long)blockIdx.y * n * 3;
  partial += (long long)blockIdx.y * gridDim.x * T;
  qv_stage_table(table, smem, table_len);
  for (int t = 0; t < T; ++t) acc[t * QV_SYNTH_BLOCK + threadIdx.x] = 0.0;
  __syncthreads();
  const QvTable tb = qv_table(smem, T);

  for (long long v = (long long)blockIdx.x * QV_SYNTH_BLOCK + threadIdx.x;
       v < n; v += (long long)gridDim.x * QV_SYNTH_BLOCK) {
    QvSynthVoxel o = qv_synth_voxel(S, T, v, k0, k1);
    y[v * 3] = o.oef;
    y[v * 3 + 1] = o.dbv;
    y[v * 3 + 2] = o.r2p;
    for (int t = 0; t < T; ++t) {
      bool mis = o.from >= 0 && t > o.from;
      float pred = qv_signal(C, tb, t, mis ? o.mis_oef : o.oef,
                             mis ? o.mis_dbv : o.dbv).pred;
      x[v * T + t] = pred;
      acc[t * QV_SYNTH_BLOCK + threadIdx.x] += (double)pred;
    }
  }
  __syncthreads();
  // per tau, a fixed tree over the block's threads
  for (int s = QV_SYNTH_BLOCK / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      for (int t = 0; t < T; ++t)
        acc[t * QV_SYNTH_BLOCK + threadIdx.x] +=
            acc[t * QV_SYNTH_BLOCK + threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x < T)
    partial[(long long)blockIdx.x * T + threadIdx.x] =
        acc[threadIdx.x * QV_SYNTH_BLOCK];
}

__global__ void __launch_bounds__(QV_SYNTH_BLOCK) qv_synth_noise_kernel(
    long long n, int T, const double* __restrict__ partial, int n_partial,
    const float* __restrict__ prof, QvSynthConsts S, unsigned k0,
    unsigned k1, const unsigned long long* __restrict__ seeds,
    float* __restrict__ x) {
  __shared__ float mean[QV_SYNTH_MAX_T];
  qv_synth_key(seeds, &k0, &k1);
  x += (long long)blockIdx.y * n * T;
  partial += (long long)blockIdx.y * n_partial * T;
  // warp w sums taus w, w + 4, ...: each lane a strided share of the
  // partials in order, then a fixed shuffle tree -- the same sum in every
  // block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < T; t += QV_SYNTH_BLOCK / 32) {
    double s = 0.0;
    for (int b = lane; b < n_partial; b += 32) s += partial[(long long)b * T + t];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) mean[t] = (float)(s / (double)n);
  }
  __syncthreads();

  for (long long v = (long long)blockIdx.x * QV_SYNTH_BLOCK + threadIdx.x;
       v < n; v += (long long)gridDim.x * QV_SYNTH_BLOCK) {
    unsigned c[4];
    qv_philox(v, 2u, k0, k1, c);
    float snr = qv_umap(qv_unit(c[3]), S.snr_lo, S.snr_hi);
    for (int j = 0; 4 * j < T; ++j) {
      float z[4];
      qv_philox(v, 3u + (unsigned)j, k0, k1, c);
      qv_box_muller(c[0], c[1], &z[0], &z[1]);
      qv_box_muller(c[2], c[3], &z[2], &z[3]);
      for (int i = 0; i < 4 && 4 * j + i < T; ++i) {
        int t = 4 * j + i;
        float sd = mean[t] / (snr * prof[t]);
        x[v * T + t] = x[v * T + t] + z[i] * sd;
      }
    }
  }
}

// Pass 1's grid for n voxels (also the partials' count), capped so that
// every pass-2 block sums a few thousand partials.
extern "C" int qv_synth_grid(long long n) {
  long long g = (n + QV_SYNTH_BLOCK - 1) / QV_SYNTH_BLOCK;
  return (int)(g < 1 ? 1 : (g > 1024 ? 1024 : g));
}

static int qv_synth_launch(long long n, int trials, QvDecodeConsts C,
                           const float* table, int table_len,
                           QvSynthConsts S, unsigned k0, unsigned k1,
                           const unsigned long long* seeds, float* x,
                           float* y, double* partial, const float* prof,
                           int noise_grid, void* stream) {
  const int T = C.n_taus;
  if (T > QV_SYNTH_MAX_T || (S.misalign && T < 6) || trials < 1 ||
      trials > 65535)
    return (int)cudaErrorInvalidValue;
  const int grid = qv_synth_grid(n);
  qv_synth_batch_kernel<<<dim3(grid, trials), QV_SYNTH_BLOCK,
                          table_len * sizeof(float),
                          (cudaStream_t)stream>>>(n, C, table, table_len, S,
                                                  k0, k1, seeds, x, y,
                                                  partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !S.noise) return (int)err;
  qv_synth_noise_kernel<<<dim3(noise_grid, trials), QV_SYNTH_BLOCK, 0,
                          (cudaStream_t)stream>>>(n, T, partial, grid, prof,
                                                  S, k0, k1, seeds, x);
  return (int)cudaGetLastError();
}

extern "C" int qv_synth_batch(long long n, QvDecodeConsts C,
                              const float* table, int table_len,
                              QvSynthConsts S, unsigned long long seed,
                              float* x,
                              float* y, double* partial, const float* prof,
                              int noise_grid, void* stream) {
  return qv_synth_launch(n, 1, C, table, table_len, S, (unsigned)seed,
                         (unsigned)(seed >> 32), nullptr, x, y, partial,
                         prof, noise_grid, stream);
}

// P = ``trials`` batches of n voxels, batch j under seeds[j] (a device
// array); x (P, n, T), y (P, n, 3), partial (P, qv_synth_grid(n), T).
extern "C" int qv_synth_batch_trials(long long n, int trials,
                                     QvDecodeConsts C, const float* table,
                                     int table_len, QvSynthConsts S,
                                     const unsigned long long* seeds,
                                     float* x, float* y, double* partial,
                                     const float* prof, int noise_grid,
                                     void* stream) {
  return qv_synth_launch(n, trials, C, table, table_len, S, 0u, 0u, seeds, x,
                         y, partial, prof, noise_grid, stream);
}
