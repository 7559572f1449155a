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
// Two passes. Pass 1 (qv_synth_batch_kernel), a grid of at most
// QV_SYNTH_MAX_GRID blocks of 256 threads striding over tiles of 256
// voxels (the grid a function of n alone, qv_synth_grid), draws and
// decodes a voxel a thread into the block's tile in shared memory, sums
// each tau of the tile in double (warp w takes taus w, w + 8, ...: each
// lane eight voxels in order, then a fixed shuffle tree) into the block's
// partial, and writes the tile's x and y out contiguously (16-byte stores
// where the tile's start allows). The last block of a trial to finish
// (a ticket taken after __threadfence) sums the trial's partials in block
// order -- lane-strided, then the shuffle tree, the same order whichever
// block comes last -- into the batch mean per tau, and resets its ticket
// to 0 for the next launch. Pass 2 (qv_synth_noise_kernel), a tile of 256
// voxels a block over the whole batch, reads its tile of x contiguously
// into shared memory, adds each voxel's noise (its normals drawn again
// from the same counters) and writes the tile back, so the batch is
// deterministic.
//
// A trial axis (qv_synth_batch_trials): P batches of n voxels each, one
// launch of each pass for all of them. Block row blockIdx.y is trial j:
// it draws under seeds[j] with the counters (v, k) of its own voxels, and
// writes x, y, its partials, its mean and its ticket at trial j's
// offsets. Each trial's blocks do what a single launch under seeds[j]
// does, in the same order, so trial j's batch is bit-equal to it (the
// noise of a batch scales with its own mean signal, so P batches are not
// one batch of P n voxels). qv_synth_batch is the one-trial launch (seeds
// NULL: the key is the scalar seed).
//
// Bound: bytes. A voxel writes 3 + T floats (14.3 MB at 256,000 voxels
// and 11 taus); its math is ~100 float operations and 2 exponentials a
// tau (the surrogate) and ~20 special functions a voxel. This design
// moves 36.9 MB: the noise pass reads and writes x again, since the noise
// scales with the batch mean that only the whole of pass 1 gives
// (recomputing the signal in pass 2 instead would double the decode).
// What it does about the rest: the mean is reduced once, not by every
// noise block from all partials; the per-tau sums take shuffles, not a
// 32 KB double accumulator that capped the blocks an SM; the noise pass
// has a thread a voxel on the whole card; x moves in whole tiles, not at
// a 44-byte stride a lane (PERF.md, the kernel S findings).

#include <stdint.h>

#include "elbo_math.cuh"

#define QV_SYNTH_BLOCK 256     // threads a block, voxels a tile
#define QV_SYNTH_MAX_T 32
#define QV_SYNTH_MAX_GRID 1024  // pass 1's blocks at most

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


// Offset, in floats, of global address g within its 16 bytes. A tile's
// shared buffer (16-byte aligned, 3 floats longer than the tile) holds the
// tile from this offset on, so that shared and global addresses agree mod
// 16 and the whole 16-byte pieces move as float4.
static __device__ __forceinline__ int qv_tile_off(const float* g) {
  return (int)(((uintptr_t)g >> 2) & 3u);
}

// cnt floats between global g and shared s = buffer + qv_tile_off(g), by
// the whole block: the floats before g's first 16-byte boundary, the
// float4 pieces, the rest. LOAD: global -> shared; else shared -> global.
template <bool LOAD>
static __device__ __forceinline__ void qv_tile_copy(float* g, float* s,
                                                    int cnt) {
  const int head = min((4 - qv_tile_off(g)) & 3, cnt);
  const int nvec = (cnt - head) >> 2;
  for (int i = threadIdx.x; i < head; i += blockDim.x) {
    if (LOAD) s[i] = g[i]; else g[i] = s[i];
  }
  float4* g4 = reinterpret_cast<float4*>(g + head);
  float4* s4 = reinterpret_cast<float4*>(s + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    if (LOAD) s4[i] = g4[i]; else g4[i] = s4[i];
  }
  for (int i = head + 4 * nvec + threadIdx.x; i < cnt; i += blockDim.x) {
    if (LOAD) s[i] = g[i]; else g[i] = s[i];
  }
}

// Lane 0's value of a fixed xor-shuffle tree over the warp (the other
// lanes hold the same sum in other orders and are not read).
static __device__ __forceinline__ double qv_warp_sum(double s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Floats of a tile's shared buffer of T taus.
static __host__ __device__ __forceinline__ int qv_tile_floats(int T) {
  return QV_SYNTH_BLOCK * T + 4;
}

// Pass 1. Dynamic shared memory: the x tile, the y tile, the decode table.
// partial (P, gridDim.x + 1, T) doubles: row b block b's sums, the last row
// the trial's mean (written by its last block); tickets[P] 0 on entry and
// on exit.
__global__ void __launch_bounds__(QV_SYNTH_BLOCK) qv_synth_batch_kernel(
    long long n, QvDecodeConsts C, const float* __restrict__ table,
    int table_len, QvSynthConsts S, unsigned k0, unsigned k1,
    const unsigned long long* __restrict__ seeds,
    float* __restrict__ x, float* __restrict__ y,
    double* __restrict__ partial, unsigned* __restrict__ tickets) {
  extern __shared__ float4 qv_synth_smem[];
  __shared__ double acc[QV_SYNTH_MAX_T];
  __shared__ int last;
  const int T = C.n_taus;
  float* xbuf = reinterpret_cast<float*>(qv_synth_smem);
  float* ybuf = xbuf + qv_tile_floats(T);
  float* tab = ybuf + qv_tile_floats(3);
  qv_synth_key(seeds, &k0, &k1);
  const int trial = blockIdx.y;
  x += (long long)trial * n * T;
  y += (long long)trial * n * 3;
  partial += (long long)trial * (gridDim.x + 1) * T;
  qv_stage_table(table, tab, table_len);
  if (threadIdx.x < T) acc[threadIdx.x] = 0.0;
  __syncthreads();
  const QvTable tb = qv_table(tab, T);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (long long v0 = (long long)blockIdx.x * QV_SYNTH_BLOCK; v0 < n;
       v0 += (long long)gridDim.x * QV_SYNTH_BLOCK) {
    const int nv = (int)min((long long)QV_SYNTH_BLOCK, n - v0);
    float* gx = x + v0 * T;
    float* gy = y + v0 * 3;
    float* sx = xbuf + qv_tile_off(gx);
    float* sy = ybuf + qv_tile_off(gy);
    float* row = sx + threadIdx.x * T;
    if ((int)threadIdx.x < nv) {
      const QvSynthVoxel o = qv_synth_voxel(S, T, v0 + threadIdx.x, k0, k1);
      sy[3 * threadIdx.x] = o.oef;
      sy[3 * threadIdx.x + 1] = o.dbv;
      sy[3 * threadIdx.x + 2] = o.r2p;
      for (int t = 0; t < T; ++t) {
        const bool mis = o.from >= 0 && t > o.from;
        row[t] = qv_signal(C, tb, t, mis ? o.mis_oef : o.oef,
                           mis ? o.mis_dbv : o.dbv).pred;
      }
    } else {
      for (int t = 0; t < T; ++t) row[t] = 0.0f;
    }
    __syncthreads();
    // the tile's per-tau sums: warp w takes taus w, w + 8, ...
    for (int t = warp; t < T; t += QV_SYNTH_BLOCK / 32) {
      double s = 0.0;
      for (int r = lane; r < QV_SYNTH_BLOCK; r += 32)
        s += (double)sx[r * T + t];
      s = qv_warp_sum(s);
      if (lane == 0) acc[t] += s;
    }
    qv_tile_copy<false>(gx, sx, nv * T);
    qv_tile_copy<false>(gy, sy, nv * 3);
    __syncthreads();
  }

  if ((int)threadIdx.x < T)
    partial[(long long)blockIdx.x * T + threadIdx.x] = acc[threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + trial, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the trial's last block: its partials in block order, the same sum
  // whichever block this is
  __threadfence();
  double* mean = partial + (long long)gridDim.x * T;
  for (int t = warp; t < T; t += QV_SYNTH_BLOCK / 32) {
    double s = 0.0;
    for (int b = lane; b < (int)gridDim.x; b += 32)
      s += __ldcg(partial + (long long)b * T + t);
    s = qv_warp_sum(s);
    if (lane == 0) mean[t] = s / (double)n;
  }
  if (threadIdx.x == 0) tickets[trial] = 0u;
}

// Pass 2: a tile of 256 voxels a block. Dynamic shared memory: the x tile.
__global__ void __launch_bounds__(QV_SYNTH_BLOCK) qv_synth_noise_kernel(
    long long n, int T, const double* __restrict__ partial, int n_partial,
    const float* __restrict__ prof, QvSynthConsts S, unsigned k0,
    unsigned k1, const unsigned long long* __restrict__ seeds,
    float* __restrict__ x) {
  extern __shared__ float4 qv_synth_smem[];
  __shared__ float mean[QV_SYNTH_MAX_T], pf[QV_SYNTH_MAX_T];
  qv_synth_key(seeds, &k0, &k1);
  x += (long long)blockIdx.y * n * T;
  const double* m =
      partial + ((long long)blockIdx.y * (n_partial + 1) + n_partial) * T;
  if ((int)threadIdx.x < T) {
    mean[threadIdx.x] = (float)m[threadIdx.x];
    pf[threadIdx.x] = prof[threadIdx.x];
  }
  const long long v0 = (long long)blockIdx.x * QV_SYNTH_BLOCK;
  const int nv = (int)min((long long)QV_SYNTH_BLOCK, n - v0);
  float* gx = x + v0 * T;
  float* sx = reinterpret_cast<float*>(qv_synth_smem) + qv_tile_off(gx);
  qv_tile_copy<true>(gx, sx, nv * T);
  __syncthreads();
  if ((int)threadIdx.x < nv) {
    const long long v = v0 + threadIdx.x;
    float* row = sx + threadIdx.x * T;
    unsigned c[4];
    qv_philox(v, 2u, k0, k1, c);
    const float snr = qv_umap(qv_unit(c[3]), S.snr_lo, S.snr_hi);
    for (int j = 0; 4 * j < T; ++j) {
      float z[4];
      qv_philox(v, 3u + (unsigned)j, k0, k1, c);
      qv_box_muller(c[0], c[1], &z[0], &z[1]);
      qv_box_muller(c[2], c[3], &z[2], &z[3]);
      for (int i = 0; i < 4 && 4 * j + i < T; ++i) {
        const int t = 4 * j + i;
        const float sd = mean[t] / (snr * pf[t]);
        row[t] = row[t] + z[i] * sd;
      }
    }
  }
  __syncthreads();
  qv_tile_copy<false>(gx, sx, nv * T);
}

// Pass 1's grid for n voxels (also the partials' rows less one): a tile a
// block up to QV_SYNTH_MAX_GRID blocks, a function of n alone so that a
// trial and its one-trial launch sum in the same order.
extern "C" int qv_synth_grid(long long n) {
  long long g = (n + QV_SYNTH_BLOCK - 1) / QV_SYNTH_BLOCK;
  return (int)(g < 1 ? 1 : (g > QV_SYNTH_MAX_GRID ? QV_SYNTH_MAX_GRID : g));
}

static int qv_synth_launch(long long n, int trials, QvDecodeConsts C,
                           const float* table, int table_len,
                           QvSynthConsts S, unsigned k0, unsigned k1,
                           const unsigned long long* seeds, float* x,
                           float* y, double* partial, unsigned* tickets,
                           const float* prof, void* stream) {
  const int T = C.n_taus;
  if (n < 1 || T < 1 || T > QV_SYNTH_MAX_T || (S.misalign && T < 6) ||
      trials < 1 || trials > 65535)
    return (int)cudaErrorInvalidValue;
  const int grid = qv_synth_grid(n);
  // at most 38.7 KB (T = 32): within the default 48 KB
  const size_t smem = (size_t)(qv_tile_floats(T) + qv_tile_floats(3) +
                               table_len) * sizeof(float);
  qv_synth_batch_kernel<<<dim3(grid, trials), QV_SYNTH_BLOCK, smem,
                          (cudaStream_t)stream>>>(n, C, table, table_len, S,
                                                  k0, k1, seeds, x, y,
                                                  partial, tickets);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !S.noise) return (int)err;
  const long long tiles = (n + QV_SYNTH_BLOCK - 1) / QV_SYNTH_BLOCK;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  qv_synth_noise_kernel<<<dim3((unsigned)tiles, trials), QV_SYNTH_BLOCK,
                          (size_t)qv_tile_floats(T) * sizeof(float),
                          (cudaStream_t)stream>>>(n, T, partial, grid, prof,
                                                  S, k0, k1, seeds, x);
  return (int)cudaGetLastError();
}

// One batch under seed. partial: (qv_synth_grid(n) + 1, T) doubles;
// tickets: one word, 0 (and left 0).
extern "C" int qv_synth_batch(long long n, QvDecodeConsts C,
                              const float* table, int table_len,
                              QvSynthConsts S, unsigned long long seed,
                              float* x, float* y, double* partial,
                              unsigned* tickets, const float* prof,
                              void* stream) {
  return qv_synth_launch(n, 1, C, table, table_len, S, (unsigned)seed,
                         (unsigned)(seed >> 32), nullptr, x, y, partial,
                         tickets, prof, stream);
}

// P = ``trials`` batches of n voxels, batch j under seeds[j] (a device
// array); x (P, n, T), y (P, n, 3), partial (P, qv_synth_grid(n) + 1, T),
// tickets (P), 0 (and left 0).
extern "C" int qv_synth_batch_trials(long long n, int trials,
                                     QvDecodeConsts C, const float* table,
                                     int table_len, QvSynthConsts S,
                                     const unsigned long long* seeds,
                                     float* x, float* y, double* partial,
                                     unsigned* tickets, const float* prof,
                                     void* stream) {
  return qv_synth_launch(n, trials, C, table, table_len, S, 0u, 0u, seeds, x,
                         y, partial, tickets, prof, stream);
}
