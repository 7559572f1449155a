// Kernels B and C: the fused stream-1 encode, alone (C) or followed by the
// quadrature posterior summaries (B).
//
// B replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_infer.py::
// encode_quad_fused (_encode_quad_kernel -> _encode_body, then
// ops/quadrature.py::quad_tile_summaries); C replaces encode_q1_packed
// (_kernel -> _encode_body, pallas_call at :246), the encode that feeds the
// MC summaries. Per voxel, in one device routine both kernels call
// (qv_encode_tile):
//   [mask] -> clip(1e-2, 1e8) -> divide by the spin-echo reference (one
//   image, or the mean of [max(se-1, 0), se+2)) -> log
//   -> Dense(T -> U) + act -> nb x Dense(U -> U) + act -> Dense(U -> 5);
// then B runs the quadrature summaries (quad_math.cuh) and the raw-log-std
// transforms and writes channel-major (3, N) means, variances and raw rows,
// and C writes the raw head channel-major as q (5, N) (row 4 zero for a
// diagonal head). The activations never reach device memory, and in B
// neither does q (the TPU's (5, 8, R/8) re-split is a TPU layout and is not
// carried over; nor is the TPU's voxel padding).
//
// Bound: about 48 B read and 36 B (B) or 20 B (C) written per voxel against
// U*T + nb*U*U + 5*U FMAs (8.2 k at U=60, nb=2, T=11) and, in B, ~150
// transcendentals, so the FMA chain, not memory, bounds both: on the tensor
// cores as 3xTF32, three TF32 products a float32 FMA at 495 TFLOP/s (~0.10
// ms a 1.03 M-voxel request on the H100, PERF.md). Design: the chain runs
// as float32-accurate 3xTF32 mma.sync products (mma_math.cuh). A warp
// encodes a tile of 32 voxels: each lane normalises one voxel into the
// warp's rows in shared memory, the layers run on MT m16 tiles of 16
// voxels at a time (MT = 2 for U <= 64, 1 for U <= 128, so that a lane's
// activations and sums stay within 128 registers; the widths are template
// constants, QV_ENCODE_DISPATCH, and no product sits behind a runtime
// guard), and the heads are staged back in shared memory, one voxel a
// lane. B's quadrature then sorts the block's 384 voxels' 1-D moment
// problems by side (quad_math.cuh::qv_quad_block: on real heads nearly
// every warp straddles the s = 1.5 split), so the warps of a block walk
// the tiles in step. Between layers the activations
// stay in registers: a layer's sums hold, per lane, channels {2t, 2t + 1}
// of each n-tile -- the channels that the next layer's A fragment of that
// k-step wants, under the k order of mma_math.cuh -- so bias and
// activation turn the sums into the next A operand in place. The weights
// are split into hi / lo on the host and laid out in fragment order
// (ops/fused_infer.py::_weight_blob), staged once per block in shared
// memory, and read one 16-byte load per lane and (k-step, n-tile), shared
// by the MT m-tiles. Widths are zero-padded to 16, 32, 64 or 128: padded
// outputs have zero weights and bias, and the next layer's weights for
// them are zero, so act(0) != 0 (sigmoid, softplus) adds nothing. A block
// holds 12 warps (~80 registers a thread; the weights and 12 warps' rows
// take ~124 KB of shared memory at OPTIMAL, one block an SM): 16 or more
// warps an SM ran 1.2-26x slower on the H100 (PERF.md). Warps walk
// the tiles in a grid-stride loop; the blocks fill the card once. The
// trunk's operand type is a template policy, QvTrunkF32: 3xTF32 on float32
// operands in k-steps of 8 channels. The bf16 trunk's kernels B and C are
// encode_quad_bf16.cu's (wgmma).
//
// Weight blob (floats; Tp = T rounded up to K, Up = U padded, k-steps of
// K = 8 channels, n-tiles of 8; fragments [k-step][n-tile][lane] of W = 4
// words: (b0 hi, b1 hi, b0 lo, b1 lo), mma_math.cuh):
//   W0 frags [Tp/K][Up/8][32][W]  Wb frags nb x [Up/K][Up/8][32][W]
//   Wf frags [Up/8][1][32][4]
//   b0[Up] bb[nb][Up] bf[8] consts[QV_NCONST]
// and after it, per warp, its staged rows xs[32][qv_xs_stride(Tp)] and
// heads qs[32][QV_QS]; then, in B, QV_QUAD_SCRATCH(block) floats for the
// quadrature's sort (qv_quad_scratch_floats, which the wrapper adds).

#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_act.cuh"
#include "mma_math.cuh"
#include "quad_math.cuh"

#define QV_ENC_THREADS 384  // launch bound: 12 warps a block
#define QV_TILE 32          // voxels a warp encodes at a time
#define QV_QS 5             // floats of a staged head

// The trunk's products: float32 operands split into TF32 hi / lo, three
// tensor-core products (mma_math.cuh), k-steps of 8 channels.
struct QvTrunkF32 {
  static constexpr int K = 8;        // channels a k-step
  typedef float4 B;                  // a lane's B fragment (hi and lo)
  struct A {
    uint32_t hi[4], lo[4];
  };
  static __device__ __forceinline__ A split(float a0, float a1, float a2,
                                            float a3) {
    A f;
    qv_split(a0, f.hi[0], f.lo[0]);
    qv_split(a1, f.hi[1], f.lo[1]);
    qv_split(a2, f.hi[2], f.lo[2]);
    qv_split(a3, f.hi[3], f.lo[3]);
    return f;
  }
  // k-step s from staged rows: r at (row g, word K s + 2t), row g + 8 at
  // r + 8 stride
  static __device__ __forceinline__ A from_rows(const float* r, int stride) {
    const float2 a = *reinterpret_cast<const float2*>(r);
    const float2 b = *reinterpret_cast<const float2*>(r + 8 * stride);
    return split(a.x, b.x, a.y, b.y);
  }
  // k-step s from the activations in registers (qv_bias_map's layout)
  template <int NK>
  static __device__ __forceinline__ A from_regs(const float (&a)[NK][4],
                                                int s) {
    return split(a[s][0], a[s][1], a[s][2], a[s][3]);
  }
  static __device__ __forceinline__ void mma(float* d, const A& a, float4 b,
                                             bool first) {
    const uint32_t bhi[2] = {__float_as_uint(b.x), __float_as_uint(b.y)};
    const uint32_t blo[2] = {__float_as_uint(b.z), __float_as_uint(b.w)};
    qv_mma3(d, a.hi, a.lo, bhi, blo, first);
  }
};

// Words a staged row: Tp, or Tp + 8 where Tp is a multiple of 16, so that a
// half-warp's 64-bit A loads (rows g = 0..3, words 2t) hit distinct banks.
static __device__ __forceinline__ int qv_xs_stride(int tp) {
  return tp % 16 == 0 ? tp + 8 : tp;
}

// The staged weights and this warp's rows and heads; w0 and wb hold the
// trunk's fragments (Trunk::B), wf the 3xTF32 head's.
struct QvEncoder {
  const void *w0, *wb;
  const float4* wf;
  const float *b0, *bb, *bf, *consts;
  float *xs, *qs;
  int T, ks0, nt, nb, act, se_idx, lo, hi, multi_image, xs_stride;
};

// Stage the blob into shared memory (whole block, synchronised) and lay out
// the weights and this warp's buffers.
template <class Trunk>
static __device__ __forceinline__ QvEncoder qv_stage_encoder(
    float* smem, const float* blob, int blob_len, int t_in, int mask_channel,
    int se_idx, int multi_image, int act, int up, int nb) {
  const float4* src = reinterpret_cast<const float4*>(blob);
  float4* dst = reinterpret_cast<float4*>(smem);
  for (int i = threadIdx.x; i < blob_len / 4; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  QvEncoder e;
  constexpr int W = sizeof(typename Trunk::B) / 4;  // words a fragment
  e.T = t_in - mask_channel;
  e.ks0 = (e.T + Trunk::K - 1) / Trunk::K;
  e.nt = up / 8;
  e.nb = nb;
  e.act = act;
  e.se_idx = se_idx;
  e.multi_image = multi_image;
  e.lo = se_idx - 1 > 0 ? se_idx - 1 : 0;
  e.hi = se_idx + 2 < e.T ? se_idx + 2 : e.T;
  e.w0 = smem;
  e.wb = smem + e.ks0 * e.nt * 32 * W;
  e.wf = reinterpret_cast<const float4*>(
      smem + (e.ks0 + nb * (up / Trunk::K)) * e.nt * 32 * W);
  e.b0 = reinterpret_cast<const float*>(e.wf + e.nt * 32);
  e.bb = e.b0 + up;
  e.bf = e.bb + nb * up;
  e.consts = e.bf + 8;
  e.xs_stride = qv_xs_stride(Trunk::K * e.ks0);
  e.xs = smem + blob_len + (threadIdx.x / 32) * QV_TILE * (e.xs_stride + QV_QS);
  e.qs = e.xs + QV_TILE * e.xs_stride;
  return e;
}

// Row `lane` of the warp's staged rows: voxel v normalised (zeros past N
// and past T, up to the k-steps' K ks0 words).
template <class Trunk>
static __device__ __forceinline__ void qv_stage_row(
    const QvEncoder& e, const float* __restrict__ x, long long n, long long v,
    int t_in, int channel_major, int mask_channel, int lane) {
  const int T = e.T;
  float* row = e.xs + lane * e.xs_stride;
  if (v < n) {
    float mask = 1.0f;
    if (mask_channel)
      mask = channel_major ? x[(long long)T * n + v] : x[v * t_in + T];
    for (int t = 0; t < T; ++t) {
      float xv = channel_major ? x[(long long)t * n + v] : x[v * t_in + t];
      if (mask_channel) xv = xv * mask;
      row[t] = fminf(fmaxf(xv, 1e-2f), 1e8f);
    }
    float ref;
    if (e.multi_image) {
      float sum = 0.0f;
      for (int t = e.lo; t < e.hi; ++t) sum += row[t];
      ref = sum / (float)(e.hi - e.lo);
    } else {
      ref = row[e.se_idx];
    }
    for (int t = 0; t < T; ++t) row[t] = logf(row[t] / ref);
  } else {
    for (int t = 0; t < T; ++t) row[t] = 0.0f;
  }
  for (int t = T; t < Trunk::K * e.ks0; ++t) row[t] = 0.0f;
}

// acc[m][j] (+)= A_m W(s, j) over the NJ n-tiles of k-step s, A_m this
// lane's split A fragment of m-tile m. Every count is a compile-time
// constant: runtime guards around the products would cut the n-tiles into
// separate blocks that the compiler cannot interleave.
template <int MT, int NJ, class Trunk, int NA>
static __device__ __forceinline__ void qv_kstep(
    const typename Trunk::A (&f)[MT], const typename Trunk::B* __restrict__ w,
    int s, int lane, bool first, float (&acc)[MT][NA][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const typename Trunk::B b = w[(s * NJ + j) * 32 + lane];
#pragma unroll
    for (int m = 0; m < MT; ++m) Trunk::mma(acc[m][j], f[m], b, first);
  }
}

// The first layer's sums, A read from the staged rows row0 + 16 m + g and
// + 8, words K s + 2t and + 1.
template <int MT, int NT, class Trunk>
static __device__ __forceinline__ void qv_layer_rows(
    const QvEncoder& e, int row0, int lane, float (&acc)[MT][NT][4]) {
  const int g = lane >> 2, t = lane & 3;
  const typename Trunk::B* w0 =
      reinterpret_cast<const typename Trunk::B*>(e.w0);
  for (int s = 0; s < e.ks0; ++s) {
    typename Trunk::A f[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      f[m] = Trunk::from_rows(e.xs + (row0 + 16 * m + g) * e.xs_stride +
                                  Trunk::K * s + 2 * t,
                              e.xs_stride);
    qv_kstep<MT, NT, Trunk>(f, w0, s, lane, s == 0, acc);
  }
}

// A layer's sums from the activations in registers (NK n-tiles of the
// previous layer: NK * 8 / K k-steps), NJ n-tiles.
template <int MT, int NK, int NJ, class Trunk, int NA>
static __device__ __forceinline__ void qv_layer_regs(
    const float (&a)[MT][NK][4], const typename Trunk::B* __restrict__ w,
    int lane, float (&acc)[MT][NA][4]) {
#pragma unroll
  for (int s = 0; s < NK * 8 / Trunk::K; ++s) {
    typename Trunk::A f[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) f[m] = Trunk::template from_regs<NK>(a[m], s);
    qv_kstep<MT, NJ, Trunk>(f, w, s, lane, s == 0, acc);
  }
}

// a = f(acc + b) over the NT n-tiles: sums (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1) of n-tile j become the next layer's A
// fragment of k-step j, (g, 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1).
template <int MT, int NT, class F>
static __device__ __forceinline__ void qv_bias_map(
    const float (&acc)[MT][NT][4], const float* b, int t, F f,
    float (&a)[MT][NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bj = *reinterpret_cast<const float2*>(b + 8 * j + 2 * t);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      a[m][j][0] = f(acc[m][j][0] + bj.x);
      a[m][j][1] = f(acc[m][j][2] + bj.x);
      a[m][j][2] = f(acc[m][j][1] + bj.y);
      a[m][j][3] = f(acc[m][j][3] + bj.y);
    }
  }
}

// a = act(acc + b): relu (OPTIMAL's) inline, any other activation through
// one out-of-line copy of qv_act. Inlining qv_act at each of the 64
// elements of an epilogue, or a copy of the epilogue per activation, made
// the kernel 6-9x larger and, on the H100, the relu path slower
// (PERF.md).
template <int MT, int NT, class Trunk>
static __device__ __forceinline__ void qv_bias_act(
    const float (&acc)[MT][NT][4], const float* b, int t, int act,
    float (&a)[MT][NT][4]) {
  if (act == 0)
    qv_bias_map(acc, b, t, [](float x) { return fmaxf(x, 0.0f); }, a);
  else
    qv_bias_map(acc, b, t, [act](float x) { return qv_act_call(act, x); }, a);
}

// The chain on the tile's rows row0 .. row0 + 16 MT - 1 (widths of NT
// n-tiles); heads into qs.
template <int MT, int NT, class Trunk>
static __device__ __forceinline__ void qv_encode_rows(const QvEncoder& e,
                                                      int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float a[MT][NT][4], acc[MT][NT][4];
  const typename Trunk::B* wb =
      reinterpret_cast<const typename Trunk::B*>(e.wb);
  qv_layer_rows<MT, NT, Trunk>(e, row0, lane, acc);
  qv_bias_act<MT, NT, Trunk>(acc, e.b0, t, e.act, a);
  for (int i = 0; i < e.nb; ++i) {
    qv_layer_regs<MT, NT, NT, Trunk>(a, wb + i * (NT * 8 / Trunk::K) * NT * 32,
                                     lane, acc);
    qv_bias_act<MT, NT, Trunk>(acc, e.bb + i * 8 * NT, t, e.act, a);
  }
  // the float32 head (U -> 5, one n-tile padded to 8): q = Wf h + bf
  qv_layer_regs<MT, NT, 1, QvTrunkF32>(a, e.wf, lane, acc);
  const float2 bj = *reinterpret_cast<const float2*>(e.bf + 2 * t);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float* q = e.qs + (row0 + 16 * m + g) * QV_QS;
    if (2 * t < QV_QS) {
      q[2 * t] = acc[m][0][0] + bj.x;
      q[8 * QV_QS + 2 * t] = acc[m][0][2] + bj.x;
    }
    if (2 * t + 1 < QV_QS) {
      q[2 * t + 1] = acc[m][0][1] + bj.y;
      q[8 * QV_QS + 2 * t + 1] = acc[m][0][3] + bj.y;
    }
  }
}

// The raw stream-1 head q[5] of voxel v0 + lane (kernels B and C): the
// whole warp encodes the tile v0 .. v0 + 31.
template <int MT, int NT, class Trunk>
static __device__ __forceinline__ void qv_encode_tile(
    const QvEncoder& e, const float* __restrict__ x, long long n,
    long long v0, int t_in, int channel_major, int mask_channel, int lane,
    float q[5]) {
  qv_stage_row<Trunk>(e, x, n, v0 + lane, t_in, channel_major, mask_channel,
                      lane);
  __syncwarp();
#pragma unroll
  for (int row0 = 0; row0 < QV_TILE; row0 += 16 * MT)
    qv_encode_rows<MT, NT, Trunk>(e, row0, lane);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 5; ++j) q[j] = e.qs[lane * QV_QS + j];
  __syncwarp();
}

template <int MT, int NT, class Trunk>
static __device__ __forceinline__ void qv_encode_quad_body(
    const float* __restrict__ x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int up, int nb,
    const float* __restrict__ blob, int blob_len, int mvg, QvRanges r,
    float* __restrict__ means, float* __restrict__ vars,
    float* __restrict__ raw) {
  extern __shared__ float4 smem4[];
  const QvEncoder e = qv_stage_encoder<Trunk>(
      reinterpret_cast<float*>(smem4), blob, blob_len, t_in, mask_channel,
      se_idx, multi_image, act, up, nb);
  const int lane = threadIdx.x & 31, warps = blockDim.x / 32;
  // the quadrature's scratch, after the warps' staging buffers
  float* scratch = reinterpret_cast<float*>(smem4) + blob_len
                   + warps * QV_TILE * (e.xs_stride + QV_QS);
  const long long tiles = (n + QV_TILE - 1) / QV_TILE;
  // every warp of a block takes the same rounds: the quadrature sorts the
  // block's problems by side
  for (long long t0 = (long long)blockIdx.x * warps; t0 < tiles;
       t0 += (long long)gridDim.x * warps) {
    const long long tile = t0 + threadIdx.x / 32;
    const long long v = tile * QV_TILE + lane;
    float q[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (tile < tiles)
      qv_encode_tile<MT, NT, Trunk>(e, x, n, tile * QV_TILE, t_in,
                                    channel_major, mask_channel, lane, q);
    const bool live = v < n;
    // ---- quadrature summaries + raw-log-std transforms ---------------------
    float rw[3];
    const QvQuadIn in = qv_quad_squash(q[0], q[1], q[2], q[3], q[4],
                                       mvg != 0, rw);
    float o[8], g[5], D1, D2;
    qv_quad_block(e.consts, scratch, live, in, o, &D1, &D2, g);
    if (!live) continue;
    float m[3], s[3];
    qv_quad_combine(o, D1, D2, g, in.od, r, m, s);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      means[(long long)j * n + v] = m[j];
      vars[(long long)j * n + v] = s[j];
      raw[(long long)j * n + v] = rw[j];
    }
  }
}

template <int MT, int NT, class Trunk>
static __device__ __forceinline__ void qv_encode_q_body(
    const float* __restrict__ x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int up, int nb,
    const float* __restrict__ blob, int blob_len, float* __restrict__ q_out) {
  extern __shared__ float4 smem4[];
  const QvEncoder e = qv_stage_encoder<Trunk>(
      reinterpret_cast<float*>(smem4), blob, blob_len, t_in, mask_channel,
      se_idx, multi_image, act, up, nb);
  const int lane = threadIdx.x & 31, warps = blockDim.x / 32;
  const long long tiles = (n + QV_TILE - 1) / QV_TILE;
  for (long long tile = (long long)blockIdx.x * warps + threadIdx.x / 32;
       tile < tiles; tile += (long long)gridDim.x * warps) {
    const long long v = tile * QV_TILE + lane;
    float q[5];
    qv_encode_tile<MT, NT, Trunk>(e, x, n, tile * QV_TILE, t_in,
                                  channel_major, mask_channel, lane, q);
    if (v >= n) continue;
#pragma unroll
    for (int j = 0; j < 5; ++j) q_out[(long long)j * n + v] = q[j];
  }
}

// Kernels B and C, float32 trunk (3xTF32): one symbol each, so that a
// profile and the SASS tell them from the bf16 trunk's.
#define QV_QUAD_ARGS                                                          \
  const float *__restrict__ x, long long n, int t_in, int channel_major,      \
      int mask_channel, int se_idx, int multi_image, int act, int up, int nb, \
      const float *__restrict__ blob, int blob_len, int mvg, QvRanges r,      \
      float *__restrict__ means, float *__restrict__ vars,                    \
      float *__restrict__ raw
#define QV_Q_ARGS                                                             \
  const float *__restrict__ x, long long n, int t_in, int channel_major,      \
      int mask_channel, int se_idx, int multi_image, int act, int up, int nb, \
      const float *__restrict__ blob, int blob_len, float *__restrict__ q_out

template <int MT, int NT>
__global__ void __launch_bounds__(QV_ENC_THREADS)
    qv_encode_quad_kernel(QV_QUAD_ARGS) {
  qv_encode_quad_body<MT, NT, QvTrunkF32>(
      x, n, t_in, channel_major, mask_channel, se_idx, multi_image, act, up,
      nb, blob, blob_len, mvg, r, means, vars, raw);
}

template <int MT, int NT>
__global__ void __launch_bounds__(QV_ENC_THREADS)
    qv_encode_q_kernel(QV_Q_ARGS) {
  qv_encode_q_body<MT, NT, QvTrunkF32>(x, n, t_in, channel_major,
                                       mask_channel, se_idx, multi_image, act,
                                       up, nb, blob, blob_len, q_out);
}

// Grid of a grid-stride encode kernel: as many blocks as the tiles need, at
// most as many as fit on the card at once (the weights are staged once per
// resident block).
static int qv_encode_grid(const void* kernel, long long n, int block,
                          long long smem_bytes, int* grid) {
  if (block % 32 != 0 || block > QV_ENC_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, block, (size_t)smem_bytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (n + QV_TILE - 1) / QV_TILE;
  const long long need = (tiles + block / 32 - 1) / (block / 32);
  const long long cap = (long long)sms * per_sm;
  *grid = (int)(need < cap ? need : cap);
  return 0;
}

// Launch one encode kernel on the grid qv_encode_grid sizes.
template <class Kernel, class... Args>
static int qv_launch(Kernel kernel, long long n, int block,
                     long long smem_bytes, void* stream, Args... args) {
  int grid = 0;
  int err = qv_encode_grid((const void*)kernel, n, block, smem_bytes, &grid);
  if (err != 0) return err;
  kernel<<<grid, block, (size_t)smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// kernel<MT, NT> for the padded width up: 2 m-tiles a pass and 2, 4 or 8
// n-tiles up to 64 units, 1 m-tile and 16 n-tiles up to 128 (a lane's
// activations and sums, 2 x MT x NT x 4 floats, within 128 registers).
#define QV_ENCODE_DISPATCH(kernel, up, ...)                   \
  switch (up) {                                               \
    case 16:                                                  \
      return qv_launch(kernel<2, 2>, __VA_ARGS__);            \
    case 32:                                                  \
      return qv_launch(kernel<2, 4>, __VA_ARGS__);            \
    case 64:                                                  \
      return qv_launch(kernel<2, 8>, __VA_ARGS__);            \
    case 128:                                                 \
      return qv_launch(kernel<1, 16>, __VA_ARGS__);           \
    default:                                                  \
      return (int)cudaErrorInvalidValue;                      \
  }

extern "C" int qv_encode_quad_fused(
    const float* x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int u, int up,
    int nb, const float* blob, int blob_len, QvRanges r, float* means,
    float* vars, float* raw, int mvg, int block, long long smem_bytes,
    void* stream) {
  (void)u;
  QV_ENCODE_DISPATCH(qv_encode_quad_kernel, up, n, block, smem_bytes, stream,
                     x, n, t_in, channel_major, mask_channel, se_idx,
                     multi_image, act, up, nb, blob, blob_len, mvg, r, means,
                     vars, raw)
}

extern "C" int qv_encode_q1(const float* x, long long n, int t_in,
                            int channel_major, int mask_channel, int se_idx,
                            int multi_image, int act, int up, int nb,
                            const float* blob, int blob_len, float* q,
                            int block, long long smem_bytes, void* stream) {
  QV_ENCODE_DISPATCH(qv_encode_q_kernel, up, n, block, smem_bytes, stream, x,
                     n, t_in, channel_major, mask_channel, se_idx, multi_image,
                     act, up, nb, blob, blob_len, q)
}
