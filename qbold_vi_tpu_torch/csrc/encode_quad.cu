// Kernels B and C: the fused stream-1 encode, alone (C) or followed by the
// quadrature posterior summaries (B).
//
// B replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_infer.py::
// encode_quad_fused (_encode_quad_kernel -> _encode_body, then
// ops/quadrature.py::quad_tile_summaries); C replaces encode_q1_packed
// (_kernel -> _encode_body, pallas_call at :246), the encode that feeds the
// MC summaries. Per voxel, in one device routine both kernels call
// (qv_encode_voxel):
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
// transcendentals, so the FMA chain, not memory, bounds both. Design: one
// thread per voxel. The padded weights (transposed so that 4 output channels
// are one float4) and the quadrature node table are staged once per block in
// shared memory, and every thread of a warp reads the same weight word (a
// broadcast). Each thread's activations live in its own column of two
// shared-memory buffers laid out [channel][thread] (no bank conflicts), so
// the kernel takes any width whose weights fit in shared memory, without
// 2 x U floats of registers per thread; each output chunk of 4 channels
// keeps 4 accumulators in registers. Blocks walk the voxels in a grid-stride
// loop, so the weights are staged once per resident block.
//
// Weight blob (floats; Up = U rounded up to 4, zero padded):
//   wfc_t[T][Up] bfc[Up] wb_t[nb][Up][Up] bb[nb][Up] wf_t[Up][8] bf[8]
//   consts[QV_NCONST]

#include <cuda_runtime.h>

#include "quad_math.cuh"

// activation codes: ops/fused_infer.py::SUPPORTED_ACTS order
static __device__ __forceinline__ float qv_act(int act, float x) {
  switch (act) {
    case 0:  // relu
      return fmaxf(x, 0.0f);
    case 1: {  // gelu, tanh approximation (jax.nn.gelu default)
      float inner = 0.7978845608028654f * (x + 0.044715f * (x * x * x));
      return x * (0.5f * (1.0f + tanhf(inner)));
    }
    case 2:
      return tanhf(x);
    case 3:
      return 1.0f / (1.0f + expf(-x));
    case 4:  // softplus = logaddexp(x, 0)
      return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
    case 5:  // elu, alpha 1
      return x > 0.0f ? x : expm1f(x);
    case 6:  // silu
    case 7:  // swish
      return x * (1.0f / (1.0f + expf(-x)));
    case 8:  // leaky_relu, slope 0.01
      return x >= 0.0f ? x : 0.01f * x;
    case 9:  // relu6
      return fminf(fmaxf(x, 0.0f), 6.0f);
    default:  // linear
      return x;
  }
}

// out[j] = act(b[j] + sum_k w_t[k][j] in[k]) for j < jp (jp % 4 == 0);
// in/out are this thread's columns of [channel][thread] buffers.
static __device__ __forceinline__ void qv_dense(const float* in, int kdim,
                                                const float* w_t,
                                                const float* b, float* out,
                                                int jp, int act, int bs) {
  for (int j0 = 0; j0 < jp; j0 += 4) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
    for (int k = 0; k < kdim; ++k) {
      float h = in[k * bs];
      float4 w = *reinterpret_cast<const float4*>(w_t + k * jp + j0);
      a0 = fmaf(w.x, h, a0);
      a1 = fmaf(w.y, h, a1);
      a2 = fmaf(w.z, h, a2);
      a3 = fmaf(w.w, h, a3);
    }
    out[(j0 + 0) * bs] = qv_act(act, a0 + b[j0 + 0]);
    out[(j0 + 1) * bs] = qv_act(act, a1 + b[j0 + 1]);
    out[(j0 + 2) * bs] = qv_act(act, a2 + b[j0 + 2]);
    out[(j0 + 3) * bs] = qv_act(act, a3 + b[j0 + 3]);
  }
}

// The staged weights and this thread's two activation columns.
struct QvEncoder {
  const float *wfc, *bfc, *wb, *bb, *wf, *bf, *consts;
  float *buf0, *buf1;
  int T, up, nb, act, bs, se_idx, lo, hi, multi_image;
};

// Stage the blob into shared memory (whole block, synchronised) and lay out
// the weights and this thread's activation columns.
static __device__ __forceinline__ QvEncoder qv_stage_encoder(
    float* smem, const float* blob, int blob_len, int t_in, int mask_channel,
    int se_idx, int multi_image, int act, int up, int nb) {
  const int bs = blockDim.x;
  for (int i = threadIdx.x; i < blob_len; i += bs) smem[i] = blob[i];
  __syncthreads();
  QvEncoder e;
  e.T = t_in - mask_channel;
  e.up = up;
  e.nb = nb;
  e.act = act;
  e.bs = bs;
  e.se_idx = se_idx;
  e.multi_image = multi_image;
  e.lo = se_idx - 1 > 0 ? se_idx - 1 : 0;
  e.hi = se_idx + 2 < e.T ? se_idx + 2 : e.T;
  e.wfc = smem;
  e.bfc = e.wfc + e.T * up;
  e.wb = e.bfc + up;
  e.bb = e.wb + nb * up * up;
  e.wf = e.bb + nb * up;
  e.bf = e.wf + up * 8;
  e.consts = e.bf + 8;
  const int rows = e.T > up ? e.T : up;
  e.buf0 = smem + blob_len + threadIdx.x;
  e.buf1 = e.buf0 + rows * bs;
  return e;
}

// The raw stream-1 head q[5] of voxel v (kernels B and C).
static __device__ __forceinline__ void qv_encode_voxel(
    const QvEncoder& e, const float* __restrict__ x, long long n, long long v,
    int t_in, int channel_major, int mask_channel, float q[5]) {
  const int T = e.T, bs = e.bs;
  float* buf0 = e.buf0;
  // ---- normalise into buf0 -----------------------------------------------
  float mask = 1.0f;
  if (mask_channel)
    mask = channel_major ? x[(long long)T * n + v] : x[v * t_in + T];
  for (int t = 0; t < T; ++t) {
    float xv = channel_major ? x[(long long)t * n + v] : x[v * t_in + t];
    if (mask_channel) xv = xv * mask;
    buf0[t * bs] = fminf(fmaxf(xv, 1e-2f), 1e8f);
  }
  float ref;
  if (e.multi_image) {
    float sum = 0.0f;
    for (int t = e.lo; t < e.hi; ++t) sum += buf0[t * bs];
    ref = sum / (float)(e.hi - e.lo);
  } else {
    ref = buf0[e.se_idx * bs];
  }
  for (int t = 0; t < T; ++t) buf0[t * bs] = logf(buf0[t * bs] / ref);

  // ---- stream-1 dense chain ------------------------------------------------
  qv_dense(buf0, T, e.wfc, e.bfc, e.buf1, e.up, e.act, bs);
  float* cur = e.buf1;
  float* nxt = buf0;
  for (int i = 0; i < e.nb; ++i) {
    qv_dense(cur, e.up, e.wb + i * e.up * e.up, e.bb + i * e.up, nxt, e.up,
             e.act, bs);
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // ---- float32 head (U -> 5) -----------------------------------------------
  float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f, q3 = 0.0f, q4 = 0.0f;
  for (int k = 0; k < e.up; ++k) {
    float h = cur[k * bs];
    float4 w = *reinterpret_cast<const float4*>(e.wf + k * 8);
    q0 = fmaf(w.x, h, q0);
    q1 = fmaf(w.y, h, q1);
    q2 = fmaf(w.z, h, q2);
    q3 = fmaf(w.w, h, q3);
    q4 = fmaf(e.wf[k * 8 + 4], h, q4);
  }
  q[0] = q0 + e.bf[0];
  q[1] = q1 + e.bf[1];
  q[2] = q2 + e.bf[2];
  q[3] = q3 + e.bf[3];
  q[4] = q4 + e.bf[4];
}

__global__ void qv_encode_quad_kernel(
    const float* __restrict__ x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int up, int nb,
    const float* __restrict__ blob, int blob_len, int mvg, QvRanges r,
    float* __restrict__ means, float* __restrict__ vars,
    float* __restrict__ raw) {
  extern __shared__ float4 smem4[];
  const QvEncoder e = qv_stage_encoder(reinterpret_cast<float*>(smem4), blob,
                                       blob_len, t_in, mask_channel, se_idx,
                                       multi_image, act, up, nb);
  const long long stride = (long long)gridDim.x * e.bs;
  for (long long v = (long long)blockIdx.x * e.bs + threadIdx.x; v < n;
       v += stride) {
    float q[5];
    qv_encode_voxel(e, x, n, v, t_in, channel_major, mask_channel, q);
    // ---- quadrature summaries + raw-log-std transforms ---------------------
    float m[3], s[3], rw[3];
    qv_quad_voxel(e.consts, q[0], q[1], q[2], q[3], q[4], mvg != 0, r, m, s,
                  rw);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      means[(long long)j * n + v] = m[j];
      vars[(long long)j * n + v] = s[j];
      raw[(long long)j * n + v] = rw[j];
    }
  }
}

__global__ void qv_encode_q_kernel(
    const float* __restrict__ x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int up, int nb,
    const float* __restrict__ blob, int blob_len, float* __restrict__ q_out) {
  extern __shared__ float4 smem4[];
  const QvEncoder e = qv_stage_encoder(reinterpret_cast<float*>(smem4), blob,
                                       blob_len, t_in, mask_channel, se_idx,
                                       multi_image, act, up, nb);
  const long long stride = (long long)gridDim.x * e.bs;
  for (long long v = (long long)blockIdx.x * e.bs + threadIdx.x; v < n;
       v += stride) {
    float q[5];
    qv_encode_voxel(e, x, n, v, t_in, channel_major, mask_channel, q);
#pragma unroll
    for (int j = 0; j < 5; ++j) q_out[(long long)j * n + v] = q[j];
  }
}

// Grid of a grid-stride encode kernel: as many blocks as the voxels need, at
// most as many as fit on the card at once (the weights are staged once per
// resident block).
static int qv_encode_grid(const void* kernel, long long n, int block,
                          long long smem_bytes, int* grid) {
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
  long long need = (n + block - 1) / block;
  long long cap = (long long)sms * per_sm;
  *grid = (int)(need < cap ? need : cap);
  return 0;
}

extern "C" int qv_encode_quad_fused(
    const float* x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int u, int up,
    int nb, const float* blob, int blob_len, QvRanges r, float* means,
    float* vars, float* raw, int mvg, int block, long long smem_bytes,
    void* stream) {
  (void)u;
  int grid = 0;
  int err = qv_encode_grid((const void*)qv_encode_quad_kernel, n, block,
                           smem_bytes, &grid);
  if (err != 0) return err;
  qv_encode_quad_kernel<<<grid, block, (size_t)smem_bytes,
                          (cudaStream_t)stream>>>(
      x, n, t_in, channel_major, mask_channel, se_idx, multi_image, act, up,
      nb, blob, blob_len, mvg, r, means, vars, raw);
  return (int)cudaGetLastError();
}

extern "C" int qv_encode_q1(const float* x, long long n, int t_in,
                            int channel_major, int mask_channel, int se_idx,
                            int multi_image, int act, int up, int nb,
                            const float* blob, int blob_len, float* q,
                            int block, long long smem_bytes, void* stream) {
  int grid = 0;
  int err = qv_encode_grid((const void*)qv_encode_q_kernel, n, block,
                           smem_bytes, &grid);
  if (err != 0) return err;
  qv_encode_q_kernel<<<grid, block, (size_t)smem_bytes,
                       (cudaStream_t)stream>>>(
      x, n, t_in, channel_major, mask_channel, se_idx, multi_image, act, up,
      nb, blob, blob_len, q);
  return (int)cudaGetLastError();
}
