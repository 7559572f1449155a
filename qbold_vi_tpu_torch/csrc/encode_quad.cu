// Kernel B: fused stream-1 encode + quadrature posterior summaries.
//
// Replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_infer.py::
// encode_quad_fused (_encode_quad_kernel -> _encode_body, then
// ops/quadrature.py::quad_tile_summaries). Per voxel:
//   [mask] -> clip(1e-2, 1e8) -> divide by the spin-echo reference (one
//   image, or the mean of [max(se-1, 0), se+2)) -> log
//   -> Dense(T -> U) + act -> nb x Dense(U -> U) + act -> Dense(U -> 5)
//   -> quadrature summaries (quad_math.cuh) and the raw-log-std transforms.
// q and the activations never reach device memory; the outputs are written
// channel-major (3, N) directly (the TPU's (5, 8, R/8) re-split is a TPU
// layout and is not carried over).
//
// Bound: about 48 B read and 36 B written per voxel against U*T + nb*U*U +
// 5*U FMAs (8.2 k at U=60, nb=2, T=11) and ~150 transcendentals, so the
// FMA chain and the quadrature, not memory, bound it. Design: one thread
// per voxel. The padded weights (transposed so that 4 output channels are
// one float4) and the quadrature node table are staged once per block in
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

__global__ void qv_encode_quad_kernel(
    const float* __restrict__ x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int up, int nb,
    const float* __restrict__ blob, int blob_len, int mvg, QvRanges r,
    float* __restrict__ means, float* __restrict__ vars,
    float* __restrict__ raw) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int T = t_in - mask_channel;
  const int bs = blockDim.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < blob_len; i += bs) smem[i] = blob[i];
  __syncthreads();

  const float* wfc = smem;
  const float* bfc = wfc + T * up;
  const float* wb = bfc + up;
  const float* bb = wb + nb * up * up;
  const float* wf = bb + nb * up;
  const float* bf = wf + up * 8;
  const float* c = bf + 8;
  const int rows = T > up ? T : up;
  float* buf0 = smem + blob_len + tid;
  float* buf1 = buf0 + rows * bs;

  const int lo = se_idx - 1 > 0 ? se_idx - 1 : 0;
  const int hi = se_idx + 2 < T ? se_idx + 2 : T;
  const long long stride = (long long)gridDim.x * bs;
  for (long long v = (long long)blockIdx.x * bs + tid; v < n; v += stride) {
    // ---- normalise into buf0 -------------------------------------------
    float mask = 1.0f;
    if (mask_channel)
      mask = channel_major ? x[(long long)T * n + v] : x[v * t_in + T];
    for (int t = 0; t < T; ++t) {
      float xv = channel_major ? x[(long long)t * n + v] : x[v * t_in + t];
      if (mask_channel) xv = xv * mask;
      buf0[t * bs] = fminf(fmaxf(xv, 1e-2f), 1e8f);
    }
    float ref;
    if (multi_image) {
      float sum = 0.0f;
      for (int t = lo; t < hi; ++t) sum += buf0[t * bs];
      ref = sum / (float)(hi - lo);
    } else {
      ref = buf0[se_idx * bs];
    }
    for (int t = 0; t < T; ++t) buf0[t * bs] = logf(buf0[t * bs] / ref);

    // ---- stream-1 dense chain --------------------------------------------
    qv_dense(buf0, T, wfc, bfc, buf1, up, act, bs);
    float* cur = buf1;
    float* nxt = buf0;
    for (int i = 0; i < nb; ++i) {
      qv_dense(cur, up, wb + i * up * up, bb + i * up, nxt, up, act, bs);
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }

    // ---- float32 head (U -> 5) -------------------------------------------
    float q0 = 0.0f, q1 = 0.0f, q2 = 0.0f, q3 = 0.0f, q4 = 0.0f;
    for (int k = 0; k < up; ++k) {
      float h = cur[k * bs];
      float4 w = *reinterpret_cast<const float4*>(wf + k * 8);
      q0 = fmaf(w.x, h, q0);
      q1 = fmaf(w.y, h, q1);
      q2 = fmaf(w.z, h, q2);
      q3 = fmaf(w.w, h, q3);
      q4 = fmaf(wf[k * 8 + 4], h, q4);
    }
    q0 += bf[0];
    q1 += bf[1];
    q2 += bf[2];
    q3 += bf[3];
    q4 += bf[4];

    // ---- quadrature summaries + raw-log-std transforms --------------------
    float m[3], s[3], rw[3];
    qv_quad_voxel(c, q0, q1, q2, q3, q4, mvg != 0, r, m, s, rw);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      means[(long long)j * n + v] = m[j];
      vars[(long long)j * n + v] = s[j];
      raw[(long long)j * n + v] = rw[j];
    }
  }
}

extern "C" int qv_encode_quad_fused(
    const float* x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int u, int up,
    int nb, const float* blob, int blob_len, QvRanges r, float* means,
    float* vars, float* raw, int mvg, int block, long long smem_bytes,
    void* stream) {
  (void)u;
  cudaError_t err = cudaFuncSetAttribute(
      qv_encode_quad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, qv_encode_quad_kernel, block, (size_t)smem_bytes)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long need = (n + block - 1) / block;
  long long cap = (long long)sms * per_sm;
  int grid = (int)(need < cap ? need : cap);
  qv_encode_quad_kernel<<<grid, block, (size_t)smem_bytes,
                          (cudaStream_t)stream>>>(
      x, n, t_in, channel_major, mask_channel, se_idx, multi_image, act, up,
      nb, blob, blob_len, mvg, r, means, vars, raw);
  return (int)cudaGetLastError();
}
