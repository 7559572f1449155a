// Kernel A: deterministic quadrature posterior summaries.
//
// Replaces the Pallas TPU kernel qbold_vi_tpu/ops/quadrature.py::
// quad_posterior_summaries (_quad_kernel -> quad_tile_summaries). The TPU
// version packs the (N, 5) rows into (5, 8, N/8) sublane tiles and pads N;
// here a block takes blockDim.x voxels at a time, one a thread, reads their
// (N, 4|5) rows as they lie, masking the ragged edge, and writes (N, 3)
// means and variances.
//
// Bound: the instructions it issues (three 16-node passes a voxel, two
// MUFU operations a node), not its 20 B read and 24 B written. Each 1-D
// moment routine takes the Gauss-Hermite or the Gauss-Laguerre side by its
// own std, and on real heads nearly every warp of 32 consecutive voxels
// straddles the split (PERF.md: C's rows 13-23% Laguerre, 99-100% of warps
// straddling), so a warp ran both sides. Here each routine's problems are
// first sorted by side across the block (quad_math.cuh::qv_quad_block), so
// that one warp of the block at most runs both. The 208-float node table
// is staged once per block in shared memory, where every thread of a warp
// reads the same word (a broadcast).

#include <cuda_runtime.h>

#include "quad_math.cuh"

#define QV_QUAD_THREADS 256  // the largest block; the wrapper's

__global__ void __launch_bounds__(QV_QUAD_THREADS, 4) qv_quad_kernel(
    const float* __restrict__ params, long long n, int k, int mvg,
    QvRanges r, const float* __restrict__ consts, float* __restrict__ means,
    float* __restrict__ vars) {
  __shared__ float c[QV_NCONST];
  __shared__ float scratch[QV_QUAD_SCRATCH(QV_QUAD_THREADS)];
  qv_stage_consts(consts, c);
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v0 = (long long)blockIdx.x * blockDim.x; v0 < n;
       v0 += stride) {
    const long long v = v0 + threadIdx.x;
    const bool live = v < n;
    const float* p = params + (live ? v : v0) * k;
    float raw[3];
    const QvQuadIn in = qv_quad_squash(p[0], p[1], p[2], p[3],
                                       k == 5 ? p[4] : 0.0f, mvg != 0, raw);
    float o[8], g[5], D1, D2;
    qv_quad_block(c, scratch, live, in, o, &D1, &D2, g);
    if (!live) continue;
    float m[3], s[3];
    qv_quad_combine(o, D1, D2, g, in.od, r, m, s);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      means[v * 3 + j] = m[j];
      vars[v * 3 + j] = s[j];
    }
  }
}

extern "C" int qv_quad_posterior_summaries(
    const float* params, long long n, int k, int mvg, QvRanges r,
    const float* consts, float* means, float* vars, int grid, int block,
    void* stream) {
  if (block % 32 != 0 || block > QV_QUAD_THREADS)
    return (int)cudaErrorInvalidValue;
  qv_quad_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      params, n, k, mvg, r, consts, means, vars);
  return (int)cudaGetLastError();
}

extern "C" const char* qv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int qv_max_dynamic_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}

// Floats of shared memory qv_quad_block sorts a block of ``threads`` in
// (kernel B adds them to its dynamic shared memory).
extern "C" int qv_quad_scratch_floats(int threads) {
  return QV_QUAD_SCRATCH(threads);
}
