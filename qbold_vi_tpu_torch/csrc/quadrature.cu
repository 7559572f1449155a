// Kernel A: deterministic quadrature posterior summaries.
//
// Replaces the Pallas TPU kernel qbold_vi_tpu/ops/quadrature.py::
// quad_posterior_summaries (_quad_kernel -> quad_tile_summaries). The TPU
// version packs the (N, 5) rows into (5, 8, N/8) sublane tiles and pads N;
// here one thread takes one voxel and reads its (N, 4|5) row as it lies,
// masking the ragged edge, and writes (N, 3) means and variances.
//
// Bound: compute. About 150 expf/tanhf per voxel (three 16-node passes and
// their splits) against 20 B read and 24 B written; the branch on s < 1.5
// is taken per thread (a warp whose voxels straddle it runs both sides).
// The 208-float node table is staged once per block in shared memory,
// where every thread of a warp reads the same word (a broadcast).

#include <cuda_runtime.h>

#include "quad_math.cuh"

__global__ void qv_quad_kernel(const float* __restrict__ params, long long n,
                               int k, int mvg, QvRanges r,
                               const float* __restrict__ consts,
                               float* __restrict__ means,
                               float* __restrict__ vars) {
  __shared__ float c[QV_NCONST];
  qv_stage_consts(consts, c);
  __syncthreads();
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += stride) {
    const float* p = params + v * k;
    float q4 = (k == 5) ? p[4] : 0.0f;
    float m[3], s[3], raw[3];
    qv_quad_voxel(c, p[0], p[1], p[2], p[3], q4, mvg != 0, r, m, s, raw);
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
