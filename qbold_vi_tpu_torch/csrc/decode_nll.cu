// Kernel G: physics decode + reconstruction NLL of given (oef, dbv) draws,
// forward and closed-form backward.
//
// Replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_decode.py::
// make_fused_decode_nll (_fwd_kernel / _bwd_kernel, pallas_call at :399 and
// :431), the fine-tune likelihood when the fused ELBO kernel is off or does
// not cover the configuration. The TPU version packs the voxels into
// (8 x 256) tiles with the taus on a leading axis and pads N; here one
// thread takes one voxel (grid-stride), reads its (T,) rows of y and sigma
// as they lie in (N, T) memory and writes exactly N rows.
//
// Bound: operations. Per voxel and draw the forward evaluates T + 1
// Chebyshev surrogates (~21 FMA-pairs each) and ~2 T exp/log against
// (2 T + 3) floats read and one written; the backward a second Clenshaw
// per tau. The per-scan table (taus, Chebyshev words, Gauss-Jacobi nodes)
// is staged in shared memory once per block; every thread of a warp reads
// the same word, a broadcast.

#include "elbo_math.cuh"

__global__ void qv_decode_nll_fwd_kernel(
    const float* __restrict__ oef, const float* __restrict__ dbv,
    const float* __restrict__ y, const float* __restrict__ sig,
    const float* __restrict__ mask, long long n, QvDecodeConsts C,
    const float* __restrict__ table, float* __restrict__ rows) {
  extern __shared__ float smem[];
  int T = C.n_taus;
  qv_stage_table(table, smem, qv_table_len(T));
  __syncthreads();
  QvTable tb = qv_table(smem, T);
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += stride) {
    float m = mask[v];
    rows[v] = qv_nll_row(C, tb, oef[v], dbv[v], y + v * T, sig + v * T, m)
              * m;
  }
}

__global__ void qv_decode_nll_bwd_kernel(
    const float* __restrict__ oef, const float* __restrict__ dbv,
    const float* __restrict__ y, const float* __restrict__ sig,
    const float* __restrict__ mask, const float* __restrict__ ct,
    long long n, QvDecodeConsts C, const float* __restrict__ table,
    float* __restrict__ doef, float* __restrict__ ddbv,
    float* __restrict__ dsig, float* __restrict__ dy) {
  extern __shared__ float smem[];
  int T = C.n_taus;
  qv_stage_table(table, smem, qv_table_len(T));
  __syncthreads();
  QvTable tb = qv_table(smem, T);
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n;
       v += stride) {
    float m = mask[v];
    float c = ct[v] * m;  // the row was masked
    float go, gd;
    qv_nll_row_grads(C, tb, oef[v], dbv[v], y + v * T, sig + v * T, m, c,
                     true, dsig + v * T, dy + v * T, &go, &gd);
    doef[v] = c * go;
    ddbv[v] = c * gd;
  }
}

extern "C" int qv_decode_nll_fwd(const float* oef, const float* dbv,
                                 const float* y, const float* sig,
                                 const float* mask, long long n,
                                 QvDecodeConsts C, const float* table,
                                 int table_len, float* rows, int grid,
                                 int block, void* stream) {
  qv_decode_nll_fwd_kernel<<<grid, block, table_len * sizeof(float),
                             (cudaStream_t)stream>>>(oef, dbv, y, sig, mask, n,
                                                     C, table, rows);
  return (int)cudaGetLastError();
}

extern "C" int qv_decode_nll_bwd(const float* oef, const float* dbv,
                                 const float* y, const float* sig,
                                 const float* mask, const float* ct,
                                 long long n, QvDecodeConsts C,
                                 const float* table, int table_len,
                                 float* doef, float* ddbv, float* dsig,
                                 float* dy, int grid, int block,
                                 void* stream) {
  qv_decode_nll_bwd_kernel<<<grid, block, table_len * sizeof(float),
                             (cudaStream_t)stream>>>(
      oef, dbv, y, sig, mask, ct, n, C, table, doef, ddbv, dsig, dy);
  return (int)cudaGetLastError();
}
