// Kernel H: the encoder trunk's 3x3 SAME convolution, forward and backward.
//
// Replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_conv.py::
// make_conv3x3: the forward (_fwd_kernel, pallas_call at :188) and the
// backward that emits dx, dw and db in one pass (_bwd_kernel, :239).
// Semantics: nn.Conv((3, 3), padding="SAME") on channels-last float32
// x (N, H, W, Ci) with weights (3, 3, Ci, Co) HWIO and bias (Co), float32
// accumulation, any H, W >= 3 and any Ci, Co.
//
// Bound: operations. At the fine-tune fold (304 planes of 25 x 25 x 60)
// a pass is 2 * 9 * 60 * 60 * 190,000 = 12.3 GFLOP, 0.184 ms at the card's
// 67 TFLOP/s float32 peak, against ~91 MB of activations and weights
// (0.027 ms at 3.35 TB/s); the backward is two such passes (dx and dw).
// What the design does about it: every input value staged in shared
// memory feeds 64 output channels, every weight word 256 pixels, and a
// thread keeps a register block of 4 pixels x 16 output channels, so the
// inner loop is 64 FMAs to 4 scalar loads and 4 broadcast float4 loads.
// Tensor cores (wgmma on TF32 splits) are later work.
//
// Layout. The pixels of all planes are one flat index p = (n * H + h) * W
// + w. A forward block takes 256 consecutive pixels and 64 output
// channels; it stages, 16 input channels at a time, the strip of pixels
// p0 - W - 1 .. p0 + 256 + W (the block's pixels with their one-row,
// one-column halo) channel-major, so the 32 lanes of a warp read 32
// consecutive words, and the 9 x 16 x 64 weight taps of the chunk. Taps
// that leave a pixel's plane (SAME zero padding, and the neighbouring
// plane above or below) are masked per pixel, so a strip may cross plane
// boundaries and no pixel slot is wasted at W = 25.
//
// dx is the same kernel on the cotangent with the taps flipped and
// transposed, wt[dy, dx, co, ci] = w[2 - dy, 2 - dx, ci, co] (as
// pallas_conv.py:232-235 builds them), read in place, without bias.
//
// dw and db reduce over all N * H * W pixels (190,000 terms at the
// fine-tune fold). The TPU kernel carried the sums across its sequential
// grid; Hopper's blocks run in parallel and in no order, and float atomics
// would make dw differ from run to run. So a first pass writes one partial
// sum per block of pixels into scratch the wrapper allocates, and a second
// pass adds the partials in block order: the same bits in every run, so a
// fine-tune replays.
//
// Arithmetic: every product is accumulated by fmaf (the build's
// --fmad=false does not touch explicit FMAs). The order of summation is
// the kernel's (channel chunks, then channels, then taps), not the plain
// version's (a product per tap, then the taps).

#include <cuda_runtime.h>

#define QV_CONV_THREADS 256
#define QV_CONV_TP 256  // output pixels of a forward / dx block
#define QV_CONV_CI 16   // input channels staged at a time
#define QV_CONV_CO 64   // output channels of a block: 4 groups of 16
#define QV_DW_TP 64     // pixels staged at a time by the dw/db pass

// Bit dy * 3 + dx is set when tap (dy, dx) of pixel p lies in p's plane.
__device__ __forceinline__ int qv_tap_mask(long long p, long long np, int h,
                                           int wd) {
  if (p >= np) return 0;
  int c = (int)(p % wd);
  int r = (int)((p / wd) % h);
  int m = 0;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      int rr = r + dy - 1, cc = c + dx - 1;
      if (rr >= 0 && rr < h && cc >= 0 && cc < wd) m |= 1 << (dy * 3 + dx);
    }
  }
  return m;
}

// Stage channels ci0 .. ci0 + 15 of the strip of pixels q = p0 - W - 1 + s,
// s in [0, len), as xs[c * len + s]; zeros outside the tensor.
__device__ __forceinline__ void qv_stage_strip(
    const float* __restrict__ x, float* xs, long long p0, int len,
    long long np, int wd, int cin, int ci0) {
  for (int e = threadIdx.x; e < len * QV_CONV_CI; e += QV_CONV_THREADS) {
    int c = e % QV_CONV_CI, s = e / QV_CONV_CI;
    long long q = p0 - (wd + 1) + s;
    int ci = ci0 + c;
    float v = 0.0f;
    if (q >= 0 && q < np && ci < cin) v = x[q * cin + ci];
    xs[c * len + s] = v;
  }
}

// out[p, o] = sum_{tap, c} in[p + off(tap), c] * W(tap, c, o) (+ b[o]),
// W(tap, c, o) = w[tap, c, o] (forward) or w[8 - tap, o, c] (dx: w is the
// forward's (3, 3, cout, cin) weight).
template <bool FLIP>
__device__ __forceinline__ void qv_conv3x3_body(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ y, long long np, int h,
    int wd, int cin, int cout) {
  extern __shared__ float4 qv_conv_smem[];
  float* ws = reinterpret_cast<float*>(qv_conv_smem);  // [9][CI][CO]
  float* xs = ws + 9 * QV_CONV_CI * QV_CONV_CO;        // [CI][len]
  const int len = QV_CONV_TP + 2 * wd + 2;
  const long long p0 = (long long)blockIdx.x * QV_CONV_TP;
  const int co0 = blockIdx.y * QV_CONV_CO;
  const int t = threadIdx.x, g = t >> 6, j = t & 63;

  int mask[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mask[i] = qv_tap_mask(p0 + j + 64 * i, np, h, wd);
  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[i][k] = 0.0f;

  for (int ci0 = 0; ci0 < cin; ci0 += QV_CONV_CI) {
    __syncthreads();  // the previous chunk's reads are done
    qv_stage_strip(x, xs, p0, len, np, wd, cin, ci0);
    for (int e = t; e < 9 * QV_CONV_CI * QV_CONV_CO; e += QV_CONV_THREADS) {
      int ol = e % QV_CONV_CO, rest = e / QV_CONV_CO;
      int c = rest % QV_CONV_CI, tap = rest / QV_CONV_CI;
      int ci = ci0 + c, o = co0 + ol;
      float v = 0.0f;
      if (ci < cin && o < cout)
        v = FLIP ? w[((long long)(8 - tap) * cout + o) * cin + ci]
                 : w[((long long)tap * cin + ci) * cout + o];
      ws[e] = v;
    }
    __syncthreads();
    const int nci = cin - ci0 < QV_CONV_CI ? cin - ci0 : QV_CONV_CI;
    for (int c = 0; c < nci; ++c) {
      const float* xr = xs + c * len + j;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = (tap / 3) * wd + tap % 3;
        const float4* wr = reinterpret_cast<const float4*>(
            ws + (tap * QV_CONV_CI + c) * QV_CONV_CO + g * 16);
        float wv[16];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float4 q = wr[k];
          wv[4 * k] = q.x;
          wv[4 * k + 1] = q.y;
          wv[4 * k + 2] = q.z;
          wv[4 * k + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float xv = xr[64 * i + off];
          xv = ((mask[i] >> tap) & 1) ? xv : 0.0f;
#pragma unroll
          for (int k = 0; k < 16; ++k) acc[i][k] = fmaf(xv, wv[k], acc[i][k]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    long long p = p0 + j + 64 * i;
    if (p >= np) continue;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      int o = co0 + g * 16 + k;
      if (o < cout) y[p * cout + o] = b ? acc[i][k] + b[o] : acc[i][k];
    }
  }
}

__global__ void __launch_bounds__(QV_CONV_THREADS)
    qv_conv3x3_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ y,
                          long long np, int h, int wd, int cin, int cout) {
  qv_conv3x3_body<false>(x, w, b, y, np, h, wd, cin, cout);
}

__global__ void __launch_bounds__(QV_CONV_THREADS)
    qv_conv3x3_dx_kernel(const float* __restrict__ ct,
                         const float* __restrict__ w, float* __restrict__ dx,
                         long long np, int h, int wd, int co_f, int ci_f) {
  qv_conv3x3_body<true>(ct, w, nullptr, dx, np, h, wd, co_f, ci_f);
}

// First pass of dw/db: block (bx, by, bz) sums pixels [bx * chunk, +chunk)
// for input channels by * 16 .. +15 and output channels bz * 64 .. +63 into
// part[bx, :], laid out as dw (3, 3, cin, cout) then db (cout); the blocks
// of by == 0 also sum db.
__global__ void __launch_bounds__(QV_CONV_THREADS)
    qv_conv3x3_dw_kernel(const float* __restrict__ x,
                         const float* __restrict__ ct,
                         float* __restrict__ part, long long np, int h,
                         int wd, int cin, int cout, long long chunk) {
  extern __shared__ float4 qv_conv_smem[];
  float* cs = reinterpret_cast<float*>(qv_conv_smem);  // [TP][CO]
  float* xs = cs + QV_DW_TP * QV_CONV_CO;               // [CI][len]
  const int len = QV_DW_TP + 2 * wd + 2;
  int* ms = reinterpret_cast<int*>(xs + QV_CONV_CI * len);  // [TP]
  const int t = threadIdx.x, cg = t & 15, c = t >> 4;
  const int ci0 = blockIdx.y * QV_CONV_CI, co0 = blockIdx.z * QV_CONV_CO;
  const bool with_db = blockIdx.y == 0 && c == 0;
  const long long pbeg = (long long)blockIdx.x * chunk;
  const long long pend = pbeg + chunk < np ? pbeg + chunk : np;

  float acc[9][4], db[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    db[k] = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) acc[tap][k] = 0.0f;
  }
  for (long long p0 = pbeg; p0 < pend; p0 += QV_DW_TP) {
    __syncthreads();
    for (int e = t; e < QV_DW_TP * QV_CONV_CO; e += QV_CONV_THREADS) {
      long long p = p0 + e / QV_CONV_CO;
      int o = co0 + e % QV_CONV_CO;
      cs[e] = (p < pend && o < cout) ? ct[p * cout + o] : 0.0f;
    }
    qv_stage_strip(x, xs, p0, len, np, wd, cin, ci0);
    for (int e = t; e < QV_DW_TP; e += QV_CONV_THREADS)
      ms[e] = p0 + e < pend ? qv_tap_mask(p0 + e, np, h, wd) : 0;
    __syncthreads();
    const int npx = pend - p0 < QV_DW_TP ? (int)(pend - p0) : QV_DW_TP;
    const float* xr = xs + c * len;
    for (int pl = 0; pl < npx; ++pl) {
      const float4 q = reinterpret_cast<const float4*>(cs + pl * QV_CONV_CO)[cg];
      const int m = ms[pl];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        float xv = xr[pl + (tap / 3) * wd + tap % 3];
        xv = ((m >> tap) & 1) ? xv : 0.0f;
        acc[tap][0] = fmaf(xv, q.x, acc[tap][0]);
        acc[tap][1] = fmaf(xv, q.y, acc[tap][1]);
        acc[tap][2] = fmaf(xv, q.z, acc[tap][2]);
        acc[tap][3] = fmaf(xv, q.w, acc[tap][3]);
      }
      if (with_db) {
        db[0] += q.x;
        db[1] += q.y;
        db[2] += q.z;
        db[3] += q.w;
      }
    }
  }
  const long long len_part = 9LL * cin * cout + cout;
  float* out = part + (long long)blockIdx.x * len_part;
  const int ci = ci0 + c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int o = co0 + 4 * cg + k;
    if (o >= cout) continue;
    if (ci < cin) {
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        out[((long long)tap * cin + ci) * cout + o] = acc[tap][k];
    }
    if (with_db) out[9LL * cin * cout + o] = db[k];
  }
}

// Second pass: out[i] = sum over blocks b, in order, of part[b, i].
__global__ void qv_conv3x3_reduce_kernel(const float* __restrict__ part,
                                         float* __restrict__ out, int nb,
                                         long long len) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < len; i += stride) {
    float s = 0.0f;
    for (int b = 0; b < nb; ++b) s += part[(long long)b * len + i];
    out[i] = s;
  }
}

static size_t qv_conv_smem_bytes(int wd) {
  return sizeof(float) * (9 * QV_CONV_CI * QV_CONV_CO +
                          QV_CONV_CI * (QV_CONV_TP + 2 * wd + 2));
}

static size_t qv_dw_smem_bytes(int wd) {
  return sizeof(float) * (QV_DW_TP * QV_CONV_CO +
                          QV_CONV_CI * (QV_DW_TP + 2 * wd + 2)) +
         sizeof(int) * QV_DW_TP;
}

// y = conv(x, w) + b; x (np pixels of h x wd planes, cin), w (3, 3, cin,
// cout), b (cout) or null.
extern "C" int qv_conv3x3_fwd(const float* x, const float* w, const float* b,
                              float* y, long long np, int h, int wd, int cin,
                              int cout, void* stream) {
  size_t smem = qv_conv_smem_bytes(wd);
  cudaError_t err = cudaFuncSetAttribute(
      qv_conv3x3_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((np + QV_CONV_TP - 1) / QV_CONV_TP),
            (unsigned)((cout + QV_CONV_CO - 1) / QV_CONV_CO));
  qv_conv3x3_fwd_kernel<<<grid, QV_CONV_THREADS, smem,
                          (cudaStream_t)stream>>>(x, w, b, y, np, h, wd, cin,
                                                  cout);
  return (int)cudaGetLastError();
}

// dx of y = conv(x, w): ct (np, cout), w the forward's (3, 3, cin, cout),
// dx (np, cin).
extern "C" int qv_conv3x3_dx(const float* ct, const float* w, float* dx,
                             long long np, int h, int wd, int cin, int cout,
                             void* stream) {
  size_t smem = qv_conv_smem_bytes(wd);
  cudaError_t err = cudaFuncSetAttribute(
      qv_conv3x3_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((np + QV_CONV_TP - 1) / QV_CONV_TP),
            (unsigned)((cin + QV_CONV_CO - 1) / QV_CONV_CO));
  qv_conv3x3_dx_kernel<<<grid, QV_CONV_THREADS, smem,
                         (cudaStream_t)stream>>>(ct, w, dx, np, h, wd, cout,
                                                 cin);
  return (int)cudaGetLastError();
}

// dw (3, 3, cin, cout) and db (cout), written contiguously to out, from x
// (np, cin) and ct (np, cout): per-block partial sums of `chunk` pixels
// into part (nb, 9 cin cout + cout), nb = ceil(np / chunk), then their sum
// in block order.
extern "C" int qv_conv3x3_dw(const float* x, const float* ct, float* part,
                             float* out, long long np, int h, int wd,
                             int cin, int cout, long long chunk, int nb,
                             void* stream) {
  size_t smem = qv_dw_smem_bytes(wd);
  cudaError_t err = cudaFuncSetAttribute(
      qv_conv3x3_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nb, (unsigned)((cin + QV_CONV_CI - 1) / QV_CONV_CI),
            (unsigned)((cout + QV_CONV_CO - 1) / QV_CONV_CO));
  qv_conv3x3_dw_kernel<<<grid, QV_CONV_THREADS, smem,
                         (cudaStream_t)stream>>>(x, ct, part, np, h, wd, cin,
                                                 cout, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  long long len = 9LL * cin * cout + cout;
  int blocks = len > 4096LL * 256 ? 4096 : (int)((len + 255) / 256);
  qv_conv3x3_reduce_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      part, out, nb, len);
  return (int)cudaGetLastError();
}
