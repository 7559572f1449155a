// Kernel H: the encoder trunk's 3x3 SAME convolution, forward and backward,
// on Hopper's tensor cores: float32-accurate 3xTF32 products for a float32
// trunk, and bf16 products with float32 sums for a bf16 one (the end of this
// header).
//
// Replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_conv.py::
// make_conv3x3: the forward (_fwd_kernel, pallas_call at :188) and the
// backward that emits dx, dw and db in one pass (_bwd_kernel, :239).
// Semantics: nn.Conv((3, 3), padding="SAME") on channels-last float32
// x (N, H, W, Ci) with weights (3, 3, Ci, Co) HWIO and bias (Co), float32
// accumulation, any H, W >= 3 and any Ci, Co.
//
// Why 3xTF32 (float32-accurate products on the TF32 tensor cores, with a
// fresh fragment every few k-steps): csrc/mma_math.cuh.
//
// Bound: operations. At the fine-tune fold (304 planes of 25 x 25 x 60) a
// pass is 2 * 9 * 60 * 60 * 190,000 = 12.3 GFLOP; three TF32 products each
// make that 37 GFLOP at the card's 495 TFLOP/s dense TF32 rate, 0.075 ms,
// against ~91 MB of activations (0.027 ms at 3.35 TB/s). The backward is
// two such passes (dx and dw). The products are mma.sync.m16n8k8 on TF32
// fragments formed in registers (wgmma, the full-rate route, is later
// work; PERF.md), the operand splits two integer operations and a
// subtraction each.
//
// Implicit GEMM on the flat pixel index p = (n * H + h) * W + w. Per tap
// t = (dy, dx), Y[p, :] += mask_t(p) * X[p + (dy - 1) W + dx - 1, :] @ W_t.
// Forward and dx (qv_conv3x3_mma_body): a block of 8 warps takes 128
// pixels (M) and 64 output channels (N); warp (wm, wn) holds a 32 x 32
// tile of sums, 2 x 4 fragments of 16 x 8, 32 floats a thread, and a
// fresh fragment per 4 k-steps. K runs over the 9 taps x the input
// channels, 64 channels staged at a time: the block's input rows
// p0 - W - 1 .. p0 + 128 + W, one contiguous range of the (P, Ci) matrix,
// are staged once into shared memory (or, when W > 130, three ranges of
// 130 rows, one a tap row), each row padded to 72 words, so the 64-bit
// fragment loads of a half-warp fall on 32 distinct banks whatever the
// tap's offset. Within a k-step of 8 channels, mma slot k and k + 4 carry
// channels 2k and 2k + 1, so a thread reads its two A values of a row with
// one 64-bit load. The per-pixel tap mask (taps that leave a pixel's
// plane: SAME zero padding, the planes above and below, the tensor's ends)
// zeroes A in registers before the split, so a tile may cross any number
// of plane boundaries and no pixel slot is wasted at W = 25. The weights
// are split once per call by qv_conv3x3_wsplit_kernel into hi/lo pairs
// laid out in fragment order (one 16-byte load gives a thread b0, b1 hi
// and lo), zero-filled past Ci and Co; 9 taps x 64 x 64 x 2 floats
// (295 KB at 60 x 60) exceed a block's shared memory, so they are read
// through L1 from L2.
//
// dx is the same kernel on the cotangent with the taps flipped and
// transposed, wt[dy, dx, co, ci] = w[2 - dy, 2 - dx, ci, co] (as
// pallas_conv.py:232-235 builds them): only the weight split reads w
// differently.
//
// dw and db: per tap, dW_t (Ci x Co) = sum_p mask_t(p) X[p + off_t, :]^T
// ct[p, :], a GEMM with M = Ci, N = Co and K = pixels. A block takes one
// tap row dy (blockIdx.z % 3), 64 input and 64 output channels and a chunk
// of pixels, staged 128 at a time (ct rows, the 130 X rows of the tap row,
// the pixels' masks); warp w holds the 16 input channels w * 16 .. of the
// three taps (dy, 0..2) x 64 output channels, 96 floats a thread, and a
// fresh fragment per k-step (its sums are long). The ct fragments are
// split once a k-step and serve all three taps. The wrapper sizes the
// chunks so that the blocks make one wave (qv_conv3x3_dw_slots). The TPU
// kernel carried the sums across its sequential grid; Hopper's blocks run
// in parallel and in no order, and float atomics would make dw differ from
// run to run. So this first pass writes one partial sum per chunk into
// scratch the wrapper allocates, and qv_conv3x3_reduce_kernel adds the
// partials in chunk order: the same bits in every run, so a fine-tune
// replays. db is the column sum of ct, taken in pixel order by the blocks
// of tap row 0.
//
// The bf16 trunk (compute_dtype="bfloat16"; the TPU kernel in the
// activations' dtype, float32 sums, pallas_conv.py:105-113, 280-281): x, w,
// b, ct, y and dx are bf16, every product a bf16 wgmma with float32 sums,
// and each output rounded to bf16 once: y after its float32 bias, dx from
// its sums, dw and db after the fixed-order reduction of float32 partials
// (qv_conv3x3_reduce_kernel; no atomics), so a fine-tune replays bit for
// bit. Bound at the fine-tune fold (chip_smoke.py::conv_bound_bf16): bytes
// for the forward (45.6 MB of bf16 at 3.35 TB/s, 0.0136 ms; the products
// 0.0124 ms at 989 TFLOP/s), operations for the backward (2.46e10 FLOP,
// 0.0251 ms). Design:
// * Staging: bf16 stays bf16, in rows of 64 channels (128 bytes) under the
//   128-byte XOR swizzle (qv_swz), by cp.async into a ring of 1-4 slots
//   (as many as shared memory holds), zeros by the copies' source size.
//   At Ci = 60 a row is 120 bytes: a 2-D TMA tensor map refuses that
//   stride and ldmatrix cannot address rows at that pitch, so the copies
//   are 8 bytes (16 where Ci % 8 == 0; plain loads where Ci % 4 != 0).
// * Forward and dx: persistent blocks of three warpgroups (192 pixels a
//   tile), one an SM. The weight image (qv_conv3x3_wimg_bf16_kernel: 9
//   taps of 64 x 64 bf16, K-major, swizzled, zero past Ci and Co; 73,728
//   bytes) is copied into shared memory once and stays while the block
//   walks its tiles (Ci or Co above 64: chunks of 64, reloaded as a step
//   needs them). A tap: ldmatrix.x4 at the tap's row offset, the pixels'
//   tap masks applied to A in registers (so a tile crosses any number of
//   planes), four wgmma.m64n64k16 (A registers, B the weights by
//   descriptor) into sums carried across all taps and channels. The
//   outputs go through a shared tile and leave by one bulk copy.
// * dw: dW_t = sum_p mask_t(p) X[p + off_t]^T ct[p] (M = Ci, N = Co,
//   K = pixels). A block of three warpgroups, one a tap row, stages x and
//   ct once for all nine taps (a block a tap row reads them three times);
//   A = X^T by ldmatrix.trans, its pixels' masks on its K slots; B = the ct
//   tile, MN-major, by descriptor; sums in the wgmma accumulators (no
//   fresh fragments); tiles of 256 pixels where two stages fit, else 128.
//   Warpgroup 0 sums db in pixel order.
// What holds it back (tools/bench_conv3x3.py on an H100 with edited copies
// of this file; PERF.md): with N only the 60 output channels, A from
// ldmatrix and B from shared memory take about the bytes the shared-memory
// pipe gives per m64n64k16 product, so the products alone ran at ~45% of
// the tensor peak, and the staging's copies, the tap masks and the
// epilogue did not overlap them (removing the staging saved ~12 us of the
// forward's ~55, ~24 of dw's ~89). Bulk copies of the 120-byte rows with
// an mbarrier, re-laid out by the threads, measured slower (64 against
// 55 us) and are not used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_math.cuh"

#define QV_CONV_THREADS 256  // forward / dx: 8 warps of 32 x 32 sums
#define QV_DW_THREADS 128    // dw: 4 warps of 16 input channels
#define QV_CONV_TP 128    // pixels of a forward / dx / dw tile
#define QV_CONV_KC 64     // channels staged at a time
#define QV_CONV_STRIDE 72 // shared-memory words a staged row (64 + 8)
#define QV_CONV_NT 64     // output channels of a forward / dx block
#define QV_KGROUP 4       // k-steps summed in a fresh fragment (forward, dx)

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

// Stage channels c0 .. c0 + nch - 1 (nch 32 or 64) of global rows q(r) =
// q0 + (r / seg) * step + r % seg, r in [0, rows), as floats s[r * STRIDE +
// c]; zeros outside rows [0, nq) and channels [0, cin). vec: cin % 4 == 0
// and x aligned to 4 elements.
__device__ __forceinline__ void qv_stage_rows(
    const float* __restrict__ x, float* s, long long q0, int rows, int seg,
    long long step, long long nq, int cin, int c0, int nch, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (nch / 4); e += blockDim.x) {
      int r = e / (nch / 4), c = 4 * (e % (nch / 4));
      long long q = q0 + (long long)(r / seg) * step + r % seg;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q >= 0 && q < nq && c0 + c < cin)
        v = __ldg(reinterpret_cast<const float4*>(x + q * cin + c0 + c));
      *reinterpret_cast<float4*>(s + r * QV_CONV_STRIDE + c) = v;
    }
  } else {
    for (int e = threadIdx.x; e < rows * nch; e += blockDim.x) {
      int r = e / nch, c = e % nch;
      long long q = q0 + (long long)(r / seg) * step + r % seg;
      float v = 0.0f;
      if (q >= 0 && q < nq && c0 + c < cin) v = x[q * cin + c0 + c];
      s[r * QV_CONV_STRIDE + c] = v;
    }
  }
}

// The weights of out = conv(in, W) as 3xTF32 B fragments: wf[tap][ks][nt]
// [lane] = (b0 hi, b1 hi, b0 lo, b1 lo) of k-step ks (input channels
// 8 ks + 2 (lane % 4) and + 1) and output channel nt * 8 + lane / 4;
// W(tap, c, o) = w[tap, c, o] (forward) or w[8 - tap, o, c] (dx, w the
// forward's (3, 3, cout, cin) weight); zeros past cin and cout.
__global__ void qv_conv3x3_wsplit_kernel(const float* __restrict__ w,
                                         float4* __restrict__ wf, int cin,
                                         int cout, int nks, int ntn,
                                         int flip) {
  long long total = 9LL * nks * ntn * 32;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    int lane = (int)(e % 32);
    long long rest = e / 32;
    int nt = (int)(rest % ntn);
    rest /= ntn;
    int ks = (int)(rest % nks);
    int tap = (int)(rest / nks);
    int o = nt * 8 + lane / 4;
    float v[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int c = 8 * ks + 2 * (lane % 4) + j;
      v[j] = 0.0f;
      if (c < cin && o < cout)
        v[j] = flip ? w[((long long)(8 - tap) * cout + o) * cin + c]
                    : w[((long long)tap * cin + c) * cout + o];
    }
    uint32_t h0, l0, h1, l1;
    qv_split(v[0], h0, l0);
    qv_split(v[1], h1, l1);
    wf[e] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                        __uint_as_float(l0), __uint_as_float(l1));
  }
}

// Rows of the staged input: the whole strip p0 - W - 1 .. p0 + TP + W when
// it is no longer than three tap rows of TP + 2, else those three rows.
__device__ __host__ __forceinline__ bool qv_whole_strip(int wd) {
  return QV_CONV_TP + 2 * wd + 2 <= 3 * (QV_CONV_TP + 2);
}

// out[p, o] = sum_{tap, c} in[p + off(tap), c] * W(tap, c, o) (+ b[o]),
// W given as wsplit's fragments.
__device__ __forceinline__ void qv_conv3x3_mma_body(
    const float* __restrict__ x, const float4* __restrict__ wf,
    const float* __restrict__ b, float* __restrict__ y, long long np, int h,
    int wd, int cin, int cout, bool vec) {
  extern __shared__ float4 qv_conv_smem[];
  float* xs = reinterpret_cast<float*>(qv_conv_smem);
  const bool whole = qv_whole_strip(wd);
  const int seg = whole ? QV_CONV_TP + 2 * wd + 2 : QV_CONV_TP + 2;
  const int rows = whole ? seg : 3 * seg;
  const long long p0 = (long long)blockIdx.x * QV_CONV_TP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int nks = (cin + 7) / 8, ntn = gridDim.y * (QV_CONV_NT / 8);
  const int nt0 = blockIdx.y * (QV_CONV_NT / 8) + wn * 4;

  // the masks of the thread's 4 pixel rows: i = wm * 32 + m * 16 + g + 8 hh
  int mask[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      mask[m][hh] = qv_tap_mask(p0 + wm * 32 + m * 16 + g + 8 * hh, np, h, wd);
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][n][k] = 0.0f;

  for (int c0 = 0; c0 < cin; c0 += QV_CONV_KC) {
    __syncthreads();  // the previous chunk's reads are done
    qv_stage_rows(x, xs, p0 - wd - 1, rows, seg, whole ? 0 : wd, np, cin, c0,
                  QV_CONV_KC, vec);
    __syncthreads();
    const int ks_n = (min(QV_CONV_KC, cin - c0) + 7) / 8;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* base = xs + ((whole ? dy * wd : dy * seg) + dx +
                                wm * 32 + g) * QV_CONV_STRIDE + 2 * t;
      const float4* wt = wf + ((long long)tap * nks + c0 / 8) * ntn * 32 +
                         nt0 * 32 + lane;
#pragma unroll 1
      for (int ks0 = 0; ks0 < ks_n; ks0 += QV_KGROUP) {
        float d[2][4][4];
#pragma unroll
        for (int kk = 0; kk < QV_KGROUP; ++kk) {
          const int ks = ks0 + kk;
          if (kk > 0 && ks >= ks_n) break;
          uint32_t bhi[4][2], blo[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float4 q = __ldg(wt + ((long long)ks * ntn + n) * 32);
            bhi[n][0] = __float_as_uint(q.x);
            bhi[n][1] = __float_as_uint(q.y);
            blo[n][0] = __float_as_uint(q.z);
            blo[n][1] = __float_as_uint(q.w);
          }
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            // a0, a2: row g, channels 2t, 2t + 1; a1, a3: row g + 8
            float2 r0 = *reinterpret_cast<const float2*>(
                base + (m * 16) * QV_CONV_STRIDE + 8 * ks);
            float2 r1 = *reinterpret_cast<const float2*>(
                base + (m * 16 + 8) * QV_CONV_STRIDE + 8 * ks);
            const bool on0 = (mask[m][0] >> tap) & 1;
            const bool on1 = (mask[m][1] >> tap) & 1;
            uint32_t ahi[4], alo[4];
            qv_split(on0 ? r0.x : 0.0f, ahi[0], alo[0]);
            qv_split(on1 ? r1.x : 0.0f, ahi[1], alo[1]);
            qv_split(on0 ? r0.y : 0.0f, ahi[2], alo[2]);
            qv_split(on1 ? r1.y : 0.0f, ahi[3], alo[3]);
#pragma unroll
            for (int n = 0; n < 4; ++n)
              qv_mma3(d[m][n], ahi, alo, bhi[n], blo[n], kk == 0);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) qv_add4(acc[m][n], d[m][n]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      long long p = p0 + wm * 32 + m * 16 + g + 8 * hh;
      if (p >= np) continue;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          int o = (nt0 + n) * 8 + 2 * t + j;
          if (o < cout) {
            float v = acc[m][n][2 * hh + j];
            y[p * cout + o] = b ? v + b[o] : v;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(QV_CONV_THREADS)
    qv_conv3x3_fwd_kernel(const float* __restrict__ x,
                          const float4* __restrict__ wf,
                          const float* __restrict__ b, float* __restrict__ y,
                          long long np, int h, int wd, int cin, int cout,
                          int vec) {
  qv_conv3x3_mma_body(x, wf, b, y, np, h, wd, cin, cout, vec != 0);
}

__global__ void __launch_bounds__(QV_CONV_THREADS)
    qv_conv3x3_dx_kernel(const float* __restrict__ ct,
                         const float4* __restrict__ wf, float* __restrict__ dx,
                         long long np, int h, int wd, int co_f, int ci_f,
                         int vec) {
  qv_conv3x3_mma_body(ct, wf, nullptr, dx, np, h, wd, co_f, ci_f, vec != 0);
}

// First pass of dw/db: block (bx, by, bz) sums pixels [bx * chunk, +chunk)
// for input channels by * 64 .. +63, output channels (bz / 3) * 64 .. +63
// and the taps of row bz % 3 into part[bx, :], laid out as dw (3, 3, cin,
// cout) then db (cout); the blocks of tap row 0 and by == 0 also sum db.
__global__ void __launch_bounds__(QV_DW_THREADS)
    qv_conv3x3_dw_kernel(const float* __restrict__ x,
                         const float* __restrict__ ct,
                         float* __restrict__ part, long long np, int h,
                         int wd, int cin, int cout, long long chunk, int vx,
                         int vc) {
  extern __shared__ float4 qv_conv_smem[];
  float* cs = reinterpret_cast<float*>(qv_conv_smem);  // [TP][STRIDE]
  float* xs = cs + QV_CONV_TP * QV_CONV_STRIDE;        // [TP + 2][STRIDE]
  int* ms = reinterpret_cast<int*>(xs + (QV_CONV_TP + 2) * QV_CONV_STRIDE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int dy = blockIdx.z % 3;
  const int ci0 = blockIdx.y * QV_CONV_KC, co0 = (blockIdx.z / 3) * QV_CONV_NT;
  const bool with_db = dy == 0 && blockIdx.y == 0 && threadIdx.x < QV_CONV_NT;
  const long long pbeg = (long long)blockIdx.x * chunk;
  const long long pend = pbeg + chunk < np ? pbeg + chunk : np;

  float acc[3][8][4];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[d][n][k] = 0.0f;
  float db = 0.0f;

  for (long long p0 = pbeg; p0 < pend; p0 += QV_CONV_TP) {
    __syncthreads();
    qv_stage_rows(ct, cs, p0, QV_CONV_TP, QV_CONV_TP, 0, pend, cout, co0,
                  QV_CONV_NT, vc != 0);
    qv_stage_rows(x, xs, p0 + (long long)(dy - 1) * wd - 1, QV_CONV_TP + 2,
                  QV_CONV_TP + 2, 0, np, cin, ci0, QV_CONV_KC, vx != 0);
    for (int e = threadIdx.x; e < QV_CONV_TP; e += QV_DW_THREADS)
      ms[e] = p0 + e < pend ? qv_tap_mask(p0 + e, np, h, wd) >> (3 * dy) : 0;
    __syncthreads();
    if (with_db)
      for (int r = 0; r < QV_CONV_TP; ++r)
        db += cs[r * QV_CONV_STRIDE + threadIdx.x];
    const int ks_n =
        (int)((pend - p0 < QV_CONV_TP ? pend - p0 : QV_CONV_TP) + 7) / 8;
#pragma unroll 1
    for (int ks = 0; ks < ks_n; ++ks) {
      // B = ct (K = pixels x N = output channels): b0 pixel t, b1 t + 4
      uint32_t bhi[8][2], blo[8][2];
      const float* crow = cs + (8 * ks + t) * QV_CONV_STRIDE + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        qv_split(crow[n * 8], bhi[n][0], blo[n][0]);
        qv_split(crow[4 * QV_CONV_STRIDE + n * 8], bhi[n][1], blo[n][1]);
      }
      const int m0 = ms[8 * ks + t], m1 = ms[8 * ks + t + 4];
      // A = X^T (M = input channels x K = pixels): a0 (channel g, pixel t),
      // a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      const float* xrow = xs + (8 * ks + t) * QV_CONV_STRIDE + warp * 16 + g;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float* xr = xrow + d * QV_CONV_STRIDE;
        const bool on0 = (m0 >> d) & 1, on1 = (m1 >> d) & 1;
        uint32_t ahi[4], alo[4];
        qv_split(on0 ? xr[0] : 0.0f, ahi[0], alo[0]);
        qv_split(on0 ? xr[8] : 0.0f, ahi[1], alo[1]);
        qv_split(on1 ? xr[4 * QV_CONV_STRIDE] : 0.0f, ahi[2], alo[2]);
        qv_split(on1 ? xr[4 * QV_CONV_STRIDE + 8] : 0.0f, ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float f[4];
          qv_mma3(f, ahi, alo, bhi[n], blo[n], true);
          qv_add4(acc[d][n], f);
        }
      }
    }
  }
  const long long len_part = 9LL * cin * cout + cout;
  float* out = part + (long long)blockIdx.x * len_part;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const long long tap = 3 * dy + d;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int ci = ci0 + warp * 16 + g + 8 * (k >> 1);
        int o = co0 + n * 8 + 2 * t + (k & 1);
        if (ci < cin && o < cout)
          out[(tap * cin + ci) * cout + o] = acc[d][n][k];
      }
    }
  }
  if (with_db && co0 + (int)threadIdx.x < cout)
    out[9LL * cin * cout + co0 + threadIdx.x] = db;
}

// ---- the bf16 trunk: wgmma, asynchronous staging, resident weights ---------

#define QV_H16_WGS 3                  // forward / dx: warpgroups a block
#define QV_H16_TP (64 * QV_H16_WGS)   // pixels of a forward / dx tile
#define QV_H16_THREADS (128 * QV_H16_WGS)
#define QV_H16_WTAP 8192              // bytes of a tap's 64 x 64 weight tile
#define QV_H16_WIMG (9 * QV_H16_WTAP) // bytes of one (N, K) chunk's image
#define QV_H16_DW_THREADS 384         // dw: a warpgroup for each tap row

static __host__ __device__ __forceinline__ int qv_align1k(int n) {
  return (n + 1023) & ~1023;
}

// The staged rows of a tile of tp pixels: the whole strip p0 - W - 1 ..
// p0 + tp + W when it is no longer than three tap rows of tp + 2, else
// those three segments (segment dy from p0 + (dy - 1) W - 1).
static __host__ __device__ __forceinline__ bool qv_h16_whole(int wd, int tp) {
  return tp + 2 * wd + 2 <= 3 * (tp + 2);
}
static __host__ __device__ __forceinline__ int qv_h16_rows(int wd, int tp) {
  return qv_h16_whole(wd, tp) ? tp + 2 * wd + 2 : 3 * (tp + 2);
}

// Byte offset of 16-byte chunk c (channels 8c .. 8c + 7) of staged row r:
// a row holds 64 bf16 channels, 128 bytes, chunk c at c ^ (r % 8). This is
// the 128-byte swizzle of wgmma's descriptors (layout 1, 8-row atoms on
// 1024-byte boundaries), and it puts the eight rows an ldmatrix matrix
// reads on eight distinct bank groups whatever the tap's row offset.
static __device__ __forceinline__ uint32_t qv_swz(int r, int c) {
  return (uint32_t)r * 128u + ((uint32_t)(c ^ (r & 7)) << 4);
}

static __device__ __forceinline__ uint32_t qv_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The first 1024-byte boundary of the dynamic shared memory.
static __device__ __forceinline__ uint8_t* qv_smem_1k(uint8_t* raw) {
  return raw + ((1024u - (qv_smem_addr(raw) & 1023u)) & 1023u);
}

// Asynchronous copies of 16 or 8 bytes; on == false fills zeros.
static __device__ __forceinline__ void qv_cp16(uint32_t dst, const void* src,
                                               bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}
static __device__ __forceinline__ void qv_cp8(uint32_t dst, const void* src,
                                              bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 8 : 0)
               : "memory");
}
static __device__ __forceinline__ void qv_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void qv_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most n (0 .. 3) of this thread's newest groups are pending.
static __device__ __forceinline__ void qv_cp_wait_n(int n) {
  if (n >= 3)
    qv_cp_wait<3>();
  else if (n == 2)
    qv_cp_wait<2>();
  else if (n == 1)
    qv_cp_wait<1>();
  else
    qv_cp_wait<0>();
}
// This thread's shared-memory writes made visible to wgmma's operand reads
// (the async proxy).
static __device__ __forceinline__ void qv_fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// One bulk copy of bytes (a multiple of 16, both ends 16-byte aligned)
// from shared to global memory by the copy engine, as its own group; the
// waits: the shared source read (.read), or the copies done.
static __device__ __forceinline__ void qv_bulk_store(void* dst,
                                                     const void* src,
                                                     uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(qv_smem_addr(src)), "r"(bytes)
      : "memory");
}
static __device__ __forceinline__ void qv_bulk_store_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
static __device__ __forceinline__ void qv_bulk_store_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Stage channels c0 .. c0 + 63 of global rows q(r) = q0 + (r / seg) * step
// + r % seg, r in [0, rows), of the (nq, cin) bf16 matrix x as swizzled
// rows at s; zeros outside rows [0, nq) and channels [0, cin), by the
// copies' source size. mode 2: 16-byte cp.async (cin % 8 == 0, x 16-byte
// aligned); 1: 8-byte cp.async (cin % 4 == 0, x 8-byte aligned); 0: plain
// loads and stores, done when the thread leaves.
static __device__ __forceinline__ void qv_stage_bf16(
    const __nv_bfloat16* __restrict__ x, uint8_t* s, long long q0, int rows,
    int seg, long long step, long long nq, int cin, int c0, int mode) {
  const uint32_t sa = qv_smem_addr(s);
  if (mode == 0) {
    for (int e = threadIdx.x; e < rows * 64; e += blockDim.x) {
      const int r = e >> 6, c = e & 63;
      const long long q = q0 + (long long)(r / seg) * step + r % seg;
      const bool on = q >= 0 && q < nq && c0 + c < cin;
      *reinterpret_cast<__nv_bfloat16*>(s + qv_swz(r, c >> 3) + 2 * (c & 7)) =
          on ? x[q * cin + c0 + c] : __ushort_as_bfloat16(0);
    }
    return;
  }
  // a thread copies piece c (8 or 16 bytes) of rows r0, r0 + dr, ...; the
  // segment of row r is tracked, not divided for (dr < seg)
  const int per_row = mode == 2 ? 8 : 16;
  const int c = threadIdx.x % per_row, dr = blockDim.x / per_row;
  const int ch = c0 + (mode == 2 ? 8 : 4) * c;
  const bool c_on = ch < cin;
  const uint32_t col = mode == 2 ? (uint32_t)c << 4 : (uint32_t)c << 3;
  int r = threadIdx.x / per_row, sg = r / seg, rr = r % seg;
#pragma unroll 1
  for (; r < rows; r += dr) {
    const long long q = q0 + sg * step + rr;
    const bool on = c_on && q >= 0 && q < nq;
    const __nv_bfloat16* src = on ? x + q * cin + ch : x;
    // chunk (col >> 4) of row r, and the 8-byte half for mode 1
    const uint32_t dst = sa + (uint32_t)r * 128u +
                         ((((col >> 4) ^ (uint32_t)(r & 7)) << 4) | (col & 8));
    if (mode == 2)
      qv_cp16(dst, src, on);
    else
      qv_cp8(dst, src, on);
    rr += dr;
    if (rr >= seg) {
      rr -= seg;
      ++sg;
    }
  }
}

// The tap masks (qv_tap_mask) of the pixels p0 .. p0 + n - 1 into m[0 ..
// n - 1], 0 at or past pend, in 32-bit arithmetic from p0's column and row.
static __device__ __forceinline__ void qv_tile_masks(int* m, long long p0,
                                                     int n, long long pend,
                                                     int h, int wd) {
  const int col0 = (int)(p0 % wd), row0 = (int)((p0 / wd) % h);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int v = 0;
    if (p0 + e < pend) {
      const int cq = (col0 + e) / wd, c = col0 + e - cq * wd;
      const int r = (row0 + cq) % h;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const int rr = r + dy - 1, cc = c + dx - 1;
          if (rr >= 0 && rr < h && cc >= 0 && cc < wd) v |= 1 << (dy * 3 + dx);
        }
    }
    m[e] = v;
  }
}

// One (N, K) chunk's weight image (QV_H16_WIMG bytes) into shared memory.
static __device__ __forceinline__ void qv_stage_wimg(
    const uint8_t* __restrict__ src, uint32_t dst) {
  for (int e = threadIdx.x; e < QV_H16_WIMG / 16; e += blockDim.x)
    qv_cp16(dst + 16 * e, src + 16 * e, true);
}

// ldmatrix of four 8 x 8 bf16 matrices, lanes 8j .. 8j + 7 giving the row
// addresses of matrix j; .trans hands each lane the transposed fragment.
static __device__ __forceinline__ void qv_ldsm4(uint32_t* a, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}
static __device__ __forceinline__ void qv_ldsm4_t(uint32_t* a, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

static __device__ __forceinline__ void qv_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void qv_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
static __device__ __forceinline__ void qv_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving a use of the sums across the points where
// the tensor cores own them.
static __device__ __forceinline__ void qv_fence_sums(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a 128-byte-swizzled operand at shared address a: start
// address, leading and stride byte offsets (16-byte units), layout 1.
static __device__ __forceinline__ uint64_t qv_desc(uint32_t a, uint32_t lbo,
                                                   uint32_t sbo) {
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}

// d (64 x 64 float32 sums) += a * b: a (64 x 16 bf16) in registers, warp w
// of the warpgroup holding rows 16 w .. 16 w + 15 as mma.m16n8k16's A
// fragment; b (16 x 64 bf16) in shared memory by descriptor, K-major (TB
// 0) or MN-major (TB 1). Thread (warp w, lane 4 g + t) holds d[4 j + 2 hh
// + i] = D(16 w + g + 8 hh, 8 j + 2 t + i).
template <int TB>
static __device__ __forceinline__ void qv_wgmma(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TB));
}

// The weight image of out = conv(in, W), chunk (nc, kc) of 64 output and
// 64 input channels at img + ((nc * nk + kc) * 9 + tap) * 8192 bytes: a
// K-major tile, row n (output channel 64 nc + n) holding input channels
// 64 kc .. + 63 as 128 swizzled bytes (qv_swz); W as
// qv_conv3x3_wsplit_kernel's; zeros past cin and cout.
__global__ void qv_conv3x3_wimg_bf16_kernel(
    const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ img,
    int cin, int cout, int nk, int nn, int flip) {
  const long long total = (long long)nn * nk * 9 * 4096;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int in = (int)(e & 4095);
    const long long rest = e >> 12;
    const int tap = (int)(rest % 9);
    const int kc = (int)((rest / 9) % nk), nc = (int)(rest / 9 / nk);
    const int n = in >> 6, k = ((((in >> 3) & 7) ^ (n & 7)) << 3) | (in & 7);
    const int c = 64 * kc + k, o = 64 * nc + n;
    __nv_bfloat16 v = __ushort_as_bfloat16(0);
    if (c < cin && o < cout)
      v = flip ? w[((long long)(8 - tap) * cout + o) * cin + c]
               : w[((long long)tap * cin + c) * cout + o];
    img[e] = v;
  }
}

// A block's step: its item (a tile of pixels, a chunk of 64 output
// channels) and the chunk of 64 input channels it sums. The block's items
// are blockIdx.x, + gridDim.x, ..., item = nc * ntiles + tile; a step
// cursor moves over them without a division.
struct QvStep {
  long long tile;
  int nc, kc;
};
static __device__ __forceinline__ void qv_next(QvStep& st, int nk,
                                               long long ntiles) {
  if (++st.kc < nk) return;
  st.kc = 0;
  st.tile += gridDim.x;
  while (st.tile >= ntiles) {
    st.tile -= ntiles;
    ++st.nc;
  }
}

// out[p, o] = bf16(sum_{tap, c} in[p + off(tap), c] * W(tap, c, o) (+ b[o])),
// W given as the weight image. Persistent blocks of QV_H16_WGS warpgroups
// walk their items; warpgroup k holds pixels 64 k .. 64 k + 63 of the
// tile, 32 sums a thread. A ring of nslots slots, each a step's strip and
// its pixels' tap masks, keeps nslots - 1 steps loading while one is
// multiplied. Where a step needs other weights than the resident chunk
// (Ci or Co above 64), the block waits for every copy and loads them.
static __device__ __forceinline__ void qv_conv3x3_wg_body(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ wimg,
    const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ y,
    long long np, int h, int wd, int cin, int cout, int mode, int nslots) {
  extern __shared__ uint8_t qv_h16_raw[];
  uint8_t* sw = qv_smem_1k(qv_h16_raw);  // the weight image
  uint8_t* obuf = sw + QV_H16_WIMG;      // the output tile, bf16 rows
  uint8_t* ring = obuf + QV_H16_TP * 128;
  const bool whole = qv_h16_whole(wd, QV_H16_TP);
  const int rows = qv_h16_rows(wd, QV_H16_TP);
  const int seg = whole ? rows : QV_H16_TP + 2;
  const int sbytes = qv_align1k(rows * 128), slot = sbytes + 1024;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nk = (cin + 63) / 64, nn = (cout + 63) / 64;
  const long long ntiles = (np + QV_H16_TP - 1) / QV_H16_TP;
  const long long items = ntiles * nn;
  if ((long long)blockIdx.x >= items) return;
  const long long nsteps =
      ((items - 1 - blockIdx.x) / gridDim.x + 1) * (long long)nk;
  // the row (of the warp's 16 pixels) and chunk half of this lane's
  // ldmatrix address: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15)
  const int lrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lhi = lane >> 4;
  const uint32_t wa = qv_smem_addr(sw);

  auto stage = [&](const QvStep& st, long long i) {
    uint8_t* sl = ring + (int)(i % nslots) * slot;
    const long long p0 = st.tile * QV_H16_TP;
    qv_stage_bf16(x, sl, p0 - wd - 1, rows, seg, whole ? 0 : wd, np, cin,
                  64 * st.kc, mode);
    if (st.kc == 0)
      qv_tile_masks(reinterpret_cast<int*>(sl + sbytes), p0, QV_H16_TP, np,
                    h, wd);
  };

  QvStep cur = {blockIdx.x % ntiles, (int)(blockIdx.x / ntiles), 0};
  QvStep ld = cur;  // the step whose strip loads next
  qv_stage_wimg(wimg + (size_t)(cur.nc * nk + cur.kc) * QV_H16_WIMG, wa);
  for (int i = 0; i < nslots - 1; ++i) {
    if (i < nsteps) {
      stage(ld, i);
      qv_next(ld, nk, ntiles);
    }
    qv_cp_commit();
  }
  int m0 = 0, m1 = 0;
  float acc[32], bias[16];
#pragma unroll 1
  for (long long s = 0; s < nsteps; ++s) {
    if (s + nslots - 1 < nsteps) {  // loads while s multiplies
      stage(ld, s + nslots - 1);
      qv_next(ld, nk, ntiles);
    }
    qv_cp_commit();
    qv_cp_wait_n(nslots - 1);  // step s's strip (and weights) have landed
    qv_fence_async_smem();
    if (threadIdx.x == 0) qv_bulk_store_read();  // the output tile is free
    __syncthreads();
    const uint8_t* sl = ring + (int)(s % nslots) * slot;
    const uint32_t xa = qv_smem_addr(sl);
    if (cur.kc == 0) {
      const int* ms = reinterpret_cast<const int*>(sl + sbytes);
      m0 = ms[warp * 16 + g];
      m1 = ms[warp * 16 + g + 8];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {  // the item's bias, 0 for dx
        const int o = 64 * cur.nc + 8 * (i >> 1) + 2 * t + (i & 1);
        bias[i] = b && o < cout ? __bfloat162float(b[o]) : 0.0f;
      }
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const int r = lrow + (whole ? dy * wd : dy * seg) + dx;
      uint32_t a[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        qv_ldsm4(a[ks], xa + qv_swz(r, 2 * ks + lhi));
        if (!((m0 >> tap) & 1)) a[ks][0] = a[ks][2] = 0u;  // pixel g
        if (!((m1 >> tap) & 1)) a[ks][1] = a[ks][3] = 0u;  // pixel g + 8
      }
      qv_fence_sums(acc);
      qv_wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        qv_wgmma<0>(acc, a[ks],
                    qv_desc(wa + tap * QV_H16_WTAP + 32 * ks, 1, 64));
      qv_wgmma_commit();
      qv_wgmma_wait<1>();  // the previous tap's products are done
      qv_fence_sums(acc);
    }
    qv_wgmma_wait<0>();
    qv_fence_sums(acc);
    if (cur.kc == nk - 1) {
      // The tile's outputs, rounded to bf16, go into the output tile as
      // rows of the item's ow channels, then out: by one bulk copy where
      // those rows are one range of y, else by the threads.
      const long long p0 = cur.tile * QV_H16_TP;
      const int o0 = 64 * cur.nc, ow = min(64, cout - o0);
      const int nv = (int)min((long long)QV_H16_TP, np - p0);
      __nv_bfloat16* ot = reinterpret_cast<__nv_bfloat16*>(obuf);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp * 16 + g + 8 * hh;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int o = 8 * j + 2 * t;
          const float v0 = acc[4 * j + 2 * hh] + bias[2 * j];
          const float v1 = acc[4 * j + 2 * hh + 1] + bias[2 * j + 1];
          if ((ow & 1) == 0 && o + 1 < ow) {
            *reinterpret_cast<__nv_bfloat162*>(ot + r * ow + o) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (o < ow) ot[r * ow + o] = __float2bfloat16_rn(v0);
            if (o + 1 < ow) ot[r * ow + o + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
      qv_fence_async_smem();
      __syncthreads();  // the tile written; every warp's strip reads done
      const int bytes = nv * cout * 2;
      if (ow == cout && bytes % 16 == 0) {  // 16-byte aligned (p0 * cout)
        if (threadIdx.x == 0) qv_bulk_store(y + p0 * cout, obuf, bytes);
      } else {
        for (int e = threadIdx.x; e < nv * ow; e += blockDim.x)
          y[(p0 + e / ow) * cout + o0 + e % ow] = ot[e];
      }
    } else {
      __syncthreads();  // every warp's strip reads done
    }
    const int wnc = cur.nc, wkc = cur.kc;
    qv_next(cur, nk, ntiles);
    if (s + 1 < nsteps && (cur.nc != wnc || cur.kc != wkc)) {
      qv_stage_wimg(wimg + (size_t)(cur.nc * nk + cur.kc) * QV_H16_WIMG, wa);
      qv_cp_commit();
      qv_cp_wait<0>();
    }
  }
  if (threadIdx.x == 0) qv_bulk_store_done();
}

__global__ void __launch_bounds__(QV_H16_THREADS, 1)
    qv_conv3x3_fwd_wg_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                  const uint8_t* __restrict__ wimg,
                                  const __nv_bfloat16* __restrict__ b,
                                  __nv_bfloat16* __restrict__ y, long long np,
                                  int h, int wd, int cin, int cout, int mode,
                                  int nslots) {
  qv_conv3x3_wg_body(x, wimg, b, y, np, h, wd, cin, cout, mode, nslots);
}

__global__ void __launch_bounds__(QV_H16_THREADS, 1)
    qv_conv3x3_dx_wg_bf16_kernel(const __nv_bfloat16* __restrict__ ct,
                                 const uint8_t* __restrict__ wimg,
                                 const __nv_bfloat16* __restrict__ b,
                                 __nv_bfloat16* __restrict__ dx, long long np,
                                 int h, int wd, int co_f, int ci_f, int mode,
                                 int nslots) {
  qv_conv3x3_wg_body(ct, wimg, nullptr, dx, np, h, wd, co_f, ci_f, mode,
                     nslots);
}

// First pass of dw/db: block (bx, by, bz) sums pixels [bx * chunk, +chunk)
// for input channels by * 64 .. +63 and output channels bz * 64 .. +63 into
// part[bx, :], laid out as dw (3, 3, cin, cout) then db (cout). Warpgroup
// dy holds the taps (dy, 0..2): 3 x 32 sums a thread, M = input channels
// (warp w: 16 w .. 16 w + 15), N = output channels, K = 16 pixels a
// product. A = X^T by ldmatrix.trans of the staged strip at the tap's row
// offset, its pixels (K slots) masked in registers; B = the staged ct
// tile, MN-major. The threads of by == 0, warpgroup 0, sum db in pixel
// order. A ring of nslots stages (ct tile, strip, masks) keeps nslots - 1
// tiles loading while one is multiplied.
__global__ void __launch_bounds__(QV_H16_DW_THREADS, 1)
    qv_conv3x3_dw_wg_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ ct,
                                 float* __restrict__ part, long long np,
                                 int h, int wd, int cin, int cout,
                                 long long chunk, int xmode, int cmode,
                                 int tp, int nslots) {
  extern __shared__ uint8_t qv_h16_raw[];
  uint8_t* sm = qv_smem_1k(qv_h16_raw);
  const bool whole = qv_h16_whole(wd, tp);
  const int rows = qv_h16_rows(wd, tp), seg = whole ? rows : tp + 2;
  const int ctb = tp * 128;  // bytes of the staged ct tile
  const int xbytes = qv_align1k(rows * 128);
  // a stage: the ct tile, the strip, the tile's tap masks
  const int stage_bytes = ctb + xbytes + 1024;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int dy = warp >> 2, wq = warp & 3;
  const int ci0 = blockIdx.y * 64, co0 = blockIdx.z * 64;
  const bool with_db = blockIdx.y == 0 && threadIdx.x < 64;
  const long long pbeg = (long long)blockIdx.x * chunk;
  const long long pend = pbeg + chunk < np ? pbeg + chunk : np;
  const int ntile = (int)((pend - pbeg + tp - 1) / tp);
  // this lane's ldmatrix row (a pixel) and chunk: matrices (channels 0-7 |
  // 8-15 of the warp's 16) x (pixels 0-7 | 8-15)
  const int lpix = (lane & 7) + (lane >> 4) * 8;
  const int lch = 2 * wq + ((lane >> 3) & 1);
  const int roff = whole ? dy * wd : dy * seg;

  auto stage = [&](int i) {
    uint8_t* st = sm + (i % nslots) * stage_bytes;
    const long long p0 = pbeg + (long long)i * tp;
    qv_stage_bf16(ct, st, p0, tp, tp, 0, pend, cout, co0, cmode);
    qv_stage_bf16(x, st + ctb, p0 - wd - 1, rows, seg, whole ? 0 : wd, np,
                  cin, ci0, xmode);
    qv_tile_masks(reinterpret_cast<int*>(st + ctb + xbytes), p0, tp, pend,
                  h, wd);
  };

  float acc[3][32];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[d][i] = 0.0f;
  float db = 0.0f;

  for (int i = 0; i < nslots - 1; ++i) {
    if (i < ntile) stage(i);
    qv_cp_commit();
  }
#pragma unroll 1
  for (int i = 0; i < ntile; ++i) {
    if (i + nslots - 1 < ntile) stage(i + nslots - 1);
    qv_cp_commit();
    qv_cp_wait_n(nslots - 1);
    qv_fence_async_smem();
    __syncthreads();
    const uint8_t* st = sm + (i % nslots) * stage_bytes;
    const uint32_t ca = qv_smem_addr(st), xa = ca + ctb;
    const int* ms = reinterpret_cast<const int*>(st + ctb + xbytes);
#pragma unroll 2
    for (int ks = 0; ks < tp / 16; ++ks) {
      const int kp = 16 * ks;
      // this thread's K slots: pixels 2t, 2t + 1 (a0, a1) and 2t + 8,
      // 2t + 9 (a2, a3), each the low and high half of a register
      const int mk0 = ms[kp + 2 * t], mk1 = ms[kp + 2 * t + 1];
      const int mk8 = ms[kp + 2 * t + 8], mk9 = ms[kp + 2 * t + 9];
      uint32_t a[3][4];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int r = kp + lpix + roff + d;
        qv_ldsm4_t(a[d], xa + qv_swz(r, lch));
        const int bit = 3 * dy + d;
        const uint32_t lo = (((mk0 >> bit) & 1) ? 0x0000FFFFu : 0u) |
                            (((mk1 >> bit) & 1) ? 0xFFFF0000u : 0u);
        const uint32_t hi = (((mk8 >> bit) & 1) ? 0x0000FFFFu : 0u) |
                            (((mk9 >> bit) & 1) ? 0xFFFF0000u : 0u);
        a[d][0] &= lo;
        a[d][1] &= lo;
        a[d][2] &= hi;
        a[d][3] &= hi;
      }
#pragma unroll
      for (int d = 0; d < 3; ++d) qv_fence_sums(acc[d]);
      qv_wgmma_fence();
      const uint64_t desc = qv_desc(ca + 2048 * ks, 64, 64);
#pragma unroll
      for (int d = 0; d < 3; ++d) qv_wgmma<1>(acc[d], a[d], desc);
      qv_wgmma_commit();
      if (with_db) {
        const int c = threadIdx.x;
#pragma unroll
        for (int r = kp; r < kp + 16; ++r)
          db += __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(
              st + qv_swz(r, c >> 3) + 2 * (c & 7)));
      }
      qv_wgmma_wait<1>();
#pragma unroll
      for (int d = 0; d < 3; ++d) qv_fence_sums(acc[d]);
    }
    qv_wgmma_wait<0>();
#pragma unroll
    for (int d = 0; d < 3; ++d) qv_fence_sums(acc[d]);
    __syncthreads();  // the stage's reads are done
  }
  const long long len_part = 9LL * cin * cout + cout;
  float* out = part + (long long)blockIdx.x * len_part;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const long long tap = 3 * dy + d;
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const int ci = ci0 + 16 * wq + g + 8 * ((v >> 1) & 1);
      const int o = co0 + 8 * (v >> 2) + 2 * t + (v & 1);
      if (ci < cin && o < cout) out[(tap * cin + ci) * cout + o] = acc[d][v];
    }
  }
  if (with_db && co0 + (int)threadIdx.x < cout)
    out[9LL * cin * cout + co0 + threadIdx.x] = db;
}

__device__ __forceinline__ void qv_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void qv_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Second pass: out[i] = sum over chunks b, in order, of part[b, i] (rounded
// once to bf16 for the bf16 trunk).
template <class T>
__global__ void qv_conv3x3_reduce_kernel(const float* __restrict__ part,
                                         T* __restrict__ out, int nb,
                                         long long len) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < len; i += stride) {
    float s = 0.0f;
    for (int b = 0; b < nb; ++b) s += part[(long long)b * len + i];
    qv_store(out + i, s);
  }
}

static size_t qv_conv_smem_bytes(int wd) {
  int rows = qv_whole_strip(wd) ? QV_CONV_TP + 2 * wd + 2
                                : 3 * (QV_CONV_TP + 2);
  return sizeof(float) * (size_t)rows * QV_CONV_STRIDE;
}

static size_t qv_dw_smem_bytes() {
  return sizeof(float) * (2 * QV_CONV_TP + 2) * QV_CONV_STRIDE +
         sizeof(int) * QV_CONV_TP;
}

// Blocks of the dw pass the card runs at once: the wrapper sizes its pixel
// chunks so that the pass fills whole waves.
extern "C" int qv_conv3x3_dw_slots(int* slots) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qv_conv3x3_dw_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)qv_dw_smem_bytes());
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, qv_conv3x3_dw_kernel, QV_DW_THREADS, qv_dw_smem_bytes());
  if (err == cudaSuccess) *slots = sms * per_sm;
  return (int)err;
}

template <class T>
static bool qv_vec(const T* p, int c) {
  return c % 4 == 0 && ((uintptr_t)p & (4 * sizeof(T) - 1)) == 0;
}

// wf = the 3xTF32 fragments of w for in-channels cin, out-channels cout
// (wsplit's layout: 9 * ceil(cin / 8) * ceil(cout / 64) * 8 * 32 float4s,
// scratch the wrapper allocates).
static int qv_wsplit(const float* w, float* wf, int cin, int cout, int flip,
                     cudaStream_t stream) {
  int nks = (cin + 7) / 8, ntn = 8 * ((cout + QV_CONV_NT - 1) / QV_CONV_NT);
  long long total = 9LL * nks * ntn * 32;
  int blocks = (int)((total + 255) / 256);
  qv_conv3x3_wsplit_kernel<<<blocks, 256, 0, stream>>>(
      w, reinterpret_cast<float4*>(wf), cin, cout, nks, ntn, flip);
  return (int)cudaGetLastError();
}

// y = conv(x, w) + b; x (np pixels of h x wd planes, cin), w (3, 3, cin,
// cout), b (cout) or null; wf the fragment scratch for (cin, cout).
extern "C" int qv_conv3x3_fwd(const float* x, const float* w, const float* b,
                              float* wf, float* y, long long np, int h,
                              int wd, int cin, int cout, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = qv_wsplit(w, wf, cin, cout, 0, s);
  if (err != 0) return err;
  size_t smem = qv_conv_smem_bytes(wd);
  cudaError_t e = cudaFuncSetAttribute(
      qv_conv3x3_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((np + QV_CONV_TP - 1) / QV_CONV_TP),
            (unsigned)((cout + QV_CONV_NT - 1) / QV_CONV_NT));
  qv_conv3x3_fwd_kernel<<<grid, QV_CONV_THREADS, smem, s>>>(
      x, reinterpret_cast<const float4*>(wf), b, y, np, h, wd, cin, cout,
      qv_vec(x, cin));
  return (int)cudaGetLastError();
}

// dx of y = conv(x, w): ct (np, cout), w the forward's (3, 3, cin, cout),
// dx (np, cin); wf the fragment scratch for (cout, cin).
extern "C" int qv_conv3x3_dx(const float* ct, const float* w, float* wf,
                             float* dx, long long np, int h, int wd, int cin,
                             int cout, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = qv_wsplit(w, wf, cout, cin, 1, s);
  if (err != 0) return err;
  size_t smem = qv_conv_smem_bytes(wd);
  cudaError_t e = cudaFuncSetAttribute(
      qv_conv3x3_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((np + QV_CONV_TP - 1) / QV_CONV_TP),
            (unsigned)((cin + QV_CONV_NT - 1) / QV_CONV_NT));
  qv_conv3x3_dx_kernel<<<grid, QV_CONV_THREADS, smem, s>>>(
      ct, reinterpret_cast<const float4*>(wf), dx, np, h, wd, cout, cin,
      qv_vec(ct, cout));
  return (int)cudaGetLastError();
}

// dw (3, 3, cin, cout) and db (cout), written contiguously to out, from x
// (np, cin) and ct (np, cout): per-chunk partial sums of `chunk` pixels (a
// multiple of 128) into part (nb, 9 cin cout + cout), nb = ceil(np /
// chunk), then their sum in chunk order.
extern "C" int qv_conv3x3_dw(const float* x, const float* ct, float* part,
                             float* out, long long np, int h, int wd,
                             int cin, int cout, long long chunk, int nb,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  size_t smem = qv_dw_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      qv_conv3x3_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nb, (unsigned)((cin + QV_CONV_KC - 1) / QV_CONV_KC),
            (unsigned)(3 * ((cout + QV_CONV_NT - 1) / QV_CONV_NT)));
  qv_conv3x3_dw_kernel<<<grid, QV_DW_THREADS, smem, s>>>(
      x, ct, part, np, h, wd, cin, cout, chunk, qv_vec(x, cin),
      qv_vec(ct, cout));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  long long len = 9LL * cin * cout + cout;
  int blocks = len > 4096LL * 256 ? 4096 : (int)((len + 255) / 256);
  qv_conv3x3_reduce_kernel<float><<<blocks, 256, 0, s>>>(part, out, nb, len);
  return (int)cudaGetLastError();
}

// ---- the bf16 trunk's entries: the float32 entries' arguments, on bf16 x,
// w, b, ct, y, dx and out (dw then db); wf (the weight image) and part
// stay float32 words.

// The ring slots of a bf16 pass: as many as the card's 227 KB of shared
// memory a block hold beside the fixed part, 1 to 4 (one slot: each step
// waits for its own strip; a block that holds none fails its launch).
#define QV_H16_SMEM 232448  // shared memory a block may take (227 KB)

static int qv_h16_slots(size_t fixed, size_t slot) {
  const size_t room = (QV_H16_SMEM - fixed) / slot;
  return room < 1 ? 1 : room > 4 ? 4 : (int)room;
}
static size_t qv_h16_fwd_slot(int wd) {
  return (size_t)qv_align1k(qv_h16_rows(wd, QV_H16_TP) * 128) + 1024;
}
static size_t qv_h16_dw_slot(int wd, int tp) {
  return (size_t)tp * 128 + (size_t)qv_align1k(qv_h16_rows(wd, tp) * 128) +
         1024;
}

// How a bf16 (rows, c) matrix at p is staged (qv_stage_bf16's mode).
static int qv_h16_mode(const __nv_bfloat16* p, int c) {
  const uintptr_t a = (uintptr_t)p;
  if (c % 8 == 0 && a % 16 == 0) return 2;
  if (c % 4 == 0 && a % 8 == 0) return 1;
  return 0;
}

typedef void (*QvH16Kernel)(const __nv_bfloat16*, const uint8_t*,
                            const __nv_bfloat16*, __nv_bfloat16*, long long,
                            int, int, int, int, int, int);

// The weight image of (cin -> cout, flip) into wf, then the persistent
// forward / dx kernel: one block an SM (or as many as fit), no more blocks
// than items.
static int qv_h16_conv(QvH16Kernel kernel, const __nv_bfloat16* in,
                       const __nv_bfloat16* w, const __nv_bfloat16* b,
                       float* wf, __nv_bfloat16* out, long long np, int h,
                       int wd, int cin, int cout, int flip, cudaStream_t s) {
  const int nk = (cin + 63) / 64, nn = (cout + 63) / 64;
  const long long total = 9LL * nk * nn * 4096;
  qv_conv3x3_wimg_bf16_kernel<<<(int)((total + 255) / 256), 256, 0, s>>>(
      w, reinterpret_cast<__nv_bfloat16*>(wf), cin, cout, nk, nn, flip);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t fixed = 1024 + QV_H16_WIMG + QV_H16_TP * 128;
  const size_t slot = qv_h16_fwd_slot(wd);
  const int nslots = qv_h16_slots(fixed, slot);
  const size_t smem = fixed + nslots * slot;
  int dev, sms, per_sm;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute((const void*)kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, (const void*)kernel, QV_H16_THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  const long long items = (np + QV_H16_TP - 1) / QV_H16_TP * nn;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  kernel<<<(unsigned)(items < cap ? items : cap), QV_H16_THREADS, smem, s>>>(
      in, reinterpret_cast<const uint8_t*>(wf), b, out, np, h, wd, cin, cout,
      qv_h16_mode(in, cin), nslots);
  return (int)cudaGetLastError();
}

extern "C" int qv_conv3x3_fwd_bf16(const __nv_bfloat16* x,
                                   const __nv_bfloat16* w,
                                   const __nv_bfloat16* b, float* wf,
                                   __nv_bfloat16* y, long long np, int h,
                                   int wd, int cin, int cout, void* stream) {
  return qv_h16_conv(qv_conv3x3_fwd_wg_bf16_kernel, x, w, b, wf, y, np, h,
                     wd, cin, cout, 0, (cudaStream_t)stream);
}

// dx: the image of the flipped, transposed taps (in-channels cout, out cin)
extern "C" int qv_conv3x3_dx_bf16(const __nv_bfloat16* ct,
                                  const __nv_bfloat16* w, float* wf,
                                  __nv_bfloat16* dx, long long np, int h,
                                  int wd, int cin, int cout, void* stream) {
  return qv_h16_conv(qv_conv3x3_dx_wg_bf16_kernel, ct, w, nullptr, wf, dx, np,
                     h, wd, cout, cin, 1, (cudaStream_t)stream);
}

// Blocks of the bf16 dw pass the card runs at once (at the largest strip).
extern "C" int qv_conv3x3_dw_bf16_slots(int* slots) {
  const size_t slot = qv_h16_dw_slot(1 << 20, QV_CONV_TP);
  const size_t smem = 1024 + qv_h16_slots(1024, slot) * slot;
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(qv_conv3x3_dw_wg_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, qv_conv3x3_dw_wg_bf16_kernel, QV_H16_DW_THREADS, smem);
  if (err == cudaSuccess) *slots = sms * per_sm;
  return (int)err;
}

extern "C" int qv_conv3x3_dw_bf16(const __nv_bfloat16* x,
                                  const __nv_bfloat16* ct, float* part,
                                  __nv_bfloat16* out, long long np, int h,
                                  int wd, int cin, int cout, long long chunk,
                                  int nb, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  // tiles of 256 pixels where two stages of them fit, else of 128 (the
  // wrapper's chunks are whole multiples of 256)
  int tp = 256;
  if (1024 + 2 * qv_h16_dw_slot(wd, tp) > QV_H16_SMEM) tp = 128;
  const size_t slot = qv_h16_dw_slot(wd, tp);
  const int nslots = qv_h16_slots(1024, slot);
  const size_t smem = 1024 + nslots * slot;
  cudaError_t err = cudaFuncSetAttribute(
      qv_conv3x3_dw_wg_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nb, (unsigned)((cin + 63) / 64),
            (unsigned)((cout + 63) / 64));
  qv_conv3x3_dw_wg_bf16_kernel<<<grid, QV_H16_DW_THREADS, smem, s>>>(
      x, ct, part, np, h, wd, cin, cout, chunk, qv_h16_mode(x, cin),
      qv_h16_mode(ct, cout), tp, nslots);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  long long len = 9LL * cin * cout + cout;
  int blocks = len > 4096LL * 256 ? 4096 : (int)((len + 255) / 256);
  qv_conv3x3_reduce_kernel<__nv_bfloat16>
      <<<blocks, 256, 0, s>>>(part, out, nb, len);
  return (int)cudaGetLastError();
}
