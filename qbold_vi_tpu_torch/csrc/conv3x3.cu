// Kernel H: the encoder trunk's 3x3 SAME convolution, forward and backward,
// on Hopper's tensor cores with float32-accurate 3xTF32 products.
//
// Replaces the Pallas TPU kernel qbold_vi_tpu/ops/pallas_conv.py::
// make_conv3x3: the forward (_fwd_kernel, pallas_call at :188) and the
// backward that emits dx, dw and db in one pass (_bwd_kernel, :239).
// Semantics: nn.Conv((3, 3), padding="SAME") on channels-last float32
// x (N, H, W, Ci) with weights (3, 3, Ci, Co) HWIO and bias (Co), float32
// accumulation, any H, W >= 3 and any Ci, Co.
//
// Why 3xTF32. The trunk runs in full float32 (TF32 is held off around the
// fine-tune step). One TF32 product keeps ~3 decimal digits, so each
// float32 operand a is split into hi = tf32(a) and lo = tf32(a - hi)
// (round to nearest, ties away, as cvt.rna) and a * b is taken as
// a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, three tensor-core products
// accumulated in float32; the dropped a_lo * b_lo is ~2^-22 of |a * b|.
// The lo of a zero (padding, masked taps) is zero. No product reaches an
// output from a single TF32 term. The tensor cores' float32 sums truncate,
// so the products of a few k-steps go to a fresh fragment that is added to
// the thread's sums in float32 (round to nearest): a running sum fed to
// the mma at every k-step gathered that bias to ~5e-6 of the largest
// output at the fine-tune fold, the fresh fragments keep it at ~4e-7.
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
// The build's --fmad=false leaves mma and the hi/lo subtraction alone:
// a - hi is exact.

#include <cuda_runtime.h>
#include <stdint.h>

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

// a rounded to TF32 (10 mantissa bits, nearest, ties away), as float bits:
// what cvt.rna.tf32.f32 gives for finite a, in two integer operations (half
// of the 13 dropped bits added to the sign-magnitude pattern, then dropped),
// which run faster here than the conversion instruction.
__device__ __forceinline__ uint32_t qv_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void qv_split(float a, uint32_t& hi,
                                         uint32_t& lo) {
  hi = qv_tf32(a);
  lo = qv_tf32(a - __uint_as_float(hi));
}

// d = a * b + c on one 16 x 8 x 8 TF32 fragment.
__device__ __forceinline__ void qv_mma(float* d, const uint32_t* a,
                                       uint32_t b0, uint32_t b1,
                                       const float* c) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d = a * b (first) or d += a * b in 3xTF32: the two small products, then
// the large one.
__device__ __forceinline__ void qv_mma3(float* d, const uint32_t* ahi,
                                        const uint32_t* alo,
                                        const uint32_t* bhi,
                                        const uint32_t* blo, bool first) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  qv_mma(d, alo, bhi[0], bhi[1], first ? zero : d);
  qv_mma(d, ahi, blo[0], blo[1], d);
  qv_mma(d, ahi, bhi[0], bhi[1], d);
}

// acc += d in float32. The tensor cores' float32 sums truncate: a running
// sum fed to them at every k-step would gather that bias over the whole
// pass (~5e-6 of the largest output at the fine-tune fold), so the
// products of a few k-steps go to a fresh fragment and are added here,
// where the adds round to nearest (~4e-7).
__device__ __forceinline__ void qv_add4(float* acc, const float* d) {
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] += d[k];
}

// Stage channels c0 .. c0 + nch - 1 (nch 32 or 64) of global rows q(r) =
// q0 + (r / seg) * step + r % seg, r in [0, rows), as s[r * STRIDE + c];
// zeros outside rows [0, nq) and channels [0, cin). vec: cin % 4 == 0 and
// x 16-byte aligned.
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

// Second pass: out[i] = sum over chunks b, in order, of part[b, i].
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

static bool qv_vec(const float* p, int c) {
  return c % 4 == 0 && ((uintptr_t)p & 15) == 0;
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
  qv_conv3x3_reduce_kernel<<<blocks, 256, 0, s>>>(part, out, nb, len);
  return (int)cudaGetLastError();
}
