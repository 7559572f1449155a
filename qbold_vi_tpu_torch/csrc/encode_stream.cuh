// Kernels B and C, streamed: the fused stream-1 encode (C), or the encode
// followed by the quadrature summaries (B), at any width and depth, with the
// weights streamed through shared memory. encode_stream_bf16.cu instantiates
// it for the bf16 trunk; the float32 policy (QvStF32), the staged rows and
// the head here serve the float32 wgmma designs, which replaced its float32
// instantiation (PERF.md).
//
// It replaces the same TPU kernels as encode_quad.cu and encode_quad_bf16.cu
// (qbold_vi_tpu/ops/pallas_infer.py::encode_quad_fused, pallas_call at :353,
// and encode_q1_packed, at :246), which cover every encoder configuration
// (pallas_infer.py:35-38), and computes what they compute, rounding where
// the resident kernels round. The resident kernels keep the whole weight
// blob in shared memory; the wrapper takes them wherever it fits
// (ops/fused_infer.py::launch_plan). Elsewhere the float32 trunk takes
// encode_stream_wg.cu's wgmma kernels up to a padded width of 256 (65-128
// units x 2 blocks, deep trunks such as 60 x 7, 129-256 units),
// encode_stream_wgc.cu's chunked wgmma kernels at 320 and 384 (257-384
// units), encode_stream_wgx.cu's split wgmma kernels at 448-768 (385-768
// units) and encode_stream_wgk.cu's cluster wgmma kernels at 832-1472
// (769-1472 units), at any tau count (many taus: their staged rows in the
// activation rows, a window of k-steps at a time where a row is wider);
// the bf16 trunk takes this kernel past 128 units and at depths whose
// blob does not fit.
//
// Bound: at 256 units x 2 blocks the products (U T + nb U^2 + 5 U FMAs a
// voxel, 3xTF32 in float32) take 1.69 ms of a 1.03 M-voxel request at the
// dense TF32 peak, 0.28 ms at bf16; the bytes of the request (~84 B a
// voxel) 0.026 ms. What a design adds is the weights' traffic from L2: a
// block reads every layer's weights once a pass of V voxels, 1.1 MB a pass
// at 256 x 2 in float32 (hi and lo), so V = 64 voxels a pass is ~17.7 GB
// of L2 reads for the request, V = 128 ~8.9 GB. On the H100 the time
// follows the voxels a pass and the slabs a pass walks, not the copies'
// latency: at 256 x 2 in float32 a ring of 2 to 6 slabs ran within 3% of
// one another, 128 voxels a pass took 20% less time than 64 and 64 35%
// less than 32, 32 KB slabs 11% less than 16 KB; 64 KB slabs were no
// faster (tools/bench_stream1.py --sweep, PERF.md; this kernel then
// served float32 at 256 x 2). So the plan takes the largest pass, then
// the largest slab up to 32 KB, that fit; two slots double-buffer the
// slabs.
//
// Design. A block of 8 warps takes a pass of V = 16 MT voxels at a time:
// * Activations in shared memory. The pass's normalised rows (xs) and two
//   buffers of V x Up activations, a layer reading one and writing the
//   other; float32 in the float32 trunk, bf16 pairs in the bf16 trunk (the
//   activations are bf16 values there). Where a layer is one chunk (Up <= 8
//   NCW x 8) every output sits in the warps' sums until the layer's last
//   slab, so one buffer serves: a __syncthreads, then the outputs overwrite
//   the inputs, and the buffer's bytes go to larger slabs.
// * Each layer in chunks of CN = 8 NCW n-tiles of outputs; warp w owns
//   n-tiles w NCW .. w NCW + NCW - 1 of the chunk for all MT m-tiles of
//   the pass, so its sums are MT x NCW x 4 floats (64 at most) whatever
//   the width, and a B fragment serves MT m-tiles. A is read from the
//   activation buffer a k-step at a time (and split into TF32 hi / lo in
//   float32). At the chunk's end, bias and activation turn the sums into
//   the next buffer's rows, with the resident kernels' rounding. B's
//   quadrature scratch shares an activation buffer's bytes where it fits
//   (the buffers are idle between a round's last head and its next pass).
// * The weights as the blob holds them (ops/fused_infer.py::_weight_blob:
//   fragment order [k-step][n-tile][lane] in float32, the wgmma core-matrix
//   images [k-step][n-tile][k-half][8][8] in bf16, whose lane words are
//   mma.sync m16n8k16's B fragment), so the streamed and resident designs
//   read one blob. A slab is KS k-steps of one chunk's n-tiles; a pass
//   walks its slabs (layer, chunk, k-slab) through two slots filled by
//   16-byte cp.async by all threads, the next slab landing while this one
//   is multiplied; the same walk repeats every pass, so the copies run on
//   from one pass into the next. One __syncthreads a slab both publishes
//   the slab and frees the slot refilled next.
// * The head (U -> 5, 8 outputs) on MT warps, an m-tile each, its
//   fragments read from the blob in global memory (L1 / L2). The heads of
//   256 / V passes are staged in shared memory; then all 256 threads, a
//   voxel a thread, run B's quadrature (quad_math.cuh, qv_quad_block's
//   side sort over the block) or write C's q.
// * Products: mma.sync (m16n8k8 TF32 as 3xTF32, mma_math.cuh; m16n8k16
//   bf16 with float32 sums). One skeleton serves both trunks. Where a
//   layer is one wgmma width in float32 (up to 256) encode_stream_wg.cu
//   redesigns it on wgmma with a producer's ring, at 320 and 384
//   encode_stream_wgc.cu in output chunks of one activation buffer, at
//   448-768 encode_stream_wgx.cu with a layer's columns split between two
//   warpgroups, and at 832-1472 encode_stream_wgk.cu across a cluster of
//   blocks (PERF.md); a bf16 version on wgmma is later work.
// MT and NCW are template constants (QV_ST_DISPATCH); depth, width and the
// slab's k-steps are runtime values that the wrapper's plan gives
// (launch_plan), with the shared-memory bytes; this file computes the
// layout from them in the same order:
//   slots 2 x KS x CN x FB bytes | act buffers (1 or 2) x V x SA words |
//   xs V x SX words | heads 5 x 256 floats | [B: node table QV_NCONST,
//   quadrature scratch QV_QUAD_SCRATCH(256) floats, unless it fits in
//   the first act buffer]
// (FB: bytes of a k-step's n-tile, 512 in float32, 256 in bf16; SA, SX:
// the policy's row strides in 32-bit words, padded so that a warp's A
// loads and epilogue stores meet no bank twice).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_act.cuh"
#include "mma_math.cuh"
#include "quad_math.cuh"

#define QV_ST_THREADS 256  // 8 warps
#define QV_ST_WARPS 8
#define QV_ST_ROUND 256    // voxels a quadrature round: a voxel a thread
// blocks an SM the registers are sized for: the shared memory holds one
// (ptxas otherwise caps some tiles at 128 registers and spills)
#define QV_ST_MINB 1

// ---- cp.async ---------------------------------------------------------------

static __device__ __forceinline__ void qv_st_cp16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
static __device__ __forceinline__ void qv_st_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until this thread's copies have landed.
static __device__ __forceinline__ void qv_st_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- the trunks' policies -----------------------------------------------------
// K: channels a k-step; FB: bytes of one (k-step, n-tile) in the blob;
// act_stride / x_stride: row strides of the activation buffers and of the
// staged rows, in 32-bit words; load_a: the A fragment of m-tile rows
// row0 .. row0 + 15, k-step ks; load_b: the B fragment of slab group grp;
// mma: a product onto the sums (the head's); mma_trunk: a trunk layer's;
// store: bias + activation of a lane's four sums, rows row and row + 8,
// channels col and col + 1; put_x: channel c of staged row r. The float32
// policy keeps what the wgmma designs take from it (their staged rows,
// A fragments, epilogue and head): qv_st_body runs the bf16 trunk only.

// float32: 3xTF32 m16n8k8 (mma_math.cuh), activations as float32.
struct QvStF32 {
  static constexpr int K = 8, FB = 512;
  struct A {
    uint32_t hi[4], lo[4];
  };
  typedef float4 B;
  static __device__ __forceinline__ int x_stride(int ks0) {
    const int tp = 8 * ks0;
    return tp % 16 == 0 ? tp + 8 : tp;
  }
  static __device__ __forceinline__ A load_a(const uint32_t* buf, int stride,
                                             int row0, int ks, int g, int t) {
    const float* r =
        reinterpret_cast<const float*>(buf) + (row0 + g) * stride + 8 * ks + 2 * t;
    const float2 a = *reinterpret_cast<const float2*>(r);
    const float2 b = *reinterpret_cast<const float2*>(r + 8 * stride);
    A f;
    qv_split(a.x, f.hi[0], f.lo[0]);
    qv_split(b.x, f.hi[1], f.lo[1]);
    qv_split(a.y, f.hi[2], f.lo[2]);
    qv_split(b.y, f.hi[3], f.lo[3]);
    return f;
  }
  static __device__ __forceinline__ B load_b_global(const uint8_t* p, int grp,
                                                    int lane) {
    return __ldg(reinterpret_cast<const float4*>(p + grp * FB) + lane);
  }
  static __device__ __forceinline__ void mma(float* d, const A& a, B b) {
    const uint32_t bhi[2] = {__float_as_uint(b.x), __float_as_uint(b.y)};
    const uint32_t blo[2] = {__float_as_uint(b.z), __float_as_uint(b.w)};
    qv_mma3(d, a.hi, a.lo, bhi, blo, false);
  }
  // bias: the layer's float32 biases
  static __device__ __forceinline__ void store(uint32_t* buf, int stride,
                                               int row, int col,
                                               const float* c,
                                               const void* bias, int act) {
    const float2 b =
        __ldg(reinterpret_cast<const float2*>(
                  reinterpret_cast<const float*>(bias) + col));
    float v0 = c[0] + b.x, v1 = c[1] + b.y, v2 = c[2] + b.x, v3 = c[3] + b.y;
    if (act == 0) {
      v0 = fmaxf(v0, 0.0f);
      v1 = fmaxf(v1, 0.0f);
      v2 = fmaxf(v2, 0.0f);
      v3 = fmaxf(v3, 0.0f);
    } else {
      v0 = qv_act_call(act, v0);
      v1 = qv_act_call(act, v1);
      v2 = qv_act_call(act, v2);
      v3 = qv_act_call(act, v3);
    }
    float* o = reinterpret_cast<float*>(buf) + row * stride + col;
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    *reinterpret_cast<float2*>(o + 8 * stride) = make_float2(v2, v3);
  }
  static __device__ __forceinline__ void put_x(uint32_t* xs, int stride, int r,
                                               int c, float v) {
    reinterpret_cast<float*>(xs)[r * stride + c] = v;
  }
};

// bf16: m16n8k16 bf16 products with float32 sums, activations as bf16 pairs
// (the resident bf16 kernel's packed epilogue: bf16(sum) + bf16 bias in
// bf16, then the activation in bf16).
struct QvStBf16 {
  static constexpr int K = 16, FB = 256;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t b0, b1;
  };
  static __device__ __forceinline__ int act_stride(int up) { return up / 2 + 4; }
  static __device__ __forceinline__ int x_stride(int ks0) { return 8 * ks0 + 4; }
  // a0 (g, 2t | 2t + 1), a1 (g + 8, ..), a2 (g, 2t + 8 | 2t + 9), a3 (g + 8, ..)
  static __device__ __forceinline__ A load_a(const uint32_t* buf, int stride,
                                             int row0, int ks, int g, int t) {
    const uint32_t* r = buf + (row0 + g) * stride + 8 * ks + t;
    A f;
    f.r[0] = r[0];
    f.r[1] = r[8 * stride];
    f.r[2] = r[4];
    f.r[3] = r[8 * stride + 4];
    return f;
  }
  // b0 (k 2t | 2t + 1, n g), b1 (k 2t + 8 | 2t + 9, n g): word `lane` of the
  // core matrices k-half 0 and 1 of the (k-step, n-tile) image
  static __device__ __forceinline__ B load_b(const uint8_t* slot, int grp,
                                             int lane) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(slot + grp * FB);
    B b;
    b.b0 = p[lane];
    b.b1 = p[32 + lane];
    return b;
  }
  static __device__ __forceinline__ B load_b_global(const uint8_t* p, int grp,
                                                    int lane) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p + grp * FB);
    B b;
    b.b0 = __ldg(q + lane);
    b.b1 = __ldg(q + 32 + lane);
    return b;
  }
  static __device__ __forceinline__ void mma(float* d, const A& a, B b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.b0),
          "r"(b.b1));
  }
  // a trunk layer's k-step: one product onto the sums (its rounding points
  // are the JAX kernel's)
  static __device__ __forceinline__ void mma_trunk(float* d, const A& a,
                                                   B b) {
    mma(d, a, b);
  }
  static __device__ __forceinline__ uint32_t pair(float lo, float hi,
                                                  uint32_t bw, int act) {
    const __nv_bfloat162 s =
        __hadd2(__floats2bfloat162_rn(lo, hi),
                *reinterpret_cast<const __nv_bfloat162*>(&bw));
    if (act == 0) {
      const __nv_bfloat162 v = __hmax2(s, __floats2bfloat162_rn(0.0f, 0.0f));
      return *reinterpret_cast<const uint32_t*>(&v);
    }
    const float2 f = __bfloat1622float2(s);
    const __nv_bfloat162 v = __floats2bfloat162_rn(qv_act_bf16(act, f.x),
                                                   qv_act_bf16(act, f.y));
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  // bias: the layer's bf16 biases as packed pairs
  static __device__ __forceinline__ void store(uint32_t* buf, int stride,
                                               int row, int col,
                                               const float* c,
                                               const void* bias, int act) {
    const uint32_t bw =
        __ldg(reinterpret_cast<const uint32_t*>(bias) + (col >> 1));
    uint32_t* o = buf + row * stride + (col >> 1);
    o[0] = pair(c[0], c[1], bw, act);
    o[8 * stride] = pair(c[2], c[3], bw, act);
  }
  static __device__ __forceinline__ void put_x(uint32_t* xs, int stride, int r,
                                               int c, float v) {
    reinterpret_cast<__nv_bfloat16*>(xs)[2 * r * stride + c] =
        __float2bfloat16_rn(v);
  }
};

// The blob's parts in global memory (ops/fused_infer.py::_weight_blob):
// layer l's weights (l = 0 the first layer, 1..nb the blocks), the head's
// fragments (bf16: its three pieces' images, pieces `head_piece` bytes
// apart), layer l's biases, the head's float32 bias and the node table.
struct QvStBlob {
  const uint8_t *w0, *wb, *wf;
  long long layer_bytes, head_piece;
  const uint8_t* bias;
  int bias_bytes;
  const float *bf, *consts;
  __device__ __forceinline__ const uint8_t* layer(int l) const {
    return l == 0 ? w0 : wb + (long long)(l - 1) * layer_bytes;
  }
  __device__ __forceinline__ const void* layer_bias(int l) const {
    return bias + l * bias_bytes;
  }
};

template <class P>
static __device__ __forceinline__ QvStBlob qv_st_blob(const float* blob,
                                                     int up, int nb, int ks0) {
  const int nt = up / 8, ksh = up / P::K;
  const bool bf16 = P::K == 16;
  QvStBlob b;
  b.w0 = reinterpret_cast<const uint8_t*>(blob + (bf16 ? 4 : 0));  // tag
  b.wb = b.w0 + (long long)ks0 * nt * P::FB;
  b.layer_bytes = (long long)ksh * nt * P::FB;
  b.wf = b.wb + nb * b.layer_bytes;
  b.head_piece = (long long)ksh * P::FB;
  b.bias = b.wf + (bf16 ? 3 : 1) * b.head_piece;
  b.bias_bytes = bf16 ? 2 * up : 4 * up;
  b.bf = reinterpret_cast<const float*>(b.bias + (nb + 1) * b.bias_bytes);
  b.consts = b.bf + 8;
  return b;
}

// Staged row r: voxel v normalised ([mask] -> clip -> / reference -> log),
// zero past N and past T up to the k-steps' kpad channels.
template <class P>
static __device__ __forceinline__ void qv_st_stage_row(
    uint32_t* xs, int stride, int r, const float* __restrict__ x, long long n,
    long long v, int t_in, int cm, int mask, int T, int se, int multi, int lo,
    int hi, int kpad) {
  if (v < n) {
    const float m =
        mask ? (cm ? x[(long long)T * n + v] : x[v * t_in + T]) : 1.0f;
    auto clip = [&](int c) {
      float xv = cm ? x[(long long)c * n + v] : x[v * t_in + c];
      if (mask) xv = xv * m;
      return fminf(fmaxf(xv, 1e-2f), 1e8f);
    };
    float ref;
    if (multi) {
      float sum = 0.0f;
      for (int c = lo; c < hi; ++c) sum += clip(c);
      ref = sum / (float)(hi - lo);
    } else {
      ref = clip(se);
    }
    for (int c = 0; c < T; ++c) P::put_x(xs, stride, r, c, logf(clip(c) / ref));
  } else {
    for (int c = 0; c < T; ++c) P::put_x(xs, stride, r, c, 0.0f);
  }
  for (int c = T; c < kpad; ++c) P::put_x(xs, stride, r, c, 0.0f);
}

// Windowed rows (the float32 wgmma designs' rows "windowed", where a staged
// row of many taus is wider than the block's activation row): a pass stages
// its rows a window at a time, the channels of the first layer's next
// k-steps in the first columns of the activation rows, each value as
// qv_st_stage_row computes it. QvStWin is a row's voxel, mask value and
// reference, computed once a pass before its first window and kept in the
// registers of the lanes of its warp that stage it (l % 16 its row).
struct QvStWin {
  long long v;
  float m, ref;
};

// A loaded value xv masked and clipped (qv_st_stage_row's clip).
static __device__ __forceinline__ float qv_st_clipped(float xv, int mask,
                                                      float m) {
  if (mask) xv = xv * m;
  return fminf(fmaxf(xv, 1e-2f), 1e8f);
}

static __device__ __forceinline__ QvStWin qv_st_win_row(
    const float* __restrict__ x, long long n, long long v, int t_in, int cm,
    int mask, int T, int se, int multi, int lo, int hi) {
  QvStWin w{v, 1.0f, 1.0f};
  if (v >= n) return w;
  auto at = [&](int c) {
    return cm ? x[(long long)c * n + v] : x[v * t_in + c];
  };
  if (mask) w.m = at(T);
  if (multi) {
    float sum = 0.0f;
    for (int c = lo; c < hi; ++c) sum += qv_st_clipped(at(c), mask, w.m);
    w.ref = sum / (float)(hi - lo);
  } else {
    w.ref = qv_st_clipped(at(se), mask, w.m);
  }
  return w;
}

// Channel c of voxel v as loaded (1 past N and past T), and its staged
// value from that load: log(clip / reference), zero past N and past T --
// apart, so that a lane can start a batch of loads before their
// arithmetic.
static __device__ __forceinline__ float qv_st_win_load(
    const float* __restrict__ x, long long n, long long v, int t_in, int cm,
    int T, int c) {
  return v < n && c < T ? (cm ? x[(long long)c * n + v] : x[v * t_in + c])
                        : 1.0f;
}
static __device__ __forceinline__ float qv_st_win_value(
    float xv, long long n, long long v, int mask, int T, float m, float ref,
    int c) {
  return v < n && c < T ? logf(qv_st_clipped(xv, mask, m) / ref) : 0.0f;
}

// Channels c0 .. c0 + width - 1 (width <= W) of a warp's 16 staged rows
// (rows r0 .. r0 + 15: consecutive voxels, lane l's row r0 + l % 16 and
// its QvStWin w) into their columns 0 .. width - 1, by warp q of the NQ
// warps that stage the same rows. The lanes follow x's layout, so that a
// load reads contiguous words: channel-major, a lane a row and the two
// lanes of a row alternate channels; voxel-major, the 32 lanes take a row's
// consecutive channels, row by row, its reference and mask value from its
// lanes by shuffle (every lane of the warp calls this). Each lane loads a
// batch of B values, then computes them: the loads are in flight together
// (one at a time, the staging ran at ~60 G values a second on the H100;
// batches of 16 ran within 4% of 8 and spilled more in the cluster
// kernels, PERF.md).
template <int W, int NQ>
static __device__ __forceinline__ void qv_st_stage_window(
    float* rows, int stride, int r0, int q, const QvStWin& w,
    const float* __restrict__ x, long long n, int t_in, int cm, int mask,
    int T, int c0, int width) {
  constexpr int B = 8;  // values a lane loads at once
  const int lane = threadIdx.x & 31;
  if (cm) {
    float* o = rows + (r0 + (lane & 15)) * stride;
    const int c1 = 2 * q + (lane >> 4);  // the lane's first channel
#pragma unroll 1
    for (int i0 = 0; 2 * NQ * i0 < width; i0 += B) {
      float raw[B];
#pragma unroll
      for (int i = 0; i < B; ++i)
        raw[i] = qv_st_win_load(x, n, w.v, t_in, cm, T,
                                c0 + c1 + 2 * NQ * (i0 + i));
#pragma unroll
      for (int i = 0; i < B; ++i) {
        const int c = c1 + 2 * NQ * (i0 + i);
        if (c < width)
          o[c] = qv_st_win_value(raw[i], n, w.v, mask, T, w.m, w.ref, c0 + c);
      }
    }
    return;
  }
  constexpr int NJ = (W + 32 * NQ - 1) / (32 * NQ);  // a lane's chunks a row
  // rows a batch: a power of two, at most B / NJ (at least 1)
  constexpr int R = B / NJ >= 8 ? 8 : B / NJ >= 4 ? 4 : B / NJ >= 2 ? 2 : 1;
  const long long v0 = w.v - (lane & 15);
#pragma unroll 1
  for (int rb = 0; rb < 16; rb += R) {
    float raw[R][NJ], m[R], ref[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = __shfl_sync(0xffffffffu, w.m, rb + r);
      ref[r] = __shfl_sync(0xffffffffu, w.ref, rb + r);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = 32 * (q + NQ * j) + lane;
        raw[r][j] = qv_st_win_load(x, n, v0 + rb + r, t_in, cm, T,
                                   c < width ? c0 + c : T);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float* o = rows + (r0 + rb + r) * stride;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = 32 * (q + NQ * j) + lane;
        if (c < width)
          o[c] = qv_st_win_value(raw[r][j], n, v0 + rb + r, mask, T, m[r],
                                 ref[r], c0 + c);
      }
    }
  }
}

// The head of m-tile rows row0 .. row0 + 15 from the last activations:
// q (channels 0-4) into hq[c * QV_ST_ROUND + base + row].
static __device__ __forceinline__ void qv_st_head(
    QvStF32, const uint32_t* buf, int stride, const QvStBlob& b, int up,
    int row0, int lane, float* hq, int base) {
  const int g = lane >> 2, t = lane & 3;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int ks = 0; ks < up / 8; ++ks)
    QvStF32::mma(acc, QvStF32::load_a(buf, stride, row0, ks, g, t),
                 QvStF32::load_b_global(b.wf, ks, lane));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 2 * t + (i & 1), row = row0 + g + (i < 2 ? 0 : 8);
    if (col < 5) hq[col * QV_ST_ROUND + base + row] = acc[i] + b.bf[col];
  }
}

// bf16: the head's three bf16 pieces (w1 + w2 + w3 = the float32 weights),
// w3's and w2's products in one float32 sum, w1's in another, as the
// resident bf16 kernel sums them.
static __device__ __forceinline__ void qv_st_head(
    QvStBf16, const uint32_t* buf, int stride, const QvStBlob& b, int up,
    int row0, int lane, float* hq, int base) {
  const int g = lane >> 2, t = lane & 3;
  float h1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, h23[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int p = 2; p >= 0; --p) {
    const uint8_t* w = b.wf + p * b.head_piece;
    float* h = p == 0 ? h1 : h23;
    for (int ks = 0; ks < up / 16; ++ks)
      QvStBf16::mma(h, QvStBf16::load_a(buf, stride, row0, ks, g, t),
                    QvStBf16::load_b_global(w, ks, lane));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 2 * t + (i & 1), row = row0 + g + (i < 2 ? 0 : 8);
    if (col < 5)
      hq[col * QV_ST_ROUND + base + row] = (h1[i] + h23[i]) + b.bf[col];
  }
}

// A round's tail, a voxel a thread: kernel B's quadrature summaries
// (means, vars, raw (3, N) to o0, o1, o2) or kernel C's q (5, N) to o0.
// Out of line: one copy serves every instantiation's round. The round's
// threads are the block's (QvBlockSync) or the first QV_ST_ROUND threads
// on a named barrier (QvNamedSync: encode_stream_wg.cu's consumers).
template <class Sync = QvBlockSync>
static __device__ __noinline__ void qv_st_quad_round(
    const float* consts, float* scratch, const float* hq, long long n,
    long long v0, int mvg, QvRanges rg, float* o0, float* o1, float* o2,
    Sync sync = Sync()) {
  const long long v = v0 + threadIdx.x;
  const bool live = v < n;
  const float* q = hq + threadIdx.x;
  float rw[3];
  const QvQuadIn in =
      qv_quad_squash(q[0], q[QV_ST_ROUND], q[2 * QV_ST_ROUND],
                     q[3 * QV_ST_ROUND], q[4 * QV_ST_ROUND], mvg != 0, rw);
  float o[8], gm[5], D1, D2;
  qv_quad_block(consts, scratch, live, in, o, &D1, &D2, gm, sync);
  if (!live) return;
  float m[3], sv[3];
  qv_quad_combine(o, D1, D2, gm, in.od, rg, m, sv);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    o0[(long long)j * n + v] = m[j];
    o1[(long long)j * n + v] = sv[j];
    o2[(long long)j * n + v] = rw[j];
  }
}

static __device__ __forceinline__ void qv_st_write_q(const float* hq,
                                                     long long n, long long v0,
                                                     float* o0) {
  const long long v = v0 + threadIdx.x;
  if (v >= n) return;
#pragma unroll
  for (int j = 0; j < 5; ++j)
    o0[(long long)j * n + v] = hq[j * QV_ST_ROUND + threadIdx.x];
}

template <class P, int MT, int NCW, bool QUAD>
static __device__ __forceinline__ void qv_st_body(
    const float* __restrict__ x, long long n, int t_in, int cm, int mask,
    int se, int multi, int act, int up, int nb,
    const float* __restrict__ blob, int mvg, QvRanges rg, int ks_slab,
    float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2) {
  constexpr int V = 16 * MT, CN = QV_ST_WARPS * NCW;
  extern __shared__ float4 qv_st_smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(qv_st_smem);
  const int T = t_in - mask;
  const int ks0 = (T + P::K - 1) / P::K, ksh = up / P::K, nt = up / 8;
  const int nch = (nt + CN - 1) / CN;
  const int nks0 = (ks0 + ks_slab - 1) / ks_slab;
  const int nksh = (ksh + ks_slab - 1) / ks_slab;
  const int s0 = nch * nks0, sh = nch * nksh, nslab = s0 + nb * sh;
  const int slot_bytes = ks_slab * CN * P::FB;
  const int sa = P::act_stride(up), sx = P::x_stride(ks0);
  const bool single = nch == 1;  // one activation buffer (header)
  uint32_t* bufs[2];
  bufs[0] = reinterpret_cast<uint32_t*>(sm + 2 * slot_bytes);
  bufs[1] = single ? bufs[0] : bufs[0] + V * sa;
  uint32_t* xs = bufs[1] + V * sa;
  float* hq = reinterpret_cast<float*>(xs + V * sx);
  float* consts = hq + 5 * QV_ST_ROUND;
  float* scratch = V * sa >= QV_QUAD_SCRATCH(QV_ST_ROUND)
                       ? reinterpret_cast<float*>(bufs[0])
                       : consts + QV_NCONST;
  const QvStBlob b = qv_st_blob<P>(blob, up, nb, ks0);
  if (QUAD) qv_stage_consts(b.consts, consts);

  // slab i of the pass's walk (layer, chunk, k-slab) into slot `slot`
  auto issue = [&](int i, int slot) {
    int l = 0, r = i;
    if (i >= s0) {
      l = 1 + (i - s0) / sh;
      r = (i - s0) - (l - 1) * sh;
    }
    const int nks = l == 0 ? nks0 : nksh, kl = l == 0 ? ks0 : ksh;
    const int c = r / nks, k0 = (r - c * nks) * ks_slab;
    const int nk = min(ks_slab, kl - k0);
    const int j0 = c * CN, nj = min(CN, nt - j0);
    const uint8_t* src = b.layer(l) + ((long long)k0 * nt + j0) * P::FB;
    uint8_t* dst = sm + slot * slot_bytes;
    const int per_k = nj * (P::FB / 16);
    for (int e = threadIdx.x; e < nk * per_k; e += QV_ST_THREADS) {
      const int k = e / per_k, p = e - k * per_k;
      qv_st_cp16(dst + k * CN * P::FB + 16 * p,
                 src + (long long)k * nt * P::FB + 16 * p);
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int lo = se - 1 > 0 ? se - 1 : 0, hi = se + 2 < T ? se + 2 : T;
  // the walk's next slab to issue, and the slot of the one to consume
  issue(0, 0);
  qv_st_commit();
  int next = nslab > 1 ? 1 : 0, slot = 0;
  const long long rounds = (n + QV_ST_ROUND - 1) / QV_ST_ROUND;
#pragma unroll 1
  for (long long rnd = blockIdx.x; rnd < rounds; rnd += gridDim.x) {
    const long long v0r = rnd * QV_ST_ROUND;
    const int passes =
        (int)min((long long)(QV_ST_ROUND / V), (n - v0r + V - 1) / V);
#pragma unroll 1
    for (int p = 0; p < passes; ++p) {
      if (threadIdx.x < V)
        qv_st_stage_row<P>(xs, sx, threadIdx.x, x, n,
                           v0r + p * V + threadIdx.x, t_in, cm, mask, T, se,
                           multi, lo, hi, ks0 * P::K);
#pragma unroll 1
      for (int l = 0; l <= nb; ++l) {
        const uint32_t* in = l == 0 ? xs : bufs[(l - 1) & 1];
        const int s_in = l == 0 ? sx : sa;
        uint32_t* out = bufs[l & 1];
        const int kl = l == 0 ? ks0 : ksh, nks = l == 0 ? nks0 : nksh;
#pragma unroll 1
        for (int c = 0; c < nch; ++c) {
          const int jw = c * CN + warp * NCW;  // the warp's first n-tile
          const bool on = jw < nt;
          float acc[MT][NCW][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < NCW; ++j)
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
#pragma unroll 1
          for (int ksl = 0; ksl < nks; ++ksl) {
            qv_st_wait();     // this slab's copies (this thread's) landed
            __syncthreads();  // everyone's; the other slot is free
            issue(next, slot ^ 1);
            qv_st_commit();
            next = next + 1 == nslab ? 0 : next + 1;
            if (on) {
              const uint8_t* cur = sm + slot * slot_bytes;
              const int k0 = ksl * ks_slab, nk = min(ks_slab, kl - k0);
#pragma unroll 1
              for (int s = 0; s < nk; ++s) {
                typename P::A a[MT];
#pragma unroll
                for (int m = 0; m < MT; ++m)
                  a[m] = P::load_a(in, s_in, 16 * m, k0 + s, g, t);
#pragma unroll
                for (int j = 0; j < NCW; ++j) {
                  const typename P::B bj =
                      P::load_b(cur, s * CN + warp * NCW + j, lane);
#pragma unroll
                  for (int m = 0; m < MT; ++m)
                    P::mma_trunk(acc[m][j], a[m], bj);
                }
              }
            }
            slot ^= 1;
          }
          if (single && l > 0) __syncthreads();  // `in` is read: overwrite it
          if (on) {
#pragma unroll
            for (int j = 0; j < NCW; ++j)
#pragma unroll
              for (int m = 0; m < MT; ++m)
                P::store(out, sa, 16 * m + g, (jw + j) * 8 + 2 * t, acc[m][j],
                         b.layer_bias(l), act);
          }
        }
      }
      __syncthreads();  // the last layer's activations are written
      if (warp < MT)
        qv_st_head(P(), bufs[nb & 1], sa, b, up, 16 * warp, lane, hq, p * V);
    }
    __syncthreads();  // the round's heads are staged
    if (QUAD)
      qv_st_quad_round(consts, scratch, hq, n, v0r, mvg, rg, o0, o1, o2);
    else
      qv_st_write_q(hq, n, v0r, o0);
    __syncthreads();  // the heads are read
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Grid: as many blocks as the rounds need, at most as many as fit on the
// card at once; block must be the kernel's `threads`.
template <class Kernel, class... Args>
static int qv_st_launch(Kernel kernel, int threads, long long n, int block,
                        long long smem_bytes, void* stream, Args... args) {
  if (block != threads) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // cleared: the next launch would report it again
    return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, block, (size_t)smem_bytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long rounds = (n + QV_ST_ROUND - 1) / QV_ST_ROUND;
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(rounds < cap ? rounds : cap);
  kernel<<<grid, block, (size_t)smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// kernel<MT, NCW> for the plan's tile (ops/fused_infer.py::_ST_TILES).
#define QV_ST_DISPATCH(kernel, mt, ncw, ...)                         \
  switch (mt * 16 + ncw) {                                           \
    case 8 * 16 + 4:                                                 \
      return qv_st_launch(kernel<8, 4>, QV_ST_THREADS, __VA_ARGS__); \
    case 8 * 16 + 1:                                                 \
      return qv_st_launch(kernel<8, 1>, QV_ST_THREADS, __VA_ARGS__); \
    case 4 * 16 + 1:                                                 \
      return qv_st_launch(kernel<4, 1>, QV_ST_THREADS, __VA_ARGS__); \
    case 8 * 16 + 2:                                                 \
      return qv_st_launch(kernel<8, 2>, QV_ST_THREADS, __VA_ARGS__); \
    case 4 * 16 + 2:                                                 \
      return qv_st_launch(kernel<4, 2>, QV_ST_THREADS, __VA_ARGS__); \
    case 4 * 16 + 4:                                                 \
      return qv_st_launch(kernel<4, 4>, QV_ST_THREADS, __VA_ARGS__); \
    case 2 * 16 + 4:                                                 \
      return qv_st_launch(kernel<2, 4>, QV_ST_THREADS, __VA_ARGS__); \
    case 1 * 16 + 4:                                                 \
      return qv_st_launch(kernel<1, 4>, QV_ST_THREADS, __VA_ARGS__); \
    default:                                                         \
      return (int)cudaErrorInvalidValue;                             \
  }

// The C entries of one trunk: kernel B (means, vars, raw) and kernel C (q),
// the resident entries' arguments plus the plan's tile and slab.
#define QV_ST_ENTRIES(P, suffix)                                              \
  template <int MT, int NCW>                                                  \
  __global__ void __launch_bounds__(QV_ST_THREADS, QV_ST_MINB)                \
      qv_encode_quad_stream##suffix##_kernel(                                 \
          const float* __restrict__ x, long long n, int t_in, int cm,         \
          int mask, int se, int multi, int act, int up, int nb,               \
          const float* __restrict__ blob, int mvg, QvRanges r, int ks,        \
          float* __restrict__ means, float* __restrict__ vars,                \
          float* __restrict__ raw) {                                          \
    qv_st_body<P, MT, NCW, true>(x, n, t_in, cm, mask, se, multi, act, up,    \
                                 nb, blob, mvg, r, ks, means, vars, raw);     \
  }                                                                           \
  template <int MT, int NCW>                                                  \
  __global__ void __launch_bounds__(QV_ST_THREADS, QV_ST_MINB)                \
      qv_encode_q_stream##suffix##_kernel(                                    \
          const float* __restrict__ x, long long n, int t_in, int cm,         \
          int mask, int se, int multi, int act, int up, int nb,               \
          const float* __restrict__ blob, int ks, float* __restrict__ q) {    \
    qv_st_body<P, MT, NCW, false>(x, n, t_in, cm, mask, se, multi, act, up,   \
                                  nb, blob, 0, QvRanges{}, ks, q, nullptr,    \
                                  nullptr);                                   \
  }                                                                           \
  extern "C" int qv_encode_quad_stream##suffix(                               \
      const float* x, long long n, int t_in, int channel_major,              \
      int mask_channel, int se_idx, int multi_image, int act, int up,         \
      int nb, const float* blob, QvRanges r, float* means, float* vars,       \
      float* raw, int mvg, int mt, int ncw, int ks, int block,                \
      long long smem_bytes, void* stream) {                                   \
    QV_ST_DISPATCH(qv_encode_quad_stream##suffix##_kernel, mt, ncw, n, block, \
                   smem_bytes, stream, x, n, t_in, channel_major,             \
                   mask_channel, se_idx, multi_image, act, up, nb, blob, mvg, \
                   r, ks, means, vars, raw)                                   \
  }                                                                           \
  extern "C" int qv_encode_q1_stream##suffix(                                 \
      const float* x, long long n, int t_in, int channel_major,              \
      int mask_channel, int se_idx, int multi_image, int act, int up,         \
      int nb, const float* blob, float* q, int mt, int ncw, int ks,           \
      int block, long long smem_bytes, void* stream) {                        \
    QV_ST_DISPATCH(qv_encode_q_stream##suffix##_kernel, mt, ncw, n, block,    \
                   smem_bytes, stream, x, n, t_in, channel_major,             \
                   mask_channel, se_idx, multi_image, act, up, nb, blob, ks,  \
                   q)                                                         \
  }
