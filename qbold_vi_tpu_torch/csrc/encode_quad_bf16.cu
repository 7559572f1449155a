// Kernels B and C with the bf16 trunk: the fused stream-1 encode, alone (C)
// or followed by the quadrature posterior summaries (B), on wgmma.
//
// B replaces qbold_vi_tpu/ops/pallas_infer.py::encode_quad_fused and C
// encode_q1_packed (pallas_call at :353 and :246) under trunk="bfloat16";
// the float32 trunk's kernels are encode_quad.cu's. Per voxel, as the JAX
// kernel's _encode_body rounds (pallas_infer.py:98-133):
//   [mask] -> clip(1e-2, 1e8) -> divide by the spin-echo reference (one
//   image, or the mean of [max(se-1, 0), se+2)) -> log, in float32, then
//   rounded to bf16 -> Dense(T -> U) -> nb x Dense(U -> U), each layer's
//   float32 sums rounded to bf16, the bf16 bias added in bf16 and the
//   activation taken in bf16 (jax.nn's composition, qv_act_bf16) -> the
//   float32 head Dense(U -> 5) on the float32-cast bf16 features;
// then B runs quad_math.cuh's summaries and raw-log-std transforms and
// writes channel-major (3, N) means, variances and raw rows, and C writes
// q (5, N) (row 4 zero for a diagonal head).
//
// Bound: bytes at OPTIMAL (48 B read, 36 B (B) or 20 B (C) written a
// voxel; ~0.026 / 0.021 ms at 1.03 M voxels on the H100), the trunk's
// products 0.0164 ms at the dense bf16 peak.
//
// Design. The encode runs on warpgroups (128 threads) that each take tiles
// of 64 voxels.
// * The products are wgmma.m64nUpk16 (bf16, float32 sums) with A from
//   registers and B, the layer's weights, resident in shared memory. The
//   blob holds each layer as 8 x 8 core matrices; the block stages them
//   into the 32-byte swizzle (qv_e16_swz32: a k-step's 16 columns as
//   32-byte rows), one layout for every width (16-128) and for the first
//   layer's K of 16. Only B is read from shared memory (2 KB a k-step of
//   64 units); kernel H at bf16 reads A there too and saturates it.
//   (Without the swizzle, the core matrices as the blob holds them, the
//   kernels ran as fast on the H100: PERF.md.)
// * wgmma's accumulator layout is its A operand's register layout: pairs
//   4s .. 4s + 3 of a layer's sums are the A registers of k-step s of the
//   next. The epilogue works on packed pairs: one cvt.rn.bf16x2.f32
//   (bf16(sum)), one add.bf16x2 with the packed bias (correctly rounded,
//   as the float32 add of two bf16 values then rounded to bf16 is: 24 >=
//   2 * 8 + 2 bits), one max.bf16x2 with 0 for relu; the result is the
//   next A register, so the activations never leave registers and each is
//   converted once. Other activations unpack and take qv_act_bf16 per
//   element.
// * The head as three bf16 products: the host cuts each float32 head
//   weight into bf16 pieces w1 + w2 + w3 that sum to it exactly (top 8
//   significant bits, the next 8, the rest: ops/fused_infer.py::
//   _bf16_pieces) and the features, bf16 already, are A as they are.
//   w2 and w3's products go into one float32 sum, w1's into another, and
//   q = (w1 sum + the rest) + bias. 3xTF32 would take the same three
//   products' time at half the rate, one of them a product by zero.
// * Input by cp.async into a ring of two slots in shared memory, the next
//   slot's rows loading while this one's are multiplied (16-byte copies
//   where the rows allow it, 4-byte ones into the same layout otherwise:
//   channel-major at N % 4 != 0, an unaligned x; the ragged end
//   zero-filled). Each lane normalises its own A fragment's rows and
//   channels from the raw slot (8 logs a lane a k-step), so no normalised
//   row goes through shared memory. A producer warp was not taken: the
//   copies need no registers or waits of the warpgroups, and every thread
//   issues its share once a slot.
// * Persistent blocks of two warpgroups walk rounds of 256 voxels, two
//   tiles a warpgroup, and stage the round's heads; then the block, a
//   voxel a thread, writes q (C) or runs the quadrature summaries with
//   qv_quad_block's side sort over the block (B). B's tail and encode
//   overlap only across the blocks on an SM (three at Up <= 64). Tried
//   and dropped (PERF.md): the two warpgroups of a block each with
//   its own tiles and tail (the tails staggered), and a warp-specialised
//   B (an encode warpgroup filling head buffers for two tail warpgroups
//   over named barriers): both slower on the H100 (B 0.276-0.277 ms
//   against 0.22 at OPTIMAL's request); each warpgroup's chain of
//   dependent products and epilogues wants many warpgroups an SM.
//
// Weight blob (32-bit words, ops/fused_infer.py::_weight_blob(trunk=
// "bfloat16")): a 4-word tag (0x51564232, the layout's number, 0, 0), then
//   W0 image [ks0][Up/8][2][8][8] bf16   Wb images nb x [Up/16][Up/8][2][8][8]
//   Wf pieces 3 x [Up/16][1][2][8][8] (w1, w2, w3)
//   b0 [Up] bf16, bb [nb][Up] bf16, bf [8] float32, consts [QV_NCONST]
// (element (n, k) of a layer at ((s * Up/8 + n / 8) * 2 + k % 16 / 8) * 64
// + n % 8 * 8 + k % 8, s = k / 16). Shared memory, from a 1024-byte
// boundary: the blob past its tag (the images swizzled), the ring (2 x 256
// x t_in floats), the heads hq [5][256] and, in B, QV_QUAD_SCRATCH(256)
// floats (ops/fused_infer.py::_block_smem).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "encode_act.cuh"
#include "mma_math.cuh"
#include "quad_math.cuh"

#define QV_E16_THREADS 256  // two warpgroups
#define QV_E16_ROUND 256    // voxels a block round
#define QV_E16_TAG_WORDS 4
// blocks an SM the registers are sized for
#define QV_E16_MINB(up) ((up) <= 64 ? 3 : 2)

// ---- PTX --------------------------------------------------------------------

static __device__ __forceinline__ uint32_t qv_e16_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// Asynchronous copies of 16 bytes (src_bytes of them read, the rest zero)
// or 4 bytes (on: read, else zero).
static __device__ __forceinline__ void qv_e16_cp16(uint32_t dst,
                                                   const void* src,
                                                   int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
static __device__ __forceinline__ void qv_e16_cp4(uint32_t dst,
                                                  const void* src, bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 4 : 0)
               : "memory");
}
static __device__ __forceinline__ void qv_e16_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most one of this thread's copy groups is pending.
static __device__ __forceinline__ void qv_e16_wait_copies() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// This thread's shared-memory writes made visible to wgmma's reads.
static __device__ __forceinline__ void qv_e16_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
static __device__ __forceinline__ void qv_e16_wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void qv_e16_wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
static __device__ __forceinline__ void qv_e16_wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving a use of the sums across the points where
// the tensor cores own them.
template <int NR>
static __device__ __forceinline__ void qv_e16_fence_sums(float* d) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major operand at shared address a (256-byte aligned)
// in the 32-byte swizzle: a k-step's 16 columns as 32-byte rows, the two
// 16-byte halves of row n swapped where bit 2 of n is set, 8-row groups
// SBO = 256 B apart (layout 3; LBO unused).
static __device__ __forceinline__ uint64_t qv_e16_desc(uint32_t a) {
  return (uint64_t)((a & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

// Shared byte offset of 16-byte piece q of a blob image of n-row k-steps
// (piece ((s * n/8 + n / 8) * 2 + kh) * 8 + n % 8 of the core-matrix
// image) in the 32-byte swizzle: row n of k-step s at s * 32 n + 32 n, its
// half kh at 16 (kh ^ (n >> 2 & 1)).
static __device__ __forceinline__ uint32_t qv_e16_swz32(int q, int n) {
  const int s = q / (2 * n), rem = q - s * 2 * n;
  const int row = (rem >> 4) * 8 + (rem & 7), kh = (rem >> 3) & 1;
  return (uint32_t)(s * n * 32 + row * 32 + ((kh ^ ((row >> 2) & 1)) << 4));
}

// d (64 x N float32 sums) (+)= a * b: a (64 x 16 bf16) in registers, warp
// w of the warpgroup holding rows 16 w .. 16 w + 15 as mma.m16n8k16's A
// fragment (a0 (g, 2t | 2t + 1), a1 (g + 8, ..), a2 (g, 2t + 8 | 2t + 9),
// a3 (g + 8, ..), lane = 4 g + t); b (16 x N) by descriptor, K-major.
// Thread (w, 4 g + t) holds d[4 j + 2 hh + i] = D(16 w + g + 8 hh,
// 8 j + 2 t + i). acc == 0: d = a * b.
template <int N>
struct QvWg;

template <>
struct QvWg<8> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct QvWg<16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct QvWg<32> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct QvWg<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

template <>
struct QvWg<128> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                             uint64_t desc, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
};

// ---- the encode -------------------------------------------------------------

static __device__ __forceinline__ uint32_t qv_e16_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage `rows` rows of `len` floats (global rows g + r * gstride, the first
// `valid` of each read, the rest zero) at shared address sa, row r at
// sa + 4 r len: 16-byte copies (vec: g and gstride 16-byte aligned, len a
// multiple of 4) or 4-byte ones. Issued by the whole block.
static __device__ __forceinline__ void qv_e16_stage(
    uint32_t sa, const float* __restrict__ g, long long gstride, int rows,
    int len, int valid, bool vec) {
  if (vec) {
    const int per = len >> 2;
    for (int e = threadIdx.x; e < rows * per; e += blockDim.x) {
      const int r = e / per, i = e - r * per;
      const int k = min(max(valid - 4 * i, 0), 4);
      qv_e16_cp16(sa + (uint32_t)(r * len + 4 * i) * 4u,
                  k ? g + r * gstride + 4 * i : g, 4 * k);
    }
  } else {
    for (int e = threadIdx.x; e < rows * len; e += blockDim.x) {
      const int r = e / len, i = e - r * len;
      const bool on = i < valid;
      qv_e16_cp4(sa + (uint32_t)(r * len + i) * 4u,
                 on ? g + r * gstride + i : g, on);
    }
  }
}

// A round's staged raw rows: voxel r's channel c at slot[c * 256 + r]
// (channel-major) or slot[r * t_in + c] (voxel-major).
struct QvE16Rows {
  const float* slot;
  int t_in, cm, T, se, multi, lo, hi, mask;
  __device__ __forceinline__ float raw(int r, int c) const {
    return cm ? slot[c * QV_E16_ROUND + r] : slot[r * t_in + c];
  }
  // [mask] and clip, as kernel C's float32 staging
  __device__ __forceinline__ float clipped(int r, int c, float m) const {
    return fminf(fmaxf(raw(r, c) * m, 1e-2f), 1e8f);
  }
  __device__ __forceinline__ float mask_of(int r) const {
    return mask ? raw(r, T) : 1.0f;
  }
  __device__ __forceinline__ float reference(int r, float m) const {
    if (!multi) return clipped(r, se, m);
    float sum = 0.0f;
    for (int t = lo; t < hi; ++t) sum += clipped(r, t, m);
    return sum / (float)(hi - lo);
  }
  // the normalised log signal, 0 past T
  __device__ __forceinline__ float norm(int r, int c, float m,
                                        float ref) const {
    return c < T ? logf(clipped(r, c, m) / ref) : 0.0f;
  }
};

// a[p] = act(bf16(bf16(acc pair p) + bias pair)) as the next A register,
// pair p = (acc[2p], acc[2p + 1]) at channels 8 (p >> 1) + 2t, + 1.
template <int UP>
static __device__ __forceinline__ void qv_e16_epilogue(
    const float* acc, const uint32_t* bias, int t, int act, uint32_t* a) {
  if (act == 0) {
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.0f, 0.0f);
#pragma unroll
    for (int p = 0; p < UP / 4; ++p) {
      const uint32_t bw = bias[4 * (p >> 1) + t];
      const __nv_bfloat162 v = __hmax2(
          __hadd2(__floats2bfloat162_rn(acc[2 * p], acc[2 * p + 1]),
                  *reinterpret_cast<const __nv_bfloat162*>(&bw)),
          zero);
      a[p] = *reinterpret_cast<const uint32_t*>(&v);
    }
  } else {
#pragma unroll
    for (int p = 0; p < UP / 4; ++p) {
      const uint32_t bw = bias[4 * (p >> 1) + t];
      const float2 f = __bfloat1622float2(
          __hadd2(__floats2bfloat162_rn(acc[2 * p], acc[2 * p + 1]),
                  *reinterpret_cast<const __nv_bfloat162*>(&bw)));
      a[p] = qv_e16_pack(qv_act_bf16(act, f.x), qv_act_bf16(act, f.y));
    }
  }
}

// The staged weights: shared addresses of the swizzled images, the
// biases, the head's bias and the node table.
struct QvE16Weights {
  uint32_t w0, wb, wf;
  const uint32_t *b0, *bb;
  const float *bf, *consts;
  int ks0, nb, act;
};

// Stage the blob past its tag at sm (1024-byte aligned, for the swizzle's
// address bits), by the whole block: the images swizzled -- the trunk's
// (UP rows), then the head's three pieces (8 rows) -- the biases and the
// node table as they are. Returns the layout; the caller fences and
// synchronises.
template <int UP>
static __device__ __forceinline__ QvE16Weights qv_e16_stage_weights(
    uint8_t* sm, const float* __restrict__ blob, int words, int T, int nb,
    int act) {
  QvE16Weights W;
  W.ks0 = (T + 15) >> 4;
  W.nb = nb;
  W.act = act;
  const float4* src = reinterpret_cast<const float4*>(blob + QV_E16_TAG_WORDS);
  const int trunk_q = (W.ks0 + nb * (UP / 16)) * UP * 2;
  const int head_q = 3 * (UP / 16) * 16;
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x) {
    const uint32_t dst =
        i < trunk_q ? qv_e16_swz32(i, UP)
        : i < trunk_q + head_q ? 16 * trunk_q + qv_e16_swz32(i - trunk_q, 8)
                               : 16u * i;
    *reinterpret_cast<float4*>(sm + dst) = src[i];
  }
  W.w0 = qv_e16_addr(sm);
  W.wb = W.w0 + W.ks0 * UP * 32;
  W.wf = W.wb + nb * UP * UP * 2;
  W.b0 = reinterpret_cast<const uint32_t*>(sm + (W.wf - W.w0) + 48 * UP);
  W.bb = W.b0 + UP / 2;
  W.bf = reinterpret_cast<const float*>(W.bb + nb * (UP / 2));
  W.consts = W.bf + 8;
  return W;
}

// The raw heads of a tile of 64 voxels (rows 0-63 of `rows`, warp w of the
// warpgroup encoding rows 16 w + g and + 8, lane 4 g + t) into
// hq[c * 256 + row].
template <int UP>
static __device__ __forceinline__ void qv_e16_encode_tile(
    const QvE16Weights& W, const QvE16Rows& rows, int warp, int g, int t,
    float* hq) {
  const int ra = warp * 16 + g, rc = ra + 8;
  float acc[UP / 2];
  uint32_t a[UP / 4];
  {  // layer 0 from the raw rows, a k-step at a time
    const float ma = rows.mask_of(ra), mc = rows.mask_of(rc);
    const float fa = rows.reference(ra, ma), fc = rows.reference(rc, mc);
#pragma unroll 1
    for (int ks = 0; ks < W.ks0; ++ks) {
      const int c = 16 * ks + 2 * t;
      uint32_t a0[4];
      a0[0] = qv_e16_pack(rows.norm(ra, c, ma, fa),
                          rows.norm(ra, c + 1, ma, fa));
      a0[1] = qv_e16_pack(rows.norm(rc, c, mc, fc),
                          rows.norm(rc, c + 1, mc, fc));
      a0[2] = qv_e16_pack(rows.norm(ra, c + 8, ma, fa),
                          rows.norm(ra, c + 9, ma, fa));
      a0[3] = qv_e16_pack(rows.norm(rc, c + 8, mc, fc),
                          rows.norm(rc, c + 9, mc, fc));
      qv_e16_fence_sums<UP / 2>(acc);
      qv_e16_wg_fence();
      QvWg<UP>::mma(acc, a0, qv_e16_desc(W.w0 + ks * UP * 32), ks > 0);
      qv_e16_wg_commit();
      qv_e16_wg_wait();
      qv_e16_fence_sums<UP / 2>(acc);
    }
  }
  qv_e16_epilogue<UP>(acc, W.b0, t, W.act, a);
#pragma unroll 1
  for (int i = 0; i < W.nb; ++i) {
    const uint32_t wi = W.wb + i * UP * UP * 2;
    qv_e16_wg_fence();
#pragma unroll
    for (int ks = 0; ks < UP / 16; ++ks)
      QvWg<UP>::mma(acc, a + 4 * ks, qv_e16_desc(wi + ks * UP * 32), ks > 0);
    qv_e16_wg_commit();
    qv_e16_wg_wait();
    qv_e16_fence_sums<UP / 2>(acc);
    qv_e16_epilogue<UP>(acc, W.bb + i * (UP / 2), t, W.act, a);
  }
  // the head: w3 and w2's products in one sum, w1's in another, in the
  // spent trunk sums' registers
  float* h1 = acc;
  float* h23 = acc + 4;
  qv_e16_wg_fence();
#pragma unroll
  for (int ks = 0; ks < UP / 16; ++ks)
    QvWg<8>::mma(h23, a + 4 * ks, qv_e16_desc(W.wf + 32 * UP + 256 * ks),
                 ks > 0);
#pragma unroll
  for (int ks = 0; ks < UP / 16; ++ks)
    QvWg<8>::mma(h23, a + 4 * ks, qv_e16_desc(W.wf + 16 * UP + 256 * ks), 1);
#pragma unroll
  for (int ks = 0; ks < UP / 16; ++ks)
    QvWg<8>::mma(h1, a + 4 * ks, qv_e16_desc(W.wf + 256 * ks), ks > 0);
  qv_e16_wg_commit();
  qv_e16_wg_wait();
  qv_e16_fence_sums<4>(h1);
  qv_e16_fence_sums<4>(h23);
  // q (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int col = 2 * t + (i & 1), row = i < 2 ? ra : rc;
    if (col < 5) hq[col * QV_E16_ROUND + row] = (h1[i] + h23[i]) + W.bf[col];
  }
}

// The kernels' body: persistent blocks of two warpgroups walk rounds of
// 256 voxels, each warpgroup encoding two tiles of 64 a round while the
// next round's rows load, and stage the round's heads (hq [5][256]). Then
// the whole block, a voxel a thread: kernel C (QUAD false) writes q
// (5, N) to o0; kernel B runs the quadrature summaries (qv_quad_block's
// side sort over the block) and writes means, vars and raw (3, N) to o0,
// o1, o2.
template <int UP, bool QUAD>
static __device__ __forceinline__ void qv_e16_body(
    const float* __restrict__ x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int nb,
    const float* __restrict__ blob, int blob_len, int mvg, QvRanges rg,
    float* __restrict__ o0, float* __restrict__ o1,
    float* __restrict__ o2) {
  extern __shared__ float4 qv_e16_smem[];
  const int words = blob_len - QV_E16_TAG_WORDS;
  uint8_t* sm = reinterpret_cast<uint8_t*>(qv_e16_smem);
  sm += (1024u - (qv_e16_addr(sm) & 1023u)) & 1023u;  // the next 1 KB boundary
  const QvE16Weights W = qv_e16_stage_weights<UP>(
      sm, blob, words, t_in - mask_channel, nb, act);
  float* ring = reinterpret_cast<float*>(sm + 4 * words);
  const int slot = QV_E16_ROUND * t_in;
  float* hq = ring + 2 * slot;
  float* scratch = hq + 5 * QV_E16_ROUND;
  qv_e16_fence_async();
  __syncthreads();

  const bool vec =
      ((uintptr_t)x & 15u) == 0 && (!channel_major || (n & 3) == 0);
  const long long rounds = (n + QV_E16_ROUND - 1) / QV_E16_ROUND;
  auto issue = [&](long long rnd, int s) {
    const long long v0 = rnd * QV_E16_ROUND;
    const int nv = (int)min((long long)QV_E16_ROUND, n - v0);
    const uint32_t sa = qv_e16_addr(ring + s * slot);
    if (channel_major)
      qv_e16_stage(sa, x + v0, n, t_in, QV_E16_ROUND, nv, vec);
    else
      qv_e16_stage(sa, x + v0 * t_in, 0, 1, slot, nv * t_in, vec);
  };

  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int wg = threadIdx.x >> 7, g = lane >> 2, t = lane & 3;
  QvE16Rows rows;
  rows.t_in = t_in;
  rows.cm = channel_major;
  rows.T = t_in - mask_channel;
  rows.se = se_idx;
  rows.multi = multi_image;
  rows.lo = se_idx - 1 > 0 ? se_idx - 1 : 0;
  rows.hi = se_idx + 2 < rows.T ? se_idx + 2 : rows.T;
  rows.mask = mask_channel;
  long long rnd = blockIdx.x;
  if (rnd < rounds) issue(rnd, 0);
  qv_e16_commit();
#pragma unroll 1
  for (int s = 0; rnd < rounds; rnd += gridDim.x, s ^= 1) {
    if (rnd + gridDim.x < rounds) issue(rnd + gridDim.x, s ^ 1);
    qv_e16_commit();
    qv_e16_wait_copies();  // this round's rows have landed
    __syncthreads();
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {  // the warpgroup's two tiles
      const int base = wg * 128 + k * 64;
      rows.slot = ring + s * slot + (channel_major ? base : base * t_in);
      qv_e16_encode_tile<UP>(W, rows, warp, g, t, hq + base);
    }
    __syncthreads();  // the round's heads are staged; its rows are read
    const long long v = rnd * QV_E16_ROUND + threadIdx.x;
    const bool live = v < n;
    const float* q = hq + threadIdx.x;
    if (QUAD) {
      float rw[3];
      const QvQuadIn in =
          qv_quad_squash(q[0], q[QV_E16_ROUND], q[2 * QV_E16_ROUND],
                         q[3 * QV_E16_ROUND], q[4 * QV_E16_ROUND], mvg != 0,
                         rw);
      float o[8], gm[5], D1, D2;
      qv_quad_block(W.consts, scratch, live, in, o, &D1, &D2, gm);
      if (live) {
        float m[3], sv[3];
        qv_quad_combine(o, D1, D2, gm, in.od, rg, m, sv);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          o0[(long long)j * n + v] = m[j];
          o1[(long long)j * n + v] = sv[j];
          o2[(long long)j * n + v] = rw[j];
        }
      }
    } else if (live) {
#pragma unroll
      for (int j = 0; j < 5; ++j)
        o0[(long long)j * n + v] = q[j * QV_E16_ROUND];
    }
  }
}


#define QV_E16_ARGS                                                           \
  const float *__restrict__ x, long long n, int t_in, int channel_major,      \
      int mask_channel, int se_idx, int multi_image, int act, int nb,         \
      const float *__restrict__ blob, int blob_len

// Kernels B and C at bf16, one symbol each, so that a profile and the SASS
// tell them from the float32 trunk's.
template <int UP>
__global__ void __launch_bounds__(QV_E16_THREADS, QV_E16_MINB(UP))
    qv_encode_quad_bf16_kernel(QV_E16_ARGS, int mvg, QvRanges r,
                               float* __restrict__ means,
                               float* __restrict__ vars,
                               float* __restrict__ raw) {
  qv_e16_body<UP, true>(x, n, t_in, channel_major, mask_channel, se_idx,
                        multi_image, act, nb, blob, blob_len, mvg, r, means,
                        vars, raw);
}

template <int UP>
__global__ void __launch_bounds__(QV_E16_THREADS, QV_E16_MINB(UP))
    qv_encode_q_bf16_kernel(QV_E16_ARGS, float* __restrict__ q) {
  qv_e16_body<UP, false>(x, n, t_in, channel_major, mask_channel, se_idx,
                         multi_image, act, nb, blob, blob_len, 0, QvRanges{},
                         q, nullptr, nullptr);
}

// Launch `threads` a block (the kernel's) on as many blocks as the rounds
// need, at most as many as fit on the card at once (the weights are
// staged once a resident block).
template <class Kernel, class... Args>
static int qv_e16_launch(Kernel kernel, int threads, long long n, int block,
                         long long smem_bytes, void* stream, Args... args) {
  if (block != threads) return (int)cudaErrorInvalidValue;
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
  const long long rounds = (n + QV_E16_ROUND - 1) / QV_E16_ROUND;
  const long long cap = (long long)sms * per_sm;
  const int grid = (int)(rounds < cap ? rounds : cap);
  kernel<<<grid, block, (size_t)smem_bytes, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

#define QV_E16_DISPATCH(kernel, threads, up, ...)             \
  switch (up) {                                               \
    case 16:                                                  \
      return qv_e16_launch(kernel<16>, threads, __VA_ARGS__);  \
    case 32:                                                  \
      return qv_e16_launch(kernel<32>, threads, __VA_ARGS__);  \
    case 64:                                                  \
      return qv_e16_launch(kernel<64>, threads, __VA_ARGS__);  \
    case 128:                                                 \
      return qv_e16_launch(kernel<128>, threads, __VA_ARGS__); \
    default:                                                  \
      return (int)cudaErrorInvalidValue;                      \
  }

// Kernels B and C at bf16: the float32 entries' arguments (encode_quad.cu),
// with ops/fused_infer.py::_weight_blob's bf16 layout of the blob; block
// must be QV_E16_THREADS and smem_bytes the layout's (_block_smem).
extern "C" int qv_encode_quad_fused_bf16(
    const float* x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int u, int up,
    int nb, const float* blob, int blob_len, QvRanges r, float* means,
    float* vars, float* raw, int mvg, int block, long long smem_bytes,
    void* stream) {
  (void)u;
  QV_E16_DISPATCH(qv_encode_quad_bf16_kernel, QV_E16_THREADS, up, n, block,
                  smem_bytes, stream, x, n, t_in, channel_major,
                  mask_channel, se_idx, multi_image, act, nb, blob, blob_len,
                  mvg, r, means, vars, raw)
}

extern "C" int qv_encode_q1_bf16(const float* x, long long n, int t_in,
                                 int channel_major, int mask_channel,
                                 int se_idx, int multi_image, int act, int up,
                                 int nb, const float* blob, int blob_len,
                                 float* q, int block, long long smem_bytes,
                                 void* stream) {
  QV_E16_DISPATCH(qv_encode_q_bf16_kernel, QV_E16_THREADS, up, n, block,
                  smem_bytes, stream, x, n, t_in, channel_major,
                  mask_channel, se_idx, multi_image, act, nb, blob, blob_len,
                  q)
}
