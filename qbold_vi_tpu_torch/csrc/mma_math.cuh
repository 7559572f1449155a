// Tensor-core products shared by the 3x3 trunk conv (conv3x3.cu, kernel H)
// and the stream-1 encode (encode_quad.cu, kernels B and C): float32-accurate
// products on Hopper's TF32 tensor cores (3xTF32) for the float32 trunk, and
// the bf16 rounding the bf16 trunk's activations take (kernels B, C and H
// at bf16 take wgmma: encode_quad_bf16.cu, conv3x3.cu).
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
// the thread's sums in float32 (round to nearest): in kernel H a running
// sum fed to the mma at every k-step gathered that bias to ~5e-6 of the
// largest output at the fine-tune fold, the fresh fragments keep it at
// ~4e-7.
//
// Fragments of mma.sync.m16n8k8 (TF32), lane = 4 g + t: A (16 x 8) holds
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8)
// b0 (t, g), b1 (t + 4, g); C / D (16 x 8) c0 (g, 2t), c1 (g, 2t + 1),
// c2 (g + 8, 2t), c3 (g + 8, 2t + 1). Both kernels give k-slots t and
// t + 4 of k-step s the channels 8 s + 2t and 8 s + 2t + 1 (any order of
// k within a step gives the same sum), so a thread's two A values of a
// row are adjacent and its B fragment is (b0, b1) = W(n = 8 j + g,
// k = 8 s + 2t, + 1): split once into hi / lo and stored as (b0 hi, b1 hi,
// b0 lo, b1 lo), one 16-byte load a lane.
//
// The build's --fmad=false leaves mma and the hi/lo subtraction alone:
// a - hi is exact.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// a rounded to TF32 (10 mantissa bits, nearest, ties away), as float bits:
// what cvt.rna.tf32.f32 gives for finite a, in two integer operations (half
// of the 13 dropped bits added to the sign-magnitude pattern, then dropped),
// which run faster here than the conversion instruction.
static __device__ __forceinline__ uint32_t qv_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

static __device__ __forceinline__ void qv_split(float a, uint32_t& hi,
                                                uint32_t& lo) {
  hi = qv_tf32(a);
  lo = qv_tf32(a - __uint_as_float(hi));
}

// d = a * b + c on one 16 x 8 x 8 TF32 fragment.
static __device__ __forceinline__ void qv_mma(float* d, const uint32_t* a,
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
static __device__ __forceinline__ void qv_mma3(float* d, const uint32_t* ahi,
                                               const uint32_t* alo,
                                               const uint32_t* bhi,
                                               const uint32_t* blo,
                                               bool first) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  qv_mma(d, alo, bhi[0], bhi[1], first ? zero : d);
  qv_mma(d, ahi, blo[0], blo[1], d);
  qv_mma(d, ahi, bhi[0], bhi[1], d);
}

// acc += d in float32, where the adds round to nearest: the sums of the
// fresh fragments.
static __device__ __forceinline__ void qv_add4(float* acc, const float* d) {
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] += d[k];
}

// ---- the bf16 trunk ----------------------------------------------------------

// a rounded to bf16 (nearest, ties to even), as a float
static __device__ __forceinline__ float qv_bf16(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}
