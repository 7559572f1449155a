// The activations of kernels B and C (encode_quad.cu, encode_quad_bf16.cu
// and the streamed encode_stream*.cu): float32 (qv_act) and jax.nn's bf16
// step compositions (qv_act_bf16).
#pragma once

#include <cuda_bf16.h>

#include "mma_math.cuh"

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

static __device__ __noinline__ float qv_act_call(int act, float x) {
  return qv_act(act, x);
}

// jax.nn's activations on a bf16 x, each step rounded to bf16 as the JAX
// package's bf16 arithmetic rounds it (the constants rounded to bf16 first,
// as JAX's weak-typed Python floats are); the result is bf16. Codes:
// ops/fused_infer.py::SUPPORTED_ACTS order.
static __device__ __noinline__ float qv_act_bf16(int act, float x) {
  switch (act) {
    case 0:  // relu
      return fmaxf(x, 0.0f);
    case 1: {  // gelu, tanh approximation
      const float x3 = qv_bf16(qv_bf16(x * x) * x);
      const float inner =
          qv_bf16(0.796875f * qv_bf16(x + qv_bf16(0.044677734375f * x3)));
      const float cdf = qv_bf16(0.5f * qv_bf16(1.0f + qv_bf16(tanhf(inner))));
      return qv_bf16(x * cdf);
    }
    case 2:
      return qv_bf16(tanhf(x));
    case 3:  // sigmoid: 1 / (1 + exp(-x))
      return qv_bf16(1.0f / qv_bf16(1.0f + qv_bf16(expf(-x))));
    case 4:  // softplus = logaddexp(x, 0)
      return qv_bf16(fmaxf(x, 0.0f) +
                     qv_bf16(log1pf(qv_bf16(expf(-fabsf(x))))));
    case 5:  // elu, alpha 1
      return x > 0.0f ? x : qv_bf16(expm1f(x));
    case 6:  // silu
    case 7: {  // swish
      const float sg = qv_bf16(1.0f / qv_bf16(1.0f + qv_bf16(expf(-x))));
      return qv_bf16(x * sg);
    }
    case 8:  // leaky_relu, slope 0.01 in bf16
      return x >= 0.0f ? x : qv_bf16(0.010009765625f * x);
    case 9:  // relu6
      return fminf(fmaxf(x, 0.0f), 6.0f);
    default:  // linear
      return x;
  }
}
