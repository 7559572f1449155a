// Kernels B and C, streamed, bf16 trunk: encode_stream.cuh's design
// instantiated with QvStBf16; symbols qv_encode_quad_stream_bf16_kernel
// and qv_encode_q_stream_bf16_kernel, entries qv_encode_quad_stream_bf16
// and qv_encode_q1_stream_bf16 (ops/fused_infer.py).

#include "encode_stream.cuh"

QV_ST_ENTRIES(QvStBf16, _bf16)
