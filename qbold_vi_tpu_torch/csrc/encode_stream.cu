// Kernels B and C, streamed, float32 trunk (3xTF32): encode_stream.cuh's
// design instantiated with QvStF32; symbols qv_encode_quad_stream_kernel
// and qv_encode_q_stream_kernel, entries qv_encode_quad_stream and
// qv_encode_q1_stream (ops/fused_infer.py).

#include "encode_stream.cuh"

QV_ST_ENTRIES(QvStF32, )
