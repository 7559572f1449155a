// Kernels B and C, streamed, float32 trunk (3xTF32) past a padded width of
// 832 (encode_stream_wg.cu serves the float32 trunk up to 256,
// encode_stream_wgc.cu at 320 and 384, where a pass of 128 voxels fits,
// encode_stream_wgx.cu at 448-832, and this kernel where its block does
// not fit):
// encode_stream.cuh's design instantiated with QvStF32; symbols
// qv_encode_quad_stream_kernel and qv_encode_q_stream_kernel, entries
// qv_encode_quad_stream and qv_encode_q1_stream (ops/fused_infer.py).

#include "encode_stream.cuh"

QV_ST_ENTRIES(QvStF32, )
