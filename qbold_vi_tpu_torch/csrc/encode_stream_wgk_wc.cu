// Kernel C's windowed-rows entries of encode_stream_wgk.cu and their
// instantiations (qv_encode_q1_wgk_w, qv_encode_wgk_clusters_q1_w), in a
// source of their own so that nvcc builds them beside the others.
#define QV_WGK_W
#define QV_WGK_C
#include "encode_stream_wgk.cu"
