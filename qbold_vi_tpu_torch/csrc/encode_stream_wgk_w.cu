// Kernel B's windowed-rows entries of encode_stream_wgk.cu and their
// instantiations (qv_encode_quad_wgk_w, qv_encode_wgk_clusters_w), in a
// source of their own so that nvcc builds them beside the others.
#define QV_WGK_W
#include "encode_stream_wgk.cu"
