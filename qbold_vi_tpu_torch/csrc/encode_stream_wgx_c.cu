// Kernel C's entry of encode_stream_wgx.cu and its instantiations, in a
// source of its own so that nvcc builds them beside kernel B's.
#define QV_WGX_C
#include "encode_stream_wgx.cu"
