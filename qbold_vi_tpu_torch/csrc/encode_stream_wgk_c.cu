// Kernel C's entries of encode_stream_wgk.cu and its instantiations, in a
// source of its own so that nvcc builds them beside kernel B's.
#define QV_WGK_C
#include "encode_stream_wgk.cu"
