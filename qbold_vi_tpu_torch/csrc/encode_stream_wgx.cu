// Kernels B and C, float32 trunk, past a padded width of 384 (Up 448 to
// 768: 385-768 units at any depth), where a pass of 128 voxels no longer
// fits in shared memory (its activation rows alone take 233,472 B at 448):
// encode_stream_wg.cu's block with each layer's output columns split
// between its two consumer warpgroups, which share a pass of 64 voxels.
//
// It replaces the same TPU kernels as encode_quad.cu and encode_stream.cuh
// (qbold_vi_tpu/ops/pallas_infer.py::encode_quad_fused, pallas_call at :353,
// and encode_q1_packed, at :246) and computes what they compute: the
// normalised log signal, the dense chain in 3xTF32 (float32-accurate),
// the float32 head, then B's quadrature summaries or C's q (5, N), rounding
// where encode_stream_wg.cu rounds. ops/fused_infer.py::launch_plan takes
// it for the float32 trunk at Up 448-768 wherever its block fits;
// encode_stream_wgk.cu's cluster of such blocks serves 832-1472 (at 832
// this block fits only in 16-column pieces, which ran 2.9-3.1x slower on
// the H100; at 896 its activation rows alone exceed the card's 232,448 B).
// On many taus the staged rows share the activation rows (RW 1), a window
// at a time where a row is wider than an activation row (RW 2).
//
// Bound: at 448 units x 1 block the 3xTF32 products take 2.60 ms of a
// 1.03 M-voxel request at the dense TF32 peak; the request's bytes 0.026
// ms. A design adds the weights' reads from L2: every pass of V voxels
// reads all the trunk's weights (hi and lo), 1.73 MB at 448 x 1, ~27.9 GB a
// request at V = 64 and twice that at the 32 voxels a pass of the
// float32 streamed plan there (retired; two activation buffers of 64
// voxels do not fit), which also ran every layer as two chunks of 256
// outputs on mma.sync.
//
// Design. encode_stream_wg.cu's block -- two consumer warpgroups, a
// producer warpgroup that fills a ring of slabs by cp.async.bulk with full
// / empty mbarriers and keeps 40 registers by setmaxnreg, 3xTF32 wgmma with
// A in registers -- with these changes:
// * Both consumer warpgroups take the same 64 voxels (warp w of each A's
//   rows 16 w .. 16 w + 15), warpgroup wg the output columns wg Up / 2 ..
//   (wg + 1) Up / 2 - 1 of every layer, in NCH chunks of CN <= 256 (one
//   wgmma.m64nCNk8 product each a k-step and TF32 part, from the same A
//   registers); each thread's sums are Up / 4 floats (112 at 448), live
//   until the layer's last k-step. So each read of the weights serves 64
//   voxels, not 32, and one activation buffer of 64 x (Up + 8) floats
//   holds the pass (116,736 B at 448).
// * A thread's A registers are no longer the channels it wrote: a layer's
//   inputs were written by both warpgroups. A named barrier between them
//   ends each layer's products before its outputs overwrite its inputs,
//   and another ends the outputs before the next layer reads them.
// * A slab is one k-step of chunk c of both halves: two pieces of 64 CN
//   bytes (hi then lo), each contiguous in the image
//   (ops/fused_infer.py::_wg_image with cn: a layer's 2 NCH chunks first,
//   warpgroup wg's chunk c the image's chunk wg NCH + c), two bulk copies
//   to one full barrier; each warpgroup's descriptors read its piece, and
//   a lane of each of the 8 consumer warps releases the slot. The walk
//   takes a k-step's chunks in turn.
// * The staged rows have their own buffer: after a pass's last layer
//   warpgroup 0 computes the pass's heads (qv_st_head, 16 rows a warp)
//   while warpgroup 1 stages the next pass's rows (16 a warp, the next
//   round's first pass after a round's last), and the barrier that opens
//   a pass publishes both.
// * Or (RW 1, the plan's shared rows: many taus, where a buffer of 64
//   staged rows does not fit beside the block) the staged rows share the
//   activation rows, in their first 8 ks0 columns: both warpgroups read
//   them in the first layer, so its epilogue waits on the named barrier as
//   every later layer's does; warpgroup 1 stages the next pass once the
//   heads have read the last activations (a barrier more a pass), and the
//   next round's first pass after the round's quadrature has read its
//   scratch.
// * Or (RW 2, the plan's windowed rows: a staged row of 8 ks0 channels
//   wider than the activation row) the rows are staged a window at a time:
//   the channels of k-steps k .. k + Up / 8 - 1 in the first Up columns,
//   before the first layer's k-step k, by every lane of both warpgroups
//   (warp w of each half of the channels of its rows 16 w .. 16 w + 15,
//   qv_st_stage_window; a row's reference and mask value computed once a
//   pass in registers). Both warpgroups read every row, so the
//   named barrier runs before a window is replaced and after it is
//   staged; the first window after the pass's opening barrier, which
//   follows the last heads and the round's quadrature. The outputs are the
//   shared rows' bit for bit; the block's shared memory does not depend on
//   the taus.
// * Rounds of 256 voxels (four passes) then B's quadrature or C's q, as in
//   encode_stream_wg.cu, on named barrier 1; B's scratch in the activation
//   rows, idle between a round's last head and its next pass's first
//   epilogue.
// On the H100 (PERF.md) a cluster of two such CTAs that multicast each
// slab (half the L2 reads) ran 1% faster at 448 x 1 and 4-5% at 448 x 2;
// a slab's products kept in flight under the next slab's, a head in
// four interleaved sums or with its fragments loaded ahead ran no faster:
// the block stays one CTA. Without its heads it ran 8% faster. The ring's
// slots and the chunk width are the plan's (three slots ran 12-13% faster
// at 512 and 704, slower at 448).
// Shared memory (ops/fused_infer.py::_wgx_smem, in this order):
//   mbarriers (QV_WG_BAR_BYTES) | ring stages x 2 x 64 CN bytes |
//   activations 64 x (Up + 8) floats | rows 64 x SX floats (none with RW
//   1 or 2)
//   | heads 5 x 256 floats | [B: node table QV_NCONST; the quadrature's
//   scratch in the activations]
// (SX: QvStF32::x_stride of the first layer's k-steps.) The PTX helpers and
// the m64nNk8 products are encode_stream_wg.cuh's. This file compiles
// kernel B's entry; encode_stream_wgx_c.cu compiles it again with
// QV_WGX_C for kernel C's, so that nvcc builds the two sets of
// instantiations side by side (one process a source).

#include "encode_stream_wg.cuh"

#define QV_WGX_PASS 64  // voxels a pass, both consumer warpgroups'

// ---- the encode -------------------------------------------------------------

// CN: the output columns of a product (Up / (2 CN) chunks a warpgroup);
// RW: the staged rows, 0 a buffer of their own, 1 in the activation rows,
// 2 there a window at a time (header).
template <int UP, int CN, int RW, bool QUAD>
static __device__ __forceinline__ void qv_wgx_body(
    const float* __restrict__ x, long long n, int t_in, int cm, int mask,
    int se, int multi, int act, int nb, const float* __restrict__ blob,
    const float* __restrict__ image, int mvg, QvRanges rg, int stages,
    float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2) {
  constexpr int HALF = UP / 2, NCH = HALF / CN;
  static_assert(HALF % CN == 0 && CN % 8 == 0 && CN <= 256, "chunk width");
  constexpr int PB = 64 * CN;  // bytes of a piece: a chunk's k-step, hi, lo
  constexpr int SA = UP + 8, PASS = QV_WGX_PASS;
  constexpr bool SH = RW != 0;  // the rows in the activation rows
  constexpr int WK = UP / 8;    // k-steps a window
  static_assert(PASS * SA >= QV_QUAD_SCRATCH(QV_ST_ROUND), "scratch");
  extern __shared__ float4 qv_wg_smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(qv_wg_smem);
  const int T = t_in - mask;
  const int ks0 = (T + 7) / 8, ksh = UP / 8;
  const int sx = QvStF32::x_stride(ks0);
  const int s0 = NCH * ks0, sh = NCH * ksh;  // slabs of a layer
  const int nslab = s0 + nb * sh, slab_bytes = 2 * PB;
  const uint32_t full = qv_wg_addr(sm), empty = full + 8 * stages;
  uint8_t* ring = sm + QV_WG_BAR_BYTES;
  float* acts = reinterpret_cast<float*>(ring + stages * slab_bytes);
  float* xss = acts + PASS * SA;
  float* hq = xss + (SH ? 0 : PASS * sx);
  float* consts = hq + 5 * QV_ST_ROUND;
  float* scratch = acts;
  const QvStBlob b = qv_st_blob<QvStF32>(blob, UP, nb, ks0);
  if (QUAD) qv_stage_consts(b.consts, consts);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      qv_wg_bar_init(full + 8 * s, 1);   // the producer's arrival + bytes
      qv_wg_bar_init(empty + 8 * s, 8);  // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long rounds = (n + QV_ST_ROUND - 1) / QV_ST_ROUND;
  // the warpgroup, warp-uniform as the compiler sees it (a wgmma in a
  // branch it takes for divergent is serialised)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (wg == QV_WG_CONSUMERS / 128) {
    // the producer: one lane walks every pass's slabs into the ring
    qv_wg_setmaxnreg_dec<QV_WG_PRODUCER_REGS>();
    if (threadIdx.x != QV_WG_CONSUMERS) return;
    const uint8_t* img = reinterpret_cast<const uint8_t*>(image);
    int slot = 0;
    uint32_t phase = 0;
#pragma unroll 1
    for (long long rnd = blockIdx.x; rnd < rounds; rnd += gridDim.x) {
      const int passes =
          (int)min((long long)(QV_ST_ROUND / PASS),
                   (n - rnd * QV_ST_ROUND + PASS - 1) / PASS);
#pragma unroll 1
      for (int i = 0; i < passes * nslab; ++i) {
        // slab j of the pass: chunk c of k-step k of layer l (k-step by
        // k-step, a k-step's chunks in order), whose image starts at the
        // trunk's k-step ls; warpgroup 1's piece is the image's chunk
        // NCH + c
        const int j = i % nslab;
        int kl = ks0, r = j, ls = 0;
        if (j >= s0) {
          const int l = (j - s0) / sh;
          kl = ksh;
          r = j - s0 - l * sh;
          ls = ks0 + l * ksh;
        }
        const int c = r % NCH, k = r / NCH;
        const uint8_t* src = img + (long long)ls * 64 * UP;
        const uint32_t dst = qv_wg_addr(ring + slot * slab_bytes);
        qv_wg_wait(empty + 8 * slot, phase ^ 1);
        qv_wg_arrive_tx(full + 8 * slot, slab_bytes);
        qv_wg_bulk(dst, src + (long long)(c * kl + k) * PB, PB,
                   full + 8 * slot);
        qv_wg_bulk(dst + PB, src + (long long)((NCH + c) * kl + k) * PB, PB,
                   full + 8 * slot);
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warp w of either warpgroup multiplies rows 16 w .. 16 w
  // + 15 of the pass into its warpgroup's half of the columns
  qv_wg_setmaxnreg_inc<QV_WG_CONSUMER_REGS>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t* act_u = reinterpret_cast<uint32_t*>(acts);
  // the staged rows and their stride
  uint32_t* xs_u = SH ? act_u : reinterpret_cast<uint32_t*>(xss);
  const int s_x = SH ? SA : sx;
  const int lo = se - 1 > 0 ? se - 1 : 0, hi = se + 2 < T ? se + 2 : T;
  const QvNamedSync both{1, QV_WG_CONSUMERS};
  // warpgroup 1 stages the pass of voxels v .. v + 63, 16 rows a warp
  auto stage = [&](long long v) {
    if (wg == 1 && lane < 16) {
      const int r = 16 * warp + lane;
      qv_st_stage_row<QvStF32>(xs_u, s_x, r, x, n, v + r, t_in, cm, mask, T,
                               se, multi, lo, hi, 8 * ks0);
    }
  };
  // RW 2: lane l of warp w holds the values of row 16 w + l % 16; warp w
  // of each warpgroup stages half of the rows' channels
  const int wr = 16 * warp + (lane & 15);
  QvStWin win;
  int slot = 0;
  uint32_t phase = 0;
  float acc[HALF / 2];  // chunk c's sums at acc + c CN / 2
  if (RW != 2 && blockIdx.x < rounds)
    stage((long long)blockIdx.x * QV_ST_ROUND);
#pragma unroll 1
  for (long long rnd = blockIdx.x; rnd < rounds; rnd += gridDim.x) {
    const long long v0r = rnd * QV_ST_ROUND;
    const int passes = (int)min((long long)(QV_ST_ROUND / PASS),
                                (n - v0r + PASS - 1) / PASS);
#pragma unroll 1
    for (int p = 0; p < passes; ++p) {
      both.sync();  // the pass's rows are staged, the last heads are read
#pragma unroll 1
      for (int l = 0; l <= nb; ++l) {
        const uint32_t* in = l == 0 ? xs_u : act_u;
        const int s_in = l == 0 ? s_x : SA, kl = l == 0 ? ks0 : ksh;
#pragma unroll 1
        for (int k = 0; k < kl; ++k) {
          // RW 2: the window of k-steps kw .. kw + WK - 1 that holds k-step
          // k, staged at its first once both warpgroups have read the last
          const int kw = RW == 2 && l == 0 ? k - k % WK : 0;
          if (RW == 2 && l == 0 && kw == k) {
            if (k == 0)
              win = qv_st_win_row(x, n, v0r + p * PASS + wr, t_in, cm, mask,
                                  T, se, multi, lo, hi);
            else
              both.sync();
            qv_st_stage_window<8 * WK, 2>(
                reinterpret_cast<float*>(act_u), SA, 16 * warp, wg, win, x, n,
                t_in, cm, mask, T, 8 * k, min(8 * WK, 8 * (ks0 - k)));
            both.sync();
          }
          const QvStF32::A a =
              QvStF32::load_a(in, s_in, 16 * warp, k - kw, g, t);
          // the k-step's chunks, each from its own slot into its own sums
          // (the same A registers), from this warpgroup's piece
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            float* d = acc + c * (CN / 2);
            const uint32_t cur = qv_wg_addr(ring + slot * slab_bytes + wg * PB);
            qv_wg_wait(full + 8 * slot, phase);
            qv_wg_fence_sums<CN / 2>(d);
            qv_wg_fence();
            QvWgTf32<CN>::mma(d, a.lo, qv_wg_desc(cur), k > 0);
            QvWgTf32<CN>::mma(d, a.hi, qv_wg_desc(cur + 32 * CN), 1);
            QvWgTf32<CN>::mma(d, a.hi, qv_wg_desc(cur), 1);
            qv_wg_commit();
            qv_wg_wait_mma();
            qv_wg_fence_sums<CN / 2>(d);
            if (lane == 0) qv_wg_arrive(empty + 8 * slot);  // the slot is read
            if (++slot == stages) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
        // the first layer reads the staged rows (SH: in the activation
        // rows); every later one the activations, which both warpgroups
        // must have read before either overwrites them
        if (SH || l > 0) both.sync();
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int j = 0; j < CN / 8; ++j)
            QvStF32::store(act_u, SA, 16 * warp + g,
                           wg * HALF + c * CN + 8 * j + 2 * t,
                           acc + c * (CN / 2) + 4 * j, b.layer_bias(l), act);
        both.sync();  // the layer's outputs are written
      }
      if (wg == 0) {
        qv_st_head(QvStF32(), act_u, SA, b, UP, 16 * warp, lane, hq,
                   p * PASS);
      } else if (!SH) {
        const long long next = rnd + gridDim.x;
        if (p + 1 < passes)
          stage(v0r + (p + 1) * PASS);
        else if (next < rounds)
          stage(next * QV_ST_ROUND);
      }
      if (RW == 1 && p + 1 < passes) {
        both.sync();  // the heads have read the activations
        stage(v0r + (p + 1) * PASS);
      }
    }
    both.sync();  // the round's heads are staged
    if (QUAD)
      qv_st_quad_round(consts, scratch, hq, n, v0r, mvg, rg, o0, o1, o2,
                       both);
    else
      qv_st_write_q(hq, n, v0r, o0);
    both.sync();  // the heads and the scratch are read
    if (RW == 1 && rnd + gridDim.x < rounds)
      stage((rnd + gridDim.x) * QV_ST_ROUND);
  }
}

// Kernels B and C, one symbol each (the profile and the SASS tell them
// from the other designs').
template <int UP, int CN, int RW>
__global__ void __launch_bounds__(QV_WG_THREADS, 1)
    qv_encode_quad_wgx_kernel(QV_WG_ARGS, int mvg, QvRanges r, int stages,
                              float* __restrict__ means,
                              float* __restrict__ vars,
                              float* __restrict__ raw) {
  qv_wgx_body<UP, CN, RW, true>(x, n, t_in, cm, mask, se, multi, act, nb,
                                blob, image, mvg, r, stages, means, vars,
                                raw);
}

template <int UP, int CN, int RW>
__global__ void __launch_bounds__(QV_WG_THREADS, 1)
    qv_encode_q_wgx_kernel(QV_WG_ARGS, int stages, float* __restrict__ q) {
  qv_wgx_body<UP, CN, RW, false>(x, n, t_in, cm, mask, se, multi, act, nb,
                                 blob, image, 0, QvRanges{}, stages, q,
                                 nullptr, nullptr);
}

// kernel<Up, CN, RW> for the plan's chunks and rows (the CN of each Up that
// ops/fused_infer.py::_WGX_SLABS gives; shared and windowed rows at every
// width, where many taus leave no room for rows of their own).
#define QV_WGX_CASE(kernel, UP_, CN_, RW_, ...) \
  case (UP_ * 512 + CN_) * 4 + RW_:             \
    return qv_st_launch(kernel<UP_, CN_, RW_>, QV_WG_THREADS, __VA_ARGS__);
#define QV_WGX_DISPATCH(kernel, up, cn, stages, rows, ...)             \
  if (stages < 2 || stages > QV_WG_MAX_STAGES || rows < 0 || rows > 2) \
    return (int)cudaErrorInvalidValue;                                 \
  switch ((up * 512 + cn) * 4 + rows) {                                \
    QV_WGX_CASE(kernel, 448, 224, 0, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 512, 128, 0, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 576, 144, 0, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 640, 160, 0, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 704, 88, 0, __VA_ARGS__)               \
    QV_WGX_CASE(kernel, 768, 64, 0, __VA_ARGS__)               \
    QV_WGX_CASE(kernel, 448, 224, 1, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 512, 128, 1, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 576, 144, 1, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 640, 160, 1, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 704, 88, 1, __VA_ARGS__)               \
    QV_WGX_CASE(kernel, 768, 64, 1, __VA_ARGS__)               \
    QV_WGX_CASE(kernel, 448, 224, 2, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 512, 128, 2, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 576, 144, 2, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 640, 160, 2, __VA_ARGS__)              \
    QV_WGX_CASE(kernel, 704, 88, 2, __VA_ARGS__)               \
    QV_WGX_CASE(kernel, 768, 64, 2, __VA_ARGS__)               \
    default:                                                   \
      return (int)cudaErrorInvalidValue;                       \
  }

// The C entries: encode_stream_wg.cu's with the chunk width cn in place of
// the slab's k-steps (a slab is one k-step), then the rows (0 separate, 1
// shared: in the activation rows, 2 windowed); kernel B's here, kernel C's
// in encode_stream_wgx_c.cu.
#ifndef QV_WGX_C
extern "C" int qv_encode_quad_wgx(
    const float* x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int up, int nb,
    const float* blob, const float* image, QvRanges r, float* means,
    float* vars, float* raw, int mvg, int stages, int cn, int rows,
    int block, long long smem_bytes, void* stream) {
  QV_WGX_DISPATCH(qv_encode_quad_wgx_kernel, up, cn, stages, rows, n,
                  block, smem_bytes, stream, x, n, t_in, channel_major,
                  mask_channel, se_idx, multi_image, act, nb, blob, image,
                  mvg, r, stages, means, vars, raw)
}
#else
extern "C" int qv_encode_q1_wgx(const float* x, long long n, int t_in,
                                int channel_major, int mask_channel,
                                int se_idx, int multi_image, int act, int up,
                                int nb, const float* blob, const float* image,
                                float* q, int stages, int cn, int rows,
                                int block, long long smem_bytes,
                                void* stream) {
  QV_WGX_DISPATCH(qv_encode_q_wgx_kernel, up, cn, stages, rows, n, block,
                  smem_bytes, stream, x, n, t_in, channel_major,
                  mask_channel, se_idx, multi_image, act, nb, blob, image,
                  stages, q)
}
#endif
