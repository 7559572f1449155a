// Kernels B and C, float32 trunk, where the resident blob does not fit and
// the padded width Up is at most 256 (65-128 units x 2 blocks, deep trunks
// such as 60 x 7, 129-256 units): the streamed encode on Hopper's wgmma,
// with the weights fed through a ring of slabs by a producer warp.
//
// It replaces the same TPU kernels as encode_quad.cu and encode_stream.cuh
// (qbold_vi_tpu/ops/pallas_infer.py::encode_quad_fused, pallas_call at :353,
// and encode_q1_packed, at :246) and computes what they compute: the
// normalised log signal, the dense chain in 3xTF32 (float32-accurate),
// the float32 head, then B's quadrature summaries or C's q (5, N).
// ops/fused_infer.py::launch_plan takes it for the float32 trunk at every
// Up <= 256 where the resident blob does not fit; past 256 units
// encode_stream_wgc.cu's chunked kernels serve where they fit (320 and 384),
// encode_stream_wgx.cu's split ones at 448-768, encode_stream_wgk.cu's
// cluster ones at 832-1472, and the bf16 trunk keeps its own kernels.
//
// Bound: at 256 units x 2 blocks the 3xTF32 products take 1.69 ms of a
// 1.03 M-voxel request at the dense TF32 peak; the request's bytes 0.026
// ms. A design adds the weights' reads from L2: every pass of V voxels
// reads all the trunk's weights (hi and lo), 1.1 MB at 256 x 2, ~8.9 GB a
// request at V = 128. In the float32 streamed kernel of encode_stream.cuh
// (retired) the time followed the block-wide barrier of every slab and
// the B fragments each warp loads into registers, and every warp split
// all the pass's activations into TF32 hi / lo once again (PERF.md).
//
// Design. A block of three warpgroups: two consumer warpgroups, each of
// which owns 64 voxels of a pass of 128, and a producer warpgroup.
// * Products on wgmma.m64nUpk8.f32.tf32.tf32, A (64 voxels x 8 channels)
//   from registers, B from shared memory by descriptor: 3xTF32 as three
//   products into one float32 accumulator, a_lo b_hi + a_hi b_lo + a_hi
//   b_hi (mma_math.cuh's split and order). A layer is one wgmma width
//   (Up <= 256), so its outputs stay in the accumulators (Up / 2 floats a
//   thread) until its last k-step.
// * The weights as K-major core-matrix images (TF32 wgmma takes no other
//   layout), hi and lo apart: k-step s of the trunk (the first layer's,
//   then each block's) is [hi | lo][Up/8 row groups][2 k-halves][8 rows]
//   [4 columns] floats, 64 Up bytes, row groups SBO = 256 B and k-halves
//   LBO = 128 B apart, no swizzle. The wrapper derives this image from
//   the fragment blob on the card (a permutation, ops/fused_infer.py::
//   _wg_image) and keeps it beside the blob; the blob's layout is
//   unchanged, so a serving .pt2 of the fragment blob runs as it did.
// * Channel 8 s + 2c + kh of k-step s sits in k-slot 4 kh + c, so thread
//   (g, t)'s A registers (rows g, g + 8; slots t, t + 4) are channels 2t
//   and 2t + 1: the columns its own accumulators hold after the layer's
//   products. Each thread therefore writes its own outputs (bias, then
//   the activation) to the warpgroup's activation rows and reads back
//   only what it wrote: no barrier between layers, and each activation is
//   split into hi / lo once a layer, by the thread that owns it. Up <= 256
//   keeps 64 x (Up + 8) floats a warpgroup in shared memory rather than
//   in registers (Up floats a thread with the accumulators).
// * One lane of the producer warpgroup walks the pass's slabs (KS k-steps
//   of a layer, each contiguous in the image) for every pass and fills a ring
//   of `stages` slots by cp.async.bulk, completion to the slot's full
//   mbarrier; a consumer warp waits on it, and after its warpgroup's
//   products of the slab have completed (wgmma.wait_group) releases the
//   slot with one arrive on its empty mbarrier (8 a phase). No block-wide
//   barrier runs in the encode. The producer warpgroup keeps 40 registers
//   a thread (setmaxnreg) and gives the rest to the consumers (232), whose
//   Up / 2 sums and the A registers of a slab's KS k-steps would spill at
//   the 168 that 384 threads get evenly.
// * Rows and heads as in encode_stream.cuh: each warp stages its own 16
//   rows (qv_st_stage_row); the head (U -> 5) on mma.sync from the blob's
//   fragments in global memory (qv_st_head); a round of 256 voxels (two
//   passes) stages its heads, then the 256 consumer threads, a voxel a
//   thread, run B's quadrature (qv_quad_block's side sort over the round,
//   on named barrier 1) or write C's q. B's scratch shares the activation
//   rows where it fits (they are idle between a round's last head and its
//   next pass).
// * Or (RW 1, the plan's shared rows: many taus, where a buffer of 128
//   staged rows does not fit beside the block) each warp stages its 16 rows
//   in the first 8 ks0 columns of its activation rows, as
//   encode_stream_wgc.cu does: a thread's first-layer products read, and
//   its epilogue overwrites, only the channels it owns (header), and the
//   round's scratch is read before the next pass is staged.
// * Or (RW 2, the plan's windowed rows: a staged row of 8 ks0 channels
//   wider than an activation row of Up) each warp stages its 16 rows a
//   window at a time: the channels of k-steps k .. k + Up / 8 - 1 (whole
//   slabs) in the first Up columns of its activation rows, before the
//   first layer's slab k, every lane of the warp staging in the order of
//   x's layout (encode_stream.cuh::qv_st_stage_window; a row's reference
//   and mask value computed once a pass in its lanes' registers). Only
//   the warp reads its rows, so a __syncwarp before and after a window is
//   the only barrier; the values and the products' order are the shared
//   rows', so the outputs are too, bit for bit. The block's shared memory
//   does not depend on the taus.
// Shared memory (ops/fused_infer.py::_wg_smem, in this order):
//   mbarriers (QV_WG_BAR_BYTES) | ring stages x KS x 64 Up bytes |
//   activations 128 x (Up + 8) floats | rows 128 x SX floats (none with
//   RW 1 or 2) | heads 5 x 256 floats | [B: node table QV_NCONST, quadrature
//   scratch QV_QUAD_SCRATCH(256) floats unless it fits in the activations]
// (SX: QvStF32::x_stride of the first layer's k-steps.) The PTX helpers
// and the products are encode_stream_wg.cuh's, shared with
// encode_stream_wgc.cu.

#include "encode_stream_wg.cuh"

// ---- the encode -------------------------------------------------------------

// KS: k-steps a slab (their A registers, 8 a k-step, are loaded before
// the slab's products); RW: the staged rows, 0 a buffer of their own, 1 in
// the activation rows, 2 there a window at a time (header).
template <int UP, int KS, int RW, bool QUAD>
static __device__ __forceinline__ void qv_wg_body(
    const float* __restrict__ x, long long n, int t_in, int cm, int mask,
    int se, int multi, int act, int nb, const float* __restrict__ blob,
    const float* __restrict__ image, int mvg, QvRanges rg, int stages,
    float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2) {
  constexpr int KB = 64 * UP;  // bytes of a k-step's image, hi then lo
  constexpr int SA = UP + 8, PASS = QV_WG_PASS;
  constexpr bool SH = RW != 0;  // the rows in the activation rows
  constexpr int WK = UP / 8;    // k-steps a window
  static_assert(WK % KS == 0, "a window holds whole slabs");
  extern __shared__ float4 qv_wg_smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(qv_wg_smem);
  const int T = t_in - mask;
  const int ks0 = (T + 7) / 8, ksh = UP / 8;
  const int nks0 = (ks0 + KS - 1) / KS;
  const int nksh = (ksh + KS - 1) / KS;
  const int nslab = nks0 + nb * nksh, slab_bytes = KS * KB;
  const int sx = QvStF32::x_stride(ks0);
  const uint32_t full = qv_wg_addr(sm), empty = full + 8 * stages;
  uint8_t* ring = sm + QV_WG_BAR_BYTES;
  float* acts = reinterpret_cast<float*>(ring + stages * slab_bytes);
  float* xss = acts + PASS * SA;
  float* hq = xss + (SH ? 0 : PASS * sx);
  float* consts = hq + 5 * QV_ST_ROUND;
  float* scratch = PASS * SA >= QV_QUAD_SCRATCH(QV_ST_ROUND)
                       ? acts
                       : consts + QV_NCONST;
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
        const int j = i % nslab;
        // slab j: k-steps k0 .. k0 + nk - 1 of layer l (the image's k-step
        // ks of the trunk)
        int kl = ks0, k0 = j * KS, ks = k0;
        if (j >= nks0) {
          const int l = (j - nks0) / nksh;
          kl = ksh;
          k0 = (j - nks0 - l * nksh) * KS;
          ks = ks0 + l * ksh + k0;
        }
        const int bytes = min(KS, kl - k0) * KB;
        qv_wg_wait(empty + 8 * slot, phase ^ 1);
        qv_wg_arrive_tx(full + 8 * slot, bytes);
        qv_wg_bulk(qv_wg_addr(ring + slot * slab_bytes),
                   img + (long long)ks * KB, bytes, full + 8 * slot);
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg encodes rows 64 wg .. 64 wg + 63 of a
  // pass, warp w its rows 16 w .. 16 w + 15
  qv_wg_setmaxnreg_inc<QV_WG_CONSUMER_REGS>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t* act_w = reinterpret_cast<uint32_t*>(acts + wg * 64 * SA);
  // the staged rows and their stride
  uint32_t* xs_w =
      SH ? act_w : reinterpret_cast<uint32_t*>(xss + wg * 64 * sx);
  const int s_x = SH ? SA : sx;
  const int lo = se - 1 > 0 ? se - 1 : 0, hi = se + 2 < T ? se + 2 : T;
  int slot = 0;
  uint32_t phase = 0;
  float acc[UP / 2];
#pragma unroll 1
  for (long long rnd = blockIdx.x; rnd < rounds; rnd += gridDim.x) {
    const long long v0r = rnd * QV_ST_ROUND;
    const int passes = (int)min((long long)(QV_ST_ROUND / PASS),
                                (n - v0r + PASS - 1) / PASS);
#pragma unroll 1
    for (int p = 0; p < passes; ++p) {
      const int base = p * PASS + wg * 64;  // the warpgroup's rows
      // RW 2: lane l holds the values of row 16 w + l % 16
      const int wr = 16 * warp + (lane & 15);
      QvStWin win;
      if (RW == 2) {
        win = qv_st_win_row(x, n, v0r + base + wr, t_in, cm, mask, T, se,
                            multi, lo, hi);
      } else {
        __syncwarp();  // the warp's rows of the last pass are read
        if (lane < 16) {
          const int r = 16 * warp + lane;
          qv_st_stage_row<QvStF32>(xs_w, s_x, r, x, n, v0r + base + r, t_in,
                                   cm, mask, T, se, multi, lo, hi, 8 * ks0);
        }
        __syncwarp();
      }
#pragma unroll 1
      for (int l = 0; l <= nb; ++l) {
        const uint32_t* in = l == 0 ? xs_w : act_w;
        const int s_in = l == 0 ? s_x : SA;
        const int kl = l == 0 ? ks0 : ksh, nks = l == 0 ? nks0 : nksh;
#pragma unroll 1
        for (int ksl = 0; ksl < nks; ++ksl) {
          const int k0 = ksl * KS, nk = min(KS, kl - k0);
          // RW 2: the window of k-steps kw .. kw + WK - 1 that holds the
          // slab, staged at its first slab once the last window (or pass)
          // is read
          const int kw = RW == 2 && l == 0 ? k0 - k0 % WK : 0;
          if (RW == 2 && l == 0 && kw == k0) {
            __syncwarp();
            qv_st_stage_window<8 * WK, 1>(
                reinterpret_cast<float*>(act_w), SA, 16 * warp, 0, win, x, n,
                t_in, cm, mask, T, 8 * k0, min(8 * WK, 8 * (ks0 - k0)));
            __syncwarp();
          }
          // a slab's KS k-steps with no branch around the products: past
          // the slab's nk (the first layer's last slab), A is zero and B
          // the slab's first k-step
          QvStF32::A a[KS];
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            a[s] = QvStF32::load_a(in, s_in, 16 * warp,
                                   min(k0 + s, kl - 1) - kw, g, t);
            const uint32_t keep = s < nk ? 0xFFFFFFFFu : 0u;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              a[s].hi[i] &= keep;
              a[s].lo[i] &= keep;
            }
          }
          const uint32_t cur = qv_wg_addr(ring + slot * slab_bytes);
          qv_wg_wait(full + 8 * slot, phase);
          qv_wg_fence_sums<UP / 2>(acc);
          qv_wg_fence();
#pragma unroll
          for (int s = 0; s < KS; ++s) {
            const uint32_t bk = cur + (s < nk ? s : 0) * KB;
            QvWgTf32<UP>::mma(acc, a[s].lo, qv_wg_desc(bk), k0 + s > 0);
            QvWgTf32<UP>::mma(acc, a[s].hi, qv_wg_desc(bk + 32 * UP), 1);
            QvWgTf32<UP>::mma(acc, a[s].hi, qv_wg_desc(bk), 1);
          }
          qv_wg_commit();
          qv_wg_wait_mma();
          qv_wg_fence_sums<UP / 2>(acc);
          if (lane == 0) qv_wg_arrive(empty + 8 * slot);  // the slot is read
          if (++slot == stages) {
            slot = 0;
            phase ^= 1;
          }
        }
        // bias and activation: each thread's own rows and channels, which
        // only it reads back (header)
#pragma unroll
        for (int j = 0; j < UP / 8; ++j)
          QvStF32::store(act_w, SA, 16 * warp + g, 8 * j + 2 * t, acc + 4 * j,
                         b.layer_bias(l), act);
      }
      __syncwarp();
      qv_st_head(QvStF32(), act_w, SA, b, UP, 16 * warp, lane, hq, base);
    }
    const QvNamedSync round{1, QV_WG_CONSUMERS};
    round.sync();  // the round's heads are staged
    if (QUAD)
      qv_st_quad_round(consts, scratch, hq, n, v0r, mvg, rg, o0, o1, o2,
                       round);
    else
      qv_st_write_q(hq, n, v0r, o0);
    round.sync();  // the heads and the scratch are read
  }
}

// Kernels B and C, one symbol each (the profile and the SASS tell them
// from the other designs').
template <int UP, int KS, int RW>
__global__ void __launch_bounds__(QV_WG_THREADS, 1)
    qv_encode_quad_wg_kernel(QV_WG_ARGS, int mvg, QvRanges r, int stages,
                             float* __restrict__ means,
                             float* __restrict__ vars,
                             float* __restrict__ raw) {
  qv_wg_body<UP, KS, RW, true>(x, n, t_in, cm, mask, se, multi, act, nb,
                               blob, image, mvg, r, stages, means, vars, raw);
}

template <int UP, int KS, int RW>
__global__ void __launch_bounds__(QV_WG_THREADS, 1)
    qv_encode_q_wg_kernel(QV_WG_ARGS, int stages, float* __restrict__ q) {
  qv_wg_body<UP, KS, RW, false>(x, n, t_in, cm, mask, se, multi, act, nb,
                                blob, image, 0, QvRanges{}, stages, q,
                                nullptr, nullptr);
}

// kernel<Up, KS, RW> for the plan's ring (stages slots of ks k-steps; the
// pairs ops/fused_infer.py::_WG_SLABS offers) and rows (shared at the
// plan's first slab of 192 and 256, the widths where the staged rows of
// many taus leave a block no room; windowed at the first slab of every
// width, where a staged row is wider than an activation row), launched as
// encode_stream.cuh's kernels are.
#define QV_WG_CASE(kernel, UP_, KS_, RW_, ...)                       \
  case (UP_ * 8 + KS_) * 4 + RW_:                                    \
    return qv_st_launch(kernel<UP_, KS_, RW_>, QV_WG_THREADS, __VA_ARGS__);
#define QV_WG_DISPATCH(kernel, up, stages, ks, rows, ...)              \
  if (stages < 2 || stages > QV_WG_MAX_STAGES || rows < 0 || rows > 2) \
    return (int)cudaErrorInvalidValue;                                 \
  switch ((up * 8 + ks) * 4 + rows) {                                  \
    QV_WG_CASE(kernel, 16, 2, 0, __VA_ARGS__)                              \
    QV_WG_CASE(kernel, 32, 4, 0, __VA_ARGS__)                              \
    QV_WG_CASE(kernel, 64, 4, 0, __VA_ARGS__)                              \
    QV_WG_CASE(kernel, 128, 2, 0, __VA_ARGS__)                             \
    QV_WG_CASE(kernel, 192, 1, 0, __VA_ARGS__)                             \
    QV_WG_CASE(kernel, 192, 2, 0, __VA_ARGS__)                             \
    QV_WG_CASE(kernel, 256, 1, 0, __VA_ARGS__)                             \
    QV_WG_CASE(kernel, 256, 2, 0, __VA_ARGS__)                             \
    QV_WG_CASE(kernel, 192, 1, 1, __VA_ARGS__)                             \
    QV_WG_CASE(kernel, 256, 1, 1, __VA_ARGS__)                             \
    QV_WG_CASE(kernel, 16, 2, 2, __VA_ARGS__)                              \
    QV_WG_CASE(kernel, 32, 4, 2, __VA_ARGS__)                              \
    QV_WG_CASE(kernel, 64, 4, 2, __VA_ARGS__)                              \
    QV_WG_CASE(kernel, 128, 2, 2, __VA_ARGS__)                             \
    QV_WG_CASE(kernel, 192, 1, 2, __VA_ARGS__)                             \
    QV_WG_CASE(kernel, 256, 1, 2, __VA_ARGS__)                             \
    default:                                                               \
      return (int)cudaErrorInvalidValue;                                   \
  }

// The C entries: encode_stream.cuh's arguments with the wgmma image
// (ops/fused_infer.py::_wg_image) beside the blob and the plan's ring and
// rows (0 separate, 1 shared: in the activation rows, 2 windowed) in place
// of its tile; block must be QV_WG_THREADS and smem_bytes the plan's.
extern "C" int qv_encode_quad_wg(
    const float* x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int up, int nb,
    const float* blob, const float* image, QvRanges r, float* means,
    float* vars, float* raw, int mvg, int stages, int ks, int rows,
    int block, long long smem_bytes, void* stream) {
  QV_WG_DISPATCH(qv_encode_quad_wg_kernel, up, stages, ks, rows, n, block,
                 smem_bytes, stream, x, n, t_in, channel_major, mask_channel,
                 se_idx, multi_image, act, nb, blob, image, mvg, r, stages,
                 means, vars, raw)
}

extern "C" int qv_encode_q1_wg(const float* x, long long n, int t_in,
                               int channel_major, int mask_channel,
                               int se_idx, int multi_image, int act, int up,
                               int nb, const float* blob, const float* image,
                               float* q, int stages, int ks, int rows,
                               int block, long long smem_bytes,
                               void* stream) {
  QV_WG_DISPATCH(qv_encode_q_wg_kernel, up, stages, ks, rows, n, block,
                 smem_bytes, stream, x, n, t_in, channel_major, mask_channel,
                 se_idx, multi_image, act, nb, blob, image, stages, q)
}
