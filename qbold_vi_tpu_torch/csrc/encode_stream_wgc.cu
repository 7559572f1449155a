// Kernels B and C, float32 trunk, past a padded width of 256 where a pass of
// 128 voxels fits in shared memory (Up 320 and 384: 257-384 units at any
// depth): encode_stream_wg.cu's design with each layer's products in output
// chunks, since wgmma's N is at most 256.
//
// It replaces the same TPU kernels as encode_quad.cu and encode_stream.cuh
// (qbold_vi_tpu/ops/pallas_infer.py::encode_quad_fused, pallas_call at :353,
// and encode_q1_packed, at :246) and computes what they compute: the
// normalised log signal, the dense chain in 3xTF32 (float32-accurate),
// the float32 head, then B's quadrature summaries or C's q (5, N), rounding
// where encode_stream_wg.cu rounds. ops/fused_infer.py::launch_plan takes
// it for the float32 trunk at Up 320 and 384 at any tau count;
// encode_stream_wgx.cu serves the wider trunks (448-768), whose pass of 128
// voxels does not fit, and encode_stream_wgk.cu 832-1472.
//
// Bound: at 320 units x 2 blocks the 3xTF32 products take 2.63 ms of a
// 1.03 M-voxel request at the dense TF32 peak; the request's bytes 0.026
// ms. A design adds the weights' reads from L2: every pass of V voxels
// reads all the trunk's weights (hi and lo), 1.68 MB at 320 x 2, ~13.5 GB a
// request at V = 128 and twice that at the 64 voxels a pass of the
// float32 streamed plan there (retired), which also ran every layer as two
// chunks of 256 outputs (the second a quarter full at 320) on mma.sync.
//
// Design. encode_stream_wg.cu's block -- two consumer warpgroups of 64
// voxels, a producer warpgroup that fills a ring of slabs by cp.async.bulk,
// 3xTF32 wgmma with A in registers, each thread reading back only the
// activations it wrote -- with these changes:
// * A layer's Up outputs are Up / CN chunks of CN <= 256 columns (320 =
//   160 + 160, 384 = 192 + 192), one wgmma.m64nCNk8 product each
//   per k-step and TF32 part, from the same A registers. CN is a multiple
//   of 8, so thread (g, t)'s sums are still the columns 8 j + 2 t, 2 t + 1
//   of every 8-column group: its A registers of the next layer are again
//   the channels it wrote (own-read), and no barrier runs between layers.
// * Every chunk's sums stay live (Up / 2 floats a thread, 160 at 320, 192
//   at 384, within the consumers' 232 registers) until the layer's last
//   k-step, and only then are the layer's outputs written over its inputs:
//   one activation buffer, 128 voxels a pass, so each read of the weights
//   serves 128 voxels.
// * A slab is one chunk's KS k-steps (64 CN bytes a k-step, hi then lo),
//   contiguous in the image: its layout puts each layer's chunks first
//   ([chunk][k-step][hi | lo][CN/8 row groups][k-half][8 rows][4 columns],
//   ops/fused_infer.py::_wg_image with cn), so a slab is one bulk copy. The
//   walk takes a k-slab's chunks in turn; a consumer releases a chunk's slot
//   as soon as its products are done, so the next copies land while the
//   other chunks multiply.
// * The staged rows share the activation rows: each warp stages its 16 rows
//   in their first 8 ks0 columns, which the first layer reads before its
//   epilogue overwrites them (the warp's own rows only). With the 10-12 KB
//   slabs that keeps 320 x 2 at 194,496 bytes, below the 196 KB past which
//   blocks of encode_stream_wg.cu ran 13-20% slower on the H100 (PERF.md);
//   384 needs the activations' 200,704 bytes alone.
// * Or (WIN, the plan's windowed rows: a staged row of 8 ks0 channels wider
//   than the activation row, many taus) each warp stages its 16 rows a
//   window at a time, as encode_stream_wg.cu's windowed kernels do: the
//   channels of k-steps k .. k + Up / 8 - 1 in the first Up columns,
//   before the first layer's k-slab k, every lane of the warp staging.
//   The warp alone reads its rows, and every chunk of a k-slab reads the
//   same A registers, loaded before the chunks' products, so a __syncwarp
//   before and after a window is the only barrier, and the layer's
//   epilogue, after its last k-slab's chunks, overwrites no window still
//   to be read. The outputs are the unwindowed kernel's, bit for bit, where
//   both fit; the block's shared memory does not depend on the taus.
// Shared memory (ops/fused_infer.py::_wg_smem with cn, in this order):
//   mbarriers (QV_WG_BAR_BYTES) | ring stages x KS x 64 CN bytes |
//   activations and staged rows 128 x (Up + 8) floats | heads 5 x 256
//   floats | [B: node table QV_NCONST; the quadrature's scratch in the
//   activations]

#include "encode_stream_wg.cuh"

// ---- the encode -------------------------------------------------------------

// CN: the output columns of a product (UP / CN chunks a layer); KS: k-steps
// a slab (their A registers, 8 a k-step, are loaded before the slab's
// products). A slab is KS k-steps of one chunk; WIN: the rows staged a
// window at a time (this file's header).
template <int UP, int CN, int KS, bool WIN, bool QUAD>
static __device__ __forceinline__ void qv_wgc_body(
    const float* __restrict__ x, long long n, int t_in, int cm, int mask,
    int se, int multi, int act, int nb, const float* __restrict__ blob,
    const float* __restrict__ image, int mvg, QvRanges rg, int stages,
    float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2) {
  static_assert(UP % CN == 0 && CN % 8 == 0 && CN <= 256, "chunk width");
  constexpr int NCH = UP / CN;
  constexpr int KB = 64 * CN;  // bytes of a chunk's k-step, hi then lo
  constexpr int SA = UP + 8, PASS = QV_WG_PASS;
  constexpr int WK = UP / 8;  // k-steps a window
  static_assert(WK % KS == 0, "a window holds whole k-slabs");
  extern __shared__ float4 qv_wg_smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(qv_wg_smem);
  const int T = t_in - mask;
  const int ks0 = (T + 7) / 8, ksh = UP / 8;
  const int nks0 = (ks0 + KS - 1) / KS;
  const int nksh = (ksh + KS - 1) / KS;
  const int s0 = NCH * nks0, sh = NCH * nksh;  // slabs of a layer
  const int nslab = s0 + nb * sh, slab_bytes = KS * KB;
  const uint32_t full = qv_wg_addr(sm), empty = full + 8 * stages;
  uint8_t* ring = sm + QV_WG_BAR_BYTES;
  float* acts = reinterpret_cast<float*>(ring + stages * slab_bytes);
  float* hq = acts + PASS * SA;
  float* consts = hq + 5 * QV_ST_ROUND;
  float* scratch = acts;  // PASS x SA floats hold QV_QUAD_SCRATCH(256)
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
        // slab j of the pass: chunk c of k-steps k0 .. k0 + KS - 1 of layer
        // l (k-slab by k-slab, a k-slab's chunks in order), whose image
        // starts at the trunk's k-step ls
        const int j = i % nslab;
        int kl = ks0, r = j, ls = 0;
        if (j >= s0) {
          const int l = (j - s0) / sh;
          kl = ksh;
          r = j - s0 - l * sh;
          ls = ks0 + l * ksh;
        }
        const int c = r % NCH, k0 = r / NCH * KS;
        const int bytes = min(KS, kl - k0) * KB;
        qv_wg_wait(empty + 8 * slot, phase ^ 1);
        qv_wg_arrive_tx(full + 8 * slot, bytes);
        qv_wg_bulk(qv_wg_addr(ring + slot * slab_bytes),
                   img + (long long)ls * 64 * UP + (long long)(c * kl + k0) * KB,
                   bytes, full + 8 * slot);
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
  const int lo = se - 1 > 0 ? se - 1 : 0, hi = se + 2 < T ? se + 2 : T;
  int slot = 0;
  uint32_t phase = 0;
  float acc[UP / 2];  // chunk c's sums at acc + c CN / 2
#pragma unroll 1
  for (long long rnd = blockIdx.x; rnd < rounds; rnd += gridDim.x) {
    const long long v0r = rnd * QV_ST_ROUND;
    const int passes = (int)min((long long)(QV_ST_ROUND / PASS),
                                (n - v0r + PASS - 1) / PASS);
#pragma unroll 1
    for (int p = 0; p < passes; ++p) {
      const int base = p * PASS + wg * 64;  // the warpgroup's rows
      // WIN: lane l holds the values of row 16 w + l % 16
      const int wr = 16 * warp + (lane & 15);
      QvStWin win;
      if (WIN) {
        win = qv_st_win_row(x, n, v0r + base + wr, t_in, cm, mask, T, se,
                            multi, lo, hi);
      } else {
        __syncwarp();  // the warp's rows of the last pass are read
        if (lane < 16) {
          const int r = 16 * warp + lane;
          qv_st_stage_row<QvStF32>(act_w, SA, r, x, n, v0r + base + r, t_in,
                                   cm, mask, T, se, multi, lo, hi, 8 * ks0);
        }
        __syncwarp();
      }
#pragma unroll 1
      for (int l = 0; l <= nb; ++l) {
        const int kl = l == 0 ? ks0 : ksh, nks = l == 0 ? nks0 : nksh;
#pragma unroll 1
        for (int ksl = 0; ksl < nks; ++ksl) {
          const int k0 = ksl * KS, nk = min(KS, kl - k0);
          // WIN: the window of k-steps kw .. kw + WK - 1 that holds the
          // k-slab, staged at its first k-slab once the last window (or
          // pass) is read
          const int kw = WIN && l == 0 ? k0 - k0 % WK : 0;
          if (WIN && l == 0 && kw == k0) {
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
            a[s] = QvStF32::load_a(act_w, SA, 16 * warp,
                                   min(k0 + s, kl - 1) - kw, g, t);
            const uint32_t keep = s < nk ? 0xFFFFFFFFu : 0u;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              a[s].hi[i] &= keep;
              a[s].lo[i] &= keep;
            }
          }
          // the k-slab's chunks, each from its own slot into its own sums
          // (the same A registers)
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            float* d = acc + c * (CN / 2);
            const uint32_t cur = qv_wg_addr(ring + slot * slab_bytes);
            qv_wg_wait(full + 8 * slot, phase);
            qv_wg_fence_sums<CN / 2>(d);
            qv_wg_fence();
#pragma unroll
            for (int s = 0; s < KS; ++s) {
              const uint32_t bk = cur + (s < nk ? s : 0) * KB;
              QvWgTf32<CN>::mma(d, a[s].lo, qv_wg_desc(bk), k0 + s > 0);
              QvWgTf32<CN>::mma(d, a[s].hi, qv_wg_desc(bk + 32 * CN), 1);
              QvWgTf32<CN>::mma(d, a[s].hi, qv_wg_desc(bk), 1);
            }
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
        // bias and activation: each thread's own rows and channels, which
        // only it reads back, after every chunk's last k-step: the layer's
        // inputs (the first layer's: the staged rows) stay whole until then
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
// from encode_stream_wg.cu's).
template <int UP, int CN, int KS, bool WIN>
__global__ void __launch_bounds__(QV_WG_THREADS, 1)
    qv_encode_quad_wgc_kernel(QV_WG_ARGS, int mvg, QvRanges r, int stages,
                              float* __restrict__ means,
                              float* __restrict__ vars,
                              float* __restrict__ raw) {
  qv_wgc_body<UP, CN, KS, WIN, true>(x, n, t_in, cm, mask, se, multi, act,
                                     nb, blob, image, mvg, r, stages, means,
                                     vars, raw);
}

template <int UP, int CN, int KS, bool WIN>
__global__ void __launch_bounds__(QV_WG_THREADS, 1)
    qv_encode_q_wgc_kernel(QV_WG_ARGS, int stages, float* __restrict__ q) {
  qv_wgc_body<UP, CN, KS, WIN, false>(x, n, t_in, cm, mask, se, multi, act,
                                      nb, blob, image, 0, QvRanges{}, stages,
                                      q, nullptr, nullptr);
}

// kernel<Up, CN, KS, WIN> for the plan's chunks and ring (the (CN, KS) of
// each Up that ops/fused_infer.py::_WGC_SLABS gives) and rows (windowed
// at both widths, where a staged row of many taus is wider than Up).
#define QV_WGC_CASE(kernel, UP_, CN_, KS_, WIN_, ...)                     \
  case ((UP_ * 512 + CN_) * 8 + KS_) * 2 + WIN_:                         \
    return qv_st_launch(kernel<UP_, CN_, KS_, (WIN_ != 0)>, QV_WG_THREADS, \
                        __VA_ARGS__);
#define QV_WGC_DISPATCH(kernel, up, cn, stages, ks, windowed, ...)          \
  if (stages < 2 || stages > QV_WG_MAX_STAGES || windowed < 0 ||           \
      windowed > 1)                                                         \
    return (int)cudaErrorInvalidValue;                                      \
  switch (((up * 512 + cn) * 8 + ks) * 2 + windowed) {                      \
    QV_WGC_CASE(kernel, 320, 160, 1, 0, __VA_ARGS__)                        \
    QV_WGC_CASE(kernel, 384, 192, 1, 0, __VA_ARGS__)                        \
    QV_WGC_CASE(kernel, 320, 160, 1, 1, __VA_ARGS__)                        \
    QV_WGC_CASE(kernel, 384, 192, 1, 1, __VA_ARGS__)                        \
    default:                                                                \
      return (int)cudaErrorInvalidValue;                                    \
  }

// The C entries: encode_stream_wg.cu's with the chunk width cn after ks,
// then the rows (windowed 1: a window at a time).
extern "C" int qv_encode_quad_wgc(
    const float* x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int up, int nb,
    const float* blob, const float* image, QvRanges r, float* means,
    float* vars, float* raw, int mvg, int stages, int ks, int cn,
    int windowed, int block, long long smem_bytes, void* stream) {
  QV_WGC_DISPATCH(qv_encode_quad_wgc_kernel, up, cn, stages, ks, windowed,
                  n, block, smem_bytes, stream, x, n, t_in, channel_major,
                  mask_channel, se_idx, multi_image, act, nb, blob, image,
                  mvg, r, stages, means, vars, raw)
}

extern "C" int qv_encode_q1_wgc(const float* x, long long n, int t_in,
                                int channel_major, int mask_channel,
                                int se_idx, int multi_image, int act, int up,
                                int nb, const float* blob, const float* image,
                                float* q, int stages, int ks, int cn,
                                int windowed, int block,
                                long long smem_bytes, void* stream) {
  QV_WGC_DISPATCH(qv_encode_q_wgc_kernel, up, cn, stages, ks, windowed, n,
                  block, smem_bytes, stream, x, n, t_in, channel_major,
                  mask_channel, se_idx, multi_image, act, nb, blob, image,
                  stages, q)
}
