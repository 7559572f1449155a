// Kernels B and C, float32 trunk, at padded widths 832-1472 (769-1472
// units at any depth): the layer's columns split across a thread-block
// cluster of C CTAs, which together hold one pass of 128 voxels and share
// its activation rows through distributed shared memory (DSMEM).
//
// It replaces the same TPU kernels as encode_quad.cu and encode_stream.cuh
// (qbold_vi_tpu/ops/pallas_infer.py::encode_quad_fused, pallas_call at :353,
// and encode_q1_packed, at :246) and computes what they compute: the
// normalised log signal, the dense chain in 3xTF32 (float32-accurate),
// the float32 head, then B's quadrature summaries or C's q (5, N).
// ops/fused_infer.py::launch_plan takes it for the float32 trunk at the
// padded widths of _WGK_PLANS at any tau count (many taus: the staged
// rows in the activation rows, RW 1, or there a window at a time where a
// row is wider than a block's NL columns, RW 2); encode_stream_wgx.cu
// serves 448-768.
//
// Bound: at 833 units x 1 block the 3xTF32 products take 8.85 ms of a
// 1.03 M-voxel request at the dense TF32 peak; the request's bytes 0.026
// ms. A design adds the weights' reads from L2: a pass of V voxels reads
// the trunk's weights (hi and lo, 6.6 MB at 896 x 1) once, ~426 GB a
// request at the 16 voxels a pass of the float32 streamed plan there (the
// only pass that fits one CTA: at 896 a single CTA's rows of 64 voxels
// alone take 231,424 B), ~53 GB at V = 128.
//
// Design. encode_stream_wgx.cu's CTA -- two consumer warpgroups, a
// producer warpgroup that fills a ring of slabs by cp.async.bulk with full
// / empty mbarriers and keeps 40 registers by setmaxnreg, 3xTF32 wgmma
// with A in registers -- in a cluster of C CTAs (rank r; the plan's C is
// 8, the most that is portable, 15 clusters resident on the H100):
// * The cluster takes a pass of 128 voxels; warpgroup wg of every CTA its
//   voxels 64 wg .. 64 wg + 63 (warp w rows 16 w .. 16 w + 15 of them).
//   CTA r computes the output columns r NL .. (r + 1) NL - 1 of every
//   layer (NL = Up / C, one wgmma.m64nNLk8 product a k-step and TF32 part)
//   and keeps only those columns of the pass's activation rows (128 x
//   (NL + 8 or 16) floats). Its producer streams only those columns'
//   slabs (chunk r of _wg_image(..., cn=NL): 64 NL bytes a k-step), so the
//   cluster reads the trunk's weights from L2 once a pass of 128 voxels.
// * A layer's inputs past the first: k-step k's channels are rank k / (NL
//   / 8)'s columns, read from its shared memory by ld.shared::cluster
//   (mapa), a k-step ahead of the products; the first layer reads the
//   staged rows, which every CTA stages for itself. CTA r takes a block
//   layer's k-steps in turn from its own (k-step r NL / 8), and its
//   producer walks the slabs in that order: in one order for all, every
//   CTA read the same CTA's rows at a time, whose shared memory then
//   served eight readers beside its own wgmma (13-16% of the time on the
//   H100, PERF.md).
// * One activation buffer a CTA: two cluster barriers a layer, one before
//   its epilogue (every CTA has read the inputs it overwrites) and one
//   after (the outputs are written). A cluster barrier is the 256 consumer
//   threads of each CTA on a named barrier, then C arrivals (release,
//   cluster scope) on each CTA's barrier mbarrier, and every consumer
//   thread's wait (acquire); the producer takes no part.
// * The sums are promoted every `seg` k-steps: a segment's three products
//   a k-step go to a fresh fragment (scale-d 0 at its first product),
//   which is added to the thread's float32 sums on the CUDA cores. The
//   tensor cores' float32 sums truncate (mma_math.cuh), and over the 832
//   channels of a block layer a running sum fed to every wgmma drifted
//   past the kernels' gate against their plain versions (PERF.md: at 832
//   units the split kernel's B; C's q 2.89e-5 from float64, 1.68e-5 here
//   unpromoted, 3.5e-6 in segments of 8 k-steps, the plain version's
//   2.19e-6; a fourth product lo * lo moved nothing). A thread holds
//   NL / 2 sums and NL / 2 fragment registers up to NL = 160 (1280).
// * Past 160 columns a CTA (1344-1472: NL 168-184) two copies of every sum
//   do not fit a thread's registers (PR 21's split kernel spilled at 176
//   sums), so the CTA's columns are two output chunks of C0 and NL - C0
//   (the template's C0; 0: one product), each a wgmma.m64nCk8 product from
//   the same A registers and the slab's columns from C0 on (32 C0 bytes
//   into its hi and lo halves: the image is the unchunked one). All NL / 2
//   sums a thread stay live to the layer's end, one chunk's fresh fragment
//   at a time: a segment of S k-steps (the plan's seg) takes chunk 0's
//   three products a k-step into the fragment, waits for them and adds it
//   to chunk 0's sums, then chunk 1's from the same split A registers (8
//   a k-step), so the segment's S slabs stay in the ring until chunk 1
//   has read them (seg <= stages); the next segment's raw A values are
//   loaded meanwhile. On the H100 a first chunk of 64 columns and
//   segments of 2-3 k-steps ran fastest; every cluster kernel, chunked or
//   not, reports 168 registers and spills under __launch_bounds__ (PERF.md).
// * The head (U -> 5): each warp's partial sums over its CTA's columns on
//   mma.sync from its own activated sums (a thread's accumulators are its
//   A fragments of the head's k-steps), stored into the shared memory of
//   the CTA that owns the pass's voxels. A cluster round is C rounds of
//   256 voxels (2 C passes); CTA r owns round r (passes 2 r, 2 r + 1), sums
//   its partials in rank order after a cluster barrier, then runs B's
//   quadrature or writes C's q for it on named barrier 1; B's scratch in
//   the activation rows, which no CTA reads between a round's last pass
//   and the next pass's first epilogue.
// * Each warp stages its own 16 rows of the next pass once its first
//   layer's products have read the current ones.
// * Or (RW 1, the plan's shared rows: many taus, where a buffer of 128
//   staged rows does not fit beside the block; T <= NL) each warp stages its 16
//   rows in the first 8 ks0 columns of its activation rows, which its
//   first layer reads before the epilogue's cluster barrier; the next
//   pass's rows wait until every CTA has read this CTA's activations, the
//   inputs of the last layer (a cluster barrier more a pass), and the next
//   round's first pass until the round's quadrature has read its scratch.
// * Or (RW 2, the plan's windowed rows: a staged row of 8 ks0 channels
//   wider than NL) each warp stages its 16 rows a window at a time: the
//   channels of WK k-steps (NT, or in a chunked plan the most whole
//   segments of S within NT) in the first 8 WK columns of its activation
//   rows, every lane of the warp staging (qv_st_stage_window; a row's
//   reference and mask value computed once a pass in registers). The first
//   layer reads only the warp's own rows (no peer reads them: peers read
//   a layer's activations after its cluster barriers), so a __syncwarp
//   before and after a window is the only barrier: the first window at
//   the first layer's start, after the cluster barrier that follows the
//   last layer (as RW 1 stages a pass), each later one once the k-steps
//   loaded ahead of the products have reached it. The outputs are the
//   shared rows' bit for bit; the block's shared memory does not depend on
//   the taus.
// Every wait on an mbarrier traps after 10 s (a fault, not a hang).
// Shared memory (ops/fused_infer.py::_wgk_smem, in this order):
//   mbarriers (QV_WGK_BAR_BYTES) | ring stages x 64 NL bytes |
//   activations 128 x SA floats | rows 128 x SX floats (none with RW 1
//   or 2) |
//   partial heads C x 5 x 256 floats | [B: node table QV_NCONST]
// (SA = NL + 8 where NL is a multiple of 16, else NL + 16: 8 words past a
// multiple of 16, so that a warp's A loads and epilogue stores meet no
// bank twice; SX: QvStF32::x_stride of the first layer's k-steps.) The
// PTX helpers and the m64nNk8 products are encode_stream_wg.cuh's. This
// file compiles kernel B's entries; encode_stream_wgk_c.cu compiles it
// again with QV_WGK_C for kernel C's, and encode_stream_wgk_w.cu /
// encode_stream_wgk_wc.cu with QV_WGK_W the windowed kernels' (entries
// named _w), so that nvcc builds the four sets of instantiations side by
// side (one process a source).

#include "encode_stream_wg.cuh"

#define QV_WGK_PASS 128       // voxels a pass of the cluster
#define QV_WGK_BAR_BYTES 256  // the ring's mbarriers, then the cluster's
#define QV_WGK_MAX_CLUSTER 8  // the portable cluster sizes
#define QV_WGK_WATCHDOG_NS 10000000000ull

// ---- cluster PTX -----------------------------------------------------------

static __device__ __forceinline__ int qv_wgk_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
static __device__ __forceinline__ int qv_wgk_ranks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
// The shared::cluster address of shared::cta address a in CTA `rank`.
static __device__ __forceinline__ uint32_t qv_wgk_map(uint32_t a, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(a), "r"(rank));
  return d;
}
static __device__ __forceinline__ float2 qv_wgk_ld2(uint32_t a) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(a)
               : "memory");
  return v;
}
static __device__ __forceinline__ void qv_wgk_st(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v)
               : "memory");
}
static __device__ __forceinline__ void qv_wgk_arrive_remote(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}
// Wait until the phase of the given parity has completed (acquire at the
// cluster's scope or the CTA's); trap after QV_WGK_WATCHDOG_NS.
template <bool CLUSTER>
static __device__ __forceinline__ void qv_wgk_wait(uint32_t bar,
                                                   uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    if (CLUSTER)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0)
      t0 = now;
    else if (now - t0 > QV_WGK_WATCHDOG_NS)
      __trap();
  }
}

// The consumers' cluster barrier (header): named barrier 2 over this CTA's
// 256 consumer threads, then thread r < C arrives on CTA r's mbarrier
// (C arrivals a phase), and every consumer thread waits on its own.
struct QvWgkSync {
  uint32_t bar;
  int ranks;
  uint32_t phase;
  __device__ __forceinline__ void sync() {
    asm volatile("bar.sync 2, %0;\n" ::"n"(QV_WG_CONSUMERS) : "memory");
    if ((int)threadIdx.x < ranks)
      qv_wgk_arrive_remote(qv_wgk_map(bar, threadIdx.x));
    qv_wgk_wait<true>(bar, phase);
    phase ^= 1;
  }
};

// Bias and activation of a thread's four sums c of columns col, col + 1
// (rows g, g + 8), as QvStF32::store computes them: v (g, col), (g, col +
// 1), (g + 8, col), (g + 8, col + 1).
static __device__ __forceinline__ void qv_wgk_act4(const float* c,
                                                   const float* bias,
                                                   int col, int act,
                                                   float* v) {
  const float2 b = __ldg(reinterpret_cast<const float2*>(bias + col));
  v[0] = c[0] + b.x;
  v[1] = c[1] + b.y;
  v[2] = c[2] + b.x;
  v[3] = c[3] + b.y;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = act == 0 ? fmaxf(v[i], 0.0f) : qv_act_call(act, v[i]);
}

// The A fragment of raw values a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1),
// a3 (g + 8, 2t + 1), split into TF32 hi / lo (QvStF32::load_a's order).
static __device__ __forceinline__ QvStF32::A qv_wgk_split(float4 r) {
  QvStF32::A f;
  qv_split(r.x, f.hi[0], f.lo[0]);
  qv_split(r.y, f.hi[1], f.lo[1]);
  qv_split(r.z, f.hi[2], f.lo[2]);
  qv_split(r.w, f.hi[3], f.lo[3]);
  return f;
}

// ---- the encode -------------------------------------------------------------

// One output chunk of CW columns over a segment of sl <= S k-steps in the
// ring's slots from `slot`: three TF32 products a k-step into the fresh
// fragment frag (scale-d 0 at the first), A the k-step's split registers,
// B the slab's columns off .. off + CW - 1 (32 off bytes into its hi and lo
// halves); then the fragment is added to the chunk's float32 sums.
template <int CW, int S, int NL>
static __device__ __forceinline__ void qv_wgk_chunk(
    float* frag, float* sums, const QvStF32::A* a, int sl, uint32_t ring,
    int slot, int stages, int off) {
  qv_wg_fence_sums<CW / 2>(frag);
  qv_wg_fence();
#pragma unroll
  for (int i = 0, s = slot; i < S; ++i, s = s + 1 == stages ? 0 : s + 1) {
    if (i < sl) {
      const uint32_t hi = ring + s * 64 * NL + 32 * off, lo = hi + 32 * NL;
      QvWgTf32<CW>::mma(frag, a[i].lo, qv_wg_desc(hi), i != 0);
      QvWgTf32<CW>::mma(frag, a[i].hi, qv_wg_desc(lo), 1);
      QvWgTf32<CW>::mma(frag, a[i].hi, qv_wg_desc(hi), 1);
    }
  }
  qv_wg_commit();
  qv_wg_wait_mma();
  qv_wg_fence_sums<CW / 2>(frag);
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) sums[i] += frag[i];
}

// NL: the output columns of a CTA (Up / C). C0 0: one product of NL
// columns a k-step, its sums promoted every `seg` k-steps; else two output
// chunks of C0 and NL - C0 columns, promoted every S (= seg) k-steps. RW:
// the staged rows, 0 a buffer of their own, 1 in the activation rows, 2
// there a window at a time (header).
template <int NL, int C0, int S, int RW, bool QUAD>
static __device__ __forceinline__ void qv_wgk_body(
    const float* __restrict__ x, long long n, int t_in, int cm, int mask,
    int se, int multi, int act, int nb, const float* __restrict__ blob,
    const float* __restrict__ image, int up, int mvg, QvRanges rg,
    int stages, int seg, float* __restrict__ o0, float* __restrict__ o1,
    float* __restrict__ o2) {
  constexpr int NT = NL / 8;  // k-steps of a CTA's columns
  constexpr int SA = NL + (NL % 16 == 0 ? 8 : 16);  // words a row
  constexpr int SB = 64 * NL;                       // bytes a slab
  constexpr int PASS = QV_WGK_PASS;
  constexpr int C1 = NL - C0;  // the second chunk's columns
  // a fresh fragment's registers: one product's, or the wider chunk's
  constexpr int FR = C0 == 0 ? NL / 2 : (C0 > C1 ? C0 : C1) / 2;
  constexpr bool SH = RW != 0;  // the rows in the activation rows
  // k-steps a window: whole segments of a chunked plan
  constexpr int WK = C0 == 0 ? NT : NT / S * S;
  static_assert(NL % 8 == 0 && NL <= 256, "columns a CTA");
  static_assert(C0 == 0 || (C0 % 8 == 0 && C1 % 8 == 0 && C1 > 0 && S > 0),
                "chunks");
  static_assert(PASS * SA >= QV_QUAD_SCRATCH(QV_ST_ROUND), "scratch");
  extern __shared__ float4 qv_wg_smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(qv_wg_smem);
  const int ranks = qv_wgk_ranks(), rank = qv_wgk_rank();
  const int T = t_in - mask;
  const int ks0 = (T + 7) / 8, ksh = up / 8;
  const int sx = QvStF32::x_stride(ks0);
  const int nslab = ks0 + nb * ksh;                 // slabs a pass
  const uint32_t full = qv_wg_addr(sm), empty = full + 8 * stages;
  const uint32_t cbar = full + 16 * QV_WG_MAX_STAGES;
  uint8_t* ring = sm + QV_WGK_BAR_BYTES;
  float* acts = reinterpret_cast<float*>(ring + stages * SB);
  float* xss = acts + PASS * SA;
  // [rank][channel][voxel of the round]
  float* part = xss + (SH ? 0 : PASS * sx);
  float* consts = part + ranks * 5 * QV_ST_ROUND;
  const QvStBlob b = qv_st_blob<QvStF32>(blob, up, nb, ks0);
  if (QUAD) qv_stage_consts(b.consts, consts);
  for (int i = threadIdx.x; i < ranks * 5 * QV_ST_ROUND; i += blockDim.x)
    part[i] = 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      qv_wg_bar_init(full + 8 * s, 1);   // the producer's arrival + bytes
      qv_wg_bar_init(empty + 8 * s, 8);  // a lane of each consumer warp
    }
    qv_wg_bar_init(cbar, ranks);         // a consumer thread of each CTA
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA's barriers and partial sums are set before any peer uses them
  asm volatile(
      "barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::
          : "memory");
  const long long span = (long long)ranks * QV_ST_ROUND;  // a cluster round
  const long long rounds = (n + span - 1) / span;
  const int cl = blockIdx.x / ranks, ncl = gridDim.x / ranks;
  // the warpgroup, warp-uniform as the compiler sees it (a wgmma in a
  // branch it takes for divergent is serialised)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (wg == QV_WG_CONSUMERS / 128) {
    // the producer: one lane walks every pass's slabs of this CTA's columns
    qv_wg_setmaxnreg_dec<QV_WG_PRODUCER_REGS>();
    if (threadIdx.x != QV_WG_CONSUMERS) return;
    const uint8_t* img = reinterpret_cast<const uint8_t*>(image);
    int slot = 0;
    uint32_t phase = 0;
#pragma unroll 1
    for (long long rnd = cl; rnd < rounds; rnd += ncl) {
      const int passes = (int)min((long long)(2 * ranks),
                                  (n - rnd * span + PASS - 1) / PASS);
#pragma unroll 1
      for (int i = 0; i < passes * nslab; ++i) {
        // slab j of the pass: k-step k of layer l, whose image starts at
        // the trunk's k-step ls (a block layer's k-steps from the CTA's
        // own, rank NT); this CTA's columns are the image's chunk `rank` of
        // the layer
        const int j = i % nslab;
        int kl = ks0, k = j, ls = 0;
        if (j >= ks0) {
          const int l = (j - ks0) / ksh;
          kl = ksh;
          k = j - ks0 - l * ksh + rank * NT;  // the consumers' order
          if (k >= ksh) k -= ksh;
          ls = ks0 + l * ksh;
        }
        const uint8_t* src =
            img + (long long)ls * 64 * up + (long long)(rank * kl + k) * SB;
        qv_wgk_wait<false>(empty + 8 * slot, phase ^ 1);
        qv_wg_arrive_tx(full + 8 * slot, SB);
        qv_wg_bulk(qv_wg_addr(ring + slot * SB), src, SB, full + 8 * slot);
        if (++slot == stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warp w of warpgroup wg multiplies rows 64 wg + 16 w ..
  // 64 wg + 16 w + 15 of the pass into this CTA's columns
  qv_wg_setmaxnreg_inc<QV_WG_CONSUMER_REGS>();
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * warp;
  uint32_t* act_u = reinterpret_cast<uint32_t*>(acts);
  // the staged rows and their stride
  uint32_t* xs_u = reinterpret_cast<uint32_t*>(SH ? acts : xss);
  const int s_x = SH ? SA : sx;
  const uint32_t acts_a = qv_wg_addr(acts), part_a = qv_wg_addr(part);
  const int lo = se - 1 > 0 ? se - 1 : 0, hi = se + 2 < T ? se + 2 : T;
  const QvNamedSync both{1, QV_WG_CONSUMERS};
  QvWgkSync cs{cbar, ranks, 0};
  // each warp stages its own 16 rows of the pass of voxels v .. v + 127
  auto stage = [&](long long v) {
    if (lane < 16)
      qv_st_stage_row<QvStF32>(xs_u, s_x, row0 + lane, x, n,
                               v + row0 + lane, t_in, cm, mask, T, se, multi,
                               lo, hi, 8 * ks0);
  };
  // RW 2: lane l holds the values of row row0 + l % 16; the window holds
  // k-steps kwin .. kwin + WK - 1
  QvStWin win;
  int kwin = 0;
  auto restage = [&](int k) {
    __syncwarp();  // the last window (or pass) is read
    qv_st_stage_window<8 * WK, 1>(acts, SA, row0, 0, win, x, n, t_in, cm,
                                  mask, T, 8 * k,
                                  min(8 * WK, 8 * (ks0 - k)));
    kwin = k;
    __syncwarp();
  };
  // k-step k's raw A values of layer l: the staged rows (l == 0) or the
  // activations of rank k / NT
  auto load = [&](int l, int k) -> float4 {
    if (l == 0) {
      const float* r = reinterpret_cast<const float*>(xs_u) +
                       (row0 + g) * s_x + 8 * (RW == 2 ? k - kwin : k) +
                       2 * t;
      const float2 a = *reinterpret_cast<const float2*>(r);
      const float2 c = *reinterpret_cast<const float2*>(r + 8 * s_x);
      return make_float4(a.x, c.x, a.y, c.y);
    }
    const int o = k / NT;
    const uint32_t a = qv_wgk_map(
        acts_a + 4 * ((row0 + g) * SA + 8 * (k - o * NT) + 2 * t), o);
    const float2 r0 = qv_wgk_ld2(a), r1 = qv_wgk_ld2(a + 32 * SA);
    return make_float4(r0.x, r1.x, r0.y, r1.y);
  };
  int slot = 0;
  uint32_t phase = 0;
  float acc[NL / 2], frag[FR];
  if (RW != 2 && cl < rounds) stage((long long)cl * span);
  __syncwarp();
#pragma unroll 1
  for (long long rnd = cl; rnd < rounds; rnd += ncl) {
    const long long v0 = rnd * span;
    const int passes =
        (int)min((long long)(2 * ranks), (n - v0 + PASS - 1) / PASS);
#pragma unroll 1
    for (int p = 0; p < passes; ++p) {
#pragma unroll 1
      for (int l = 0; l <= nb; ++l) {
        const int kl = l == 0 ? ks0 : ksh;
#pragma unroll
        for (int i = 0; i < NL / 2; ++i) acc[i] = 0.0f;
        // a block layer's k-steps in turn from this CTA's own, rank NT, so
        // that the cluster's CTAs read different CTAs' rows at a time
        const int k0 = l == 0 ? 0 : rank * NT;
        auto kstep = [&](int k) {
          return k + k0 < kl ? k + k0 : k + k0 - kl;
        };
        if (RW == 2 && l == 0) {  // the pass's first window
          win = qv_st_win_row(x, n, v0 + p * PASS + row0 + (lane & 15), t_in,
                              cm, mask, T, se, multi, lo, hi);
          restage(0);
        }
        if constexpr (C0 == 0) {
          float4 raw = load(l, kstep(0));
          int done = 0;
#pragma unroll 1
          for (int k = 0; k < kl; ++k) {
            float4 nxt = raw;
            if (RW == 2 && l == 0 && k + 1 < kl && (k + 1) % WK == 0)
              restage(k + 1);  // raw is in registers
            if (k + 1 < kl) nxt = load(l, kstep(k + 1));  // a k-step ahead
            const QvStF32::A a = qv_wgk_split(raw);
            const uint32_t cur = qv_wg_addr(ring + slot * SB);
            qv_wgk_wait<false>(full + 8 * slot, phase);
            qv_wg_fence_sums<NL / 2>(frag);
            qv_wg_fence();
            QvWgTf32<NL>::mma(frag, a.lo, qv_wg_desc(cur), done != 0);
            QvWgTf32<NL>::mma(frag, a.hi, qv_wg_desc(cur + 32 * NL), 1);
            QvWgTf32<NL>::mma(frag, a.hi, qv_wg_desc(cur), 1);
            qv_wg_commit();
            qv_wg_wait_mma();
            qv_wg_fence_sums<NL / 2>(frag);
            if (lane == 0) qv_wg_arrive(empty + 8 * slot);  // the slot is read
            if (++slot == stages) {
              slot = 0;
              phase ^= 1;
            }
            if (++done == seg || k + 1 == kl) {  // promote the segment
#pragma unroll
              for (int i = 0; i < NL / 2; ++i) acc[i] += frag[i];
              done = 0;
            }
            raw = nxt;
          }
        } else {
          // segments of S k-steps: the segment's A values split once,
          // chunk 0's products over its slabs, promoted, then chunk 1's
          // from the same registers; the next segment's raw values are
          // loaded ahead
          float4 nxt[S];
#pragma unroll
          for (int i = 0; i < S; ++i)
            nxt[i] = i < kl ? load(l, kstep(i)) : make_float4(0, 0, 0, 0);
          const uint32_t ring_a = qv_wg_addr(ring);
#pragma unroll 1
          for (int k = 0; k < kl; k += S) {
            const int sl = min(S, kl - k);
            QvStF32::A a[S];
            if constexpr (RW == 2) {
              // the segment's values are split before the next segment's
              // window replaces them
#pragma unroll
              for (int i = 0; i < S; ++i) a[i] = qv_wgk_split(nxt[i]);
              if (l == 0 && k + S < kl && (k + S) % WK == 0) restage(k + S);
#pragma unroll
              for (int i = 0; i < S; ++i)
                if (k + S + i < kl) nxt[i] = load(l, kstep(k + S + i));
            } else {
#pragma unroll
              for (int i = 0; i < S; ++i) {
                a[i] = qv_wgk_split(nxt[i]);
                if (k + S + i < kl) nxt[i] = load(l, kstep(k + S + i));
              }
            }
            for (int i = 0, s = slot; i < sl; ++i) {  // the slabs landed
              qv_wgk_wait<false>(full + 8 * s, phase ^ (s < slot));
              s = s + 1 == stages ? 0 : s + 1;
            }
            qv_wgk_chunk<C0, S, NL>(frag, acc, a, sl, ring_a, slot, stages,
                                    0);
            qv_wgk_chunk<C1, S, NL>(frag, acc + C0 / 2, a, sl, ring_a, slot,
                                    stages, C0);
            for (int i = 0; i < sl; ++i) {  // the segment's slots are read
              if (lane == 0) qv_wg_arrive(empty + 8 * slot);
              if (++slot == stages) {
                slot = 0;
                phase ^= 1;
              }
            }
          }
        }
        if (!SH && l == 0) {
          // this warp's staged rows are read: stage the next pass's
          __syncwarp();
          const long long next = rnd + ncl;
          if (p + 1 < passes)
            stage(v0 + (p + 1) * PASS);
          else if (next < rounds)
            stage(next * span);
          __syncwarp();
        }
        if (l < nb) {
          const float* bias =
              reinterpret_cast<const float*>(b.layer_bias(l)) + rank * NL;
          cs.sync();  // every CTA has read the activations overwritten here
#pragma unroll
          for (int j = 0; j < NT; ++j)
            QvStF32::store(act_u, SA, row0 + g, 8 * j + 2 * t, acc + 4 * j,
                           bias, act);
          cs.sync();  // the layer's outputs are written
        } else {
          // the head's partial sums over this CTA's columns, from the
          // thread's own activated sums, to the round's owner
          const float* bias =
              reinterpret_cast<const float*>(b.layer_bias(nb)) + rank * NL;
          float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float v[4];
            qv_wgk_act4(acc + 4 * j, bias, 8 * j + 2 * t, act, v);
            QvStF32::mma(h, qv_wgk_split(make_float4(v[0], v[2], v[1], v[3])),
                         QvStF32::load_b_global(b.wf, rank * NT + j, lane));
          }
          const int owner = p / 2, base = (p & 1) * PASS + row0 + g;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int col = 2 * t + (i & 1), row = base + (i < 2 ? 0 : 8);
            if (col < 5)
              qv_wgk_st(qv_wgk_map(part_a + 4 * ((rank * 5 + col) *
                                                     QV_ST_ROUND + row),
                                   owner),
                        h[i]);
          }
          if (SH && p + 1 < passes) {
            cs.sync();  // every CTA has read this CTA's activations
            if (RW == 1) {
              stage(v0 + (p + 1) * PASS);
              __syncwarp();
            }
          }
        }
      }
    }
    cs.sync();  // the round's partial heads are written
    const int vi = threadIdx.x;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      float s = part[c * QV_ST_ROUND + vi];
      for (int r = 1; r < ranks; ++r)
        s += part[(r * 5 + c) * QV_ST_ROUND + vi];
      part[c * QV_ST_ROUND + vi] = s + b.bf[c];
    }
    both.sync();  // this CTA's round of heads is summed
    const long long v0r = v0 + (long long)rank * QV_ST_ROUND;
    if (QUAD)
      qv_st_quad_round(consts, acts, part, n, v0r, mvg, rg, o0, o1, o2,
                       both);
    else
      qv_st_write_q(part, n, v0r, o0);
    // the heads and the scratch are read; the next round's partial heads
    // come after the next pass's cluster barriers (nb >= 1: the blob of
    // ops/fused_infer.py::_weight_blob has a block)
    both.sync();
    if (RW == 1 && rnd + ncl < rounds) {
      stage((rnd + ncl) * span);
      __syncwarp();
    }
  }
}

// Kernels B and C, one symbol each (the profile and the SASS tell them
// from the other designs').
template <int NL, int C0, int S, int RW>
__global__ void __launch_bounds__(QV_WG_THREADS, 1)
    qv_encode_quad_wgk_kernel(QV_WG_ARGS, int up, int mvg, QvRanges r,
                              int stages, int seg, float* __restrict__ means,
                              float* __restrict__ vars,
                              float* __restrict__ raw) {
  qv_wgk_body<NL, C0, S, RW, true>(x, n, t_in, cm, mask, se, multi, act, nb,
                                   blob, image, up, mvg, r, stages, seg,
                                   means, vars, raw);
}

template <int NL, int C0, int S, int RW>
__global__ void __launch_bounds__(QV_WG_THREADS, 1)
    qv_encode_q_wgk_kernel(QV_WG_ARGS, int up, int stages, int seg,
                           float* __restrict__ q) {
  qv_wgk_body<NL, C0, S, RW, false>(x, n, t_in, cm, mask, se, multi, act,
                                    nb, blob, image, up, 0, QvRanges{},
                                    stages, seg, q, nullptr, nullptr);
}

// The launch config of a cluster of `ranks` CTAs of `block` threads.
struct QvWgkConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  QvWgkConfig(int ranks, int block, long long smem, void* stream) : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ranks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(ranks);
    cfg.blockDim = dim3(block);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of the kernel that the card holds at once (0: none fits). An
// error is returned and cleared: the runtime would report it again at the
// next launch of any kernel.
template <class Kernel>
static int qv_wgk_clusters(Kernel kernel, int ranks, long long smem,
                           int* clusters) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    QvWgkConfig c(ranks, QV_WG_THREADS, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(clusters, kernel, &c.cfg);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// Grid: as many clusters as the cluster rounds need, at most as many as
// the card holds at once; a cluster that cannot run is an error.
template <class Kernel, class... Args>
static int qv_wgk_launch(Kernel kernel, int ranks, long long n, int block,
                         long long smem_bytes, void* stream, Args... args) {
  if (block != QV_WG_THREADS) return (int)cudaErrorInvalidValue;
  int clusters = 0;
  int err = qv_wgk_clusters(kernel, ranks, smem_bytes, &clusters);
  if (err != 0) return err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const long long span = (long long)ranks * QV_ST_ROUND;
  const long long rounds = (n + span - 1) / span;
  QvWgkConfig c(ranks, block, smem_bytes, stream);
  c.cfg.gridDim = dim3((unsigned)(ranks * (rounds < clusters ? rounds
                                                             : clusters)));
  cudaLaunchKernelEx(&c.cfg, kernel, args...);
  return (int)cudaGetLastError();
}

// kernel<NL, C0, S, RW> for the plan's columns a CTA (Up / C of each width
// that ops/fused_infer.py::_WGK_PLANS gives, and the sweep's other
// clusters), its first chunk's columns C0 (0: one product), a chunked
// plan's promoted segment S (its `seg`; 0 where C0 is 0, `seg` at run time)
// and its rows (RW 1: in the activation rows, at the plans whose staged
// rows of many taus leave no room beside the block; RW 2: there a window at
// a time, where a staged row is wider than a block's columns).
// The shared-rows plans (ops/fused_infer.py::_WGK_SHARED): the widths
// 1280-1472, whose staged rows of 73-184 taus fit in an activation row but
// not beside the block.
#define QV_WGK_SHARED_CASES(X, kernel, ...) \
  X(kernel, 160, 0, 0, 1, __VA_ARGS__)      \
  X(kernel, 168, 64, 2, 1, __VA_ARGS__)     \
  X(kernel, 176, 64, 3, 1, __VA_ARGS__)     \
  X(kernel, 184, 64, 3, 1, __VA_ARGS__)
#define QV_WGK_CASES(X, kernel, ...)    \
  X(kernel, 104, 0, 0, 0, __VA_ARGS__)  \
  X(kernel, 112, 0, 0, 0, __VA_ARGS__)  \
  X(kernel, 120, 0, 0, 0, __VA_ARGS__)  \
  X(kernel, 128, 0, 0, 0, __VA_ARGS__)  \
  X(kernel, 136, 0, 0, 0, __VA_ARGS__)  \
  X(kernel, 144, 0, 0, 0, __VA_ARGS__)  \
  X(kernel, 152, 0, 0, 0, __VA_ARGS__)  \
  X(kernel, 160, 0, 0, 0, __VA_ARGS__)  \
  X(kernel, 168, 64, 2, 0, __VA_ARGS__) \
  X(kernel, 176, 64, 3, 0, __VA_ARGS__) \
  X(kernel, 176, 64, 2, 0, __VA_ARGS__) \
  X(kernel, 184, 64, 3, 0, __VA_ARGS__) \
  X(kernel, 184, 64, 2, 0, __VA_ARGS__) \
  QV_WGK_SHARED_CASES(X, kernel, __VA_ARGS__)
// The windowed-rows plans (ops/fused_infer.py::_WGK_WINDOWED): the first
// plan of every width, reached where a staged row of many taus is wider
// than its columns (encode_stream_wgk_w.cu, encode_stream_wgk_wc.cu).
#define QV_WGK_WINDOWED_CASES(X, kernel, ...) \
  X(kernel, 104, 0, 0, 2, __VA_ARGS__)        \
  X(kernel, 112, 0, 0, 2, __VA_ARGS__)        \
  X(kernel, 120, 0, 0, 2, __VA_ARGS__)        \
  X(kernel, 128, 0, 0, 2, __VA_ARGS__)        \
  X(kernel, 136, 0, 0, 2, __VA_ARGS__)        \
  X(kernel, 144, 0, 0, 2, __VA_ARGS__)        \
  X(kernel, 152, 0, 0, 2, __VA_ARGS__)        \
  X(kernel, 160, 0, 0, 2, __VA_ARGS__)        \
  X(kernel, 168, 64, 2, 2, __VA_ARGS__)       \
  X(kernel, 176, 64, 3, 2, __VA_ARGS__)       \
  X(kernel, 184, 64, 3, 2, __VA_ARGS__)
// This source's kernels and its entries' names (header).
#ifdef QV_WGK_W
#define QV_WGK_TU_CASES(X, kernel, ...) \
  QV_WGK_WINDOWED_CASES(X, kernel, __VA_ARGS__)
#define QV_WGK_NAME(name) name##_w
#else
#define QV_WGK_TU_CASES(X, kernel, ...) QV_WGK_CASES(X, kernel, __VA_ARGS__)
#define QV_WGK_NAME(name) name
#endif
#define QV_WGK_MATCH(NL_, C0_, S_, RW_) \
  (nl == NL_ && chunk == C0_ && (C0_ == 0 || seg == S_) && rows == RW_)
#define QV_WGK_LAUNCH(kernel, NL_, C0_, S_, RW_, ...) \
  if (QV_WGK_MATCH(NL_, C0_, S_, RW_))                \
    return qv_wgk_launch(kernel<NL_, C0_, S_, RW_>, __VA_ARGS__);
#define QV_WGK_CHECK(up, cluster, stages, seg, chunk, rows)               \
  if (stages < 2 || stages > QV_WG_MAX_STAGES || seg < 1 ||               \
      cluster < 1 || cluster > QV_WGK_MAX_CLUSTER || up % cluster != 0 || \
      chunk < 0 || (chunk > 0 && seg > stages) || rows < 0 || rows > 2)   \
    return (int)cudaErrorInvalidValue;                                    \
  const int nl = up / cluster;
#define QV_WGK_DISPATCH(kernel, ...)                  \
  QV_WGK_TU_CASES(QV_WGK_LAUNCH, kernel, __VA_ARGS__) \
  return (int)cudaErrorInvalidValue;

// The C entries: encode_stream_wgx.cu's with the cluster's CTAs, the
// promoted segment's k-steps and the first chunk's columns (0: none) in
// place of the chunk width, then the rows (0 separate, 1 shared: in the
// activation rows, 2 windowed: the _w entries); kernel B's here, kernel
// C's in encode_stream_wgk_c.cu.
#define QV_WGK_COUNT(kernel, NL_, C0_, S_, RW_, ranks, smem, clusters) \
  if (QV_WGK_MATCH(NL_, C0_, S_, RW_))                                  \
    return qv_wgk_clusters(kernel<NL_, C0_, S_, RW_>, ranks, smem, clusters);
#define QV_WGK_COUNT_CHECK(up, cluster, rows)                             \
  *clusters = 0;                                                          \
  if (cluster < 1 || cluster > QV_WGK_MAX_CLUSTER || up % cluster != 0 || \
      rows < 0 || rows > 2)                                               \
    return (int)cudaErrorInvalidValue;                                    \
  const int nl = up / cluster;

// Clusters of kernel C at this plan that the card holds at once, into
// *clusters; returns the CUDA error (encode_stream_wgk_c.cu, the windowed
// plans' encode_stream_wgk_wc.cu).
extern "C" int QV_WGK_NAME(qv_encode_wgk_clusters_q1)(int up, int cluster,
                                                      int seg, int chunk,
                                                      int rows,
                                                      long long smem_bytes,
                                                      int* clusters);

#ifndef QV_WGK_C
extern "C" int QV_WGK_NAME(qv_encode_quad_wgk)(
    const float* x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int up, int nb,
    const float* blob, const float* image, QvRanges r, float* means,
    float* vars, float* raw, int mvg, int stages, int cluster, int seg,
    int chunk, int rows, int block, long long smem_bytes, void* stream) {
  QV_WGK_CHECK(up, cluster, stages, seg, chunk, rows)
  QV_WGK_DISPATCH(qv_encode_quad_wgk_kernel, cluster, n, block, smem_bytes,
                  stream, x, n, t_in, channel_major, mask_channel, se_idx,
                  multi_image, act, nb, blob, image, up, mvg, r, stages, seg,
                  means, vars, raw)
}

#ifndef QV_WGK_W
// The windowed plans' count (encode_stream_wgk_w.cu).
extern "C" int qv_encode_wgk_clusters_w(int up, int cluster, int seg,
                                        int chunk, int rows, int quad,
                                        long long smem_bytes, int* clusters);
#endif

// Clusters of kernel B (quad) or C at this plan that the card holds at
// once, into *clusters; returns the CUDA error.
extern "C" int QV_WGK_NAME(qv_encode_wgk_clusters)(int up, int cluster,
                                                   int seg, int chunk,
                                                   int rows, int quad,
                                                   long long smem_bytes,
                                                   int* clusters) {
#ifndef QV_WGK_W
  if (rows == 2)
    return qv_encode_wgk_clusters_w(up, cluster, seg, chunk, rows, quad,
                                    smem_bytes, clusters);
#endif
  if (!quad)
    return QV_WGK_NAME(qv_encode_wgk_clusters_q1)(up, cluster, seg, chunk,
                                                  rows, smem_bytes, clusters);
  QV_WGK_COUNT_CHECK(up, cluster, rows)
  QV_WGK_TU_CASES(QV_WGK_COUNT, qv_encode_quad_wgk_kernel, cluster,
                  smem_bytes, clusters)
  return (int)cudaErrorInvalidValue;
}
#else
extern "C" int QV_WGK_NAME(qv_encode_q1_wgk)(
    const float* x, long long n, int t_in, int channel_major,
    int mask_channel, int se_idx, int multi_image, int act, int up, int nb,
    const float* blob, const float* image, float* q, int stages, int cluster,
    int seg, int chunk, int rows, int block, long long smem_bytes,
    void* stream) {
  QV_WGK_CHECK(up, cluster, stages, seg, chunk, rows)
  QV_WGK_DISPATCH(qv_encode_q_wgk_kernel, cluster, n, block, smem_bytes,
                  stream, x, n, t_in, channel_major, mask_channel, se_idx,
                  multi_image, act, nb, blob, image, up, stages, seg, q)
}

extern "C" int QV_WGK_NAME(qv_encode_wgk_clusters_q1)(int up, int cluster,
                                                      int seg, int chunk,
                                                      int rows,
                                                      long long smem_bytes,
                                                      int* clusters) {
  QV_WGK_COUNT_CHECK(up, cluster, rows)
  QV_WGK_TU_CASES(QV_WGK_COUNT, qv_encode_q_wgk_kernel, cluster, smem_bytes,
                  clusters)
  return (int)cudaErrorInvalidValue;
}
#endif
