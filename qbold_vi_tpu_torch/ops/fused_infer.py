"""Fused stream-1 inference: normalise -> dense chain [-> quadrature].

The counterpart of ``qbold_vi_tpu/ops/pallas_infer.py::encode_quad_fused``
(kernel B) and ``encode_q1_packed`` (kernel C, the encode alone).
Stream 1 of the encoder (``use_first_op=True``) is voxelwise for every
encoder configuration -- GroupNorm and dropout act only on the stream-2
residual path -- so the whole serving program is one pass per voxel:

    [mask] -> clip -> spin-echo normalise -> log
    -> Dense(T->U) + act -> [Dense(U->U) + act] x n_blocks
    -> float32 Dense(U->4|5) head
    -> quadrature posterior summaries + raw-log-std transforms

``encode_quad_fused`` is the wrapper of kernel B: for a CUDA tensor it
packs the weights and calls the registered op
``torch.ops.qbold_vi_tpu_torch.encode_quad_fused`` (``encode_quad_fused_op``,
registered when this module is imported, with a fake implementation for
``torch.export``; the fused serving artifact calls the same op), which
launches a hand-written kernel on the current stream (q never leaves the
chip's registers and shared memory); for a CPU tensor it runs
``encode_quad_fused_plain``, the plain torch version of the same math.
Every width and depth runs on the card, as the JAX kernel covers every
encoder configuration; ``launch_plan``, a function of shapes alone, picks
the design: the resident kernels of csrc/encode_quad.cu (float32) and
csrc/encode_quad_bf16.cu (bf16), which hold the whole weight blob in
shared memory, wherever it fits (counted in ``encode_quad_fused.launches``
and ``.bf16_launches``); else, in float32 up to a padded width of 256,
csrc/encode_stream_wg.cu, which feeds a wgmma image of the blob's weights
(``_wg_image``) through a ring of slabs (``.wgmma_launches``); in float32
at padded widths 320 and 384 (257-384 units), csrc/encode_stream_wgc.cu,
the same design with each layer's products in output chunks of at most 256
columns (``.chunked_launches``); in float32 at padded widths 448-768
(385-768 units), csrc/encode_stream_wgx.cu, the same block with each
layer's columns split between its two consumer warpgroups on a shared
pass of 64 voxels (``.split_launches``); in float32 at padded widths
832-1472 (769-1472 units), csrc/encode_stream_wgk.cu, a thread-block
cluster of such blocks on a pass of 128 voxels, each block holding its
share of every layer's columns (past 160 a block, in two output chunks)
and reading the others' through distributed shared memory
(``.cluster_launches``). On dense tau scans, where a buffer of staged
input rows does not fit beside the wgmma, split or cluster block, the
block stages them in its activation rows, and where a staged row is wider
than an activation row, there a window of the first layer's k-steps at a
time (``LaunchPlan.rows``), so every float32 shape up to a padded width
of 1472 runs at any tau count. The bf16 trunk takes the streamed kernels
of csrc/encode_stream.cuh past 128 units or where its blob does not fit,
which stream the blob itself through shared memory a slab at a time
(``.stream_bf16_launches``).
``encode_q1_packed`` is the wrapper of kernel C, which shares B's encode
routine and writes the raw head ``q (5, N)`` for the MC summaries
(ops/summarize.py); its plain version is ``encode_q_plain``.

Contract (as the JAX function's): images are ``(T[+1], N)``
channel-major (``input_layout="channel"``) or ``(..., T[+1])``
voxel-major (``"voxel"``); ``mask_channel`` says the last channel is the
brain mask, multiplied in before the clip. Returns channel-major
``(means (3, N), vars (3, N), raw (3, N))`` with raw = (log-std0,
log-std1, offdiag), row 2 zero for diagonal heads. Unlike the TPU
kernel, nothing is padded: the outputs hold exactly N voxels.

``trunk`` is the dense chain's dtype, as the JAX kernel's: "float32"
(the kernel's products in 3xTF32, float32-accurate) or "bfloat16", whose
rounding points are ``_encode_body``'s (pallas_infer.py:118-133): the
normalised log signal is float32, then rounded to bf16; each layer's
products take bf16 operands and a float32 sum, rounded to bf16; the bf16
bias is added in bf16 and the activation runs in bf16 (jax.nn's
composition, models/encoder.py::activation_fn); the head is float32 on the
float32-cast features.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.encoder import activation_fn, normalise_data
from . import _cuda
from .quadrature import quad_tile_summaries

__all__ = ["encode_quad_fused", "encode_quad_fused_op",
           "encode_quad_fused_plain", "encode_q_plain", "encode_q1_packed",
           "fused_infer_available", "launch_plan", "LaunchPlan",
           "SUPPORTED_ACTS"]

# Activations the kernel implements (csrc/encode_quad.cu::qv_act, whose
# codes follow this order); the same set as the JAX package's.
SUPPORTED_ACTS = ("relu", "gelu", "tanh", "sigmoid", "softplus", "elu",
                  "silu", "swish", "leaky_relu", "relu6", "linear")

_WARPS = (12, 8, 4, 2, 1)       # resident float32 warps a block, most that fit
_RESIDENT_WIDTHS = (16, 32, 64, 128)  # csrc/encode_quad.cu::QV_ENCODE_DISPATCH
# the bf16 kernels' block and round of voxels (csrc/encode_quad_bf16.cu::
# QV_E16_THREADS, QV_E16_ROUND), and the tag words their blob starts with:
# a magic word and the layout's number (QV_E16_TAG_WORDS words in all)
_E16_THREADS = _E16_ROUND = 256
_BF16_TAG = (0x51564232, 2, 0, 0)
_NCONST = 3 * 16 + 10 * 16      # csrc/quad_math.cuh::QV_NCONST
# the streamed kernels (csrc/encode_stream.cuh): threads a block and voxels
# a quadrature round (QV_ST_THREADS, QV_ST_ROUND), the (MT, NCW) tiles
# compiled (QV_ST_DISPATCH) by n-tiles a warp, largest pass first, and the
# slabs' bytes tried, largest first (on the H100 64 KB slabs ran no faster
# than 32 KB ones, at bf16 slower)
_ST_THREADS = _ST_ROUND = 256
_ST_TILES = {1: (8, 4), 2: (8, 4), 4: (8, 4, 2, 1)}
_ST_SLAB_BYTES = (32768, 16384)
# the float32 trunk's wgmma kernels (csrc/encode_stream_wg.cu): threads a
# block (QV_WG_THREADS: two consumer warpgroups and a producer's), voxels a
# pass (QV_WG_PASS), the bytes of the ring's mbarriers (QV_WG_BAR_BYTES),
# the k-steps a slab compiled for each padded width (QV_WG_DISPATCH: 12-32
# KB slabs) and the ring's slots. launch_plan takes the smallest ring, the
# first slab in two slots, which ran fastest on the H100 (at 256 x 2, 16
# KB slabs in two slots 13-15% faster than any block past 196 KB; PERF.md);
# the other slabs and slots are tools/bench_stream1.py --sweep's
_WG_THREADS = 384
_WG_PASS = 128
_WG_BAR_BYTES = 128
_WG_SLABS = {16: (2,), 32: (4,), 64: (4,), 128: (2,), 192: (1, 2),
             256: (1, 2)}
_WG_STAGES = (2, 3, 4)
# the chunked wgmma kernels (csrc/encode_stream_wgc.cu) past 256: the
# (chunk width, k-steps a slab) compiled for each padded width
# (QV_WGC_DISPATCH); on the H100 384 ran 13-14% faster in chunks of 192
# than of 128 (PERF.md)
_WGC_SLABS = {320: (160, 1), 384: (192, 1)}
# the split wgmma kernels (csrc/encode_stream_wgx.cu) past 384, where a
# pass of 128 voxels does not fit: voxels a pass (QV_WGX_PASS, both
# consumer warpgroups') and, for each padded width, the chunk width
# compiled (QV_WGX_DISPATCH; it divides a warpgroup's Up / 2) and the ring's
# slots: of the plans that fit, the one that ran fastest on the H100
# (tools/bench_stream1.py --sweep; PERF.md); at 832 the cluster design's
# kernels ran 2.9-3.1x faster than the split kernels' 16-column pieces
_WGX_PASS = 64
_WGX_SLABS = {448: (224, 2), 512: (128, 3), 576: (144, 3), 640: (160, 2),
              704: (88, 3), 768: (64, 2)}
# the cluster wgmma kernels (csrc/encode_stream_wgk.cu): voxels a pass of
# the cluster (QV_WGK_PASS), the bytes of a block's mbarriers
# (QV_WGK_BAR_BYTES), the columns a block compiled (QV_WGK_CASES: Up / C)
# and, for each padded width, its plans, the first that fits taken: the
# cluster's blocks C, the ring's slots, the k-steps of a promoted segment
# and the first of two output chunks' columns (0: one product of a
# block's columns). At 832-1280 on the H100 8 blocks ran 3-5% faster than
# 7 at 896, 4 slots within 1% of 2, segments of 8 k-steps 1-2% faster than
# 4 with C's q within 3.8e-6 of float64. Past 160 columns a block
# (1344-1472) a first chunk of 64 columns ran 1-10% faster than halves, a
# segment of 2 k-steps in 4 slots 2-10% faster than 1 in 2, and at 1408 and
# 1472 one of 3 in 6 slots 1-7% faster than 2 in 4 (at 1344 not); a cluster
# of 16 blocks (88 columns a block, no chunks; 7 resident) ran 34-37%
# slower at 1408 (tools/bench_stream1.py --sweep; PERF.md)
_WGK_PASS = 128
_WGK_BAR_BYTES = 256
_WGK_COLUMNS = (104, 112, 120, 128, 136, 144, 152, 160, 168, 176, 184)
_WGK_PLANS = {**{up: ((8, 2, 8, 0),) for up in range(832, 1281, 64)},
              1344: ((8, 4, 2, 64),),
              1408: ((8, 6, 3, 64), (8, 4, 2, 64)),
              1472: ((8, 6, 3, 64), (8, 4, 2, 64))}
# where the wgmma, split and cluster designs stage a pass's input rows, in
# the order launch_plan tries them: a buffer of their own, then (many taus)
# the first columns of the activation rows, then (a staged row wider than
# an activation row) there a window of the first layer's k-steps at a time;
# the chunked design's rows are always in its activation rows ("separate",
# its one layout of old), windowed where a row is wider. The shared-rows
# kernels compiled: the wgmma design's at these padded widths
# (QV_WG_DISPATCH, the first slab of _WG_SLABS), the split design's at
# every width of _WGX_SLABS (QV_WGX_DISPATCH), the cluster design's at
# these (columns a block, first chunk, segment) (csrc/encode_stream_wgk.cu::
# QV_WGK_SHARED_CASES): the plans whose staged rows of some tau count fit
# in an activation row but not beside the block at the H100's 232,448 B.
# The windowed kernels compiled: the wgmma design's at every width's first
# slab, the chunked and split designs' at every width, the cluster design's
# at every width's first plan (QV_WGK_WINDOWED_CASES): the plans that some
# tau count up to 1024 reaches at the H100's limit (a windowed block's
# bytes are the shared-rows block's, whatever the taus)
_ROWS = ("separate", "shared", "windowed")
_ROW_CODES = {"separate": 0, "shared": 1, "windowed": 2}
_WG_SHARED = (192, 256)
_WGX_SHARED = tuple(_WGX_SLABS)
_WGK_SHARED = ((160, 0, 0), (168, 64, 2), (176, 64, 3), (184, 64, 3))
_WGK_WINDOWED = tuple((up // c, chunk, seg if chunk else 0)
                      for up, ((c, _, seg, chunk), *_) in _WGK_PLANS.items())


def fused_infer_available(activation: str) -> bool:
    return activation in SUPPORTED_ACTS


def _stream1_weights(encoder, n_blocks: int):
    """Stream-1 weights of an ``models.encoder.Encoder`` in the JAX
    kernel's shapes: wfc (U, T), bfc (U, 1), wb (nb, U, U), bb (nb, U, 1),
    wf (5, U), bf (5, 1); the head is zero-padded to 5 output rows so
    diagonal heads read row 4 as 0."""
    wfc = encoder.first_conv.weight.detach()
    bfc = encoder.first_conv.bias.detach()[:, None]
    blocks = [getattr(encoder, f"block_{i}").Dense_0 for i in range(n_blocks)]
    wb = torch.stack([b.weight.detach() for b in blocks])
    bb = torch.stack([b.bias.detach() for b in blocks])[..., None]
    wf = encoder.final.weight.detach()
    bf = encoder.final.bias.detach()
    u = wfc.shape[0]
    wf_t = wf.new_zeros((5, u))
    wf_t[:wf.shape[0]] = wf
    bf_t = bf.new_zeros((5, 1))
    bf_t[:bf.shape[0], 0] = bf
    return wfc, bfc, wb, bb, wf_t, bf_t


def _rows(images, input_layout: str):
    """(x, channel_major): the images as a 2-D (T[+1], N) channel-major
    or (N, T[+1]) voxel-major view."""
    if input_layout == "channel":
        if images.ndim != 2:
            raise ValueError("channel-major images must be (T[+1], N)")
        return images, True
    if input_layout == "voxel":
        return images.reshape(-1, images.shape[-1]), False
    raise ValueError(f"input_layout must be voxel|channel, "
                     f"got {input_layout!r}")


def _check_trunk(trunk: str) -> None:
    if trunk not in ("float32", "bfloat16"):
        raise ValueError(f"trunk must be float32|bfloat16, got {trunk!r}")


def _mm_bf16(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """w @ h on bf16 operands: their products (exact in float32) summed in
    float32, then one rounding to bf16; float32 products whatever the
    device's bf16 matmul flags."""
    return (w.float() @ h.float()).to(torch.bfloat16)


def encode_q_plain(images, encoder, *, se_idx: int, multi_image: bool,
                   activation: str, n_blocks: int, trunk: str,
                   mask_channel: bool = False, input_layout: str = "voxel"):
    """Plain torch version of kernel C, the encode half of kernel B: the
    raw stream-1 head ``q (5, N)``, channel-major (row 4 zero for
    diagonal heads)."""
    _check_trunk(trunk)
    x, channel_major = _rows(images, input_layout)
    x = (x if channel_major else x.T).to(torch.float32)
    wfc, bfc, wb, bb, wf, bf = _stream1_weights(encoder, n_blocks)
    if mask_channel:
        x = x[:-1] * x[-1:]
    if x.shape[0] != wfc.shape[1]:
        raise ValueError(f"images carry {x.shape[0]} tau channels but "
                         f"first_conv expects {wfc.shape[1]}")
    h = normalise_data(x.T, se_idx, multi_image).T      # (T, N)
    if trunk == "float32":
        act = activation_fn(activation)
        h = act(wfc @ h + bfc)                          # (U, N)
        for i in range(n_blocks):
            h = act(wb[i] @ h + bb[i])
        return wf @ h + bf                              # (5, N)
    dt = torch.bfloat16
    act = activation_fn(activation, dt)
    h = act(_mm_bf16(wfc.to(dt), h.to(dt)) + bfc.to(dt))
    for i in range(n_blocks):
        h = act(_mm_bf16(wb[i].to(dt), h) + bb[i].to(dt))
    return wf @ h.float() + bf


def encode_quad_fused_plain(images, encoder, *, se_idx: int,
                            multi_image: bool, activation: str,
                            n_blocks: int, trunk: str, mvg: bool,
                            oef_range: float, min_oef: float,
                            dbv_range: float, min_dbv: float,
                            dw_coeff: float, mask_channel: bool = False,
                            input_layout: str = "voxel"):
    """Plain torch version of kernel B (same contract as the wrapper),
    on whatever device ``images`` lies."""
    q = encode_q_plain(images, encoder, se_idx=se_idx,
                       multi_image=multi_image, activation=activation,
                       n_blocks=n_blocks, trunk=trunk,
                       mask_channel=mask_channel, input_layout=input_layout)
    means, variances, raw = quad_tile_summaries(
        q[0], q[1], q[2], q[3], q[4], mvg=mvg, oef_range=oef_range,
        min_oef=min_oef, dbv_range=dbv_range, min_dbv=min_dbv,
        dw_coeff=dw_coeff)
    return torch.stack(means), torch.stack(variances), torch.stack(raw)


def _tf32(w):
    """w rounded to TF32 (10 mantissa bits, nearest, ties away) as float32:
    the bits of csrc/mma_math.cuh::qv_tf32 (half of the 13 dropped bits
    added to the sign-magnitude pattern, then dropped)."""
    bits = w.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _fragments(w, kp: int, np_: int):
    """The 3xTF32 B fragments of a layer out = w @ in, w (N_out, K_in)
    zero-padded to (np_, kp): [k-step s][n-tile j][lane 4g + t] ->
    (b0 hi, b1 hi, b0 lo, b1 lo), b0 = w[8j + g, 8s + 2t], b1 = w[8j + g,
    8s + 2t + 1], hi = tf32(w), lo = tf32(w - hi) (csrc/mma_math.cuh)."""
    wp = w.new_zeros((np_, kp))
    wp[:w.shape[0], :w.shape[1]] = w
    hi = _tf32(wp)
    lo = _tf32(wp - hi)
    # (n, k) = (8j + g, 8s + 2t + pair) -> [s][j][g][t][hi/lo][pair]
    split = torch.stack([hi, lo]).reshape(2, np_ // 8, 8, kp // 8, 4, 2)
    return split.permute(3, 1, 2, 4, 0, 5).reshape(-1)


def _wg_image(blob, up: int, nb: int, t: int, cn: int | None = None):
    """The wgmma image of a float32 blob's trunk, a permutation of its
    fragments: layer by layer (the first, then each block), its outputs in
    chunks of ``cn`` columns (``up`` by default: csrc/encode_stream_wg.cu;
    fewer past 256, csrc/encode_stream_wgc.cu and encode_stream_wgx.cu),
    each chunk's k-steps in order as K-major core matrices with hi and lo
    apart, [chunk][k-step s][hi | lo][row group j of the chunk][k-half kh]
    [row g][column c] = the split of w[8j + g, 8s + 2c + kh] -- fragment
    (s, j, lane 4g + c) word 2 hi/lo + kh (``_fragments``). With one chunk
    the image is the layers' k-steps in order."""
    nt = up // 8
    cn = up if cn is None else cn
    ks0 = -(-t // 8)
    parts, step = [], 0
    for kl in [ks0] + [nt] * nb:
        frag = blob[step * nt * 128:(step + kl) * nt * 128].view(
            kl, up // cn, cn // 8, 8, 4, 2, 2)
        parts.append(frag.permute(1, 0, 5, 2, 6, 3, 4).reshape(-1))
        step += kl
    return torch.cat(parts)


def _wg_image_of(blob, up: int, nb: int, t: int, cn: int | None = None):
    """``_wg_image`` of ``blob``, derived on the blob's device at its
    first use by the wgmma kernels and kept on the blob (a fused serving
    artifact's buffer derives it once) while the blob is unchanged."""
    key = (blob._version, up, nb, t, cn)
    kept = getattr(blob, "_qv_wg_image", None)
    if kept is None or kept[0] != key:
        kept = (key, _wg_image(blob, up, nb, t, cn))
        blob._qv_wg_image = kept
    return kept[1]


def _core_image(w, kp: int, np_: int):
    """The wgmma B image of a layer out = w @ in (csrc/encode_quad_bf16.cu),
    w (bf16 values) zero-padded to (np_, kp), as float32 words: 8 x 8 core
    matrices, K-major, [k-step s][8-row group][k-half][row][column] --
    element (n, k) at ((s * np_/8 + n // 8) * 2 + k % 16 // 8) * 64 +
    n % 8 * 8 + k % 8, s = k // 16."""
    wp = w.new_zeros((np_, kp), dtype=torch.bfloat16)
    wp[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)
    # (n, k) = (8 ng + r, 16 s + 8 kh + c) -> [s][ng][kh][r][c]
    img = wp.reshape(np_ // 8, 8, kp // 16, 2, 8).permute(2, 0, 3, 1, 4)
    return img.contiguous().reshape(-1).view(torch.float32)


def _bf16_pieces(w):
    """Three bf16 tensors w1, w2, w3 with w1 + w2 + w3 == w exactly for a
    float32 w: w1 its top 8 significant bits (the sign, the exponent and 7
    mantissa bits), w2 the next 8 of w - w1, w3 the rest (at most 8 bits,
    so exact in bf16 for |w| >= 2^-103, where w3 stays a normal bf16).
    Truncation, not rounding, so that no piece overflows at the largest
    floats; the two subtractions are exact in float32."""
    def top(v):
        return (v.contiguous().view(torch.int32) & -65536).view(torch.float32)

    w1 = top(w)
    r1 = w - w1
    w2 = top(r1)
    return w1.to(torch.bfloat16), w2.to(torch.bfloat16), (r1 - w2).to(
        torch.bfloat16)


def _weight_blob(encoder, n_blocks: int, device, trunk: str = "float32"
                 ) -> tuple:
    """The kernel's shared-memory image of the weights, the width U
    zero-padded to Up (``_padded_width``) and the taus T to a whole k-step.
    float32 trunk (layout in csrc/encode_quad.cu): each layer's 3xTF32 hi /
    lo B fragments in k-steps of 8, the head's too, then the padded biases
    and the quadrature node table. bf16 trunk (csrc/encode_quad_bf16.cu):
    the tag ``_BF16_TAG``, each layer's wgmma image of bf16 weights
    (``_core_image``), the head's three bf16 pieces' images
    (``_bf16_pieces``), the biases in bf16, the head's bias in float32 and
    the node table; the blob is marked as checked
    (``_check_blob_layout``)."""
    wfc, bfc, wb, bb, wf, bf = (t.to(device=device, dtype=torch.float32)
                                for t in _stream1_weights(encoder, n_blocks))
    u, t = wfc.shape
    k = _k_step(trunk)
    up, tp = _padded_width(u), -(-t // k) * k

    def pad(b, size):
        return torch.cat([b.reshape(-1), b.new_zeros(size - b.numel())])

    if trunk == "float32":
        blob = torch.cat(
            [_fragments(wfc, tp, up)]
            + [_fragments(wb[i], up, up) for i in range(n_blocks)]
            + [_fragments(wf, up, 8), pad(bfc, up)]
            + [pad(bb[i], up) for i in range(n_blocks)]
            + [pad(bf, 8), _cuda.quad_consts(device)])
        return blob.contiguous(), u, up, t

    def bias16(b):
        return pad(b, up).to(torch.bfloat16).view(torch.float32)

    tag = torch.tensor(_BF16_TAG, dtype=torch.int32).view(torch.float32)
    blob = torch.cat(
        [tag.to(device), _core_image(wfc, tp, up)]
        + [_core_image(wb[i], up, up) for i in range(n_blocks)]
        + [_core_image(p, up, 8) for p in _bf16_pieces(wf)]
        + [bias16(bfc)] + [bias16(bb[i]) for i in range(n_blocks)]
        + [pad(bf, 8), _cuda.quad_consts(device)]).contiguous()
    blob._qv_layout = _BF16_TAG
    return blob, u, up, t


def _check_blob_layout(blob, trunk: str) -> None:
    """Refuse a bf16 weight blob of another layout than this build's: one
    without ``_BF16_TAG`` at its start, as a fused bf16 ``.pt2`` exported
    before the wgmma encode carries. Read once a blob (a device blob's tag
    costs a synchronisation); ``_weight_blob`` marks its own."""
    if trunk != "bfloat16" or getattr(blob, "_qv_layout", None) == _BF16_TAG:
        return
    head = (tuple(blob[:4].view(torch.int32).tolist()) if blob.numel() >= 4
            else ())
    if head != _BF16_TAG:
        raise ValueError(
            "the bf16 weight blob was written in another layout than this "
            "build's kernel reads (no tag "
            f"{_BF16_TAG[0]:#x}, layout {_BF16_TAG[1]}): a fused bf16 "
            "serving artifact exported before it must be exported again "
            "(io/export_model.py::export_inference(fused=True))")
    blob._qv_layout = _BF16_TAG


def _k_step(trunk: str) -> int:
    """Channels a k-step of the trunk's products: 8 (m16n8k8 TF32) or 16
    (wgmma's k16 at bf16)."""
    return 8 if trunk == "float32" else 16


def _padded_width(u: int) -> int:
    """The kernels' width for U units: 16, 32, 64 or 128, the resident
    kernels' compiled widths (csrc/encode_quad.cu::QV_ENCODE_DISPATCH), and
    past 128 a multiple of 64, whole chunks of the streamed kernels'
    n-tiles a warp (csrc/encode_stream.cuh)."""
    for w in _RESIDENT_WIDTHS:
        if u <= w:
            return w
    return -(-u // 64) * 64


def _blob_floats(up: int, nb: int, t: int, trunk: str) -> int:
    """32-bit words of ``_weight_blob``'s blob at padded width ``up``,
    ``nb`` blocks and ``t`` taus."""
    tp = -(-t // _k_step(trunk)) * _k_step(trunk)
    tail = 8 + _NCONST                       # the head's bias, node table
    if trunk == "float32":       # hi + lo fragments: 2 words a weight
        return (2 * tp * up + 2 * nb * up * up + 16 * up + up * (1 + nb)
                + tail)
    # bf16 images: half a word a weight; 3 head pieces; bf16 biases
    return (len(_BF16_TAG) + tp * up // 2 + nb * up * up // 2 + 12 * up
            + up // 2 * (1 + nb) + tail)


def _quad_scratch_floats(threads: int) -> int:
    """csrc/quad_math.cuh::QV_QUAD_SCRATCH: kernel B's quadrature scratch
    for a block of ``threads``."""
    return 2 * 32 + 21 * threads


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How kernel B or C runs at one shape: ``design`` "resident" (the
    whole weight blob in shared memory, csrc/encode_quad.cu or
    encode_quad_bf16.cu), "wgmma" (float32, csrc/encode_stream_wg.cu: a
    ring of ``stages`` slabs of ``ks`` k-steps), "chunked" (float32,
    csrc/encode_stream_wgc.cu: the same with each layer in output chunks
    of ``cn`` columns), "split" (float32, csrc/encode_stream_wgx.cu: the
    same block, a warpgroup's half of each layer's columns in chunks of
    ``cn``, slabs of one k-step), "cluster" (float32,
    csrc/encode_stream_wgk.cu: ``cluster`` such blocks, each ``cn`` = Up /
    ``cluster`` of every layer's columns, slabs of one k-step, the sums
    promoted every ``seg`` k-steps; past 160 columns a block, those in two
    output chunks of ``chunk`` and ``cn - chunk`` columns) or "streamed"
    (bf16, csrc/encode_stream.cuh: ``mt`` m-tiles -- 16 mt voxels a pass
    -- and ``ncw`` n-tiles a warp, slabs of ``ks`` k-steps,
    double-buffered), with the block's ``threads`` and dynamic
    shared-memory bytes ``smem``. ``rows`` is where the wgmma, split and
    cluster designs stage a pass's input rows: "separate" (a buffer of
    their own), "shared" (in the first columns of the activation rows,
    where many taus leave no room for that buffer) or "windowed" (there,
    a window of the first layer's k-steps at a time, where a staged row
    is wider than an activation row); the chunked design's rows are
    always in its activation rows, "separate" (whole) or "windowed"."""

    design: str
    threads: int
    smem: int
    mt: int = 0
    ncw: int = 0
    ks: int = 0
    stages: int = 0
    cn: int = 0
    cluster: int = 0
    seg: int = 0
    chunk: int = 0
    rows: str = "separate"


def _st_ncw(up: int) -> int:
    """n-tiles a warp of the streamed kernels: the 8 warps of a block
    cover 64 outputs at up <= 64, 128 at 128, 256 past it."""
    return 1 if up <= 64 else 2 if up <= 128 else 4


def _st_slabs(up: int, trunk: str) -> list:
    """k-steps of the streamed kernels' slabs that launch_plan tries,
    largest first: _ST_SLAB_BYTES of one chunk's n-tiles (512 B a k-step's
    n-tile in float32, 256 in bf16), at most a block layer's k-steps."""
    fb = 512 if trunk == "float32" else 256
    kmax = up // _k_step(trunk)
    return sorted({min(max(1, b // (8 * _st_ncw(up) * fb)), kmax)
                   for b in _ST_SLAB_BYTES}, reverse=True)


def _st_smem(up: int, t: int, trunk: str, quad: bool, mt: int,
             ks: int) -> int:
    """Shared-memory bytes of the streamed kernels, in the layout of
    csrc/encode_stream.cuh: two slots of slabs of ``ks`` k-steps, the
    activation buffers (one where a layer is one chunk), the staged rows,
    the round's heads and, in B, the node table and the quadrature's
    scratch (in the first activation buffer where it fits)."""
    v, ncw, k = 16 * mt, _st_ncw(up), _k_step(trunk)
    ks0 = -(-t // k)
    if trunk == "float32":
        fb, sa, sx = 512, up + 8, _xs_stride(t)
    else:
        fb, sa, sx = 256, up // 2 + 4, 8 * ks0 + 4
    bufs = 1 if up <= 64 * ncw else 2
    words = bufs * v * sa + v * sx + 5 * _ST_ROUND
    if quad:
        scratch = _quad_scratch_floats(_ST_ROUND)
        words += _NCONST + (scratch if v * sa < scratch else 0)
    return 2 * ks * 8 * ncw * fb + 4 * words


def _wg_smem(up: int, t: int, quad: bool, stages: int, ks: int,
             cn: int | None = None, shared: bool = False) -> int:
    """Shared-memory bytes of the wgmma kernels, in the layout of
    csrc/encode_stream_wg.cu (``cn`` None) or csrc/encode_stream_wgc.cu
    (chunks of ``cn`` columns): the ring's mbarriers, ``stages`` slots of
    ``ks`` k-steps (64 up bytes each, 64 cn chunked), the activation rows
    of a pass, its staged rows (chunked or ``shared``: in the activation
    rows, whole or windowed; then no byte depends on ``t``), the round's
    heads and, in B, the node table and the quadrature's scratch (in the
    activation rows where it fits). A windowed row's reference and mask
    value stay in the staging lanes' registers."""
    act = _WG_PASS * (up + 8)
    rows = 0 if cn or shared else _WG_PASS * _xs_stride(t)
    words = act + rows + 5 * _ST_ROUND
    if quad:
        scratch = _quad_scratch_floats(_ST_ROUND)
        words += _NCONST + (scratch if act < scratch else 0)
    return _WG_BAR_BYTES + stages * ks * 64 * (cn or up) + 4 * words


def _wgx_smem(up: int, t: int, quad: bool, stages: int, cn: int,
              shared: bool = False) -> int:
    """Shared-memory bytes of the split wgmma kernels, in the layout of
    csrc/encode_stream_wgx.cu: the ring's mbarriers, ``stages`` slots of
    two pieces of 64 ``cn`` bytes, the activation rows and the staged rows
    (``shared``: none, they are in the activation rows, whole or windowed)
    of a pass of 64 voxels, the round's heads and, in B, the node table
    (the quadrature's scratch in the activation rows)."""
    rows = 0 if shared else _xs_stride(t)
    words = _WGX_PASS * (up + 8 + rows) + 5 * _ST_ROUND
    if quad:
        words += _NCONST
    return _WG_BAR_BYTES + stages * 2 * 64 * cn + 4 * words


def _wgk_stride(cn: int) -> int:
    """csrc/encode_stream_wgk.cu's SA: words an activation row of ``cn``
    columns, cn + 8 where cn is a multiple of 16, else cn + 16 (8 words
    past a multiple of 16)."""
    return cn + (8 if cn % 16 == 0 else 16)


def _wgk_smem(up: int, t: int, quad: bool, stages: int,
              cluster: int, shared: bool = False) -> int:
    """Shared-memory bytes of a block of the cluster wgmma kernels, in the
    layout of csrc/encode_stream_wgk.cu: its mbarriers, ``stages`` slots of
    one k-step of its Up / ``cluster`` columns (64 bytes a column), those
    columns' activation rows and every staged row of a pass of 128 voxels
    (``shared``: in the activation rows, whole or windowed), the partial
    heads of ``cluster`` blocks for a round of 256 voxels and, in B, the
    node table (the quadrature's scratch in the activation rows)."""
    cn = up // cluster
    rows = 0 if shared else _xs_stride(t)
    words = (_WGK_PASS * (_wgk_stride(cn) + rows)
             + cluster * 5 * _ST_ROUND)
    if quad:
        words += _NCONST
    return _WGK_BAR_BYTES + stages * 64 * cn + 4 * words


def _fits_row(t: int, columns: int) -> bool:
    """Whether a staged row of ``t`` taus (its k-steps' 8 ceil(t / 8)
    channels) fits in the first columns of an activation row of
    ``columns``: the shared-rows layout's condition."""
    return -(-t // 8) * 8 <= columns


def _may_stage(rows: str, t: int, columns: int, shared: bool,
               windowed: bool = True) -> bool:
    """Whether launch_plan tries a plan with these staged ``rows``: a
    buffer of their own always; in the activation rows of ``columns``
    where the build compiles the plan so (``shared``, ``windowed``) and,
    whole, a staged row of ``t`` taus fits in them."""
    if rows == "shared":
        return shared and _fits_row(t, columns)
    return rows == "separate" or windowed


def launch_plan(up: int, nb: int, t: int, t_in: int, trunk: str,
                quad: bool, limit: int) -> LaunchPlan:
    """The launch of kernel B (``quad``) or C at padded width ``up``, ``nb``
    blocks, ``t`` taus of ``t_in`` input channels (a mask channel adds one)
    on a card whose blocks take ``limit`` bytes of shared memory: the
    resident design wherever its blob fits (in float32 beside the staged
    rows of the most warps that fit); else, in float32 at ``up`` <= 256,
    the wgmma design's smallest ring if it fits; in float32 at ``up`` 320
    and 384 the chunked design in two slots if it fits (windowed where a
    staged row is wider than an activation row); in float32 at the ``up``
    of ``_WGK_PLANS`` (832-1472) the cluster design in the first of its
    plans that fits; in float32 at ``up`` 448-768 the split design in its
    ring (``_WGX_SLABS``) if it fits; in bf16 the streamed design with the
    largest pass of voxels, then the largest slab, that fits. Raises if
    none fits. The wgmma, split and cluster designs try their plans with
    separate staged rows first, then (where the build compiles it,
    ``_WG_SHARED``, ``_WGX_SHARED``, ``_WGK_SHARED``, and a staged row fits
    in an activation row of the block's columns) with shared rows, then
    windowed (the cluster design where the build compiles it,
    ``_WGK_WINDOWED``), before the next design; the bytes of a block with
    shared or windowed rows do not depend on ``t``."""
    _check_trunk(trunk)
    scratch = _quad_scratch_floats if quad else (lambda threads: 0)
    blob = _blob_floats(up, nb, t, trunk)
    if up in _RESIDENT_WIDTHS:
        if trunk == "bfloat16":
            smem = 1024 + 4 * (blob - len(_BF16_TAG)
                               + _E16_ROUND * (2 * t_in + 5)
                               + scratch(_E16_THREADS))
            if smem <= limit:
                return LaunchPlan("resident", _E16_THREADS, smem)
        else:
            for warps in _WARPS:
                smem = 4 * (blob + warps * 32 * (_xs_stride(t) + 5)
                            + scratch(32 * warps))
                if smem <= limit:
                    return LaunchPlan("resident", 32 * warps, smem)
    if trunk == "float32" and up in _WG_SLABS:
        ks, stages = _WG_SLABS[up][0], _WG_STAGES[0]
        for rows in _ROWS:
            if not _may_stage(rows, t, up, up in _WG_SHARED):
                continue
            smem = _wg_smem(up, t, quad, stages, ks,
                            shared=rows != "separate")
            if smem <= limit:
                return LaunchPlan("wgmma", _WG_THREADS, smem, ks=ks,
                                  stages=stages, rows=rows)
    if trunk == "float32" and up in _WGC_SLABS:
        cn, ks = _WGC_SLABS[up]
        rows = "separate" if _fits_row(t, up) else "windowed"
        smem = _wg_smem(up, t, quad, _WG_STAGES[0], ks, cn)
        if smem <= limit and rows in _ROWS:
            return LaunchPlan("chunked", _WG_THREADS, smem, ks=ks,
                              stages=_WG_STAGES[0], cn=cn, rows=rows)
    for rows in _ROWS:
        for cluster, stages, seg, chunk in (
                _WGK_PLANS.get(up, ()) if trunk == "float32" else ()):
            key = (up // cluster, chunk, seg if chunk else 0)
            if not _may_stage(rows, t, up // cluster, key in _WGK_SHARED,
                              key in _WGK_WINDOWED):
                continue
            smem = _wgk_smem(up, t, quad, stages, cluster,
                             shared=rows != "separate")
            if smem <= limit:
                return LaunchPlan("cluster", _WG_THREADS, smem, ks=1,
                                  stages=stages, cn=up // cluster,
                                  cluster=cluster, seg=seg, chunk=chunk,
                                  rows=rows)
    if trunk == "float32" and up in _WGX_SLABS:
        cn, stages = _WGX_SLABS[up]
        for rows in _ROWS:
            if not _may_stage(rows, t, up, up in _WGX_SHARED):
                continue
            smem = _wgx_smem(up, t, quad, stages, cn,
                             shared=rows != "separate")
            if smem <= limit:
                return LaunchPlan("split", _WG_THREADS, smem, ks=1,
                                  stages=stages, cn=cn, rows=rows)
    if trunk == "float32":
        raise ValueError(
            f"fused-infer kernel: no launch fits {limit} B of shared memory "
            f"at {up} units (padded), {nb} blocks, T={t} in float32: no "
            f"wgmma design's block fits (the widest is {max(_WGK_PLANS)})")
    for mt in _ST_TILES[_st_ncw(up)]:
        for ks in _st_slabs(up, trunk):
            smem = _st_smem(up, t, trunk, quad, mt, ks)
            if smem <= limit:
                return LaunchPlan("streamed", _ST_THREADS, smem, mt,
                                  _st_ncw(up), ks)
    raise ValueError(
        f"fused-infer kernel: no launch fits {limit} B of shared memory at "
        f"{up} units (padded), {nb} blocks, T={t}: the streamed design's "
        f"smallest pass needs "
        f"{_st_smem(up, t, trunk, quad, 1, _st_slabs(up, trunk)[-1])} B")


def _plan(up: int, nb: int, t: int, t_in: int, trunk: str, quad: bool,
          device) -> LaunchPlan:
    """launch_plan on this card's limit."""
    with torch.cuda.device(device):
        limit = _cuda.library().qv_max_dynamic_smem()
    return launch_plan(up, nb, t, t_in, trunk, quad, limit)


def _xs_stride(t: int) -> int:
    """csrc/encode_quad.cu::qv_xs_stride: words a staged row of T taps in
    the float32 trunk's k-steps of 8 channels."""
    tp = -(-t // 8) * 8
    return tp + 8 if tp % 16 == 0 else tp


def _launch_setup(images, encoder, *, n_blocks: int, activation: str,
                  trunk: str, mask_channel: bool, input_layout: str,
                  se_idx: int):
    """Checks and operands shared by kernels B and C: (x (T[+1], N) or
    (N, T[+1]) contiguous, channel_major, n, weight blob, U, Up, T)."""
    _check_trunk(trunk)
    if not fused_infer_available(activation):
        raise ValueError(f"activation {activation!r} has no kernel "
                         f"implementation (SUPPORTED_ACTS)")
    if images.dtype != torch.float32:
        raise TypeError(f"the fused-infer kernel takes float32, got "
                        f"{images.dtype}")
    x, channel_major = _rows(images, input_layout)
    x = x.contiguous()
    t_in, n = x.shape if channel_major else x.shape[::-1]
    blob, u, up, t = _weight_blob(encoder, n_blocks, images.device, trunk)
    if t_in - int(mask_channel) != t:
        raise ValueError(f"images carry {t_in - int(mask_channel)} tau "
                         f"channels but first_conv expects {t}")
    if not 0 <= se_idx < t:
        raise ValueError(f"se_idx {se_idx} outside the {t} tau channels")
    return x, channel_major, n, blob, u, up, t


def _entry(name: str, trunk: str, lib=None):
    """The C entry of kernel B or C for the trunk's dtype in library
    ``lib`` (the package's by default)."""
    return getattr(lib or _cuda.library(),
                   name + ("_bf16" if trunk == "bfloat16" else ""))


_WG_ENTRY = {"wgmma": "wg", "chunked": "wgc", "split": "wgx",
             "cluster": "wgk"}


def _launch_bc(lib, plan: LaunchPlan, quad: bool, trunk: str, args,
               units: int, up: int, nb: int, t: int, blob, outs, stream,
               ranges=None, mvg: bool = False) -> int:
    """Launch kernel B (``quad``: ``outs`` = means, vars, raw, with the
    quadrature's ``ranges`` and ``mvg``) or C (``outs`` = (q,)) by an
    explicit ``plan`` through the C entries of library ``lib`` (the
    package's, or a build of edited sources with its interface), the rows'
    ``args`` of ``_encode_args``; returns the CUDA error. The wrappers
    launch ``launch_plan``'s plan; tools/bench_stream1.py --sweep and the
    card tests any other."""
    ptrs = tuple(o.data_ptr() for o in outs)
    tail = (ranges, *ptrs, int(mvg)) if quad else ptrs
    size = (plan.threads, plan.smem, stream)
    if plan.design == "resident":
        if quad:
            return _entry("qv_encode_quad_fused", trunk, lib)(
                *args, units, up, nb, blob.data_ptr(), blob.numel(), *tail,
                *size)
        return _entry("qv_encode_q1", trunk, lib)(
            *args, up, nb, blob.data_ptr(), blob.numel(), *tail, *size)
    if plan.design == "streamed":
        name = "qv_encode_quad_stream" if quad else "qv_encode_q1_stream"
        return _entry(name, trunk, lib)(
            *args, up, nb, blob.data_ptr(), *tail, plan.mt, plan.ncw,
            plan.ks, *size)
    rows = _ROW_CODES[plan.rows]
    knobs = {"wgmma": (plan.stages, plan.ks, rows),
             "chunked": (plan.stages, plan.ks, plan.cn, int(rows == 2)),
             "split": (plan.stages, plan.cn, rows),
             "cluster": (plan.stages, plan.cluster, plan.seg, plan.chunk,
                         rows)}[plan.design]
    image = _wg_image_of(blob, up, nb, t, plan.cn or None)
    return getattr(lib, _wg_entry(plan, quad))(
        *args, up, nb, blob.data_ptr(), image.data_ptr(), *tail, *knobs,
        *size)


def _wg_entry(plan: LaunchPlan, quad: bool) -> str:
    """The C entry of kernel B (``quad``) or C at a wgmma-family plan:
    the cluster design's windowed kernels have their own, compiled apart
    (csrc/encode_stream_wgk_w.cu, encode_stream_wgk_wc.cu)."""
    windowed = plan.design == "cluster" and plan.rows == "windowed"
    return (("qv_encode_quad_" if quad else "qv_encode_q1_")
            + _WG_ENTRY[plan.design] + ("_w" if windowed else ""))


_COUNTER_PREFIX = {"resident": "", "streamed": "stream_", "wgmma": "wgmma_",
                   "chunked": "chunked_", "split": "split_",
                   "cluster": "cluster_"}


def _count(wrapper, plan: LaunchPlan, trunk: str) -> None:
    """One launch of kernel B or C, counted by design and trunk."""
    name = _COUNTER_PREFIX[plan.design] + (
        "bf16_launches" if trunk == "bfloat16" else "launches")
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def _encode_args(x, n, channel_major, mask_channel, se_idx, multi_image,
                 activation):
    return (x.data_ptr(), n, x.shape[0] if channel_major else x.shape[1],
            int(channel_major), int(mask_channel), se_idx, int(multi_image),
            SUPPORTED_ACTS.index(activation))


def encode_quad_fused(images, encoder, *, se_idx: int, multi_image: bool,
                      activation: str, n_blocks: int, trunk: str, mvg: bool,
                      oef_range: float, min_oef: float, dbv_range: float,
                      min_dbv: float, dw_coeff: float,
                      mask_channel: bool = False,
                      input_layout: str = "voxel"):
    """Fused stream-1 encode + quadrature summaries (see module
    docstring). CUDA tensors launch kernel B through the registered op
    ``torch.ops.qbold_vi_tpu_torch.encode_quad_fused`` or raise; CPU
    tensors run the plain version."""
    kw = dict(se_idx=se_idx, multi_image=multi_image, activation=activation,
              n_blocks=n_blocks, trunk=trunk, mvg=mvg, oef_range=oef_range,
              min_oef=min_oef, dbv_range=dbv_range, min_dbv=min_dbv,
              dw_coeff=dw_coeff, mask_channel=mask_channel,
              input_layout=input_layout)
    if images.device.type == "cpu":
        return encode_quad_fused_plain(images, encoder, **kw)
    if images.device.type != "cuda":
        raise ValueError(f"no fused-infer kernel for device {images.device}")
    x, channel_major, _, blob, u, up, _ = _launch_setup(
        images, encoder, n_blocks=n_blocks, activation=activation,
        trunk=trunk, mask_channel=mask_channel, input_layout=input_layout,
        se_idx=se_idx)
    return encode_quad_fused_op(
        x, blob, u, up, n_blocks, channel_major, mask_channel, se_idx,
        multi_image, activation, trunk, mvg, oef_range, min_oef, dbv_range,
        min_dbv, dw_coeff)


@torch.library.custom_op("qbold_vi_tpu_torch::encode_quad_fused",
                         mutates_args=(), device_types="cuda")
def encode_quad_fused_op(x: torch.Tensor, blob: torch.Tensor, units: int,
                         padded_units: int, n_blocks: int,
                         channel_major: bool, mask_channel: bool,
                         se_idx: int, multi_image: bool, activation: str,
                         trunk: str, mvg: bool, oef_range: float,
                         min_oef: float, dbv_range: float, min_dbv: float,
                         dw_coeff: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B as a registered op on the card, its operands as tensors
    and its scalars as attributes: the rows ``x`` (T[+1], N) channel-major
    or (N, T[+1]) voxel-major, contiguous, and the weight blob of
    ``_weight_blob`` (width ``units`` padded to ``padded_units``, the
    quadrature node table at its end; a bf16 blob of another layout is
    refused, ``_check_blob_layout``); returns channel-major (means,
    vars, raw), each (3, N), launched on the current stream by the design
    ``launch_plan`` picks and counted by ``_count``. ``encode_quad_fused``
    and the fused serving artifact (io/export_model.py) call it; it
    mutates none of its inputs."""
    n = x.shape[1] if channel_major else x.shape[0]
    t = (x.shape[0] if channel_major else x.shape[1]) - int(mask_channel)
    outs = [torch.empty((3, n), device=x.device, dtype=torch.float32)
            for _ in range(3)]
    if n == 0:
        return tuple(outs)
    _check_blob_layout(blob, trunk)
    if blob.numel() != _blob_floats(padded_units, n_blocks, t, trunk):
        raise ValueError(
            f"fused-infer kernel: a weight blob of {blob.numel()} words, not "
            f"the {_blob_floats(padded_units, n_blocks, t, trunk)} of "
            f"{padded_units} units (padded), {n_blocks} blocks, T={t}")
    plan = _plan(padded_units, n_blocks, t, t + int(mask_channel), trunk,
                 True, x.device)
    args = _encode_args(x, n, channel_major, mask_channel, se_idx,
                        multi_image, activation)
    ranges = _cuda.quad_ranges(oef_range=oef_range, min_oef=min_oef,
                               dbv_range=dbv_range, min_dbv=min_dbv,
                               dw_coeff=dw_coeff)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _launch_bc(_cuda.library(), plan, True, trunk, args, units,
                         padded_units, n_blocks, t, blob, outs, stream,
                         ranges, mvg)
    _cuda.check(err, "fused-infer")
    _count(encode_quad_fused, plan, trunk)
    return tuple(outs)


@encode_quad_fused_op.register_fake
def _encode_quad_fused_shapes(x, blob, units, padded_units, n_blocks,
                              channel_major, mask_channel, se_idx,
                              multi_image, activation, trunk, mvg,
                              oef_range, min_oef, dbv_range, min_dbv,
                              dw_coeff):
    # shapes only: no data, no launch (tracing and export)
    n = x.shape[1] if channel_major else x.shape[0]
    return tuple(x.new_empty((3, n), dtype=torch.float32) for _ in range(3))


def encode_q1_packed(images, encoder, *, se_idx: int, multi_image: bool,
                     activation: str, n_blocks: int, trunk: str,
                     mask_channel: bool = False,
                     input_layout: str = "voxel"):
    """Fused stream-1 encode -> the raw head ``q (5, N)``, channel-major
    (row 4 zero for a diagonal head), with kernel B's contract for the
    layouts, the mask channel and the trunk. CUDA tensors launch kernel C
    by the design ``launch_plan`` picks (counted as kernel B's, in
    ``encode_q1_packed.launches``, ``.bf16_launches``,
    ``.wgmma_launches``, ``.chunked_launches``, ``.split_launches``,
    ``.cluster_launches`` and ``.stream_bf16_launches``) or raise; CPU
    tensors run ``encode_q_plain``. Unlike the TPU kernel, N is not
    padded."""
    kw = dict(se_idx=se_idx, multi_image=multi_image, activation=activation,
              n_blocks=n_blocks, trunk=trunk, mask_channel=mask_channel,
              input_layout=input_layout)
    if images.device.type == "cpu":
        return encode_q_plain(images, encoder, **kw)
    if images.device.type != "cuda":
        raise ValueError(f"no fused-infer kernel for device {images.device}")
    x, channel_major, n, blob, u, up, t = _launch_setup(
        images, encoder, n_blocks=n_blocks, activation=activation,
        trunk=trunk, mask_channel=mask_channel, input_layout=input_layout,
        se_idx=se_idx)
    q = torch.empty((5, n), device=images.device, dtype=torch.float32)
    if n == 0:
        return q
    plan = _plan(up, n_blocks, t, t + int(mask_channel), trunk, False,
                 images.device)
    args = _encode_args(x, n, channel_major, mask_channel, se_idx,
                        multi_image, activation)
    stream = torch.cuda.current_stream(images.device).cuda_stream
    with torch.cuda.device(images.device):
        err = _launch_bc(_cuda.library(), plan, False, trunk, args, u, up,
                         n_blocks, t, blob, (q,), stream)
    _cuda.check(err, "stream-1 encode")
    _count(encode_q1_packed, plan, trunk)
    return q


for _w in (encode_quad_fused, encode_q1_packed):
    _w.launches = _w.bf16_launches = _w.wgmma_launches = 0
    _w.chunked_launches = _w.split_launches = _w.cluster_launches = 0
    _w.stream_bf16_launches = 0
