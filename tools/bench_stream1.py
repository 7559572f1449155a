"""Time kernels B, C and D (qbold_vi_tpu_torch/csrc/encode_quad.cu and
summarize.cu) on the stream-1 serving request, kernel A (quadrature.cu:
B's quadrature tail alone) on four head mixes, and kernel E (summarize.cu)
on one subject, with each build's errors and its registers, spills, stack
frame, shared memory, blocks an SM and SASS instructions.

    python3 tools/bench_stream1.py [--dtype float32|bfloat16|both]
        [--units U] [--blocks NB] [--shapes UxNB[xT],...] [--sweep]
        [--slots S,...] [--segments K,...] [--chunks C,...]
        [--clusters C,...]
        [--only-copies]
        [--row-blob SRC ...]
        [--package DIR] [SRC ...]

Run it from the repository's root on a machine with the card, as
``env PYTHONPATH=. python3 tools/bench_stream1.py _chip_checkout/<copy>/
quadrature.cu ...``, with the edited copies in a git-ignored directory.

Builds the package's kernels (``ops/_cuda.library``) and, for each further
source given -- an edited copy of ``csrc/encode_quad.cu``,
``csrc/summarize.cu`` or ``csrc/quadrature.cu`` with the package's C
entries -- a library of that
file alone with the same nvcc flags and ``-I csrc``, all compiles started
at once (a copy's own directory comes first on the include path, so an
edited header beside it replaces the package's). A source given with
``--row-blob`` is a copy of the earlier encode (one thread a voxel on the
CUDA cores), whose weight blob is row-major and whose block carries two
activation columns a thread; the tool packs that blob itself.
``--only-copies`` times the given sources alone.

The request is OPTIMAL's stream-1 serving request: 1,032,192 voxels
(14 x 96 x 96 x 8), 11 taus + a mask channel, voxel-major, U 60, 2
blocks, MVG, relu, random weights (``init_params`` seed 0); ``--units``
and ``--blocks`` change the trunk's width and depth (``init_params`` of
that configuration, seed 0), ``--shapes`` also the taus (a scan of T
taus: OPTIMAL's with the tau_step that gives T, ``scan_of``), and kernels
B and C then run the design
``fused_infer.launch_plan`` picks there: the resident entries
(``qv_encode_quad_fused``, ``qv_encode_q1``), the float32 wgmma ones
(``qv_encode_quad_wg``, ``qv_encode_q1_wg``, kernels
``qv_encode_quad_wg_kernel`` and ``qv_encode_q_wg_kernel``, fed the
blob's wgmma image ``fused_infer._wg_image``; an edited copy of
``csrc/encode_stream_wg.cu`` keeps their C interface and the plan's
shared-memory layout), at 320 and 384 units (padded) the chunked wgmma
ones (``qv_encode_quad_wgc``, ``qv_encode_q1_wgc``, kernels
``qv_encode_quad_wgc_kernel`` and ``qv_encode_q_wgc_kernel``, fed the
image in the plan's chunks, ``fused_infer._wg_image(..., cn)``; an edited
copy of ``csrc/encode_stream_wgc.cu`` likewise, beside which an edited
``encode_stream_wg.cuh`` replaces the package's), at 448-768 the split
wgmma ones (``qv_encode_quad_wgx``, ``qv_encode_q1_wgx``, kernels
``qv_encode_quad_wgx_kernel`` and ``qv_encode_q_wgx_kernel``, fed the
image in the plan's chunks; an edited copy of
``csrc/encode_stream_wgx.cu`` likewise), at 832-1472 the cluster wgmma
ones (``qv_encode_quad_wgk``, ``qv_encode_q1_wgk``, kernels
``qv_encode_quad_wgk_kernel`` and ``qv_encode_q_wgk_kernel``, fed the
image in chunks of a block's columns, past 160 columns a block computed
in two output chunks, with the clusters the card holds at once,
``qv_encode_wgk_clusters``; an edited copy of
``csrc/encode_stream_wgk.cu`` likewise; the wgmma, chunked, split and
cluster designs with the plan's staged rows, separate, in the activation
rows or there a window at a time, ``LaunchPlan.rows``, every launch
through ``fused_infer._launch_bc``) or, in bf16, the streamed ones
(``qv_encode_quad_stream_bf16``, ``qv_encode_q1_stream_bf16``, kernels
``qv_encode_quad_stream_bf16_kernel`` and
``qv_encode_q_stream_bf16_kernel``; an edited copy of
``csrc/encode_stream_bf16.cu`` likewise). Per build it prints:

* B (``qv_encode_quad_fused``): means / vars / raw against the plain
  version; C (``qv_encode_q1``): q against the plain version and against
  a float64 encode of the same rows (``chip_smoke.encode_q_f64``);
* A (``qv_quad_posterior_summaries``, on C's q as (N, 5) rows): means /
  vars against the plain version;
* D (``qv_mc_summaries``, the channel-major entry on C's q, S = 200
  antithetic): means / vars against the plain version fed the same host
  normals; with device noise (65,536 voxels) against the plain version fed
  each replay of the counters (``ops/summarize.py::mc_philox_normals``,
  one Philox block for two pairs, and ``ops/fused_elbo.py::philox_normals``,
  one a pair, as the earlier D drew them); each error with whether chip_smoke's
  gates (``CHECKS``) hold;
* A on four head mixes of 1,032,192 rows: C's q rows, chip_smoke's
  straddling heads (``chip_smoke.raw_head``), heads whose three logit stds
  all lie below the s = 1.5 split and heads whose stds all lie at or above
  it; per mix, the share of voxels each 1-D moment routine sends to the
  Gauss-Laguerre side and the share of 32-voxel warps that straddle the
  split; A's errors against the plain version and against a float64
  evaluation of the same node words (the plain version in double), beside
  the plain float32 version's;
* E (``qv_mc_kl_map``, or an earlier build's ``qv_mc_kl``) on one
  subject, 73,728 voxels, S = 100: against the plain version fed the same
  host normals and, with device noise, fed ``mc_philox_normals``;
* device ms by the profiler (median of 21 calls after warm-up,
  ``chip_smoke.kernel_ms``) and ms a call by CUDA events: A on each mix, B
  and C (and both with the activation gelu on the same weights, timing
  only), D at S = 200 with device noise, D at S = 2 (the per-voxel work
  alone) and D with host normals; E at S = 100 with device noise, at
  S = 2, with host normals, in blocks of 64, 128 and 256 threads, and at
  4x the voxels (timing only: what a grid too small for the card loses).
  Other lane counts are edited copies of ``csrc/summarize.cu`` with
  another ``QV_KL_LANES``, e.g. for L in 1 4 8: ``mkdir -p
  _chip_checkout/e$L && sed "s/^#define QV_KL_LANES 2$/#define
  QV_KL_LANES $L/" qbold_vi_tpu_torch/csrc/summarize.cu >
  _chip_checkout/e$L/summarize.cu``.

``--package DIR`` imports ``qbold_vi_tpu_torch`` from DIR (another
checkout, e.g. the parent's unpacked by ``git archive`` into
``_chip_checkout/parent``, or ``.`` for this one) and times only B, C and
A through that package's wrappers, with their errors, C's head against a
float64 head on the plain version's features (``chip_smoke.head_f64_err``)
and B beside C + A: the way to time two commits in one call, in turns
(parent, change, change, parent; ``--dtype both`` runs both trunks in
one process). ``--shapes 60x2,256x2,768x1x51,...`` takes each width x
depth [x taus] given in place of ``--units`` / ``--blocks``, with or
without ``--package``.

``--sweep`` times B and C (errors against the plain versions, device ms)
by each build (the package's and each copy) under every plan of the
design ``launch_plan`` picks that fits the card's shared memory at the
request's width and depth -- the measurement behind
``launch_plan``'s order: streamed (bf16), each tile (m-tiles a pass) of
``fused_infer._ST_TILES`` and each slab of ``fused_infer._st_slabs``;
wgmma, each slab compiled for the width (``fused_infer._WG_SLABS``: its
k-steps and bytes) and each ring of ``fused_infer._WG_STAGES`` slots;
chunked, each ring of the width's chunks and slab
(``fused_infer._WGC_SLABS``), its rows whole or windowed; split, every chunk width that divides a
warpgroup's columns and each ring (``fused_infer._WGX_SLABS`` holds the
plan's); cluster, every cluster of at most 8 blocks whose columns a
block the package compiles, each ring of SLOTS, each promoted segment
of SEGMENTS and, past 160 columns a block, each first output chunk of
CHUNKS (``--slots``, ``--segments``, ``--chunks``;
``fused_infer._WGK_PLANS`` holds the plan's; ``--clusters`` the cluster
sizes), with the resident clusters; the wgmma, split and cluster plans
each with separate staged rows and, where a staged row fits in an
activation row of the block's columns, with shared rows, and with
windowed rows (a plan the build does not compile is skipped).
Each plan's row gives B's CHECKS verdict, C's distance to the float64
encode and B's and C's registers and spills (ptxas). A build's cluster
instantiations are its ``QV_WGK_CASES`` (``QV_WGK_WINDOWED_CASES`` with
windowed rows): sweep other chunks and segments as a copy of
``csrc/encode_stream_wgk.cu`` with more cases. The wgmma
designs' other knobs are compiled in (two consumer warpgroups of 64
voxels; a pass of 128 voxels a cluster): time another as an edited copy of
``csrc/encode_stream_wg.cu``, ``encode_stream_wgc.cu``,
``encode_stream_wgx.cu`` or ``encode_stream_wgk.cu`` (each build is
swept).

``--dtype bfloat16`` runs B and C at trunk="bfloat16" (the entries
``qv_encode_quad_fused_bf16`` and ``qv_encode_q1_bf16``, kernels
``qv_encode_quad_bf16_kernel`` and ``qv_encode_q_bf16_kernel``) against
the plain versions at the same trunk; the float64 encode and the other
kernels are as above (A, D and E take the bf16 trunk's q).

Blocks an SM are computed from ptxas's registers and the block's shared
memory against the H100's limits (65,536 registers allocated 256 a warp,
233,472 B of shared memory with 1 KB reserved a block, 2,048 threads, 32
blocks). SASS per kernel by ``cuobjdump -sass``: its instructions and its
special-function (MUFU) instructions by kind, as compiled (a loop body
counts once). Needs one CUDA card; about a minute with ten builds.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
# --package DIR: that checkout's qbold_vi_tpu_torch (read before the
# imports below)
if "--package" in sys.argv[:-1]:
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--package") + 1])
                           .resolve()))

from chip_smoke import (branch_shares, check_close,  # noqa: E402
                        check_rows, cuda_ms, encode_q_f64, gpu_line,
                        head_f64_err, kernel_ms, raw_head, sass, squashed,
                        volumes, wide_bound)
from qbold_vi_tpu_torch import OPTIMAL, FineTuner, init_params  # noqa: E402
from qbold_vi_tpu_torch.ops import _cuda  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_elbo as fe  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_infer as fi  # noqa: E402
from qbold_vi_tpu_torch.ops import quadrature as quad  # noqa: E402
from qbold_vi_tpu_torch.ops import summarize as sm  # noqa: E402
from qbold_vi_tpu_torch.dist.logit_mvn import KL_BOUND  # noqa: E402
from qbold_vi_tpu_torch.ops.decode_nll import _BLOCK, _grid  # noqa: E402

N = 14 * 96 * 96 * 8
N_NOISE = 65_536
N_SUBJ = 96 * 96 * 8                 # kernel E's chunk: one subject
S, SEED = 200, 3
S_KL = 100
ENTRIES = ("qv_quad_posterior_summaries", "qv_encode_quad_fused",
           "qv_encode_q1", "qv_encode_quad_fused_bf16", "qv_encode_q1_bf16",
           "qv_encode_quad_wg", "qv_encode_q1_wg",
           "qv_encode_quad_wgc", "qv_encode_q1_wgc",
           "qv_encode_quad_wgx", "qv_encode_q1_wgx",
           "qv_encode_quad_wgk", "qv_encode_q1_wgk", "qv_encode_wgk_clusters",
           "qv_encode_quad_wgk_w", "qv_encode_q1_wgk_w",
           "qv_encode_quad_stream_bf16", "qv_encode_q1_stream_bf16",
           "qv_mc_summaries", "qv_mc_kl_map", "qv_mc_kl")
# C entries of earlier builds that the package no longer has: the earlier
# kernel E took (grid, block), one thread a voxel
EARLIER = {"qv_mc_kl": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]}
KERNELS = dict(A="qv_quad_kernel", B="qv_encode_quad_kernel",
               C="qv_encode_q_kernel", D="qv_mc_summaries_kernel",
               E="qv_mc_kl_kernel")
MIXES = ("C rows", "straddling", "below", "above")   # kernel A's heads
# the tau_step of a scan of T taus (OPTIMAL's grid otherwise): the ones
# chip_smoke.py and the card tests use
TAU_STEPS = {51: 0.0016, 96: 0.00085, 128: 0.000635, 330: 0.000246,
             512: 0.0001585}


def scan_of(taus: int):
    """OPTIMAL's scan with ``taus`` taus: its own at 11, else its grid at
    TAU_STEPS' step or one that gives ``taus`` (span / (taus - 1/2))."""
    scan = OPTIMAL.scan
    if taus != scan.n_taus:
        step = TAU_STEPS.get(taus, (scan.tau_end - scan.tau_start)
                             / (taus - 0.5))
        scan = dataclasses.replace(scan, tau_step=step)
    if scan.n_taus != taus:
        raise ValueError(f"no scan of {taus} taus (tau_step {step})")
    return scan


def build_variants(paths):
    """{name: (ctypes library, nvcc log, .so path)} of each source, built
    with the port's flags. A source whose package file has a companion
    ``<stem>_c.cu`` (encode_stream_wgx.cu, encode_stream_wgk.cu: kernel
    C's entries compiled apart; encode_stream_wgk.cu's windowed kernels'
    ``_w.cu`` and ``_wc.cu`` too) is built with those companions, pointed
    at the copy."""
    out_dir = _cuda.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for path in map(Path, paths):
        name = f"{path.parent.name}/{path.stem}"
        so = out_dir / f"{path.parent.name}_{path.stem}.so"
        srcs = [str(path)]
        for part in ("_c", "_w", "_wc"):
            companion = _cuda.CSRC / f"{path.stem}{part}.cu"
            if not companion.is_file():
                continue
            c_src = out_dir / f"{path.parent.name}_{path.stem}{part}.cu"
            c_src.write_text(companion.read_text().replace(
                f'#include "{path.name}"', f'#include "{path.resolve()}"'))
            srcs.append(str(c_src))
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{path.resolve().parent}",
               f"-I{_cuda.CSRC}", "-shared", "-o", str(so), *srcs]
        procs.append((name, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        libs[name] = (bind(ctypes.CDLL(str(so))), log, so)
    return libs


def bind(lib):
    """Set the argument types of the C entries the library has."""
    for fn in ENTRIES:
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = _cuda._SIGNATURES.get(fn,
                                                              EARLIER.get(fn))
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def resources(log: str, kernels: dict, inst: str) -> dict:
    """{kernel symbol: (registers, static shared bytes, 'stack / spill'
    text)} of ``kernels``' symbols from ptxas's --resource-usage report
    (of a templated kernel, the request's instantiation ``inst``, e.g.
    "ILi64E" for a bf16 resident kernel at Up = 64)."""
    out = {}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"Function properties for \S*?(qv_\w+_kernel)", line)
        templated = m is not None and any(
            k in m.group(1)
            for k in ("bf16", "stream", "_wg_", "_wgc_", "_wgx_", "_wgk_"))
        if (m and m.group(1) in kernels.values() and i + 2 < len(lines)
                and (not templated or inst in line)):
            regs = re.search(r"Used (\d+) registers", lines[i + 2])
            smem = re.search(r"(\d+) bytes smem", lines[i + 2])
            out[m.group(1)] = (int(regs.group(1)) if regs else -1,
                               int(smem.group(1)) if smem else 0,
                               lines[i + 1].strip())
    return out


def blocks_per_sm(regs: int, threads: int, smem: int) -> int:
    warps = -(-threads // 32)
    by_regs = 65536 // (-(-regs * 32 // 256) * 256 * warps)
    return min(by_regs, 233_472 // (smem + 1024), 2048 // threads, 32)


def row_blob_setup(x, encoder, n_blocks):
    """The earlier encode's operands: the row-major blob (transposed weights padded to
    U rounded up to 4, then the quadrature table) and the block's shared
    memory with two activation columns of max(T, Up) floats a thread."""
    wfc, bfc, wb, bb, wf, bf = fi._stream1_weights(encoder, n_blocks)
    u, t = wfc.shape
    up = -(-u // 4) * 4
    z = lambda *s: torch.zeros(s, device=x.device)              # noqa: E731
    wfc_t, bfc_p, wb_t, bb_p, wf_t, bf_p = (
        z(t, up), z(up), z(n_blocks, up, up), z(n_blocks, up), z(up, 8),
        z(8))
    wfc_t[:, :u] = wfc.T
    bfc_p[:u] = bfc[:, 0]
    wb_t[:, :u, :u] = wb.transpose(1, 2)
    bb_p[:, :u] = bb[..., 0]
    wf_t[:u, :5] = wf.T
    bf_p[:5] = bf[:, 0]
    blob = torch.cat([wfc_t.reshape(-1), bfc_p, wb_t.reshape(-1),
                      bb_p.reshape(-1), wf_t.reshape(-1), bf_p,
                      _cuda.quad_consts(x.device)]).contiguous()
    block = 128
    return blob, u, up, block, 4 * (blob.numel() + 2 * max(t, up) * block)


class Calls:
    """The C entries of one build on the request's operands."""

    def __init__(self, lib, row_blob, ctx):
        self.lib, self.ctx = lib, ctx
        x, enc = ctx["x"], ctx["encoder"]
        self.nb = nb = ctx["kw"]["n_blocks"]
        if row_blob:
            self.blob, self.u, self.up, self.block, self.smem = row_blob_setup(
                x, enc, nb)
            self.block_b, self.smem_b = self.block, self.smem
            self.plan_b = self.plan_c = None
        else:
            _, _, _, self.blob, self.u, self.up, self.t = fi._launch_setup(
                x, enc, trunk=ctx["trunk"], **ctx["setup"])
            # kernel B's plan counts its quadrature's scratch
            self.plan_b, self.plan_c = (
                fi._plan(self.up, nb, self.t, self.t + 1, ctx["trunk"], quad_,
                         x.device)
                for quad_ in (True, False))
            self.block_b, self.smem_b = self.plan_b.threads, self.plan_b.smem
            self.block, self.smem = self.plan_c.threads, self.plan_c.smem
        self.stream = torch.cuda.current_stream().cuda_stream

    def design(self) -> str:
        return "row blob" if self.plan_b is None else self.plan_b.design

    def streamed(self) -> bool:
        return self.design() == "streamed"

    def enc_args(self, act):
        c = self.ctx
        return fi._encode_args(c["x"], N, False, True, c["kw"]["se_idx"],
                               c["kw"]["multi_image"],
                               act or c["kw"]["activation"])

    def b(self, act=None):
        ranges = _cuda.quad_ranges(**self.ctx["ranges"])
        if self.plan_b is None:              # the earlier row-blob encode
            o = [t.data_ptr() for t in self.ctx["b_out"]]
            err = getattr(self.lib, "qv_encode_quad_fused" + self.ctx["tag"])(
                *self.enc_args(act), self.u, self.up, self.nb,
                self.blob.data_ptr(), self.blob.numel(), ranges, *o, 1,
                self.block_b, self.smem_b, self.stream)
        else:
            err = fi._launch_bc(self.lib, self.plan_b, True, self.ctx["trunk"],
                                self.enc_args(act), self.u, self.up, self.nb,
                                self.t, self.blob, self.ctx["b_out"],
                                self.stream, ranges, True)
        _cuda.check(err, "B")

    def c(self, act=None):
        if self.plan_c is None:              # the earlier row-blob encode
            err = getattr(self.lib, "qv_encode_q1" + self.ctx["tag"])(
                *self.enc_args(act), self.up, self.nb, self.blob.data_ptr(),
                self.blob.numel(), self.ctx["q_out"].data_ptr(), self.block,
                self.smem, self.stream)
        else:
            err = fi._launch_bc(self.lib, self.plan_c, False,
                                self.ctx["trunk"], self.enc_args(act), self.u,
                                self.up, self.nb, self.t, self.blob,
                                (self.ctx["q_out"],), self.stream)
        _cuda.check(err, "C")

    def a(self, mix="C rows", block=quad.QUAD_BLOCK):
        q = self.ctx["heads"][mix]
        err = self.lib.qv_quad_posterior_summaries(
            q.data_ptr(), N, 5, 1, _cuda.quad_ranges(**self.ctx["ranges"]),
            _cuda.quad_consts(q.device).data_ptr(),
            *(t.data_ptr() for t in self.ctx["a_out"]), -(-N // block),
            block, self.stream)
        _cuda.check(err, "A")

    def e(self, q, p, z=None, s=S_KL, block=_BLOCK):
        """Kernel E on rows q, p (n, 5)."""
        n = q.shape[0]
        kl = self.ctx["e_out"][:n]
        args = (q.data_ptr(), p.data_ptr(), n, 1,
                None if z is None else z.data_ptr(), 0, SEED, s, KL_BOUND,
                kl.data_ptr())
        if hasattr(self.lib, "qv_mc_kl_map"):
            err = self.lib.qv_mc_kl_map(*args, block, self.stream)
        else:
            err = self.lib.qv_mc_kl(*args, -(-n // block), block,
                                    self.stream)
        _cuda.check(err, "E")
        return kl

    def d(self, q_t, z=None, seed=SEED, s=S, out=None):
        n = q_t.shape[1]
        draws = sm.mc_draws(s)
        means, variances = out if out is not None else self.ctx["d_out"]
        err = self.lib.qv_mc_summaries(
            q_t.data_ptr(), n, 1, n, 1, _cuda.quad_ranges(**self.ctx["ranges"]),
            None if z is None else z.data_ptr(), 0, seed, draws, 1, 1.0 / s,
            means.data_ptr(), variances.data_ptr(), 1, n, _grid(n), _BLOCK,
            self.stream)
        _cuda.check(err, "D")


def trunk_config(units, blocks):
    """OPTIMAL's model at the trunk's width and depth."""
    return dataclasses.replace(OPTIMAL.model, no_units=units,
                               no_intermediate_layers=blocks)


def context(dev, trunk="float32", units=60, blocks=2, taus=11):
    cfg, scan = trunk_config(units, blocks), scan_of(taus)
    tuner = FineTuner(cfg, scan, device=dev)
    tuner.load_state_dict(init_params(cfg, scan,
                                      torch.Generator().manual_seed(0)))
    kw = dict(se_idx=scan.se_idx, multi_image=cfg.multi_image_normalisation,
              activation=cfg.activation, n_blocks=cfg.no_intermediate_layers,
              mask_channel=True, input_layout="voxel")
    ranges = dict(oef_range=cfg.oef_range, min_oef=cfg.min_oef,
                  dbv_range=cfg.dbv_range, min_dbv=cfg.min_dbv,
                  dw_coeff=float(scan.dw_coeff * scan.hct))
    x = torch.from_numpy(volumes(np.random.default_rng(0), (N,),
                                 scan.n_taus)).to(dev)
    plain_kw = dict(kw, trunk=trunk)
    q_plain = fi.encode_q_plain(x, tuner.encoder, **plain_kw)
    b_plain = fi.encode_quad_fused_plain(x, tuner.encoder, mvg=True,
                                         **ranges, **plain_kw)
    q64 = encode_q_f64(x, tuner.encoder, **kw)
    draws = sm.mc_draws(S)
    z = torch.randn((draws, N, 2), device=dev)
    d_plain = sm.mc_posterior_summaries_plain(q_plain.T, z, mvg=True,
                                              **ranges)
    f32 = dict(device=dev, dtype=torch.float32)
    rng = np.random.default_rng(8)
    heads = {"C rows": q_plain.T.contiguous()}
    heads.update({mix: torch.from_numpy(raw_head(rng, N, mix)).to(dev)
                  for mix in MIXES[1:]})
    qe = heads["straddling"][:4 * N_SUBJ]
    pe = torch.from_numpy((rng.normal(size=(4 * N_SUBJ, 5)) * 0.7).astype(
        np.float32)).to(dev)
    ze = torch.from_numpy(rng.normal(size=(S_KL, N_SUBJ, 2)).astype(
        np.float32)).to(dev)
    return dict(
        heads=heads, a_out=[torch.empty((N, 3), **f32) for _ in range(2)],
        a_plain={k: quad.posterior_summaries_quadrature(h, mvg=True, **ranges)
                 for k, h in heads.items()},
        a_f64={k: quad.posterior_summaries_quadrature(h.double(), mvg=True,
                                                      **ranges)
               for k, h in heads.items()},
        qe=qe, pe=pe, ze=ze, e_out=torch.empty((4 * N_SUBJ,), **f32),
        e_plain=sm.mc_kl_map_plain(qe[:N_SUBJ], pe[:N_SUBJ], ze),
        e_plain_dev=sm.mc_kl_map_plain(
            qe[:N_SUBJ], pe[:N_SUBJ], torch.from_numpy(sm.mc_philox_normals(
                SEED, N_SUBJ, S_KL)).to(dev)),
        x=x, encoder=tuner.encoder, kw=kw, ranges=ranges, trunk=trunk,
        taus=taus,
        tag="_bf16" if trunk == "bfloat16" else "",
        setup={k: kw[k] for k in ("n_blocks", "activation", "mask_channel",
                                  "input_layout", "se_idx")},
        q_plain=q_plain, b_plain=b_plain, q64=q64, z=z, d_plain=d_plain,
        q_d=q_plain.contiguous(),
        b_out=[torch.empty((3, N), **f32) for _ in range(3)],
        q_out=torch.empty((5, N), **f32),
        d_out=[torch.empty((3, N), **f32) for _ in range(2)])


def gate(name, got, ref, mean_ref=None) -> str:
    """Largest errors of (means, vars) channel-major pairs against the
    plain version's channel-last ones, and whether chip_smoke's gates
    (CHECKS) hold."""
    try:
        e = (check_close(name, got[0].T, ref[0], "mean"),
             check_close(name, got[1].T, ref[1], "var", ref[0]))
        verdict = "within CHECKS"
    except AssertionError as exc:
        e = tuple(float((g.T - r).abs().max()) for g, r in zip(got, ref))
        verdict = f"OUTSIDE CHECKS ({exc})"
    return f"{e[0]:.2e} / {e[1]:.2e} {verdict}"


def mix_shares(ctx) -> str:
    """Per head mix, chip_smoke.branch_shares: the share of voxels that each
    1-D moment routine sends to the Gauss-Laguerre side, and of 32-voxel
    warps that straddle the split."""
    return " | ".join(f"{mix}: {branch_shares(squashed(h, True), True)}"
                      for mix, h in ctx["heads"].items())


def f64_err(got, ref64) -> str:
    return " / ".join(f"{float((g.double() - r).abs().max()):.2e}"
                      for g, r in zip(got, ref64))


def errors(calls: Calls, ctx) -> str:
    out = []
    lib = calls.lib
    if hasattr(lib, "qv_quad_posterior_summaries"):
        for mix in MIXES:
            calls.a(mix)
            torch.cuda.synchronize()
            got = [t.clone() for t in ctx["a_out"]]
            out.append(f"A {mix} vs plain means / vars " + gate(
                f"A {mix}", [t.T for t in got], ctx["a_plain"][mix])
                + f", vs float64 {f64_err(got, ctx['a_f64'][mix])} (plain "
                f"{f64_err(ctx['a_plain'][mix], ctx['a_f64'][mix])})")
    if hasattr(lib, entry(calls, "B", ctx)):
        calls.b()
        torch.cuda.synchronize()
        out.append("B vs plain means / vars / raw " + " / ".join(
            f"{float((g - r).abs().max()):.2e}"
            for g, r in zip(ctx["b_out"], ctx["b_plain"])))
    if hasattr(lib, entry(calls, "C", ctx)):
        calls.c()
        torch.cuda.synchronize()
        q, q64 = ctx["q_out"], ctx["q64"]
        out.append(f"C vs plain {float((q - ctx['q_plain']).abs().max()):.2e}"
                   f", vs float64 {float((q.double() - q64).abs().max()):.2e}"
                   f" (plain vs float64 "
                   f"{float((ctx['q_plain'].double() - q64).abs().max()):.2e}"
                   f", largest |q| {float(q64.abs().max()):.3g})")
    if hasattr(lib, "qv_mc_summaries"):
        calls.d(ctx["q_d"], z=ctx["z"])
        torch.cuda.synchronize()
        out.append("D host noise vs plain means / vars "
                   + gate("D host", ctx["d_out"], ctx["d_plain"]))
        q = ctx["q_d"][:, :N_NOISE].contiguous()
        got = [torch.empty((3, N_NOISE), device=q.device) for _ in range(2)]
        calls.d(q, out=got)
        torch.cuda.synchronize()
        draws = sm.mc_draws(S)
        for tag, z in (
                ("mc_philox_normals", torch.from_numpy(
                    sm.mc_philox_normals(SEED, N_NOISE, draws)).to(q.device)),
                ("philox_normals", torch.from_numpy(fe.philox_normals(
                    SEED, N_NOISE, draws)).to(q.device))):
            ref = sm.mc_posterior_summaries_plain(q.T, z, mvg=True,
                                                  **ctx["ranges"])
            out.append(f"D device noise vs plain fed {tag} means / vars "
                       + gate(f"D device {tag}", got, ref))
    if hasattr(lib, "qv_mc_kl_map") or hasattr(lib, "qv_mc_kl"):
        q, p = ctx["qe"][:N_SUBJ], ctx["pe"][:N_SUBJ]
        for tag, z, ref, rtol in (
                ("host noise", ctx["ze"], ctx["e_plain"], 1e-5),
                ("device noise", None, ctx["e_plain_dev"], 1e-4)):
            got = calls.e(q, p, z)
            torch.cuda.synchronize()
            try:
                e = f"{check_rows('E', got, ref, rtol, 1e-4):.2e} within gate"
            except AssertionError as exc:
                e = f"OUTSIDE the gate ({exc})"
            out.append(f"E {tag} vs plain {e}")
    return "; ".join(out)


def timed(label: str, fn, symbol: str) -> str:
    return (f"{label} {kernel_ms(fn, symbol):.4f} "
            f"({cuda_ms(fn, reps=10):.4f})")


def entry(calls, key, ctx) -> str:
    """The C entry of kernel B or C on this build's plan and trunk."""
    if calls.design() in fi._WG_ENTRY:
        return fi._wg_entry(calls.plan_b if key == "B" else calls.plan_c,
                            key == "B")
    stem = {"B": "qv_encode_quad_", "C": "qv_encode_q1"}[key]
    if calls.streamed():
        stem += "stream" if key == "B" else "_stream"
    elif key == "B":
        stem += "fused"
    return stem + ctx["tag"]


def bc_symbols(plan, trunk, up) -> tuple:
    """(B's, C's) kernel symbols on this plan and trunk at padded width
    ``up``, and the template instantiation ptxas reports for them."""
    tag = "_bf16" if trunk == "bfloat16" else ""
    if plan is not None and plan.design == "streamed":
        return ((f"qv_encode_quad_stream{tag}_kernel",
                 f"qv_encode_q_stream{tag}_kernel"),
                f"ILi{plan.mt}ELi{plan.ncw}E")
    # the rows' template argument: 0 separate, 1 shared, 2 windowed (the
    # chunked design's: windowed or not; an earlier package's plan may
    # have no rows)
    code = {"shared": 1, "windowed": 2}.get(getattr(plan, "rows", ""), 0)
    rows = f"Li{code}E"
    if plan is not None and plan.design == "wgmma":
        return (("qv_encode_quad_wg_kernel", "qv_encode_q_wg_kernel"),
                f"ILi{up}ELi{plan.ks}E{rows}E")
    if plan is not None and plan.design == "chunked":
        return (("qv_encode_quad_wgc_kernel", "qv_encode_q_wgc_kernel"),
                f"ILi{up}ELi{plan.cn}ELi{plan.ks}ELb{int(code == 2)}EE")
    if plan is not None and plan.design == "split":
        return (("qv_encode_quad_wgx_kernel", "qv_encode_q_wgx_kernel"),
                f"ILi{up}ELi{plan.cn}E{rows}E")
    if plan is not None and plan.design == "cluster":
        chunk = getattr(plan, "chunk", None)     # an earlier build's: none
        return (("qv_encode_quad_wgk_kernel", "qv_encode_q_wgk_kernel"),
                f"ILi{plan.cn}EE" if chunk is None else
                f"ILi{plan.cn}ELi{chunk}ELi{plan.seg if chunk else 0}E"
                f"{rows}E")
    return ((f"qv_encode_quad{tag}_kernel", f"qv_encode_q{tag}_kernel"),
            "ILi64E")


def bench(name, lib, log, so, row_blob, ctx) -> None:
    calls = Calls(lib, row_blob, ctx)
    kernels = dict(KERNELS)
    (kernels["B"], kernels["C"]), inst = bc_symbols(calls.plan_b,
                                                    ctx["trunk"], calls.up)
    res = resources(log, kernels, inst)
    code = sass(so)
    parts = []
    for key, sym in kernels.items():
        if sym not in res:
            continue
        regs, static, frame = res[sym]
        threads = (quad.QUAD_BLOCK if key == "A" else _BLOCK
                   if key in "DE" else calls.block_b if key == "B"
                   else calls.block)
        smem = static + (0 if key in "ADE" else calls.smem_b if key == "B"
                         else calls.smem)
        size, mufu = code.get(sym, (0, {}))
        parts.append(f"{key} {regs} registers, {frame}, {smem} B shared a "
                     f"block of {threads}, {blocks_per_sm(regs, threads, smem)}"
                     f" blocks an SM, {size} SASS instructions, MUFU "
                     f"{dict(sorted(mufu.items()))}")
    if calls.design() == "cluster":
        b, c = (active_clusters(lib, calls.up, plan, quad_)
                for plan, quad_ in ((calls.plan_b, True),
                                    (calls.plan_c, False)))
        parts.append(f"active clusters of {calls.plan_b.cluster} blocks: B "
                     f"{b}, C {c}")
    print(f"{name}: " + "; ".join(parts), flush=True)
    serial = sorted({re.sub(r".*function '\S*?(qv_\w+_kernel)(ILi\d+E)?.*",
                            r"\1\2", line)
                     for line in log.splitlines() if "C7512" in line})
    if serial:
        print(f"{name}: ptxas serialises the wgmma of {', '.join(serial)} "
              "(C7512: insufficient register resources)", flush=True)
    print(f"{name} errors: {errors(calls, ctx)}", flush=True)
    rows = []
    if hasattr(lib, "qv_quad_posterior_summaries"):
        for mix in MIXES:
            rows.append(timed(f"A {mix}", lambda m=mix: calls.a(m),
                              KERNELS["A"]))
        rows.append(timed("A C rows block 128",
                          lambda: calls.a(block=128), KERNELS["A"]))
    if hasattr(lib, entry(calls, "B", ctx)):
        rows.append(timed("B", calls.b, kernels["B"]))
        rows.append(timed("B gelu", lambda: calls.b("gelu"), kernels["B"]))
    if hasattr(lib, entry(calls, "C", ctx)):
        rows.append(timed("C", calls.c, kernels["C"]))
        rows.append(timed("C gelu", lambda: calls.c("gelu"), kernels["C"]))
    if hasattr(lib, "qv_mc_summaries"):
        q = ctx["q_d"]
        rows.append(timed("D", lambda: calls.d(q), KERNELS["D"]))
        rows.append(timed("D s=2", lambda: calls.d(q, s=2), KERNELS["D"]))
        rows.append(timed("D host noise", lambda: calls.d(q, z=ctx["z"]),
                          KERNELS["D"]))
    print(f"{name} ms at N={N}, device by profiler (CUDA events a call): "
          + "; ".join(rows), flush=True)
    if hasattr(lib, "qv_mc_kl_map") or hasattr(lib, "qv_mc_kl"):
        q, p, q4, p4 = (ctx["qe"][:N_SUBJ], ctx["pe"][:N_SUBJ], ctx["qe"],
                        ctx["pe"])
        rows = [timed("E", lambda: calls.e(q, p), KERNELS["E"]),
                timed("E S=2", lambda: calls.e(q, p, s=2), KERNELS["E"]),
                timed("E host noise", lambda: calls.e(q, p, ctx["ze"]),
                      KERNELS["E"])]
        rows += [timed(f"E block {b}", lambda b=b: calls.e(q, p, block=b),
                       KERNELS["E"]) for b in (64, 256)]
        rows.append(timed(f"E at N={4 * N_SUBJ}", lambda: calls.e(q4, p4),
                          KERNELS["E"]))
        print(f"{name} ms at N={N_SUBJ}, S={S_KL}, device by profiler (CUDA "
              "events a call): " + "; ".join(rows), flush=True)


# the ring's slots and the promoted segments (k-steps) the sweep of the
# cluster design tries (--slots, --segments; 1024 promotes only at a
# layer's end), and the first output chunk's columns (--chunks; 0: one
# product of a block's columns); by default past 160 columns a block, 64
# and the wider half's multiple of 8 below half
SLOTS = (2, 3, 4, 6, 8)
SEGMENTS = (1, 2, 4, 8, 16, 1024)
CHUNKS = None
CLUSTERS = (8, 7, 6, 5, 4, 3, 2, 1)


def cluster_chunks(nl) -> tuple:
    """The first chunk widths the sweep tries at ``nl`` columns a block."""
    if CHUNKS is not None:
        return tuple(c for c in CHUNKS if c < nl)
    return (0,) if nl <= 160 else (64, nl // 16 * 8)


def cluster_plans(up, t) -> list:
    """[(label, B's plan, C's plan)] of the cluster design at padded width
    ``up``: every cluster of CLUSTERS (``--clusters``; past 8 a copy that
    allows non-portable clusters) whose columns a block (Up / C) are whole
    k-steps, each ring of SLOTS, each promoted segment of SEGMENTS and
    each first chunk of cluster_chunks (a chunked plan's segment no longer
    than its ring); a plan no build compiles is skipped."""
    out = []
    for cluster in CLUSTERS:
        nl = up // cluster
        if up % cluster or nl % 8:
            continue
        for chunk in cluster_chunks(nl):
            for stages in SLOTS:
                for seg in SEGMENTS:
                    if chunk and seg > stages:
                        continue
                    for rows in plan_rows(t, nl):
                        plans = [fi.LaunchPlan(
                            "cluster", fi._WG_THREADS,
                            fi._wgk_smem(up, t, q, stages, cluster,
                                         rows != "separate"), ks=1,
                            stages=stages, cn=nl, cluster=cluster, seg=seg,
                            chunk=chunk, rows=rows) for q in (True, False)]
                        out.append((f"cluster {cluster} ({nl} columns a "
                                    "block"
                                    + (f" in chunks {chunk} + {nl - chunk}"
                                       if chunk else "")
                                    + f", {64 * nl} B slabs) stages {stages} "
                                    f"seg {seg}, {rows} rows", *plans))
    return out


def plan_rows(t, columns) -> tuple:
    """The staged rows the sweep tries for a block of ``columns`` output
    columns: separate, shared where a staged row of ``t`` taus fits in an
    activation row, and windowed."""
    return tuple(r for r in fi._ROWS
                 if r != "shared" or fi._fits_row(t, columns))


def split_plans(up, t) -> list:
    """[(label, B's plan, C's plan)] of the split design at padded width
    ``up``: every chunk width that divides a warpgroup's columns, each
    ring of fused_infer._WG_STAGES."""
    out = []
    for cn in range(256, 7, -8):
        if (up // 2) % cn:
            continue
        for stages in fi._WG_STAGES:
            for rows in plan_rows(t, up):
                plans = [fi.LaunchPlan("split", fi._WG_THREADS,
                                       fi._wgx_smem(up, t, q, stages, cn,
                                                    rows != "separate"),
                                       ks=1, stages=stages, cn=cn, rows=rows)
                         for q in (True, False)]
                out.append((f"split cn {cn} ({2 * 64 * cn} B slabs) stages "
                            f"{stages}, {rows} rows", *plans))
    return out


def sweep_plans(calls, trunk, up, t) -> list:
    """[(label, B's plan, C's plan)] of every plan of the design
    launch_plan picks here (the cluster design's at a width the split
    design also takes, 832, and the split design's)."""
    out = []
    if calls.design() == "wgmma":
        for ks in fi._WG_SLABS[up]:
            for stages in fi._WG_STAGES:
                for rows in plan_rows(t, up):
                    plans = [fi.LaunchPlan(
                        "wgmma", fi._WG_THREADS,
                        fi._wg_smem(up, t, q, stages, ks,
                                    shared=rows != "separate"),
                        ks=ks, stages=stages, rows=rows)
                        for q in (True, False)]
                    out.append((f"ks {ks} ({ks * 64 * up} B slabs) stages "
                                f"{stages}, {rows} rows", *plans))
        return out
    if calls.design() == "chunked":
        cn, ks = fi._WGC_SLABS[up]
        for stages in fi._WG_STAGES:
            for rows in ("separate", "windowed"):
                if rows == "separate" and not fi._fits_row(t, up):
                    continue
                plans = [fi.LaunchPlan("chunked", fi._WG_THREADS,
                                       fi._wg_smem(up, t, q, stages, ks, cn),
                                       ks=ks, stages=stages, cn=cn, rows=rows)
                         for q in (True, False)]
                out.append((f"cn {cn} ks {ks} ({ks * 64 * cn} B slabs) "
                            f"stages {stages}, {rows} rows", *plans))
        return out
    if calls.design() == "split":
        return split_plans(up, t)
    if calls.design() == "cluster":
        return cluster_plans(up, t) + (split_plans(up, t)
                                       if up in fi._WGX_SLABS else [])
    ncw = fi._st_ncw(up)
    for mt in fi._ST_TILES[ncw]:
        for ks in fi._st_slabs(up, trunk):
            plans = [fi.LaunchPlan("streamed", fi._ST_THREADS,
                                   fi._st_smem(up, t, trunk, q, mt, ks), mt,
                                   ncw, ks) for q in (True, False)]
            out.append((f"mt {mt} ks {ks}", *plans))
    return out


def sweep(name, lib, log, ctx) -> None:
    """--sweep: B and C by the build ``name`` under every plan of
    launch_plan's design that fits (the split design: every chunk width
    that divides a warpgroup's columns; a plan the build does not compile
    is skipped), with B's registers and spills from the build's ptxas
    report."""
    calls = Calls(lib, False, ctx)
    if calls.design() == "resident":
        print("sweep: launch_plan keeps the resident design here", flush=True)
        return
    design = calls.design()
    trunk, up, nb, t = ctx["trunk"], calls.up, calls.nb, calls.t
    limit = _cuda.library().qv_max_dynamic_smem()
    (sym_b, sym_c), _ = bc_symbols(calls.plan_b, trunk, up)
    chosen = (calls.plan_b, calls.plan_c)
    rows = []
    for label, *plans in sweep_plans(calls, trunk, up, t):
        if plans[0].smem > limit:
            continue
        calls.plan_b, calls.plan_c = plans
        if not hasattr(lib, entry(calls, "B", ctx)):
            continue                  # a design this build lacks
        (sym_b, sym_c), _ = bc_symbols(plans[0], trunk, up)
        try:
            calls.b()
            calls.c()
        except RuntimeError as e:
            if "invalid argument" not in str(e):
                raise
            continue                  # a chunk width this build lacks
        torch.cuda.synchronize()
        err_b = max(float((g - r).abs().max()) for g, r in
                    zip(ctx["b_out"][:1] + ctx["b_out"][2:],
                        ctx["b_plain"][:1] + ctx["b_plain"][2:]))
        verdict = gate_b(ctx)
        err_c = float((ctx["q_out"] - ctx["q_plain"]).abs().max())
        err64 = float((ctx["q_out"].double() - ctx["q64"]).abs().max())
        mark = " (launch_plan's)" if plans[0] == chosen[0] else ""
        extra = ""
        if plans[0].design == "cluster":
            extra = (f", active clusters B "
                     f"{active_clusters(lib, up, plans[0], True)} / C "
                     f"{active_clusters(lib, up, plans[1], False)}")
        (sym_b, sym_c), inst = bc_symbols(plans[0], trunk, up)
        for key, sym in (("B", sym_b), ("C", sym_c)):
            regs = resources(log, {key: sym}, inst).get(sym)
            if regs:
                extra += f", {key} {regs[0]} registers ({regs[2]})"
        rows.append(f"{label}{mark}: B "
                    f"{kernel_ms(calls.b, sym_b):.4f} (means/raw err "
                    f"{err_b:.1e}, {verdict}), C "
                    f"{kernel_ms(calls.c, sym_c):.4f} (err {err_c:.1e}, vs "
                    f"float64 {err64:.2e}), smem B {plans[0].smem}{extra}")
    calls.plan_b, calls.plan_c = chosen
    plain64 = float((ctx["q_plain"].double() - ctx["q64"]).abs().max())
    rows.append(f"the plain version's q vs float64 {plain64:.2e}")
    print(f"sweep of {name} at {trunk}, {up} units (padded) x {nb} blocks "
          f"on {t} taus ({design}), device ms at N={N}: " + "; ".join(rows),
          flush=True)


def gate_b(ctx) -> str:
    """Whether B's outputs (ctx["b_out"]) hold chip_smoke's CHECKS against
    the plain version's."""
    got, ref = ctx["b_out"], ctx["b_plain"]
    try:
        check_close("B", got[0].T, ref[0].T, "mean")
        check_close("B", got[1].T, ref[1].T, "var", ref[0].T)
        check_close("B", got[2].T, ref[2].T, "raw")
        return "within CHECKS"
    except AssertionError as exc:
        return f"OUTSIDE CHECKS ({exc})"


def active_clusters(lib, up, plan, quad) -> int:
    """Clusters of the plan's kernel B (quad) or C that the card holds at
    once (qv_encode_wgk_clusters)."""
    n = ctypes.c_int(0)
    _cuda.check(lib.qv_encode_wgk_clusters(up, plan.cluster, plan.seg,
                                           plan.chunk,
                                           fi._ROW_CODES[plan.rows],
                                           int(quad), plan.smem,
                                           ctypes.byref(n)),
                "cluster occupancy")
    return n.value


def wrappers(dev, dtype, units=60, blocks=2, taus=11) -> None:
    """B, C and A through the package's wrappers (the same in every
    checkout that has the bf16 trunk): errors against the plain versions,
    C's head against a float64 head on the plain version's features
    (chip_smoke.head_f64_err), device times, B beside C + A, the launches
    one call of B and of C counts, the plain versions' ms a call (CUDA
    events) and the bounds (chip_smoke.wide_bound). Where the package's
    launch_plan raises at this shape, the plain versions' ms and the
    bounds alone."""
    cfg, scan = trunk_config(units, blocks), scan_of(taus)
    tuner = FineTuner(cfg, scan, device=dev)
    tuner.load_state_dict(init_params(cfg, scan,
                                      torch.Generator().manual_seed(0)))
    kw = dict(se_idx=scan.se_idx, multi_image=cfg.multi_image_normalisation,
              activation=cfg.activation, n_blocks=cfg.no_intermediate_layers,
              mask_channel=True, input_layout="voxel", trunk=dtype)
    ranges = dict(oef_range=cfg.oef_range, min_oef=cfg.min_oef,
                  dbv_range=cfg.dbv_range, min_dbv=cfg.min_dbv,
                  dw_coeff=float(scan.dw_coeff * scan.hct))
    x = torch.from_numpy(volumes(np.random.default_rng(0), (N,),
                                 scan.n_taus)).to(dev)
    enc = tuner.encoder
    where = (f"package {Path(fi.__file__).resolve().parent.parent} through "
             f"its wrappers at {dtype}, {units} units x {blocks} blocks on "
             f"{scan.n_taus} taus")
    q_ref = fi.encode_q_plain(x, enc, **kw)
    b_ref = fi.encode_quad_fused_plain(x, enc, mvg=True, **kw, **ranges)
    plain = {"B": cuda_ms(lambda: fi.encode_quad_fused_plain(
                 x, enc, mvg=True, **kw, **ranges), reps=2, blocks=3),
             "C": cuda_ms(lambda: fi.encode_q_plain(x, enc, **kw), reps=2,
                          blocks=3)}
    try:
        plan = (fi._plan(fi._padded_width(units), blocks, scan.n_taus,
                         scan.n_taus + 1, dtype, True, dev)
                if hasattr(fi, "launch_plan") else None)
    except ValueError as exc:                 # no launch fits this shape
        bound = {k: wide_bound(k, units, blocks, dtype, scan, b_ref[2],
                               True) for k in "BC"}
        print(f"{where}: launch_plan raises ({exc}); plain ms B "
              f"{plain['B']:.4f}, C {plain['C']:.4f}; bound ms B "
              f"{bound['B']['bound_ms']:.4f}, C {bound['C']['bound_ms']:.4f}",
              flush=True)
        return
    design = "" if plan is None else f" ({plan.design}" + (
        f", {plan.rows} rows)" if hasattr(plan, "rows") else ")")
    counters = {k: [c for c in vars(w) if c.endswith("launches")]
                for k, w in (("B", fi.encode_quad_fused),
                             ("C", fi.encode_q1_packed))}
    before = {k: [getattr(w, c) for c in counters[k]]
              for k, w in (("B", fi.encode_quad_fused),
                           ("C", fi.encode_q1_packed))}
    q = fi.encode_q1_packed(x, enc, **kw)
    b = fi.encode_quad_fused(x, enc, mvg=True, **kw, **ranges)
    launched = {k: {c: getattr(w, c) - n for c, n in zip(counters[k],
                                                          before[k])
                    if getattr(w, c) != n}
                for k, w in (("B", fi.encode_quad_fused),
                             ("C", fi.encode_q1_packed))}
    bound = {k: wide_bound(k, units, blocks, dtype, scan, b[2], True)
             for k in "BC"}
    head = head_f64_err(q, x, enc, kw)
    rows = q.T.contiguous()
    (sym_b, sym_c), _ = bc_symbols(plan, dtype, fi._padded_width(units))
    ms = {"B": kernel_ms(lambda: fi.encode_quad_fused(
              x, enc, mvg=True, **kw, **ranges), sym_b),
          "C": kernel_ms(lambda: fi.encode_q1_packed(x, enc, **kw), sym_c),
          "A": kernel_ms(lambda: quad.quad_posterior_summaries(
              rows, mvg=True, **ranges), KERNELS["A"])}
    print(f"{where}{design}: C vs plain "
          f"{float((q - q_ref).abs().max()):.2e}, B vs plain means / vars / "
          "raw " + " / ".join(f"{float((g - r).abs().max()):.2e}"
                              for g, r in zip(b, b_ref))
          + "; C's head against a float64 head on the plain features "
          + ", ".join(f"{k} {v:.3e}" for k, v in head[0].items())
          + " (the plain float32 head " + ", ".join(
              f"{k} {v:.3e}" for k, v in head[1].items()) + "); device ms "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + f", C + A {ms['C'] + ms['A']:.4f}; launches a call "
          f"{launched}; plain ms B {plain['B']:.4f}, C {plain['C']:.4f}; "
          + "; ".join(f"{k} bound {bound[k]['bound_ms']:.4f} ms by "
                      f"{bound[k]['bound_by']} "
                      f"({100 * bound[k]['bound_ms'] / ms[k]:.1f}%)"
                      for k in "BC"), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this bench needs the card")
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only-copies", action="store_true",
                    help="time the given sources alone")
    ap.add_argument("--row-blob", action="append", default=[],
                    help="a copy of the earlier, row-major-blob "
                    "encode_quad.cu")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16", "both"],
                    help="the stream-1 trunk of kernels B and C")
    ap.add_argument("--units", type=int, default=OPTIMAL.model.no_units,
                    help="the trunk's width (OPTIMAL's 60)")
    ap.add_argument("--blocks", type=int,
                    default=OPTIMAL.model.no_intermediate_layers,
                    help="the trunk's depth (OPTIMAL's 2)")
    ap.add_argument("--shapes", default=None,
                    help="the trunks to time (in place of --units and "
                    "--blocks), as UNITSxBLOCKS[xTAUS] separated by commas")
    ap.add_argument("--package", default=None,
                    help="import qbold_vi_tpu_torch from this directory and "
                    "time B, C and A through its wrappers alone")
    ap.add_argument("--sweep", action="store_true",
                    help="time B and C under every plan of launch_plan's "
                    "design that fits")
    ap.add_argument("--slots", default=None,
                    help="the cluster design's rings --sweep tries, "
                    "separated by commas (SLOTS)")
    ap.add_argument("--segments", default=None,
                    help="the cluster design's promoted segments --sweep "
                    "tries, separated by commas (SEGMENTS)")
    ap.add_argument("--clusters", default=None,
                    help="the cluster design's blocks a cluster --sweep "
                    "tries, separated by commas (CLUSTERS)")
    ap.add_argument("--chunks", default=None,
                    help="the cluster design's first output chunks "
                    "--sweep tries (columns; 0: one product), separated by "
                    "commas (CHUNKS)")
    ap.add_argument("sources", nargs="*", help="edited copies of the "
                    "package's encode_quad.cu or summarize.cu")
    args = ap.parse_args()
    global SLOTS, SEGMENTS, CHUNKS, CLUSTERS
    if args.slots:
        SLOTS = tuple(map(int, args.slots.split(",")))
    if args.segments:
        SEGMENTS = tuple(map(int, args.segments.split(",")))
    if args.chunks:
        CHUNKS = tuple(map(int, args.chunks.split(",")))
    if args.clusters:
        CLUSTERS = tuple(map(int, args.clusters.split(",")))
    dev = torch.device("cuda", 0)
    dtypes = (("float32", "bfloat16") if args.dtype == "both"
              else (args.dtype,))
    shapes = ([(tuple(map(int, s.split("x"))) + (OPTIMAL.scan.n_taus,))[:3]
               for s in args.shapes.split(",")] if args.shapes
              else [(args.units, args.blocks, OPTIMAL.scan.n_taus)])
    if args.package:
        with torch.no_grad():
            for units, blocks, taus in shapes:
                for dtype in dtypes:
                    wrappers(dev, dtype, units, blocks, taus)
        print(gpu_line())
        return 0
    libs = {}
    if not args.only_copies:
        lib = bind(_cuda.library())
        libs["package"] = (lib, _cuda.build_log(), lib._name, False)
    built = build_variants(args.row_blob + args.sources)
    for i, (name, (lib, log, so)) in enumerate(built.items()):
        libs[name] = (lib, log, so, i < len(args.row_blob))
    with torch.no_grad():
        for (units, blocks, taus), dtype in ((s, d) for s in shapes
                                             for d in dtypes):
            ctx = context(dev, dtype, units, blocks, taus)
            print(f"{dtype}, {units} units x {blocks} blocks on {taus} taus; "
                  "head mixes: " + mix_shares(ctx), flush=True)
            if args.sweep:
                for name, (lib, log, so, row_blob) in libs.items():
                    if not row_blob:
                        sweep(name, lib, log, ctx)
                continue
            for name, (lib, log, so, row_blob) in libs.items():
                bench(name, lib, log, so, row_blob, ctx)
    print(gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
