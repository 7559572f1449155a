"""Kernels B and C on dense tau scans: the shared-rows and windowed-rows
layouts of the float32 wgmma, chunked, split and cluster designs
(ops/fused_infer.py::launch_plan), and the port's posterior_maps on 51-
and 330-tau scans against the JAX package's.

A plan's staged input rows sit in a buffer of their own ("separate") or,
where that buffer does not fit beside the block, in the first 8 ceil(T /
8) columns of the activation rows ("shared"; csrc/encode_stream_wg.cu,
encode_stream_wgx.cu, encode_stream_wgk.cu) or, where a staged row is
wider than an activation row, there a window of the first layer's
k-steps at a time ("windowed", those three and encode_stream_wgc.cu). The
byte counts below are written out from the kernels' layout comments; the
plans are those of the H100's 232,448 B a block.

Tolerance of the maps: rtol 1e-3 / atol 3e-5 with the R2' variance floor
of torch_parity_utils.assert_vars_close, as
tests/test_torch_infer.py::test_posterior_maps_match_jax holds them.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from torch_parity_utils import (assert_vars_close, port_params,  # noqa: E402
                                port_tuner)
from qbold_vi_tpu import infer as jinfer  # noqa: E402
from qbold_vi_tpu.config import OPTIMAL, ScanParams  # noqa: E402
from qbold_vi_tpu_torch import infer as tinfer  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_infer as tfi  # noqa: E402

H100_SMEM = 232_448
NCONST = 3 * 16 + 10 * 16      # csrc/quad_math.cuh::QV_NCONST
HEADS = 5 * 256                # a round's heads (5 x QV_ST_ROUND floats)
TOL = dict(rtol=1e-3, atol=3e-5)
MAPS = ("oef", "dbv", "r2p", "stds", "raw_log_stds")


@pytest.mark.parametrize("quad", [True, False], ids=["B", "C"])
def test_shared_rows_byte_counts_are_the_kernels_layouts(quad):
    """Each design's bytes with the staged rows in the activation rows, in
    the order of its layout comment, and the separate-rows bytes that do
    not fit: the wgmma block at 256 units on 128 taus (mbarriers 128 B,
    two 16 KB slabs, 128 activation rows of 264 words, no rows of their
    own, the heads, the node table; B's scratch in the activations), the
    split block at 768 on 51 taus (two slots of two 4 KB pieces, 64 rows
    of 776 words) and a cluster block at 1344 and 1472 on 128 taus
    (mbarriers 256 B, 4 / 6 slots of 64 x 168 / 184 B, 128 rows of 184 /
    200 words, 8 blocks' partial heads)."""
    node = NCONST if quad else 0
    assert tfi._wg_smem(256, 128, quad, 2, 1, shared=True) == (
        128 + 2 * 64 * 256 + 4 * (128 * 264 + HEADS + node))
    assert tfi._wg_smem(256, 128, quad, 2, 1, shared=True) == (
        174_016 if quad else 173_184)
    assert tfi._wg_smem(256, 128, quad, 2, 1) == (
        174_016 + 4 * 128 * 136 - (0 if quad else 4 * NCONST)) > H100_SMEM
    assert tfi._wgx_smem(768, 51, quad, 2, 64, True) == (
        128 + 2 * 2 * 64 * 64 + 4 * (64 * 776 + HEADS + node))
    assert tfi._wgx_smem(768, 51, True, 2, 64, True) == 221_120
    assert tfi._wgx_smem(768, 51, True, 2, 64) == 235_456 > H100_SMEM
    for up, stages, cn, sa, total in ((1344, 4, 168, 184, 179_264),
                                      (1472, 6, 184, 200, 215_104)):
        assert tfi._wgk_stride(cn) == sa
        assert tfi._wgk_smem(up, 128, quad, stages, 8, True) == (
            256 + stages * 64 * cn + 4 * (128 * sa + 8 * HEADS + node))
        assert tfi._wgk_smem(up, 128, quad, stages, 8, True) == (
            total - (0 if quad else 4 * NCONST))
        assert tfi._wgk_smem(up, 128, quad, stages, 8) > H100_SMEM
    # the chunked design's rows were always in its activation rows
    assert tfi._wg_smem(320, 11, quad, 2, 1, 160) == tfi._wg_smem(
        320, 11, quad, 2, 1, 160, shared=True)


@pytest.mark.parametrize("quad", [True, False], ids=["B", "C"])
def test_windowed_rows_byte_counts_are_the_kernels_layouts(quad):
    """Each design's bytes with its rows staged a window at a time, in the
    order of its layout comment, the same on 11 and on 1024 taus (a row's
    reference and mask value are in the staging lanes' registers): the
    wgmma block at 16 units (two slots of 2 k-steps of 1 KB, 128 rows of 24
    words, the heads, B's node table and its scratch of its own: the
    activation rows are smaller) and at 64 (two slots of 4 k-steps of 4
    KB, 128 rows of 72 words; the scratch in them), the chunked block at
    320 (two slots of a 160-column k-step, 128 rows of 328 words), the
    split block at 448 (two slots of two 14 KB pieces, 64 rows of 456
    words) and a cluster block at 896 and 1472 (mbarriers 256 B, 2 / 6
    slots of 64 x 112 / 184 B, 128 rows of 120 / 200 words, 8 blocks'
    partial heads); and each plan's bytes on 1024 taus are these."""
    node = NCONST if quad else 0
    scratch = 2 * 32 + 21 * 256 if quad else 0
    want = {
        ("wgmma", 16): 128 + 2 * 2 * 64 * 16 + 4 * (128 * 24 + HEADS + node
                                                   + scratch),
        ("wgmma", 64): 128 + 2 * 4 * 64 * 64 + 4 * (128 * 72 + HEADS + node),
        ("chunked", 320): 128 + 2 * 64 * 160 + 4 * (128 * 328 + HEADS
                                                    + node),
        ("split", 448): 128 + 2 * 2 * 64 * 224 + 4 * (64 * 456 + HEADS
                                                      + node),
        ("cluster", 896): 256 + 2 * 64 * 112 + 4 * (128 * 120 + 8 * HEADS
                                                     + node),
        ("cluster", 1472): 256 + 6 * 64 * 184 + 4 * (128 * 200 + 8 * HEADS
                                                     + node)}
    assert want[("chunked", 320)] == (194_496 if quad else 193_664)
    assert want[("cluster", 1472)] == (215_104 if quad else 214_272)
    for t in (11, 1024):
        assert tfi._wg_smem(16, t, quad, 2, 2, shared=True) == want[
            ("wgmma", 16)]
        assert tfi._wg_smem(64, t, quad, 2, 4, shared=True) == want[
            ("wgmma", 64)]
        assert tfi._wg_smem(320, t, quad, 2, 1, 160) == want[
            ("chunked", 320)]
        assert tfi._wgx_smem(448, t, quad, 2, 224, True) == want[
            ("split", 448)]
        assert tfi._wgk_smem(896, t, quad, 2, 8, True) == want[
            ("cluster", 896)]
        assert tfi._wgk_smem(1472, t, quad, 6, 8, True) == want[
            ("cluster", 1472)]
    for (design, up), smem in want.items():
        plan = tfi.launch_plan(up, 1, 1024, 1025, "float32", quad, H100_SMEM)
        assert (plan.design, plan.rows, plan.smem) == (design, "windowed",
                                                       smem)


# (padded units, blocks, taus) -> (design, B's rows, C's rows) at the
# H100's limit: at 1344 on 96 taus C's block (no node table) still fits
# beside rows of its own, 768 B under the limit; a staged row wider than
# the block's activation row (320 x 2 and 64 x 2 on 330 taus: 336
# channels against 320 and 64 columns; 128 x 2 on 256; 896 x 1 on 330,
# 1280 x 1 on 512 and 1472 x 1 on 330: 112, 160 and 184 columns a
# block) is staged a window at a time
SH, SEP, WIN = "shared", "separate", "windowed"
DENSE = [(768, 1, 48, "split", SH, SH), (768, 1, 51, "split", SH, SH),
         (640, 1, 96, "split", SH, SH), (256, 1, 128, "wgmma", SH, SH),
         (256, 2, 128, "wgmma", SH, SH), (1344, 1, 96, "cluster", SH, SEP),
         (1472, 1, 80, "cluster", SH, SH), (1472, 1, 128, "cluster", SH, SH),
         (320, 2, 330, "chunked", WIN, WIN),
         (896, 1, 330, "cluster", WIN, WIN),
         (64, 2, 330, "wgmma", WIN, WIN), (128, 2, 256, "wgmma", WIN, WIN),
         (1280, 1, 512, "cluster", WIN, WIN),
         (1472, 1, 330, "cluster", WIN, WIN)]


@pytest.mark.parametrize("up,nb,t,design,rows_b,rows_c", DENSE,
                         ids=[f"{u}x{nb}-t{t}" for u, nb, t, *_ in DENSE])
def test_launch_plan_on_dense_tau_scans(up, nb, t, design, rows_b, rows_c):
    """Where a block's own staged rows do not fit, launch_plan gives the
    wgmma, split and cluster designs shared rows (a kernel the build
    compiles: _WG_SHARED, _WGX_SHARED, _WGK_SHARED) and the plan's bytes
    are that layout's; where a staged row is wider than the block's
    activation row, windowed rows (every wgmma and chunked width's first
    slab; the cluster's _WGK_WINDOWED) in the same bytes."""
    for quad, rows in ((True, rows_b), (False, rows_c)):
        plan = tfi.launch_plan(up, nb, t, t + 1, "float32", quad, H100_SMEM)
        assert (plan.design, plan.rows) == (design, rows)
        assert plan.smem <= H100_SMEM
        if rows == WIN:
            columns = up // plan.cluster if design == "cluster" else up
            assert not tfi._fits_row(t, columns)
            if design == "cluster":
                assert (plan.cn, plan.chunk, plan.seg if plan.chunk
                        else 0) in tfi._WGK_WINDOWED
            # the bytes of rows in the activation rows, on any taus
            if design == "cluster":
                smem = tfi._wgk_smem(up, 11, quad, plan.stages,
                                     plan.cluster, True)
            else:
                smem = tfi._wg_smem(up, 11, quad, plan.stages, plan.ks,
                                    plan.cn or None, shared=True)
            assert plan.smem == smem
        elif rows == SEP and design == "cluster":
            assert plan.smem == tfi._wgk_smem(up, t, quad, plan.stages,
                                              plan.cluster)
        elif design == "split":
            assert plan.smem == tfi._wgx_smem(up, t, quad, plan.stages,
                                              plan.cn, True)
            assert up in tfi._WGX_SHARED
        elif design == "wgmma":
            assert plan.smem == tfi._wg_smem(up, t, quad, plan.stages,
                                             plan.ks, shared=True)
            assert up in tfi._WG_SHARED
        elif design == "cluster":
            assert plan.smem == tfi._wgk_smem(up, t, quad, plan.stages,
                                              plan.cluster, True)
            assert (plan.cn, plan.chunk,
                    plan.seg if plan.chunk else 0) in tfi._WGK_SHARED


@pytest.mark.parametrize("t", [11, 24, 40])
def test_plans_that_fit_before_keep_their_plan(monkeypatch, t):
    """At every padded width 16-1472 (1 and 2 blocks, both trunks, B and
    C) on 11, 24 and 40 taus launch_plan gives the plan it gives with the
    shared-rows layout taken away -- the parent's order, separate rows
    first -- and no plan with shared rows: every shape that fit keeps its
    plan and its bytes."""
    widths = [16, 32, 64, 128] + list(range(192, 1473, 64))
    shapes = [(up, nb, trunk, quad) for up in widths for nb in (1, 2)
              for trunk in ("float32", "bfloat16") for quad in (True, False)]
    now = [tfi.launch_plan(up, nb, t, t + 1, trunk, quad, H100_SMEM)
           for up, nb, trunk, quad in shapes]
    monkeypatch.setattr(tfi, "_ROWS", ("separate",))
    for (up, nb, trunk, quad), plan in zip(shapes, now):
        before = tfi.launch_plan(up, nb, t, t + 1, trunk, quad, H100_SMEM)
        assert plan == before, (up, nb, trunk, quad)
        assert plan.rows == "separate"


def test_shared_rows_plans_are_compiled_at_the_h100_limit():
    """Over every padded width of the wgmma, split and cluster designs and
    every tau count whose staged row fits the block's activation row,
    launch_plan takes shared rows only where the separate-rows plans do
    not fit, and then always one the build compiles; every shared-rows
    kernel compiled is reached by some tau count."""
    reached = set()
    for up in sorted(set(tfi._WG_SLABS) | set(tfi._WGX_SLABS)
                     | set(tfi._WGK_PLANS)):
        columns = up // 8 if up in tfi._WGK_PLANS else up
        for t in range(1, columns + 1, 3):
            plan = tfi.launch_plan(up, 1, t, t + 1, "float32", True,
                                   H100_SMEM)
            if plan.rows != "shared":
                continue
            key = ((plan.cn, plan.chunk, plan.seg if plan.chunk else 0)
                   if plan.design == "cluster" else up)
            reached.add((plan.design, key))
    assert reached == ({("wgmma", up) for up in tfi._WG_SHARED}
                       | {("split", up) for up in tfi._WGX_SHARED}
                       | {("cluster", k) for k in tfi._WGK_SHARED})


WIDTHS = [16, 32, 64, 128] + list(range(192, 1473, 64))
SCANS = (11, 51, 128, 200, 256, 330, 512, 1024)


@pytest.mark.parametrize("t", SCANS)
def test_float32_plans_on_any_tau_count_keep_or_window(monkeypatch, t):
    """At every padded width 16-1472 (1 and 2 blocks, B and C) on t taus
    launch_plan gives float32 a wgmma, chunked, split or cluster plan --
    none streams or raises. Every shape that planned without the windowed
    layout (the parent's order: separate rows, then shared) keeps that
    plan exactly; the others, where the parent streamed or raised, take
    windowed rows."""
    shapes = [(up, nb, quad) for up in WIDTHS for nb in (1, 2)
              for quad in (True, False)]
    now = [tfi.launch_plan(up, nb, t, t + 1, "float32", quad, H100_SMEM)
           for up, nb, quad in shapes]
    assert {p.design for p in now} <= {"resident", "wgmma", "chunked",
                                       "split", "cluster"}
    monkeypatch.setattr(tfi, "_ROWS", ("separate", "shared"))
    for (up, nb, quad), plan in zip(shapes, now):
        try:
            before = tfi.launch_plan(up, nb, t, t + 1, "float32", quad,
                                     H100_SMEM)
        except ValueError:
            before = None
        if before is None:
            assert plan.rows == "windowed", (up, nb, t, quad, plan)
        else:
            assert plan == before, (up, nb, t, quad)


def test_windowed_rows_plans_are_compiled_at_the_h100_limit():
    """Over every padded width of the wgmma-family designs and the tau
    counts 1-1024, launch_plan takes windowed rows only where a staged row
    is wider than the block's activation row and no plan with separate
    rows fits, and then always one the build compiles; every windowed
    kernel compiled is reached by some tau count."""
    reached = set()
    for up in sorted(set(tfi._WG_SLABS) | set(tfi._WGC_SLABS)
                     | set(tfi._WGX_SLABS) | set(tfi._WGK_PLANS)):
        for t in range(1, 1025, 7):
            plan = tfi.launch_plan(up, 1, t, t + 1, "float32", True,
                                   H100_SMEM)
            if plan.rows != "windowed":
                continue
            columns = up // plan.cluster if plan.design == "cluster" else up
            assert not tfi._fits_row(t, columns), (up, t)
            key = ((plan.cn, plan.chunk, plan.seg if plan.chunk else 0)
                   if plan.design == "cluster" else up)
            reached.add((plan.design, key))
    assert reached == ({("wgmma", up) for up in tfi._WG_SLABS}
                       | {("chunked", up) for up in tfi._WGC_SLABS}
                       | {("split", up) for up in tfi._WGX_SLABS}
                       | {("cluster", k) for k in tfi._WGK_WINDOWED})


SCAN51 = ScanParams(simulate_noise=False, tau_step=0.0016)
CFG64 = dataclasses.replace(OPTIMAL.model, compute_dtype="float32",
                            no_units=64, no_intermediate_layers=1)


@pytest.fixture(scope="module")
def dense_setup():
    assert SCAN51.n_taus == 51
    rng = np.random.default_rng(51)
    data = (np.abs(rng.normal(size=(2, 16, 16, 8, SCAN51.n_taus + 1)))
            .astype(np.float32) * 50.0 + 100.0)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    jt, params = port_params(CFG64, SCAN51, seed=24)
    ref = jinfer.posterior_maps(jt, params, data, jax.random.PRNGKey(0),
                                use_pallas=False, chunk=2,
                                use_first_op=True)
    return data, params, ref


@pytest.mark.parametrize("fused", ["on", "off"])
def test_posterior_maps_on_51_taus_match_jax(dense_setup, fused):
    """posterior_maps at 64 units x 1 block on a 51-tau scan (tau_step 1.6
    ms), 4,096 voxels of stream 1, fused_infer "on" (kernel B's route,
    whose plain version the CPU runs) and "off", against the JAX
    package's posterior_maps on the same weights and volumes."""
    data, params, ref = dense_setup
    tuner = port_tuner(dataclasses.replace(CFG64, fused_infer=fused),
                       SCAN51, params)
    got = tinfer.posterior_maps(tuner, data, use_first_op=True, chunk=2)
    for key in MAPS:
        assert got[key].shape == ref[key].shape, key
    for key in ("oef", "dbv", "r2p", "raw_log_stds"):
        np.testing.assert_allclose(got[key], ref[key], err_msg=key, **TOL)
    means = np.concatenate([ref["oef"], ref["dbv"], ref["r2p"]], -1)
    assert_vars_close(got["stds"], ref["stds"], means, **TOL)


SCAN330 = ScanParams(simulate_noise=False, tau_step=0.000246)


@pytest.fixture(scope="module")
def scan330_setup():
    assert SCAN330.n_taus == 330
    rng = np.random.default_rng(330)
    data = (np.abs(rng.normal(size=(1, 8, 8, 4, SCAN330.n_taus + 1)))
            .astype(np.float32) * 50.0 + 100.0)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    jt, params = port_params(CFG64, SCAN330, seed=25)
    ref = jinfer.posterior_maps(jt, params, data, jax.random.PRNGKey(0),
                                use_pallas=False, chunk=2,
                                use_first_op=True)
    return data, params, ref


@pytest.mark.parametrize("fused", ["on", "off"])
def test_posterior_maps_on_330_taus_match_jax(scan330_setup, fused):
    """posterior_maps at 64 units x 1 block on a 330-tau scan (tau_step
    0.246 ms: a staged row of 336 channels, wider than the block's
    activation row, so the card stages it a window at a time), 256 voxels
    of stream 1, fused_infer "on" and "off", against the JAX package's
    posterior_maps on the same weights and volumes, at the 51-tau test's
    tolerances."""
    data, params, ref = scan330_setup
    tuner = port_tuner(dataclasses.replace(CFG64, fused_infer=fused),
                       SCAN330, params)
    got = tinfer.posterior_maps(tuner, data, use_first_op=True, chunk=2)
    for key in MAPS:
        assert got[key].shape == ref[key].shape, key
    for key in ("oef", "dbv", "r2p", "raw_log_stds"):
        np.testing.assert_allclose(got[key], ref[key], err_msg=key, **TOL)
    means = np.concatenate([ref["oef"], ref["dbv"], ref["r2p"]], -1)
    assert_vars_close(got["stds"], ref["stds"], means, **TOL)
