"""Kernels B and C on dense tau scans: the shared-rows layout of the float32
wgmma, split and cluster designs (ops/fused_infer.py::launch_plan), and
the port's posterior_maps on a 51-tau scan against the JAX package's.

A plan's staged input rows sit in a buffer of their own ("separate") or,
where that buffer does not fit beside the block, in the first 8 ceil(T /
8) columns of the activation rows ("shared"; csrc/encode_stream_wg.cu,
encode_stream_wgx.cu, encode_stream_wgk.cu). The byte counts below are
written out from the kernels' layout comments; the plans are those of the
H100's 232,448 B a block.

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


# (padded units, blocks, taus) -> (design, B's rows, C's rows) at the
# H100's limit: at 1344 on 96 taus C's block (no node table) still fits
# beside rows of its own, 768 B under the limit
SH, SEP = "shared", "separate"
DENSE = [(768, 1, 48, "split", SH, SH), (768, 1, 51, "split", SH, SH),
         (640, 1, 96, "split", SH, SH), (256, 1, 128, "wgmma", SH, SH),
         (256, 2, 128, "wgmma", SH, SH), (1344, 1, 96, "cluster", SH, SEP),
         (1472, 1, 80, "cluster", SH, SH), (1472, 1, 128, "cluster", SH, SH),
         (320, 2, 330, "streamed", SEP, SEP),
         (896, 1, 330, "streamed", SEP, SEP)]


@pytest.mark.parametrize("up,nb,t,design,rows_b,rows_c", DENSE,
                         ids=[f"{u}x{nb}-t{t}" for u, nb, t, *_ in DENSE])
def test_launch_plan_on_dense_tau_scans(up, nb, t, design, rows_b, rows_c):
    """Where a block's own staged rows do not fit, launch_plan gives the
    wgmma, split and cluster designs shared rows (a kernel the build
    compiles: _WG_SHARED, _WGX_SHARED, _WGK_SHARED) and the plan's bytes
    are that layout's; the streamed design serves only where a staged row
    is wider than the block's activation row (320 x 2 and 896 x 1 on 330
    taus: 336 channels against 320 and 112 columns)."""
    for quad, rows in ((True, rows_b), (False, rows_c)):
        plan = tfi.launch_plan(up, nb, t, t + 1, "float32", quad, H100_SMEM)
        assert (plan.design, plan.rows) == (design, rows)
        assert plan.smem <= H100_SMEM
        if rows == SEP and design == "cluster":
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
        else:
            columns = up // 8 if up > 768 else up
            assert not tfi._fits_row(t, columns)


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
