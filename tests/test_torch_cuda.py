"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one (marker
``cuda``). This file imports no jax, so it runs on the machine with the
card, where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: means and raw rtol 1e-4 / atol 3e-5; variances rtol 1e-3 /
atol 3e-5, with the R2' floor of torch_parity_utils.assert_vars_close.
The fine-tune kernels F and G: rows at rtol 1e-5 / atol 1e-5, gradients
scale-normalised at rtol 5e-4 / atol 5e-5 (the JAX package's own gates,
tests/test_pallas_elbo.py:88-97). The sampled kernels D and E with host
normals at the means/variances tolerances above and rtol 1e-5 for the KL
rows; with device noise against the plain versions fed their replay of
the counters (ops/summarize.py::mc_philox_normals; F's philox_normals) at
rtol 1e-4 (numpy's log/sin/cos on the host against the card's). Kernel
A on heads below, above and straddling the s = 1.5 split. Kernel E
also against the replay of its own summation order (kernel lanes, then
a shuffle tree; torch_parity_utils.kl_lanes_replay) given the same host
normals, at rtol 1e-5 / atol 1e-5 plus 16 ulps of the parts each row
cancels from (assert_kl_close).
The 3x3 conv kernel H (3xTF32 tensor-core products): the output and dx
within 1e-5 of their largest magnitude, dw and db within 1e-4 of theirs
(sums of every pixel's terms in another order than the plain version's).
The bf16 trunk (bf16 products, float32 sums, one rounding to bf16 where
the plain versions round): H's outputs and gradients and kernel C's q
within BF16_ULPS bf16 ulps of their largest magnitude (a float32 sum in
another order moves a rounding by one ulp, and in the encode that ulp
travels through the next layers); kernel B against the plain quadrature
of kernel C's q (the two kernels share the encode) at the float32
tolerances, and against its plain version at the JAX package's bf16 gate
(rtol 0.05 / atol 0.03, tests/test_pallas_infer.py:217); a fine-tune step
through H at bf16 against the same step through cuDNN at bf16 within
torch_parity_utils.assert_bf16_grads_close's weight tolerance, 0.01 of
each gradient's scale (cuDNN rounds its sums before the bias, H after).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity_utils import (HEAD_MIXES, assert_kl_close,  # noqa: E402
                                assert_vars_close, assert_wls_close, bf16_ulp,
                                cuda_device,  # noqa: F401
                                head_mix, kl_lanes_replay, kl_scale,
                                own_save_dir, raw_head, volume)
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch import infer  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner, init_params  # noqa: E402
from qbold_vi_tpu_torch.ops import conv3x3 as tcv  # noqa: E402
from qbold_vi_tpu_torch.ops import decode_nll as tdn  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_elbo as tfe  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_infer as tfi  # noqa: E402
from qbold_vi_tpu_torch.ops import quadrature as tq  # noqa: E402
from qbold_vi_tpu_torch.ops import summarize as tsm  # noqa: E402
from qbold_vi_tpu_torch.train import optim as toptim  # noqa: E402
from qbold_vi_tpu_torch.train import steps as tsteps  # noqa: E402

pytestmark = pytest.mark.cuda

SCAN = tcfg.ScanParams(simulate_noise=False)
MEAN_TOL = dict(rtol=1e-4, atol=3e-5)
VAR_TOL = dict(rtol=1e-3, atol=3e-5)
DW = float(SCAN.dw_coeff * SCAN.hct)
RANGES = dict(oef_range=0.8, min_oef=0.04, dbv_range=0.2, min_dbv=0.001,
              dw_coeff=DW)
BF16_ULPS = 4


def _ulp_close(got, ref, ulps, name):
    """|got - ref| within ``ulps`` bf16 ulps of ref's largest magnitude."""
    got, ref = got.double().cpu(), ref.double().cpu()
    assert torch.isfinite(got).all(), name
    ulp = bf16_ulp(ref)
    err = float((got - ref).abs().max())
    assert err <= ulps * ulp, f"{name}: {err:.3e}, {err / ulp:.2f} ulps"


def _tuner(cfg, device, scan=SCAN):
    tuner = FineTuner(cfg, scan, device=device)
    tuner.load_state_dict(init_params(cfg, scan,
                                      torch.Generator().manual_seed(0)))
    return tuner


def _close(got, ref):
    """(means, vars[, raw]) channel-last numpy triples."""
    np.testing.assert_allclose(got[0], ref[0], err_msg="means", **MEAN_TOL)
    assert_vars_close(got[1], ref[1], ref[0], **VAR_TOL)
    if len(got) > 2:
        np.testing.assert_allclose(got[2], ref[2], err_msg="raw", **MEAN_TOL)


@pytest.mark.parametrize("mvg", [True, False])
@pytest.mark.parametrize("mix", HEAD_MIXES)
def test_quadrature_kernel_matches_plain(cuda_device, mix, mvg):
    """Kernel A (its problems sorted by side across each block) against
    the plain version; 100,003 voxels end in a ragged block."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(head_mix(rng, 100_003, mix)).to(cuda_device)
    before = tq.quad_posterior_summaries.launches
    got = tq.quad_posterior_summaries(q, mvg=mvg, **RANGES)
    torch.cuda.synchronize()
    assert tq.quad_posterior_summaries.launches == before + 1
    ref = tq.posterior_summaries_quadrature(q, mvg=mvg, **RANGES)
    _close([a.cpu().numpy() for a in got], [a.cpu().numpy() for a in ref])


# widths 13 and 30 are zero-padded to 16 and 32 in the kernel, whose
# padded channels gelu and softplus map from 0 to 0 and log 2; N = 50,001
# and 33 end in a ragged tile of 32 voxels
@pytest.mark.parametrize("layout", ["voxel", "channel"])
@pytest.mark.parametrize("act,units,mvg,multi,n", [
    ("relu", 60, True, False, 50_001),          # OPTIMAL
    ("gelu", 30, False, True, 50_001),
    ("softplus", 13, True, False, 50_001),      # width not a multiple of 4
    ("gelu", 13, True, False, 50_001),
    ("softplus", 30, True, True, 50_001),
    ("relu", 60, True, False, 33),
])
def test_fused_kernel_matches_plain(cuda_device, layout, act, units, mvg,
                                    multi, n):
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, activation=act,
                              no_units=units, use_mvg=mvg,
                              multi_image_normalisation=multi)
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(7)
    x = volume(rng, (n,), SCAN.n_taus + 1)
    x[:, -1] = rng.uniform(size=n) > 0.2
    xt = torch.from_numpy(x).to(cuda_device)
    if layout == "channel":
        xt = xt.T.contiguous()
    kw = dict(se_idx=SCAN.se_idx, multi_image=multi, activation=act,
              n_blocks=cfg.no_intermediate_layers, trunk="float32",
              mask_channel=True, input_layout=layout, mvg=mvg,
              **{k: v for k, v in RANGES.items()})
    before = tfi.encode_quad_fused.launches
    got = tfi.encode_quad_fused(xt, tuner.encoder, **kw)
    torch.cuda.synchronize()
    assert tfi.encode_quad_fused.launches == before + 1
    ref = tfi.encode_quad_fused_plain(xt, tuner.encoder, **kw)
    _close([a.T.cpu().numpy() for a in got], [a.T.cpu().numpy() for a in ref])


def _design_counter(units, nb, trunk, quad, t_in, mask=True):
    """The launch counter of kernel B (quad) or C at this shape (t_in
    input channels, the last the mask if ``mask``): the design launch_plan
    picks on this card, and the trunk."""
    from qbold_vi_tpu_torch.ops import _cuda

    plan = tfi.launch_plan(tfi._padded_width(units), nb, t_in - int(mask),
                           t_in, trunk, quad,
                           _cuda.library().qv_max_dynamic_smem())
    return tfi._COUNTER_PREFIX[plan.design] + (
        "bf16_launches" if trunk == "bfloat16" else "launches")


# widths and depths past the resident blob: 100 and 128 units x 2 blocks in
# float32 (the blob does not fit), 192, 256, 320 and 384 x 2, 448, 520,
# 800, 832, 833, 1280, 1281, 1350 and 1472 x 1 and 1024 x 2 (past 128
# units), 60 x 7 (depth); 128 x 2 and 60 x 7 at bf16 stay resident. In
# float32 every padded width up to 256 takes the wgmma design
# (csrc/encode_stream_wg.cu), 320 and 384 the chunked one
# (csrc/encode_stream_wgc.cu), 448-768 the split one
# (csrc/encode_stream_wgx.cu: 448 and 520), 832-1472 the cluster one
# (csrc/encode_stream_wgk.cu: 800 and 832 at 832 padded, where 832 full
# units drifted past the gate on the split kernel; 833 at 896; 1024; 1280,
# the widest of one product a block; 1281, 1350 and 1472 at 1344, 1408 and
# 1472, a block's columns in two output chunks). N = 20,011 ends in a
# ragged pass and round, and channel-major at N % 4 != 0.
@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["voxel", "channel"])
@pytest.mark.parametrize("units,nb,act", [
    (100, 2, "relu"), (128, 2, "gelu"), (192, 2, "relu"), (256, 2, "relu"),
    (520, 1, "softplus"), (60, 7, "relu"), (320, 2, "gelu"),
    (384, 2, "relu"), (448, 1, "gelu"), (800, 1, "softplus"),
    (832, 1, "relu"), (833, 1, "relu"), (1024, 2, "softplus"),
    (1280, 1, "relu"), (1281, 1, "relu"), (1350, 1, "softplus"),
    (1472, 1, "gelu")])
def test_wide_and_deep_kernels_match_plain(cuda_device, trunk, layout, units,
                                           nb, act):
    """Kernels B and C at every width and depth against their plain
    versions: float32 at the kernel tolerances (C's q at rtol 1e-4 / atol
    3e-5, B by _close); bf16 C within BF16_ULPS bf16 ulps, B against the
    plain quadrature of C's q at the float32 tolerances and against its
    plain version at the JAX package's bf16 gate. One launch each, counted
    under the design launch_plan picks: wgmma in float32 up to 256 units
    (padded), chunked wgmma at 320 and 384, split wgmma at 448-768,
    cluster wgmma at 832-1472."""
    _wide_and_deep_case(cuda_device, trunk, layout, units, nb, act)


@pytest.mark.parametrize("layout", ["voxel", "channel"])
def test_deep_narrow_float32_takes_the_wgmma_design(cuda_device, layout):
    """30 units x 32 blocks in float32 (the resident blob does not fit at
    a padded width of 32): kernels B and C on the wgmma design, whose slab
    there holds 4 k-steps and the first layer's only 2, against their
    plain versions as test_wide_and_deep_kernels_match_plain holds them."""
    _wide_and_deep_case(cuda_device, "float32", layout, 30, 32, "softplus")


# dense tau scans: (units, blocks, tau_step, taus, design); 51 taus
# (tau_step 1.6 ms) at 768 x 1, 128 at 256 x 2 and 1472 x 1, where no
# block of their design fits beside a buffer of staged rows
MANY_TAUS = [(768, 1, 0.0016, 51, "split"), (256, 2, 0.000635, 128, "wgmma"),
             (1472, 1, 0.000635, 128, "cluster")]


@pytest.mark.parametrize("layout", ["voxel", "channel"])
@pytest.mark.parametrize("units,nb,step,taus,design", MANY_TAUS,
                         ids=[f"{u}x{nb}-t{t}" for u, nb, _, t, _ in
                              MANY_TAUS])
def test_many_taus_float32_takes_the_shared_rows_designs(
        cuda_device, layout, units, nb, step, taus, design):
    """768 units x 1 block on 51 taus, 256 x 2 and 1472 x 1 on 128 in
    float32: the split, wgmma and cluster blocks stage the rows in their
    activation rows (LaunchPlan.rows "shared"), kernels B and C held
    against their plain versions as test_wide_and_deep_kernels_match_plain
    holds them."""
    from qbold_vi_tpu_torch.ops import _cuda

    scan = dataclasses.replace(SCAN, tau_step=step)
    assert scan.n_taus == taus
    plan = tfi.launch_plan(tfi._padded_width(units), nb, taus, taus + 1,
                           "float32", True,
                           _cuda.library().qv_max_dynamic_smem())
    assert (plan.design, plan.rows) == (design, "shared")
    _wide_and_deep_case(cuda_device, "float32", layout, units, nb, "relu",
                        scan, design + "_launches")


# a staged row wider than the block's activation row: (units, blocks,
# tau_step, taus, design, layout, multi_image, mask channel); 330 taus
# (tau_step 0.246 ms: 336 channels) at 320 x 2 (320 columns), 64 x 2,
# 896 x 1 and 1472 x 1 (112 and 184 columns a cluster block), 512 taus
# (0.1585 ms) at 1280 x 1 (160 columns a block) and 448 x 1 (the split
# block's 448 columns)
WINDOWED = [(320, 2, 0.000246, 330, "chunked", "voxel", False, True),
            (320, 2, 0.000246, 330, "chunked", "channel", True, True),
            (64, 2, 0.000246, 330, "wgmma", "channel", False, False),
            (896, 1, 0.000246, 330, "cluster", "voxel", False, True),
            (1472, 1, 0.000246, 330, "cluster", "channel", False, True),
            (1280, 1, 0.0001585, 512, "cluster", "voxel", False, True),
            (448, 1, 0.0001585, 512, "split", "channel", False, True)]


@pytest.mark.parametrize(
    "units,nb,step,taus,design,layout,multi,mask", WINDOWED,
    ids=[f"{u}x{nb}-t{t}-{lay}" + ("-multi" if m else "")
         + ("" if k else "-nomask")
         for u, nb, _, t, _, lay, m, k in WINDOWED])
def test_float32_stages_windows_where_a_row_is_wider_than_the_block(
        cuda_device, units, nb, step, taus, design, layout, multi, mask):
    """Where a staged row is wider than the block's activation row, kernels
    B and C stage it a window of the first layer's k-steps at a time
    (LaunchPlan.rows "windowed") in the chunked, wgmma, cluster and split
    designs, held against their plain versions as
    test_wide_and_deep_kernels_match_plain holds them: both input
    layouts, multi_image once and no mask channel once."""
    from qbold_vi_tpu_torch.ops import _cuda

    scan = dataclasses.replace(SCAN, tau_step=step)
    assert scan.n_taus == taus
    plan = tfi.launch_plan(tfi._padded_width(units), nb, taus,
                           taus + int(mask), "float32", True,
                           _cuda.library().qv_max_dynamic_smem())
    assert (plan.design, plan.rows) == (design, "windowed")
    _wide_and_deep_case(cuda_device, "float32", layout, units, nb, "relu",
                        scan, design + "_launches", multi=multi, mask=mask)


# where both fit: (units, blocks, tau_step, taus, design)
BIT_EQUAL = [(256, 2, 0.000635, 128, "wgmma"), (384, 2, None, 11, "chunked"),
             (1472, 1, 0.000635, 128, "cluster"),
             (768, 1, 0.0016, 51, "split")]


@pytest.mark.parametrize("units,nb,step,taus,design", BIT_EQUAL,
                         ids=[f"{u}x{nb}-t{t}" for u, nb, _, t, _ in
                              BIT_EQUAL])
def test_windowed_rows_are_bit_equal_to_shared_rows(cuda_device, units, nb,
                                                    step, taus, design):
    """Where a staged row fits in the activation row, the windowed plan of
    each design gives kernels B and C the outputs of its plan with the
    whole rows there (shared; the chunked design's one layout of old) bit
    for bit: the same values, staged by every lane a window at a time, in
    the same bytes. Both launched by fused_infer._launch_bc."""
    from qbold_vi_tpu_torch.ops import _cuda

    scan = SCAN if step is None else dataclasses.replace(SCAN,
                                                         tau_step=step)
    assert scan.n_taus == taus
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, no_units=units,
                              no_intermediate_layers=nb)
    tuner = _tuner(cfg, cuda_device, scan)
    rng = np.random.default_rng(25)
    x = torch.from_numpy(volume(rng, (20_011,), taus + 1)).to(cuda_device)
    xs, cm, n, blob, u, up, t = tfi._launch_setup(
        x, tuner.encoder, n_blocks=nb, activation="relu", trunk="float32",
        mask_channel=True, input_layout="voxel", se_idx=scan.se_idx)
    args = tfi._encode_args(xs, n, cm, True, scan.se_idx, False, "relu")
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}
    for quad in (True, False):
        plan = tfi._plan(up, nb, t, t + 1, "float32", quad, x.device)
        assert (plan.design, plan.rows) == (
            design, "separate" if design == "chunked" else "shared")
        windowed = dataclasses.replace(plan, rows="windowed")
        for p in (plan, windowed):
            o = tuple(torch.full((3 if quad else 5, n), float("nan"),
                                 device=cuda_device)
                      for _ in range(3 if quad else 1))
            _cuda.check(tfi._launch_bc(_cuda.library(), p, quad, "float32",
                                       args, u, up, nb, t, blob, o, stream,
                                       _cuda.quad_ranges(**RANGES), True),
                        f"{design} {p.rows}")
            outs[(quad, p.rows)] = o
    torch.cuda.synchronize()
    for quad in (True, False):
        whole = outs[(quad, "separate" if design == "chunked" else "shared")]
        for a, b in zip(whole, outs[(quad, "windowed")]):
            assert torch.isfinite(a).all()
            assert torch.equal(a, b), (design, quad)


@pytest.mark.parametrize("units,nb,design", [(256, 2, "wgmma"),
                                             (768, 1, "split"),
                                             (1472, 1, "cluster")])
def test_shared_rows_are_bit_equal_to_separate_rows(cuda_device, units, nb,
                                                    design):
    """On 11 taus, where both fit, the shared-rows plan of the wgmma, split
    and cluster designs gives kernels B and C the separate-rows plan's
    outputs bit for bit: the same rows, staged elsewhere. Both launched by
    fused_infer._launch_bc, the entry tools/bench_stream1.py --sweep uses
    for an explicit plan."""
    from qbold_vi_tpu_torch.ops import _cuda

    cfg = dataclasses.replace(tcfg.OPTIMAL.model, no_units=units,
                              no_intermediate_layers=nb)
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(24)
    x = torch.from_numpy(volume(rng, (20_011,), SCAN.n_taus + 1)).to(
        cuda_device)
    xs, cm, n, blob, u, up, t = tfi._launch_setup(
        x, tuner.encoder, n_blocks=nb, activation="relu", trunk="float32",
        mask_channel=True, input_layout="voxel", se_idx=SCAN.se_idx)
    args = tfi._encode_args(xs, n, cm, True, SCAN.se_idx, False, "relu")
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}
    for quad in (True, False):
        plan = tfi._plan(up, nb, t, t + 1, "float32", quad, x.device)
        assert (plan.design, plan.rows) == (design, "separate")
        smem = {"wgmma": lambda: tfi._wg_smem(up, t, quad, plan.stages,
                                              plan.ks, shared=True),
                "split": lambda: tfi._wgx_smem(up, t, quad, plan.stages,
                                               plan.cn, True),
                "cluster": lambda: tfi._wgk_smem(up, t, quad, plan.stages,
                                                 plan.cluster, True)}[design]
        shared = dataclasses.replace(plan, rows="shared", smem=smem())
        assert shared.smem < plan.smem
        for p in (plan, shared):
            o = tuple(torch.full((3 if quad else 5, n), float("nan"),
                                 device=cuda_device)
                      for _ in range(3 if quad else 1))
            _cuda.check(tfi._launch_bc(_cuda.library(), p, quad, "float32",
                                       args, u, up, nb, t, blob, o, stream,
                                       _cuda.quad_ranges(**RANGES), True),
                        f"{design} {p.rows}")
            outs[(quad, p.rows)] = o
    torch.cuda.synchronize()
    for quad in (True, False):
        for a, b in zip(outs[(quad, "separate")], outs[(quad, "shared")]):
            assert torch.isfinite(a).all()
            assert torch.equal(a, b), (design, quad)


def _wide_and_deep_case(cuda_device, trunk, layout, units, nb, act,
                        scan=SCAN, want=None, multi=False, mask=True):
    from qbold_vi_tpu_torch.ops.quadrature import quad_tile_summaries

    cfg = dataclasses.replace(tcfg.OPTIMAL.model, no_units=units,
                              no_intermediate_layers=nb, activation=act,
                              compute_dtype=("bfloat16" if trunk == "bfloat16"
                                             else "float32"))
    tuner = _tuner(cfg, cuda_device, scan)
    rng = np.random.default_rng(units + nb)
    n = 20_011
    t_in = scan.n_taus + int(mask)
    x = torch.from_numpy(volume(rng, (n,), t_in)).to(cuda_device)
    if mask:
        x[:, -1] = (torch.rand(n, device=cuda_device) > 0.2).float()
    if layout == "channel":
        x = x.T.contiguous()
    kw = dict(se_idx=scan.se_idx, multi_image=multi, activation=act,
              n_blocks=nb, trunk=trunk, mask_channel=mask,
              input_layout=layout)
    names = [_design_counter(units, nb, trunk, quad, t_in, mask)
             for quad in (True, False)]
    if trunk == "float32":
        up = tfi._padded_width(units)
        assert names == 2 * [want or ("wgmma_launches" if up <= 256
                                      else "chunked_launches" if up <= 384
                                      else "split_launches" if up <= 768
                                      else "cluster_launches")]
    before = (getattr(tfi.encode_quad_fused, names[0]),
              getattr(tfi.encode_q1_packed, names[1]))
    q = tfi.encode_q1_packed(x, tuner.encoder, **kw)
    got = tfi.encode_quad_fused(x, tuner.encoder, mvg=True, **kw, **RANGES)
    torch.cuda.synchronize()
    assert (getattr(tfi.encode_quad_fused, names[0]) - before[0],
            getattr(tfi.encode_q1_packed, names[1]) - before[1]) == (1, 1)
    q_ref = tfi.encode_q_plain(x, tuner.encoder, **kw)
    ref = tfi.encode_quad_fused_plain(x, tuner.encoder, mvg=True, **kw,
                                      **RANGES)
    if trunk == "float32":
        np.testing.assert_allclose(q.cpu().numpy(), q_ref.cpu().numpy(),
                                   **MEAN_TOL)
        _close([g.T.cpu().numpy() for g in got],
               [r.T.cpu().numpy() for r in ref])
        return
    for j in range(5):
        _ulp_close(q[j], q_ref[j], BF16_ULPS, f"q row {j}")
    tail = quad_tile_summaries(q[0], q[1], q[2], q[3], q[4], mvg=True,
                               **RANGES)
    _close([g.T.cpu().numpy() for g in got],
           [torch.stack(t).T.cpu().numpy() for t in tail])
    for name, g, r in zip(("means", "raw"), (got[0], got[2]),
                          (ref[0], ref[2])):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=0.05, atol=0.03, err_msg=name)


@pytest.mark.parametrize("units,design", [(256, "wgmma"), (320, "chunked"),
                                          (448, "split")],
                         ids=["wgmma-256", "chunked-320", "split-448"])
def test_wgmma_design_raises_rather_than_running_plain(cuda_device,
                                                      monkeypatch, units,
                                                      design):
    """At 256 units x 2 blocks (the wgmma design), 320 x 2 (the chunked
    wgmma design) and 448 x 2 (the split wgmma design) a launch the card
    refuses (a plan past its shared memory) and a kernel library that does
    not build raise from kernels B and C; neither runs a plain version or
    counts a launch."""
    from qbold_vi_tpu_torch.ops import _cuda

    cfg = dataclasses.replace(tcfg.OPTIMAL.model, no_units=units)
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(19)
    x = torch.from_numpy(volume(rng, (5_003,), SCAN.n_taus + 1)).to(
        cuda_device)
    kw = dict(se_idx=SCAN.se_idx, multi_image=False, activation="relu",
              n_blocks=2, trunk="float32", mask_channel=True,
              input_layout="voxel")

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(tfi, "encode_quad_fused_plain", plain)
    monkeypatch.setattr(tfi, "encode_q_plain", plain)
    counter = design + "_launches"
    counts = (getattr(tfi.encode_quad_fused, counter),
              getattr(tfi.encode_q1_packed, counter))
    plan = tfi._plan
    assert plan(units, 2, SCAN.n_taus, SCAN.n_taus + 1, "float32", True,
                x.device).design == design
    monkeypatch.setattr(tfi, "_plan", lambda *a: dataclasses.replace(
        plan(*a), smem=1 << 20))
    with pytest.raises(RuntimeError, match="launch failed"):
        tfi.encode_quad_fused(x, tuner.encoder, mvg=True, **kw, **RANGES)
    with pytest.raises(RuntimeError, match="launch failed"):
        tfi.encode_q1_packed(x, tuner.encoder, **kw)
    monkeypatch.setattr(tfi, "_plan", plan)

    def unbuilt():
        raise RuntimeError("nvcc failed: no kernel library")

    monkeypatch.setattr(_cuda, "library", unbuilt)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfi.encode_quad_fused(x, tuner.encoder, mvg=True, **kw, **RANGES)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        tfi.encode_q1_packed(x, tuner.encoder, **kw)
    assert (getattr(tfi.encode_quad_fused, counter),
            getattr(tfi.encode_q1_packed, counter)) == counts


def test_launch_plan_scratch_is_the_kernels(cuda_device):
    """launch_plan counts kernel B's quadrature scratch as the C side sizes
    it (csrc/quad_math.cuh::QV_QUAD_SCRATCH)."""
    from qbold_vi_tpu_torch.ops import _cuda

    for threads in (128, 256, 384):
        assert (tfi._quad_scratch_floats(threads)
                == _cuda.library().qv_quad_scratch_floats(threads))


@pytest.mark.parametrize("layout", ["voxel", "channel"])
@pytest.mark.parametrize("units,mvg,multi,act,n", [
    (60, True, False, "relu", 50_003),
    (13, False, True, "relu", 50_003),
    (13, True, False, "gelu", 50_003),
    (30, False, False, "softplus", 50_003),
    (30, True, False, "relu", 31),
])
def test_encode_kernel_matches_plain(cuda_device, layout, units, mvg, multi,
                                     act, n):
    """Kernel C: the raw head q (5, N) of the stream-1 encode."""
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, no_units=units,
                              use_mvg=mvg, multi_image_normalisation=multi,
                              activation=act)
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(5)
    x = volume(rng, (n,), SCAN.n_taus + 1)
    x[:, -1] = rng.uniform(size=n) > 0.2
    xt = torch.from_numpy(x).to(cuda_device)
    if layout == "channel":
        xt = xt.T.contiguous()
    kw = dict(se_idx=SCAN.se_idx, multi_image=multi, activation=act,
              n_blocks=cfg.no_intermediate_layers, trunk="float32",
              mask_channel=True, input_layout=layout)
    before = tfi.encode_q1_packed.launches
    got = tfi.encode_q1_packed(xt, tuner.encoder, **kw)
    torch.cuda.synchronize()
    assert tfi.encode_q1_packed.launches == before + 1
    ref = tfi.encode_q_plain(xt, tuner.encoder, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               **MEAN_TOL)
    if not mvg:
        assert (got[4] == 0).all()


@pytest.mark.parametrize("device_noise", [False, True],
                         ids=["host", "philox"])
@pytest.mark.parametrize("mvg,antithetic,s", [(True, True, 200),
                                              (True, False, 7),
                                              (False, True, 9),
                                              (True, True, 2),
                                              (False, False, 200)])
def test_mc_summaries_kernel_matches_plain(cuda_device, mvg, antithetic, s,
                                           device_noise):
    """Kernel D in both layouts against its plain version."""
    n, k = 50_001, 5 if mvg else 4
    rng = np.random.default_rng(6)
    q = torch.from_numpy(raw_head(rng, n, k)).to(cuda_device)
    draws = tsm.mc_draws(s, antithetic)
    kw = dict(no_samples=s, mvg=mvg, antithetic=antithetic, **RANGES)
    if device_noise:
        noise = dict(seed=9, offset=1234)
        z = torch.from_numpy(tsm.mc_philox_normals(9, n, draws, 1234)
                             ).to(cuda_device)
    else:
        z = torch.from_numpy(rng.normal(size=(draws, n, 2)).astype(np.float32)
                             ).to(cuda_device)
        noise = dict(z=z)
    q_t = torch.cat([q.T, q.new_zeros((5 - k, n))]).contiguous()
    counts = (tsm.mc_posterior_summaries.launches,
              tsm.mc_posterior_summaries_packed.launches)
    got = tsm.mc_posterior_summaries(q, **noise, **kw)
    got_t = tsm.mc_posterior_summaries_packed(q_t, **noise, **kw)
    torch.cuda.synchronize()
    assert (tsm.mc_posterior_summaries.launches - counts[0],
            tsm.mc_posterior_summaries_packed.launches - counts[1]) == (1, 1)
    for a, b in zip(got, got_t):
        assert torch.equal(a, b.T)
    ref = tsm.mc_posterior_summaries_plain(q, z, **kw)
    _close([a.cpu().numpy() for a in got], [a.cpu().numpy() for a in ref])


@pytest.mark.parametrize("device_noise", [False, True],
                         ids=["host", "philox"])
@pytest.mark.parametrize("mvg,s", [(True, 100), (False, 100), (True, 7),
                                   (True, 2), (False, 7)])
def test_mc_kl_kernel_matches_plain(cuda_device, mvg, s, device_noise):
    """Kernel E against its plain version and, with host normals, against
    the replay of its lane order; KL(q || q) is 0. S odd and S below twice
    the lanes leave lanes with one draw or none; 50,001 voxels end in a
    ragged block."""
    n, k = 50_001, 5 if mvg else 4
    rng = np.random.default_rng(7)
    q = torch.from_numpy(raw_head(rng, n, k)).to(cuda_device)
    p = torch.from_numpy((rng.normal(size=(n, k)) * 0.7).astype(np.float32)
                         ).to(cuda_device)
    if device_noise:
        noise = dict(seed=3, offset=77)
        z = torch.from_numpy(tsm.mc_philox_normals(3, n, s, 77)
                             ).to(cuda_device)
    else:
        z = torch.from_numpy(rng.normal(size=(s, n, 2)).astype(np.float32)
                             ).to(cuda_device)
        noise = dict(z=z)
    before = tsm.mc_kl_map.launches
    got = tsm.mc_kl_map(q, p, no_samples=s, mvg=mvg, **noise)
    self_kl = tsm.mc_kl_map(q, q, no_samples=s, mvg=mvg, **noise)
    torch.cuda.synchronize()
    assert tsm.mc_kl_map.launches == before + 2
    assert (self_kl == 0).all()
    ref = tsm.mc_kl_map_plain(q, p, z, mvg)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4 if device_noise else 1e-5,
                               atol=1e-4)
    if not device_noise:
        assert_kl_close(got.cpu(), kl_lanes_replay(q, p, z, tsm.KL_LANES,
                                                   mvg).cpu(),
                        kl_scale(q, p, z, mvg).cpu(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["voxel", "channel"])
@pytest.mark.parametrize("act,units,mvg,n", [
    ("relu", 60, True, 100_003), ("softplus", 13, False, 4_099),
    ("gelu", 30, True, 4_099), ("sigmoid", 128, True, 4_099)])
def test_fused_kernel_bf16_trunk_matches_plain(cuda_device, layout, act,
                                               units, mvg, n):
    """Kernels B and C at trunk="bfloat16" against the plain versions."""
    from qbold_vi_tpu_torch.ops.quadrature import quad_tile_summaries

    cfg = tcfg.ModelConfig(no_units=units, activation=act, use_mvg=mvg,
                           compute_dtype="bfloat16")
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(units)
    x = torch.from_numpy(volume(rng, (n,), SCAN.n_taus + 1)).to(cuda_device)
    x[:, -1] = (torch.rand(n, device=cuda_device) > 0.2).float()
    if layout == "channel":
        x = x.T.contiguous()
    kw = dict(se_idx=SCAN.se_idx, multi_image=False, activation=act,
              n_blocks=cfg.no_intermediate_layers, trunk="bfloat16",
              mask_channel=True, input_layout=layout)
    counts = (tfi.encode_quad_fused.bf16_launches,
              tfi.encode_q1_packed.bf16_launches,
              tfi.encode_quad_fused.launches, tfi.encode_q1_packed.launches)
    q = tfi.encode_q1_packed(x, tuner.encoder, **kw)
    got = tfi.encode_quad_fused(x, tuner.encoder, mvg=mvg, **kw, **RANGES)
    torch.cuda.synchronize()
    assert (tfi.encode_quad_fused.bf16_launches - counts[0],
            tfi.encode_q1_packed.bf16_launches - counts[1],
            tfi.encode_quad_fused.launches - counts[2],
            tfi.encode_q1_packed.launches - counts[3]) == (1, 1, 0, 0)
    q_ref = tfi.encode_q_plain(x, tuner.encoder, **kw)
    for j in range(5 if mvg else 4):
        _ulp_close(q[j], q_ref[j], BF16_ULPS, f"q row {j}")
    if not mvg:
        assert (q[4] == 0).all()
    tail = quad_tile_summaries(q[0], q[1], q[2], q[3], q[4], mvg=mvg,
                               **RANGES)
    tail = [torch.stack(t).T.cpu().numpy() for t in tail]
    _close([g.T.cpu().numpy() for g in got], tail)
    ref = tfi.encode_quad_fused_plain(x, tuner.encoder, mvg=mvg, **kw,
                                      **RANGES)
    for name, g, r in zip(("means", "raw"), (got[0], got[2]),
                          (ref[0], ref[2])):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=0.05, atol=0.03, err_msg=name)


def test_bf16_encode_reads_unaligned_rows(cuda_device):
    """Kernels B and C at bf16 on voxel-major rows that start 4 bytes past
    a 16-byte boundary (the 4-byte cp.async path) give the same outputs,
    bit for bit, as on the same rows 16-byte aligned (the 16-byte path)."""
    cfg = tcfg.ModelConfig(no_units=60, use_mvg=True,
                           compute_dtype="bfloat16")
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(7)
    n, t_in = 4_099, SCAN.n_taus + 1
    x = torch.from_numpy(volume(rng, (n,), t_in)).to(cuda_device)
    buf = torch.empty(n * t_in + 1, device=cuda_device)
    shifted = buf[1:].view(n, t_in)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == 4 and x.data_ptr() % 16 == 0
    kw = dict(se_idx=SCAN.se_idx, multi_image=False, activation="relu",
              n_blocks=cfg.no_intermediate_layers, trunk="bfloat16",
              mask_channel=True, input_layout="voxel")
    q = tfi.encode_q1_packed(x, tuner.encoder, **kw)
    q_shifted = tfi.encode_q1_packed(shifted, tuner.encoder, **kw)
    got = tfi.encode_quad_fused(x, tuner.encoder, mvg=True, **kw, **RANGES)
    got_shifted = tfi.encode_quad_fused(shifted, tuner.encoder, mvg=True,
                                        **kw, **RANGES)
    torch.cuda.synchronize()
    assert torch.equal(q, q_shifted)
    assert all(torch.equal(a, b) for a, b in zip(got, got_shifted))


@pytest.mark.parametrize("use_first_op", [True, False],
                         ids=["stream1", "stream2"])
def test_posterior_maps_on_card(cuda_device, use_first_op):
    """The slice goes through the kernels on the card (launch counts
    move) and agrees with the plain versions on the CPU."""
    cfg = tcfg.OPTIMAL.model
    gpu = _tuner(cfg, cuda_device)
    cpu = _tuner(cfg, "cpu")
    rng = np.random.default_rng(2)
    data = volume(rng, (3, 16, 16, 4), SCAN.n_taus + 1)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    counts = (tfi.encode_quad_fused.launches,
              tq.quad_posterior_summaries.launches)
    got = infer.posterior_maps(gpu, data, use_first_op=use_first_op)
    moved = (tfi.encode_quad_fused.launches - counts[0],
             tq.quad_posterior_summaries.launches - counts[1])
    assert moved == ((2, 0) if use_first_op else (0, 2))
    ref = infer.posterior_maps(cpu, data, use_first_op=use_first_op)
    means = [np.concatenate([d["oef"], d["dbv"], d["r2p"]], -1)
             for d in (got, ref)]
    _close([means[0], got["stds"], got["raw_log_stds"]],
           [means[1], ref["stds"], ref["raw_log_stds"]])


def test_auto_at_256_units_launches_b_not_a(cuda_device):
    """At 256 units x 2 blocks "auto" runs stream 1 through kernel B (the
    wgmma design), not the encoder and kernel A, and matches the plain
    route on the CPU at test_torch_infer.py's tolerances; a forced "on"
    runs the same kernel."""
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, no_units=256,
                              compute_dtype="float32")
    gpu = _tuner(cfg, cuda_device)
    cpu = _tuner(cfg, "cpu")
    rng = np.random.default_rng(3)
    data = volume(rng, (3, 12, 12, 3), SCAN.n_taus + 1)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    counters = (lambda: tfi.encode_quad_fused.wgmma_launches,
                lambda: tfi.encode_quad_fused.launches,
                lambda: tq.quad_posterior_summaries.launches)
    counts = [c() for c in counters]
    got = infer.posterior_maps(gpu, data, use_first_op=True)
    moved = tuple(c() - n for c, n in zip(counters, counts))
    assert moved[0] > 0 and moved[1:] == (0, 0), moved
    ref = infer.posterior_maps(cpu, data, use_first_op=True)
    tol = dict(rtol=1e-3, atol=3e-5)
    for key in ("oef", "dbv", "r2p", "raw_log_stds"):
        np.testing.assert_allclose(got[key], ref[key], err_msg=key, **tol)
    means = np.concatenate([ref["oef"], ref["dbv"], ref["r2p"]], -1)
    assert_vars_close(got["stds"], ref["stds"], means, **tol)
    forced = _tuner(dataclasses.replace(cfg, fused_infer="on"), cuda_device)
    forced.load_state_dict(gpu.state_dict())
    again = infer.posterior_maps(forced, data, use_first_op=True)
    assert tfi.encode_quad_fused.wgmma_launches - counts[0] == 2 * moved[0]
    for key in ("oef", "dbv", "r2p", "stds", "raw_log_stds"):
        np.testing.assert_array_equal(again[key], got[key], err_msg=key)


@pytest.mark.parametrize("use_first_op", [True, False],
                         ids=["stream1", "stream2"])
def test_mc_posterior_maps_on_card(cuda_device, use_first_op):
    """method="mc" goes through kernels C and D (stream 1) or D (stream 2)
    and, with the same Philox draws, agrees with the CPU plain path."""
    cfg = tcfg.OPTIMAL.model
    gpu = _tuner(cfg, cuda_device)
    cpu = _tuner(cfg, "cpu")
    rng = np.random.default_rng(3)
    data = volume(rng, (3, 16, 16, 4), SCAN.n_taus + 1)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    counters = (tfi.encode_q1_packed, tsm.mc_posterior_summaries_packed,
                tsm.mc_posterior_summaries)
    counts = [f.launches for f in counters]
    got = infer.posterior_maps(gpu, data, use_first_op=use_first_op,
                               method="mc", seed=4)
    moved = tuple(f.launches - c for f, c in zip(counters, counts))
    assert moved == ((2, 2, 0) if use_first_op else (0, 0, 2))
    # at chunk 1 the same draws (cuDNN's rounding may follow the batch
    # shape; another seed's Monte-Carlo spread is ~1e-2)
    again = infer.posterior_maps(gpu, data, use_first_op=use_first_op,
                                 method="mc", seed=4, chunk=1)
    ref = infer.posterior_maps(cpu, data, use_first_op=use_first_op,
                               method="mc", seed=4)
    for other in (again, ref):
        means = [np.concatenate([d["oef"], d["dbv"], d["r2p"]], -1)
                 for d in (got, other)]
        _close([means[0], got["stds"], got["raw_log_stds"]],
               [means[1], other["stds"], other["raw_log_stds"]])


def test_elbo_maps_on_card(cuda_device):
    """elbo_maps launches kernel E once a chunk for an MVG head and gives
    the maps of the CPU path when both draw the same normals."""
    cfg = tcfg.OPTIMAL
    gpu = _tuner(cfg.model, cuda_device)
    cpu = _tuner(cfg.model, "cpu")
    rng = np.random.default_rng(4)
    data = volume(rng, (2, 12, 12, 3), SCAN.n_taus + 1)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    priors = (rng.normal(size=data.shape[:-1] + (5,)) * 0.5
              ).astype(np.float32)

    def host_noise(stream, seed, start, shape, draws, device, index=None):
        g = np.random.default_rng([seed, start,
                                   ("summaries", "kl", "decode").index(stream),
                                   0 if index is None else index + 1])
        lead = () if index is not None else (draws,)
        z = g.normal(size=lead + tuple(shape) + (2,)).astype(np.float32)
        return {"z": torch.from_numpy(z).to(device)}

    before = tsm.mc_kl_map.launches
    got = infer.elbo_maps(gpu, cfg, data, priors, seed=1, no_samples=5)
    assert tsm.mc_kl_map.launches == before + 2
    assert set(got) == {"likelihood", "kl", "residual"}
    assert all(np.isfinite(v).all() for v in got.values())
    draw = infer.draw_noise
    infer.draw_noise = host_noise
    try:
        a = infer.elbo_maps(gpu, cfg, data, priors, seed=1, no_samples=5)
        b = infer.elbo_maps(cpu, cfg, data, priors, seed=1, no_samples=5)
    finally:
        infer.draw_noise = draw
    for key in a:
        np.testing.assert_allclose(a[key], b[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)


# ---- the fine-tune kernels F and G ------------------------------------------

ROW_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
FT_CASES = {
    "optimal": dict(),
    "student_multi": dict(student_t_df=2.0, multi_image_normalisation=True),
    "log_data": dict(predict_log_data=True),
    "gj16": dict(quad_rule="gj16"),
    "diag": dict(use_mvg=False),
}


def _grad_close(got, ref, name):
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = ref.abs().max() + 1e-8
    np.testing.assert_allclose((got / scale).numpy(), (ref / scale).numpy(),
                               err_msg=name, **GRAD_TOL)


def _ft_inputs(rng, n, k, device, s_nll=1, s_kl=70):
    f = np.float32
    mask = (rng.uniform(size=n) > 0.2).astype(f)
    y = (np.abs(rng.normal(size=(n, SCAN.n_taus))) * 50 + 100).astype(f)
    arrays = dict(
        q=(rng.normal(size=(n, k)) * 0.7).astype(f),
        p=(rng.normal(size=(n, k)) * 0.7).astype(f),
        y=y * mask[:, None], sigma=rng.uniform(0.03, 0.2, (n, SCAN.n_taus)
                                               ).astype(f),
        mask=mask, z_nll=rng.normal(size=(s_nll, n, 2)).astype(f),
        z_kl=rng.normal(size=(s_kl, n, 2)).astype(f),
        ct_n=rng.normal(size=n).astype(f), ct_k=rng.normal(size=n).astype(f))
    return {k_: torch.from_numpy(v).to(device) for k_, v in arrays.items()}


# kernel G also serves the configuration kernel F leaves out
G_CASES = dict(FT_CASES, diag_pop_prior=dict(use_mvg=False,
                                             use_population_prior=True))


@pytest.mark.parametrize("case", list(G_CASES))
def test_decode_nll_kernel_matches_plain(cuda_device, case):
    """Kernel G's rows and its backward, with dy asked for and without
    (dy then None and the other gradients the same), against the plain
    version at 50,001 rows (a ragged tile)."""
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, **G_CASES[case])
    C = tdn.decode_consts(cfg, SCAN)
    rng = np.random.default_rng(8)
    n = 50_001
    a = _ft_inputs(rng, n, 5, cuda_device)
    oef = torch.from_numpy(rng.uniform(0.04, 0.84, n).astype(np.float32)
                           ).to(cuda_device)
    dbv = torch.from_numpy(rng.uniform(0.001, 0.201, n).astype(np.float32)
                           ).to(cuda_device)
    args = (oef, dbv, a["y"], a["sigma"], a["mask"])
    counts = (tdn.decode_nll_forward.launches,
              tdn.decode_nll_backward.launches)
    rows = tdn.decode_nll_forward(*args, C)
    grads = tdn.decode_nll_backward(*args, a["ct_n"], C)
    nody = tdn.decode_nll_backward(*args, a["ct_n"], C, want_dy=False)
    torch.cuda.synchronize()
    assert (tdn.decode_nll_forward.launches - counts[0],
            tdn.decode_nll_backward.launches - counts[1]) == (1, 2)
    np.testing.assert_allclose(
        rows.cpu().numpy(),
        (tdn.nll_row_plain(*args, C) * a["mask"]).cpu().numpy(), **ROW_TOL)
    ct = a["ct_n"] * a["mask"]
    ref = tdn.nll_row_grads_plain(*args, C)
    for name, g, r in zip(("doef", "ddbv", "dsig", "dy"), grads, ref):
        r = r * (ct if r.ndim == 1 else ct[:, None])
        _grad_close(g, r, name)
    assert nody[3] is None
    for name, g, x in zip(("doef", "ddbv", "dsig"), nody, grads):
        assert torch.equal(g, x), name


def _shape_rows(a, rows, C):
    """The row sets of kernel F's card cases: "random" as drawn;
    "clamped": q means near or past +-kl_bound, so that some or all KL
    draws clamp; "dead_warps": runs of 64 masked voxels (whole warps of
    dead voxels) in the first half, beside the random mask."""
    n = a["mask"].shape[0]
    if rows == "clamped":
        b = C.scalars["kl_bound"]
        a["q"][0::4, 0] = b - 0.5
        a["q"][1::4, 2] = -(b + 1.0)
        a["q"][2::4, 0] = -(b - 2.0)
    elif rows == "dead_warps":
        idx = torch.arange(n, device=a["mask"].device)
        dead = (idx < n // 2) & ((idx // 64) % 2 == 0)
        a["mask"][dead] = 0.0
        a["y"][dead] = 0.0


@pytest.mark.parametrize("rows", ["random", "clamped", "dead_warps"])
@pytest.mark.parametrize("s_nll", [1, 2])
@pytest.mark.parametrize("case", list(FT_CASES))
def test_fused_elbo_kernel_matches_plain(cuda_device, case, s_nll, rows):
    """Kernel F's rows and gradients against its plain version (host
    noise); the MVG backward both without the KL state (every draw
    replayed on the voxel's lanes) and from the forward's state (the KL
    side of unclamped voxels from the moments, of clamped ones replayed by
    the warp), against the plain version and each other;
    the state against kl_state_plain; dead voxels' outputs are 0."""
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, **FT_CASES[case])
    C = tdn.decode_consts(cfg, SCAN)
    mvg = cfg.use_mvg
    n = 40_003
    a = _ft_inputs(np.random.default_rng(9), n, 5 if mvg else 4,
                   cuda_device, s_nll=s_nll)
    _shape_rows(a, rows, C)
    main = (a["q"], a["p"], a["y"], a["sigma"], a["mask"])
    kw = dict(mvg=mvg, s_nll=s_nll, s_kl=70, z_nll=a["z_nll"],
              z_kl=a["z_kl"])
    state = (torch.full((n, tfe.KL_STATE), 7.0, device=cuda_device) if mvg
             else None)
    counts = (tfe.fused_elbo_forward.launches,
              tfe.fused_elbo_backward.launches,
              tfe.fused_elbo_backward.from_state)
    got = tfe.fused_elbo_forward(*main, C, state=state, **kw)
    gg = tfe.fused_elbo_backward(*main, a["ct_n"], a["ct_k"], C, **kw)
    gs = (tfe.fused_elbo_backward(*main, a["ct_n"], a["ct_k"], C,
                                  state=state, **kw) if mvg else gg)
    torch.cuda.synchronize()
    assert (tfe.fused_elbo_forward.launches - counts[0],
            tfe.fused_elbo_backward.launches - counts[1],
            tfe.fused_elbo_backward.from_state - counts[2]) == (
                (1, 2, 1) if mvg else (1, 1, 0))
    ref = tfe.elbo_rows_plain(*main, a["z_nll"], a["z_kl"], C, mvg)
    gr = tfe.elbo_grads_plain(*main, a["z_nll"], a["z_kl"], a["ct_n"],
                              a["ct_k"], C, mvg)
    for name, x, y in zip(("nll", "kl"), got, ref):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   err_msg=name, **ROW_TOL)
    names = ("dq", "dp", "dy", "dsig")
    for name, x, y, w in zip(names, gg, gr, gs):
        _grad_close(x, y, name)
        _grad_close(w, y, name + " from the state")
        _grad_close(w, x, name + " from the state vs replayed")
    if mvg:
        sref = tfe.kl_state_plain(a["q"], a["mask"], a["z_kl"], C)
        flag = state[:, 5] != 0
        assert torch.equal(flag, sref[:, 5] != 0)
        np.testing.assert_allclose(state[:, :5].cpu().numpy(),
                                   sref[:, :5].cpu().numpy(), rtol=1e-5,
                                   atol=1e-4)
        if rows == "clamped":
            assert int(flag.sum()) > n // 4
    dead = a["mask"] == 0
    assert int(dead.sum()) > 0
    for x, y in zip(tuple(got) + tuple(gg) + tuple(gs),
                    tuple(ref) + tuple(gr) + tuple(gr)):
        assert bool((x[dead] == 0).all())
        assert bool((y[dead][torch.isfinite(y[dead])] == 0).all())


def test_fused_elbo_device_noise_at_an_offset(cuda_device):
    """A launch over rows [h, n) at offset h draws, bit for bit, what one
    launch over all n rows draws there (forward and both backwards), and
    the plain version at that offset agrees with it."""
    cfg = tcfg.OPTIMAL.model
    C = tdn.decode_consts(cfg, SCAN)
    n, h = 20_000, 7_504
    a = _ft_inputs(np.random.default_rng(12), n, 5, cuda_device)
    a["q"][:, [1, 3]] *= 0.3
    a["p"][:, [1, 3]] *= 0.3
    main = (a["q"], a["p"], a["y"], a["sigma"], a["mask"])
    tail = [x[h:] for x in main]
    kw = dict(mvg=True, s_nll=1, s_kl=70, seed=9)
    states = [torch.empty(m, tfe.KL_STATE, device=cuda_device)
              for m in (n, n - h)]
    whole = tfe.fused_elbo_forward(*main, C, state=states[0], **kw)
    part = tfe.fused_elbo_forward(*tail, C, offset=h, state=states[1], **kw)
    assert torch.equal(states[0][h:], states[1])
    for st in (None, states):
        gw = tfe.fused_elbo_backward(*main, a["ct_n"], a["ct_k"], C,
                                     state=st and st[0], **kw)
        gp = tfe.fused_elbo_backward(*tail, a["ct_n"][h:], a["ct_k"][h:], C,
                                     offset=h, state=st and st[1], **kw)
        for x, y in zip(gw, gp):
            assert torch.equal(x[h:], y)
    for x, y in zip(whole, part):
        assert torch.equal(x[h:], y)
    ref = tfe.fused_elbo_forward(*[x.cpu() for x in tail], C, offset=h, **kw)
    for x, y in zip(part, ref):
        np.testing.assert_allclose(x.cpu().numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_fused_elbo_device_noise(cuda_device):
    """Device noise: the kernel's Philox draws are philox_normals' (the
    plain version fed them agrees), a seed replays bit for bit, another
    seed differs, and the KL rows are unbiased for the closed form."""
    cfg = tcfg.OPTIMAL.model
    C = tdn.decode_consts(cfg, SCAN)
    n = 30_000
    a = _ft_inputs(np.random.default_rng(10), n, 5, cuda_device)
    a["q"][:, [1, 3]] *= 0.3
    a["p"][:, [1, 3]] *= 0.3
    main = (a["q"], a["p"], a["y"], a["sigma"], a["mask"])
    kw = dict(mvg=True, s_nll=1, s_kl=70)
    r1 = tfe.fused_elbo_forward(*main, C, seed=5, **kw)
    r2 = tfe.fused_elbo_forward(*main, C, seed=5, **kw)
    r3 = tfe.fused_elbo_forward(*main, C, seed=6, **kw)
    g1 = tfe.fused_elbo_backward(*main, a["ct_n"], a["ct_k"], C, seed=5, **kw)
    g2 = tfe.fused_elbo_backward(*main, a["ct_n"], a["ct_k"], C, seed=5, **kw)
    for x, y in zip(r1 + g1, r2 + g2):
        assert torch.equal(x, y)
    states = [torch.empty(n, tfe.KL_STATE, device=cuda_device)
              for _ in range(2)]
    gs = []
    for st in states:
        tfe.fused_elbo_forward(*main, C, seed=5, state=st, **kw)
        gs.append(tfe.fused_elbo_backward(*main, a["ct_n"], a["ct_k"], C,
                                          seed=5, state=st, **kw))
    assert torch.equal(*states)
    for x, y, w in zip(gs[0], gs[1], g1):
        assert torch.equal(x, y)
        _grad_close(x, w, "from the state vs replayed")
    assert not torch.equal(r1[0], r3[0])
    z = torch.from_numpy(tfe.philox_normals(5, n, 71)).to(cuda_device)
    ref = tfe.elbo_rows_plain(*main, z[:1], z[1:], C, True)
    for x, y in zip(r1, ref):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
    from qbold_vi_tpu_torch.dist.logit_mvn import LogitMVN
    live = a["mask"] > 0
    diff = (r1[1] - LogitMVN().mvg_kl_closed_form(a["q"], a["p"]))[live]
    se = diff.std() / diff.numel() ** 0.5
    assert abs(float(diff.mean())) < 5 * float(se)


def _grads(tuner):
    return {k: p.grad.detach().cpu().double() for k, p in
            tuner.named_parameters() if p.grad is not None}


def _terms_grads(tuner, cfg, batch, noise):
    """Gradients of the plain fine-tune loss, backward at the caller's
    TF32 settings."""
    tuner.zero_grad()
    loss, _ = tsteps.finetune_terms(tuner, cfg, batch, noise=noise)
    loss.backward()
    return _grads(tuner)


def test_step_gradients_are_float32_on_the_card(cuda_device):
    """The fine-tune step's conv gradients on the card match the CPU's in
    float32 (make_finetune_step turns TF32 off for its backward too); the
    same backward with cuDNN's default TF32 would not. The activation is
    smooth: with relu, a pre-activation within float32 rounding of 0 can
    take the other side of the kink on the card than on the CPU, which
    moves a conv gradient by ~1e-4 of its scale whatever the TF32
    setting."""
    cfg = dataclasses.replace(
        tcfg.OPTIMAL, scan=SCAN,
        model=dataclasses.replace(tcfg.OPTIMAL.model, activation="softplus"),
        train=dataclasses.replace(tcfg.OPTIMAL.train, fused_elbo="off",
                                  fused_decode_nll="off"))
    rng = np.random.default_rng(12)
    shape = (6, 25, 25, 8)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask, "mask": mask,
             "priors": (rng.normal(size=shape + (5,)) * 0.3
                        ).astype(np.float32)}
    noise = {"z_nll": rng.normal(size=(1,) + shape + (2,)).astype(np.float32),
             "z_kl": rng.normal(size=(70,) + shape + (2,)).astype(np.float32)}
    sd = init_params(cfg.model, SCAN, torch.Generator().manual_seed(3))
    cpu = FineTuner(cfg.model, SCAN, device="cpu")
    cpu.load_state_dict(sd)
    gpu = FineTuner(cfg.model, SCAN, device=cuda_device)
    gpu.load_state_dict(sd)
    ref = _terms_grads(cpu, cfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, noise)
    gb = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        # the backward outside the step, cuDNN at its TF32 default
        tf32 = _terms_grads(gpu, cfg, gb, noise)
        # the step: TF32 off around its forward and backward
        opt = toptim.make_finetune_optimizer(gpu.parameters(), cfg.train)
        tsteps.make_finetune_step(gpu, cfg, opt)(gb, noise=noise)
        got = _grads(gpu)
        assert torch.backends.cudnn.allow_tf32      # restored
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    conv = [k for k in ref if "ConvXY" in k and k.endswith("weight")]
    assert conv
    for k in ref:
        _grad_close(got[k], ref[k], k)
    worst = max(float(((tf32[k] - ref[k]).abs().max()
                       / (ref[k].abs().max() + 1e-8))) for k in conv)
    assert worst > GRAD_TOL["atol"], (
        f"TF32 conv gradients were within float32 tolerance ({worst:.2e}): "
        "the check cannot tell the two apart")


@pytest.mark.parametrize("route", ["fused_conv", "fused_elbo"])
def test_step_through_kernels_matches_reference_route(cuda_device, route):
    """One fine-tune step on the card with a kernel against the same step
    through the reference route, gradients scale-normalised at GRAD_TOL:
    the trunk convs through kernel H (fused_conv "on") against cuDNN
    ("off"); the ELBO through kernel F (fused_elbo "on", its backward from
    the KL state) against kernel G plus the torch KL (fused_elbo "off").
    Host normals, so that both routes draw the same; softplus, since a
    relu input within rounding of 0 may take either side of the kink."""
    base = dataclasses.replace(
        tcfg.OPTIMAL, scan=SCAN,
        model=dataclasses.replace(tcfg.OPTIMAL.model, activation="softplus"))
    cfgs = {}
    for mode in ("on", "off"):
        if route == "fused_conv":
            cfgs[mode] = dataclasses.replace(base, model=dataclasses.replace(
                base.model, fused_conv=mode))
        else:
            cfgs[mode] = dataclasses.replace(base, train=dataclasses.replace(
                base.train, fused_elbo=mode, fused_decode_nll="on"))
    rng = np.random.default_rng(17)
    shape = (8, 25, 25, 8)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask, "mask": mask,
             "priors": (rng.normal(size=shape + (5,)) * 0.3
                        ).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    noise = {"z_nll": rng.normal(size=(1,) + shape + (2,)).astype(np.float32),
             "z_kl": rng.normal(size=(70,) + shape + (2,)).astype(np.float32)}
    sd = init_params(base.model, SCAN, torch.Generator().manual_seed(5))
    grads, counts = {}, {}
    for mode, cfg in cfgs.items():
        tuner = FineTuner(cfg.model, SCAN, device=cuda_device)
        tuner.load_state_dict(sd)
        opt = toptim.make_finetune_optimizer(tuner.parameters(), cfg.train)
        before = (tcv.conv3x3.bwd_launches, tfe.fused_elbo_backward.from_state,
                  tdn.decode_nll_backward.launches)
        tsteps.make_finetune_step(tuner, cfg, opt)(batch, noise=noise)
        torch.cuda.synchronize()
        counts[mode] = (tcv.conv3x3.bwd_launches - before[0],
                        tfe.fused_elbo_backward.from_state - before[1],
                        tdn.decode_nll_backward.launches - before[2])
        grads[mode] = _grads(tuner)
    n_conv = 2 * base.model.no_intermediate_layers
    if route == "fused_conv":
        assert counts == {"on": (n_conv, 1, 0), "off": (0, 1, 0)}
    else:
        assert counts == {"on": (0, 1, 0), "off": (0, 0, 1)}
    assert set(grads["on"]) == set(grads["off"])
    for k, g in grads["off"].items():
        _grad_close(grads["on"][k], g, k)


def test_diag_prior_step_through_g_matches_cpu(cuda_device):
    """One fine-tune step of a diagonal posterior with a population prior
    on the card -- under "auto" kernel G and the torch KL with the
    hyperprior cost, since kernel F does not cover it -- against the same
    step on the CPU plain path: the loss at rtol 1e-5, the gradients
    scale-normalised at GRAD_TOL (softplus, as above)."""
    cfg = dataclasses.replace(
        tcfg.OPTIMAL, scan=SCAN, model=dataclasses.replace(
            tcfg.OPTIMAL.model, activation="softplus", use_mvg=False,
            use_population_prior=True))
    rng = np.random.default_rng(19)
    shape = (6, 25, 25, 8)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask, "mask": mask,
             "priors": (rng.normal(size=shape + (4,)) * 0.3
                        ).astype(np.float32)}
    noise = {"z_nll": rng.normal(size=(1,) + shape + (2,)).astype(np.float32)}
    sd = init_params(cfg.model, SCAN, torch.Generator().manual_seed(6))
    loss, grads, counts = {}, {}, {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda_device)):
        tuner = FineTuner(cfg.model, SCAN, device=dev)
        tuner.load_state_dict(sd)
        opt = toptim.make_finetune_optimizer(tuner.parameters(), cfg.train)
        before = (tdn.decode_nll_forward.launches,
                  tdn.decode_nll_backward.launches,
                  tfe.fused_elbo_forward.launches)
        metrics = tsteps.make_finetune_step(tuner, cfg, opt)(
            {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            noise=noise)
        torch.cuda.synchronize()
        counts[name] = (tdn.decode_nll_forward.launches - before[0],
                        tdn.decode_nll_backward.launches - before[1],
                        tfe.fused_elbo_forward.launches - before[2])
        loss[name] = float(metrics["loss"])
        grads[name] = _grads(tuner)
    assert counts == {"cpu": (0, 0, 0), "card": (1, 1, 0)}
    np.testing.assert_allclose(loss["card"], loss["cpu"], rtol=1e-5)
    assert "pop_prior" in grads["card"]
    assert set(grads["card"]) == set(grads["cpu"])
    for k, g in grads["cpu"].items():
        _grad_close(grads["card"][k], g, k)


# ---- the 3x3 conv kernel H --------------------------------------------------

def _conv_inputs(rng, shape, device):
    n, h, w, ci, co = shape
    f = np.float32
    arrays = (rng.normal(size=(n, h, w, ci)).astype(f),
              (rng.normal(size=(3, 3, ci, co)) * 0.1).astype(f),
              (rng.normal(size=co) * 0.1).astype(f),
              rng.normal(size=(n, h, w, co)).astype(f))
    return [torch.from_numpy(a).to(device) for a in arrays]


def _scaled_close(got, ref, tol, name):
    got, ref = got.double().cpu(), ref.double().cpu()
    err = float((got - ref).abs().max())
    assert err <= tol * float(ref.abs().max()), f"{name}: {err:.3e}"


# the three main-path shapes (fine-tune fold, serving chunk, prepare_real's
# chunk), a batch of the fold, a pixel count off the 128-pixel tile, W = 3,
# W past the 130 at which the staged strip splits into three tap rows,
# ragged channel counts 1, 3, 5, 7 and 64, 65 (two channel tiles)
CONV_CARD_SHAPES = [(304, 25, 25, 60, 60), (16, 96, 96, 60, 60),
                    (32, 62, 76, 60, 60), (38, 25, 25, 60, 60),
                    (3, 7, 9, 60, 60), (9, 3, 11, 5, 7), (4, 5, 3, 7, 5),
                    (1, 4, 200, 8, 12), (2, 9, 10, 1, 3), (2, 9, 10, 3, 1),
                    (2, 9, 10, 5, 7), (2, 9, 10, 64, 65), (2, 9, 10, 65, 64)]


@pytest.mark.parametrize("shape", CONV_CARD_SHAPES)
def test_conv3x3_kernel_matches_plain(cuda_device, shape):
    x, w, b, ct = _conv_inputs(np.random.default_rng(14), shape, cuda_device)
    counts = (tcv.conv3x3.fwd_launches, tcv.conv3x3.bwd_launches)
    y = tcv.conv3x3_forward(x, w, b)
    dx, dw, db = tcv.conv3x3_backward(x, w, ct)
    torch.cuda.synchronize()
    assert (tcv.conv3x3.fwd_launches - counts[0],
            tcv.conv3x3.bwd_launches - counts[1]) == (1, 1)
    _scaled_close(y, tcv.conv3x3_plain(x, w, b), 1e-5, "y")
    ref = tcv.conv3x3_grads_plain(x, w, ct)
    for name, g, r, tol in zip(("dx", "dw", "db"), (dx, dw, db), ref,
                               (1e-5, 1e-4, 1e-4)):
        _scaled_close(g, r, tol, name)
    _, dw2, db2 = tcv.conv3x3_backward(x, w, ct, need_dx=False)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)   # replay


@pytest.mark.parametrize("shape", [(304, 25, 25, 60, 60), (3, 7, 9, 60, 60),
                                   (9, 3, 11, 5, 7), (1, 4, 200, 8, 12),
                                   (2, 9, 10, 64, 65), (2, 25, 25, 256, 256),
                                   (2, 96, 96, 60, 60)])
def test_conv3x3_bf16_kernel_matches_plain(cuda_device, shape):
    """Kernel H at bf16: forward, dx and dw/db against the plain versions
    within 2 bf16 ulps (each output one rounding of float32 sums; dw and db
    after the fixed-order reduction, so they replay bit for bit)."""
    x, w, b, ct = (t.to(torch.bfloat16) for t in _conv_inputs(
        np.random.default_rng(18), shape, cuda_device))
    counts = (tcv.conv3x3.fwd_bf16_launches, tcv.conv3x3.bwd_bf16_launches,
              tcv.conv3x3.fwd_launches, tcv.conv3x3.bwd_launches)
    y = tcv.conv3x3_forward(x, w, b)
    grads = tcv.conv3x3_backward(x, w, ct)
    torch.cuda.synchronize()
    assert (tcv.conv3x3.fwd_bf16_launches - counts[0],
            tcv.conv3x3.bwd_bf16_launches - counts[1],
            tcv.conv3x3.fwd_launches - counts[2],
            tcv.conv3x3.bwd_launches - counts[3]) == (1, 1, 0, 0)
    assert all(t.dtype == torch.bfloat16 for t in (y,) + grads)
    _ulp_close(y, tcv.conv3x3_plain(x, w, b), 2, "y")
    for name, g, r in zip(("dx", "dw", "db"), grads,
                          tcv.conv3x3_grads_plain(x, w, ct)):
        _ulp_close(g, r, 2, name)
    _, dw2, db2 = tcv.conv3x3_backward(x, w, ct, need_dx=False)
    assert torch.equal(grads[1], dw2) and torch.equal(grads[2], db2)
    with pytest.raises(TypeError, match="one dtype"):
        tcv.conv3x3_forward(x, w.float(), b)


def test_step_through_kernel_h_bf16_matches_cudnn_bf16(cuda_device):
    """One bf16 fine-tune step with the trunk convs through kernel H
    (fused_conv "on") against the same step through cuDNN (softplus)."""
    from torch_parity_utils import assert_bf16_grads_close

    base = dataclasses.replace(
        tcfg.OPTIMAL, scan=SCAN,
        model=dataclasses.replace(tcfg.OPTIMAL.model, activation="softplus",
                                  compute_dtype="bfloat16"))
    rng = np.random.default_rng(21)
    shape = (8, 25, 25, 8)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask, "mask": mask,
             "priors": (rng.normal(size=shape + (5,)) * 0.3
                        ).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    noise = {"z_nll": rng.normal(size=(1,) + shape + (2,)).astype(np.float32),
             "z_kl": rng.normal(size=(70,) + shape + (2,)).astype(np.float32)}
    sd = init_params(base.model, SCAN, torch.Generator().manual_seed(5))
    tuners, counts = {}, {}
    for mode in ("on", "off"):
        cfg = dataclasses.replace(base, model=dataclasses.replace(
            base.model, fused_conv=mode))
        tuner = FineTuner(cfg.model, SCAN, device=cuda_device)
        tuner.load_state_dict(sd)
        before = tcv.conv3x3.bwd_bf16_launches
        tuner.zero_grad()
        loss, _ = tsteps.finetune_terms(tuner, cfg, batch, noise=noise)
        loss.backward()
        torch.cuda.synchronize()
        counts[mode] = tcv.conv3x3.bwd_bf16_launches - before
        tuners[mode] = tuner
    assert counts == {"on": 2 * base.model.no_intermediate_layers, "off": 0}
    assert_bf16_grads_close(tuners["on"].named_parameters(),
                            {k: p.grad.cpu() for k, p in
                             tuners["off"].named_parameters()},
                            weight_tol=0.01, bias_tol=0.01)


def test_conv3x3_kernel_refuses_bad_inputs(cuda_device):
    x, w, b, ct = _conv_inputs(np.random.default_rng(15), (2, 5, 6, 4, 3),
                               cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tcv.conv3x3_forward(x.transpose(1, 2).contiguous().transpose(1, 2),
                            w, b)
    with pytest.raises(TypeError, match="float32"):
        tcv.conv3x3_forward(x.double(), w, b)
    with pytest.raises(TypeError, match="CUDA"):
        tcv.conv3x3_forward(x, w.cpu(), b)
    with pytest.raises(ValueError, match="cotangent"):
        tcv.conv3x3_backward(x, w, ct[:, :, :, :2].contiguous())
    with pytest.raises(ValueError, match="at least 3 x 3"):
        tcv.conv3x3_forward(x[:, :2].contiguous(), w, b)


def test_fused_conv_runs_kernel_h_in_a_finetune_step(cuda_device):
    cfg = dataclasses.replace(
        tcfg.OPTIMAL, scan=SCAN,
        model=dataclasses.replace(tcfg.OPTIMAL.model, fused_conv="on"))
    tuner = _tuner(cfg.model, cuda_device)
    rng = np.random.default_rng(16)
    shape = (4, 25, 25, 8)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask, "mask": mask,
             "priors": (rng.normal(size=shape + (5,)) * 0.3
                        ).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    opt = toptim.make_finetune_optimizer(tuner.parameters(), cfg.train)
    counts = (tcv.conv3x3.fwd_launches, tcv.conv3x3.bwd_launches)
    m = tsteps.make_finetune_step(tuner, cfg, opt)(batch, seed=3)
    torch.cuda.synchronize()
    n_conv = 2 * cfg.model.no_intermediate_layers
    assert (tcv.conv3x3.fwd_launches - counts[0],
            tcv.conv3x3.bwd_launches - counts[1]) == (n_conv, n_conv)
    assert all(bool(torch.isfinite(v)) for v in m.values())


# ---- kernel S, the streaming synthetic batch ---------------------------------

S_CASES = {
    "optimal": dict(),
    "mixture_misalign": dict(uniform_prop=0.3, misalign_prob=0.5),
    "gj16_no_noise": dict(uniform_prop=0.3, misalign_prob=0.5,
                          quad_rule="gj16", simulate_noise=False),
}


def _synth_cfg(case):
    kw = dict(S_CASES[case])
    scan = dataclasses.replace(tcfg.OPTIMAL.scan,
                               simulate_noise=kw.pop("simulate_noise", True))
    model = dataclasses.replace(tcfg.OPTIMAL.model,
                                quad_rule=kw.pop("quad_rule", "auto"))
    return dataclasses.replace(
        tcfg.OPTIMAL, scan=scan, model=model,
        synth=dataclasses.replace(tcfg.OPTIMAL.synth, **kw))


@pytest.mark.parametrize("case", list(S_CASES))
def test_synth_batch_kernel_matches_plain(cuda_device, case):
    """Kernel S against its plain version fed the host replay of its draws
    (ops/synth_batch.py::synth_philox_draws), at the row tolerance rtol
    1e-5 / atol 1e-5: the plain decode (ops/physics.py) rounds its
    constants otherwise than the kernel's table, and the replay's normals
    are numpy's log/sin/cos; a seed replays bit for bit, another differs."""
    from qbold_vi_tpu_torch.ops import synth_batch as tsb

    cfg = _synth_cfg(case)
    b, seed = 64, 2 ** 40 + 17
    n = b * 500
    before = (tsb.synth_batch.launches, tsb.synth_batch.noise_launches)
    got = tsb.synth_batch(cfg, b, seed, device=cuda_device)
    again = tsb.synth_batch(cfg, b, seed, device=cuda_device)
    other = tsb.synth_batch(cfg, b, seed + 1, device=cuda_device)
    torch.cuda.synchronize()
    noisy = int(cfg.scan.simulate_noise)
    assert (tsb.synth_batch.launches - before[0],
            tsb.synth_batch.noise_launches - before[1]) == (3, 3 * noisy)
    ref = tsteps.stream_synthetic_batch(
        cfg, b, tsb.synth_philox_draws(seed, n, SCAN.n_taus),
        device=cuda_device)
    for k, shape in (("x", (b, 10, 10, 5, 11)), ("y", (b, 10, 10, 5, 3))):
        assert got[k].shape == shape
        assert torch.equal(got[k], again[k]), k
        assert not torch.equal(got[k], other[k]), k
        np.testing.assert_allclose(got[k].cpu().numpy(),
                                   ref[k].cpu().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    y = got["y"].reshape(-1, 3).cpu().numpy()
    s = cfg.synth
    assert s.oef_start <= y[:, 0].min() and y[:, 0].max() <= s.oef_end
    assert s.dbv_start <= y[:, 1].min() and y[:, 1].max() <= s.dbv_end


def test_stream_step_on_card_matches_cpu(cuda_device):
    """One streaming pretrain step from one seed: on the card through
    kernel S, on the CPU through the plain version of S's replayed draws
    -- the loss at rtol 1e-5, the gradients scale-normalised at GRAD_TOL
    (softplus: a relu kink moves a gradient by more than the batches'
    float32 rounding)."""
    from qbold_vi_tpu_torch.ops import synth_batch as tsb

    cfg = dataclasses.replace(
        tcfg.OPTIMAL,
        model=dataclasses.replace(tcfg.OPTIMAL.model, activation="softplus"),
        train=dataclasses.replace(tcfg.OPTIMAL.train, pt_batch_size=16))
    sd = init_params(cfg.model, cfg.scan, torch.Generator().manual_seed(4))
    loss, grads = {}, {}
    for name, dev in (("cpu", torch.device("cpu")), ("card", cuda_device)):
        tuner = FineTuner(cfg.model, cfg.scan, device=dev)
        tuner.load_state_dict(sd)
        opt = toptim.make_pretrain_optimizer(tuner.named_parameters(),
                                             cfg.train)
        launched = tsb.synth_batch.launches
        m, _ = tsteps.make_pretrain_stream_step(tuner, cfg, opt)(seed=99)
        torch.cuda.synchronize()
        assert tsb.synth_batch.launches - launched == (name == "card")
        loss[name] = float(m["loss"])
        grads[name] = _grads(tuner)
    np.testing.assert_allclose(loss["card"], loss["cpu"], rtol=1e-5)
    assert set(grads["card"]) == set(grads["cpu"])
    for k, g in grads["cpu"].items():
        _grad_close(grads["card"][k], g, k)


def test_stream_pretrain_routes_the_asymptotic_model(cuda_device, tmp_path):
    """train.full_model=False: kernel S does not decode the asymptotic
    tissue model, so the batch takes the plain version of S's replayed
    draws on the card (no launch of S), and the streaming pretrain runs."""
    from qbold_vi_tpu_torch.ops import synth_batch as tsb
    from qbold_vi_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(
        tcfg.OPTIMAL, model=dataclasses.replace(tcfg.OPTIMAL.model,
                                                no_units=16),
        synth=dataclasses.replace(tcfg.OPTIMAL.synth, sample_size=400),
        train=dataclasses.replace(tcfg.OPTIMAL.train, full_model=False,
                                  pt_on_device_synth=True, no_pt_epochs=1,
                                  pt_batch_size=16))
    before = (tsb.synth_batch.launches, tsb.synth_batch.noise_launches)
    got = tsb.synth_batch(cfg, 16, 5, device=cuda_device)
    ref = tsteps.stream_synthetic_batch(
        cfg, 16, tsb.synth_philox_draws(5, 16 * 500, SCAN.n_taus),
        device=cuda_device)
    for k in ("x", "y"):
        assert got[k].device.type == "cuda"
        assert torch.equal(got[k], ref[k]), k
    trainer = Trainer(own_save_dir(cfg, tmp_path), device=cuda_device)
    m = trainer.pretrain()
    torch.cuda.synchronize()
    assert (tsb.synth_batch.launches,
            tsb.synth_batch.noise_launches) == before
    assert all(np.isfinite(float(v)) for v in m.values())


def test_wls_maps_on_card_match_cpu(cuda_device):
    """baseline.wls_maps on the card against the CPU on noisy physics
    signals: the same float32 operations, the taus summed in another
    order (torch_parity_utils.assert_wls_close)."""
    from qbold_vi_tpu_torch import baseline
    from qbold_vi_tpu_torch.ops import physics

    rng = np.random.default_rng(5)
    shape = (3, 32, 32, 8)
    sig = physics.ase_signal(
        torch.from_numpy(rng.uniform(0.05, 0.8, shape).astype(np.float32)),
        torch.from_numpy(rng.uniform(0.003, 0.195, shape).astype(
            np.float32)), SCAN).numpy() * 800.0
    x = (sig + rng.normal(size=sig.shape) * sig.mean() / 80.0).astype(
        np.float32)
    got = baseline.wls_maps(x, SCAN, device=cuda_device)
    ref = baseline.wls_maps(x, SCAN, device="cpu")
    assert got.shape == shape + (3,)
    assert_wls_close(got, ref, x, SCAN)


def test_checkpoints_round_trip_on_the_card(cuda_device, tmp_path):
    """A Trainer on the card writes a .partial of its fine-tune (crash at
    epoch 1) and final_model.msgpack after the resume; the file's tensors
    come back on the card bit for bit, in a fresh Trainer resumed
    FULL_TRAINED, and two runs resumed from one .partial end equal."""
    import shutil

    from qbold_vi_tpu_torch.train.trainer import Trainer, WeightStatus

    base = tcfg.OPTIMAL
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, no_units=16),
        train=dataclasses.replace(base.train, no_ft_epochs=2,
                                  ft_steps_per_epoch=3, ft_batch_size=4,
                                  checkpoint_every_epochs=1))
    rng = np.random.default_rng(3)
    data = volume(rng, (2, 40, 30, 2), cfg.scan.n_taus + 1)
    data[..., -1] = 1.0
    weights = init_params(cfg.model, cfg.scan,
                          torch.Generator().manual_seed(2))

    class Crash(RuntimeError):
        pass

    def crash(phase, epoch, m):
        if epoch == 1:
            raise Crash()

    first = own_save_dir(cfg, tmp_path)
    with pytest.raises(Crash):
        Trainer(first, state_dict=weights, device=cuda_device,
                logger=crash).finetune(data)
    partial = os.path.join(first.train.save_directory,
                           "final_model.msgpack.partial")
    finals = []
    for _ in range(2):
        c = own_save_dir(cfg, tmp_path)
        shutil.copy(partial, c.train.save_directory)
        t = Trainer(c, state_dict=weights, resume_partial=True,
                    device=cuda_device, logger=lambda *a: None)
        t.finetune(data)
        assert t.status is WeightStatus.FULL_TRAINED
        finals.append(t)
    for k, v in finals[0].tuner.state_dict().items():
        assert torch.equal(v, finals[1].tuner.state_dict()[k]), k
    back = Trainer(finals[0].cfg, device=cuda_device)
    assert back.status is WeightStatus.FULL_TRAINED
    for k, v in finals[0].tuner.state_dict().items():
        assert back.tuner.state_dict()[k].device.type == "cuda"
        assert torch.equal(back.tuner.state_dict()[k], v), k
    assert back._load_state(back.final_path,
                            "finetune").opt_state.count == 6


def test_pretrain_resumes_its_swa_on_the_card(cuda_device, tmp_path):
    """A pretrain .partial holding SWA's average (one fold, at the end of
    epoch 0) resumed on the card: the average comes to the card, and the
    fold at the end of epoch 1 gives (average + weights) / 2 of the saved
    average and the final weights, also in pt_model.msgpack. A CPU resume
    of the same file ends within 2 pt_lr a resumed step of the card's
    weights (each run moves a weight by about pt_lr a step; the card's
    decode and sums round otherwise), and its average within half that."""
    import shutil

    from qbold_vi_tpu_torch.train.trainer import Trainer

    base = dataclasses.replace(
        tcfg.OPTIMAL,
        model=dataclasses.replace(tcfg.OPTIMAL.model, no_units=16),
        synth=dataclasses.replace(tcfg.OPTIMAL.synth, sample_size=60),
        train=dataclasses.replace(tcfg.OPTIMAL.train, no_pt_epochs=2,
                                  pt_batch_size=2, pt_on_device_synth=False,
                                  checkpoint_every_epochs=1))
    probe = Trainer(own_save_dir(base, tmp_path), device="cpu")
    (tx, _), _ = probe.build_pretrain_data()
    spe = len(tx) // base.train.pt_batch_size
    assert spe >= 2
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, swa_start=spe, swa_period=spe))

    class Crash(RuntimeError):
        pass

    def crash(phase, epoch, m):
        if epoch == 1:
            raise Crash()

    first = own_save_dir(cfg, tmp_path)
    with pytest.raises(Crash):
        Trainer(first, device=cuda_device, logger=crash).pretrain()
    partial = os.path.join(first.train.save_directory,
                           "pt_model.msgpack.partial")
    ends = {}
    for dev in (cuda_device, torch.device("cpu")):
        c = own_save_dir(cfg, tmp_path)
        shutil.copy(partial, c.train.save_directory)
        t = Trainer(c, device=dev, logger=lambda *a: None)
        saved = t._load_state(t._partial_path(t.pt_path), "pretrain").swa
        assert (saved.step, saved.n_avg) == (spe, 1)
        t.pretrain()
        assert (t.swa.step, t.swa.n_avg) == (2 * spe, 2)
        params = dict(t.tuner.named_parameters())
        for k, p in params.items():
            avg = t.swa.average[k]
            assert avg.device.type == dev.type, k
            want = (saved.average[k].to(dev) * 1.0 + p.detach()) \
                / p.new_tensor(2.0)
            assert torch.equal(avg, want), k
        written = t._load_state(t.pt_path, "pretrain").swa
        assert written.n_avg == 2
        for k, v in written.average.items():
            assert torch.equal(v, t.swa.average[k].cpu()), k
        ends[dev.type] = ({k: p.detach().cpu() for k, p in params.items()},
                          {k: v.cpu() for k, v in t.swa.average.items()})
    lr = cfg.train.pt_lr
    for i, tol in ((0, 2 * lr * spe), (1, lr * spe)):
        for k, v in ends["cpu"][i].items():
            err = float((ends["cuda"][i][k] - v).abs().max())
            assert err <= tol, (k, i, err)


def test_cli_train_and_infer_on_the_card(cuda_device, tmp_path):
    """python -m qbold_vi_tpu_torch train --smoke then infer, on the card by
    default (no --device)."""
    from qbold_vi_tpu_torch.cli import main
    from qbold_vi_tpu_torch.io.nifti import load_nifti

    save = str(tmp_path / "run")
    assert main(["train", "--smoke", "--set", f"save_directory={save}",
                 "--set", f"d={tmp_path / 'none'}"]) == 0
    rng = np.random.default_rng(1)
    data = volume(rng, (1, 8, 8, 2), 12)
    data[..., -1] = 1.0
    np.save(tmp_path / "subj.npy", data)
    out = str(tmp_path / "maps")
    assert main(["infer", str(tmp_path / "subj.npy"), "-o", out,
                 "--set", f"save_directory={save}", "--set", "no_units=8",
                 "--set", "no_intermediate_layers=1"]) == 0
    assert np.all(np.isfinite(load_nifti(out + "_oef.nii.gz")))


# ---- kernel B's registered op, the serving artifacts, dropout --------------

@pytest.mark.parametrize("trunk", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["voxel", "channel"])
def test_kernel_b_op_matches_the_direct_launch(cuda_device, layout, trunk):
    """encode_quad_fused (through torch.ops.qbold_vi_tpu_torch.
    encode_quad_fused) against the ctypes call of the C entry made as the
    wrapper made it before the op: bit for bit, one launch counted."""
    from qbold_vi_tpu_torch.ops import _cuda

    cfg = dataclasses.replace(tcfg.OPTIMAL.model, compute_dtype=(
        "bfloat16" if trunk == "bfloat16" else "auto"))
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(31)
    x = torch.from_numpy(volume(rng, (20_011,), 12)).to(cuda_device)
    if layout == "channel":
        x = x.T.contiguous()
    kw = dict(se_idx=SCAN.se_idx, multi_image=cfg.multi_image_normalisation,
              activation=cfg.activation, n_blocks=cfg.no_intermediate_layers,
              trunk=trunk, mask_channel=True, input_layout=layout)
    counter = "bf16_launches" if trunk == "bfloat16" else "launches"
    before = getattr(tfi.encode_quad_fused, counter)
    got = tfi.encode_quad_fused(x, tuner.encoder, mvg=True, **RANGES, **kw)
    assert getattr(tfi.encode_quad_fused, counter) == before + 1
    xs, cm, n, blob, u, up, t = tfi._launch_setup(
        x, tuner.encoder, n_blocks=kw["n_blocks"], activation=kw["activation"],
        trunk=trunk, mask_channel=True, input_layout=layout,
        se_idx=kw["se_idx"])
    plan = tfi._plan(up, kw["n_blocks"], t, t + 1, trunk, True, x.device)
    assert plan.design == "resident"
    ref = [torch.empty((3, n), device=cuda_device) for _ in range(3)]
    err = tfi._entry("qv_encode_quad_fused", trunk)(
        *tfi._encode_args(xs, n, cm, True, kw["se_idx"], kw["multi_image"],
                          kw["activation"]),
        u, up, kw["n_blocks"], blob.data_ptr(), blob.numel(),
        _cuda.quad_ranges(**RANGES), *(r.data_ptr() for r in ref), 1,
        plan.threads, plan.smem, torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "B direct")
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_fused_artifact_reloads_in_a_fresh_process(cuda_device, tmp_path):
    """The fused .pt2 (kernel B's op over channel-major rows, N baked)
    reloaded by another process that imports qbold_vi_tpu_torch gives the
    in-process kernel-B route's maps bit for bit, with one B launch."""
    import subprocess
    import sys

    from qbold_vi_tpu_torch.io import export_model as em

    tuner = _tuner(tcfg.OPTIMAL.model, cuda_device)
    shape = (2, 40, 33, 4)
    ep = em.export_inference(tuner, fused=True, platforms=("cuda",),
                             example_shape=shape)
    path = str(tmp_path / "fused.pt2")
    em.save_exported(ep, path)
    rng = np.random.default_rng(5)
    x_cm = np.ascontiguousarray(volume(rng, shape, 12).reshape(-1, 12).T)
    np.save(tmp_path / "x.npy", x_cm)
    ref = tfi.encode_quad_fused(
        torch.from_numpy(x_cm).to(cuda_device), tuner.encoder,
        se_idx=SCAN.se_idx, multi_image=False, activation="relu",
        n_blocks=2, trunk="float32", mvg=True, **RANGES, mask_channel=True,
        input_layout="channel")
    script = (
        "import sys, numpy as np, torch\n"
        "import qbold_vi_tpu_torch\n"
        "from qbold_vi_tpu_torch.io.export_model import load_exported\n"
        "from qbold_vi_tpu_torch.ops import fused_infer as fi\n"
        "art = load_exported(sys.argv[1])\n"
        "x = torch.from_numpy(np.load(sys.argv[2])).cuda()\n"
        "out = art(x)\n"
        "torch.cuda.synchronize()\n"
        "np.savez(sys.argv[3], **{k: v.cpu().numpy() for k, v in "
        "out.items()})\n"
        "print(fi.encode_quad_fused.launches)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", script, path, str(tmp_path / "x.npy"),
         str(tmp_path / "out.npz")], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=repo))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "1"
    with np.load(tmp_path / "out.npz") as out:
        for key, r in zip(("means", "stds", "raw_log_stds"), ref):
            np.testing.assert_array_equal(out[key], r.cpu().numpy(),
                                          err_msg=key)


@pytest.mark.parametrize("trunk,units", [("float32", 256),
                                         ("bfloat16", 256),
                                         ("float32", 320),
                                         ("float32", 448)],
                         ids=["float32", "bfloat16", "float32-320",
                              "float32-448"])
def test_fused_artifact_at_256_units(cuda_device, tmp_path, trunk, units):
    """The fused .pt2 at 256 units x 2 blocks (kernel B's wgmma design in
    float32, the streamed one in bf16), at 320 x 2 in float32 (the chunked
    wgmma design) and at 448 x 2 (the split wgmma design) exports, saves,
    reloads and gives the in-process kernel-B route's maps bit for bit, one
    launch of that design a call."""
    from qbold_vi_tpu_torch.io import export_model as em

    cfg = dataclasses.replace(tcfg.OPTIMAL.model, no_units=units,
                              compute_dtype=trunk)
    tuner = _tuner(cfg, cuda_device)
    shape = (1, 24, 20, 4)
    path = str(tmp_path / "fused256.pt2")
    em.save_exported(em.export_inference(tuner, fused=True,
                                         platforms=("cuda",),
                                         example_shape=shape), path)
    art = em.load_exported(path)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(np.ascontiguousarray(
        volume(rng, shape, 12).reshape(-1, 12).T)).to(cuda_device)
    counter = ("stream_bf16_launches" if trunk == "bfloat16" else
               "wgmma_launches" if units <= 256 else "chunked_launches"
               if units <= 384 else "split_launches")
    before = getattr(tfi.encode_quad_fused, counter)
    out = art(x)
    torch.cuda.synchronize()
    assert getattr(tfi.encode_quad_fused, counter) == before + 1
    ref = tfi.encode_quad_fused(
        x, tuner.encoder, se_idx=SCAN.se_idx, multi_image=False,
        activation="relu", n_blocks=2, trunk=trunk, mvg=True, **RANGES,
        mask_channel=True, input_layout="channel")
    for key, r in zip(("means", "stds", "raw_log_stds"), ref):
        assert torch.equal(out[key], r), key


_REFUSALS = [(833, "smem"), (833, "cluster"), (833, "unbuilt"),
             (833, "shared"), (1281, "smem"), (1281, "cluster"),
             (1281, "unbuilt"), (1281, "chunk"), (1281, "segment"),
             (1281, "windowed")]


@pytest.mark.parametrize(
    "units,refusal", _REFUSALS,
    ids=[r if u == 833 else f"{u}-{r}" for u, r in _REFUSALS])
def test_cluster_design_raises_rather_than_falling_back(cuda_device,
                                                       monkeypatch, units,
                                                       refusal):
    """At 833 units x 1 block (the cluster design, 896 padded) and at 1281
    (1344 padded, a block's columns in two output chunks) a cluster launch
    that cannot run raises from kernels B and C: a block past the card's
    shared memory, a cluster of 16 blocks (past the portable 8), a kernel
    library that does not build, at 896 a shared-rows plan the build does
    not compile (112 columns a block) and, chunked, a first chunk or a
    promoted segment the build does not compile, and a windowed-rows plan
    it does not compile (a segment of 3 k-steps at 168 columns a block).
    No other design (split, streamed) launches in its place, no plain
    version runs and no launch is counted."""
    from qbold_vi_tpu_torch.ops import _cuda

    cfg = dataclasses.replace(tcfg.OPTIMAL.model, no_units=units,
                              no_intermediate_layers=1)
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(22)
    x = torch.from_numpy(volume(rng, (5_003,), SCAN.n_taus + 1)).to(
        cuda_device)
    kw = dict(se_idx=SCAN.se_idx, multi_image=False, activation="relu",
              n_blocks=1, trunk="float32", mask_channel=True,
              input_layout="voxel")

    def plain(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(tfi, "encode_quad_fused_plain", plain)
    monkeypatch.setattr(tfi, "encode_q_plain", plain)
    plan = tfi._plan
    chosen = plan(tfi._padded_width(units), 1, SCAN.n_taus, SCAN.n_taus + 1,
                  "float32", True, x.device)
    assert chosen.design == "cluster" and (chosen.chunk > 0) == (units > 1280)
    wrappers = (tfi.encode_quad_fused, tfi.encode_q1_packed)
    counters = [c for c in vars(tfi.encode_quad_fused)
                if c.endswith("launches")]

    def counts():
        return [getattr(w, c) for w in wrappers for c in counters]

    before = counts()
    if refusal == "unbuilt":
        def unbuilt():
            raise RuntimeError("nvcc failed: no kernel library")

        monkeypatch.setattr(_cuda, "library", unbuilt)
        match = "nvcc failed"
    else:
        change = {"smem": {"smem": 1 << 20},
                  "cluster": {"cluster": 16, "cn": 56} if units == 833
                  else {"cluster": 12, "cn": 112},
                  "chunk": {"chunk": 72},
                  "segment": {"seg": 3, "stages": 4},
                  "shared": {"rows": "shared"},
                  "windowed": {"rows": "windowed", "seg": 3,
                               "stages": 4}}[refusal]
        monkeypatch.setattr(tfi, "_plan", lambda *a: dataclasses.replace(
            plan(*a), **change))
        match = "launch failed"
    with pytest.raises(RuntimeError, match=match):
        tfi.encode_quad_fused(x, tuner.encoder, mvg=True, **kw, **RANGES)
    with pytest.raises(RuntimeError, match=match):
        tfi.encode_q1_packed(x, tuner.encoder, **kw)
    torch.cuda.synchronize()
    assert counts() == before


def test_default_artifact_on_the_card(cuda_device, tmp_path):
    """The default .pt2 exported from a tuner on the card, reloaded there,
    at two geometries against posterior_maps (stream 2: the encoder, then
    kernel A) at the maps' tolerances."""
    from qbold_vi_tpu_torch.io import export_model as em

    cfg = dataclasses.replace(tcfg.OPTIMAL.model, no_units=16)
    tuner = _tuner(cfg, cuda_device)
    path = str(tmp_path / "maps.pt2")
    em.save_exported(em.export_inference(tuner, use_first_op=False), path)
    art = em.load_exported(path)
    rng = np.random.default_rng(8)
    for shape in ((1, 9, 7, 3), (3, 20, 16, 8)):
        data = volume(rng, shape, 12)
        data[..., -1] = rng.uniform(size=shape) > 0.2
        got = art(torch.from_numpy(data).to(cuda_device))
        ref = infer.posterior_maps(tuner, data, use_first_op=False)
        g = {k: v.cpu().numpy() for k, v in got.items()}
        means = lambda d: np.concatenate([d[k] for k in  # noqa: E731
                                          ("oef", "dbv", "r2p")], -1)
        _close((means(g), g["stds"], g["raw_log_stds"]),
               (means(ref), ref["stds"], ref["raw_log_stds"]))


def test_dropout_step_through_f_and_h_matches_the_plain_route(cuda_device):
    """A fine-tune step at dropout_rate 0.1 through kernels H (fused_conv
    "on") and F against the same step through cuDNN and the plain ELBO,
    given the same masks and host normals: gradients at GRAD_TOL, H and F
    launched; softplus (a relu kink may fall either way). A pass with
    train=False ignores the rate (bit-equal to rate 0), and masks drawn
    from a seed on the card replay."""
    base = dataclasses.replace(
        tcfg.OPTIMAL, scan=SCAN,
        model=dataclasses.replace(tcfg.OPTIMAL.model, activation="softplus",
                                  dropout_rate=0.1))
    cfgs = {"on": dataclasses.replace(base, model=dataclasses.replace(
                base.model, fused_conv="on"), train=dataclasses.replace(
                base.train, fused_elbo="on")),
            "off": dataclasses.replace(base, model=dataclasses.replace(
                base.model, fused_conv="off"), train=dataclasses.replace(
                base.train, fused_elbo="off", fused_decode_nll="off"))}
    rng = np.random.default_rng(19)
    shape = (8, 25, 25, 8)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask, "mask": mask,
             "priors": (rng.normal(size=shape + (5,)) * 0.3
                        ).astype(np.float32)}
    batch = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    noise = {"z_nll": rng.normal(size=(1,) + shape + (2,)).astype(np.float32),
             "z_kl": rng.normal(size=(70,) + shape + (2,)).astype(np.float32)}
    fold = (shape[0] * shape[3], shape[1], shape[2], base.model.no_units)
    masks = [rng.uniform(size=fold) < 0.9
             for _ in range(2 * base.model.no_intermediate_layers)]
    sd = init_params(base.model, SCAN, torch.Generator().manual_seed(6))
    grads, counts = {}, {}
    for mode, cfg in cfgs.items():
        tuner = FineTuner(cfg.model, SCAN, device=cuda_device)
        tuner.load_state_dict(sd)
        opt = toptim.make_finetune_optimizer(tuner.parameters(), cfg.train)
        before = (tcv.conv3x3.bwd_launches, tfe.fused_elbo_backward.from_state)
        tsteps.make_finetune_step(tuner, cfg, opt)(batch, noise=noise,
                                                   dropout_masks=masks)
        torch.cuda.synchronize()
        counts[mode] = (tcv.conv3x3.bwd_launches - before[0],
                        tfe.fused_elbo_backward.from_state - before[1])
        grads[mode] = _grads(tuner)
    n_conv = 2 * base.model.no_intermediate_layers
    assert counts == {"on": (n_conv, 1), "off": (0, 0)}
    for k, g in grads["off"].items():
        _grad_close(grads["on"][k], g, k)

    tuner = FineTuner(cfgs["on"].model, SCAN, device=cuda_device)
    tuner.load_state_dict(sd)
    zero = FineTuner(dataclasses.replace(cfgs["on"].model, dropout_rate=0.0),
                     SCAN, device=cuda_device)
    zero.load_state_dict(sd)
    with torch.no_grad():
        for a, b in zip(tuner.encode(batch["images"]),
                        zero.encode(batch["images"])):
            assert torch.equal(a, b)
        drop = [tuner.dropout(True, seed=4) for _ in range(2)]
        h = torch.ones(fold, device=cuda_device)
        a, b = drop[0](h), drop[1](h)
        assert torch.equal(a, b) and a.device.type == "cuda"
        assert abs(float((a != 0).float().mean()) - 0.9) < 0.01


# ---- the data-parallel layer on the card ------------------------------------

def _port_of_a_free_socket():
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_one_rank_nccl_step_is_the_unsharded_step(cuda_device):
    """A world of one rank (NCCL, in this process): the sharded fine-tune
    step through kernel F, given a batch and a seed, is the unsharded
    step bit for bit (the reduction is the identity, the scale 1)."""
    import torch.distributed as dist

    from qbold_vi_tpu_torch.parallel import mesh as pmesh

    assert pmesh.initialize_distributed(
        f"localhost:{_port_of_a_free_socket()}", 1, 0,
        device="cuda") == "nccl"
    try:
        mesh = pmesh.make_mesh()
        cfg = dataclasses.replace(tcfg.OPTIMAL, model=dataclasses.replace(
            tcfg.OPTIMAL.model, no_units=8, no_intermediate_layers=1),
            scan=SCAN)
        rng = np.random.default_rng(3)
        shape = (4, 9, 9, 2)
        mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
        batch = {"images": volume(rng, shape, SCAN.n_taus) * mask,
                 "mask": mask,
                 "priors": (rng.normal(size=shape + (5,)) * 0.3
                            ).astype(np.float32)}
        batch = {k: torch.from_numpy(v).to(cuda_device)
                 for k, v in batch.items()}
        sd = init_params(cfg.model, SCAN, torch.Generator().manual_seed(2))
        out = []
        for m in (None, mesh):
            tuner = FineTuner(cfg.model, SCAN, device=cuda_device)
            tuner.load_state_dict(sd)
            opt = toptim.make_finetune_optimizer(tuner.parameters(),
                                                 cfg.train)
            b = batch if m is None else dict(
                batch, live=torch.ones(shape[0], device=cuda_device))
            f0 = tfe.fused_elbo_forward.launches
            metrics = tsteps.make_finetune_step(tuner, cfg, opt, m)(b,
                                                                    seed=9)
            assert tfe.fused_elbo_forward.launches == f0 + 1
            out.append((metrics, tuner.state_dict()))
        assert mesh.counts["step_reduce"] == 1
        for k, v in out[0][0].items():
            assert torch.equal(out[1][0][k], v), k
        for k, v in out[0][1].items():
            assert torch.equal(out[1][1][k], v), k
    finally:
        dist.destroy_process_group()


def test_two_ranks_share_the_card(cuda_device, tmp_path):
    """Two ranks on the one card (gloo on CUDA tensors): certify's
    workload through F, S, B, A and E, bit-equal across ranks and within
    rtol 2e-5 of this process alone."""
    from qbold_vi_tpu_torch.parallel import multihost

    out = multihost.certify(2, device="cuda", workdir=str(tmp_path),
                            timeout_s=600)
    assert out["ok"] and out["backend"] == "gloo"
    for counts in out["launches"]:
        for k in ("F_fwd", "F_bwd", "S", "B", "A", "E"):
            assert counts[k] > 0, (k, counts)


def test_dryrun_on_the_card(cuda_device):
    from qbold_vi_tpu_torch.parallel import dryrun

    out = dryrun.run(2, device="cuda", timeout_s=600)
    assert out["ok"] and out["step_reduces_per_step"] == 1


# ---- the sweep: kernel S's trial axis and the populations ----------------------

@pytest.mark.parametrize("case", list(S_CASES))
def test_synth_batch_trial_axis_is_bit_equal(cuda_device, case):
    """synth_batch(seeds=[...]): one launch of each pass for every trial,
    trial j bit-equal to the one-trial launch under seeds[j]."""
    from qbold_vi_tpu_torch.ops import synth_batch as tsb

    cfg = _synth_cfg(case)
    seeds = [5, 2 ** 40 + 17, 123456789]
    before = (tsb.synth_batch.launches, tsb.synth_batch.noise_launches)
    got = tsb.synth_batch(cfg, 32, seeds=seeds, device=cuda_device)
    torch.cuda.synchronize()
    noisy = int(cfg.scan.simulate_noise)
    assert (tsb.synth_batch.launches - before[0],
            tsb.synth_batch.noise_launches - before[1]) == (1, noisy)
    assert got["x"].shape == (3, 32, 10, 10, 5, 11)
    for j, s in enumerate(seeds):
        one = tsb.synth_batch(cfg, 32, s, device=cuda_device)
        for k in ("x", "y"):
            assert torch.equal(got[k][j], one[k]), (k, j)


def test_synth_batch_trial_axis_at_full_batch(cuda_device):
    """S at P = 4 trials of OPTIMAL's batch (512 volumes of 10 x 10 x 5,
    256,000 voxels a trial, a grid of pass-1 blocks at its cap): each trial
    bit-equal to its one-trial launch, the same on a second call, and the
    first within rtol / atol 1e-5 of the plain version fed its replayed
    draws."""
    from qbold_vi_tpu_torch.ops import synth_batch as tsb

    cfg = tcfg.OPTIMAL
    b, seeds = cfg.train.pt_batch_size, [11, 2 ** 40 + 3, 977, 12345]
    n = b * 500
    got = tsb.synth_batch(cfg, b, seeds=seeds, device=cuda_device)
    again = tsb.synth_batch(cfg, b, seeds=seeds, device=cuda_device)
    torch.cuda.synchronize()
    assert got["x"].shape == (4, b, 10, 10, 5, cfg.scan.n_taus)
    for k in ("x", "y"):
        assert torch.equal(got[k], again[k]), k
    for j, s in enumerate(seeds):
        one = tsb.synth_batch(cfg, b, s, device=cuda_device)
        for k in ("x", "y"):
            assert torch.equal(got[k][j], one[k]), (k, j)
    ref = tsteps.stream_synthetic_batch(
        cfg, b, tsb.synth_philox_draws(seeds[0], n, cfg.scan.n_taus),
        device=cuda_device)
    for k in ("x", "y"):
        np.testing.assert_allclose(got[k][0].cpu().numpy(),
                                   ref[k].cpu().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", list(S_CASES))
def test_synth_batch_launches_its_design_s_kernels(cuda_device, case):
    """One batch is two kernel launches on the device with noise (pass 1,
    whose last block reduces the mean, and the noise pass) and one without,
    whatever the trial count: the profiler's kernel records of a call,
    against the wrapper's counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qbold_vi_tpu_torch.ops import synth_batch as tsb

    cfg = _synth_cfg(case)
    noisy = int(cfg.scan.simulate_noise)
    for kw in (dict(seed=5), dict(seeds=[5, 6, 7, 8])):
        tsb.synth_batch(cfg, 64, device=cuda_device, **kw)
        torch.cuda.synchronize()
        before = (tsb.synth_batch.launches, tsb.synth_batch.noise_launches)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tsb.synth_batch(cfg, 64, device=cuda_device, **kw)
            torch.cuda.synchronize()
        names = [e.name.split("(")[0] for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "qv_synth" in e.name]
        assert sorted(names) == sorted(
            ["qv_synth_batch_kernel"] + ["qv_synth_noise_kernel"] * noisy)
        assert (tsb.synth_batch.launches - before[0],
                tsb.synth_batch.noise_launches - before[1]) == (1, noisy)


def _sweep_cfg(tmp_path, **train):
    """tests/test_sweep.py's population configuration with a data
    directory of 3 subjects and a study set."""
    rng = np.random.default_rng(7)
    d = tmp_path / "data"
    d.mkdir(exist_ok=True)
    vols = volume(rng, (3, 40, 30, 2), SCAN.n_taus + 1)
    vols[..., -1] = 1.0
    np.save(d / "ASE_scan.npy", vols)
    study = volume(rng, (2, 12, 12, 2), SCAN.n_taus + 2)
    study[..., -2:] = 1.0
    np.save(d / "hyperv_ase.npy", study)
    np.save(d / "baseline_ase.npy", study + 1.0)
    return tcfg.QBoldConfig(
        scan=dataclasses.replace(SCAN, simulate_noise=False),
        synth=tcfg.SynthParams(sample_size=40),
        model=tcfg.ModelConfig(no_units=4, no_intermediate_layers=1,
                               use_mvg=True, student_t_df=200.0,
                               predict_log_data=False),
        train=tcfg.TrainConfig(**dict(dict(
            no_pt_epochs=1, pt_batch_size=4, no_ft_epochs=1,
            ft_batch_size=2, ft_steps_per_epoch=3, crop_size=6,
            swa_start=1, swa_period=1, save_directory=str(tmp_path),
            data_directory=str(d)), **train)))


@pytest.mark.parametrize("p_n", [1, 3])
def test_population_step_launches_f_twice_whatever_p(cuda_device, tmp_path,
                                                      p_n):
    """A population fine-tune step launches kernel F once forward and once
    backward for all its trials, and a pretrain step kernel S once; no
    trial fails."""
    from qbold_vi_tpu_torch import sweep
    from qbold_vi_tpu_torch.ops import launch_counts

    cfg = _sweep_cfg(tmp_path)
    before = launch_counts()
    out = sweep.population_full_run(
        cfg, [{"ft_lr": 1e-3 * (j + 1)} for j in range(p_n)],
        device=cuda_device)
    torch.cuda.synchronize()
    after = launch_counts()
    steps = cfg.train.no_ft_epochs * cfg.train.ft_steps_per_epoch
    assert after["F_fwd"] - before["F_fwd"] == steps
    assert after["F_bwd"] - before["F_bwd"] == steps
    assert after["S"] - before["S"] == 1          # one pretrain step
    assert all(r["status"] == "FULL_TRAINED" for r in out)
    assert all(np.isfinite(r["val_elbo"]) for r in out)


@pytest.mark.parametrize("fused", ["host", "on"])
def test_population_matches_serial_on_the_card(cuda_device, tmp_path, fused):
    """The populations against their serial oracle on the card (kernels S
    and F, F under host noise, and under device noise, where trial i draws
    at the counters of rows i N ... whether alone or with the others): the
    pretrain at rtol 2e-4 / atol 1e-5, the full run at rtol 5e-4 / atol
    1e-5 (tests/test_sweep.py's gates)."""
    from qbold_vi_tpu_torch import sweep

    from qbold_vi_tpu_torch.ops import launch_counts

    cfg = _sweep_cfg(tmp_path, fused_elbo=fused)
    trials = [{"pt_lr": 1e-3, "ft_lr": 2e-3}, {"pt_lr": 5e-4, "ft_lr": 1e-3},
              {"pt_lr": 2e-3, "ft_lr": 5e-3, "adamw_decay": 1e-3}]
    before = launch_counts()
    for fn, tol, keys in (
            (sweep.population_pretrain, dict(rtol=2e-4, atol=1e-5),
             ("val_loss", "oef_mse", "dbv_mse", "r2p_mse", "loss")),
            (sweep.population_full_run, dict(rtol=5e-4, atol=1e-5),
             ("val_elbo", "val_nll", "val_kl", "loss", "pt_val_loss"))):
        pop = fn(cfg, trials, device=cuda_device)
        ser = fn(cfg, trials, device=cuda_device, serial=True)
        for a, b in zip(pop, ser):
            assert a.get("status") != "failed"
            for k in keys:
                np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)
        assert len({round(r["val_elbo"], 6) for r in pop}) == 3
    after = launch_counts()
    for k in ("S", "F_fwd", "F_bwd"):
        assert after[k] > before[k], k
