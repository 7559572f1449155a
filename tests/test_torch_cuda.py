"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one (marker
``cuda``). This file imports no jax, so it runs on the machine with the
card, where jax is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: means and raw rtol 1e-4 / atol 3e-5; variances rtol 1e-3 /
atol 3e-5, with the R2' floor of torch_parity_utils.assert_vars_close.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity_utils import (assert_vars_close, cuda_device,  # noqa: E402,F401
                                raw_head, volume)
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch import infer  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner, init_params  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_infer as tfi  # noqa: E402
from qbold_vi_tpu_torch.ops import quadrature as tq  # noqa: E402

pytestmark = pytest.mark.cuda

SCAN = tcfg.ScanParams(simulate_noise=False)
MEAN_TOL = dict(rtol=1e-4, atol=3e-5)
VAR_TOL = dict(rtol=1e-3, atol=3e-5)
DW = float(SCAN.dw_coeff * SCAN.hct)
RANGES = dict(oef_range=0.8, min_oef=0.04, dbv_range=0.2, min_dbv=0.001,
              dw_coeff=DW)


def _tuner(cfg, device):
    tuner = FineTuner(cfg, SCAN, device=device)
    tuner.load_state_dict(init_params(cfg, SCAN,
                                      torch.Generator().manual_seed(0)))
    return tuner


def _close(got, ref):
    """(means, vars[, raw]) channel-last numpy triples."""
    np.testing.assert_allclose(got[0], ref[0], err_msg="means", **MEAN_TOL)
    assert_vars_close(got[1], ref[1], ref[0], **VAR_TOL)
    if len(got) > 2:
        np.testing.assert_allclose(got[2], ref[2], err_msg="raw", **MEAN_TOL)


@pytest.mark.parametrize("mvg", [True, False])
def test_quadrature_kernel_matches_plain(cuda_device, mvg):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(raw_head(rng, 100_003)).to(cuda_device)
    before = tq.quad_posterior_summaries.launches
    got = tq.quad_posterior_summaries(q, mvg=mvg, **RANGES)
    torch.cuda.synchronize()
    assert tq.quad_posterior_summaries.launches == before + 1
    ref = tq.posterior_summaries_quadrature(q, mvg=mvg, **RANGES)
    _close([a.cpu().numpy() for a in got], [a.cpu().numpy() for a in ref])


@pytest.mark.parametrize("layout", ["voxel", "channel"])
@pytest.mark.parametrize("act,units,mvg,multi", [
    ("relu", 60, True, False),          # OPTIMAL
    ("gelu", 30, False, True),
    ("softplus", 13, True, False),      # width not a multiple of 4
])
def test_fused_kernel_matches_plain(cuda_device, layout, act, units, mvg,
                                    multi):
    cfg = dataclasses.replace(tcfg.OPTIMAL.model, activation=act,
                              no_units=units, use_mvg=mvg,
                              multi_image_normalisation=multi)
    tuner = _tuner(cfg, cuda_device)
    rng = np.random.default_rng(7)
    x = volume(rng, (50_001,), SCAN.n_taus + 1)
    x[:, -1] = rng.uniform(size=50_001) > 0.2
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


def test_fused_kernel_raises_for_bf16_trunk(cuda_device):
    tuner = _tuner(tcfg.ModelConfig(no_units=8), cuda_device)
    x = torch.ones((10, SCAN.n_taus), device=cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfi.encode_quad_fused(
            x, tuner.encoder, se_idx=SCAN.se_idx, multi_image=False,
            activation="relu", n_blocks=1, trunk="bfloat16", mvg=False,
            **RANGES)


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
