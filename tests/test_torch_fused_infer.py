"""The port's fused stream-1 encode + quadrature (ops/fused_infer.py,
kernel B's plain version and wrapper) against the JAX package's Pallas
kernel, run by the Mosaic interpreter (the way the JAX package's own
CPU tests run it), with the same bridged weights and numpy inputs.

Tolerances: q and raw rtol 1e-5 / atol 2e-5 (the same float32 chain in
another summation order); means rtol 1e-4 / atol 3e-5; variances
rtol 1e-3 / atol 3e-5, since E[x^2] - E[x]^2 cancels -- for R2' at
dw ~ 300 with an absolute floor of 16 float32 ulps of its second moment
(torch_parity_utils.assert_vars_close).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import (assert_vars_close, port_params,  # noqa: E402
                                port_tuner, volume)
from qbold_vi_tpu.config import OPTIMAL, ModelConfig, ScanParams  # noqa: E402
from qbold_vi_tpu.infer import _encode_q  # noqa: E402
from qbold_vi_tpu.ops import pallas_infer as jpi  # noqa: E402
from qbold_vi_tpu_torch.ops import fused_infer as tfi  # noqa: E402

SCAN = ScanParams(simulate_noise=False)
Q_TOL = dict(rtol=1e-5, atol=2e-5)
MEAN_TOL = dict(rtol=1e-4, atol=3e-5)
VAR_TOL = dict(rtol=1e-3, atol=3e-5)


def _ranges(cfg, scan):
    return dict(mvg=cfg.use_mvg, oef_range=cfg.oef_range,
                min_oef=cfg.min_oef, dbv_range=cfg.dbv_range,
                min_dbv=cfg.min_dbv,
                dw_coeff=float(scan.dw_coeff * scan.hct))


def _enc_kw(cfg, scan):
    return dict(se_idx=scan.se_idx, multi_image=cfg.multi_image_normalisation,
                activation=cfg.activation,
                n_blocks=cfg.no_intermediate_layers, trunk="float32")


def _run(cfg, scan, vol_shape, seed, *, mask_channel, layout):
    """JAX's kernel (interpreted) and the port's wrapper on one input.
    Returns (jax (3, N) triple, port (3, N) triple, extras)."""
    rng = np.random.default_rng(seed)
    images = volume(rng, vol_shape, scan.n_taus)
    jt, params = port_params(cfg, scan, seed)
    x = images
    if mask_channel:
        mask = (rng.uniform(size=vol_shape + (1,)) > 0.3).astype(np.float32)
        x = np.concatenate([images, mask], -1)
    if layout == "channel":
        x = np.ascontiguousarray(x.reshape(-1, x.shape[-1]).T)
    n = int(np.prod(vol_shape))
    kw = dict(**_enc_kw(cfg, scan), **_ranges(cfg, scan),
              mask_channel=mask_channel, input_layout=layout)
    ref = jpi.encode_quad_fused(jnp.asarray(x), params["encoder"], rows=64,
                                interpret=True, **kw)
    ref = [np.asarray(a)[:, :n] for a in ref]
    tuner = port_tuner(cfg, scan, params)
    got = tfi.encode_quad_fused(torch.from_numpy(x), tuner.encoder, **kw)
    return ref, [a.numpy() for a in got], (jt, params, tuner, images)


SCAN24 = ScanParams(tau_start=-0.028, tau_end=0.065, tau_step=0.004,
                    simulate_noise=False)
SCAN_SE0 = ScanParams(tau_start=0.0, simulate_noise=False)
OPT = dataclasses.replace(OPTIMAL.model, compute_dtype="float32")


def _small(act, **kw):
    base = dict(use_mvg=True, activation=act, no_units=16,
                no_intermediate_layers=2, multi_image_normalisation=False,
                compute_dtype="float32")
    return ModelConfig(**{**base, **kw})


# One case per activation; the published OPTIMAL shape in both layouts;
# masks, ragged N (105 voxels over 64-row tiles), diagonal heads, the
# 24-tau protocol and the se_idx = 0 grid edge folded into the others.
CASES = [
    ("relu-optimal-channel", OPT, SCAN, "channel", True),
    ("relu-optimal-voxel", OPT, SCAN, "voxel", True),
    ("gelu-24tau", _small("gelu", multi_image_normalisation=True), SCAN24,
     "voxel", True),
    ("tanh-diag", _small("tanh", use_mvg=False), SCAN, "channel", False),
    ("sigmoid", _small("sigmoid"), SCAN, "voxel", False),
    ("softplus", _small("softplus", no_units=13), SCAN, "channel", True),
    ("elu-se0", _small("elu", multi_image_normalisation=True), SCAN_SE0,
     "channel", True),
    ("silu", _small("silu", no_intermediate_layers=1), SCAN, "voxel", True),
    ("swish", _small("swish"), SCAN, "voxel", False),
    ("leaky_relu", _small("leaky_relu", no_intermediate_layers=3), SCAN,
     "channel", False),
    ("relu6-diag", _small("relu6", use_mvg=False), SCAN, "voxel", True),
    ("linear", _small("linear"), SCAN, "channel", True),
]


def test_cases_cover_every_activation():
    assert ({c[1].activation for c in CASES} == set(tfi.SUPPORTED_ACTS))


@pytest.mark.parametrize("name,cfg,scan,layout,mask", CASES,
                         ids=[c[0] for c in CASES])
def test_matches_jax_kernel(name, cfg, scan, layout, mask):
    ref, got, (jt, params, tuner, images) = _run(
        cfg, scan, (1, 7, 5, 3), 1, mask_channel=mask, layout=layout)
    np.testing.assert_allclose(got[0], ref[0], err_msg="means", **MEAN_TOL)
    assert_vars_close(got[1].T, ref[1].T, ref[0].T, **VAR_TOL)
    np.testing.assert_allclose(got[2], ref[2], err_msg="raw", **Q_TOL)
    # the encode half alone: q against the flax encoder's stream 1
    q_ref, _ = _encode_q(jt, params, jnp.asarray(images))
    q = tfi.encode_q_plain(torch.from_numpy(images), tuner.encoder,
                           **_enc_kw(cfg, scan))
    k = q_ref.shape[-1]
    np.testing.assert_allclose(q.numpy()[:k].T,
                               np.asarray(q_ref).reshape(-1, k), **Q_TOL)
    if k == 4:
        assert (q.numpy()[4] == 0).all()


def test_masked_voxels_are_neutral():
    """A masked voxel clips to 1e-2 everywhere: log-ratio 0, so its
    summaries are those of the all-zero normalised input."""
    cfg = ModelConfig(use_mvg=True, no_units=8, compute_dtype="float32")
    scan = SCAN
    rng = np.random.default_rng(6)
    images = volume(rng, (1, 4, 4, 1), scan.n_taus)
    _, params = port_params(cfg, scan)
    tuner = port_tuner(cfg, scan, params)
    x = np.concatenate([images, np.zeros(images.shape[:-1] + (1,),
                                         np.float32)], -1)
    kw = dict(**_enc_kw(cfg, scan), **_ranges(cfg, scan))
    m, _, _ = tfi.encode_quad_fused(torch.from_numpy(x), tuner.encoder,
                                    mask_channel=True, **kw)
    m0, _, _ = tfi.encode_quad_fused(
        torch.ones((1, scan.n_taus)), tuner.encoder, **kw)
    torch.testing.assert_close(m, m0.expand_as(m), rtol=0, atol=0)


def test_wrapper_rejects_what_it_does_not_take():
    cfg = ModelConfig(use_mvg=True, no_units=8, compute_dtype="float32")
    _, params = port_params(cfg, SCAN)
    enc = port_tuner(cfg, SCAN, params).encoder
    kw = dict(**_enc_kw(cfg, SCAN), **_ranges(cfg, SCAN))
    x = torch.ones((10, SCAN.n_taus))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfi.encode_quad_fused(x, enc, **dict(kw, trunk="bfloat16"))
    with pytest.raises(ValueError, match="input_layout"):
        tfi.encode_quad_fused(x, enc, input_layout="rows", **kw)
    with pytest.raises(ValueError, match="tau channels"):
        tfi.encode_quad_fused(torch.ones((10, 5)), enc, **kw)
    before = tfi.encode_quad_fused.launches
    tfi.encode_quad_fused(x, enc, **kw)
    assert tfi.encode_quad_fused.launches == before    # plain on the CPU
