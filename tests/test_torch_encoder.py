"""The port's Encoder / FineTuner (models/) and weight bridge (io/from_jax)
against the flax Encoder with the same weights.

Tolerance for the encoder outputs: rtol 1e-5 / atol 2e-5 (float32
matmuls and convolutions in another summation order). The bridge and the
npz round trip are exact.

At compute_dtype="bfloat16" the port rounds where flax rounds (a Dense's
float32 sums to bf16, then the bf16 bias; nn.Conv's sums, then its bias;
jax.nn's activations step by step; the heads in float32), so each output
lies within BF16_ULPS bf16 ulps of its largest magnitude of flax's: a
float32 sum in another order (a GroupNorm's statistics, a Dense's
products) can move a bf16 rounding by one ulp, and that ulp travels on.
Under fused_conv="off" the port's library conv stands for nn.Conv; under
"interpret" kernel H's plain version for the JAX kernel in the Mosaic
interpreter. Both are well inside the JAX package's own bf16 gate for the
encoder, rtol / atol 0.05 (tests/test_model.py:132-133).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import (bf16_ulp, jax_tuner_and_params,  # noqa: E402
                                port_params, port_tuner, volume)
from qbold_vi_tpu.config import OPTIMAL, ModelConfig, ScanParams  # noqa: E402
from qbold_vi_tpu.models.vi import FineTuner as JFineTuner  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch.io import from_jax  # noqa: E402
from qbold_vi_tpu_torch.models.encoder import _dtype_of  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner, init_params  # noqa: E402

SCAN = ScanParams(simulate_noise=False)
TOL = dict(rtol=1e-5, atol=2e-5)
BF16_ULPS = 4
OPT = dataclasses.replace(OPTIMAL.model, compute_dtype="float32")


def _cfg(**kw):
    base = dict(use_mvg=True, no_units=16, no_intermediate_layers=2,
                gate_offset=-1.0, resid_init_std=0.2,
                compute_dtype="float32")
    return ModelConfig(**{**base, **kw})


ENCODER_CASES = [
    ("plain", _cfg()),
    ("layer_norm", _cfg(use_layer_norm=True, activation="gelu")),
    ("inv_gamma-scalar_gate", _cfg(infer_inv_gamma=True,
                                   channelwise_gating=False,
                                   use_mvg=False, activation="elu")),
    ("layer_norm-inv_gamma", _cfg(use_layer_norm=True, infer_inv_gamma=True,
                                  multi_image_normalisation=True)),
]


def _compare(cfg, params, images):
    ref = JFineTuner(cfg, SCAN).encode(params, jnp.asarray(images))
    tuner = port_tuner(cfg, SCAN, params)
    with torch.no_grad():
        got = tuner.encode(torch.from_numpy(images))
        s1 = tuner.encoder.stream1(torch.from_numpy(images))
    for name, g, r in zip(("stream1", "stream2", "sigma"), got, ref):
        assert g.shape == r.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)
    # stream 1 alone (the unfused serving path) is forward's first output
    np.testing.assert_allclose(s1.numpy(), got[0].numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("name,cfg", ENCODER_CASES,
                         ids=[c[0] for c in ENCODER_CASES])
def test_encoder_matches_flax(name, cfg):
    rng = np.random.default_rng(0)
    images = volume(rng, (2, 5, 6, 3), SCAN.n_taus)
    _, params = port_params(cfg, SCAN, seed=1)
    _compare(cfg, params, images)


def test_optimal_encoder_from_flax_init():
    """A params tree made by flax itself (OPTIMAL widths) crosses the
    bridge and gives the same three outputs."""
    rng = np.random.default_rng(1)
    images = volume(rng, (1, 6, 5, 2), SCAN.n_taus)
    _, params = jax_tuner_and_params(OPT, SCAN, jnp.asarray(images), seed=3)
    _compare(OPT, jax.tree_util.tree_map(np.asarray, params), images)


@pytest.mark.parametrize("cfg", [OPT, ENCODER_CASES[3][1]],
                         ids=["optimal", "layer_norm-inv_gamma"])
def test_bridge_round_trip_is_exact(tmp_path, cfg):
    images = jnp.ones((1, 4, 4, 2, SCAN.n_taus))
    _, params = jax_tuner_and_params(cfg, SCAN, images, seed=2)
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = from_jax.state_dict_from_jax(tree)
    back = from_jax.jax_from_state_dict(sd)
    flat, flat_back = (from_jax.flatten_params(t) for t in (tree, back))
    assert flat.keys() == flat_back.keys()
    for k in flat:
        np.testing.assert_array_equal(flat_back[k], flat[k], err_msg=k)
    path = str(tmp_path / "w.npz")
    from_jax.save_params_npz(tree, path)
    loaded = from_jax.flatten_params(from_jax.load_params_npz(path))
    for k in flat:
        np.testing.assert_array_equal(loaded[k], flat[k], err_msg=k)
    # the state_dict loads into the port's module without missing keys
    tuner = FineTuner(tcfg.ModelConfig(**dataclasses.asdict(cfg)),
                      tcfg.ScanParams(**dataclasses.asdict(SCAN)),
                      device="cpu")
    tuner.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("cfg", [
    OPT,
    dataclasses.replace(OPT, use_layer_norm=True, infer_inv_gamma=True,
                        use_population_prior=True,
                        heteroscedastic_noise=False, use_mvg=False),
], ids=["optimal", "all-extras"])
def test_init_params_tree_and_distributions(cfg):
    """init_params gives the flax tree's names and shapes, and flax's
    initialiser distributions (not its numbers)."""
    _, jparams = jax_tuner_and_params(
        cfg, SCAN, jnp.ones((1, 4, 4, 2, SCAN.n_taus)))
    ref = from_jax.flatten_params(jax.tree_util.tree_map(np.asarray,
                                                         jparams))
    tc = tcfg.ModelConfig(**dataclasses.asdict(cfg))
    ts = tcfg.ScanParams(**dataclasses.asdict(SCAN))
    sd = init_params(tc, ts, torch.Generator().manual_seed(0))
    got = from_jax.flatten_params(from_jax.jax_from_state_dict(sd))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    u = cfg.no_units
    w = got["encoder/block_0/Dense_0/kernel"]
    assert abs(w.std() - np.sqrt(2.0 / u)) < 0.15 * np.sqrt(2.0 / u)
    assert np.abs(w).max() <= 2 * np.sqrt(2.0 / u) / 0.8796256610342398
    conv = got["encoder/block_0/ConvXY_0/Conv_0/kernel"]
    assert abs(conv.std() - cfg.resid_init_std) < 0.1 * cfg.resid_init_std
    np.testing.assert_allclose(got["encoder/sigma_head/bias"],
                               np.log(cfg.im_loss_sigma), rtol=1e-6)
    for k in ref:
        if k.endswith("bias") and "sigma_head" not in k:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("encoder/inv_gamma_raw", "pop_prior", "log_sigma"):
        if k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)
    # the same generator seed gives the same weights
    again = init_params(tc, ts, torch.Generator().manual_seed(0))
    for k in sd:
        assert torch.equal(sd[k], again[k]), k


def test_dist_transforms_and_prior_match_jax():
    from qbold_vi_tpu.dist.logit_mvn import LogitMVN as JLogitMVN

    rng = np.random.default_rng(3)
    raw = rng.normal(size=(50, 2)).astype(np.float32) * 3.0
    cfg = dataclasses.replace(OPT, use_population_prior=True)
    tc = tcfg.ModelConfig(**dataclasses.asdict(cfg))
    tuner = FineTuner(tc, tcfg.ScanParams(**dataclasses.asdict(SCAN)),
                      device="cpu")
    tuner.load_state_dict(init_params(tc, tuner.scan,
                                      torch.Generator().manual_seed(0)))
    jd, td = JLogitMVN(), tuner.dist
    t = torch.from_numpy(raw)
    for name in ("transform_std", "transform_offdiag", "forward_transform"):
        np.testing.assert_allclose(getattr(td, name)(t).numpy(),
                                   np.asarray(getattr(jd, name)(raw)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    q = torch.zeros((2, 3, 5))
    prior = tuner.prior_params(q)
    assert prior.shape == (2, 3, 5)
    np.testing.assert_allclose(prior[1, 2].detach().numpy(),
                               [-0.97, 0.4, -1.14, 0.6, 0.0])


def test_compute_dtype_resolution():
    """"auto" (the default) and "float32" resolve to float32, as the JAX
    package resolves "auto" off the TPU; "bfloat16" to bf16; anything else
    raises (the JAX package's tests/test_model.py:135-150)."""
    assert _dtype_of(tcfg.ModelConfig()) is torch.float32
    assert _dtype_of(tcfg.ModelConfig(compute_dtype="auto")) is torch.float32
    assert _dtype_of(tcfg.ModelConfig(compute_dtype="float32")) \
        is torch.float32
    assert _dtype_of(tcfg.ModelConfig(compute_dtype="bfloat16")) \
        is torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        _dtype_of(tcfg.ModelConfig(compute_dtype="fp16"))
    with pytest.raises(ValueError, match="compute_dtype"):
        FineTuner(tcfg.ModelConfig(no_units=4, compute_dtype="fp16"),
                  tcfg.ScanParams(), device="cpu")


def _cfg16(**kw):
    return _cfg(**{"compute_dtype": "bfloat16", **kw})


BF16_CASES = [
    ("mvg-relu-off", _cfg16()),
    ("diag-softplus-layer_norm-off", _cfg16(use_mvg=False,
                                            activation="softplus",
                                            use_layer_norm=True)),
    ("mvg-softplus-interpret", _cfg16(activation="softplus", no_units=8,
                                      no_intermediate_layers=1,
                                      fused_conv="interpret")),
    ("diag-relu-layer_norm-interpret", _cfg16(use_mvg=False, no_units=8,
                                              no_intermediate_layers=1,
                                              use_layer_norm=True,
                                              fused_conv="interpret")),
]


@pytest.mark.parametrize("name,cfg", BF16_CASES,
                         ids=[c[0] for c in BF16_CASES])
def test_bf16_encoder_matches_flax(name, cfg):
    rng = np.random.default_rng(0)
    images = volume(rng, (2, 6, 7, 3), SCAN.n_taus)
    _, params = port_params(cfg, SCAN, seed=1)
    ref = JFineTuner(cfg, SCAN).encode(params, jnp.asarray(images))
    tuner = port_tuner(cfg, SCAN, params)
    x = torch.from_numpy(images)
    with torch.no_grad():
        got = tuner.encode(x)
        s1 = tuner.encoder.stream1(x)
        f32 = port_tuner(dataclasses.replace(cfg, compute_dtype="float32"),
                         SCAN, params).encode(x)
    for key, g, r, g32 in zip(("stream1", "stream2", "sigma"), got, ref,
                              f32):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape, key
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=BF16_ULPS * bf16_ulp(r), err_msg=key)
        assert (g != g32).any(), key        # the trunk ran in bf16
    np.testing.assert_array_equal(s1.numpy(), got[0].numpy())


def test_forward_leaves_tf32_settings_as_found():
    """The encoder turns TF32 off only while it runs."""
    cfg = tcfg.ModelConfig(no_units=8)
    tuner = FineTuner(cfg, tcfg.ScanParams(), device="cpu")
    tuner.load_state_dict(init_params(cfg, tcfg.ScanParams(),
                                      torch.Generator().manual_seed(0)))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            tuner.encode(torch.ones((1, 3, 3, 2, 11)))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
