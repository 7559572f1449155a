"""The slice end to end: the port's posterior_maps / save_predictions
(infer.py) against the JAX package's posterior_maps on the same weights
and cohort, for both encoder streams and both fused_infer settings.

Tolerance: rtol 1e-3 / atol 3e-5, the JAX package's own gate between its
fused and plain paths (tests/test_pallas_infer.py); the R2' variance
map with the absolute floor of torch_parity_utils.assert_vars_close.
At compute_dtype="bfloat16" (OPTIMAL's relu) each map within BF16_ULPS
bf16 ulps of its largest magnitude: the port's trunk rounds where flax's
does, but a float32 sum in another order can move one activation's bf16
rounding by an ulp, and the maps carry it.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from torch_parity_utils import (assert_vars_close, bf16_ulp,  # noqa: E402
                                port_params, port_tuner)
from qbold_vi_tpu import infer as jinfer  # noqa: E402
from qbold_vi_tpu.config import OPTIMAL, ScanParams  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch import infer as tinfer  # noqa: E402
from qbold_vi_tpu_torch.io import nifti  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner, init_params  # noqa: E402

SCAN = ScanParams(simulate_noise=False)
CFG = dataclasses.replace(OPTIMAL.model, compute_dtype="float32")
TOL = dict(rtol=1e-3, atol=3e-5)
BF16_ULPS = 4
MAPS = ("oef", "dbv", "r2p", "stds", "raw_log_stds")


def _cohort(seed=0, shape=(3, 8, 8, 2)):
    rng = np.random.default_rng(seed)
    data = (np.abs(rng.normal(size=shape + (SCAN.n_taus + 1,)))
            .astype(np.float32) * 50.0 + 100.0)
    data[..., -1] = rng.uniform(size=shape) > 0.3
    return data


@pytest.fixture(scope="module")
def slice_setup():
    data = _cohort()
    jt, params = port_params(CFG, SCAN, seed=4)
    refs = {first: jinfer.posterior_maps(
                jt, params, data, jax.random.PRNGKey(0), use_pallas=False,
                chunk=2, use_first_op=first)
            for first in (True, False)}
    return data, params, refs


def _port(params, fused: str):
    cfg = dataclasses.replace(CFG, fused_infer=fused)
    return port_tuner(cfg, SCAN, params)


def _assert_maps(got, ref):
    for key in MAPS:
        assert got[key].shape == ref[key].shape, key
    for key in ("oef", "dbv", "r2p", "raw_log_stds"):
        np.testing.assert_allclose(got[key], ref[key], err_msg=key, **TOL)
    means = np.concatenate([ref["oef"], ref["dbv"], ref["r2p"]], -1)
    assert_vars_close(got["stds"], ref["stds"], means, **TOL)


@pytest.mark.parametrize("use_first_op", [True, False],
                         ids=["stream1", "stream2"])
@pytest.mark.parametrize("fused", ["on", "off"])
def test_posterior_maps_match_jax(slice_setup, use_first_op, fused):
    data, params, refs = slice_setup
    tuner = _port(params, fused)
    got = tinfer.posterior_maps(tuner, data, use_first_op=use_first_op,
                                chunk=2)
    _assert_maps(got, refs[use_first_op])


@pytest.mark.parametrize("use_first_op,fused", [(True, "on"), (True, "off"),
                                                (False, "off")],
                         ids=["stream1-fused", "stream1", "stream2"])
def test_bf16_posterior_maps_match_jax(use_first_op, fused):
    cfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    data = _cohort(1)
    jt, params = port_params(cfg, SCAN, seed=5)
    ref = jinfer.posterior_maps(jt, params, data, jax.random.PRNGKey(0),
                                use_pallas=False, chunk=2,
                                use_first_op=use_first_op)
    tuner = port_tuner(dataclasses.replace(cfg, fused_infer=fused), SCAN,
                       params)
    assert tuner.encoder.dtype == torch.bfloat16
    got = tinfer.posterior_maps(tuner, data, use_first_op=use_first_op,
                                chunk=2)
    for key in MAPS:
        r = ref[key]
        assert got[key].shape == r.shape, key
        np.testing.assert_allclose(got[key], r, rtol=0,
                                   atol=BF16_ULPS * bf16_ulp(r), err_msg=key)


def test_save_predictions_writes_what_it_returns(slice_setup, tmp_path):
    data, params, refs = slice_setup
    tuner = _port(params, "on")
    prefix = str(tmp_path / "out" / "maps")
    maps = tinfer.save_predictions(tuner, tcfg.OPTIMAL, data, prefix)
    _assert_maps(maps, refs[True])
    for key, suffix in (("oef", "_oef"), ("dbv", "_dbv"), ("r2p", "_r2p"),
                        ("stds", "_logstds"),
                        ("raw_log_stds", "_raw_logstds")):
        path = prefix + suffix + ".nii.gz"
        assert os.path.isfile(path), path
        back = nifti.load_nifti(path)
        # subjects are folded into the last axis (reference layout)
        m = maps[key]
        folded = np.concatenate(np.split(m, m.shape[0], 0), -1)[0]
        np.testing.assert_array_equal(back, folded, err_msg=key)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(transform_directory="/nonexistent"),
    dict(method="mc", fine_tuned=True),
    dict(method="mc", fine_tuned=True, transform_directory="/nonexistent"),
])
def test_unported_options_raise(tmp_path, kw):
    """``mesh=``, refused until the sharded export was ported, now routes
    to posterior_maps_sharded / elbo_maps_sharded: on a one-rank mesh
    (no process group) the maps and files are those of the unsharded
    export, bit for bit (tests/test_torch_parallel.py holds 2 and 3
    ranks)."""
    from qbold_vi_tpu_torch.parallel import make_mesh

    cfg = tcfg.ModelConfig(no_units=8)
    tuner = FineTuner(cfg, tcfg.ScanParams(), device="cpu")
    tuner.load_state_dict(init_params(cfg, tcfg.ScanParams(),
                                      torch.Generator().manual_seed(0)))
    data, qcfg = _cohort(1, (3, 2, 2, 1)), tcfg.QBoldConfig(model=cfg)
    got = tinfer.save_predictions(tuner, qcfg, data,
                                  str(tmp_path / "a" / "m"),
                                  mesh=make_mesh("cpu"), **kw)
    ref = tinfer.save_predictions(tuner, qcfg, data,
                                  str(tmp_path / "b" / "m"), **kw)
    assert set(got) == set(ref)
    for key, v in ref.items():
        np.testing.assert_array_equal(got[key], v, err_msg=key)
    assert sorted(os.listdir(tmp_path / "a")) == \
        sorted(os.listdir(tmp_path / "b"))


def test_method_and_mode_validation():
    with pytest.raises(ValueError, match="quadrature"):
        tinfer._check_method("quad")
    cfg = tcfg.OPTIMAL.model
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tinfer._resolve_fused_infer(cfg, cpu) is False      # auto
    assert tinfer._resolve_fused_infer(cfg, cuda) is True
    for mode, want in (("on", True), ("interpret", True), ("off", False)):
        c = dataclasses.replace(cfg, fused_infer=mode)
        assert tinfer._resolve_fused_infer(c, cpu) is want, mode
    with pytest.raises(ValueError, match="fused_infer"):
        tinfer._resolve_fused_infer(
            dataclasses.replace(cfg, fused_infer="maybe"), cpu)
    with pytest.raises(ValueError, match="SUPPORTED_ACTS"):
        tinfer._resolve_fused_infer(dataclasses.replace(
            cfg, fused_infer="on", activation="selu"), cpu)
    assert not tinfer._resolve_fused_infer(
        dataclasses.replace(cfg, activation="selu"), cuda)


def test_auto_fused_infer_follows_the_kernel_width():
    """"auto" turns stream 1's fused kernel on at every width and depth on
    a CUDA device, as the JAX "auto" does (kernels B and C stream the
    weights where the resident blob does not fit): 100 and 128 units x 2
    blocks, past 128 units, 60 x 7; a forced "on" too."""
    cuda = torch.device("cuda")
    cfg = tcfg.OPTIMAL.model
    for units, nb in ((60, 2), (100, 2), (128, 2), (129, 2), (256, 2),
                      (520, 1), (1024, 2), (60, 7)):
        c = dataclasses.replace(cfg, no_units=units,
                                no_intermediate_layers=nb)
        assert tinfer._resolve_fused_infer(c, cuda) is True, (units, nb)
    wide = dataclasses.replace(cfg, no_units=256, fused_infer="on")
    assert tinfer._resolve_fused_infer(wide, cuda) is True


def test_to_channel_major():
    x = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
    cm = tinfer.to_channel_major(x)
    assert cm.flags.c_contiguous and cm.shape == (4, 6)
    np.testing.assert_array_equal(cm, x.reshape(-1, 4).T)
