"""The port's legacy Keras ``.h5`` import (io/keras_import.py) and its
tau-protocol transfer (models/transfer.py) against the JAX package's.

The test writes the Keras-2 ``save_weights`` layouts itself with h5py --
each Conv3D its own layer group, and the reference's final_model.h5 form
with the encoder nested under one group plus VariableLayer extras -- so it
needs no reference checkout and no TensorFlow. The imported state_dict
must equal the JAX importer's params through the weight bridge exactly.
The transferred weights keep the trunk's tensors bit for bit, and through
the bridge give the JAX FineTuner's encoder outputs on the new tau grid at
rtol / atol 1e-5 (the encoder gate of tests/test_torch_encoder.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import (legacy_kernels, port_params,  # noqa: E402
                                write_legacy_h5)
from qbold_vi_tpu.config import ModelConfig, ScanParams  # noqa: E402
from qbold_vi_tpu.io import keras_import as jki  # noqa: E402
from qbold_vi_tpu.models.vi import FineTuner as JFineTuner  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch.io import keras_import as tki  # noqa: E402
from qbold_vi_tpu_torch.io.from_jax import (jax_from_state_dict,  # noqa: E402
                                            state_dict_from_jax)
from qbold_vi_tpu_torch.models.transfer import transfer_params  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner  # noqa: E402

SCAN = ScanParams(simulate_noise=False)
CFG = ModelConfig(no_units=8, no_intermediate_layers=3, use_mvg=True,
                  gate_offset=-3.0, multi_image_normalisation=False,
                  student_t_df=200.0, predict_log_data=False)
POP = np.asarray([-0.9, 0.3, -1.2, 0.5, 0.05], np.float32)
LOG_SIGMA = np.asarray([np.log(0.07)], np.float32)


def _port(dc):
    return getattr(tcfg, type(dc).__name__)(**dataclasses.asdict(dc))


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("nested,extras", [
    (False, False), (True, False), (True, True)])
def test_legacy_h5_matches_jax(tmp_path, nested, extras):
    """The flat layout, the nested final_model.h5 layout, and the latter
    with a population prior and a trainable sigma under a config that asks
    for them (and one that does not, where they are left out)."""
    path = str(tmp_path / "weights.h5")
    convs = legacy_kernels(np.random.default_rng(3), CFG, SCAN.n_taus)
    write_legacy_h5(path, convs, nested,
                    extras=(POP, LOG_SIGMA) if extras else ())
    cfgs = [CFG]
    if extras:
        cfgs.append(dataclasses.replace(CFG, use_population_prior=True,
                                        heteroscedastic_noise=False))
    for cfg in cfgs:
        want = state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, jki.params_from_legacy_h5(path, cfg)))
        got = tki.load_reference_h5(path, _port(cfg))
        _assert_same(got, want)
        tuner = FineTuner(_port(cfg), _port(SCAN), device="cpu")
        tuner.load_state_dict(got)       # every parameter, strictly
    if extras:
        np.testing.assert_array_equal(got["pop_prior"].numpy(), POP)
        assert float(got["log_sigma"]) == float(LOG_SIGMA[0])


def test_a_failed_parse_raises_without_a_keras_route(tmp_path):
    path = str(tmp_path / "short.h5")
    convs = legacy_kernels(np.random.default_rng(1), CFG, SCAN.n_taus)
    write_legacy_h5(path, convs[:-1], nested=False)
    with pytest.raises(ValueError, match="Keras route"):
        tki.load_reference_h5(path, _port(CFG))
    with pytest.raises(ValueError, match="Conv3D"):
        tki.params_from_legacy_h5(path, _port(CFG))


@pytest.mark.parametrize("pop_prior", [False, True])
def test_transfer_keeps_the_trunk_and_matches_jax(pop_prior):
    """An 11-tau model retargeted to a 20-tau grid: the trunk's tensors are
    the trained ones (the same objects), first_conv and sigma_head are
    fresh and shaped for the new grid, pop_prior / log_sigma come along or
    are added where the config asks for them and the weights lack them;
    the result drives the JAX FineTuner's encoder on the new grid as it
    drives the port's."""
    cfg = dataclasses.replace(CFG, no_intermediate_layers=2)
    _, trained_tree = port_params(cfg, SCAN, seed=2)
    trained = state_dict_from_jax(trained_tree)
    new_scan = dataclasses.replace(SCAN, tau_start=-0.016, tau_step=0.004,
                                   tau_end=0.064)
    assert new_scan.n_taus == 20
    tcfg_model = _port(cfg)
    if pop_prior:
        tcfg_model = dataclasses.replace(tcfg_model, use_population_prior=True,
                                         heteroscedastic_noise=False)
    sample = np.zeros((1, 4, 4, 2, new_scan.n_taus), np.float32)
    out = transfer_params(torch.Generator().manual_seed(5), trained,
                          tcfg_model, _port(new_scan), sample)
    for name, t in out.items():
        layer = name.split(".")[1] if name.startswith("encoder.") else None
        if layer not in ("first_conv", "sigma_head") and name in trained:
            assert t is trained[name], name
    assert out["encoder.first_conv.weight"].shape == (8, 20)
    assert out["encoder.sigma_head.weight"].shape == (20, 8)
    assert ("pop_prior" in out) == ("log_sigma" in out) == pop_prior
    with pytest.raises(ValueError, match="taus"):
        transfer_params(torch.Generator(), trained, tcfg_model,
                        _port(new_scan), sample[..., :11])

    jcfg = dataclasses.replace(cfg, use_population_prior=pop_prior,
                               heteroscedastic_noise=not pop_prior)
    rng = np.random.default_rng(4)
    images = (np.abs(rng.normal(size=(2, 6, 5, 2, 20))) * 50 + 100
              ).astype(np.float32)
    ref = JFineTuner(jcfg, new_scan).encode(
        jax.tree_util.tree_map(jnp.asarray, jax_from_state_dict(out)),
        jnp.asarray(images))
    tuner = FineTuner(tcfg_model, _port(new_scan), device="cpu")
    tuner.load_state_dict(out)
    with torch.no_grad():
        got = tuner.encode(torch.from_numpy(images))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
