"""Dropout in training: the port's fine-tune and pretrain steps at
dropout_rate 0.1 against the JAX package's, given the masks the JAX run
drew.

flax folds the dropout key through its module scopes (``make_rng``), which
torch cannot replay, so the JAX run records its masks: an interceptor on
``nn.Dropout.__call__`` draws the mask from the module's own ``make_rng``
with flax's ``bernoulli`` and passes that key on to flax, so the JAX
forward is unchanged; the port takes the masks as ``dropout_masks``, as
``noise`` injects the normals.

Tolerances: the fine-tune loss at rtol 1e-5 and the gradients, each
scaled by the reference's largest entry, at rtol 5e-4 / atol 5e-5 (the
JAX package's fused-vs-plain gate, tests/test_pallas_elbo.py:88-97); at
bf16 the loss at rtol 1e-4 and the gradients by
``torch_parity_utils.assert_bf16_grads_close`` (test_torch_train.py's
bf16 step gate). The pretrain loss and gradients at the same float32
tolerances.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import flax.linen as fnn  # noqa: E402

from torch_parity_utils import (assert_bf16_grads_close,  # noqa: E402
                                port_params, port_tuner)
from qbold_vi_tpu.config import (ModelConfig, QBoldConfig,  # noqa: E402
                                 ScanParams, TrainConfig)
from qbold_vi_tpu.train.steps import (_finetune_terms,  # noqa: E402
                                      _pretrain_loss)
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch.io import from_jax  # noqa: E402
from qbold_vi_tpu_torch.models.encoder import Dropout  # noqa: E402
from qbold_vi_tpu_torch.train import steps as tsteps  # noqa: E402
from qbold_vi_tpu_torch.train.trainer import Trainer  # noqa: E402

SCAN = ScanParams(simulate_noise=False)
MODEL = ModelConfig(no_units=4, no_intermediate_layers=2,
                    student_t_df=200.0, predict_log_data=False,
                    multi_image_normalisation=False, use_mvg=True,
                    gate_offset=-3.0, activation="softplus",
                    dropout_rate=0.1)
SHAPE = (2, 6, 5, 2)


def recording(masks: list):
    """An interceptor for ``nn.intercept_methods`` that appends each mask
    flax's Dropout draws in a training pass to ``masks``."""

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if (isinstance(mod, fnn.Dropout) and context.method_name == "__call__"
                and not mod.deterministic and 0.0 < mod.rate < 1.0):
            rng = mod.make_rng(mod.rng_collection)
            masks.append(np.array(jax.random.bernoulli(
                rng, 1.0 - mod.rate, args[0].shape)))
            return next_fun(*args, rng=rng, **kwargs)
        return next_fun(*args, **kwargs)

    return interceptor


def _batch(rng, k=5):
    mask = (rng.uniform(size=SHAPE + (1,)) > 0.2).astype(np.float32)
    return {"images": (np.abs(rng.normal(size=SHAPE + (11,))) * 50 + 100
                       ).astype(np.float32) * mask,
            "mask": mask,
            "priors": (rng.normal(size=SHAPE + (k,)) * 0.3
                       ).astype(np.float32)}


def _key_noise(key, model):
    """The normals of JAX _finetune_terms(key): z_nll from the first split's
    first split, z_kl from the second split."""
    k_sample, k_kl = jax.random.split(key)
    k_draw = jax.random.split(k_sample)[0]

    def draws(k, s):
        return np.array(jax.vmap(lambda kk: jax.random.normal(
            kk, SHAPE + (2,)))(jax.random.split(k, s)))

    return {"z_nll": draws(k_draw, model.no_samples), "z_kl": draws(k_kl, 70)}


def _jax_terms(model, params, key, batch):
    """(value, grads state_dict, masks) of the JAX fine-tune loss with
    dropout on."""
    cfg = QBoldConfig(scan=SCAN, model=model,
                      train=TrainConfig(fused_elbo="off",
                                        fused_decode_nll="off"))
    from qbold_vi_tpu.models.vi import FineTuner as JFineTuner

    jt = JFineTuner(model, SCAN)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    masks = []
    with fnn.intercept_methods(recording(masks)):
        value, grads = jax.value_and_grad(
            lambda p: _finetune_terms(p, key, jb, jt, cfg)[0])(
                jax.tree_util.tree_map(jnp.asarray, params))
    grads = from_jax.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads))
    return float(value), grads, masks


def _port_cfg(tuner, fused_elbo="off"):
    return tcfg.QBoldConfig(scan=tuner.scan, model=tuner.cfg,
                            train=tcfg.TrainConfig(fused_elbo=fused_elbo,
                                                   fused_decode_nll="off"))


def _assert_grads_close(named_params, grads_ref):
    for name, p in named_params:
        r = grads_ref[name].numpy()
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(r)
        scale = np.abs(r).max() + 1e-8
        np.testing.assert_allclose(g / scale, r / scale, rtol=5e-4,
                                   atol=5e-5, err_msg=name)


@pytest.mark.parametrize("path,layer_norm", [("F", False), ("plain", False),
                                             ("plain", True)])
def test_finetune_step_with_jax_masks_matches_jax(path, layer_norm):
    """One fine-tune loss and its gradients at rate 0.1 through kernel F's
    plain version or the plain path, on a z-folded trunk (masks (B*Z, X,
    Y, U)) and under GroupNorm (masks (B, X, Y, Z, U)); 2 masks a block.
    The masks matter: without them the port's loss differs."""
    model = dataclasses.replace(MODEL, use_layer_norm=layer_norm)
    _, params = port_params(model, SCAN, seed=4)
    batch = _batch(np.random.default_rng(21))
    key = jax.random.PRNGKey(8)
    value, grads, masks = _jax_terms(model, params, key, batch)
    assert len(masks) == 2 * model.no_intermediate_layers
    fold = (SHAPE[0] * SHAPE[3],) + SHAPE[1:3] if not layer_norm else SHAPE
    assert all(m.shape == fold + (model.no_units,) for m in masks)
    assert 0.0 < np.mean(np.concatenate([m.ravel() for m in masks])) < 1.0

    tuner = port_tuner(model, SCAN, params)
    tc = _port_cfg(tuner, "on" if path == "F" else "off")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    noise = _key_noise(key, model)
    total, _ = tsteps.finetune_terms(tuner, tc, tb, noise=noise,
                                     dropout_masks=masks)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), value, rtol=1e-5)
    _assert_grads_close(tuner.named_parameters(), grads)

    with torch.no_grad():
        other = [np.ones_like(m) for m in masks]
        kept, _ = tsteps.finetune_terms(tuner, tc, tb, noise=noise,
                                        dropout_masks=other)
    assert abs(float(kept) - value) > 1e-5 * abs(value)


def test_bf16_finetune_step_with_jax_masks_matches_jax():
    """At compute_dtype="bfloat16" flax divides the bf16 activations by the
    weak-typed keep rate, i.e. by bf16(0.9), and selects in bf16; the port
    rounds there too (models.encoder.Dropout). Softplus, convs by the
    library conv against nn.Conv."""
    model = dataclasses.replace(MODEL, no_units=8, no_intermediate_layers=1,
                                compute_dtype="bfloat16")
    _, params = port_params(model, SCAN, seed=3)
    batch = _batch(np.random.default_rng(11))
    key = jax.random.PRNGKey(5)
    value, grads, masks = _jax_terms(model, params, key, batch)
    assert len(masks) == 2
    tuner = port_tuner(model, SCAN, params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, _ = tsteps.finetune_terms(tuner, _port_cfg(tuner), tb,
                                     noise=_key_noise(key, model),
                                     dropout_masks=masks)
    assert total.dtype == torch.float32
    total.backward()
    np.testing.assert_allclose(float(total.detach()), value, rtol=1e-4)
    assert_bf16_grads_close(tuner.named_parameters(), grads)


def test_pretrain_step_at_rate_0_1_matches_jax():
    """The pretrain loss reads stream 1, which flax's dropout (stream 2's
    residual path) never reaches: the JAX step at rate 0.1 draws its
    masks and computes what it computes at rate 0, and the port's step at
    rate 0.1 agrees with it (loss rtol 1e-5, gradients as the fine-tune
    gate)."""
    from qbold_vi_tpu.models.vi import FineTuner as JFineTuner

    rng = np.random.default_rng(2)
    cfg = QBoldConfig(scan=SCAN, model=MODEL)
    _, params = port_params(MODEL, SCAN, seed=6)
    batch = {"x": (np.abs(rng.normal(size=(2, 4, 4, 2, 11))) * 50 + 100
                   ).astype(np.float32),
             "y": np.stack([rng.uniform(0.1, 0.7, (2, 4, 4, 2)),
                            rng.uniform(0.01, 0.15, (2, 4, 4, 2)),
                            rng.uniform(1.0, 10.0, (2, 4, 4, 2))],
                           -1).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    masks = []
    with fnn.intercept_methods(recording(masks)):
        value, grads = jax.value_and_grad(lambda p: _pretrain_loss(
            p, key, jb, JFineTuner(MODEL, SCAN), cfg))(jparams)
    assert len(masks) == 2 * MODEL.no_intermediate_layers
    cfg0 = dataclasses.replace(cfg, model=dataclasses.replace(
        MODEL, dropout_rate=0.0))
    value0 = _pretrain_loss(jparams, key, jb, JFineTuner(cfg0.model, SCAN),
                            cfg0)
    assert float(value0) == float(value)

    k_loss = jax.random.split(key)[0]
    z = np.array(jax.vmap(lambda kk: jax.random.normal(
        kk, (batch["x"][..., 0].size, 2)))(jax.random.split(k_loss, 10)))
    tuner = port_tuner(MODEL, SCAN, params)
    tc = tcfg.QBoldConfig(scan=tuner.scan, model=tuner.cfg)
    loss = tsteps.pretrain_loss(
        tuner, tc, {k: torch.from_numpy(v) for k, v in batch.items()},
        noise={"z_r2p": z})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(value), rtol=1e-5)
    _assert_grads_close(tuner.named_parameters(), from_jax.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads)))


def test_train_false_ignores_the_rate():
    """Validation and inference are deterministic: ``FineTuner.dropout``
    gives None for train=False, and the terms, the encoder and the ELBO
    evaluation at rate 0.1 equal those at rate 0 bit for bit."""
    _, params = port_params(MODEL, SCAN, seed=1)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(np.random.default_rng(5)).items()}
    noise = _key_noise(jax.random.PRNGKey(1), MODEL)
    out = {}
    for rate in (0.1, 0.0):
        tuner = port_tuner(dataclasses.replace(MODEL, dropout_rate=rate),
                           SCAN, params)
        assert tuner.dropout(False, seed=3) is None
        tc = _port_cfg(tuner)
        with torch.no_grad():
            total, _ = tsteps.finetune_terms(tuner, tc, batch, noise=noise,
                                             train=False)
            ev = tsteps.make_finetune_eval(tuner, tc, stochastic_passes=2)(
                batch, seed=4)
            out[rate] = (total, tuner.encode(batch["images"]), ev)
    assert torch.equal(out[0.1][0], out[0.0][0])
    for a, b in zip(out[0.1][1], out[0.0][1]):
        assert torch.equal(a, b)
    for k in out[0.0][2]:
        assert torch.equal(out[0.1][2][k], out[0.0][2][k]), k


def test_drawn_masks_and_the_trainer():
    """On its own generator (the device's on the card): a seed replays its
    masks, the kept share is near 1 - rate and kept units are scaled by
    1 / (1 - rate); rate 1 zeroes everything; a Trainer fine-tunes and
    pretrains at rate 0.1 from a seed."""
    h = torch.rand((64, 5, 7, 8)) + 0.5
    a = Dropout(0.1, generator=torch.Generator().manual_seed(7))(h)
    b = Dropout(0.1, generator=torch.Generator().manual_seed(7))(h)
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.01
    torch.testing.assert_close(a[kept], h[kept] / 0.9, rtol=1e-6, atol=0)
    assert torch.equal(Dropout(1.0, masks=[])(h), torch.zeros_like(h))
    with pytest.raises(ValueError, match="more dropout masks"):
        Dropout(0.5, masks=[])(h)
    with pytest.raises(ValueError, match="shape"):
        Dropout(0.5, masks=[np.ones((2, 2), bool)])(h)

    import tempfile

    model = tcfg.ModelConfig(**{f.name: getattr(MODEL, f.name)
                                for f in dataclasses.fields(MODEL)})
    cfg = tcfg.QBoldConfig(
        scan=tcfg.ScanParams(**dataclasses.asdict(SCAN)), model=model,
        synth=tcfg.SynthParams(sample_size=40),
        train=tcfg.TrainConfig(no_pt_epochs=1, no_ft_epochs=1,
                               ft_steps_per_epoch=2, ft_batch_size=2,
                               crop_size=8, pt_batch_size=1,
                               pt_on_device_synth=True))
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, save_directory=tmp))
        t = Trainer(cfg, device="cpu", logger=lambda *a: None)
        assert all(np.isfinite(v) for v in t.pretrain().values())
        rng = np.random.default_rng(0)
        data = np.abs(rng.normal(size=(2, 12, 12, 2, 12))
                      ).astype(np.float32) * 50 + 100
        data[..., -1] = 1.0
        m = t.finetune(data, epochs=1)
        assert all(np.isfinite(v) for v in m.values())
