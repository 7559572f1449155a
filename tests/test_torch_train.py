"""The port's fine-tune step, optimiser, data pipeline, weight bridge and
trainer against the JAX package's.

Tolerances: the loss at rtol 1e-5; the schedule and the optimiser over 5
steps at rtol 1e-6 / atol 1e-7 (the same float32 operations in the same
order); data arrays bit-equal. The updated parameters of one step: Adam's
first update is lr * g / (|g| + eps), about +-lr whatever |g| is, so an
entry is held to 1e-6 + 1e-4 |delta| where its gradient is clear of zero
(|g| > 1e-3 of the tensor's largest), and to the step's own bound 2 lr
where it is not (there the two packages' last-bit differences can flip
the sign of g).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import port_params, port_tuner  # noqa: E402
from qbold_vi_tpu.config import (ModelConfig, QBoldConfig,  # noqa: E402
                                 ScanParams, TrainConfig)
from qbold_vi_tpu.models.vi import FineTuner as JFineTuner  # noqa: E402
from qbold_vi_tpu.train import data as jdata  # noqa: E402
from qbold_vi_tpu.train import optim as joptim  # noqa: E402
from qbold_vi_tpu.train.steps import TrainState, make_finetune_step  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch.io import from_jax  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner, init_params  # noqa: E402
from qbold_vi_tpu_torch.train import data as tdata  # noqa: E402
from qbold_vi_tpu_torch.train import optim as toptim  # noqa: E402
from qbold_vi_tpu_torch.train import steps as tsteps  # noqa: E402
from qbold_vi_tpu_torch.train.trainer import Trainer  # noqa: E402

SCAN = ScanParams(simulate_noise=False)
MODEL = ModelConfig(no_units=4, no_intermediate_layers=1, student_t_df=200.0,
                    predict_log_data=False, multi_image_normalisation=False,
                    use_mvg=True, gate_offset=-3.0)


@pytest.mark.parametrize("path", ["F", "plain"])
def test_one_finetune_step_matches_jax(path):
    rng = np.random.default_rng(21)
    cfg = QBoldConfig(scan=SCAN, model=MODEL,
                      train=TrainConfig(fused_elbo="off",
                                        fused_decode_nll="off"))
    _, params = port_params(MODEL, SCAN, seed=4)
    jt = JFineTuner(MODEL, SCAN)
    shape = (2, 6, 5, 2)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask,
             "mask": mask,
             "priors": (rng.normal(size=shape + (5,)) * 0.3
                        ).astype(np.float32)}
    opt = joptim.make_finetune_optimizer(cfg.train)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    stepped = jax.tree_util.tree_map(jnp.array, params)    # donated
    state = TrainState(stepped, opt.init(stepped), None,
                       jnp.zeros([], jnp.int32))
    key = jax.random.PRNGKey(8)
    new_state, aux_ref = make_finetune_step(jt, cfg, opt)(
        state, key, {k: jnp.asarray(v) for k, v in batch.items()})
    k_sample, k_kl = jax.random.split(key)
    k_draw = jax.random.split(k_sample)[0]

    def draws(k, s):
        return np.array(jax.vmap(lambda kk: jax.random.normal(
            kk, shape + (2,)))(jax.random.split(k, s)))

    noise = {"z_nll": draws(k_draw, 1), "z_kl": draws(k_kl, 70)}
    grads_ref = from_jax.state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.grad(lambda p: _jax_loss(p, key, batch, jt, cfg))(
            jparams)))

    tuner = port_tuner(MODEL, SCAN, params)
    before = {k: v.clone() for k, v in tuner.state_dict().items()}
    tc = tcfg.QBoldConfig(scan=tuner.scan, model=tuner.cfg,
                          train=tcfg.TrainConfig(
                              fused_elbo="on" if path == "F" else "off",
                              fused_decode_nll="off"))
    topt = toptim.make_finetune_optimizer(tuner.parameters(), tc.train)
    aux = tsteps.make_finetune_step(tuner, tc, topt)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise)
    np.testing.assert_allclose(float(aux["loss"]), float(aux_ref["loss"]),
                               rtol=1e-5)
    after_ref = from_jax.state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, new_state.params))
    lr = tc.train.ft_lr
    for name, p in tuner.state_dict().items():
        delta = (p - before[name]).numpy()
        delta_ref = (after_ref[name] - before[name]).numpy()
        g = np.abs(grads_ref[name].numpy())
        clear = g > 1e-3 * (g.max() + 1e-30)
        err = np.abs(delta - delta_ref)
        assert np.all(err[clear] <= 1e-6 + 1e-4 * np.abs(delta_ref[clear])), \
            name
        assert np.all(err <= 2.0 * lr), name


def _jax_loss(params, key, batch, tuner, cfg):
    from qbold_vi_tpu.train.steps import _finetune_terms

    return _finetune_terms(params, key,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           tuner, cfg)[0]


@pytest.mark.parametrize("decay", [2e-4, 0.0])
def test_schedule_and_adamw_match_optax(decay):
    train = TrainConfig(ft_lr=5e-3, adamw_decay=decay, no_ft_epochs=1,
                        ft_steps_per_epoch=3)
    js = joptim.linear_decay_schedule(5e-3, 3)
    ts = toptim.linear_decay_schedule(5e-3, 3)
    for step in range(6):                      # past the end: unclamped
        assert np.float32(ts(step)) == np.float32(js(step))
    rng = np.random.default_rng(3)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 10 ** -i
              for k, v in p0.items()} for i in range(5)]
    opt = joptim.make_finetune_optimizer(train)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = opt.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    topt = toptim.make_finetune_optimizer(params.values(),
                                          tcfg.TrainConfig(**dataclasses.asdict(
                                              train)))
    for g in grads:
        upd, st = opt.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)


def test_real_data_pipeline_matches_jax():
    rng = np.random.default_rng(0)
    vols = rng.normal(size=(3, 40, 30, 2, 12)).astype(np.float32)
    vols[..., -1] = rng.uniform(size=vols.shape[:-1]) > 0.3
    for shape in ((3, 40, 30, 2, 12), (2, 80, 70, 2, 12)):
        v = rng.normal(size=shape).astype(np.float32)
        with pytest.warns(UserWarning) if shape[1] <= 34 else _nullcontext():
            got = tdata.blank_crop(v)
        with pytest.warns(UserWarning) if shape[1] <= 34 else _nullcontext():
            ref = jdata.blank_crop(v)
        np.testing.assert_array_equal(got, ref)

    def encode(images):
        q = np.concatenate([images[..., :5] * 0.5, images[..., :1]], -1)
        return q, q, images

    pr_t = tdata.predict_priors(encode, vols, 5, chunk=2)
    pr_j = jdata.predict_priors(encode, vols, 5, chunk=2)
    np.testing.assert_array_equal(pr_t, pr_j)
    st = tdata.RealCropSampler(vols, pr_t, 16, rng=np.random.default_rng(5))
    sj = jdata.RealCropSampler(vols, pr_j, 16, rng=np.random.default_rng(5))
    for _ in range(3):
        a, b = st.sample(4), sj.sample(4)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(st.eval_batches(2), sj.eval_batches(2)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


class _nullcontext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_sample_crop_batch_takes_the_drawn_windows():
    rng = np.random.default_rng(1)
    vols = torch.from_numpy(rng.normal(size=(3, 20, 18, 2, 12)
                                       ).astype(np.float32))
    priors = torch.from_numpy(rng.normal(size=(3, 20, 18, 2, 5)
                                         ).astype(np.float32))
    gen = torch.Generator().manual_seed(4)
    replay = torch.Generator().manual_seed(4)
    batch = tsteps.sample_crop_batch(gen, vols, priors, 5, 8)
    si = torch.randint(0, 3, (5,), generator=replay)
    xi = torch.randint(0, 13, (5,), generator=replay)
    yi = torch.randint(0, 11, (5,), generator=replay)
    for i in range(5):
        w = vols[si[i], xi[i]:xi[i] + 8, yi[i]:yi[i] + 8]
        assert torch.equal(batch["mask"][i], w[..., -1:])
        assert torch.equal(batch["images"][i], w[..., :-1] * w[..., -1:])
        assert torch.equal(batch["priors"][i],
                           priors[si[i], xi[i]:xi[i] + 8, yi[i]:yi[i] + 8])


@pytest.mark.parametrize("kw", [dict(use_population_prior=True),
                                dict(heteroscedastic_noise=False),
                                dict(use_mvg=False, use_population_prior=True,
                                     mog_components=2)])
def test_bridge_carries_pop_prior_and_log_sigma(kw):
    """pop_prior and log_sigma cross from a JAX params tree into the port's
    FineTuner and back unchanged, and the port's decode reads them."""
    model = dataclasses.replace(MODEL, **kw)
    jt = JFineTuner(model, SCAN)
    params = jax.jit(jt.init)(jax.random.PRNGKey(2),
                              jnp.ones((1, 4, 4, 1, 11), jnp.float32))
    tree = jax.tree_util.tree_map(np.asarray, params)
    tuner = FineTuner(tcfg.ModelConfig(**dataclasses.asdict(model)),
                      tcfg.ScanParams(**dataclasses.asdict(SCAN)),
                      device="cpu")
    tuner.load_state_dict(from_jax.state_dict_from_jax(tree), strict=True)
    back = from_jax.flatten_params(from_jax.jax_from_state_dict(
        tuner.state_dict()))
    flat = from_jax.flatten_params(tree)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    for name in ("pop_prior", "log_sigma"):
        assert (name in flat) == hasattr(tuner, name)
    if "log_sigma" in flat:
        images = torch.ones((1, 4, 4, 1, 11))
        out = tuner.apply(images, torch.zeros((1, 1, 4, 4, 1, 2)))
        np.testing.assert_allclose(out["im_sigma"].detach().numpy(),
                                   np.exp(flat["log_sigma"]), rtol=1e-6)


def test_finetuner_asks_for_the_card_by_default():
    cfg = tcfg.ModelConfig(no_units=4)
    if torch.cuda.is_available():
        assert FineTuner(cfg, tcfg.ScanParams()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FineTuner(cfg, tcfg.ScanParams())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Trainer(tcfg.OPTIMAL)
    assert FineTuner(cfg, tcfg.ScanParams(), device="cpu").device.type == "cpu"


def test_trainer_finetunes_on_the_cpu():
    base = tcfg.OPTIMAL
    cfg = dataclasses.replace(
        base, model=dataclasses.replace(base.model, no_units=6,
                                        no_intermediate_layers=1),
        train=dataclasses.replace(base.train, ft_steps_per_epoch=2,
                                  ft_batch_size=2, crop_size=8,
                                  fused_elbo="on"))
    rng = np.random.default_rng(2)
    data = (np.abs(rng.normal(size=(2, 40, 30, 2, 12))) * 50 + 100
            ).astype(np.float32)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.2
    logged = []
    weights = init_params(cfg.model, cfg.scan, torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="pretrain"):
        Trainer(cfg, device="cpu").finetune(data, epochs=1)
    t = Trainer(cfg, state_dict=weights, device="cpu",
                logger=lambda *a: logged.append(a))
    before = {k: v.clone() for k, v in t.tuner.state_dict().items()}
    m = t.finetune(data, study_data=data[:1], epochs=2)
    assert t.epochs_done == 2 and len(logged) == 2
    assert all(np.isfinite(v) for v in m.values())
    assert {"loss", "nll", "kl", "smoothness", "val_elbo"} <= set(m)
    assert any(not torch.equal(before[k], v)
               for k, v in t.tuner.state_dict().items())
    assert t.sampler.priors.shape == t.sampler.data.shape[:-1] + (5,)
    assert t.pretrain() == {}                 # given weights: pretrained
    streaming = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, pt_on_device_synth=True))
    with pytest.raises(NotImplementedError, match="pt_on_device_synth"):
        Trainer(streaming, device="cpu").pretrain()
    with pytest.raises(NotImplementedError, match="mesh"):
        Trainer(cfg, device="cpu", mesh=object())
    drop = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dropout_rate=0.1))
    with pytest.raises(NotImplementedError, match="dropout"):
        Trainer(drop, state_dict=weights, device="cpu").finetune(data,
                                                                 epochs=1)


def test_trainer_raises_for_unported_checkpoints(tmp_path):
    """A save directory holding a JAX checkpoint would be resumed by the JAX
    Trainer; the port raises instead of silently starting over, and it
    raises for mid-phase checkpoints too."""
    cfg = dataclasses.replace(
        tcfg.OPTIMAL,
        model=dataclasses.replace(tcfg.OPTIMAL.model, no_units=4,
                                  no_intermediate_layers=1),
        train=dataclasses.replace(tcfg.OPTIMAL.train,
                                  save_directory=str(tmp_path)))
    Trainer(cfg, device="cpu")                     # an empty directory
    (tmp_path / "final_model.msgpack").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="final_model.msgpack"):
        Trainer(cfg, device="cpu")
    (tmp_path / "final_model.msgpack").unlink()
    every = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_every_epochs=1))
    data = np.ones((1, 40, 30, 1, 12), np.float32)
    with pytest.raises(NotImplementedError, match="checkpoint_every_epochs"):
        Trainer(every, device="cpu").finetune(data, epochs=1)


def test_init_params_carry_population_prior():
    cfg = tcfg.ModelConfig(no_units=4, use_mvg=True,
                           use_population_prior=True)
    sd = init_params(cfg, tcfg.ScanParams(), torch.Generator().manual_seed(0))
    np.testing.assert_allclose(sd["pop_prior"].numpy(),
                               [-0.97, 0.4, -1.14, 0.6, 0.0])
