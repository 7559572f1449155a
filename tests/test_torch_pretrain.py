"""The port's synthetic pretraining against the JAX package's.

(a) the fixed synthetic set from the same integer seed: y bit-equal, x
    (the torch decode against the JAX decode) within 1e-5;
(b) the seed fold against ``jax.random.fold_in``;
(c) the pseudo-volume split and the batch order, bit-equal;
(d) noise, misalignment and the population samplers fed the JAX key's
    draws, within float32 rounding (erfinv differs in its last bits);
(e) ``synthetic_data_loss`` and its gradient w.r.t. the head at rtol 1e-5
    (gradients scale-normalised);
(f) the pretraining optimiser and SWA against optax over 5 steps at
    rtol 1e-6 / atol 1e-7 (the same float32 operations in the same order);
(g) one pretraining step: the loss at rtol 1e-5, the update held as in
    tests/test_torch_train.py (Adam's first step is ~lr sign(g)); at
    compute_dtype="bfloat16" (softplus) the loss at rtol 1e-4 and the
    gradients by torch_parity_utils.assert_bf16_grads_close;
(h) ``Trainer.pretrain()`` against the JAX ``Trainer.pretrain()`` from the
    same initial parameters: parameters within 1e-4 of each leaf's scale,
    val_loss within 1e-5;
(i) the CPU chain pretrain -> finetune under fused_conv="on" (the plain
    kernel H) against the chain under "off": parameters within 1e-4 of each
    leaf's scale (the two convs sum in different orders, and Adam carries
    the difference from step to step).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import (assert_bf16_grads_close,  # noqa: E402
                                own_save_dir, port_params, port_tuner)
from qbold_vi_tpu import config as jcfg  # noqa: E402
from qbold_vi_tpu import synth as jsynth  # noqa: E402
from qbold_vi_tpu.dist.logit_mvn import LogitMVN as JLogitMVN  # noqa: E402
from qbold_vi_tpu.ops import physics as jphys  # noqa: E402
from qbold_vi_tpu.train import data as jdata  # noqa: E402
from qbold_vi_tpu.train import losses as jlosses  # noqa: E402
from qbold_vi_tpu.train import optim as joptim  # noqa: E402
from qbold_vi_tpu.train.steps import TrainState, make_pretrain_step  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch import synth as tsynth  # noqa: E402
from qbold_vi_tpu_torch.dist.logit_mvn import LogitMVN  # noqa: E402
from qbold_vi_tpu_torch.io import from_jax  # noqa: E402
from qbold_vi_tpu_torch.ops import physics as tphys  # noqa: E402
from qbold_vi_tpu_torch.train import data as tdata  # noqa: E402
from qbold_vi_tpu_torch.train import losses as tlosses  # noqa: E402
from qbold_vi_tpu_torch.train import optim as toptim  # noqa: E402
from qbold_vi_tpu_torch.train import steps as tsteps  # noqa: E402
from qbold_vi_tpu_torch.train.trainer import Trainer, WeightStatus  # noqa: E402


def _port(dc):
    """The port's copy of a JAX config dataclass (same fields)."""
    if isinstance(dc, jcfg.QBoldConfig):
        return tcfg.QBoldConfig(scan=_port(dc.scan), synth=_port(dc.synth),
                                model=_port(dc.model), train=_port(dc.train),
                                name=dc.name)
    klass = getattr(tcfg, type(dc).__name__)
    return klass(**{f.name: getattr(dc, f.name)
                    for f in dataclasses.fields(dc)})


def _tiny(tmp, **train):
    base = jcfg.OPTIMAL
    return dataclasses.replace(
        base,
        model=dataclasses.replace(base.model, no_units=8,
                                  no_intermediate_layers=1),
        synth=dataclasses.replace(base.synth, sample_size=40),
        train=dataclasses.replace(base.train, no_pt_epochs=2, pt_batch_size=1,
                                  save_directory=str(tmp), **train))


# ---- (a), (b), (c) the synthetic set ---------------------------------------

@pytest.mark.parametrize("misalign,noise", [(0.0, True), (0.3, True),
                                            (0.3, False)])
def test_synthetic_set_matches_jax(misalign, noise):
    scan = jcfg.ScanParams(simulate_noise=noise)
    synth = jcfg.SynthParams(sample_size=30, misalign_prob=misalign)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 0x5EED)
    x_ref, y_ref = jsynth.create_synthetic_dataset_host(key, scan, synth)
    x, y = tsynth.create_synthetic_dataset_host(
        tsynth.pretrain_data_seed(3), _port(scan), _port(synth), device="cpu")
    np.testing.assert_array_equal(y, y_ref)
    assert x.dtype == np.float32 and x.shape == (900, scan.n_taus)
    np.testing.assert_allclose(x, x_ref, rtol=1e-5, atol=1e-5)


def test_synthetic_set_decodes_on_the_card_by_default(monkeypatch):
    """Like every entry point of the port, the synthetic set decodes on
    the CUDA card unless given device="cpu": without a card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsynth.create_synthetic_dataset_host(
            0, tcfg.ScanParams(), tcfg.SynthParams(sample_size=4))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1])
def test_seed_fold_matches_jax(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5EED)
    words = [int(w) for w in np.asarray(jax.random.key_data(key)).ravel()]
    raw = jax.random.key_data(jax.random.PRNGKey(seed))
    assert words[-1] == tsynth.pretrain_data_seed(seed)
    assert list(tsynth.threefry_fold_in(tuple(int(w) for w in np.asarray(
        raw).ravel()), 0x5EED)) == words


def test_split_and_batches_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2345, 11)).astype(np.float32)
    y = rng.normal(size=(2345, 3)).astype(np.float32)
    got, ref = tdata.split_synthetic(x, y), jdata.split_synthetic(x, y)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(a, b)
    (tx, ty), _ = got
    for bs in (1, 2, 5):
        pairs = zip(tdata.synthetic_batches(np.random.default_rng(4), tx, ty,
                                            bs),
                    jdata.synthetic_batches(np.random.default_rng(4), tx, ty,
                                            bs))
        n = 0
        for a, b in pairs:
            n += 1
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        assert n == max(1, len(tx) // bs)


# ---- (d) draws fed from the JAX key -----------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


def test_noise_and_misalignment_match_jax():
    scan = jcfg.ScanParams()
    rng = np.random.default_rng(1)
    n = 257
    signal = (rng.uniform(size=(n, scan.n_taus)) * 0.5 + 0.3).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    ref = jphys.add_acquisition_noise(key, jnp.asarray(signal), scan.taus())
    k1, k2 = jax.random.split(key)
    got = tphys.add_acquisition_noise(
        _t(signal), scan.taus(), _t(jax.random.uniform(k1, (n, 1))),
        _t(jax.random.normal(k2, signal.shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)

    oef = rng.uniform(0.05, 0.8, size=n).astype(np.float32)
    dbv = rng.uniform(0.01, 0.15, size=n).astype(np.float32)
    ref = jphys.misalign_params(key, jnp.asarray(oef), jnp.asarray(dbv),
                                scan.n_taus, 0.4)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    got = tphys.misalign_params(
        _t(oef), _t(dbv), scan.n_taus, 0.4, _t(jax.random.uniform(k1, (n, 1))),
        _t(jax.random.randint(k2, (n, 1), 4, scan.n_taus - 1)),
        _t(jax.random.normal(k3, (n, 1))), _t(jax.random.normal(k4, (n, 1))))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tphys.norm_snr_profile(np.zeros(5)).tolist() == [1.0] * 5
    np.testing.assert_array_equal(tphys.norm_snr_profile(np.zeros(24)),
                                  jphys.norm_snr_profile(np.zeros(24)))
    np.testing.assert_allclose(
        tphys.r2_prime(_t(oef), _t(dbv), scan.hct, _port(scan)).numpy(),
        np.asarray(jphys.r2_prime(oef, dbv, scan.hct, scan)), rtol=1e-6)


def test_population_samplers_match_jax():
    synth = jcfg.SynthParams(sample_size=300, uniform_prop=0.3,
                             misalign_prob=0.2)
    key = jax.random.PRNGKey(2)
    n_uni = round(synth.sample_size * synth.uniform_prop)
    n_norm = synth.sample_size - n_uni
    k_ou, k_on, k_du, k_dn = jax.random.split(key, 4)
    draws = {"oef_u": jax.random.uniform(k_ou, (n_uni,)),
             "oef_n": jax.random.normal(k_on, (n_norm,)),
             "dbv_u": jax.random.uniform(k_du, (n_uni,)),
             "dbv_n": jax.random.uniform(k_dn, (n_norm,))}
    got = tsynth.sample_population_params(
        _port(synth), {k: _t(v) for k, v in draws.items()})
    ref = jsynth.sample_population_params(key, synth)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    n = 400
    names = ("sel_o", "sel_d", "oef_u", "oef_n", "dbv_u", "dbv_n")
    keys = dict(zip(names, jax.random.split(key, 6)))
    draws = {k: (jax.random.normal if k == "oef_n" else jax.random.uniform)(
        keys[k], (n,)) for k in names}
    got = tsynth.sample_batch_params(_port(synth),
                                     {k: _t(v) for k, v in draws.items()})
    ref = jsynth.sample_batch_params(key, synth, n)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert tsynth.synth_oef_bound(_port(synth)) == jsynth.synth_oef_bound(
        synth)


# ---- (e) the loss ----------------------------------------------------------

@pytest.mark.parametrize("mvg", [True, False])
@pytest.mark.parametrize("r2p", [True, False])
@pytest.mark.parametrize("prior", ["off", "fixed", "inferred"])
def test_synthetic_data_loss_matches_jax(mvg, r2p, prior):
    scan = jcfg.ScanParams()
    model = jcfg.ModelConfig(use_mvg=mvg, infer_inv_gamma=prior == "inferred")
    ab = (3.0, 0.5) if prior == "fixed" else (0.0, 0.0)
    rng = np.random.default_rng(5)
    n, k = 300, 5 if mvg else 4
    oef = rng.uniform(0.04, 0.84, n)
    dbv = rng.uniform(0.001, 0.201, n)
    y = np.stack([oef, dbv, scan.dw_coeff * scan.hct * oef * dbv],
                 -1).astype(np.float32)
    head = rng.normal(size=(n, k)).astype(np.float32) * 0.8
    if prior == "inferred":
        hyper = np.broadcast_to(np.float32([18.0, 2.2, 21.0, 2.7]), (n, 4))
        head = np.concatenate([head, hyper], -1).astype(np.float32)
    key = jax.random.PRNGKey(6)
    kw = dict(use_r2p_loss=r2p, inv_gamma_alpha=ab[0], inv_gamma_beta=ab[1])

    def jloss(h):
        return jlosses.synthetic_data_loss(key, JLogitMVN(), model, scan,
                                           jnp.asarray(y), h, **kw)

    v_ref, g_ref = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(head))
    z = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (n, 2)))(
        jax.random.split(key, 10)))
    h = _t(head).requires_grad_()
    v = tlosses.synthetic_data_loss(LogitMVN(), _port(model), _port(scan),
                                    _t(y), h, z=_t(z), **kw)
    (g,) = torch.autograd.grad(v, h)
    np.testing.assert_allclose(float(v.detach()), float(v_ref), rtol=1e-5)
    scale = np.abs(np.asarray(g_ref)).max()
    np.testing.assert_allclose(g.numpy() / scale, np.asarray(g_ref) / scale,
                               rtol=1e-5, atol=1e-5)
    rows = tlosses.synthetic_data_loss(LogitMVN(), _port(model), _port(scan),
                                       _t(y), _t(head), z=_t(z),
                                       return_mean=False, **kw)
    assert rows.shape == (n,)


# ---- (f) optimiser and SWA --------------------------------------------------

@pytest.mark.parametrize("use_swa", [True, False])
def test_pretrain_optimizer_and_swa_match_optax(use_swa):
    train = jcfg.TrainConfig(pt_lr=2e-3, pt_adamw_decay=3e-3,
                             use_swa=use_swa, swa_start=2, swa_period=2)
    rng = np.random.default_rng(8)
    p0 = {"encoder": {"a": rng.normal(size=(4, 3)).astype(np.float32),
                      "b": rng.normal(size=(5,)).astype(np.float32)},
          "pop_prior": rng.normal(size=(5,)).astype(np.float32)}
    flat = {"encoder.a": ("encoder", "a"), "encoder.b": ("encoder", "b"),
            "pop_prior": ("pop_prior",)}

    def leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    grads = [jax.tree_util.tree_map(
        lambda v: (rng.normal(size=v.shape) * 10.0 ** -i).astype(np.float32),
        p0) for i in range(5)]
    for g in grads[:2]:
        g["encoder"]["b"][:] = 0.0             # no gradient: decay alone
    opt = joptim.make_pretrain_optimizer(train)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = opt.init(jp)
    jswa = joptim.swa_init(jp)
    named = [(k, torch.nn.Parameter(torch.from_numpy(leaf(p0, v).copy())))
             for k, v in flat.items()]
    topt = toptim.make_pretrain_optimizer(named, _port(train))
    tswa = toptim.swa_init(named)
    for g in grads:
        upd, st = opt.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)
        jswa = joptim.swa_update(jswa, jp, train.swa_start, train.swa_period)
        for k, p in named:
            p.grad = torch.from_numpy(leaf(g, flat[k]))
        topt.step()
        tswa = toptim.swa_update(tswa, named, train.swa_start,
                                 train.swa_period)
        for k, p in named:
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(leaf(jp, flat[k])),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert (tswa.step, tswa.n_avg) == (int(jswa.step), int(jswa.n_avg)) \
        == (5, 2)
    for k, _ in named:
        np.testing.assert_allclose(tswa.average[k].numpy(),
                                   np.asarray(leaf(jswa.average, flat[k])),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


# ---- (g) one step -----------------------------------------------------------

@pytest.mark.parametrize("use_swa,r2p", [(True, True), (False, False)])
def test_one_pretrain_step_matches_jax(use_swa, r2p):
    base = jcfg.OPTIMAL
    model = dataclasses.replace(base.model, no_units=8,
                                no_intermediate_layers=1)
    cfg = dataclasses.replace(base, model=model, train=dataclasses.replace(
        base.train, use_swa=use_swa, use_r2p_loss=r2p))
    jt, params = port_params(model, cfg.scan, seed=2)
    rng = np.random.default_rng(3)
    shape = (3, 4, 4, 2)
    oef = rng.uniform(0.04, 0.84, shape)
    dbv = rng.uniform(0.001, 0.201, shape)
    batch = {"x": (rng.uniform(size=shape + (11,)) * 0.4 + 0.4
                   ).astype(np.float32),
             "y": np.stack([oef, dbv, cfg.scan.dw_coeff * cfg.scan.hct * oef
                            * dbv], -1).astype(np.float32)}
    opt = joptim.make_pretrain_optimizer(cfg.train)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    state = TrainState(jparams, opt.init(jparams),
                       joptim.swa_init(jparams) if use_swa else None,
                       jnp.zeros([], jnp.int32))
    key = jax.random.PRNGKey(4)
    grads_ref = jax.grad(lambda p: jax_pretrain_loss(p, key, batch, jt, cfg))(
        jax.tree_util.tree_map(jnp.asarray, params))
    new_state, m_ref = make_pretrain_step(jt, cfg, opt)(
        state, key, {k: jnp.asarray(v) for k, v in batch.items()})
    k_loss = jax.random.split(key)[0]
    n = int(np.prod(shape))
    noise = {"z_r2p": np.asarray(jax.vmap(lambda kk: jax.random.normal(
        kk, (n, 2)))(jax.random.split(k_loss, 10)))}

    tuner = port_tuner(model, cfg.scan, params)
    tc = _port(cfg)
    before = {k: v.clone() for k, v in tuner.state_dict().items()}
    topt = toptim.make_pretrain_optimizer(tuner.named_parameters(), tc.train)
    m = tsteps.make_pretrain_step(tuner, tc, topt)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise)
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                               rtol=1e-5)
    after_ref = from_jax.state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, new_state.params))
    g_ref = from_jax.state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                grads_ref))
    lr = tc.train.pt_lr
    for name, p in tuner.state_dict().items():
        delta = (p - before[name]).numpy()
        delta_ref = (after_ref[name] - before[name]).numpy()
        g = np.abs(g_ref[name].numpy())
        clear = g > 1e-3 * (g.max() + 1e-30)
        err = np.abs(delta - delta_ref)
        assert np.all(err[clear] <= 1e-6 + 1e-4 * np.abs(delta_ref[clear])), \
            name
        assert np.all(err <= 2.0 * lr), name
        if not g.any():        # stream 2 and the sigma head: decay alone
            np.testing.assert_array_equal(delta, delta_ref, err_msg=name)


def test_bf16_pretrain_step_matches_jax():
    """One stream-1 pretraining step with the trunk in bf16: its loss and
    gradients against JAX's, float32 parameters, head output and loss."""
    base = jcfg.OPTIMAL
    model = dataclasses.replace(base.model, no_units=8,
                                no_intermediate_layers=2,
                                activation="softplus",
                                compute_dtype="bfloat16")
    cfg = dataclasses.replace(base, model=model)
    jt, params = port_params(model, cfg.scan, seed=2)
    rng = np.random.default_rng(3)
    shape = (3, 4, 4, 2)
    oef = rng.uniform(0.04, 0.84, shape)
    dbv = rng.uniform(0.001, 0.201, shape)
    batch = {"x": (rng.uniform(size=shape + (11,)) * 0.4 + 0.4
                   ).astype(np.float32),
             "y": np.stack([oef, dbv, cfg.scan.dw_coeff * cfg.scan.hct * oef
                            * dbv], -1).astype(np.float32)}
    key = jax.random.PRNGKey(4)
    value_ref, grads_ref = jax.value_and_grad(
        lambda p: jax_pretrain_loss(p, key, batch, jt, cfg))(
        jax.tree_util.tree_map(jnp.asarray, params))
    k_loss = jax.random.split(key)[0]
    n = int(np.prod(shape))
    noise = {"z_r2p": np.asarray(jax.vmap(lambda kk: jax.random.normal(
        kk, (n, 2)))(jax.random.split(k_loss, 10)))}
    tuner = port_tuner(model, cfg.scan, params)
    tc = _port(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert tuner.encoder.stream1(tb["x"]).dtype == torch.float32
    loss = tsteps.pretrain_loss(tuner, tc, tb, noise=noise)
    assert loss.dtype == torch.float32
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(value_ref),
                               rtol=1e-4)
    assert_bf16_grads_close(tuner.named_parameters(),
                            from_jax.state_dict_from_jax(
                                jax.tree_util.tree_map(np.asarray,
                                                       grads_ref)))


def jax_pretrain_loss(params, key, batch, tuner, cfg):
    from qbold_vi_tpu.train.steps import _pretrain_loss

    return _pretrain_loss(params, key,
                          {k: jnp.asarray(v) for k, v in batch.items()},
                          tuner, cfg)


# ---- (h), (i) the trainer ---------------------------------------------------

def _leafwise_close(got: dict, ref: dict, rtol: float):
    for name, r in ref.items():
        r = np.asarray(r, np.float64)
        scale = np.abs(r).max() + 1e-12
        err = np.abs(np.asarray(got[name], np.float64) - r).max()
        assert err <= rtol * scale, f"{name}: {err:.3e} of scale {scale:.3e}"


def test_trainer_pretrain_matches_jax(tmp_path):
    from qbold_vi_tpu.train.trainer import Trainer as JTrainer

    cfg = _tiny(tmp_path / "jax", swa_start=2, swa_period=1, swa_adopt=True)
    logged, logged_ref = [], []
    t = Trainer(_port(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, save_directory=str(tmp_path / "port")))), device="cpu",
        logger=lambda *a: logged.append(a))
    assert t.status is WeightStatus.NOT_TRAINED
    init = from_jax.jax_from_state_dict(t.tuner.state_dict())
    jt = JTrainer(cfg, logger=lambda *a: logged_ref.append(a))
    jt._init_params = lambda: jax.tree_util.tree_map(jnp.asarray, init)
    state = jt.pretrain()
    t.pretrain()
    assert t.status is WeightStatus.PRE_TRAINED
    assert [a[:2] for a in logged] == [a[:2] for a in logged_ref] == [
        ("pretrain", 0), ("pretrain", 1)]
    for (_, _, m), (_, _, m_ref) in zip(logged, logged_ref):
        np.testing.assert_allclose(m["val_loss"], m_ref["val_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(m["loss"], m_ref["loss"], rtol=1e-5)
    assert t.swa.n_avg == int(state.swa.n_avg) == 3
    np.testing.assert_allclose(t.pretrain_val_metrics()["val_loss"],
                               jt.pretrain_val_metrics()["val_loss"],
                               rtol=1e-5)
    ref = from_jax.state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, state.params))
    _leafwise_close({k: v.numpy() for k, v in t.tuner.state_dict().items()},
                    {k: v.numpy() for k, v in ref.items()}, 1e-4)


def test_pretrain_then_finetune_kernel_h_chain(tmp_path):
    rng = np.random.default_rng(2)
    data = (np.abs(rng.normal(size=(2, 40, 30, 2, 12))) * 50 + 100
            ).astype(np.float32)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.2
    finals = {}
    for mode in ("on", "off"):
        cfg = own_save_dir(_port(_tiny(
            tmp_path, ft_steps_per_epoch=3, ft_batch_size=2, crop_size=8,
            fused_elbo="on")), tmp_path)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, fused_conv=mode))
        t = Trainer(cfg, device="cpu", logger=lambda *a: None)
        with pytest.raises(RuntimeError, match="pretrain"):
            t.finetune(data, epochs=1)
        t.pretrain()
        t.finetune(data, epochs=1)
        finals[mode] = {k: v.numpy() for k, v in t.tuner.state_dict().items()}
    _leafwise_close(finals["on"], finals["off"], 1e-4)
