"""The port's streaming pretrain against the JAX package's.

(a) ``steps.stream_synthetic_batch`` fed the JAX key's draws (split in
    the JAX order: k_par, k_mis, k_noise, then sample_batch_params' six
    keys) against the JAX function, misalignment and noise on and off,
    the full SDR and the asymptotic tissue model, at the physics
    tolerance 1e-5 (the two decodes round differently in float32; y to
    float32 rounding: erfinv differs in its last bits);
(b) one streaming step and a 2-step epoch against JAX
    ``make_pretrain_stream_step`` / ``make_pretrain_stream_epoch`` given
    the same draws, SWA on and off, at
    tests/test_torch_pretrain.py::test_one_pretrain_step_matches_jax's
    tolerances: the loss at rtol 1e-5, each update within 1e-6 + 1e-4 of
    the JAX update where the gradient is clear of 0 and within 2 lr
    everywhere (Adam's first step is ~lr sign(g)); the epoch's first step
    against JAX's state after one step, its second (last) step from each
    side's state after the first against JAX's with JAX's gradient there,
    both at those tolerances, and the two in all within 4 lr; the SWA
    average within its parameters' differences (plus 2 float32 ulps);
(c) ``pretrain_val_fold`` against the JAX fold (y bit-equal, x at 1e-5,
    as the synthetic set of test_torch_pretrain.py), and
    ``Trainer.pretrain()`` in streaming mode: the JAX trainer's steps per
    epoch and epoch count, finite metrics, and ``pretrain_val_metrics(
    fold=True)`` on the fold;
(e) kernel S's draws replayed on the host (ops/synth_batch.py::
    synth_philox_draws) against a torch reimplementation of the same
    counter scheme (Philox4x32-10 on 16-bit limbs in int64), the words'
    uniforms bit-equal and the normals at rtol 1e-5 / atol 1e-6 (float64
    log/sin/cos against numpy's float32), and the plain version on a seed
    drawing that replay on the CPU;
(f) that replay's batch (kernel S's draws) against the JAX function's own
    key in distribution, at 200,000 voxels of OPTIMAL's synthetic set:
    the labels' means, variances and quantiles, the truncated normal's
    tails and each tau's noise variance, each within 5 standard errors of
    the difference of two independent samples; with misalignment, the
    misaligned share and the from_idx histogram of the two draws.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity_utils import (own_save_dir, port_params,  # noqa: E402
                                port_tuner)
from qbold_vi_tpu import config as jcfg  # noqa: E402
from qbold_vi_tpu.train import optim as joptim  # noqa: E402
from qbold_vi_tpu.train import steps as jsteps  # noqa: E402
from qbold_vi_tpu.train.steps import TrainState  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch.io import from_jax  # noqa: E402
from qbold_vi_tpu_torch.ops import synth_batch as tsb  # noqa: E402
from qbold_vi_tpu_torch.train import optim as toptim  # noqa: E402
from qbold_vi_tpu_torch.train import steps as tsteps  # noqa: E402
from qbold_vi_tpu_torch.train import trainer as ttrainer  # noqa: E402

VOL = (10, 10, 5)
BATCH = 2                       # pseudo-volumes: 1,000 voxels


def _port(dc):
    """The port's copy of a JAX config dataclass (same fields)."""
    if isinstance(dc, jcfg.QBoldConfig):
        return tcfg.QBoldConfig(scan=_port(dc.scan), synth=_port(dc.synth),
                                model=_port(dc.model), train=_port(dc.train),
                                name=dc.name)
    klass = getattr(tcfg, type(dc).__name__)
    return klass(**{f.name: getattr(dc, f.name)
                    for f in dataclasses.fields(dc)})


def _cfg(misalign=0.0, noise=True, uniform_prop=None, batch=BATCH, **train):
    base = jcfg.OPTIMAL
    synth = dataclasses.replace(base.synth, misalign_prob=misalign)
    if uniform_prop is not None:
        synth = dataclasses.replace(synth, uniform_prop=uniform_prop)
    return dataclasses.replace(
        base, synth=synth,
        scan=dataclasses.replace(base.scan, simulate_noise=noise),
        model=dataclasses.replace(base.model, no_units=8,
                                  no_intermediate_layers=1),
        train=dataclasses.replace(base.train, pt_batch_size=batch, **train))


def jax_batch_draws(key, cfg, n):
    """The draws of JAX stream_synthetic_batch(key, ...), in the port's
    layout."""
    t = cfg.scan.n_taus
    k_par, k_mis, k_noise = jax.random.split(key, 3)
    names = ("sel_o", "sel_d", "oef_u", "oef_n", "dbv_u", "dbv_n")
    keys = dict(zip(names, jax.random.split(k_par, 6)))
    d = {k: (jax.random.normal if k == "oef_n" else jax.random.uniform)(
        keys[k], (n,)) for k in names}
    if cfg.synth.misalign_prob > 0.0:
        k1, k2, k3, k4 = jax.random.split(k_mis, 4)
        d.update(mis_u=jax.random.uniform(k1, (n, 1)),
                 from_idx=jax.random.randint(k2, (n, 1), 4, t - 1),
                 z_oef=jax.random.normal(k3, (n, 1)),
                 z_dbv=jax.random.normal(k4, (n, 1)))
    if cfg.scan.simulate_noise:
        k1, k2 = jax.random.split(k_noise)
        d.update(snr_u=jax.random.uniform(k1, (n, 1)),
                 z=jax.random.normal(k2, (n, t)))
    return {k: np.array(v) for k, v in d.items()}


def jax_loss_noise(key, cfg, n):
    """The R2' loss normals of the JAX stream step's key: k_loss is the
    second split, _pretrain_loss splits it again (dropout)."""
    if not cfg.train.use_r2p_loss:
        return None
    k = jax.random.split(jax.random.split(key)[1])[0]
    return {"z_r2p": np.array(jax.vmap(lambda kk: jax.random.normal(
        kk, (n, 2)))(jax.random.split(k, 10)))}


# ---- (a) the batch -----------------------------------------------------------

@pytest.mark.parametrize("misalign,noise,uniform_prop", [
    (0.0, True, None), (0.5, True, 0.3), (0.5, False, 0.3), (0.0, False, None)])
def test_stream_batch_matches_jax(misalign, noise, uniform_prop):
    key = jax.random.PRNGKey(5)
    n = BATCH * int(np.prod(VOL))
    for full_model in (True, False):      # the SDR and asymptotic models
        cfg = _cfg(misalign, noise, uniform_prop, full_model=full_model)
        ref = jsteps.stream_synthetic_batch(key, cfg, BATCH, VOL)
        got = tsteps.stream_synthetic_batch(
            _port(cfg), BATCH, jax_batch_draws(key, cfg, n), vol_shape=VOL)
        assert got["x"].shape == (BATCH,) + VOL + (11,)
        assert got["y"].shape == (BATCH,) + VOL + (3,)
        np.testing.assert_allclose(got["y"].numpy(), np.asarray(ref["y"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["x"].numpy(), np.asarray(ref["x"]),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"full_model={full_model}")


# ---- (b) the step and the epoch -------------------------------------------

def _jax_state(cfg, params):
    opt = joptim.make_pretrain_optimizer(cfg.train)
    jp = jax.tree_util.tree_map(jnp.array, params)
    return opt, TrainState(jp, opt.init(jp),
                           joptim.swa_init(jp) if cfg.train.use_swa else None,
                           jnp.zeros([], jnp.int32))


def _sd(tree):
    return from_jax.state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               tree))


def _updates_close(got, before, after_jax, lr, spread, grads_jax=None,
                   before_jax=None):
    """Each weight's update (from ``before``; JAX's from ``before_jax``,
    by default the same) against the JAX one: within spread * lr, and
    given the step's JAX gradient, within 1e-6 + 1e-4 of it where the
    gradient is clear of 0 and equal where it is 0 (decay alone)."""
    after_ref = _sd(after_jax)
    before_ref = before if before_jax is None else _sd(before_jax)
    g_ref = None if grads_jax is None else _sd(grads_jax)
    for name, p in got.items():
        delta = (p - before[name]).numpy()
        delta_ref = (after_ref[name] - before_ref[name]).numpy()
        err = np.abs(delta - delta_ref)
        assert np.all(err <= spread * lr), name
        if g_ref is None:
            continue
        g = np.abs(g_ref[name].numpy())
        clear = g > 1e-3 * (g.max() + 1e-30)
        assert np.all(err[clear] <= 1e-6 + 1e-4 * np.abs(delta_ref[clear])), \
            name
        if not g.any():             # stream 2 and the sigma head: decay alone
            np.testing.assert_allclose(delta, delta_ref, rtol=1e-6,
                                       atol=1e-9, err_msg=name)


def _swa_close(tswa, jswa, before, lr, spread):
    assert (tswa.step, tswa.n_avg) == (int(jswa.step), int(jswa.n_avg))
    _updates_close(tswa.average, before, jswa.average, lr, spread)


def _swa_within(tswa, jswa, folded):
    """The SWA average, a mean of the parameters ``folded`` [(port, JAX)],
    within the largest of their differences plus 2 float32 ulps (the
    mean's own rounding)."""
    ref = _sd(jswa.average)
    pairs = [(p, _sd(j)) for p, j in folded]
    for name, a in tswa.average.items():
        bound = np.max([np.abs((p[name] - j[name]).numpy())
                        for p, j in pairs], axis=0)
        r = ref[name].numpy()
        err = np.abs(a.numpy() - r)
        assert np.all(err <= bound + 2 * np.finfo(np.float32).eps
                      * np.abs(r)), (name, err.max())


def _jax_grads(jt, cfg, params, key):
    """The gradient that JAX's streaming step under ``key`` takes at
    ``params``."""
    k_batch, k_loss = jax.random.split(key)
    batch = jsteps.stream_synthetic_batch(k_batch, cfg, BATCH, VOL)
    return jax.grad(lambda p: jsteps._pretrain_loss(
        p, k_loss, batch, jt, cfg))(jax.tree_util.tree_map(jnp.asarray,
                                                           params))


@pytest.mark.parametrize("use_swa,r2p", [(True, True), (False, False)])
def test_stream_step_matches_jax(use_swa, r2p):
    cfg = _cfg(misalign=0.3, use_swa=use_swa, use_r2p_loss=r2p, swa_start=0,
               swa_period=1)
    jt, params = port_params(cfg.model, cfg.scan, seed=2)
    opt, state = _jax_state(cfg, params)
    key = jax.random.PRNGKey(4)
    n = BATCH * int(np.prod(VOL))
    k_batch = jax.random.split(key)[0]
    grads_ref = _jax_grads(jt, cfg, params, key)
    new_state, m_ref = jsteps.make_pretrain_stream_step(jt, cfg, opt)(
        state, key)

    tuner = port_tuner(cfg.model, cfg.scan, params)
    tc = _port(cfg)
    before = {k: v.clone() for k, v in tuner.state_dict().items()}
    topt = toptim.make_pretrain_optimizer(tuner.named_parameters(), tc.train)
    swa = toptim.swa_init(tuner.named_parameters()) if use_swa else None
    m, swa = tsteps.make_pretrain_stream_step(tuner, tc, topt)(
        swa=swa, draws=jax_batch_draws(k_batch, cfg, n),
        noise=jax_loss_noise(key, cfg, n))
    np.testing.assert_allclose(float(m["loss"]), float(m_ref["loss"]),
                               rtol=1e-5)
    lr = tc.train.pt_lr
    _updates_close(tuner.state_dict(), before, new_state.params, lr, 2,
                   grads_ref)
    if use_swa:
        _swa_close(swa, new_state.swa, before, lr, 2)
    else:
        assert swa is None and new_state.swa is None


@pytest.mark.parametrize("use_swa", [True, False])
def test_stream_epoch_matches_jax(use_swa):
    cfg = _cfg(use_swa=use_swa, swa_start=1, swa_period=1)
    jt, params = port_params(cfg.model, cfg.scan, seed=3)
    opt, state = _jax_state(cfg, params)
    key = jax.random.PRNGKey(8)
    n = BATCH * int(np.prod(VOL))
    new_state, m_ref = jsteps.make_pretrain_stream_epoch(jt, cfg, opt, 2)(
        state, key)
    keys = jax.random.split(key, 2)
    draws = [jax_batch_draws(jax.random.split(k)[0], cfg, n) for k in keys]
    # JAX's state after the epoch's first step, and each step's gradient
    grads = [_jax_grads(jt, cfg, params, keys[0])]
    state1, _ = jsteps.make_pretrain_stream_step(jt, cfg, opt)(
        _jax_state(cfg, params)[1], keys[0])
    grads.append(_jax_grads(jt, cfg, state1.params, keys[1]))

    tc = _port(cfg)

    def port_epoch(n_steps):
        tuner = port_tuner(cfg.model, cfg.scan, params)
        topt = toptim.make_pretrain_optimizer(tuner.named_parameters(),
                                              tc.train)
        swa = toptim.swa_init(tuner.named_parameters()) if use_swa else None
        losses, swa = tsteps.make_pretrain_stream_epoch(
            tuner, tc, topt, n_steps)(swa=swa, draws=draws[:n_steps])
        return losses, tuner.state_dict(), swa

    before = port_tuner(cfg.model, cfg.scan, params).state_dict()
    _, after1, swa1 = port_epoch(1)
    losses, after, swa = port_epoch(2)
    assert losses.shape == (2,)
    np.testing.assert_allclose(losses, np.asarray(m_ref["loss"]), rtol=1e-5)
    lr = tc.train.pt_lr
    # the first step against JAX's state after one step, the last step from
    # each side's state after the first, and the two steps in all
    _updates_close(after1, before, state1.params, lr, 2, grads[0])
    _updates_close(after, after1, new_state.params, lr, 2, grads[1],
                   before_jax=state1.params)
    _updates_close(after, before, new_state.params, lr, 4)
    if use_swa:
        _swa_close(swa1, state1.swa, before, lr, 2)
        _swa_within(swa1, state1.swa, [(after1, state1.params)])
        _swa_close(swa, new_state.swa, before, lr, 4)
        _swa_within(swa, new_state.swa, [(after1, state1.params),
                                         (after, new_state.params)])
    else:
        assert swa is None and new_state.swa is None


# ---- (c) the fold and the trainer --------------------------------------------

def test_pretrain_val_fold_matches_jax():
    from qbold_vi_tpu.train.trainer import pretrain_val_fold as jfold

    cfg = dataclasses.replace(jcfg.OPTIMAL, synth=dataclasses.replace(
        jcfg.OPTIMAL.synth, sample_size=300, misalign_prob=0.2))
    vx_ref, vy_ref = jfold(cfg)
    vx, vy = ttrainer.pretrain_val_fold(_port(cfg), device="cpu")
    assert vx.shape == vx_ref.shape == (5,) + VOL + (11,)  # 160^2 / 500 / 10
    np.testing.assert_array_equal(vy, vy_ref)
    np.testing.assert_allclose(vx, vx_ref, rtol=1e-5, atol=1e-5)


def test_trainer_stream_pretrain(tmp_path, monkeypatch):
    """Trainer.pretrain() in streaming mode runs the JAX trainer's steps per
    epoch and epochs (the JAX trainer's loop, its step and eval replaced by
    counters), logs finite metrics, and validates on the fold."""
    from qbold_vi_tpu.train import trainer as jtrainer

    cfg = dataclasses.replace(
        _cfg(batch=1, pt_on_device_synth=True, no_pt_epochs=2,
             save_directory=str(tmp_path / "jax")),
        synth=dataclasses.replace(jcfg.OPTIMAL.synth, sample_size=40))
    jax_steps = []

    def fake_epoch(tuner, c, optimizer, n_steps, mesh=None):
        jax_steps.append(n_steps)
        return lambda state, key: (state, {"loss": jnp.zeros(n_steps)})

    monkeypatch.setattr(jtrainer, "make_pretrain_stream_epoch", fake_epoch)
    jt = jtrainer.Trainer(cfg, logger=lambda *a: None)
    monkeypatch.setattr(jt, "_pretrain_eval_fn", lambda: (
        lambda params, key, batch: {"val_loss": jnp.zeros([])}))
    jt.pretrain()

    port_steps, logged = [], []
    real = ttrainer.make_pretrain_stream_epoch

    def counted(tuner, c, optimizer, n_steps, *a, **kw):
        port_steps.append(n_steps)
        return real(tuner, c, optimizer, n_steps, *a, **kw)

    monkeypatch.setattr(ttrainer, "make_pretrain_stream_epoch", counted)
    tc = _port(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, save_directory=str(tmp_path / "port"))))
    t = ttrainer.Trainer(tc, device="cpu", logger=lambda *a: logged.append(a))
    train_set, _ = t.build_pretrain_data()
    assert train_set is None
    t.pretrain()
    assert port_steps == jax_steps == [ttrainer.stream_steps_per_epoch(tc)]
    assert port_steps == [3]                   # round(0.9 * 40^2 / 500 / 1)
    assert [a[:2] for a in logged] == [("pretrain", 0), ("pretrain", 1)]
    for _, _, m in logged:
        assert all(np.isfinite(v) for v in m.values()), m
    assert t.status is ttrainer.WeightStatus.PRE_TRAINED
    assert t.swa.step == 2 * 3                 # SWA stepped once a step
    fold = t.pretrain_val_metrics(fold=True)
    assert np.isfinite(fold["val_loss"])
    # the streaming mode's per-epoch set is the fold
    np.testing.assert_allclose(t.pretrain_val_metrics()["val_loss"],
                               fold["val_loss"], rtol=1e-6)


def test_pretrain_val_metrics_fold_takes_no_synthetic_set(tmp_path):
    """fold=True evaluates on the seed fold, so a synthetic set beside it is
    refused rather than silently ignored."""
    t = ttrainer.Trainer(own_save_dir(_port(_cfg()), tmp_path), device="cpu",
                         logger=lambda *a: None)
    with pytest.raises(ValueError, match="fold"):
        t.pretrain_val_metrics((np.zeros((1, 11)), np.zeros((1, 3))),
                               fold=True)


# ---- (e) kernel S's draws, replayed ------------------------------------------

_M0, _M1, _W0, _W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85


def _mulhilo(m: int, a: torch.Tensor):
    """(hi, lo) words of m * a for 32-bit a in int64, on 16-bit limbs."""
    t1, t2 = m * (a & 0xFFFF), m * (a >> 16)          # each < 2^48
    low = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (low >> 32), low & 0xFFFFFFFF


def _torch_philox(v: torch.Tensor, k: int, seed: int):
    c = [v & 0xFFFFFFFF, v >> 32, torch.full_like(v, k), torch.zeros_like(v)]
    k0, k1 = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    for _ in range(10):
        h0, l0 = _mulhilo(_M0, c[0])
        h1, l1 = _mulhilo(_M1, c[2])
        c = [h1 ^ c[1] ^ k0, l1, h0 ^ c[3] ^ k1, l0]
        k0, k1 = (k0 + _W0) & 0xFFFFFFFF, (k1 + _W1) & 0xFFFFFFFF
    return c


def _torch_box_muller(a, b):
    u1 = ((a >> 8) + 1).double() * 2.0 ** -24
    u2 = (b >> 8).double() * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(2 * np.pi * u2), r * torch.sin(2 * np.pi * u2)


@pytest.mark.parametrize("seed,n_taus", [(7, 11), (2 ** 40 + 3, 24),
                                         (2 ** 61 + 9, 6)])
def test_synth_draws_replay_the_counters(seed, n_taus):
    n = 37
    d = tsb.synth_philox_draws(seed, n, n_taus)
    v = torch.arange(n, dtype=torch.int64)
    blocks = [_torch_philox(v, k, seed) for k in range(3 + -(-n_taus // 4))]
    unit = lambda w: ((w >> 8).double() * 2.0 ** -24).numpy()  # noqa: E731
    for name, (k, i) in dict(sel_o=(0, 0), sel_d=(0, 1), oef_u=(0, 2),
                             dbv_u=(0, 3), dbv_n=(1, 2), mis_u=(1, 3),
                             snr_u=(2, 3)).items():
        np.testing.assert_array_equal(d[name].reshape(-1),
                                      unit(blocks[k][i]), err_msg=name)
    normals = dict(zip(("oef_n", "z_oef"), _torch_box_muller(*blocks[1][:2])))
    normals["z_dbv"] = _torch_box_muller(*blocks[2][:2])[0]
    for name, ref in normals.items():
        np.testing.assert_allclose(d[name].reshape(-1), ref.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    z = torch.cat([torch.stack(_torch_box_muller(*b[:2])
                               + _torch_box_muller(*b[2:]), -1)
                   for b in blocks[3:]], -1)[:, :n_taus]
    np.testing.assert_allclose(d["z"], z.numpy(), rtol=1e-5, atol=1e-6)
    from_idx = 4 + (((blocks[2][2] >> 8) * (n_taus - 5)) >> 24)
    np.testing.assert_array_equal(d["from_idx"].reshape(-1), from_idx.numpy())
    assert d["from_idx"].min() >= 4 and d["from_idx"].max() <= n_taus - 2


def test_synth_batch_on_the_cpu_is_the_plain_version_of_the_replay():
    cfg = _port(_cfg(misalign=0.5, uniform_prop=0.3))
    got = tsb.synth_batch(cfg, BATCH, 1234, device="cpu")
    ref = tsteps.stream_synthetic_batch(
        cfg, BATCH, tsb.synth_philox_draws(1234, BATCH * 500, 11))
    for k in ("x", "y"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy())
    y = got["y"].numpy().reshape(-1, 3)
    assert 0.05 <= y[:, 0].min() and y[:, 0].max() <= 0.8
    assert 0.003 <= y[:, 1].min() and y[:, 1].max() <= 0.195
    assert np.isfinite(got["x"].numpy()).all()
    other = tsb.synth_batch(cfg, BATCH, 1235, device="cpu")
    assert not np.array_equal(other["y"].numpy(), got["y"].numpy())


def test_synth_batch_routes_the_asymptotic_model_to_the_plain_version():
    """Kernel S decodes the full SDR model only; the asymptotic model takes
    the plain version of the same replayed draws by its config (the card's
    route is tests/test_torch_cuda.py's)."""
    cfg = _port(_cfg(full_model=False))
    got = tsb.synth_batch(cfg, BATCH, 77, device="cpu")
    ref = tsteps.stream_synthetic_batch(
        cfg, BATCH, tsb.synth_philox_draws(77, BATCH * 500, 11))
    np.testing.assert_array_equal(got["x"].numpy(), ref["x"].numpy())
    full = tsb.synth_batch(_port(_cfg()), BATCH, 77, device="cpu")
    np.testing.assert_array_equal(got["y"].numpy(), full["y"].numpy())
    assert not np.array_equal(got["x"].numpy(), full["x"].numpy())


# ---- (f) kernel S's draws against the JAX samplers, in distribution ---------

N_STAT = 200_000


def _within(name, a, b, se, k=5.0):
    assert abs(a - b) <= k * se, (f"{name}: {a} against {b}, "
                                  f"{abs(a - b) / se:.2f} standard errors")


def _var_se(v) -> float:
    """Standard error of a sample variance: sqrt((m4 - var^2) / n)."""
    c = v - v.mean()
    return float(np.sqrt(((c ** 4).mean() - (c ** 2).mean() ** 2) / v.size))


def test_replayed_batch_matches_jax_in_distribution():
    cfg = _cfg(batch=N_STAT // 500)
    clean = dataclasses.replace(
        cfg, scan=dataclasses.replace(cfg.scan, simulate_noise=False))
    key = jax.random.PRNGKey(11)
    b = cfg.train.pt_batch_size
    ref, ref0 = (jsteps.stream_synthetic_batch(key, c, b, VOL)
                 for c in (cfg, clean))
    d = tsb.synth_philox_draws(11, N_STAT, 11)
    got, got0 = (tsteps.stream_synthetic_batch(_port(c), b, d, vol_shape=VOL)
                 for c in (cfg, clean))
    y_r = np.asarray(ref["y"], np.float64).reshape(-1, 3)
    y_g = got["y"].numpy().astype(np.float64).reshape(-1, 3)
    n = N_STAT
    for i, name in enumerate(("oef", "dbv", "r2p")):
        a, r = y_g[:, i], y_r[:, i]
        _within(f"{name} mean", a.mean(), r.mean(),
                np.sqrt((a.var() + r.var()) / n))
        _within(f"{name} variance", a.var(), r.var(),
                np.hypot(_var_se(a), _var_se(r)))
        # the two CDFs at the replay's quantiles (OEF has atoms where the
        # normal is clipped to its range)
        for q in (0.01, 0.05, 0.25, 0.5, 0.75, 0.95, 0.99):
            x = np.quantile(a, q)
            pa, pr = (a <= x).mean(), (r <= x).mean()
            pm = (pa + pr) / 2
            _within(f"{name} quantile {q}", pa, pr,
                    np.sqrt(2 * pm * (1 - pm) / n))
    # the truncated normal's tails: DBV near its lower bound and far above
    # its mean (OPTIMAL: mean 0.025, std 0.02 on [0.003, 0.195])
    for lo, hi in ((0.003, 0.005), (0.08, 0.195), (0.12, 0.195)):
        pa = ((y_g[:, 1] >= lo) & (y_g[:, 1] <= hi)).mean()
        pr = ((y_r[:, 1] >= lo) & (y_r[:, 1] <= hi)).mean()
        p = (pa + pr) / 2
        _within(f"dbv in [{lo}, {hi}]", pa, pr,
                max(np.sqrt(2 * p * (1 - p) / n), 1 / n))
    noise_r = (np.asarray(ref["x"]) - np.asarray(ref0["x"])).reshape(-1, 11)
    noise_g = (got["x"] - got0["x"]).numpy().reshape(-1, 11)
    for t in range(11):
        a, r = noise_g[:, t].astype(np.float64), noise_r[:, t].astype(
            np.float64)
        _within(f"noise variance, tau {t}", a.var(), r.var(),
                np.hypot(_var_se(a), _var_se(r)))
    # misalignment: the share of misaligned voxels and the tau it starts at
    mis = _cfg(0.5, batch=N_STAT // 500)
    dj = jax_batch_draws(key, mis, n)
    p = mis.synth.misalign_prob
    _within("misaligned share", (d["mis_u"] < p).mean(),
            (dj["mis_u"] < p).mean(), np.sqrt(2 * p * (1 - p) / n))
    for k in range(4, 10):
        pa, pr = (d["from_idx"] == k).mean(), (dj["from_idx"] == k).mean()
        pm = (pa + pr) / 2
        _within(f"from_idx {k}", pa, pr, np.sqrt(2 * pm * (1 - pm) / n))
    assert d["from_idx"].min() == 4 and d["from_idx"].max() == 9
