"""The port's sweep populations (qbold_vi_tpu_torch/sweep.py) against the
JAX package's, and against their own serial oracle.

(a) ``population_pretrain`` against the JAX ``population_pretrain`` at
    tests/test_sweep.py's tiny configuration, 3 trials: a mixed
    inverse-gamma partition (two groups) and a static-key group (another
    width). The JAX run's draws replace the port's where the port draws
    them (``_Draws``, through monkeypatch): each trial's initial weights (the JAX init under fold_in(seed, 1000 + i),
    through io/from_jax.py's stacked bridge), its batches' draws from its
    key chain (fold_in(seed, 2000 + i), split(., n_steps), split(k) ->
    k_batch, read as tests/test_torch_stream_pretrain.py::jax_batch_draws
    reads them) and the validation's normals (split(PRNGKey(0)) -> the
    posterior-MSE draws). Every metric within rtol 2e-4 / atol 1e-5 (the
    JAX population's own gate against its serial run).
(b) ``population_full_run`` against the JAX function under host noise
    (JAX ``fused_elbo="host-interpret"``, the port's "host": kernel F's
    plain version), 2 trials that vary ft_lr and pt_lr, with the crops
    (JAX ``sample_crop_batch``'s indices under each step's k_crop), the
    fine-tune normals (k_step's z_nll / z_kl) and the ELBO validation's
    normals injected: rtol 5e-4 / atol 1e-5.
(c) The port's populations against their ``serial=True`` oracle (the
    default seeds; host noise, and the device noise of kernel F's plain
    version on the CPU, each trial's rows at its own Philox counters):
    equal to rtol 2e-4 / 5e-4, and the trials distinct.
(d) One population Adam / AdamW step (``sweep._StackedAdam``), given
    gradients, against the JAX population's formulas (optax scale_by_adam,
    then -lr u - wd p, the decay masked to the encoder; b2 0.9 and no mask
    for the fine-tune) at rtol 1e-6; the stacked bridge round trip.
(e) The routing spy of tests/test_sweep.py:772-795 (random_search with
    run_fn=full_run and parallel_trials 3 makes one population call of 3),
    and a population's kernels through counting shims: one F forward and
    one F backward a population step whatever P, one S call a pretrain
    step.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_stream_pretrain as tsp  # noqa: E402
from qbold_vi_tpu import config as jcfg  # noqa: E402
from qbold_vi_tpu import sweep as jsweep  # noqa: E402
from qbold_vi_tpu.models.vi import FineTuner as JFineTuner  # noqa: E402
from qbold_vi_tpu_torch import sweep as tsweep  # noqa: E402
from qbold_vi_tpu_torch.io import from_jax  # noqa: E402

PT_TOL = dict(rtol=2e-4, atol=1e-5)
FT_TOL = dict(rtol=5e-4, atol=1e-5)


def _cfg(tmp_path, data_dir=None, **train):
    """tests/test_sweep.py's population configuration."""
    kw = dict(no_pt_epochs=1, pt_batch_size=4, save_directory=str(tmp_path),
              swa_start=1, swa_period=1)
    if data_dir is not None:
        kw.update(no_ft_epochs=1, ft_batch_size=2, ft_steps_per_epoch=2,
                  crop_size=6, data_directory=data_dir)
    kw.update(train)
    return jcfg.QBoldConfig(
        scan=jcfg.ScanParams(simulate_noise=False),
        synth=jcfg.SynthParams(sample_size=40),
        model=jcfg.ModelConfig(no_units=4, no_intermediate_layers=1,
                               use_mvg=True, student_t_df=200.0,
                               predict_log_data=False),
        train=jcfg.TrainConfig(**kw))


def _data_dir(tmp_path, with_study=True):
    """tests/test_sweep.py::TestPopulationFullRun._data_dir's volumes."""
    rng = np.random.default_rng(7)
    t = jcfg.ScanParams(simulate_noise=False).n_taus
    d = tmp_path / "data"
    d.mkdir()
    vols = np.abs(rng.normal(size=(3, 40, 30, 2, t + 1))
                  ).astype(np.float32) * 50 + 100
    vols[..., -1] = 1.0
    np.save(d / "ASE_scan.npy", vols)
    if with_study:
        study = np.abs(rng.normal(size=(2, 12, 12, 2, t + 2))
                       ).astype(np.float32) * 50 + 100
        study[..., -2:] = 1.0
        np.save(d / "hyperv_ase.npy", study)
        np.save(d / "baseline_ase.npy", study + 1.0)
    return str(d)


def _normals(key, n, shape):
    """n standard normals of ``shape`` from split(key, n): the JAX
    sample_many / mvg_kl_samples draws."""
    return np.array(jax.vmap(lambda k: jax.random.normal(k, shape))(
        jax.random.split(key, n)))


def _groups(cfg, trials, traced):
    """The JAX population's groups: {static overrides: [trial indices]}."""
    out = {}
    for i, ov in enumerate(trials):
        static = tuple(sorted((k, v) for k, v in ov.items()
                              if k not in traced))
        out.setdefault((static, tsweep._ig_on(tsp._port(cfg), ov)),
                       []).append(i)
    return out


@functools.lru_cache(maxsize=None)
def _jax_init(model, scan):
    """The JAX FineTuner's jitted init for a model (one compile)."""
    return jax.jit(JFineTuner(model, scan).init)


class _Draws:
    """The JAX run's draws, put where the port draws its own: each seed the
    port's population draws under (its keys' counterparts) mapped to the
    JAX draws of that key. ``install`` replaces, through ``monkeypatch``,
    ``models.vi.init_params`` (keyed by the generator's seed and the
    width), ``ops.synth_batch.synth_batch`` (each trial's batch seed ->
    the plain version on the JAX draws), ``steps.normals`` (every normal
    the loss, the validation and the fine-tune step draw from a seed) and
    ``steps.sample_crop_batch`` (each trial's crops, step by step)."""

    def __init__(self):
        self.init, self.batch, self.normals = {}, {}, {}
        self.crops, self.crop_normals = {}, {}

    def install(self, monkeypatch):
        from qbold_vi_tpu_torch.models import vi as tvi
        from qbold_vi_tpu_torch.ops import synth_batch as tsb
        from qbold_vi_tpu_torch.train import steps as tsteps

        real_normals, real_crops = tsteps.normals, tsteps.sample_crop_batch
        calls = {}

        def init_params(model, scan, generator):
            return self.init[(generator.initial_seed(), model.no_units)]

        def synth_batch(cfg, b, seed=None, *, seeds, device, vol_shape):
            parts = [tsteps.stream_synthetic_batch(
                cfg, b, self.batch[sd], device=device, vol_shape=vol_shape)
                for sd in seeds]
            return {k: torch.stack([q[k] for q in parts]) for k in parts[0]}

        def normals(seed, shape, device):
            if seed not in self.normals:
                return real_normals(seed, shape, device)
            return torch.as_tensor(self.normals[seed], dtype=torch.float32
                                   ).to(device).reshape(shape)

        def sample_crop_batch(gen, vols, priors, b, crop_size, *a):
            real_crops(gen, vols, priors, b, crop_size, *a)   # its draws
            # the step seed the population draws next from the generator
            peek = torch.Generator()
            peek.set_state(gen.get_state())
            step_seed = int(torch.randint(0, tsteps._SEED_HI, (1,),
                                          generator=peek))
            trial = gen.initial_seed()
            step = calls[trial] = calls.get(trial, -1) + 1
            sp = tsteps._split_seed(step_seed, 4)
            z_nll, z_kl = self.crop_normals[trial][step]
            self.normals.update({sp[0]: z_nll, sp[1]: z_kl})
            return tsteps.take_crops(vols, priors, self.crops[trial][step],
                                     crop_size)

        monkeypatch.setattr(tvi, "init_params", init_params)
        monkeypatch.setattr(tsb, "synth_batch", synth_batch)
        monkeypatch.setattr(tsteps, "normals", normals)
        monkeypatch.setattr(tsteps, "sample_crop_batch", sample_crop_batch)


def _pt_draws(cfg, trials, traced=tsweep._POP_KEYS) -> _Draws:
    """The JAX population_pretrain's draws under the port's seeds: each
    trial's JAX initial weights (in a group's stacked tree, through the
    stacked bridge), its batches' draws and loss normals, the validation
    normals."""
    from qbold_vi_tpu_torch.train import steps as tsteps

    seed = cfg.train.seed
    base = jax.random.PRNGKey(seed)
    vol = 500
    n = cfg.train.pt_batch_size * vol
    n_steps = cfg.train.no_pt_epochs * max(1, round(
        0.9 * cfg.synth.sample_size ** 2 / vol / cfg.train.pt_batch_size))
    d = _Draws()
    for (static, _), idxs in _groups(cfg, trials, traced).items():
        gcfg = jcfg.apply_flat_overrides(cfg, dict(static))
        init = _jax_init(gcfg.model, gcfg.scan)
        sample = jnp.zeros((1, 2, 2, 1, gcfg.scan.n_taus), jnp.float32)
        # jax.random is vmap-invariant: key by key, the population's
        # vmapped init
        trees = [init(jax.random.fold_in(base, 1000 + j), sample)
                 for j in range(len(idxs))]
        inits = from_jax.stacked_state_dict_from_jax(jax.tree_util.tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees))
        for j in range(len(idxs)):
            d.init[(tsteps.fold_seed(seed, 1000 + j), gcfg.model.no_units)] = {
                k: v[j] for k, v in inits.items()}
            keys = jax.random.split(jax.random.fold_in(base, 2000 + j),
                                    n_steps)
            seeds = tsteps._split_seed(tsteps.fold_seed(seed, 2000 + j),
                                       n_steps)
            for k, sd in zip(keys, seeds):
                s_batch, s_loss = tsteps._split_seed(sd, 2)
                d.batch[s_batch] = tsp.jax_batch_draws(
                    jax.random.split(k)[0], gcfg, n)
                noise = tsp.jax_loss_noise(k, gcfg, n)
                if noise is not None:
                    d.normals[s_loss] = noise["z_r2p"]
    from qbold_vi_tpu.train.trainer import pretrain_val_fold, val_batch_count

    vx, _ = pretrain_val_fold(cfg)
    n_val = val_batch_count(len(vx), int(np.prod(vx.shape[1:4])))
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    s_r2p, s_mse = tsteps._split_seed(0, 2)   # the validation's seed 0
    d.normals[s_mse] = _normals(k2, 20, vx[:n_val].shape[:4] + (2,))
    if cfg.train.use_r2p_loss:
        d.normals[s_r2p] = _normals(jax.random.split(k1)[0], 10,
                                    (n_val * vol, 2))
    return d


def _assert_metrics(got, ref, keys, tol):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        for k in keys:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


PT_TRIALS = {
    "inverse-gamma": [
        {"pt_lr": 1e-3, "inv_gamma_alpha": 1.0, "inv_gamma_beta": 2.0},
        {"pt_lr": 5e-4, "inv_gamma_alpha": 0.0, "inv_gamma_beta": 0.0},
        {"pt_lr": 2e-3, "inv_gamma_alpha": 0.5, "inv_gamma_beta": 0.5}],
    "static-key": [
        {"pt_lr": 1e-3, "no_units": 4},
        {"pt_lr": 1e-3, "no_units": 6},
        {"pt_lr": 5e-4, "no_units": 4, "pt_adamw_decay": 1e-3}],
}


# ---- (a) the pretrain population against JAX -----------------------------

@pytest.mark.parametrize("case", sorted(PT_TRIALS))
def test_population_pretrain_matches_jax(tmp_path, monkeypatch, case):
    trials = PT_TRIALS[case]
    cfg = _cfg(tmp_path)
    ref = jsweep.population_pretrain(cfg, trials)
    _pt_draws(cfg, trials).install(monkeypatch)
    got = tsweep.population_pretrain(tsp._port(cfg), trials, device="cpu")
    assert [set(g) for g in got] == [set(r) for r in ref]
    _assert_metrics(got, ref, ref[0], PT_TOL)
    assert len({round(r["val_elbo"], 6) for r in got}) == 3


# ---- (b) the full-run population against JAX ------------------------------

def _ft_draws(cfg, trials, d: _Draws) -> _Draws:
    """Adds the JAX population_full_run's fine-tune draws to ``d``: each
    trial's crop indices and step normals (ft keys fold_in(seed, 3000 + i),
    split(., total), split(k) -> k_crop, k_step), and the ELBO
    validation's normals (fold_in(PRNGKey(0), b))."""
    from qbold_vi_tpu.train import data as jdata
    from qbold_vi_tpu_torch.train import steps as tsteps

    tr, model = cfg.train, cfg.model
    base = jax.random.PRNGKey(tr.seed)
    real = jdata.load_real_directory(tr.data_directory)
    vols = jdata.blank_crop(real["train"])
    s_n, x_n, y_n = vols.shape[:3]
    cx, cy = min(tr.crop_size, x_n), min(tr.crop_size, y_n)
    vox = (tr.ft_batch_size, cx, cy, vols.shape[3])
    total = tr.no_ft_epochs * tr.ft_steps_per_epoch
    for (_, _), idxs in _groups(cfg, trials, tsweep._POP_FT_KEYS).items():
        for j in range(len(idxs)):
            crops, normals = [], []
            for k in jax.random.split(jax.random.fold_in(base, 3000 + j),
                                      total):
                k_crop, k_step = jax.random.split(k)
                k_s, k_x, k_y = jax.random.split(k_crop, 3)
                b = tr.ft_batch_size
                crops.append(np.stack([
                    np.asarray(jax.random.randint(k_s, (b,), 0, s_n)),
                    np.asarray(jax.random.randint(k_x, (b,), 0,
                                                  x_n - cx + 1)),
                    np.asarray(jax.random.randint(k_y, (b,), 0,
                                                  y_n - cy + 1))]))
                k_sample, k_kl = jax.random.split(k_step)
                k_draw = jax.random.split(k_sample)[0]
                n = int(np.prod(vox))
                normals.append((_normals(k_draw, model.no_samples, (n, 2)),
                                _normals(k_kl, 70, (n, 2))))
            trial = tsteps.fold_seed(tr.seed, 3000 + j)
            d.crops[trial], d.crop_normals[trial] = crops, normals
    study = real["study"]
    ev = study if study is not None else vols
    b_eval = tr.eval_batch_size
    n_full = ev.shape[0] // b_eval
    shapes = ([ev.shape[0]] if n_full == 0 else [b_eval] * min(4, n_full))
    for bi, n_b in enumerate(shapes):
        evox = (n_b, min(76, ev.shape[1]), min(76, ev.shape[2]), ev.shape[3])
        k_kl, *keys = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(0), bi), 11)
        seeds = tsteps._split_seed(tsteps.fold_seed(0, bi), 11)
        d.normals[seeds[0]] = _normals(k_kl, 70, evox + (2,))
        for sd, k in zip(seeds[1:], keys):
            d.normals[sd] = _normals(jax.random.split(k)[0],
                                     model.no_samples, evox + (2,))
    return d


FT_KEYS = ("val_elbo", "val_nll", "val_kl", "val_smoothness", "loss",
           "pt_val_loss")


def test_population_full_run_matches_jax(tmp_path, monkeypatch):
    cfg = _cfg(tmp_path, _data_dir(tmp_path), fused_elbo="host-interpret")
    trials = [{"pt_lr": 1e-3, "ft_lr": 2e-3}, {"pt_lr": 5e-4, "ft_lr": 1e-3}]
    ref = jsweep.population_full_run(cfg, trials)
    _ft_draws(cfg, trials, _pt_draws(cfg, trials, tsweep._POP_FT_KEYS)
              ).install(monkeypatch)
    port = tsp._port(dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fused_elbo="host")))
    got = tsweep.population_full_run(port, trials, device="cpu")
    assert [set(g) for g in got] == [set(r) for r in ref]
    assert all(g["status"] == "FULL_TRAINED" for g in got)
    _assert_metrics(got, ref, FT_KEYS, FT_TOL)
    assert got[0]["val_elbo"] != got[1]["val_elbo"]


# ---- (c) the serial oracle ----------------------------------------------------

def test_population_pretrain_matches_its_serial_run(tmp_path):
    cfg = tsp._port(_cfg(tmp_path))
    trials = PT_TRIALS["inverse-gamma"]
    pop = tsweep.population_pretrain(cfg, trials, device="cpu")
    ser = tsweep.population_pretrain(cfg, trials, device="cpu", serial=True)
    _assert_metrics(pop, ser, pop[0], PT_TOL)
    assert len({round(r["val_elbo"], 6) for r in pop}) == 3


@pytest.mark.parametrize("fused", ["host", "on"])
def test_population_full_run_matches_its_serial_run(tmp_path, fused):
    """Kernel F's plain version over the folded rows of all trials: host
    normals travel with their rows, and under device noise ("on": one seed
    of the group a step) trial i draws from the counters of rows i N ...
    whether it runs with the others or alone, so the population equals its
    serial run under both."""
    cfg = tsp._port(_cfg(tmp_path, _data_dir(tmp_path), fused_elbo=fused))
    trials = [{"pt_lr": 1e-3, "ft_lr": 2e-3}, {"pt_lr": 5e-4, "ft_lr": 1e-3},
              {"ft_lr": 5e-3, "adamw_decay": 1e-3}]
    pop = tsweep.population_full_run(cfg, trials, device="cpu")
    ser = tsweep.population_full_run(cfg, trials, device="cpu", serial=True)
    _assert_metrics(pop, ser, FT_KEYS, FT_TOL)
    assert len({round(r["val_elbo"], 6) for r in pop}) == len(trials)


def test_population_full_run_without_study_sets(tmp_path):
    cfg = tsp._port(_cfg(tmp_path, _data_dir(tmp_path, with_study=False)))
    with pytest.warns(UserWarning, match="study sets"):
        out = tsweep.population_full_run(cfg, [{"ft_lr": 2e-3}],
                                         device="cpu")
    assert out[0]["val_elbo"] == out[0]["train_elbo"]
    assert np.isfinite(out[0]["val_elbo"])


def test_a_mixed_inverse_gamma_batch_raises(tmp_path):
    with pytest.raises(ValueError, match="inverse-gamma"):
        tsweep._population_group(
            tsp._port(_cfg(tmp_path)),
            [{"inv_gamma_alpha": 1.0, "inv_gamma_beta": 1.0},
             {"inv_gamma_alpha": 0.0}], (10, 10, 5), False, device="cpu")


# ---- (d) the update and the bridge ---------------------------------------------

@pytest.mark.parametrize("phase", ["pretrain", "finetune"])
def test_population_update_matches_the_jax_formulas(phase):
    import optax

    from qbold_vi_tpu.train import optim as joptim

    rng = np.random.default_rng(3)
    p_n = 3
    params = {"encoder": {"Dense_0": {
        "kernel": rng.normal(size=(p_n, 5, 4)).astype(np.float32),
        "bias": rng.normal(size=(p_n, 4)).astype(np.float32)}},
        "pop_prior": rng.normal(size=(p_n, 5)).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(size=a.shape).astype(np.float32), params)
        for _ in range(2)]
    lr = np.array([1e-3, 5e-4, 2e-3], np.float32)
    wd = np.array([1e-2, 0.0, 3e-3], np.float32)
    b2 = 0.999 if phase == "pretrain" else 0.9
    adam = optax.scale_by_adam(b2=b2, eps=1e-7)

    def jax_step(p, g, state, lr_t, wd_t):
        u, state = adam.update(g, state)
        mask = (joptim._encoder_only(p) if phase == "pretrain"
                else jax.tree_util.tree_map(lambda _: True, p))
        u = jax.tree_util.tree_map(
            lambda uu, pp, m: -lr_t * uu - (wd_t * pp if m else 0.0), u, p,
            mask)
        return optax.apply_updates(p, u), state

    ref = []
    for j in range(p_n):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a[j]), params)
        state = adam.init(p)
        for g in grads:
            p, state = jax_step(p, jax.tree_util.tree_map(
                lambda a: jnp.asarray(a[j]), g), state, lr[j], wd[j])
        ref.append(jax.tree_util.tree_map(np.asarray, p))
    flat = lambda t: {k.replace("/", "."): torch.from_numpy(  # noqa: E731
        np.array(v)) for k, v in from_jax.flatten_params(t).items()}
    stacked = flat(params)
    opt = tsweep._StackedAdam(stacked, b2=b2)
    decay = ({k: k.startswith("encoder.") for k in stacked}
             if phase == "pretrain" else None)
    for g in grads:
        opt.step(stacked, flat(g), torch.from_numpy(lr), torch.from_numpy(wd),
                 decay)
    for j in range(p_n):
        for k, v in flat(ref[j]).items():
            np.testing.assert_allclose(stacked[k][j].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


def test_stacked_bridge_round_trip(tmp_path):
    cfg = _cfg(tmp_path)
    init = _jax_init(cfg.model, cfg.scan)
    sample = jnp.zeros((1, 2, 2, 1, cfg.scan.n_taus), jnp.float32)
    trees = [init(k, sample) for k in jax.random.split(
        jax.random.PRNGKey(1), 3)]
    tree = jax.tree_util.tree_map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)
    sd = from_jax.stacked_state_dict_from_jax(tree)
    for j in range(3):
        one = from_jax.state_dict_from_jax(jax.tree_util.tree_map(
            lambda a: a[j], tree))
        for k, v in one.items():
            assert torch.equal(sd[k][j], v), k
    back = from_jax.flatten_params(from_jax.jax_from_stacked_state_dict(sd))
    for k, v in from_jax.flatten_params(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


# ---- (e) routing and kernel launches --------------------------------------------

def test_search_routes_full_run_through_population(tmp_path, monkeypatch):
    cfg = tsp._port(_cfg(tmp_path, _data_dir(tmp_path)))
    calls = []
    real = tsweep.population_full_run

    def spy(cfg_, ovs, *a, **kw):
        calls.append(len(ovs))
        return real(cfg_, ovs, *a, **kw)

    monkeypatch.setattr(tsweep, "population_full_run", spy)
    res = tsweep.random_search(
        cfg, {"ft_lr": ("log_uniform", 1e-4, 5e-3)}, n_trials=3,
        run_fn=tsweep.full_run, parallel_trials=3, seed=0, device="cpu")
    assert calls == [3]
    vals = [r["val_elbo"] for r in res]
    assert vals == sorted(vals)
    assert all(r["status"] == "FULL_TRAINED" for r in res)


def test_population_full_run_through_g_matches_its_serial_run(tmp_path):
    """A diagonal posterior with a population prior (the configuration F
    leaves out) routes to kernel G: its rows of every trial in one call,
    each trial's terms its own, equal to the serial run."""
    from qbold_vi_tpu_torch.ops import decode_nll as dn

    cfg = _cfg(tmp_path, _data_dir(tmp_path), fused_decode_nll="on")
    cfg = tsp._port(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_mvg=False, use_population_prior=True)))
    trials = [{"ft_lr": 2e-3}, {"ft_lr": 5e-3, "adamw_decay": 1e-3}]
    calls = []
    real = dn.decode_nll_rows

    def spy(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        from qbold_vi_tpu_torch.train import steps as tst
        mp.setattr(tst, "decode_nll_rows", spy)
        pop = tsweep.population_full_run(cfg, trials, device="cpu")
        total = cfg.train.no_ft_epochs * cfg.train.ft_steps_per_epoch
        assert len(calls) == total                  # one call a step
        ser = tsweep.population_full_run(cfg, trials, device="cpu",
                                         serial=True)
    assert len(calls) == 3 * total and calls[0] == 2 * calls[-1]
    _assert_metrics(pop, ser, FT_KEYS, FT_TOL)
    assert pop[0]["val_elbo"] != pop[1]["val_elbo"]


@pytest.mark.parametrize("p_n", [1, 3])
def test_population_step_calls_f_once_whatever_p(tmp_path, monkeypatch, p_n):
    """Counting shims around kernel F's wrappers and kernel S: a population
    fine-tune step calls F forward once and backward once for all its
    trials, and a pretrain step draws every trial's batch in one S call
    (on the CPU the wrappers run their plain versions)."""
    from qbold_vi_tpu_torch.ops import fused_elbo as fe
    from qbold_vi_tpu_torch.ops import synth_batch as sb

    counts = {"fwd": 0, "bwd": 0, "S": 0, "S_trials": []}
    fwd, bwd, synth = (fe.fused_elbo_forward, fe.fused_elbo_backward,
                       sb.synth_batch)

    def count(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            if name == "S":
                counts["S_trials"].append(len(kw["seeds"]))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fe, "fused_elbo_forward", count("fwd", fwd))
    monkeypatch.setattr(fe, "fused_elbo_backward", count("bwd", bwd))
    monkeypatch.setattr(sb, "synth_batch", count("S", synth))
    cfg = tsp._port(_cfg(tmp_path, _data_dir(tmp_path), fused_elbo="on"))
    trials = [{"ft_lr": 1e-3 * (j + 1)} for j in range(p_n)]
    out = tsweep.population_full_run(cfg, trials, device="cpu")
    total = cfg.train.no_ft_epochs * cfg.train.ft_steps_per_epoch
    assert counts["fwd"] == counts["bwd"] == total
    assert counts["S"] == 1 and counts["S_trials"] == [p_n]
    assert all(np.isfinite(r["val_elbo"]) for r in out)
