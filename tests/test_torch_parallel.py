"""The port's data-parallel layer (qbold_vi_tpu_torch/parallel, the
sharded steps, maps and Trainer) against the JAX package's shard_map
paths, on gloo ranks on the CPU.

(a) Layouts: ``_device_crop_counts``, ``_subject_shard_counts`` and
    ``host_local_rows`` equal the JAX functions exactly over a grid of
    (batch, ranks, subjects), 1-8 ranks.
(b) Steps: JAX ``make_finetune_epoch_sharded(n_steps=1)``,
    ``make_finetune_epoch_subject_sharded`` and
    ``make_pretrain_stream_step_sharded`` run on 2- and 3-device slices of
    the conftest's 8-device CPU mesh; the port's sharded step runs on 2 and
    3 gloo ranks (tests/torch_rank_cases.py), each rank given its JAX
    device's crops (JAX ``sample_crop_batch`` under the folded key) or
    synthetic draws, and its normals. Uneven batches (5 crops / volumes
    over 2 and 3 ranks), kernel F's plain version ("on") and the plain
    path, and the diagonal-posterior population-prior configuration
    (kernel G's plain version, whose hyperprior cost counts live crops).
    Tolerances of tests/test_torch_train.py: the loss and its terms at
    rtol 1e-5; each updated weight within 1e-6 + 1e-4 of the JAX update
    where the global gradient is clear of 0, and within 2 lr everywhere
    (Adam's first step is ~lr sign(g)). The ranks' weights bit-equal.
(c) Maps: the port's ``posterior_maps_sharded`` (quadrature, both
    streams, and mc) and ``elbo_maps_sharded`` (with and without priors)
    of 5 subjects over 2 and 3 ranks against its single-process maps, the
    quadrature maps against JAX ``posterior_maps_sharded`` too, at
    tests/test_torch_infer.py's tolerances; ``save_predictions(mesh=)``
    writes on rank 0 only.
(d) ``Trainer(mesh=)`` on 2 ranks: a streaming pretrain, then finetune
    with ft_shard_subjects "on" and "off"; only rank 0 logs and writes;
    metrics and weights replicated; a plain Trainer resumes the checkpoint.
(e) The sweep's populations with 3 trials split over the 2 ranks
    (sweep.population_pretrain(mesh=), and population_full_run(mesh=) under
    kernel F's device noise), against one process.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_torch_stream_pretrain as tsp  # noqa: E402
from torch_parity_utils import (assert_vars_close, port_params,  # noqa: E402
                                port_tuner)
from qbold_vi_tpu import infer as jinfer  # noqa: E402
from qbold_vi_tpu.config import (ModelConfig, QBoldConfig,  # noqa: E402
                                 ScanParams, TrainConfig)
from qbold_vi_tpu.parallel import mesh as jmesh  # noqa: E402
from qbold_vi_tpu.train import optim as joptim  # noqa: E402
from qbold_vi_tpu.train import steps as jsteps  # noqa: E402
from qbold_vi_tpu.train.steps import TrainState  # noqa: E402
from qbold_vi_tpu_torch import infer as tinfer  # noqa: E402
from qbold_vi_tpu_torch.io import from_jax  # noqa: E402
from qbold_vi_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from qbold_vi_tpu_torch.parallel import multihost  # noqa: E402
from qbold_vi_tpu_torch.parallel.multihost import launch_workers  # noqa: E402
from qbold_vi_tpu_torch.train import steps as tsteps  # noqa: E402
from qbold_vi_tpu_torch.train.trainer import Trainer, WeightStatus  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
SCAN = ScanParams(simulate_noise=False)
MODEL = ModelConfig(no_units=4, no_intermediate_layers=1, student_t_df=200.0,
                    predict_log_data=False, multi_image_normalisation=False,
                    use_mvg=True, gate_offset=-3.0)
POP_MODEL = dataclasses.replace(MODEL, use_mvg=False,
                                use_population_prior=True)
MAP_MODEL = ModelConfig(no_units=8, no_intermediate_layers=1)
INFER_TOL = dict(rtol=1e-3, atol=3e-5)        # tests/test_torch_infer.py
B, CROP = 5, 4                                # crops: 5 over 2 and 3 ranks
KEY = jax.random.PRNGKey(8)


# ---- (a) layouts ------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_crop_counts_match_jax(n):
    for b in (1, 3, 5, 7, 37, 38, 512):
        assert tsteps._device_crop_counts(b, n) == \
            jsteps._device_crop_counts(b, n)
        lo_hi = [tmesh.crop_rows(b, n, d) for d in range(n)]
        b_local, (base, rem) = jsteps._device_crop_counts(b, n)
        assert [hi - lo for lo, hi in lo_hi] == \
            [base + (d < rem) for d in range(n)]
        assert lo_hi[0][0] == 0 and lo_hi[-1][1] == b
        assert all(a[1] == c[0] for a, c in zip(lo_hi, lo_hi[1:]))


@pytest.mark.parametrize("n", range(1, 9))
def test_subject_shard_counts_match_jax(n):
    for s in range(1, 2 * n + 2):
        for b in (1, 5, 38):
            assert tsteps._subject_shard_counts(s, n, b) == \
                jsteps._subject_shard_counts(s, n, b), (s, b)


@pytest.mark.parametrize("n", range(1, 9))
def test_host_local_rows_match_jax(n):
    """Rank d's rows are JAX device d's under the leading-axis sharding of
    an n-device mesh; a row count n does not divide is refused by both."""
    mesh = jmesh.make_mesh(jax.devices()[:n])
    for rows in (n, 2 * n, 38 * n, 38, 5, 1):
        sharding = jmesh.batch_sharding(mesh, 2)
        ranks = [tmesh.Mesh(n, d, torch.device("cpu")) for d in range(n)]
        if rows % n:
            with pytest.raises(ValueError):
                sharding.devices_indices_map((rows, 3))
            with pytest.raises(ValueError, match="divide"):
                tmesh.host_local_rows(ranks[0], (rows, 3))
            continue
        want = [(s[0].start or 0, rows if s[0].stop is None else s[0].stop)
                for s in sharding.devices_indices_map((rows, 3)).values()]
        assert [tmesh.host_local_rows(m, (rows, 3)) for m in ranks] == want
        # a single process owns every device: JAX's host range is (0, rows)
        assert jmesh.host_local_rows(sharding, (rows, 3)) == \
            tmesh.host_local_rows(tmesh.Mesh(1, 0, torch.device("cpu")),
                                  rows)


def test_one_rank_mesh_without_a_group():
    """make_mesh without a process group is one rank whose collectives
    are the identity; shard_batch_local checks the rows it is given."""
    mesh = tmesh.make_mesh("cpu")
    assert (mesh.world_size, mesh.rank, mesh.grouped) == (1, 0, False)
    x = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = tmesh.shard_batch(mesh, {"x": x, "t": [x]})
    assert torch.equal(got["x"], torch.from_numpy(x))
    assert torch.equal(got["t"][0], torch.from_numpy(x))
    assert torch.equal(tmesh.replicate(mesh, x), torch.from_numpy(x))
    s, = tmesh.all_reduce_sum(mesh, [torch.ones(2)])
    assert torch.equal(s, torch.ones(2))
    assert torch.equal(tmesh.all_gather_rows(mesh, got["x"]), got["x"])
    two = tmesh.Mesh(2, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match=r"process 1 passed 3 local rows "
                       r"but its devices own rows \[2, 4\) of 4"):
        tmesh.shard_batch_local(two, {"x": x[:3]}, 4)
    assert tmesh.initialize_distributed(None) is None


# ---- the JAX references and the port's ranks ---------------------------------

def _draws(k, s, shape):
    return np.array(jax.vmap(lambda kk: jax.random.normal(
        kk, shape + (2,)))(jax.random.split(k, s)))


def _sd(tree):
    return from_jax.state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               tree))


def _port_cfg(cfg, **train):
    return tsp._port(dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, **train)))


def _cohort(rng, shape, n_taus, p=0.2):
    vols = (np.abs(rng.normal(size=shape + (n_taus + 1,))) * 50 + 100
            ).astype(np.float32)
    vols[..., -1] = rng.uniform(size=shape) > p
    return vols


def _jax_ft(n, model, subject_sharded=False):
    """JAX's 1-step sharded epoch on an n-device mesh, its per-device
    crops and normals, and the global gradient at the start (the sum of
    each device's mask-weighted local gradient)."""
    from qbold_vi_tpu.train.steps import _finetune_terms

    cfg = QBoldConfig(scan=SCAN, model=model, train=TrainConfig(
        ft_batch_size=B, crop_size=CROP, fused_elbo="off",
        fused_decode_nll="off"))
    jt, params = port_params(model, SCAN, seed=4)
    k = 5 if model.use_mvg else 4
    rng = np.random.default_rng(21)
    vols = _cohort(rng, (3, 7, 6, 2), SCAN.n_taus)
    priors = (rng.normal(size=(3, 7, 6, 2, k)) * 0.3).astype(np.float32)
    mesh = jmesh.make_mesh(jax.devices()[:n])
    opt = joptim.make_finetune_optimizer(cfg.train)
    p0 = jax.tree_util.tree_map(jnp.array, params)
    state = jmesh.replicate(mesh, TrainState(p0, opt.init(p0), None,
                                             jnp.zeros([], jnp.int32)))
    if subject_sharded:
        s_pad, subj, crops, b_local = jsteps._subject_shard_counts(3, n, B)
        pad = np.zeros((s_pad,) + vols.shape[1:], np.float32)
        pad[:3] = vols
        ppad = np.zeros((s_pad,) + priors.shape[1:], np.float32)
        ppad[:3] = priors
        sh = jmesh.shard_batch(mesh, {"v": pad, "p": ppad})
        new, m = jsteps.make_finetune_epoch_subject_sharded(
            jt, cfg, opt, 1, mesh, 3)(state, KEY, sh["v"], sh["p"])
        chunk = s_pad // n
        local = [(pad[d * chunk:(d + 1) * chunk],
                  ppad[d * chunk:(d + 1) * chunk], subj[d], crops[d])
                 for d in range(n)]
    else:
        new, m = jsteps.make_finetune_epoch_sharded(jt, cfg, opt, 1, mesh)(
            state, KEY, jmesh.replicate(mesh, vols),
            jmesh.replicate(mesh, priors))
        b_local, (base, rem) = jsteps._device_crop_counts(B, n)
        local = [(vols, priors, None, base + (d < rem)) for d in range(n)]
    grad_fn = jax.jit(jax.grad(lambda pp, k_, jb: _finetune_terms(
        pp, k_, jb, jt, cfg)[0]))
    batches, noises, grads, masses = [], [], [], []
    for d, (v, p, n_subj, n_live) in enumerate(local):
        kd = jax.random.split(jax.random.fold_in(KEY, d), 1)[0]
        k_crop, k_step = jax.random.split(kd)
        batch = {key: np.array(val) for key, val in jsteps.sample_crop_batch(
            k_crop, jnp.asarray(v), jnp.asarray(p), b_local, CROP,
            n_subjects=n_subj).items()}
        live = (np.arange(b_local) < n_live).astype(np.float32)
        batch["mask"] = batch["mask"] * live[:, None, None, None, None]
        batch["live"] = live
        k_sample, k_kl = jax.random.split(k_step)
        shape = batch["mask"].shape[:-1]
        noise = {"z_nll": _draws(jax.random.split(k_sample)[0],
                                 model.no_samples, shape)}
        if model.use_mvg:
            noise["z_kl"] = _draws(k_kl, 70, shape)
        jb = {key: jnp.asarray(val) for key, val in batch.items()}
        grads.append(_sd(grad_fn(params, k_step, jb)))
        masses.append(float(batch["mask"].sum()))
        batches.append(batch)
        noises.append(noise)
    total = sum(masses)
    grad = {key: sum(g[key] * (w / total) for g, w in zip(grads, masses))
            for key in grads[0]}
    ref = {"metrics": {key: float(np.asarray(val)[0])
                       for key, val in m.items()},
           "params": _sd(new.params), "grad": grad,
           "before": from_jax.state_dict_from_jax(params),
           "lr": cfg.train.ft_lr}
    return cfg, params, batches, noises, ref


def _jax_stream(n):
    """JAX's sharded streaming step on an n-device mesh, each device's
    draws and R2' normals, and the global gradient at the start."""
    cfg = tsp._cfg(batch=B, use_r2p_loss=True)
    jt, params = port_params(cfg.model, cfg.scan, seed=2)
    opt, state = tsp._jax_state(cfg, params)
    mesh = jmesh.make_mesh(jax.devices()[:n])
    new, m = jsteps.make_pretrain_stream_step_sharded(jt, cfg, opt, mesh)(
        jmesh.replicate(mesh, state), KEY)
    b_local, (base, rem) = jsteps._device_crop_counts(B, n)
    vox = b_local * int(np.prod(tsp.VOL))
    grad_fn = jax.jit(jax.grad(lambda pp, kb, kl, live: jsteps._pretrain_loss(
        pp, kl, jsteps.stream_synthetic_batch(kb, cfg, b_local, tsp.VOL),
        jt, cfg, live) * jnp.sum(live)))
    draws, noises, parts, dens = [], [], [], []
    for d in range(n):
        kd = jax.random.fold_in(KEY, d)
        k_batch, k_loss = jax.random.split(kd)
        live = jnp.asarray(np.arange(b_local) < base + (d < rem), jnp.float32)
        parts.append(_sd(grad_fn(jax.tree_util.tree_map(jnp.asarray, params),
                                 k_batch, k_loss, live)))
        dens.append(float(np.sum(live)))
        draws.append(tsp.jax_batch_draws(k_batch, cfg, vox))
        noises.append(tsp.jax_loss_noise(kd, cfg, vox))
    grad = {key: sum(p[key] for p in parts) / sum(dens) for key in parts[0]}
    ref = {"metrics": {"loss": float(m["loss"])},
           "params": _sd(new.params), "grad": grad,
           "before": from_jax.state_dict_from_jax(params),
           "lr": cfg.train.pt_lr}
    return cfg, params, draws, noises, ref


def _map_inputs():
    rng = np.random.default_rng(3)
    data = _cohort(rng, (5, 6, 6, 2), SCAN.n_taus, p=0.3)
    priors = (rng.normal(size=(5, 6, 6, 2, 5)) * 0.3).astype(np.float32)
    jt, params = port_params(MAP_MODEL, SCAN, seed=5)
    return jt, params, data, priors


# every kind on 2 or 3 ranks (the fine-tune and streaming steps on both);
# the subject-sharded step with 3 subjects over 2 ranks (one a partial
# shard), the population prior's over 3 (a rank with 1 live crop of 2)
FT_CASES = [("ft", 2, "F"), ("ft", 2, "plain"), ("ft", 3, "F"),
            ("ft", 3, "plain"), ("subject", 2, "plain"),
            ("subject", 2, "F"), ("pop", 3, "G"), ("pop", 3, "plain"),
            ("stream", 2, "plain"), ("stream", 3, "plain")]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(references, per-n rank results): the JAX references of every case
    and the port's ranks, one launch of 2 and one of 3 gloo ranks."""
    tmp = tmp_path_factory.mktemp("ranks")
    payload, refs = {2: {}, 3: {}}, {}
    jax_runs = {}
    for kind, n, path in FT_CASES:
        name = f"{kind}-{n}-{path}"
        if (kind, n) not in jax_runs:
            if kind == "stream":
                jax_runs[kind, n] = _jax_stream(n)
            else:
                jax_runs[kind, n] = _jax_ft(
                    n, POP_MODEL if kind == "pop" else MODEL,
                    subject_sharded=kind == "subject")
        cfg, params, inputs, noises, refs[name] = jax_runs[kind, n]
        if kind == "stream":
            payload[n][name] = dict(kind="stream_step", cfg=tsp._port(cfg),
                                    params=refs[name]["before"],
                                    draws=inputs, noise=noises)
            continue
        train = dict(fused_elbo="on" if path == "F" else "off",
                     fused_decode_nll="on" if path == "G" else "off")
        payload[n][name] = dict(kind="ft_step", cfg=_port_cfg(cfg, **train),
                                params=refs[name]["before"], batch=inputs,
                                noise=noises)
    jt, params, data, priors = _map_inputs()
    map_cfg = tsp._port(QBoldConfig(scan=SCAN, model=MAP_MODEL))
    sd = from_jax.state_dict_from_jax(params)
    for n in (2, 3):
        mesh = jmesh.make_mesh(jax.devices()[:n])
        refs[f"jax-maps-{n}"] = {
            first: jinfer.posterior_maps_sharded(
                jt, params, data, jax.random.PRNGKey(0), mesh,
                use_pallas=False, use_first_op=first)
            for first in (True, False)}
        payload[n]["maps"] = dict(kind="maps", cfg=map_cfg, params=sd,
                                  data=data, priors=priors,
                                  prefix=str(tmp / f"maps{n}" / "subj"))
    tiny = tsp._port(QBoldConfig(
        scan=SCAN, model=ModelConfig(no_units=8, no_intermediate_layers=1),
        train=TrainConfig(pt_on_device_synth=True, no_pt_epochs=1,
                          pt_batch_size=3, swa_start=1, swa_period=1,
                          no_ft_epochs=1, ft_steps_per_epoch=2,
                          ft_batch_size=3, crop_size=6)))
    tiny = dataclasses.replace(tiny, synth=dataclasses.replace(
        tiny.synth, sample_size=40))
    vols = _cohort(np.random.default_rng(4), (3, 10, 10, 2), SCAN.n_taus)
    for mode in ("on", "off"):
        cfg = dataclasses.replace(tiny, train=dataclasses.replace(
            tiny.train, ft_shard_subjects=mode,
            save_directory=str(tmp / f"trainer_{mode}")))
        payload[2][f"trainer-{mode}"] = dict(kind="trainer", cfg=cfg,
                                             data=vols)
    payload[2]["population"] = dict(kind="population",
                                    cfg=multihost._population_cfg("tiny"),
                                    trials=list(POP_TRIALS))
    payload[2]["population-full"] = dict(kind="population_full",
                                         cfg=_full_run_cfg(tmp / "full"),
                                         trials=list(FULL_TRIALS))
    path = tmp / "payload.pkl"
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    results = {}
    for n in (2, 3):
        work = tmp / f"work{n}"
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OMP_NUM_THREADS", "1")     # the ranks share the cores
            launch_workers(n, module="torch_rank_cases", pythonpath=[TESTS],
                           args=["--payload", str(path)], timeout_s=600,
                           workdir=str(work))
        results[n] = []
        for r in range(n):
            with open(work / f"proc{r}.json.pkl", "rb") as f:
                results[n].append(pickle.load(f))
    refs["_maps"] = (map_cfg, sd, data, priors, tmp)
    return refs, results


# ---- (b) steps ----------------------------------------------------------------

def _assert_updates(got, ref):
    """Each weight's update within 1e-6 + 1e-4 of JAX's where the global
    gradient is clear of 0, and within 2 lr everywhere."""
    for name, p in got.items():
        delta = p - ref["before"][name].numpy()
        delta_ref = (ref["params"][name] - ref["before"][name]).numpy()
        g = np.abs(ref["grad"][name].numpy())
        clear = g > 1e-3 * (g.max() + 1e-30)
        err = np.abs(delta - delta_ref)
        assert np.all(err[clear] <= 1e-6 + 1e-4 * np.abs(delta_ref[clear])), \
            name
        assert np.all(err <= 2.0 * ref["lr"]), name


@pytest.mark.parametrize("kind,n,path", FT_CASES,
                         ids=[f"{k}-{n}-{p}" for k, n, p in FT_CASES])
def test_sharded_step_matches_jax(ranks, kind, n, path):
    refs, results = ranks
    name = f"{kind}-{n}-{path}"
    ref = refs[name]
    got = [r[name] for r in results[n]]
    for rank in got[1:]:                 # replicated bit for bit
        assert rank["metrics"] == got[0]["metrics"]
        for key, v in got[0]["params"].items():
            np.testing.assert_array_equal(rank["params"][key], v,
                                          err_msg=key)
    terms = ("loss",) if kind == "stream" else (
        "loss", "nll", "kl", "smoothness", "sigma")
    for key in terms:
        np.testing.assert_allclose(got[0]["metrics"][key],
                                   ref["metrics"][key], rtol=1e-5,
                                   err_msg=key)
    _assert_updates(got[0]["params"], ref)


# ---- (c) maps -----------------------------------------------------------------

def _assert_maps(got, ref):
    for key in ref:
        assert got[key].shape == ref[key].shape, key
    for key in ("oef", "dbv", "r2p", "raw_log_stds"):
        if key in ref:
            np.testing.assert_allclose(got[key], ref[key], err_msg=key,
                                       **INFER_TOL)
    if "stds" in ref:
        means = np.concatenate([ref["oef"], ref["dbv"], ref["r2p"]], -1)
        assert_vars_close(got["stds"], ref["stds"], means, **INFER_TOL)
    for key in ("likelihood", "kl", "residual"):
        if key in ref:
            np.testing.assert_allclose(got[key], ref[key], err_msg=key,
                                       **INFER_TOL)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_maps_match_one_process_and_jax(ranks, n):
    refs, results = ranks
    cfg, sd, data, priors, tmp = refs["_maps"]
    tuner = port_tuner(MAP_MODEL, SCAN, from_jax.jax_from_state_dict(sd))
    single = {
        "quad_s1": tinfer.posterior_maps(tuner, data, seed=3),
        "quad_s2": tinfer.posterior_maps(tuner, data, seed=3,
                                         use_first_op=False),
        "mc_s1": tinfer.posterior_maps(tuner, data, seed=4, method="mc",
                                       no_samples=8),
        "elbo_priors": tinfer.elbo_maps(tuner, cfg, data, priors, seed=5,
                                        no_samples=4),
        "elbo_none": tinfer.elbo_maps(tuner, cfg, data, None, seed=5,
                                      no_samples=4)}
    got = [r["maps"] for r in results[n]]
    assert set(got[0]["elbo_priors"]) == {"likelihood", "kl", "residual"}
    assert set(got[0]["elbo_none"]) == {"likelihood", "residual"}
    for key, ref in single.items():
        for rank in got:
            for k, v in rank[key].items():         # every rank: all maps
                np.testing.assert_array_equal(v, got[0][key][k])
        _assert_maps(got[0][key], ref)
    for first in (True, False):
        _assert_maps(got[0][f"quad_s{1 if first else 2}"],
                     refs[f"jax-maps-{n}"][first])
    # save_predictions(mesh=): the maps, written on rank 0 only
    saved = {k: v for k, v in got[0]["saved"].items()}
    _assert_maps(saved, tinfer.posterior_maps(tuner, data, seed=6))
    files = set(os.listdir(tmp / f"maps{n}"))
    for suffix in ("oef", "dbv", "r2p", "logstds", "raw_logstds",
                   "likelihood", "kl", "residual"):
        assert f"subj_0_{suffix}.nii.gz" in files, suffix
    assert not any(f.startswith("subj_1") or f.startswith("subj_2")
                   for f in files), files


# ---- (d) the Trainer ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["on", "off"])
def test_trainer_on_a_mesh(ranks, mode):
    refs, results = ranks
    r0, r1 = (r[f"trainer-{mode}"] for r in results[2])
    assert [p for p, _ in r0["logged"]] == ["pretrain", "finetune"]
    assert r1["logged"] == []                    # rank 0 logs
    timeless = lambda m: {k: v for k, v in m.items()  # noqa: E731
                          if not k.endswith("_time_s")}
    for phase in ("pretrain", "finetune"):
        assert timeless(r0[phase]) == timeless(r1[phase]), phase
        assert all(np.isfinite(v) for v in r0[phase].values())
    assert {"loss", "nll", "kl", "val_elbo"} <= set(r0["finetune"])
    for key, v in r0["params"].items():
        np.testing.assert_array_equal(r1["params"][key], v, err_msg=key)
    save = os.path.dirname(r0["final_path"])
    assert {"pt_model.msgpack", "final_model.msgpack"} <= set(
        os.listdir(save))
    cfg = tsp._port(QBoldConfig(
        scan=SCAN, model=ModelConfig(no_units=8, no_intermediate_layers=1),
        train=TrainConfig(save_directory=save)))
    plain = Trainer(cfg, device="cpu", logger=lambda *a: None)
    assert plain.status is WeightStatus.FULL_TRAINED
    for key, v in plain.tuner.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), r0["params"][key],
                                      err_msg=key)


# ---- (e) the sweep's population over the ranks ------------------------------------

POP_TRIALS = multihost.POPULATION_TRIALS[:3]


def test_population_over_two_ranks_matches_one_process(ranks):
    """3 trials over 2 ranks (rank 1's second slot a pad copy of trial 0):
    every rank returns all 3 results in order, bit-equal across ranks and
    within rtol 2e-4 of the population in one process."""
    from qbold_vi_tpu_torch import sweep

    _, results = ranks
    got = [r["population"] for r in results[2]]
    assert got[0] == got[1] and len(got[0]) == 3
    ref = sweep.population_pretrain(multihost._population_cfg("tiny"),
                                    list(POP_TRIALS), device="cpu")
    for a, b in zip(got[0], ref):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-6,
                                       err_msg=k)
    assert len({round(r["val_elbo"], 6) for r in got[0]}) == 3


FULL_TRIALS = ({"pt_lr": 1e-3, "ft_lr": 2e-3}, {"pt_lr": 5e-4, "ft_lr": 1e-3},
               {"ft_lr": 5e-3, "adamw_decay": 1e-3})


def _full_run_cfg(tmp):
    """tests/test_sweep.py's full-run population configuration, kernel F's
    plain version under device noise."""
    import test_torch_sweep_population as tsw

    tmp.mkdir()
    return tsp._port(tsw._cfg(tmp, tsw._data_dir(tmp), fused_elbo="on"))


def test_full_run_population_over_two_ranks_matches_one_process(ranks):
    """3 trials of population_full_run over 2 ranks under device noise:
    each trial draws from its index in the group (the group's step seed,
    the Philox counters of its rows), so its metrics do not depend on the
    rank or slot it runs in -- within rtol 2e-4 of one process."""
    from qbold_vi_tpu_torch import sweep

    refs, results = ranks
    got = [r["population-full"] for r in results[2]]
    assert got[0] == got[1] and len(got[0]) == 3
    tmp = refs["_maps"][4]
    ref = sweep.population_full_run(_full_run_cfg(tmp / "one_process"),
                                    list(FULL_TRIALS), device="cpu")
    for a, b in zip(got[0], ref):
        assert a["status"] == b["status"] == "FULL_TRAINED"
        for k in b:
            if k != "status":
                np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-6,
                                           err_msg=k)
    assert len({round(r["val_elbo"], 6) for r in got[0]}) == 3
