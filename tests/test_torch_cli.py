"""The port's CLI (python -m qbold_vi_tpu_torch) on the CPU.

* (h) tests/test_cli.py's train --smoke -> infer round trip, serve, baseline
  and the fine-tuned infer with a _kl map, ported, with ``--device cpu``;
* (i) the slice as a whole: ``python -m qbold_vi_tpu train --smoke``
  writes a directory, and the port's ``infer`` on it writes the JAX
  ``infer``'s maps of the same request within test_torch_infer.py's TOL
  (rtol 1e-3, atol 3e-5; the variances by assert_vars_close); and the
  other way round;
* ``train`` on a real-data directory (load_real_directory's layout) with
  mid-phase checkpoints: the post-pretrain, baseline and hyperv exports,
  both checkpoints and no .partial left;
* a TPU artifact (the JAX package's) exits 2, and the card is asked for
  unless ``--device cpu`` is given.
"""

import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity_utils import assert_vars_close  # noqa: E402
from qbold_vi_tpu_torch.cli import main  # noqa: E402
from qbold_vi_tpu_torch.io.nifti import load_nifti  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=3e-5)
CPU = ["--device", "cpu"]
SMOKE_ARCH = ["--set", "no_units=8", "--set", "no_intermediate_layers=1"]


def _smoke(save, *extra):
    return main(["train", "--smoke", *CPU, "--set", f"save_directory={save}",
                 "--set", "d=/tmp/definitely_missing", *extra])


def _request(path, seed, shape):
    rng = np.random.default_rng(seed)
    data = (np.abs(rng.normal(size=shape + (12,))).astype(np.float32) * 50
            + 100)
    data[..., -1] = 1.0
    np.save(path, data)
    return str(path)


def test_train_smoke_and_infer_roundtrip(tmp_path):
    save = str(tmp_path / "run")
    assert _smoke(save) == 0
    assert os.path.isfile(os.path.join(save, "pt_model.msgpack"))
    dpath = _request(tmp_path / "subj.npy", 1, (1, 8, 8, 2))
    out = str(tmp_path / "maps")
    # the architecture must be what --smoke trained
    assert main(["infer", dpath, "--output", out, *CPU,
                 "--set", f"save_directory={save}", *SMOKE_ARCH]) == 0
    for suffix in ("_oef", "_dbv", "_r2p", "_logstds"):
        assert os.path.isfile(out + suffix + ".nii.gz")
    # a second smoke run resumes the checkpoint instead of pretraining
    with open(os.path.join(save, "pt_model.msgpack"), "rb") as f:
        before = f.read()
    assert _smoke(save) == 0
    with open(os.path.join(save, "pt_model.msgpack"), "rb") as f:
        assert f.read() == before


def test_serve_command(tmp_path, monkeypatch, capsys):
    """One process, many export requests as JSON lines; a bad request never
    ends it."""
    save = str(tmp_path / "run")
    assert _smoke(save) == 0
    dpath = _request(tmp_path / "subj.npy", 4, (1, 4, 4, 2))
    out1, out2 = str(tmp_path / "m1"), str(tmp_path / "m2")
    reqs = "\n".join([
        json.dumps({"cmd": "ping"}),
        json.dumps({"cmd": "status"}),
        json.dumps({"data": dpath, "output": out1}),
        "this is not json",
        json.dumps([1, 2]),
        json.dumps({"data": str(tmp_path / "missing.npy"), "output": out2}),
        json.dumps({"data": dpath, "output": out2, "method": "quad"}),
        json.dumps({"data": dpath, "output": out2,
                    "transform_directory": str(tmp_path)}),
        json.dumps({"data": dpath, "output": out2, "method": "mc"}),
        json.dumps({"cmd": "shutdown"}),
        json.dumps({"data": dpath, "output": out2}),   # after shutdown
    ]) + "\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(reqs))
    capsys.readouterr()
    assert main(["serve", "--warm", "1", "4", "4", "2", *CPU,
                 "--set", f"save_directory={save}", *SMOKE_ARCH]) == 0
    lines = [json.loads(ln)
             for ln in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["ok"] and lines[0]["ready"]
    assert not lines[0]["fine_tuned"]
    assert lines[1]["ok"] and lines[1]["ready"]
    assert not lines[2]["ok"] and "unknown cmd: 'status'" in lines[2]["error"]
    assert lines[3]["ok"] and lines[3]["subjects"] == 1
    assert lines[3]["voxels"] == 32 and lines[3]["wall_s"] >= 0
    assert not lines[4]["ok"] and "bad json" in lines[4]["error"]
    assert not lines[5]["ok"] and "JSON object" in lines[5]["error"]
    assert not lines[6]["ok"]
    assert not lines[7]["ok"] and "method" in lines[7]["error"]
    # a request's transform_directory: native-space maps where FSL is
    # missing (test_torch_fsl_preprocess.py holds the MNI warp)
    assert lines[8]["ok"] and lines[8]["output"] == out2
    assert lines[9]["ok"] and lines[9]["output"] == out2
    assert lines[10]["ok"] and lines[10]["shutdown"]
    assert len(lines) == 11
    for suffix in ("_oef", "_dbv", "_r2p", "_logstds"):
        assert os.path.isfile(out1 + suffix + ".nii.gz")
        assert os.path.isfile(out2 + suffix + ".nii.gz")

    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    assert main(["serve", *CPU, "--set",
                 f"save_directory={tmp_path / 'nothing'}"]) == 1
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    assert main(["serve", "--warm", "0", "4", "4", "2", *CPU,
                 "--set", f"save_directory={save}", *SMOKE_ARCH]) == 1
    assert "--warm dimensions" in capsys.readouterr().err


def test_baseline_command(tmp_path):
    rng = np.random.default_rng(0)
    vols = np.abs(rng.normal(size=(2, 6, 5, 3, 13))).astype(np.float32) + 0.5
    path = str(tmp_path / "vols.npy")
    np.save(path, vols)
    out = str(tmp_path / "wls")
    assert main(["baseline", path, "--output", out, *CPU]) == 0
    for suffix in ("_oef", "_dbv", "_r2p"):
        assert os.path.isfile(out + suffix + ".nii.gz")
    # the JAX CLI's maps of the same volumes
    from qbold_vi_tpu.cli import main as jmain
    ref = str(tmp_path / "wls_jax")
    assert jmain(["baseline", path, "--output", ref]) == 0
    for suffix in ("_oef", "_dbv", "_r2p"):
        np.testing.assert_allclose(load_nifti(out + suffix + ".nii.gz"),
                                   load_nifti(ref + suffix + ".nii.gz"),
                                   rtol=1e-4, atol=1e-5, err_msg=suffix)
    assert main(["baseline", path, "--output", out, *CPU,
                 "--protocol", "streamlined"]) == 1


def test_infer_fine_tuned_without_pop_prior_exports_kl(tmp_path):
    """OPTIMAL-like (MVG, no population prior): infer on a FULL_TRAINED
    checkpoint takes the per-voxel priors from the pt checkpoint beside it
    and exports the _kl map."""
    from qbold_vi_tpu_torch.config import (ModelConfig, QBoldConfig,
                                           ScanParams, SynthParams,
                                           TrainConfig)
    from qbold_vi_tpu_torch.train.trainer import Trainer

    save = str(tmp_path / "run")
    cfg = QBoldConfig(
        scan=ScanParams(simulate_noise=False),
        synth=SynthParams(sample_size=40),
        model=ModelConfig(no_units=4, no_intermediate_layers=1, use_mvg=True,
                          student_t_df=200.0, predict_log_data=False),
        train=TrainConfig(no_pt_epochs=1, no_ft_epochs=1, pt_batch_size=8,
                          ft_batch_size=2, ft_steps_per_epoch=2, crop_size=6,
                          save_directory=save, swa_start=1, swa_period=1))
    t = Trainer(cfg, device="cpu", logger=lambda *a: None)
    t.pretrain()
    rng = np.random.default_rng(3)
    real = np.abs(rng.normal(size=(2, 8, 8, 2, cfg.scan.n_taus + 1))
                  ).astype(np.float32) * 50 + 100
    real[..., -1] = 1.0
    t.finetune(real)
    assert os.path.isfile(t.final_path)
    dpath = str(tmp_path / "subj.npy")
    np.save(dpath, real[:1])
    out = str(tmp_path / "maps")
    assert main(["infer", dpath, "--output", out, *CPU,
                 "--set", f"save_directory={save}",
                 "--set", "no_units=4", "--set", "no_intermediate_layers=1",
                 "--set", "simulate_noise=False", "--set", "use_mvg=True",
                 "--set", "student_t_df=200.0",
                 "--set", "predict_log_data=False"]) == 0
    for suffix in ("_oef", "_kl", "_likelihood", "_residual"):
        assert os.path.isfile(out + suffix + ".nii.gz"), suffix


def _maps(prefix):
    return {k: load_nifti(f"{prefix}_{k}.nii.gz")
            for k in ("oef", "dbv", "r2p", "logstds", "raw_logstds")}


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_infer_matches_the_jax_cli(tmp_path, trained_by):
    """The slice as a whole: one package's train --smoke writes a
    directory; each package's infer on it writes the same maps within
    TOL."""
    from qbold_vi_tpu.cli import main as jmain

    save = str(tmp_path / "run")
    if trained_by == "jax":
        assert jmain(["train", "--smoke", "--set", f"save_directory={save}",
                      "--set", "d=/tmp/definitely_missing"]) == 0
    else:
        assert _smoke(save) == 0
    dpath = _request(tmp_path / "subj.npy", 6, (2, 8, 8, 2))
    args = ["--set", f"save_directory={save}", *SMOKE_ARCH]
    assert main(["infer", dpath, "-o", str(tmp_path / "port"), *CPU,
                 *args]) == 0
    assert jmain(["infer", dpath, "-o", str(tmp_path / "jax"), *args]) == 0
    got, ref = _maps(tmp_path / "port"), _maps(tmp_path / "jax")
    for k in ("oef", "dbv", "r2p", "raw_logstds"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, **TOL)
    means = np.stack([ref["oef"], ref["dbv"], ref["r2p"]], -1)
    stds = lambda m: m.reshape(m.shape[:-1] + (-1, 3))  # noqa: E731
    assert_vars_close(stds(got["logstds"]), stds(ref["logstds"]), means,
                      **TOL)


def test_train_on_a_real_data_directory(tmp_path):
    """train on load_real_directory's layout with checkpoint_every_epochs=1:
    both checkpoints, no .partial, the pt_* exports of the pretrained
    weights and the baseline_* / hyperv_* exports of the fine-tuned ones
    with their _kl maps; a second run resumes final_model.msgpack."""
    rng = np.random.default_rng(7)
    d = tmp_path / "data"
    d.mkdir()
    ase = (np.abs(rng.normal(size=(3, 10, 10, 2, 12))) * 50 + 100
           ).astype(np.float32)
    ase[..., -1] = 1.0
    np.save(d / "ASE_scan.npy", ase)
    for name in ("hyperv_ase", "baseline_ase"):
        study = np.concatenate([ase[:1, ..., :-1],
                                np.ones(ase.shape[1:-1] + (2,),
                                        np.float32)[None]], -1)
        np.save(d / f"{name}.npy", study)
    save = tmp_path / "run"
    argv = ["train", "--smoke", *CPU, "--set", f"save_directory={save}",
            "--set", f"d={d}", "--set", "checkpoint_every_epochs=1",
            "--set", "no_ft_epochs=2"]
    assert main(argv) == 0
    files = set(os.listdir(save))
    assert {"pt_model.msgpack", "final_model.msgpack"} <= files
    assert not any(f.endswith(".partial") for f in files)
    for prefix in ("pt_baseline", "pt_hyperv"):
        assert f"{prefix}_oef.nii.gz" in files and \
            f"{prefix}_kl.nii.gz" not in files
    for prefix in ("baseline", "hyperv"):
        for suffix in ("oef", "dbv", "r2p", "logstds", "kl", "likelihood",
                       "residual"):
            assert f"{prefix}_{suffix}.nii.gz" in files, (prefix, suffix)
    oef = load_nifti(str(save / "baseline_oef.nii.gz"))
    assert np.all(np.isfinite(oef))
    with open(save / "final_model.msgpack", "rb") as f:
        before = f.read()
    assert main(argv) == 0
    with open(save / "final_model.msgpack", "rb") as f:
        assert f.read() == before


def test_what_is_not_ported_exits_2(tmp_path, capsys):
    """Every subcommand of the JAX CLI is ported (sweep:
    tests/test_torch_sweep.py): only a TPU artifact, which is the JAX
    package's, exits 2. dryrun and train's --mesh / --coordinator /
    --num-processes / --process-id run (tests/test_torch_multihost.py),
    and --mesh without a process group trains on one rank, unsharded, as
    the JAX CLI does."""
    from qbold_vi_tpu_torch import cli

    assert not hasattr(cli, "_UNPORTED")
    save = tmp_path / "mesh1"
    assert main(["train", "--mesh", "--smoke", *CPU, "--set",
                 f"save_directory={save}", "--set",
                 f"d={tmp_path}/none"]) == 0
    assert os.listdir(save) == ["pt_model.msgpack"]
    assert "not ported" not in capsys.readouterr().err
    shutil.rmtree(save)
    assert main(["export-model", "-o", "x", "--platforms", "tpu",
                 *CPU]) == 2
    assert "JAX package's" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


def test_the_card_is_asked_for_unless_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["train", "--smoke", "--set", f"save_directory={tmp_path}",
              "--set", "d=/tmp/definitely_missing"])
    assert not os.listdir(tmp_path)


def test_python_m_runs_the_cli(tmp_path):
    """``python -m qbold_vi_tpu_torch`` reaches cli.main."""
    out = subprocess.run(
        [sys.executable, "-m", "qbold_vi_tpu_torch", "export-model", "-o",
         str(tmp_path / "x"), "--platforms", "tpu", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "TPU artifacts" in out.stderr
    out = subprocess.run(
        [sys.executable, "-m", "qbold_vi_tpu_torch", "--help"], cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "serve" in out.stdout


# ---- synth / import-weights / transfer / export-model --------------------

def _jax_synth_draws(key, synth, n_taus, noise: bool):
    """The draws of JAX create_synthetic_dataset(key, ...) in the port's
    layout: k_pop's four, the permutation, then k_mis's and k_noise's."""
    import jax

    k_pop, k_shuf, k_mis, k_noise = jax.random.split(key, 4)
    n = synth.sample_size
    n_uni = round(n * synth.uniform_prop)
    k_ou, k_on, k_du, k_dn = jax.random.split(k_pop, 4)
    d = {"oef_u": jax.random.uniform(k_ou, (n_uni,)),
         "oef_n": jax.random.normal(k_on, (n - n_uni,)),
         "dbv_u": jax.random.uniform(k_du, (n_uni,)),
         "dbv_n": jax.random.uniform(k_dn, (n - n_uni,)),
         "perm": jax.random.permutation(k_shuf, n * n)}
    if synth.misalign_prob > 0.0:
        k1, k2, k3, k4 = jax.random.split(k_mis, 4)
        d.update(mis_u=jax.random.uniform(k1, (n * n, 1)),
                 from_idx=jax.random.randint(k2, (n * n, 1), 4, n_taus - 1),
                 z_oef=jax.random.normal(k3, (n * n, 1)),
                 z_dbv=jax.random.normal(k4, (n * n, 1)))
    if noise:
        k1, k2 = jax.random.split(k_noise)
        d.update(snr_u=jax.random.uniform(k1, (n * n, 1)),
                 z=jax.random.normal(k2, (n * n, n_taus)))
    return {k: np.array(v) for k, v in d.items()}


@pytest.mark.parametrize("misalign,noise", [(0.0, False), (0.5, True)])
def test_synthetic_dataset_matches_jax_given_its_draws(misalign, noise):
    """synth.create_synthetic_dataset fed the JAX key's draws (the
    samplers, the cross product, the permutation, misalignment and noise):
    the labels (OEF, DBV, R2') at rtol 1e-6 / atol 1e-7 -- within 2 float32
    ulps: XLA fuses the uniforms' map into a multiply-add and has its own
    erfinv -- and x at rtol 1e-5 / atol 1e-5 (the decode gate of
    test_torch_stream_pretrain.py); from a seed, a seed replays."""
    import dataclasses

    import jax

    from qbold_vi_tpu import config as jcfg
    from qbold_vi_tpu.synth import create_synthetic_dataset as jcreate
    from qbold_vi_tpu_torch import config as tcfg
    from qbold_vi_tpu_torch.synth import create_synthetic_dataset

    scan = dataclasses.replace(jcfg.ScanParams(), simulate_noise=noise)
    synth = dataclasses.replace(jcfg.SynthParams(), sample_size=24,
                                misalign_prob=misalign, uniform_prop=0.3)
    key = jax.random.PRNGKey(9)
    xr, yr = jcreate(key, scan, synth)
    tscan = tcfg.ScanParams(**dataclasses.asdict(scan))
    tsynth = tcfg.SynthParams(**dataclasses.asdict(synth))
    x, y = create_synthetic_dataset(
        None, tscan, tsynth, device="cpu",
        draws=_jax_synth_draws(key, synth, scan.n_taus, noise))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-5,
                               atol=1e-5)
    a = create_synthetic_dataset(3, tscan, tsynth, device="cpu")
    b = create_synthetic_dataset(3, tscan, tsynth, device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert a[0].shape == (24 * 24, 11) and torch.isfinite(a[0]).all()


def test_synth_command(tmp_path, capsys):
    """synth -o writes x (N, T) and y (N, 3) as the JAX CLI lays them out,
    the labels within the population's ranges."""
    from qbold_vi_tpu.cli import main as jmain

    out = str(tmp_path / "port.npz")
    assert main(["synth", "-o", out, *CPU, "--set", "sample_size=20"]) == 0
    assert "wrote" in capsys.readouterr().out
    ref = str(tmp_path / "jax.npz")
    assert jmain(["synth", "-o", ref, "--set", "sample_size=20"]) == 0
    with np.load(out) as got, np.load(ref) as want:
        for k in ("x", "y"):
            assert got[k].shape == want[k].shape and got[k].dtype == \
                want[k].dtype, k
            assert np.isfinite(got[k]).all()
        lo, hi = want["y"].min(0), want["y"].max(0)
        assert (got["y"][:, :2] >= 0.0).all()
        assert (got["y"][:, 0] <= 1.0).all() and (hi > lo).all()


def _legacy_file(path, cfg, extras):
    from torch_parity_utils import legacy_kernels, write_legacy_h5

    write_legacy_h5(path, legacy_kernels(np.random.default_rng(6), cfg, 11),
                    nested=True, extras=extras)
    return str(path)


POP_ARCH = [*SMOKE_ARCH, "--set", "use_mvg=true",
            "--set", "use_population_prior=true",
            "--set", "heteroscedastic_noise=false"]


def test_import_weights_and_transfer_commands(tmp_path, capsys):
    """import-weights writes the JAX CLI's checkpoint bytes for a
    pt_model.h5 and (--final) a final_model.h5 with its population prior
    and trainable sigma; the JAX Trainer resumes them. transfer retargets
    the imported model to a 20-tau grid: the JAX Trainer resumes its
    pt_model.msgpack on that grid with the trunk unchanged, and the port's
    infer runs on it."""
    pytest.importorskip("h5py")
    from qbold_vi_tpu.cli import _load_cfg as jload, build_parser as jparser
    from qbold_vi_tpu.cli import main as jmain
    from qbold_vi_tpu.train import trainer as jtrainer

    from qbold_vi_tpu_torch import config as tcfg

    cfg = tcfg.apply_flat_overrides(tcfg.QBoldConfig(), {
        "no_units": 8, "no_intermediate_layers": 1, "use_mvg": True,
        "use_population_prior": True, "heteroscedastic_noise": False})
    h5 = _legacy_file(tmp_path / "final_model.h5", cfg.model,
                      (np.asarray([-0.9, 0.3, -1.2, 0.5, 0.05], np.float32),
                       np.asarray([np.log(0.07)], np.float32)))
    files = {}
    for final in (False, True):
        name = "final_model" if final else "pt_model"
        flag = ["--final"] if final else []
        port, ref = str(tmp_path / f"port_{name}"), str(tmp_path / f"jax_{name}")
        assert main(["import-weights", h5, *flag, *CPU, "--set",
                     f"save_directory={port}", *POP_ARCH]) == 0
        assert "extras: log_sigma, pop_prior" in capsys.readouterr().out
        assert jmain(["import-weights", h5, *flag, "--set",
                      f"save_directory={ref}", *POP_ARCH]) == 0
        with open(os.path.join(port, name + ".msgpack"), "rb") as f:
            files[name] = f.read()
        with open(os.path.join(ref, name + ".msgpack"), "rb") as f:
            assert files[name] == f.read(), name
        jargs = jparser().parse_args(["train", "--set",
                                      f"save_directory={port}", *POP_ARCH])
        jt = jtrainer.Trainer(jload(jargs), logger=lambda *a: None)
        assert jt.status.name == ("FULL_TRAINED" if final else "PRE_TRAINED")
        np.testing.assert_allclose(np.asarray(jt.state.params["log_sigma"]),
                                   np.log(0.07), rtol=1e-6)

    out = str(tmp_path / "transferred")
    tau = ["--tau-start", "-0.016", "--tau-step", "0.004", "--tau-end",
           "0.064"]
    src = str(tmp_path / "port_pt_model")
    assert main(["transfer", *tau, "-o", out, *CPU, "--set",
                 f"save_directory={src}", *POP_ARCH]) == 0
    assert "20-tau protocol" in capsys.readouterr().out
    grid = ["--set", "tau_start=-0.016", "--set", "tau_step=0.004",
            "--set", "tau_end=0.064"]
    jargs = jparser().parse_args(["train", "--set", f"save_directory={out}",
                                  *POP_ARCH, *grid])
    jt = jtrainer.Trainer(jload(jargs), logger=lambda *a: None)
    assert jt.status.name == "PRE_TRAINED"
    enc = jt.state.params["encoder"]
    assert enc["first_conv"]["kernel"].shape == (20, 8)
    from qbold_vi_tpu_torch.io.keras_import import load_reference_h5

    imported = load_reference_h5(h5, cfg.model)
    np.testing.assert_array_equal(
        np.asarray(enc["block_0"]["ConvXY_0"]["Conv_0"]["kernel"]),
        imported["encoder.block_0.ConvXY_0.Conv_0.weight"].numpy().transpose(
            2, 3, 1, 0))
    req = tmp_path / "req20.npy"
    data = np.abs(np.random.default_rng(2).normal(
        size=(1, 5, 5, 2, 21))).astype(np.float32) * 50 + 100
    data[..., -1] = 1.0
    np.save(req, data)
    maps = str(tmp_path / "maps20")
    assert main(["infer", str(req), "-o", maps, *CPU, "--set",
                 f"save_directory={out}", *POP_ARCH, *grid]) == 0
    oef = load_nifti(maps + "_oef.nii.gz")
    assert oef.shape == (5, 5, 2, 1) and np.isfinite(oef).all()
    assert main(["transfer", *tau, "-o", out, *CPU, "--set",
                 f"save_directory={tmp_path / 'empty'}", *POP_ARCH]) == 1


def test_export_model_and_transform_directory_commands(tmp_path, capsys):
    """export-model of a pretrained checkpoint writes a stream-1 .pt2
    (test_torch_export.py reloads such an artifact); --fused needs the
    card; without a checkpoint it exits 1. infer and baseline take
    --transform-directory: without FSL they write native-space maps."""
    save = str(tmp_path / "run")
    assert _smoke(save) == 0
    capsys.readouterr()
    out = str(tmp_path / "maps.pt2")
    assert main(["export-model", "-o", out, *CPU, "--set",
                 f"save_directory={save}", *SMOKE_ARCH]) == 0
    line = capsys.readouterr().out
    assert os.path.getsize(out) > 0
    assert "pretrained checkpoint, stream-1 head" in line
    assert "input (s, x, y, z, 12) float32" in line
    with pytest.raises(ValueError, match="card"):
        main(["export-model", "-o", out, "--fused", *CPU, "--set",
              f"save_directory={save}", *SMOKE_ARCH])
    assert main(["export-model", "-o", out, *CPU, "--set",
                 f"save_directory={tmp_path / 'none'}"]) == 1

    tdir = str(tmp_path / "transforms")
    os.makedirs(tdir)
    dpath = _request(tmp_path / "subj.npy", 3, (1, 6, 6, 2))
    maps = str(tmp_path / "m")
    assert main(["infer", dpath, "-o", maps, "--transform-directory", tdir,
                 *CPU, "--set", f"save_directory={save}", *SMOKE_ARCH]) == 0
    assert os.path.isfile(maps + "_oef.nii.gz")
    vols = str(tmp_path / "vols.npy")
    np.save(vols, np.abs(np.random.default_rng(0).normal(
        size=(1, 6, 5, 3, 13))).astype(np.float32) + 0.5)
    assert main(["baseline", vols, "-o", str(tmp_path / "w"),
                 "--transform-directory", tdir, *CPU]) == 0
    assert "FSL not found" in capsys.readouterr().err
    assert os.path.isfile(str(tmp_path / "w") + "_oef.nii.gz")
