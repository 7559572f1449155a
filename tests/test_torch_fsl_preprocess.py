"""The port's FSL adapter (io/fsl.py), MNI-space export
(``save_predictions(transform_directory=)``), preprocessing
(preprocess.py) and profiling helpers (utils/profiling.py) against the JAX
package's.

FSL is installed neither here nor on the card's machine, so the tests hold
the command lines: ``subprocess.run`` is replaced by a recorder (which
writes the outputs the pipeline reads next), and the port's commands must
equal the JAX modules' one for one. nibabel is absent too; where a path
needs it, a stand-in module over the built-in NIfTI reader takes its
place. The numeric steps (``estimate_norm_snr``, ``average_slices``) are
held against JAX bit for bit.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qbold_vi_tpu import preprocess as jpre  # noqa: E402
from qbold_vi_tpu.io import fsl as jfsl  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch import infer as tinfer  # noqa: E402
from qbold_vi_tpu_torch import preprocess as tpre  # noqa: E402
from qbold_vi_tpu_torch.io import fsl as tfsl  # noqa: E402
from qbold_vi_tpu_torch.io import nifti as tnifti  # noqa: E402
from qbold_vi_tpu_torch.models.vi import FineTuner, init_params  # noqa: E402
from qbold_vi_tpu_torch.utils import profiling  # noqa: E402


def recorder(monkeypatch, on_call=None):
    """Replace subprocess.run (which both packages' FSL calls reach) with
    a recorder of the argument lists; ``on_call(cmd)`` may write the
    outputs a pipeline reads next."""
    calls = []

    def run(cmd, *a, **kw):
        calls.append(list(cmd))
        if on_call is not None:
            on_call(list(cmd))
        return subprocess.CompletedProcess(list(cmd), 0, "", "")

    monkeypatch.setattr(subprocess, "run", run)
    return calls


class _FakeImg:
    def __init__(self, data, header=None):
        self._d = np.asarray(data)
        self.header = header or types.SimpleNamespace(copy=lambda: None)

    def get_fdata(self):
        return self._d


def fake_nibabel(monkeypatch, saved: list):
    """A nibabel stand-in: load reads with the built-in NIfTI-1 reader,
    save records (path, data)."""
    nib = types.SimpleNamespace(
        load=lambda p: _FakeImg(tnifti._read_nifti1(p)),
        Nifti1Image=lambda data, affine=None, header=None: np.asarray(data),
        save=lambda img, p: saved.append((os.path.basename(p), img)))
    monkeypatch.setitem(sys.modules, "nibabel", nib)
    return nib


# ---- io/fsl.py -----------------------------------------------------------

def test_fsl_commands_match_jax(monkeypatch):
    assert tfsl.have_fsl() is False
    calls = recorder(monkeypatch)
    for mod in (jfsl, tfsl):
        mod.applywarp("in.nii", "out.nii", "warp.nii", "ref.nii")
        mod.fslmerge("merged", ["a", "b"])
    assert calls[:2] == calls[2:]
    assert calls[0] == ["applywarp", "--in=in.nii", "--out=out.nii",
                        "--warp=warp.nii", "--ref=ref.nii"]


def test_run_keeps_stdout_clean(capfd):
    """Tool output reaches stderr, never stdout (serve's JSON lines)."""
    tfsl._run([sys.executable, "-c", "print('tool chatter')"])
    out, err = capfd.readouterr()
    assert out == "" and "tool chatter" in err
    with pytest.raises(subprocess.CalledProcessError):
        tfsl._run([sys.executable, "-c", "import sys; print('x'); "
                   "sys.exit(3)"])
    out, err = capfd.readouterr()
    assert out == "" and "x" in err


def test_warp_maps_to_mni_matches_jax(monkeypatch, tmp_path):
    """The per-subject applywarp calls, the fslmerge and the three _mni
    maps split from the merged series, as the JAX function makes them;
    without nibabel both refuse before any command."""
    rng = np.random.default_rng(0)
    oef, dbv, r2p = (rng.uniform(size=(2, 4, 3, 2, 1)).astype(np.float32)
                     for _ in range(3))
    calls = recorder(monkeypatch)
    with pytest.raises(RuntimeError, match="nibabel"):
        tfsl.warp_maps_to_mni(oef, dbv, r2p, str(tmp_path / "m"), "t")
    assert calls == []
    merged = rng.uniform(size=(4, 3, 2, 6))
    out = {}
    for name, mod in (("jax", jfsl), ("port", tfsl)):
        saved = []
        nib = fake_nibabel(monkeypatch, saved)
        nib.load = lambda p: _FakeImg(merged)
        mod.warp_maps_to_mni(oef, dbv, r2p, str(tmp_path / "m"),
                             str(tmp_path / "t"))
        out[name] = saved
    n = len(calls) // 2
    assert n == 3 and calls[:n] == calls[n:]
    assert [c[0] for c in calls[:n]] == ["applywarp", "applywarp",
                                         "fslmerge"]
    assert [p for p, _ in out["port"]] == [p for p, _ in out["jax"]]
    for (_, a), (_, b) in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(a, b)
    assert [p for p, _ in out["port"]][-3:] == [
        "m_oef_mni.nii.gz", "m_dbv_mni.nii.gz", "m_r2p_mni.nii.gz"]


@pytest.mark.parametrize("nibabel", [False, True])
def test_save_predictions_with_a_transform_directory(monkeypatch, tmp_path,
                                                      nibabel):
    """Without FSL the maps are written in native space (as without a
    transform directory); with FSL and nibabel the (OEF, DBV, R2') maps
    go to warp_maps_to_mni; with FSL and without nibabel a warning and no
    warp (JAX infer.py:778-792)."""
    cfg = tcfg.ModelConfig(no_units=6, no_intermediate_layers=1)
    tuner = FineTuner(cfg, tcfg.ScanParams(), device="cpu")
    tuner.load_state_dict(init_params(cfg, tcfg.ScanParams(),
                                      torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    data = (np.abs(rng.normal(size=(2, 4, 4, 2, 12))) * 50 + 100
            ).astype(np.float32)
    data[..., -1] = 1.0
    tdir = str(tmp_path / "transforms")
    os.makedirs(tdir)
    native = tinfer.save_predictions(tuner, tcfg.OPTIMAL, data,
                                     str(tmp_path / "a"),
                                     transform_directory=tdir)
    ref = tinfer.save_predictions(tuner, tcfg.OPTIMAL, data,
                                  str(tmp_path / "b"))
    for k in ref:
        np.testing.assert_array_equal(native[k], ref[k])
        assert os.path.isfile(str(tmp_path / "a") + "_oef.nii.gz")

    warped = []
    monkeypatch.setattr(tfsl, "have_fsl", lambda: True)
    monkeypatch.setattr(tfsl, "warp_maps_to_mni",
                        lambda *a: warped.append(a))
    monkeypatch.setattr(tnifti, "have_nibabel", lambda: nibabel)
    if nibabel:
        monkeypatch.setattr(tnifti, "save_im_data", lambda *a: None)
        tinfer.save_predictions(tuner, tcfg.OPTIMAL, data,
                                str(tmp_path / "c"), transform_directory=tdir)
        assert len(warped) == 1
        np.testing.assert_array_equal(warped[0][0], ref["oef"])
        assert warped[0][3:] == (str(tmp_path / "c"), tdir)
    else:
        with pytest.warns(UserWarning, match="nibabel"):
            tinfer.save_predictions(tuner, tcfg.OPTIMAL, data,
                                    str(tmp_path / "c"),
                                    transform_directory=tdir)
        assert warped == []


# ---- preprocess.py -------------------------------------------------------

def test_numeric_steps_match_jax():
    rng = np.random.default_rng(2)
    data = np.abs(rng.normal(size=(30, 28, 3, 11))) + 1.0
    mask = (rng.uniform(size=(30, 28, 3)) > 0.4).astype(np.float32)
    np.testing.assert_array_equal(tpre.estimate_norm_snr(data, mask),
                                  jpre.estimate_norm_snr(data, mask))
    vol = rng.uniform(size=(6, 5, 8, 13)).astype(np.float32)
    for n in (1, 2, 4):
        np.testing.assert_array_equal(tpre.average_slices(vol, n),
                                      jpre.average_slices(vol, n))


def _subject(root, base="baseline_ase"):
    d = root / "subj"
    (d / "VDM").mkdir(parents=True)
    for name in ("vdm5_B1.nii", "vdm5_B2.nii", "vdm5_H1.nii",
                 "vdm5_H2.nii", "T1.nii", "c1T1.nii", "c2T1.nii"):
        (d / ("VDM" if name.startswith("vdm") else ".") / name).touch()
    return str(d / f"{base}.nii.gz")


@pytest.mark.parametrize("base", ["baseline_ase", "hyperv_ase"])
def test_registration_chain_matches_jax(monkeypatch, tmp_path, base):
    """register_to_t1's 17 commands (T1 masks, fsl_anat, flirt, the roi
    concat, the VDM average -- 'H' maps for hypervent -- convertwarp, the
    QA warp, the WM+GM segmentation, the inverse warp of the GM mask) and
    its outputs, as the JAX function's."""
    src = _subject(tmp_path, base)
    calls = recorder(monkeypatch)
    got = tpre.register_to_t1(src)
    n = len(calls)
    want = jpre.register_to_t1(src)
    assert n == 17 and calls[:n] == calls[n:] and got == want
    assert any("vdm5_" + ("H" if "hyperv" in base else "B") in c[1]
               for c in calls[:n] if c[0] == "fslmaths" and len(c) > 1)


def test_prepare_image_matches_jax(monkeypatch, tmp_path):
    """mcflirt / fslmaths / bet, cached on their outputs, and the stack
    with the GM (here the brain mask) and brain mask channels -- read by
    the port's own NIfTI reader, by nibabel's stand-in for the JAX one."""
    rng = np.random.default_rng(0)
    vol = np.abs(rng.normal(size=(6, 5, 2, 11))).astype(np.float32)
    srcs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        srcs[name] = str(d / "ase.nii.gz")
        tnifti._write_nifti1(vol, srcs[name])

    def outputs(cmd):
        if cmd[0] == "mcflirt":
            tnifti._write_nifti1(vol, cmd[4])
        elif cmd[0] == "fslmaths":
            tnifti._write_nifti1(vol.mean(-1), cmd[-1])
        elif cmd[0] == "bet":
            tnifti._write_nifti1(np.ones((6, 5, 2), np.float32),
                                 cmd[2].replace(".nii.gz", "_mask.nii.gz"))

    calls = recorder(monkeypatch, outputs)
    got = tpre.prepare_image(srcs["port"])
    n = len(calls)
    fake_nibabel(monkeypatch, [])
    want = jpre.prepare_image(srcs["jax"])
    swap = [[a.replace(str(tmp_path / "port"), str(tmp_path / "jax"))
             for a in c] for c in calls[:n]]
    assert n == 3 and swap == calls[n:]
    np.testing.assert_array_equal(got, want)
    assert got.shape == (6, 5, 2, 13)
    del sys.modules["nibabel"]
    calls.clear()
    np.testing.assert_array_equal(tpre.prepare_image(srcs["port"]), got)
    assert calls == []                    # every step cached


def test_prepare_data_excludes_a_mismatched_subject(monkeypatch, tmp_path):
    """A subject whose shape differs from the first is left out of the
    stack, the warp tar and the GM merge alike (JAX preprocess.py's fix),
    and the fslmerge lines are the JAX function's."""
    import tarfile

    shapes = {"s1": (4, 4, 2, 3), "s2": (6, 6, 2, 3), "s3": (4, 4, 2, 3)}
    (tmp_path / "study").mkdir()
    for name in shapes:
        d = tmp_path / f"study{name}"
        d.mkdir()
        (d / "ase.nii.gz").write_bytes(b"")
        (d / "tmean_ase.nii.gz").write_bytes(b"")
    nonlin = tmp_path / "nonlin_src.nii.gz"
    nonlin.write_bytes(b"warp")
    calls = recorder(monkeypatch)
    stacks = {}
    for name, mod in (("port", tpre), ("jax", jpre)):
        monkeypatch.setattr(mod, "prepare_image", lambda p, **kw: np.zeros(
            shapes[[k for k in shapes if f"study{k}/" in p][0]], np.float32))
        monkeypatch.setattr(mod, "register_to_t1",
                            lambda p, **kw: (str(nonlin), p + "_gm"))
        with pytest.warns(UserWarning, match="EXCLUDED"):
            stacks[name] = mod.prepare_data(str(tmp_path / "study"), "ase",
                                            include_warp=True)
        with tarfile.open(str(tmp_path / "study" / "warp_infoase.tar.gz")) \
                as t:
            assert sorted(t.getnames()) == ["nonlin0.nii.gz",
                                            "nonlin1.nii.gz"]
    assert stacks["port"].shape[0] == 2
    np.testing.assert_array_equal(stacks["port"], stacks["jax"])
    n = len(calls) // 2
    assert calls[:n] == calls[n:] and [c[0] for c in calls[:n]] == [
        "fslmerge", "fslmerge"]
    assert not any("s2" in a for a in calls[0])


def test_fieldmaps_and_reslice(monkeypatch, tmp_path):
    d = tmp_path / "VDM"
    d.mkdir()
    with pytest.raises(FileNotFoundError):
        tpre.average_fieldmaps(str(d), "B", str(tmp_path / "shift"))
    for name in ("vdm5_B1.nii", "vdm5_B2.nii"):
        (d / name).touch()
    calls = recorder(monkeypatch)
    tpre.average_fieldmaps(str(d), "B", "shift")
    jpre.average_fieldmaps(str(d), "B", "shift")
    assert calls[0] == calls[1] and calls[0][-3:] == ["-mul", "0.5", "shift"]

    rng = np.random.default_rng(3)
    vol = rng.uniform(size=(4, 3, 8, 2)).astype(np.float32)
    path = str(tmp_path / "merged.nii.gz")
    tnifti._write_nifti1(vol, path)
    tpre.reslice_images(path, binarise=True, n=4)
    want = (vol.reshape(4, 3, 2, 4, 2).mean(-2) >= 0.5)
    np.testing.assert_array_equal(tnifti.load_nifti(path), want)


# ---- utils/profiling.py --------------------------------------------------

def test_profiling_helpers(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiling.StepTimer()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            profiling.steady_state_step_time(lambda: None)
    t = profiling.StepTimer(warmup=1, device="cpu")
    for _ in range(4):
        t.start()
        t.stop()
    s = t.summary()
    assert set(s) == {"step_time_mean_s", "step_time_p50_s",
                      "step_time_p95_s", "steps_per_sec"}
    assert s["steps_per_sec"] > 0 and len(t._times) == 3
    with pytest.raises(RuntimeError, match="start"):
        t.stop()
    calls = []
    dt = profiling.steady_state_step_time(lambda: calls.append(1), reps=5,
                                          blocks=2, device="cpu")
    assert dt >= 0 and len(calls) == 2 + 5 * 2
    metrics = {"a": 1.0, "b": torch.ones(3)}
    assert profiling.check_finite(metrics) is metrics
    for bad in (float("nan"), torch.tensor([1.0, float("inf")]),
                np.array([np.nan])):
        with pytest.raises(FloatingPointError, match="test"):
            profiling.check_finite({"a": 1.0, "b": bad}, where="test")
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert prof.key_averages() is not None
    assert os.path.isfile(str(tmp_path / "tr" / "trace.json"))
