"""The port's checkpoint files against the JAX package's, both ways.

* (a) the msgpack codec (qbold_vi_tpu_torch/io/msgpack_lite.py) against
  the ``msgpack`` package and flax.serialization: the same bytes for every
  length class, the same tree from a file the JAX Trainer wrote, and a
  clear error on flax's chunked layout and on bfloat16;
* (b) ``_config_fingerprint`` equals the JAX function's;
* (c) JAX -> port: the JAX Trainer writes ``pt_model.msgpack``,
  ``final_model.msgpack`` and a ``.partial`` of each phase (a crash at
  epoch 1, checkpoint_every_epochs=1); the port resumes each to the same
  status and start epoch with params, mu, nu, counts, SWA and step equal
  exactly after the bridge, and writes the file's bytes back from them;
* (d) port -> JAX: the same sequence run by the port, resumed by
  ``qbold_vi_tpu.train.trainer.Trainer`` with its state equal exactly to
  the tensors the port saved;
* (e) the schema, fingerprint, steps-per-epoch, layout, unversioned and
  legacy cases of tests/test_train.py:1013-1140, and the NaN tripwire's
  veto of a checkpoint;
* (f) one fine-tune step of each framework from the same restored
  ``.partial`` (non-zero moments and count), at
  test_torch_train.py::test_one_finetune_step_matches_jax's tolerances;
* (g) ``estimate_population_param_distribution`` (rtol 1e-5) and
  ``load_real_directory`` (exactly) against the JAX functions.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
from flax import serialization  # noqa: E402

from torch_parity_utils import _fields, own_save_dir  # noqa: E402
from qbold_vi_tpu import config as jcfg  # noqa: E402
from qbold_vi_tpu.train import data as jdata  # noqa: E402
from qbold_vi_tpu.train import optim as joptim  # noqa: E402
from qbold_vi_tpu.train import trainer as jtrainer  # noqa: E402
from qbold_vi_tpu.train.steps import make_finetune_step  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402
from qbold_vi_tpu_torch.io import msgpack_lite as ml  # noqa: E402
from qbold_vi_tpu_torch.io.from_jax import state_dict_from_jax  # noqa: E402
from qbold_vi_tpu_torch.models.vi import init_params  # noqa: E402
from qbold_vi_tpu_torch.train import checkpoint as tck  # noqa: E402
from qbold_vi_tpu_torch.train import data as tdata  # noqa: E402
from qbold_vi_tpu_torch.train import optim as toptim  # noqa: E402
from qbold_vi_tpu_torch.train import steps as tsteps  # noqa: E402
from qbold_vi_tpu_torch.train import trainer as ttrainer  # noqa: E402

W = ttrainer.WeightStatus


def _jax_cfg(save, **train):
    kw = dict(no_pt_epochs=3, no_ft_epochs=3, pt_batch_size=8,
              ft_batch_size=2, ft_steps_per_epoch=2, crop_size=6,
              save_directory=str(save), swa_start=1, swa_period=1,
              checkpoint_every_epochs=1)
    kw.update(train)
    return jcfg.QBoldConfig(
        scan=jcfg.ScanParams(simulate_noise=False),
        synth=jcfg.SynthParams(sample_size=40),
        model=jcfg.ModelConfig(no_units=4, no_intermediate_layers=1,
                               student_t_df=200.0, use_mvg=True,
                               predict_log_data=False),
        train=jcfg.TrainConfig(**kw))


def _port(cfg):
    return tcfg.QBoldConfig(
        **{g: getattr(tcfg, type(getattr(cfg, g)).__name__)(
            **_fields(getattr(cfg, g)))
           for g in ("scan", "synth", "model", "train")}, name=cfg.name)


def _real(n_taus):
    rng = np.random.default_rng(3)
    real = (np.abs(rng.normal(size=(2, 10, 10, 2, n_taus + 1))) * 50 + 100
            ).astype(np.float32)
    real[..., -1] = 1.0
    return real


class Crash(RuntimeError):
    pass


def _crash_at(phase, epoch):
    def logger(p, e, m):
        if (p, e) == (phase, epoch):
            raise Crash()
    return logger


def _quiet(*a):
    pass


STAGES = ("pt_partial", "pt", "ft_partial", "final")
PHASE = {"pt_partial": "pretrain", "pt": "pretrain",
         "ft_partial": "finetune", "final": "finetune"}
FILE = {"pt_partial": "pt_model.msgpack.partial", "pt": "pt_model.msgpack",
        "ft_partial": "final_model.msgpack.partial",
        "final": "final_model.msgpack"}


def _run_stages(make, root, real):
    """Run pretrain crash -> resume -> finetune crash -> resume with the
    trainers ``make(logger)`` gives in one save directory, copying it after
    each stage to root/<stage>."""
    save = root / "run"
    steps = (
        ("pt_partial", "pretrain", _crash_at("pretrain", 1)),
        ("pt", "pretrain", _quiet),
        ("ft_partial", "finetune", _crash_at("finetune", 1)),
        ("final", "finetune", _quiet))
    for stage, phase, logger in steps:
        t = make(save, logger)
        try:
            t.pretrain() if phase == "pretrain" else t.finetune(real)
        except Crash:
            pass
        shutil.copytree(save, root / stage)


def _clone(state):
    c = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa
    o = state.opt_state
    swa = None if state.swa is None else toptim.SWAState(
        state.swa.step, state.swa.n_avg, c(state.swa.average))
    return tck.TrainState(c(state.params),
                          tck.OptState(o.count, c(o.mu), c(o.nu), o.tail),
                          swa, state.step)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four stages written by the JAX Trainer and by the port (with the
    state each port write saved, by path)."""
    root = tmp_path_factory.mktemp("ckpt")
    cfg = _jax_cfg(root / "jax" / "run")
    real = _real(cfg.scan.n_taus)
    _run_stages(lambda save, lg: jtrainer.Trainer(
        dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, save_directory=str(save))), logger=lg),
        root / "jax", real)

    saved, snaps, orig = {}, {}, ttrainer._save_state

    def recording(path, state, cfg=None, steps_per_epoch=0):
        saved[os.path.basename(path)] = _clone(state)
        return orig(path, state, cfg=cfg, steps_per_epoch=steps_per_epoch)

    def make_port(save, logger):
        snaps[len(snaps)] = dict(saved)
        return ttrainer.Trainer(_port(dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train,
                                           save_directory=str(save)))),
            device="cpu", logger=logger)

    ttrainer._save_state = recording
    try:
        _run_stages(make_port, root / "port", real)
    finally:
        ttrainer._save_state = orig
    snaps[len(snaps)] = dict(saved)
    # the port's states on disk after each stage
    port_saved = {stage: snaps[i + 1] for i, stage in enumerate(STAGES)}
    return {"root": root, "cfg": cfg, "real": real, "port_saved": port_saved}


def _at(cfg, d):
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, save_directory=str(d)))


def _jax_view(state) -> dict:
    """A JAX TrainState in the port's layout (the bridge's)."""
    tree = lambda t: state_dict_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t))
    adam = state.opt_state[0]
    counts = [int(adam.count)] + [int(s.count) for s in state.opt_state[1:]
                                  if hasattr(s, "count")]
    swa = None
    if state.swa is not None:
        swa = (int(state.swa.step), int(state.swa.n_avg),
               tree(state.swa.average))
    return {"params": tree(state.params), "mu": tree(adam.mu),
            "nu": tree(adam.nu), "counts": counts, "swa": swa,
            "step": int(state.step)}


def _port_view(state) -> dict:
    o = state.opt_state
    swa = None
    if state.swa is not None:
        swa = (state.swa.step, state.swa.n_avg, state.swa.average)
    return {"params": state.params, "mu": o.mu, "nu": o.nu,
            "counts": [o.count] + [o.count for has in o.tail if has],
            "swa": swa, "step": state.step}


def _assert_views_equal(a, b):
    assert a["counts"] == b["counts"] and a["step"] == b["step"]
    assert (a["swa"] is None) == (b["swa"] is None)
    pairs = [("params", a["params"], b["params"]), ("mu", a["mu"], b["mu"]),
             ("nu", a["nu"], b["nu"])]
    if a["swa"] is not None:
        assert a["swa"][:2] == b["swa"][:2]
        pairs.append(("swa", a["swa"][2], b["swa"][2]))
    for tag, x, y in pairs:
        assert set(x) == set(y), tag
        for k in x:
            assert torch.equal(x[k].cpu(), y[k].cpu()), f"{tag} {k}"
    assert any(float(v.abs().max()) > 0 for v in a["nu"].values())


def _jax_restore(cfg, stage, d):
    """(status, TrainState, start epoch) of a JAX Trainer on directory
    ``d``: the state it resumes, or for a .partial its _phase_start's."""
    jt = jtrainer.Trainer(_at(cfg, d), logger=_quiet)
    if not stage.endswith("partial"):
        return jt.status, jt.state, None
    if PHASE[stage] == "pretrain":
        spe = 1                    # 2 training pseudo-volumes, batch 8
        state, start = jt._phase_start(
            jt.pt_path, swa=cfg.train.use_swa,
            optimizer=joptim.make_pretrain_optimizer(cfg.train),
            steps_per_epoch=spe)
    else:
        state, start = jt._phase_start(
            jt.final_path, swa=False,
            optimizer=joptim.make_finetune_optimizer(cfg.train),
            steps_per_epoch=cfg.train.ft_steps_per_epoch)
    return jt.status, state, start


def _port_restore(cfg, stage, d):
    """(Trainer on ``d``, TrainState, start epoch): the file the Trainer
    resumed, read again, with the Trainer's weights checked against it;
    for a .partial its _phase_start's."""
    t = ttrainer.Trainer(_port(_at(cfg, d)), device="cpu", logger=_quiet)
    if not stage.endswith("partial"):
        state = t._load_state(str(d / FILE[stage]), PHASE[stage])
        for k, v in state.params.items():
            assert torch.equal(t.tuner.state_dict()[k], v), k
        return t, state, None
    if PHASE[stage] == "pretrain":
        state, start = t._phase_start(t.pt_path, "pretrain", 1)
    else:
        state, start = t._phase_start(t.final_path, "finetune",
                                      cfg.train.ft_steps_per_epoch)
    return t, state, start


# ---- (a) the codec --------------------------------------------------------

def _length_cases(kind):
    if kind == "int":
        return [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    if kind == "float":
        return [0.0, -0.0, 1.5, -3.25e-300, float("inf"), 1e308]
    if kind == "nil/bool":
        return [None, True, False]
    sizes = {"str": (0, 31, 32, 255, 256, 65535, 65536),
             "bin": (0, 1, 255, 256, 65535, 65536),
             "array": (0, 15, 16, 65535, 65536),
             "map": (0, 15, 16, 65535, 65536),
             "ext": (1, 2, 3, 4, 8, 16, 17, 255, 256, 65535, 65536)}[kind]
    make = {"str": lambda n: "é" * (n // 2) + "x" * (n % 2),
            "bin": lambda n: bytes(range(256)) * (n // 256) + b"y" * (n % 256),
            "array": lambda n: list(range(n)),
            "map": lambda n: {f"k{i}": i for i in range(n)},
            "ext": lambda n: ml.Ext(5, b"z" * n)}[kind]
    return [make(n) for n in sizes]


@pytest.mark.parametrize("kind", ["int", "float", "nil/bool", "str", "bin",
                                  "array", "map", "ext"])
def test_codec_matches_msgpack(kind):
    """Every int width, float64 (and float32 on reading), every str / bin /
    array / map / ext length class: the msgpack package's bytes, and its
    bytes decoded to the same value."""
    for v in _length_cases(kind):
        ref_v = msgpack.ExtType(v.code, v.data) if kind == "ext" else v
        ref = msgpack.packb(ref_v, use_bin_type=True)
        assert ml.packb(v) == ref, (kind, repr(v)[:40])
        assert ml.unpackb(ref) == v
    if kind == "float":
        for v in (1.25, -2.5e30, float("-inf")):
            single = msgpack.packb(v, use_single_float=True)
            assert single[0] == 0xCA
            assert ml.unpackb(single) == msgpack.unpackb(single)


def _assert_same_tree(a, b):
    assert type(a) is type(b) or (isinstance(a, np.generic)
                                  and isinstance(b, np.generic))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b)
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("stage", STAGES)
def test_codec_reads_and_writes_the_jax_files(runs, stage):
    """A file of the JAX Trainer decodes to flax's tree (keys in order,
    dtypes, numpy scalars), and flax's state dict encodes to the file's
    bytes."""
    with open(runs["root"] / "jax" / stage / FILE[stage], "rb") as f:
        raw = f.read()
    ref = serialization.msgpack_restore(raw)
    _assert_same_tree(ml.unpackb(raw), ref)
    assert ml.packb(tck._sorted(ref)) == raw
    assert list(ref) == ["__meta__", "opt_state", "params", "step", "swa"]


def test_codec_refuses_chunked_arrays_and_bf16():
    chunked = {"w": serialization._chunk(np.zeros(6, np.float32))}
    with pytest.raises(ValueError, match="chunked"):
        ml.unpackb(serialization.msgpack_serialize(chunked))
    bf16 = serialization.msgpack_serialize(
        {"w": np.asarray(jnp.ones(3, jnp.bfloat16))})
    with pytest.raises(ValueError, match="bfloat16"):
        ml.unpackb(bf16)
    with pytest.raises(ValueError, match="bfloat16"):
        ml.packb({"w": np.asarray(jnp.ones(3, jnp.bfloat16))})
    with pytest.raises(ValueError, match="trailing"):
        ml.unpackb(msgpack.packb(1) + b"\x01")


# ---- (b) the fingerprint ----------------------------------------------------

FP_VARIANTS = {
    "optimal": {},
    "narrow": {"no_units": 8, "no_intermediate_layers": 1},
    "24 taus": {"tau_start": -0.028, "tau_step": 0.004},
    "pop prior": {"use_population_prior": True, "use_mvg": False},
}


@pytest.mark.parametrize("legacy", [False, True])
@pytest.mark.parametrize("variant", sorted(FP_VARIANTS))
def test_fingerprint_matches_jax(variant, legacy):
    """The JAX function's fingerprint (and legacy one) for OPTIMAL and
    three variants; the runtime-only switches leave it unchanged (and
    change the legacy one, which keeps them, except fused_conv)."""
    over = FP_VARIANTS[variant]
    j = jcfg.apply_flat_overrides(jcfg.OPTIMAL, over)
    t = tcfg.apply_flat_overrides(tcfg.OPTIMAL, over)
    want = jtrainer._config_fingerprint(j, legacy=legacy)
    got = tck._config_fingerprint(t, legacy=legacy)
    assert isinstance(got, np.uint64) and got == want and got != 0
    runtime = tcfg.apply_flat_overrides(t, {
        "compute_dtype": "bfloat16", "quad_rule": "gj16",
        "fused_infer": "off", "fused_conv": "on", "simulate_noise": False,
        "snr": 77.0})
    moved = tck._config_fingerprint(runtime, legacy=legacy)
    assert (moved == got) != legacy
    conv = tcfg.apply_flat_overrides(t, {"fused_conv": "on"})
    assert tck._config_fingerprint(conv, legacy=legacy) == got


# ---- (c) JAX -> port ----------------------------------------------------------

@pytest.mark.parametrize("stage", STAGES)
def test_port_resumes_jax_checkpoints(runs, stage):
    """The port resumes the JAX Trainer's file to the JAX Trainer's status
    and start epoch, with the same tensors after the bridge, and writes
    the file's bytes back from them."""
    cfg, d = runs["cfg"], runs["root"] / "jax" / stage
    j_status, j_state, j_start = _jax_restore(cfg, stage, d)
    t, state, start = _port_restore(cfg, stage, d)
    assert t.status.name == j_status.name
    assert start == j_start
    if stage.endswith("partial"):
        assert start == 1
    _assert_views_equal(_port_view(state), _jax_view(j_state))
    with open(d / FILE[stage], "rb") as f:
        raw = f.read()
    spe = int(ml.unpackb(raw)["__meta__"]["steps_per_epoch"])
    out = str(runs["root"] / f"rewritten_{stage}")
    n = tck._save_state(out, state, cfg=t.cfg, steps_per_epoch=spe)
    with open(out, "rb") as f:
        assert f.read() == raw and n == len(raw)


def test_port_finishes_the_jax_runs(runs, tmp_path):
    """From the JAX .partial files the port's phases resume at epoch 1,
    load the saved moments into its optimiser, finish, write the phase's
    file and remove the .partial."""
    cfg = runs["cfg"]
    d = tmp_path / "pt"
    shutil.copytree(runs["root"] / "jax" / "pt_partial", d)
    logged = []
    t = ttrainer.Trainer(_port(_at(cfg, d)), device="cpu",
                         logger=lambda p, e, m: logged.append((p, e)))
    assert t.status is W.NOT_TRAINED
    t.pretrain()
    assert logged == [("pretrain", 1), ("pretrain", 2)]
    assert os.path.isfile(t.pt_path) and not os.path.exists(
        t.pt_path + ".partial")

    d = tmp_path / "ft"
    shutil.copytree(runs["root"] / "jax" / "ft_partial", d)
    t = ttrainer.Trainer(_port(_at(cfg, d)), device="cpu",
                         logger=lambda p, e, m: logged.append((p, e)))
    assert t.status is W.PRE_TRAINED
    _, j_state, _ = _jax_restore(cfg, "ft_partial", d)
    t.finetune(runs["real"], epochs=0)        # resumes, runs no epoch
    assert t.epochs_done == 1 and t.optimizer.count == 2
    names = [n for n, _ in t.tuner.named_parameters()]
    ref = _jax_view(j_state)
    for i, name in enumerate(names):
        assert torch.equal(t.optimizer.mu[i], ref["mu"][name]), name
        assert torch.equal(t.optimizer.nu[i], ref["nu"][name]), name
        assert torch.equal(t.tuner.state_dict()[name], ref["params"][name])
    del logged[:]
    t.finetune(runs["real"])
    assert logged == [("finetune", 1), ("finetune", 2)]
    assert t.status is W.FULL_TRAINED and t.optimizer.count == 6
    assert os.path.isfile(t.final_path) and not os.path.exists(
        t.final_path + ".partial")


# ---- (d) port -> JAX ----------------------------------------------------------

@pytest.mark.parametrize("stage", STAGES)
def test_jax_resumes_port_checkpoints(runs, stage):
    """The JAX Trainer resumes the port's file, accepting its (non-zero)
    fingerprint, to a state equal to the tensors the port saved."""
    cfg, d = runs["cfg"], runs["root"] / "port" / stage
    with open(d / FILE[stage], "rb") as f:
        meta = serialization.msgpack_restore(f.read())["__meta__"]
    assert int(meta["fingerprint"]) == int(jtrainer._config_fingerprint(cfg))
    assert int(meta["fingerprint"]) != 0
    j_status, j_state, j_start = _jax_restore(cfg, stage, d)
    assert j_status.name == {"pt_partial": "NOT_TRAINED", "pt": "PRE_TRAINED",
                             "ft_partial": "PRE_TRAINED",
                             "final": "FULL_TRAINED"}[stage]
    assert j_start == (1 if stage.endswith("partial") else None)
    saved = runs["port_saved"][stage][FILE[stage]]
    _assert_views_equal(_jax_view(j_state), _port_view(saved))


# ---- (e) mismatches ---------------------------------------------------------

def _tiny_port(tmp_path, **train):
    return own_save_dir(_port(_jax_cfg("unused", **train)), tmp_path)


def test_fingerprint_and_layout_mismatches_raise(runs, tmp_path):
    """A changed architecture raises CheckpointMismatchError naming the
    fingerprints; a changed optimiser (adamw_decay 0: optax.adam's layout)
    raises on the layout; the runtime-only switches restore; a Trainer
    given state_dict= refuses a directory with a checkpoint."""
    cfg = runs["cfg"]
    d = runs["root"] / "port" / "final"
    base = _port(_at(cfg, d))
    changed = tcfg.apply_flat_overrides(base, {"no_units": 8})
    with pytest.raises(tck.CheckpointMismatchError, match="fingerprint"):
        ttrainer.Trainer(changed, device="cpu")
    plain = tcfg.apply_flat_overrides(base, {"adamw_decay": 0.0})
    with pytest.raises(tck.CheckpointMismatchError, match="optimiser"):
        ttrainer.Trainer(plain, device="cpu")
    runtime = tcfg.apply_flat_overrides(base, {
        "compute_dtype": "float32", "quad_rule": "gj16",
        "fused_infer": "off", "simulate_noise": False, "snr": 77.0})
    assert ttrainer.Trainer(runtime, device="cpu").status is W.FULL_TRAINED
    weights = init_params(base.model, base.scan,
                          torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="final_model.msgpack"):
        ttrainer.Trainer(base, state_dict=weights, device="cpu")


@pytest.mark.parametrize("stage", STAGES)
def test_given_weights_refuse_a_checkpoint_unless_asked(runs, tmp_path,
                                                        stage):
    """A Trainer given state_dict= raises ValueError naming whatever file
    of save_directory it would otherwise resume or pass over; only the
    fine-tune's .partial is resumed, and only under resume_partial=True,
    its weights replacing the given ones."""
    cfg = runs["cfg"]
    d = tmp_path / stage
    d.mkdir()
    shutil.copy(runs["root"] / "port" / stage / FILE[stage], d)
    base = _port(_at(cfg, d))
    weights = init_params(base.model, base.scan,
                          torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match=FILE[stage].replace(".", r"\.")):
        ttrainer.Trainer(base, state_dict=weights, device="cpu")
    if stage != "ft_partial":
        with pytest.raises(ValueError, match="resume_partial"):
            ttrainer.Trainer(base, state_dict=weights, resume_partial=True,
                             device="cpu")
        return
    t = ttrainer.Trainer(base, state_dict=weights, resume_partial=True,
                         device="cpu", logger=_quiet)
    t.finetune(runs["real"], epochs=0)          # resumes, runs no epoch
    saved = runs["port_saved"][stage][FILE[stage]]
    assert t.epochs_done == 1
    for k, v in saved.params.items():
        assert torch.equal(t.tuner.state_dict()[k], v), k


def test_partial_steps_per_epoch_mismatch_raises(runs, tmp_path):
    cfg = runs["cfg"]
    d = tmp_path / "ft"
    shutil.copytree(runs["root"] / "port" / "ft_partial", d)
    changed = tcfg.apply_flat_overrides(_port(_at(cfg, d)),
                                        {"ft_steps_per_epoch": 5})
    t = ttrainer.Trainer(changed, device="cpu", logger=_quiet)
    with pytest.raises(tck.CheckpointMismatchError, match="steps/epoch"):
        t.finetune(runs["real"])


def test_unversioned_and_legacy_checkpoints_load(runs, tmp_path):
    """A file without __meta__, one with fingerprint 0 (no config), and one
    with the legacy fingerprint restore under an unchanged config."""
    cfg = runs["cfg"]
    src = runs["root"] / "port" / "pt" / "pt_model.msgpack"
    with open(src, "rb") as f:
        tree = ml.unpackb(f.read())
    state = tck._load_state(str(src), _port(cfg), tail=tck.opt_tail(
        "pretrain", _port(cfg).train), swa=True)
    legacy = dict(tree, __meta__=dict(
        tree["__meta__"],
        fingerprint=tck._config_fingerprint(_port(cfg), legacy=True)))
    assert int(legacy["__meta__"]["fingerprint"]) != int(
        tree["__meta__"]["fingerprint"])
    variants = {"unversioned": {k: v for k, v in tree.items()
                                if k != "__meta__"},
                "legacy": legacy}
    for name, t_ in variants.items():
        d = tmp_path / name
        d.mkdir()
        with open(d / "pt_model.msgpack", "wb") as f:
            f.write(ml.packb(t_))
    d = tmp_path / "no_config"
    tck._save_state(str(d / "pt_model.msgpack"), state)
    with open(d / "pt_model.msgpack", "rb") as f:
        assert int(ml.unpackb(f.read())["__meta__"]["fingerprint"]) == 0
    for name in ("unversioned", "legacy", "no_config"):
        t = ttrainer.Trainer(_port(_at(cfg, tmp_path / name)), device="cpu")
        assert t.status is W.PRE_TRAINED, name
        for k, v in state.params.items():
            assert torch.equal(t.tuner.state_dict()[k], v), (name, k)
        # the JAX Trainer restores them too
        assert jtrainer.Trainer(_at(cfg, tmp_path / name)).status.name == \
            "PRE_TRAINED"


def test_nan_tripwire_vetoes_the_checkpoint(tmp_path, monkeypatch):
    """A non-finite epoch raises NaNLossError before its .partial is
    written: the file keeps the last finite epoch's state."""
    cfg = _tiny_port(tmp_path)
    real = _real(cfg.scan.n_taus)
    weights = init_params(cfg.model, cfg.scan,
                          torch.Generator().manual_seed(0))
    t = ttrainer.Trainer(cfg, state_dict=weights, device="cpu",
                         logger=_quiet)
    t.finetune(real, epochs=1)
    partial = t.final_path + ".partial"
    with open(partial, "rb") as f:
        before = f.read()
    real_epoch = ttrainer.make_finetune_epoch_on_device

    def poisoned(*a, **kw):
        fn = real_epoch(*a, **kw)

        def epoch(*b):
            m = fn(*b)
            return dict(m, loss=m["loss"] * float("nan"))
        return epoch

    monkeypatch.setattr(ttrainer, "make_finetune_epoch_on_device", poisoned)
    with pytest.raises(ttrainer.NaNLossError):
        t.finetune(real, epochs=1)
    with open(partial, "rb") as f:
        assert f.read() == before
    assert ml.unpackb(before)["step"] == cfg.train.ft_steps_per_epoch
    assert not os.path.exists(t.final_path)


@pytest.mark.parametrize("case", ["finetune decay", "finetune adam",
                                  "pretrain swa", "pretrain adam"])
def test_optimizer_layout_matches_optax(case):
    """opt_tail's layout is the one flax writes for optax's state of each
    phase's optimiser (the adamw_decay == 0 fine-tune included), counts
    int32, moments shaped like the params."""
    phase, kind = case.split()
    train = jcfg.TrainConfig(adamw_decay=0.0 if kind == "adam" else 2e-4,
                             use_swa=kind == "swa")
    mcfg = jcfg.ModelConfig(no_units=4, use_mvg=True)
    ptrain = _port(jcfg.QBoldConfig(model=mcfg, train=train)).train
    make = (joptim.make_finetune_optimizer if phase == "finetune"
            else joptim.make_pretrain_optimizer)
    sd = init_params(tcfg.ModelConfig(**_fields(mcfg)), tcfg.ScanParams(),
                     torch.Generator().manual_seed(0))
    tree = tck.jax_from_state_dict(sd)
    ref = serialization.to_state_dict(jax.tree_util.tree_map(
        np.asarray, make(train).init(jax.tree_util.tree_map(jnp.asarray,
                                                            tree))))
    zeros = {k: torch.zeros_like(v) for k, v in sd.items()}
    state = tck.TrainState(sd, tck.OptState(0, zeros, zeros,
                                            tck.opt_tail(phase, ptrain)),
                           None, 0)
    got = tck._state_tree(state)["opt_state"]
    assert ml.packb(tck._sorted(got)) == ml.packb(tck._sorted(ref))


# ---- (f) one step from a restored .partial --------------------------------

def _step_cfg(runs):
    return dataclasses.replace(runs["cfg"], train=dataclasses.replace(
        runs["cfg"].train, fused_elbo="off", fused_decode_nll="off"))


@pytest.fixture(scope="module")
def jax_step(runs):
    """The JAX Trainer's .partial restored and stepped once on one batch
    (the batch, noise derivation and key of
    test_one_finetune_step_matches_jax), and the gradient of that step."""
    from qbold_vi_tpu.train.steps import _finetune_terms

    cfg = _step_cfg(runs)
    d = runs["root"] / "jax" / "ft_partial"
    _, j_state, _ = _jax_restore(cfg, "ft_partial", d)
    assert int(j_state.opt_state[0].count) == 2
    jt = jtrainer.Trainer(_at(cfg, d), logger=_quiet)
    rng = np.random.default_rng(21)
    shape = (2, 6, 5, 2)
    mask = (rng.uniform(size=shape + (1,)) > 0.2).astype(np.float32)
    batch = {"images": (np.abs(rng.normal(size=shape + (11,))) * 50 + 100
                        ).astype(np.float32) * mask,
             "mask": mask,
             "priors": (rng.normal(size=shape + (5,)) * 0.3
                        ).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = joptim.make_finetune_optimizer(cfg.train)
    grads = jax.jit(jax.grad(lambda p, key: _finetune_terms(
        p, key, jbatch, jt.tuner, cfg)[0]))(
        jax.tree_util.tree_map(jnp.asarray, j_state.params),
        jax.random.PRNGKey(8))
    state = jax.tree_util.tree_map(jnp.array, j_state)        # donated
    key = jax.random.PRNGKey(8)
    new_state, aux = make_finetune_step(jt.tuner, cfg, opt)(state, key,
                                                            jbatch)
    k_sample, k_kl = jax.random.split(key)
    k_draw = jax.random.split(k_sample)[0]

    def draws(k, s):
        return np.array(jax.vmap(lambda kk: jax.random.normal(
            kk, shape + (2,)))(jax.random.split(k, s)))

    tree = lambda t: state_dict_from_jax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, t))
    return {"batch": batch, "loss": float(aux["loss"]),
            "noise": {"z_nll": draws(k_draw, 1), "z_kl": draws(k_kl, 70)},
            "after": tree(new_state.params), "grads": tree(grads)}


@pytest.mark.parametrize("path", ["F", "plain"])
def test_one_step_from_a_restored_partial_matches_jax(runs, jax_step, path):
    """Each framework restores the JAX .partial of the fine-tune (moments
    and count non-zero) and takes one step on one batch with the same
    noise: the loss at rtol 1e-5, the updates at
    test_one_finetune_step_matches_jax's tolerances. A moment left in the
    JAX layout would move the port's update."""
    cfg = _step_cfg(runs)
    d = runs["root"] / "jax" / "ft_partial"
    tc = tcfg.apply_flat_overrides(_port(_at(cfg, d)), {
        "fused_elbo": "on" if path == "F" else "off"})
    t = ttrainer.Trainer(tc, device="cpu", logger=_quiet)
    p_state, start = t._phase_start(t.final_path, "finetune",
                                    tc.train.ft_steps_per_epoch)
    assert start == 1
    t._load_params(p_state.params)
    topt = toptim.make_finetune_optimizer(t.tuner.parameters(), tc.train)
    tck.restore_optimizer(topt, t.tuner, p_state.opt_state)
    before = {k: v.clone() for k, v in t.tuner.state_dict().items()}
    aux = tsteps.make_finetune_step(t.tuner, tc, topt)(
        {k: torch.from_numpy(v) for k, v in jax_step["batch"].items()},
        noise=jax_step["noise"])
    np.testing.assert_allclose(float(aux["loss"]), jax_step["loss"],
                               rtol=1e-5)
    lr = tc.train.ft_lr
    for name, p in t.tuner.state_dict().items():
        delta = (p - before[name]).numpy()
        delta_ref = (jax_step["after"][name] - before[name]).numpy()
        g = np.abs(jax_step["grads"][name].numpy())
        clear = g > 1e-3 * (g.max() + 1e-30)
        err = np.abs(delta - delta_ref)
        assert np.all(err[clear] <= 1e-6 + 1e-4 * np.abs(delta_ref[clear])), \
            name
        assert np.all(err <= 2.0 * lr), name
    assert topt.count == 3


# ---- (g) population stats and the real-data directory -----------------------

def test_population_stats_match_jax(runs):
    """estimate_population_param_distribution of the fine-tuned weights on
    a masked study set, at rtol 1e-5."""
    cfg = runs["cfg"]
    d = runs["root"] / "jax" / "final"
    rng = np.random.default_rng(5)
    data = (np.abs(rng.normal(size=(2, 8, 8, 2, 12))) * 50 + 100
            ).astype(np.float32)
    data[..., -1] = rng.uniform(size=data.shape[:-1]) > 0.3
    ref = jtrainer.Trainer(_at(cfg, d)).estimate_population_param_distribution(
        data)
    got = ttrainer.Trainer(_port(_at(cfg, d)), device="cpu"
                           ).estimate_population_param_distribution(data)
    assert set(got) == set(ref) == {"mean_oef", "log_std_oef", "mean_dbv",
                                    "log_std_dbv"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("files", [
    ("ASE_scan", "ASE_INF", "ASE_SUP", "hyperv_ase", "baseline_ase"),
    ("ASE_INF", "hyperv_ase"), ("baseline_ase",), ()])
def test_load_real_directory_matches_jax(tmp_path, files):
    rng = np.random.default_rng(len(files))
    for name in files:
        extra = 2 if name in ("hyperv_ase", "baseline_ase") else 1
        np.save(tmp_path / f"{name}.npy", rng.normal(
            size=(1 + len(name) % 3, 4, 3, 2, 11 + extra)).astype(np.float32))
    ref = jdata.load_real_directory(str(tmp_path))
    got = tdata.load_real_directory(str(tmp_path))
    assert set(got) == set(ref) == {"train", "study", "hyperv", "baseline"}
    for k in ref:
        assert (got[k] is None) == (ref[k] is None), k
        if ref[k] is not None:
            np.testing.assert_array_equal(got[k], ref[k])


def test_missing_population_prior_is_topped_up(runs, tmp_path):
    """A pt checkpoint without pop_prior (fingerprint 0, e.g. written
    without a config) restored under a config with a population prior:
    the encoder from the file, pop_prior from init_params, as the JAX
    fine-tune tops it up (trainer.py:669-672); the pretrained weights of
    pretrained_encode_fn carry it too."""
    cfg = runs["cfg"]
    src = str(runs["root"] / "port" / "pt" / "pt_model.msgpack")
    pcfg = _port(cfg)
    state = tck._load_state(src, pcfg, tail=tck.opt_tail(
        "pretrain", pcfg.train), swa=True)
    tck._save_state(str(tmp_path / "pt_model.msgpack"), state)
    pop = tcfg.apply_flat_overrides(_port(_at(cfg, tmp_path)),
                                    {"use_population_prior": True})
    t = ttrainer.Trainer(pop, device="cpu", logger=_quiet)
    assert t.status is W.PRE_TRAINED and "pop_prior" not in state.params
    np.testing.assert_allclose(t.tuner.pop_prior.detach().numpy(),
                               [-0.97, 0.4, -1.14, 0.6, 0.0])
    for k, v in state.params.items():
        assert torch.equal(t.tuner.state_dict()[k], v), k
    t.status = W.FULL_TRAINED                  # read the pt file again
    assert "pop_prior" in t.pretrained_params()
    assert t.pretrained_encode_fn() is not None


def test_finetune_val_metrics(runs, tmp_path):
    """The ELBO validation of the current weights: it reuses the study
    crops of finetune(study_data=) (the priors of the encoder fine-tuning
    started from); a restored Trainer needs study_data (priors from the
    current encoder, as in the JAX trainer) and raises ValueError without;
    a NOT_TRAINED one raises RuntimeError."""
    cfg = runs["cfg"]
    real = runs["real"]
    keys = {"val_nll", "val_kl", "val_smoothness", "val_elbo"}
    restored = ttrainer.Trainer(_port(_at(cfg, runs["root"] / "port" /
                                          "final")), device="cpu")
    with pytest.raises(ValueError, match="study_data"):
        restored.finetune_val_metrics()
    m = restored.finetune_val_metrics(real)
    assert keys <= set(m) and all(np.isfinite(v) for v in m.values())
    with pytest.raises(RuntimeError, match="no trained weights"):
        ttrainer.Trainer(_port(_at(cfg, tmp_path / "empty")),
                         device="cpu").finetune_val_metrics(real)
    weights = {k: v.clone() for k, v in restored.tuner.state_dict().items()}
    t = ttrainer.Trainer(_tiny_port(tmp_path, checkpoint_every_epochs=0),
                         state_dict=weights, device="cpu", logger=_quiet)
    t.finetune(real, study_data=real[:1], epochs=1)
    study = t._ft_samplers[1]
    m = t.finetune_val_metrics(real)        # reuses finetune's crops
    assert t._ft_samplers[1] is study
    assert keys <= set(m) and all(np.isfinite(v) for v in m.values())


def test_finetune_val_metrics_matches_jax(runs, monkeypatch):
    """The ELBO validation of a restored final_model.msgpack, called twice
    on one port Trainer with two study sets, against a fresh JAX Trainer's
    first call on each set (the JAX trainer scores its first set again on
    later calls), every draw pinned to 0.5 in both frameworks: the same
    crops, priors and metrics at rtol 1e-5. A port that kept the first
    set's crops or priors would score set A twice."""
    cfg = runs["cfg"]
    d = runs["root"] / "jax" / "final"
    rng = np.random.default_rng(11)
    sets = []
    for scale in (1.0, 1.7):
        s = (np.abs(rng.normal(size=(3, 10, 10, 2, cfg.scan.n_taus + 1)))
             * 50 * scale + 100).astype(np.float32)
        s[..., -1] = rng.uniform(size=s.shape[:-1]) > 0.2
        sets.append(s)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=jnp.float32:
                        jnp.full(shape, 0.5, dtype))
    monkeypatch.setattr(tsteps, "normals", lambda seed, shape, device:
                        torch.full(shape, 0.5, device=device))
    ref = [{k: float(v) for k, v in jtrainer.Trainer(
        _at(cfg, d), logger=_quiet).finetune_val_metrics(s).items()}
        for s in sets]
    t = ttrainer.Trainer(_port(_at(cfg, d)), device="cpu", logger=_quiet)
    got = [t.finetune_val_metrics(s) for s in sets]
    assert abs(ref[0]["val_elbo"] - ref[1]["val_elbo"]) > 1e-3 * abs(
        ref[0]["val_elbo"])
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            np.testing.assert_allclose(g[k], r[k], rtol=1e-5, err_msg=k)
