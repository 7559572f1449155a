"""The port's sweep (qbold_vi_tpu_torch/sweep.py) on the CPU: the search
grammar, the searches, the serial objectives, the wandb agent and the
CLI's ``sweep``.

* ``parse_wandb_sweep`` / ``_normalise_space`` on configurations/
  sweep_prior.yaml equal the JAX results exactly, and so does
  chip_smoke.py's literal of that file (the card has no pyyaml);
* ``random_search`` and ``bayes_search`` (seeds 0 and 1, n_startup below
  and above the trial count, serial and parallel_trials 3 with a counting
  population stand-in) propose the JAX override sequence exactly, under
  tests/test_sweep.py's objective (a noisy quadratic from a seeded
  generator: the same values on both sides);
* failed and NaN trials rank last, ``maximize`` flips the order, and a
  typo'd dimension raises before any trial;
* ``_default_run`` and ``full_run`` on the port's Trainer (tiny widths,
  ``device="cpu"``): finite ranking metrics, the trial directories'
  checkpoints, the no-study fallback;
* the wandb-agent cases of tests/test_sweep.py:329-543 with a stand-in
  module, and the repair of the JAX batcher's stall (an executor that
  escapes releases every waiting agent thread at once with a failed
  result);
* ``python -m qbold_vi_tpu_torch sweep`` through ``cli.main``: a grid and
  a --space search at a tiny width, ranked JSON, no exit 2.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

import test_torch_stream_pretrain as tsp  # noqa: E402
from qbold_vi_tpu import config as jcfg  # noqa: E402
from qbold_vi_tpu import sweep as jsweep  # noqa: E402
from qbold_vi_tpu_torch import sweep as tsweep  # noqa: E402
from qbold_vi_tpu_torch.cli import main  # noqa: E402
from qbold_vi_tpu_torch.config import (QBoldConfig, ScanParams,  # noqa: E402
                                       SynthParams, ModelConfig, TrainConfig,
                                       UnknownConfigKeyError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRIOR_YAML = os.path.join(REPO, "configurations", "sweep_prior.yaml")
SPACE = {"gate_offset": ("uniform", -6.0, 0.0),
         "pt_lr": ("log_uniform", 1e-5, 1e-1)}
CHOICES = dict(SPACE, crop_size=("choice", [16, 20, 25]),
               no_units=("fixed", 30))


def _objective_factory(noise=0.05, seed=0):
    """tests/test_sweep.py's objective: a noisy quadratic in gate_offset
    (optimum -3) plus a log-scale pt_lr bowl at 2e-3."""
    rng = np.random.default_rng(seed)

    def run(cfg):
        y = ((cfg.model.gate_offset + 3.0) ** 2
             + (np.log10(cfg.train.pt_lr) - np.log10(2e-3)) ** 2
             + rng.normal() * noise)
        return {"val_elbo": float(y)}

    return run


def _tiny(tmp_path, **train):
    return QBoldConfig(
        scan=ScanParams(simulate_noise=False),
        synth=SynthParams(sample_size=40),
        model=ModelConfig(no_units=4, no_intermediate_layers=1,
                          use_mvg=True, student_t_df=200.0,
                          predict_log_data=False),
        train=TrainConfig(**dict(dict(no_pt_epochs=1, pt_batch_size=4,
                                      save_directory=str(tmp_path)),
                                 **train)))


def _trial_order(results):
    return [r["overrides"] for r in sorted(results, key=lambda r: r["trial"])]


# ---- the grammar -------------------------------------------------------------

def test_sweep_prior_yaml_parses_as_jax_parses_it():
    with open(PRIOR_YAML) as f:
        spec = yaml.safe_load(f)
    got = tsweep.parse_wandb_sweep(spec)
    assert got == jsweep.parse_wandb_sweep(spec)
    space, metric, goal, method = got
    assert (metric, goal, method) == ("val_elbo", "minimize", "bayes")
    assert space["inv_gamma_alpha"] == ("uniform", 0.1, 10.0)
    assert space["no_units"] == ("fixed", 30)
    for raw in (spec["parameters"], SPACE, CHOICES,
                {"a": [1, 2], "b": [1, 2, 3], "c": 5, "d": [True, False],
                 "e": {"min": 1e-4, "max": 1.0,
                       "distribution": "log_uniform_values"}}):
        assert tsweep._normalise_space(raw) == jsweep._normalise_space(raw)


def test_the_card_phase_space_is_the_yaml():
    """chip_smoke.py's literal of sweep_prior.yaml (the card has no
    pyyaml) is the file's content, and parses to the same space."""
    import chip_smoke

    with open(PRIOR_YAML) as f:
        spec = yaml.safe_load(f)
    assert chip_smoke.SWEEP_PRIOR == spec
    assert tsweep.parse_wandb_sweep(chip_smoke.SWEEP_PRIOR) == \
        jsweep.parse_wandb_sweep(spec)


def test_unsupported_spec_raises():
    with pytest.raises(ValueError, match="unsupported wandb parameter"):
        tsweep._normalise_space({"x": {"distribution": "q_uniform"}})


# ---- the searches against JAX ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_startup", [3, 12])
def test_bayes_search_proposes_the_jax_sequence(tmp_path, seed, n_startup):
    jc = jcfg.QBoldConfig(train=jcfg.TrainConfig(
        save_directory=str(tmp_path)))
    tc = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    kw = dict(n_trials=10, seed=seed, n_startup=n_startup)
    ref = jsweep.bayes_search(jc, CHOICES, run_fn=_objective_factory(seed=7),
                              **kw)
    got = tsweep.bayes_search(tc, CHOICES, run_fn=_objective_factory(seed=7),
                              **kw)
    assert _trial_order(got) == _trial_order(ref)
    assert [r["val_elbo"] for r in got] == [r["val_elbo"] for r in ref]


@pytest.mark.parametrize("seed", [0, 1])
def test_random_search_proposes_the_jax_sequence(tmp_path, seed):
    jc = jcfg.QBoldConfig(train=jcfg.TrainConfig(
        save_directory=str(tmp_path)))
    tc = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    ref = jsweep.random_search(jc, CHOICES, 7, seed=seed,
                               run_fn=_objective_factory(seed=3))
    got = tsweep.random_search(tc, CHOICES, 7, seed=seed,
                               run_fn=_objective_factory(seed=3))
    assert _trial_order(got) == _trial_order(ref)


def _counting_population(objective, calls):
    def pop(cfg, ovs, **kw):
        calls.append(len(ovs))
        return [objective(jcfg.apply_flat_overrides(
            jcfg.QBoldConfig(), ov)) for ov in ovs]
    return pop


@pytest.mark.parametrize("search", ["bayes", "random"])
@pytest.mark.parametrize("seed", [0, 1])
def test_parallel_searches_propose_the_jax_sequence(tmp_path, monkeypatch,
                                                    search, seed):
    """parallel_trials 3 with a counting population stand-in on both
    sides: the same batches (3, 3, 1 of 7 trials) and proposals."""
    jc = jcfg.QBoldConfig(train=jcfg.TrainConfig(
        save_directory=str(tmp_path)))
    tc = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    jcalls, tcalls = [], []
    monkeypatch.setattr(jsweep, "population_pretrain", _counting_population(
        _objective_factory(seed=5), jcalls))
    monkeypatch.setattr(tsweep, "population_pretrain", _counting_population(
        _objective_factory(seed=5), tcalls))
    kw = dict(n_trials=7, seed=seed, parallel_trials=3)
    if search == "bayes":
        kw["n_startup"] = 3
    ref = getattr(jsweep, f"{search}_search")(jc, CHOICES, **kw)
    got = getattr(tsweep, f"{search}_search")(tc, CHOICES, **kw)
    assert tcalls == jcalls == [3, 3, 1]
    assert _trial_order(got) == _trial_order(ref)


# ---- ranking and failures -----------------------------------------------------

def test_failed_and_nan_trials_rank_last_and_maximize_flips(tmp_path):
    cfg = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    vals = iter([0.2, float("nan"), 0.9, 0.5])
    res = tsweep.random_search(cfg, SPACE, 4,
                               run_fn=lambda c: {"val_elbo": next(vals)},
                               maximize=True)
    assert [r["val_elbo"] for r in res[:3]] == [0.9, 0.5, 0.2]
    assert np.isnan(res[-1]["val_elbo"])
    calls = []

    def flaky(c):
        calls.append(c)
        if len(calls) == 2:
            raise FloatingPointError("non-finite loss at epoch 3")
        return {"val_elbo": float(len(calls))}

    res = tsweep.random_search(cfg, SPACE, 3, run_fn=flaky)
    assert res[-1]["status"] == "failed" and "non-finite" in res[-1]["error"]
    assert [r["val_elbo"] for r in res[:2]] == [1.0, 3.0]

    def diverges(c):
        if c.model.gate_offset > -1.0:
            raise RuntimeError("diverged")
        return {"val_elbo": (c.model.gate_offset + 3.0) ** 2}

    res = tsweep.bayes_search(cfg, {"gate_offset": ("uniform", -6.0, 0.0)},
                              12, run_fn=diverges, seed=3)
    ok = [r for r in res if "val_elbo" in r]
    assert ok and all(res.index(r) < len(ok) for r in ok)
    assert all(r["status"] == "failed" for r in res[len(ok):])


def test_a_typod_dimension_raises_before_any_trial(tmp_path):
    cfg = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    calls = []
    bad = {"pt_lrr": ("log_uniform", 1e-4, 1e-2)}
    for search in (tsweep.random_search, tsweep.bayes_search):
        with pytest.raises(UnknownConfigKeyError, match="pt_lr"):
            search(cfg, bad, 3, run_fn=lambda c: calls.append(c) or {})
    assert calls == []


def test_population_batch_failure_is_isolated(tmp_path, monkeypatch):
    """A raising population batch retries its trials one at a time on the
    same device; only the bad trial fails, and ranks last."""
    cfg = tsp._port(jcfg.QBoldConfig(
        scan=jcfg.ScanParams(simulate_noise=False),
        synth=jcfg.SynthParams(sample_size=40),
        model=jcfg.ModelConfig(no_units=4, no_intermediate_layers=1,
                               use_mvg=True, student_t_df=200.0,
                               predict_log_data=False),
        train=jcfg.TrainConfig(no_pt_epochs=1, pt_batch_size=4,
                               save_directory=str(tmp_path))))
    real = tsweep.population_pretrain
    devices = []

    def flaky(cfg_, ovs, *a, **kw):
        devices.append(kw.get("device"))
        if len(ovs) > 1:
            raise RuntimeError("population batch exploded")
        if ovs[0].get("pt_lr") == 666.0:
            raise RuntimeError("bad trial")
        return real(cfg_, ovs, *a, **kw)

    monkeypatch.setattr(tsweep, "population_pretrain", flaky)
    res = tsweep.random_search(cfg, {"pt_lr": ("choice", [1e-3, 666.0])}, 4,
                               parallel_trials=2, seed=0, device="cpu")
    ok = [r for r in res if "error" not in r]
    assert ok and len(ok) < 4
    assert all(np.isfinite(r["val_elbo"]) for r in ok)
    assert all(r["status"] == "failed" for r in res[len(ok):])
    assert set(devices) == {"cpu"}          # the retries stay on the device


# ---- the serial objectives ---------------------------------------------------

def test_default_run_ranks_and_resumes(tmp_path):
    cfg = _tiny(tmp_path)
    first = tsweep._default_run(cfg, device="cpu")
    again = tsweep._default_run(cfg, device="cpu")     # resumes PRE_TRAINED
    assert first["status"] == again["status"] == "PRE_TRAINED"
    assert first["val_elbo"] == first["val_loss"]
    assert np.isfinite(first["val_elbo"]) and np.isfinite(again["val_elbo"])


def _real_dir(tmp_path, study=True):
    rng = np.random.default_rng(0)
    t = ScanParams(simulate_noise=False).n_taus
    d = tmp_path / "data"
    d.mkdir()
    vols = np.abs(rng.normal(size=(3, 40, 30, 2, t + 1))).astype(
        np.float32) * 50 + 100
    vols[..., -1] = 1.0
    np.save(d / "ASE_scan.npy", vols)
    if study:
        s = np.abs(rng.normal(size=(2, 12, 12, 2, t + 2))).astype(
            np.float32) * 50 + 100
        s[..., -2:] = 1.0
        np.save(d / "hyperv_ase.npy", s)
        np.save(d / "baseline_ase.npy", s + 1.0)
    return str(d)


def _full_cfg(tmp_path, data):
    return _tiny(tmp_path / "runs", no_ft_epochs=1, ft_batch_size=2,
                 ft_steps_per_epoch=2, crop_size=6, data_directory=data,
                 swa_start=1, swa_period=1, pt_batch_size=8)


def test_full_run_trains_both_phases_and_ranks(tmp_path):
    cfg = _full_cfg(tmp_path, _real_dir(tmp_path))
    assert tsweep.default_objective(cfg) is tsweep.full_run
    assert tsweep.default_objective(_tiny(tmp_path)) is tsweep._default_run
    res = tsweep.random_search(cfg, {"gate_offset": ("choice", [-3.0, -1.0])},
                               2, run_fn=tsweep.full_run, device="cpu")
    for r in res:
        assert r["status"] == "FULL_TRAINED"
        for k in ("val_elbo", "val_nll", "val_kl"):
            assert np.isfinite(r[k]), (k, r)
    assert res[0]["val_elbo"] <= res[1]["val_elbo"]
    t0 = tmp_path / "runs" / "trial0"
    assert {"pt_model.msgpack", "final_model.msgpack"} <= set(os.listdir(t0))


def test_full_run_without_study_sets_falls_back(tmp_path):
    cfg = _full_cfg(tmp_path, _real_dir(tmp_path, study=False))
    with pytest.warns(UserWarning, match="study sets"):
        out = tsweep.full_run(cfg, device="cpu")
    assert out["status"] == "FULL_TRAINED"
    assert out["val_elbo"] == out["train_elbo"]
    empty = tmp_path / "none"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="ASE training volumes"):
        tsweep.full_run(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, data_directory=str(empty))), device="cpu")


def test_grid_sweep_runs_each_cell_in_its_directory(tmp_path):
    seen = []

    def spy(c):
        seen.append((c.model.no_intermediate_layers, c.model.no_units,
                     c.train.seed, c.train.save_directory))
        return {"val_elbo": 1.0}

    res = tsweep.run_grid_sweep(_tiny(tmp_path), layers=(1, 2), units=(3,),
                                seeds=2, run_fn=spy)
    assert [(r["layers"], r["units"], r["seed"]) for r in res] == \
        [(1, 3, 0), (1, 3, 1), (2, 3, 0), (2, 3, 1)]
    assert len({s[3] for s in seen}) == 4


# ---- the wandb agent ---------------------------------------------------------------

class FakeRun:
    def __init__(self, config):
        self.config, self.logged, self.finished = config, [], False

    def log(self, m):
        self.logged.append(m)

    def finish(self, exit_code=0):
        self.finished, self.exit_code = True, exit_code


class FakeWandb:
    """The wandb module's stand-in: agent() calls the function once a
    queued proposal, init() hands out the next config (thread-safe)."""

    def __init__(self, proposals):
        self.proposals, self.runs, self.agent_calls = list(proposals), [], []
        self._lock = threading.Lock()

    def init(self, **kw):
        with self._lock:
            run = FakeRun(self.proposals[len(self.runs)])
            self.runs.append(run)
            return run

    def agent(self, sweep_id, function=None, count=None):
        with self._lock:
            self.agent_calls.append((sweep_id, count))
        for _ in range(count if count is not None else len(self.proposals)):
            function()


def test_agent_loop_reports_metric(tmp_path):
    cfg = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    fake = FakeWandb([{"gate_offset": -3.0, "pt_lr": 2e-3},
                      {"gate_offset": -1.0, "pt_lr": 1e-4}])
    n = tsweep.run_wandb_agent("team/proj/abc123", cfg, count=2,
                               run_fn=_objective_factory(noise=0.0),
                               wandb_module=fake)
    assert n == 2 and fake.agent_calls == [("team/proj/abc123", 2)]
    assert all(r.finished for r in fake.runs)
    assert fake.runs[0].logged[0]["val_elbo"] < \
        fake.runs[1].logged[0]["val_elbo"]


def test_agent_parallel_trials_batches_populations(tmp_path, monkeypatch):
    cfg = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    fake = FakeWandb([{"pt_lr": 1e-3}, {"pt_lr": 2e-3}, {"pt_lr": 3e-3}])
    batches = []

    def fake_pop(c, ovs, **kw):
        batches.append(list(ovs))
        return [{"val_elbo": float(o["pt_lr"]) * 1000.0} for o in ovs]

    monkeypatch.setattr(tsweep, "population_pretrain", fake_pop)
    n = tsweep.run_wandb_agent("id", cfg, count=3, wandb_module=fake,
                               parallel_trials=2)
    assert n == 3
    assert sum(len(b) for b in batches) == 3
    assert max(len(b) for b in batches) == 2
    for run in fake.runs:
        assert run.finished and run.exit_code == 0
        assert run.logged[0]["val_elbo"] == pytest.approx(
            run.config["pt_lr"] * 1000.0)


def test_agent_smaller_count_does_not_stall(tmp_path, monkeypatch):
    cfg = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    fake = FakeWandb([{"pt_lr": 1e-3}, {"pt_lr": 2e-3}])
    monkeypatch.setattr(tsweep, "population_pretrain", lambda c, ovs, **kw: [
        {"val_elbo": float(o["pt_lr"])} for o in ovs])
    t0 = time.monotonic()
    n = tsweep.run_wandb_agent("id", cfg, count=2, wandb_module=fake,
                               parallel_trials=4)
    assert n == 2 and time.monotonic() - t0 < 60.0
    for run in fake.runs:
        assert run.finished and run.logged[0]["val_elbo"] == \
            pytest.approx(run.config["pt_lr"])


def test_an_escaping_executor_releases_every_waiting_thread(tmp_path,
                                                            monkeypatch):
    """The JAX batcher's stall, repaired: an executor that escapes
    _population_batch's isolation (here a BaseException, as a
    KeyboardInterrupt would) leaves no entry without a result. The thread
    that flushed sees the exception; the parked threads wake at once with a
    failed result, well inside ``timeout_s``."""
    class Escape(BaseException):
        pass

    def escaping(cfg, ovs, **kw):
        raise Escape("executor escaped")

    monkeypatch.setattr(tsweep, "population_pretrain", escaping)
    cfg = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    batcher = tsweep._AgentPopulationBatcher(
        cfg, tsweep.population_pretrain, size=3, n_threads=3,
        timeout_s=120.0)
    outs, errors = {}, {}

    def agent(i):
        try:
            outs[i] = batcher.submit({"pt_lr": 1e-3 * (i + 1)})
        except Escape as e:
            errors[i] = e

    threads = [threading.Thread(target=agent, args=(i,), daemon=True)
               for i in range(3)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
        time.sleep(0.05)
    for t in threads:
        t.join(timeout=30.0)
    assert time.monotonic() - t0 < 30.0
    assert not any(t.is_alive() for t in threads)
    assert len(errors) == 1 and len(outs) == 2
    for out in outs.values():
        assert out["status"] == "failed" and "raised" in out["error"]


def test_agent_custom_objective_falls_back_to_serial(tmp_path):
    cfg = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    fake = FakeWandb([{"pt_lr": 1e-3}, {"pt_lr": 2e-3}])
    with pytest.warns(UserWarning, match="no population executor"):
        n = tsweep.run_wandb_agent(
            "id", cfg, count=2, run_fn=lambda c: {"val_elbo": c.train.pt_lr},
            wandb_module=fake, parallel_trials=4)
    assert n == 2 and all(r.finished for r in fake.runs)


def test_agent_dirs_keyed_on_run_id_and_failures_isolated(tmp_path, capsys):
    cfg = QBoldConfig(train=TrainConfig(save_directory=str(tmp_path)))
    fake = FakeWandb([{"pt_lr": 1e-3}, {"pt_lr": 2e-3}, {"pt_lr": 3e-3}])
    init = fake.init

    def init_with_id(**kw):
        run = init(**kw)
        run.id = f"r{len(fake.runs)}z"
        return run

    fake.init = init_with_id
    dirs = []

    def spy(c):
        dirs.append(c.train.save_directory)
        if len(dirs) == 2:
            raise RuntimeError("trial exploded")
        return {"val_elbo": 1.0}

    n = tsweep.run_wandb_agent("id", cfg, count=3, run_fn=spy,
                               wandb_module=fake)
    assert n == 3 and len(set(dirs)) == 3
    assert all("/agent_r" in d for d in dirs)
    assert fake.runs[1].exit_code == 1
    assert fake.runs[1].logged[-1]["status"] == "failed"
    assert fake.runs[2].exit_code == 0
    assert "trial exploded" in capsys.readouterr().err


def test_finish_without_exit_code_is_called_bare(capsys):
    class OldRun:
        def __init__(self):
            self.calls = 0

        def finish(self):
            self.calls += 1

    run = OldRun()
    tsweep._finish_wandb_run(run, 1)
    assert run.calls == 1 and "lacks exit_code" in capsys.readouterr().err


# ---- the CLI ------------------------------------------------------------------------

def _ranked(out: str) -> list:
    """The ranked results' JSON, printed after the trials' logs."""
    return json.loads(out[out.index("[\n"):])


TINY = ["--device", "cpu", "--set", "sample_size=40", "--set",
        "no_pt_epochs=1", "--set", "pt_batch_size=4", "--set",
        "simulate_noise=False"]


def test_sweep_command_grid_and_space(tmp_path, capsys):
    save = tmp_path / "grid"
    assert main(["sweep", "--layers", "1", "--units", "4", "--seeds", "2",
                 *TINY, "--set", f"save_directory={save}", "--set",
                 f"d={tmp_path}/none"]) == 0
    res = _ranked(capsys.readouterr().out)
    assert [(r["layers"], r["units"]) for r in res] == [(1, 4), (1, 4)]
    assert all(np.isfinite(r["val_elbo"]) for r in res)
    space = tmp_path / "space.yaml"
    space.write_text(yaml.safe_dump({
        "method": "random", "metric": {"name": "val_elbo"},
        "parameters": {"pt_lr": {"min": 1e-4, "max": 1e-2,
                                 "distribution": "log_uniform_values"},
                       "no_units": {"value": 4},
                       "no_intermediate_layers": {"value": 1}}}))
    assert main(["sweep", "--space", str(space), "--trials", "3",
                 "--parallel-trials", "3", "--method", "bayes", *TINY,
                 "--set", f"save_directory={tmp_path}/space", "--set",
                 f"d={tmp_path}/none"]) == 0
    res = _ranked(capsys.readouterr().out)
    vals = [r["val_elbo"] for r in res]
    assert len(vals) == 3 and vals == sorted(vals)
    assert all(np.isfinite(v) for v in vals)


def test_sweep_command_says_what_is_missing(tmp_path, monkeypatch, capsys):
    import builtins

    real_import = builtins.__import__

    def no_optional(name, *a, **kw):
        if name in ("yaml", "wandb"):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_optional)
    assert main(["sweep", "--space", "x.yaml", *TINY]) == 2
    assert "needs pyyaml" in capsys.readouterr().err
    assert main(["sweep", "--agent", "id", *TINY]) == 2
    assert "needs wandb" in capsys.readouterr().err
