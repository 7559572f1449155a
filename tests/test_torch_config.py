"""The port's config copy against the JAX package's, and the port's
freedom from jax."""

import dataclasses
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

import torch_parity_utils  # noqa: E402,F401  (thread cap)
from qbold_vi_tpu import config as jcfg  # noqa: E402
from qbold_vi_tpu_torch import config as tcfg  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("group", ["scan", "synth", "model", "train"])
def test_optimal_field_for_field(group):
    ref = getattr(jcfg.OPTIMAL, group)
    got = getattr(tcfg.OPTIMAL, group)
    assert type(got).__name__ == type(ref).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert tcfg.OPTIMAL.name == jcfg.OPTIMAL.name


@pytest.mark.parametrize("scan_kw", [
    {},                                                      # 11 taus
    dict(tau_start=-0.028, tau_end=0.065, tau_step=0.004),   # 24 taus
    dict(tau_start=0.0),                                     # se_idx 0
])
def test_scan_derived_quantities(scan_kw):
    ref, got = jcfg.ScanParams(**scan_kw), tcfg.ScanParams(**scan_kw)
    assert (got.taus() == ref.taus()).all()
    assert got.taus().dtype == ref.taus().dtype
    assert (got.n_taus, got.se_idx, got.dw_coeff) == (
        ref.n_taus, ref.se_idx, ref.dw_coeff)


def test_known_flat_keys_and_overrides():
    assert tcfg.known_flat_keys() == jcfg.known_flat_keys()
    over = {"no_units": "16", "use_mvg": "false", "tau_step": 0.004,
            "d": "/data", "name": "x", "fused_infer": "off"}
    ref = jcfg.apply_flat_overrides(jcfg.QBoldConfig(), over)
    got = tcfg.apply_flat_overrides(tcfg.QBoldConfig(), over)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    with pytest.raises(tcfg.UnknownConfigKeyError, match="no_units"):
        tcfg.apply_flat_overrides(tcfg.QBoldConfig(), {"no_unit": 3})


def test_yaml_config_matches():
    path = os.path.join(REPO, "configurations", "optimal.yaml")
    ref = jcfg.load_yaml_config(path)
    got = tcfg.load_yaml_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_port_imports_without_jax():
    """Every module of the port imports with jax, flax, msgpack and yaml
    made unimportable (the card has none of them), and a checkpoint
    round-trips there: train --smoke writes pt_model.msgpack, a fresh
    Trainer resumes it to the same weights."""
    code = (
        "import sys, pkgutil, importlib, tempfile, os\n"
        "for m in ('jax', 'flax', 'msgpack', 'yaml'): sys.modules[m] = None\n"
        "import qbold_vi_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'msgpack', "
        "'yaml', 'qbold_vi_tpu') for k in sys.modules "
        "if sys.modules[k] is not None)\n"
        "import torch\n"
        "from qbold_vi_tpu_torch.cli import main\n"
        "from qbold_vi_tpu_torch.config import apply_flat_overrides, "
        "QBoldConfig\n"
        "from qbold_vi_tpu_torch.train.trainer import Trainer\n"
        "d = tempfile.mkdtemp()\n"
        "assert main(['train', '--smoke', '--device', 'cpu', '--set', "
        "'save_directory=' + d, '--set', 'd=' + d + '/none']) == 0\n"
        "cfg = apply_flat_overrides(QBoldConfig(), {'save_directory': d, "
        "'no_units': 8, 'no_intermediate_layers': 1})\n"
        "t = Trainer(cfg, device='cpu')\n"
        "assert t.status.name == 'PRE_TRAINED'\n"
        "state = t._load_state(t.pt_path, 'pretrain')\n"
        "assert state.opt_state.count > 0\n"
        "for k, v in state.params.items():\n"
        "    assert torch.equal(t.tuner.state_dict()[k], v)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 10
