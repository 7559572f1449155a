"""The port's multi-process layer on the CPU: ``multihost.certify`` (the
counterpart of tests/test_multihost.py), the CLI's ``dryrun`` and
``train --mesh --coordinator`` on spawned gloo ranks, the backend choice,
and the kernel build's lock against ranks that start cold together.

Tolerances: certify's own (every metric bit-equal across ranks; the
host-draw stages and the maps within rtol 2e-5 / atol 1e-6 of the
single-process run, whose reductions run in another order).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qbold_vi_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from qbold_vi_tpu_torch.parallel import multihost  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"          # the ranks share the test's cores
    return env


def _cli(*argv, timeout=600):
    return subprocess.run([sys.executable, "-m", "qbold_vi_tpu_torch",
                           *argv], cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=timeout)


def test_certify_two_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the ranks share the cores
    out = multihost.certify(2, device="cpu", workdir=str(tmp_path),
                            timeout_s=600)
    assert out["ok"] and out["processes"] == 2 and out["backend"] == "gloo"
    assert out["per_rank_eval_rows"] == [[0, 2], [2, 4]]
    np.testing.assert_allclose(out["ft_loss"], out["single_process_ft_loss"],
                               rtol=2e-5)
    # one all-reduce of the mask count and one of the gradients a step
    assert out["allreduce_calls_per_step"] == 2
    assert out["step_reduces_per_step"] == 1
    assert len(out["subject_sharded_loss"]) == out["steps"]
    assert np.isfinite(out["fused_host_loss"])
    assert out["single_process_step_ms"] > 0
    for counts in out["collectives"]:
        assert counts["step_reduce"] > 0 and counts["all_gather"] > 0
    assert np.isfinite(out["trainer_ft_val_elbo"])
    assert all(v == 0 for c in out["launches"] for v in c.values())  # CPU
    assert os.path.isfile(tmp_path / "trainer" / "pt" / "pt_model.msgpack")


def test_dryrun_command():
    res = _cli("dryrun", "--devices", "4", "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["ok"] is True and out["devices"] == 4
    assert out["backend"] == "gloo" and out["step_reduces_per_step"] == 1
    assert out["maps_max_abs_diff"] < 1e-4


def test_dryrun_command_certifies_processes():
    res = _cli("dryrun", "--processes", "2", "--device", "cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    assert out["ok"] is True and out["processes"] == 2
    assert out["parity_rtol"] == 2e-5


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_train_on_a_mesh_of_two_processes(tmp_path):
    """``train --mesh --coordinator ... --smoke`` on two CPU ranks: both
    exit 0 with equal metrics, rank 0 alone writes and logs, and a plain
    Trainer resumes the checkpoint."""
    from qbold_vi_tpu_torch.config import QBoldConfig, apply_flat_overrides
    from qbold_vi_tpu_torch.train.trainer import Trainer, WeightStatus

    save = tmp_path / "save"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "qbold_vi_tpu_torch", "train", "--mesh",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(i), "--device", "cpu", "--smoke",
         "--set", f"save_directory={save}", "--set", f"d={tmp_path}/none"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(out.splitlines())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = []
    for i, lines in enumerate(outs):
        tag = f"rank {i} of 2: "
        mine = [ln for ln in lines if ln.startswith(tag)]
        assert len(mine) == 1, lines
        ranks.append(json.loads(mine[0][len(tag):]))
    assert any(ln.startswith("[pretrain]") for ln in outs[0])
    assert not any(ln.startswith("[pretrain]") for ln in outs[1])
    timeless = [{k: v for k, v in r["pretrain"].items()
                 if not k.endswith("_time_s")} for r in ranks]
    assert timeless[0] == timeless[1] and "loss" in timeless[0]
    assert os.listdir(save) == ["pt_model.msgpack"]
    cfg = apply_flat_overrides(QBoldConfig(), {
        "save_directory": str(save), "no_units": 8,
        "no_intermediate_layers": 1})
    assert Trainer(cfg, device="cpu").status is WeightStatus.PRE_TRAINED


def test_entry_points_default_to_the_card(monkeypatch):
    """certify, the workload and the dry run run on the card unless asked
    for the CPU: without one they raise before spawning anything."""
    from qbold_vi_tpu_torch.parallel import dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: multihost.certify(2),
                 lambda: multihost.workload_metrics(),
                 lambda: dryrun.run(2)):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            call()


def test_backend_choice():
    assert tmesh.choose_backend(["h/a", "h/b"])[0] == "nccl"
    backend, why = tmesh.choose_backend(["h/a", "h/a"])
    assert backend == "gloo" and "NCCL refuses" in why
    assert tmesh.choose_backend(["h/a", "g/a", "h/b"])[0] == "nccl"


STUB_NVCC = """#!/bin/sh
echo "$*" >> "$NVCC_CALLS"
sleep 1
out=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo stub > "$out"
"""


def test_concurrent_cold_builds_compile_once(tmp_path):
    """Two processes that start cold together (two ranks) build the
    kernel library once: the second waits on the build's lock and finds
    it built. nvcc is a stub on PATH that sleeps and writes its output."""
    from qbold_vi_tpu_torch.ops import _cuda

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(STUB_NVCC)
    nvcc.chmod(0o755)
    build = tmp_path / "build"
    env = _env()
    env["PATH"] = f"{bin_dir}{os.pathsep}{env['PATH']}"
    env["NVCC_CALLS"] = str(tmp_path / "calls")
    code = ("import sys; from pathlib import Path; "
            "from qbold_vi_tpu_torch.ops import _cuda; "
            "_cuda.BUILD_DIR = Path(sys.argv[1]); print(_cuda._build())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    libs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        libs.append(out.strip())
    assert libs[0] == libs[1] and os.path.isfile(libs[0])
    calls = (tmp_path / "calls").read_text().splitlines()
    assert sum(" -c " in c for c in calls) == len(_cuda.SOURCES), calls
    assert sum("-shared" in c for c in calls) == 1, calls
