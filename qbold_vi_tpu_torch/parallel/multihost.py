"""Multi-process execution of the sharded paths, certified against one
process.

The counterpart of ``qbold_vi_tpu/parallel/multihost.py``: ``certify(n)``
spawns ``n`` ranks (``launch_workers``: subprocesses that meet at a
localhost coordinator, gloo on the CPU or on a shared card, NCCL with a
card each), runs the same workload in every rank and in this process,
and holds the ranks' metrics to each other bit for bit and to the
single-process run within ``rtol``.

The workload (``workload_metrics``) builds its data and its HOST-injected
draws from ``numpy.random.default_rng`` over the GLOBAL rows, and each
rank takes its rows, so an n-rank run and a single-process run see the
same rows and the same normals (in place of the JAX package's "the same
device count in one process"):

1. the sharded fine-tune step (``steps.make_finetune_step(mesh=)``) on
   global crop batches of ``n + 1`` crops (``38`` at OPTIMAL's width; a
   count no mesh of two or more ranks divides), each rank its
   ``_device_crop_counts`` rows and their normals, dead slots masked; the
   losses and the parameter norm; and one such step with kernel F taking
   the host's normals (``fused_elbo="host"``; its plain version on the
   CPU);
2. the sharded streaming step on global synthetic draws (``n + 1``
   volumes; 511 at OPTIMAL's width, which 2 ranks do not divide);
3. a per-rank-fed evaluation: each rank materialises only its rows of a
   global batch (``mesh.shard_batch_local``), and the sharded
   ``make_pretrain_eval`` returns the global metrics;
4. the sharded maps (``infer.posterior_maps_sharded`` of stream 1 and 2,
   ``elbo_maps_sharded`` with priors) of ``2n + 1`` subjects (15 at
   OPTIMAL's width) from the initial weights, against posterior_maps /
   elbo_maps.

With ``population_trials`` K > 0 the ranks also train a K-trial
pretrain population of the sweep (``sweep.population_pretrain(mesh=)``:
each rank its slice of the trials, the metrics gathered), held bit for
bit across ranks and within rtol 2e-4 of the population in this process
(the JAX dry run's stage 5d).

Every run times the fine-tune epoch on the device's draws (kernel F's
Philox streams on the card) over ``time_steps`` steps, after a warm
epoch: ``make_finetune_epoch_sharded`` under a mesh, the unsharded
``make_finetune_epoch_on_device`` on the whole global batch alone, so
the two walls a step are taken the same way. Under a mesh the workload
then runs the production paths, held to cross-rank bit equality only: a
third sharded epoch whose all-reduces alone are timed and whose
gradient reductions are counted (one a step), a subject-sharded epoch on
``max(1, n - 1)`` subjects (a rank with none), a sharded streaming
epoch, and the Trainer: ``pretrain`` (streaming, rank 0 writing
pt_model.msgpack) then ``finetune`` with ``ft_shard_subjects="on"`` on 3
subjects (at 2 ranks one holding a partial shard) and a study set, rank
0 writing final_model.msgpack. Each rank reports its kernels' launches,
its collectives and the all-reduce's milliseconds a step.

    python -m qbold_vi_tpu_torch dryrun --processes 2 --device cpu
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["workload_metrics", "population_metrics", "launch_workers",
           "certify"]

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# metrics of the host-draw stages and the maps: held to the single-process
# run; every metric is held across ranks bit for bit
REFERENCE_KEYS = ("ft_loss", "param_norm", "fused_host_loss", "stream_loss",
                  "eval_loss", "eval_oef_mse", "maps_oef_sum")


def _workload_cfg(width: str, n_ranks: int):
    from ..config import (OPTIMAL, ModelConfig, QBoldConfig, ScanParams,
                          SynthParams, TrainConfig)

    if width == "optimal":
        return dataclasses.replace(
            OPTIMAL, scan=dataclasses.replace(OPTIMAL.scan,
                                              simulate_noise=False),
            train=dataclasses.replace(OPTIMAL.train, pt_batch_size=511))
    if width != "tiny":
        raise ValueError(f"width must be 'tiny' or 'optimal', got {width!r}")
    return QBoldConfig(
        scan=ScanParams(simulate_noise=False),
        synth=SynthParams(sample_size=8),
        model=ModelConfig(no_units=8, no_intermediate_layers=1,
                          use_mvg=True, student_t_df=200.0,
                          predict_log_data=False),
        train=TrainConfig(ft_batch_size=n_ranks + 1, crop_size=6,
                          pt_batch_size=n_ranks + 1))


# the trials of the population stage: pt_lr and the inverse-gamma prior
# vary (one group: every trial has the prior)
POPULATION_TRIALS = (
    {"pt_lr": 1e-3, "inv_gamma_alpha": 1.0, "inv_gamma_beta": 2.0},
    {"pt_lr": 5e-4, "inv_gamma_alpha": 3.0, "inv_gamma_beta": 1.0},
    {"pt_lr": 2e-3, "inv_gamma_alpha": 0.5, "inv_gamma_beta": 0.5},
    {"pt_lr": 8e-4, "inv_gamma_alpha": 2.0, "inv_gamma_beta": 4.0})
POPULATION_RTOL = 2e-4


def _population_cfg(width: str):
    """The population stage's configuration: OPTIMAL for one streaming
    epoch, or at the tiny width the sweep tests' (its seed fold holds a
    validation volume)."""
    from ..config import (OPTIMAL, ModelConfig, QBoldConfig, ScanParams,
                          SynthParams, TrainConfig)

    if width == "optimal":
        return dataclasses.replace(OPTIMAL, train=dataclasses.replace(
            OPTIMAL.train, no_pt_epochs=1))
    return QBoldConfig(
        scan=ScanParams(simulate_noise=False),
        synth=SynthParams(sample_size=40),
        model=ModelConfig(no_units=8, no_intermediate_layers=1,
                          use_mvg=True, student_t_df=200.0,
                          predict_log_data=False),
        train=TrainConfig(no_pt_epochs=1, pt_batch_size=4))


def population_metrics(mesh=None, *, n_trials: int, width: str = "tiny",
                       device: str = "cuda") -> list:
    """The population stage: ``n_trials`` of POPULATION_TRIALS through
    ``sweep.population_pretrain`` (under ``mesh``, each rank its slice)."""
    from ..sweep import population_pretrain

    return population_pretrain(_population_cfg(width),
                               list(POPULATION_TRIALS[:n_trials]),
                               mesh=mesh, device=device)


def _shapes(width: str, n_ranks: int) -> dict:
    if width == "optimal":
        return dict(vol=(3, 32, 32, 8), maps=(15, 32, 32, 8))
    return dict(vol=(3, 10, 10, 2), maps=(2 * n_ranks + 1, 6, 6, 2))


def _volumes(rng, shape, n_taus) -> np.ndarray:
    vols = np.abs(rng.normal(size=shape + (n_taus + 1,))).astype(
        np.float32) * 50 + 100
    vols[..., -1] = rng.uniform(size=shape) > 0.1
    return vols


def _rank_slots(x: np.ndarray, b: int, mesh, axis: int = 0) -> np.ndarray:
    """The rank's slots of a global array whose ``axis`` has ``b`` rows:
    its _device_crop_counts rows, padded to ceil(b / n) with copies of its
    first (dead: the caller masks them)."""
    from .mesh import crop_rows

    lo, hi = crop_rows(b, mesh.world_size, mesh.rank)
    b_local = -(-b // mesh.world_size)
    idx = np.concatenate([np.arange(lo, hi),
                          np.full(b_local - (hi - lo), min(lo, b - 1))])
    return np.take(x, idx, axis=axis)


def _param_norm(tuner) -> float:
    return float(torch.sqrt(sum(torch.sum(p.detach().double() ** 2)
                                for p in tuner.parameters())))


def _crop_batches(vols, priors, cfg, n_steps: int):
    """n_steps global crop batches and their normals, host-drawn."""
    b, c = cfg.train.ft_batch_size, cfg.train.crop_size
    s, x, y = vols.shape[:3]
    out = []
    for t in range(n_steps):
        rng = np.random.default_rng(100 + t)
        si = rng.integers(0, s, b)
        xi = rng.integers(0, x - c + 1, b)
        yi = rng.integers(0, y - c + 1, b)
        win = np.stack([vols[i, a:a + c, e:e + c] for i, a, e in
                        zip(si, xi, yi)])
        pri = np.stack([priors[i, a:a + c, e:e + c] for i, a, e in
                        zip(si, xi, yi)])
        mask = win[..., -1:]
        vox = win.shape[:-1]
        out.append(({"images": win[..., :-1] * mask, "mask": mask,
                     "priors": pri},
                    {"z_nll": rng.standard_normal(
                        (cfg.model.no_samples,) + vox + (2,), np.float32),
                     "z_kl": rng.standard_normal((70,) + vox + (2,),
                                                 np.float32)}))
    return out


def _stream_draws(cfg, b: int, vol_voxels: int = 500):
    """The draws of one global streaming batch of b pseudo-volumes (the
    layout of steps.stream_synthetic_batch; no misalignment, no noise)."""
    rng = np.random.default_rng(7)
    n = b * vol_voxels
    d = {k: rng.uniform(size=n).astype(np.float32)
         for k in ("sel_o", "sel_d", "oef_u", "dbv_u", "dbv_n")}
    d["oef_n"] = rng.standard_normal(n, np.float32)
    noise = None
    if cfg.train.use_r2p_loss:
        noise = {"z_r2p": rng.standard_normal((10, n, 2), np.float32)}
    return d, noise


def workload_metrics(mesh=None, *, n_ranks: int = 1, width: str = "tiny",
                     n_steps: int = 2, time_steps: Optional[int] = None,
                     device="cuda", trainer_dir: Optional[str] = None
                     ) -> tuple:
    """(metrics, maps): the workload on ``mesh`` (None: this process alone
    on ``device``, the reference run, which skips the production paths).
    ``n_ranks`` sizes the shapes of the run being certified; ``width``
    "tiny" or "optimal"; ``n_steps`` host-drawn crop batches;
    ``time_steps`` (default ``n_steps``) steps a timed epoch."""
    from .. import infer
    from ..models.vi import FineTuner, init_params
    from ..ops import launch_counts
    from ..train import optim, steps
    from ..train.data import predict_priors
    from . import mesh as pmesh

    device = (mesh.device if mesh is not None
              else pmesh.require_device(device))
    cfg = _workload_cfg(width, n_ranks)
    shapes = _shapes(width, n_ranks)
    t_taus = cfg.scan.n_taus
    rng = np.random.default_rng(0)
    vols = _volumes(rng, shapes["vol"], t_taus)
    priors = (rng.normal(size=shapes["vol"] + (5,)) * 0.3).astype(np.float32)
    init = init_params(cfg.model, cfg.scan, torch.Generator().manual_seed(0))

    def tuner_of(params):
        t = FineTuner(cfg.model, cfg.scan, device=device)
        t.load_state_dict(params)
        return t

    out = {"world_size": 1 if mesh is None else mesh.world_size,
           "rank": 0 if mesh is None else mesh.rank}

    def put(tree):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in tree.items()}

    # 1. the sharded fine-tune step on host-drawn crops and normals
    tuner = tuner_of(init)
    opt = optim.make_finetune_optimizer(tuner.parameters(), cfg.train)
    step = steps.make_finetune_step(tuner, cfg, opt, mesh)
    b = cfg.train.ft_batch_size

    def rank_batch(batch, noise):
        if mesh is None:
            return put(batch), put(noise)
        batch = {k: _rank_slots(v, b, mesh) for k, v in batch.items()}
        noise = {k: _rank_slots(v, b, mesh, 1) for k, v in noise.items()}
        lo, hi = pmesh.crop_rows(b, mesh.world_size, mesh.rank)
        batch["live"] = (np.arange(len(batch["mask"])) < hi - lo
                         ).astype(np.float32)
        return put(batch), put(noise)

    batches = _crop_batches(vols, priors, cfg, n_steps)
    losses = []
    for batch, noise in batches:
        batch, noise = rank_batch(batch, noise)
        losses.append(float(step(batch, noise=noise)["loss"]))
    out["ft_loss"] = losses
    out["param_norm"] = _param_norm(tuner)

    # 1b. kernel F taking the host's normals inside the sharded step
    fcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, fused_elbo="host"))
    tuner = tuner_of(init)
    opt = optim.make_finetune_optimizer(tuner.parameters(), fcfg.train)
    batch, noise = rank_batch(*batches[0])
    out["fused_host_loss"] = float(steps.make_finetune_step(
        tuner, fcfg, opt, mesh)(batch, noise=noise)["loss"])

    # 2. the sharded streaming step on host-drawn synthetic volumes
    tuner = tuner_of(init)
    popt = optim.make_pretrain_optimizer(tuner.named_parameters(), cfg.train)
    b_pt = cfg.train.pt_batch_size
    draws, noise = _stream_draws(cfg, b_pt)
    if mesh is None:
        stream = steps.make_pretrain_stream_step(tuner, cfg, popt)
    else:
        stream = steps.make_pretrain_stream_step_sharded(tuner, cfg, popt,
                                                         mesh)
        draws = {k: _rank_slots(v.reshape(b_pt, -1), b_pt, mesh).reshape(-1)
                 for k, v in draws.items()}
        if noise is not None:
            noise = {"z_r2p": _rank_slots(
                noise["z_r2p"].reshape(10, b_pt, -1, 2), b_pt, mesh,
                1).reshape(10, -1, 2)}
    m, _ = stream(draws=draws, noise=noise)
    out["stream_loss"] = float(m["loss"])

    # 3. the per-rank-fed evaluation of a global batch
    g_rows = n_ranks * 2
    xr = np.random.default_rng(1)
    gx = (np.abs(xr.normal(size=(g_rows, 2, 2, 1, t_taus))) + 0.5).astype(
        np.float32)
    oef = xr.uniform(0.1, 0.7, size=(g_rows, 2, 2, 1, 1)).astype(np.float32)
    dbv = xr.uniform(0.01, 0.18, size=(g_rows, 2, 2, 1, 1)).astype(
        np.float32)
    r2p = np.float32(cfg.scan.dw_coeff * cfg.scan.hct) * oef * dbv
    gy = np.concatenate([oef, dbv, r2p], -1)
    evaluate = steps.make_pretrain_eval(tuner_of(init), cfg, mesh=mesh)
    if mesh is None:
        ev = evaluate(put({"x": gx, "y": gy}), 0)
        lo, hi = 0, g_rows
    else:
        lo, hi = pmesh.host_local_rows(mesh, g_rows)
        local = {"x": gx[lo:hi], "y": gy[lo:hi]}     # only this rank's rows
        ev = evaluate(pmesh.shard_batch_local(mesh, local, g_rows), 0,
                      rows=(lo, hi, g_rows))
    out["eval_loss"] = float(ev["val_loss"])
    out["eval_oef_mse"] = float(ev["oef_mse"])
    out["local_eval_rows"] = [int(lo), int(hi)]

    # 4. the sharded maps of the initial weights
    mrng = np.random.default_rng(2)
    pdata = _volumes(mrng, shapes["maps"], t_taus)
    tuner = tuner_of(init)

    @torch.no_grad()
    def encode(images):
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        return tuple(o.cpu().numpy() for o in tuner.encode(x))

    pmap = predict_priors(encode, pdata, 5 if cfg.model.use_mvg else 4)
    maps = {}
    for first in (True, False):
        kw = dict(use_first_op=first, seed=3)
        got = (infer.posterior_maps(tuner, pdata, **kw) if mesh is None else
               infer.posterior_maps_sharded(tuner, pdata, mesh, **kw))
        maps.update({f"s{1 if first else 2}_{k}": v for k, v in got.items()})
    got = (infer.elbo_maps(tuner, cfg, pdata, pmap, seed=4, no_samples=8)
           if mesh is None else
           infer.elbo_maps_sharded(tuner, cfg, pdata, pmap, mesh, seed=4,
                                   no_samples=8))
    maps.update({f"elbo_{k}": v for k, v in got.items()})
    out["maps_oef_sum"] = float(np.sum(np.float64(maps["s1_oef"])))

    out.update(_timed_epochs(mesh, cfg, init, vols, priors, tuner_of,
                             time_steps or n_steps, device))
    if mesh is not None:
        out.update(_production_paths(mesh, cfg, init, vols, priors,
                                     tuner_of, n_steps, trainer_dir))
        out["launches"] = launch_counts()
        out["collectives"] = dict(mesh.counts)
    return out, maps


def _timed_epochs(mesh, cfg, init, vols, priors, tuner_of, n_steps: int,
                  device) -> dict:
    """The fine-tune epoch of ``n_steps`` steps on the device's draws,
    warmed, then timed (its wall a step, the crop sampling included):
    sharded under ``mesh``, else unsharded on the whole global batch.
    Under a mesh a third epoch times its all-reduces alone (the device
    synchronised around each, so that epoch's wall is not the step's)
    and counts its gradient reductions."""
    from ..train import optim, steps

    tuner = tuner_of(init)
    opt = optim.make_finetune_optimizer(tuner.parameters(), cfg.train)
    v, p = (torch.from_numpy(a).to(device) for a in (vols, priors))
    if mesh is None:
        run = steps.make_finetune_epoch_on_device(tuner, cfg, opt, n_steps)

        def epoch(seed):
            return run(torch.Generator().manual_seed(seed), v, p)
    else:
        run = steps.make_finetune_epoch_sharded(tuner, cfg, opt, n_steps,
                                                mesh)

        def epoch(seed):
            return run(seed, v, p)

    epoch(11)                                     # warm, then timed
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    losses = epoch(12)["loss"].cpu().tolist()
    out = {"ft_device_step_ms": 1e3 * (time.perf_counter() - t0) / n_steps}
    if mesh is None:
        return out
    out["ft_device_loss"] = losses
    mesh.timed, mesh.seconds = True, collections.Counter()
    calls0 = mesh.counts["all_reduce"]
    reduces0 = mesh.counts["step_reduce"]
    epoch(13)
    mesh.timed = False
    out["allreduce_calls_per_step"] = (
        (mesh.counts["all_reduce"] - calls0) / n_steps)
    out["step_reduces_per_step"] = (
        (mesh.counts["step_reduce"] - reduces0) / n_steps)
    out["allreduce_ms_per_step"] = 1e3 * mesh.seconds["all_reduce"] / n_steps
    out["ft_device_param_norm"] = _param_norm(tuner)
    return out


def _production_paths(mesh, cfg, init, vols, priors, tuner_of,
                      n_steps: int, trainer_dir: Optional[str]) -> dict:
    """The subject-sharded and streaming epochs and the Trainer on the
    device's draws: cross-rank metrics."""
    from ..train import optim, steps
    from ..train.trainer import Trainer
    from . import mesh as pmesh

    out = {}
    # a subject-sharded epoch on n - 1 subjects: the last rank holds none
    n_subj = max(1, mesh.world_size - 1)
    s_pad = steps._subject_shard_counts(n_subj, mesh.world_size,
                                        cfg.train.ft_batch_size)[0]
    rows = np.arange(s_pad) % len(vols)
    live = (np.arange(s_pad) < n_subj).reshape((-1,) + (1,) * 4)
    shard = pmesh.shard_batch(mesh, {"v": vols[rows] * live,
                                     "p": priors[rows] * live})
    tuner = tuner_of(init)
    opt = optim.make_finetune_optimizer(tuner.parameters(), cfg.train)
    m = steps.make_finetune_epoch_subject_sharded(
        tuner, cfg, opt, n_steps, mesh, n_subj)(4, shard["v"], shard["p"])
    out["subject_sharded_loss"] = m["loss"].cpu().tolist()
    out["subject_sharded_param_norm"] = _param_norm(tuner)

    tuner = tuner_of(init)
    popt = optim.make_pretrain_optimizer(tuner.named_parameters(), cfg.train)
    losses, _ = steps.make_pretrain_stream_epoch(tuner, cfg, popt, n_steps,
                                                 mesh=mesh)(13)
    out["stream_device_loss"] = [float(x) for x in losses]

    tdir = trainer_dir or tempfile.mkdtemp(prefix="qbold_mh_trainer_")
    tcfg = dataclasses.replace(
        cfg,
        synth=dataclasses.replace(cfg.synth, sample_size=40),
        train=dataclasses.replace(
            cfg.train, pt_on_device_synth=True, no_pt_epochs=1,
            save_directory=os.path.join(tdir, "pt"), swa_start=1,
            swa_period=1, no_ft_epochs=1, ft_steps_per_epoch=n_steps,
            ft_shard_subjects="on"))
    tr = Trainer(tcfg, mesh=mesh, logger=lambda *_: None)
    tr.pretrain()
    out["trainer_val_loss"] = tr.pretrain_val_metrics(fold=True)["val_loss"]
    out["trainer_ckpt_exists"] = os.path.isfile(tr.pt_path)
    tr.finetune(vols, study_data=vols[:2])
    out["trainer_ft_loss"] = tr.last_finetune_metrics["loss"]
    out["trainer_ft_val_elbo"] = tr.last_finetune_metrics["val_elbo"]
    out["trainer_ft_param_norm"] = _param_norm(tr.tuner)
    out["trainer_final_ckpt_exists"] = os.path.isfile(tr.final_path)
    out["trainer_dir"] = tcfg.train.save_directory
    return out


# ---- workers --------------------------------------------------------------


def _worker_main(argv=None) -> int:
    import torch.distributed as dist

    from . import mesh as pmesh

    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--width", default="tiny", choices=["tiny", "optimal"])
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--time-steps", type=int, default=None)
    p.add_argument("--population", type=int, default=0,
                   help="trials of the population stage (0: none)")
    args = p.parse_args(argv)

    pmesh.initialize_distributed(args.coordinator, args.num_processes,
                                 args.process_id, device=args.device)
    try:
        mesh = pmesh.make_mesh(args.device)
        out, maps = workload_metrics(
            mesh, n_ranks=args.num_processes, width=args.width,
            n_steps=args.steps, time_steps=args.time_steps,
            trainer_dir=os.path.join(os.path.dirname(args.out), "trainer"))
        if mesh.rank == 0:
            np.savez(args.out + ".maps.npz", **maps)
        if args.population:
            from ..ops import launch_counts

            before, coll = launch_counts()["S"], collections.Counter(
                mesh.counts)
            out["population"] = population_metrics(
                mesh, n_trials=args.population, width=args.width,
                device=args.device)
            out["population_s_launches"] = launch_counts()["S"] - before
            out["population_collectives"] = dict(mesh.counts - coll)
        out["backend"] = mesh.backend
    finally:
        dist.destroy_process_group()
    write_result(args.out, out)
    return 0


def write_result(path: str, out: dict) -> None:
    """A worker's JSON result, written atomically (the launcher reads it
    after the worker exits)."""
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_workers(n_processes: int, *, args=(),
                   module: str = "qbold_vi_tpu_torch.parallel.multihost",
                   timeout_s: float = 900.0, workdir: Optional[str] = None,
                   pythonpath=()) -> list:
    """Run ``python -m <module> --coordinator localhost:PORT
    --num-processes n --process-id i --out <workdir>/proc<i>.json
    <args>`` for every rank, wait, and return their JSON results in rank
    order. A worker that fails or outlives ``timeout_s`` ends the run:
    every worker is killed through its Popen handle and the log's tail
    raised. The port comes from a probe socket closed before rank 0 binds
    it; a failure that looks like a bind / connect race retries ONCE on a
    fresh port."""
    for attempt in (0, 1):
        try:
            return _launch_once(n_processes, list(args), module, timeout_s,
                                workdir or tempfile.mkdtemp(
                                    prefix="qbold_multihost_"), pythonpath)
        except RuntimeError as e:
            msg = str(e).lower()
            racy = any(t in msg for t in (
                "address already in use", "eaddrinuse", "bind",
                "connection refused", "failed to connect"))
            if attempt or not racy:
                raise
            print(f"[multihost] worker launch failed with a bind/connect-"
                  f"shaped error; retrying on a fresh port: {e}",
                  file=sys.stderr)
    raise AssertionError("unreachable")


def _launch_once(n: int, args: list, module: str, timeout_s: float,
                 workdir: str, pythonpath) -> list:
    os.makedirs(workdir, exist_ok=True)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO_ROOT, *pythonpath] + ([env["PYTHONPATH"]]
                                    if env.get("PYTHONPATH") else []))
    procs, outs, logs, handles = [], [], [], []
    try:
        for pid in range(n):
            out = os.path.join(workdir, f"proc{pid}.json")
            log_path = os.path.join(workdir, f"proc{pid}.log")
            for stale in (out, out + ".maps.npz"):
                if os.path.exists(stale):
                    os.remove(stale)
            log = open(log_path, "w")
            handles.append(log)
            cmd = [sys.executable, "-m", module,
                   "--coordinator", f"localhost:{port}",
                   "--num-processes", str(n), "--process-id", str(pid),
                   "--out", out, *args]
            procs.append(subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT,
                                          env=env, cwd=REPO_ROOT))
            outs.append(out)
            logs.append(log_path)
        deadline = time.time() + timeout_s
        pending = list(range(n))
        while pending:
            for pid in list(pending):
                rc = procs[pid].poll()
                if rc is None:
                    continue
                pending.remove(pid)
                if rc != 0:
                    with open(logs[pid]) as f:
                        tail = f.read()[-3000:]
                    raise RuntimeError(f"worker {pid} exited {rc}; log "
                                       f"tail:\n{tail}")
            if pending and time.time() > deadline:
                raise RuntimeError(f"workers {pending} timed out after "
                                   f"{timeout_s} s (logs in {workdir})")
            time.sleep(0.05)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
        for h in handles:
            h.close()
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results


def _certify_population(workers: list, reference: list) -> dict:
    """The population stage of every rank: bit-equal across ranks, each
    trial's metrics within POPULATION_RTOL of this process's population;
    each rank's S launches and collectives (one all_gather a group)."""
    pops = [w["population"] for w in workers]
    for r, pop in enumerate(pops[1:], 1):
        assert pop == pops[0], f"population differs on rank {r}: {pop}"
    assert len(pops[0]) == len(reference)
    worst = 0.0
    for got, ref in zip(pops[0], reference):
        for k, v in ref.items():
            np.testing.assert_allclose(
                got[k], v, rtol=POPULATION_RTOL, atol=1e-6,
                err_msg=f"population {k}: {len(workers)} ranks against one "
                        "process")
            worst = max(worst, abs(got[k] - v) / max(abs(v), 1e-30))
        assert np.isfinite(got["val_elbo"]), got
    for w in workers:
        assert w["population_collectives"].get("all_gather") == 1, w
    return {"population": pops[0], "population_rel_err": worst,
            "population_s_launches": [w["population_s_launches"]
                                      for w in workers]}


def certify(n_processes: int, *, n_steps: int = 2,
            time_steps: Optional[int] = None, width: str = "tiny",
            device: str = "cuda", timeout_s: float = 900.0,
            rtol: float = 2e-5, workdir: Optional[str] = None,
            population_trials: int = 0) -> dict:
    """Run the workload on ``n_processes`` ranks and in this process, and
    hold them to each other: every metric bit-equal across ranks; the
    host-draw stages and the maps within ``rtol`` (atol 1e-6) of the
    single-process run (the ranks reduce in another order); the per-rank
    evaluation rows tiling the global batch; one gradient all-reduce a
    step; rank 0's checkpoints written. ``time_steps`` (default
    ``n_steps``) steps the timed epochs. With ``population_trials`` the
    population stage too. Returns the certification as a dict ("ok":
    True)."""
    from .mesh import require_device

    require_device(device)
    time_steps = time_steps or n_steps
    workdir = workdir or tempfile.mkdtemp(prefix="qbold_multihost_")
    pop_args = (["--population", str(population_trials)]
                if population_trials else [])
    reference, ref_maps = workload_metrics(
        None, n_ranks=n_processes, width=width, n_steps=n_steps,
        time_steps=time_steps, device=device)
    ref_pop = (population_metrics(n_trials=population_trials, width=width,
                                  device=device)
               if population_trials else None)
    workers = launch_workers(
        n_processes, args=["--width", width, "--device", device, "--steps",
                           str(n_steps), "--time-steps", str(time_steps),
                           *pop_args],
        timeout_s=timeout_s, workdir=workdir)
    w0 = workers[0]
    assert w0["world_size"] == n_processes, w0
    skip = ("rank", "local_eval_rows", "launches", "collectives",
            "allreduce_ms_per_step", "ft_device_step_ms", "population",
            "population_s_launches", "population_collectives")
    for w in workers[1:]:
        for k, v in w0.items():
            if k not in skip:
                assert w[k] == v, (f"{k} differs between rank 0 and rank "
                                   f"{w['rank']}: {v} != {w[k]}")
    for k in REFERENCE_KEYS:
        np.testing.assert_allclose(
            w0[k], reference[k], rtol=rtol, atol=1e-6,
            err_msg=f"{k}: {n_processes} ranks against one process")
    maps_diff = 0.0
    with np.load(os.path.join(workdir, "proc0.json.maps.npz")) as got:
        for k, v in ref_maps.items():
            np.testing.assert_allclose(
                got[k], v, rtol=rtol, atol=1e-6,
                err_msg=f"map {k}: {n_processes} ranks against one process")
            maps_diff = max(maps_diff, float(np.max(np.abs(got[k] - v))))
    ranges = sorted(w["local_eval_rows"] for w in workers)
    assert ranges[0][0] == 0 and ranges[-1][1] == 2 * n_processes, ranges
    for (_, a_hi), (b_lo, _) in zip(ranges, ranges[1:]):
        assert a_hi == b_lo, f"eval row ranges overlap or gap: {ranges}"
    assert w0["step_reduces_per_step"] == 1, w0["step_reduces_per_step"]
    assert w0["trainer_ckpt_exists"] and w0["trainer_final_ckpt_exists"], \
        "rank 0's checkpoints were not written"
    pop = (_certify_population(workers, ref_pop) if population_trials
           else {})
    return {
        **pop,
        "processes": n_processes,
        "devices_per_process": 1,
        "backend": w0["backend"],
        "width": width,
        "steps": n_steps,
        "time_steps": time_steps,
        "ft_loss": w0["ft_loss"],
        "single_process_ft_loss": reference["ft_loss"],
        "stream_loss": w0["stream_loss"],
        "eval_loss": w0["eval_loss"],
        "param_norm": w0["param_norm"],
        "fused_host_loss": w0["fused_host_loss"],
        "parity_rtol": rtol,
        "per_rank_eval_rows": [w["local_eval_rows"] for w in workers],
        "maps_subjects": int(ref_maps["s1_oef"].shape[0]),
        "maps_max_abs_diff": maps_diff,
        "subject_sharded_loss": w0["subject_sharded_loss"],
        "trainer_val_loss": w0["trainer_val_loss"],
        "trainer_ft_loss": w0["trainer_ft_loss"],
        "trainer_ft_val_elbo": w0["trainer_ft_val_elbo"],
        "allreduce_ms_per_step": [w["allreduce_ms_per_step"]
                                  for w in workers],
        "allreduce_calls_per_step": w0["allreduce_calls_per_step"],
        "step_reduces_per_step": w0["step_reduces_per_step"],
        "ft_device_step_ms": [w["ft_device_step_ms"] for w in workers],
        "single_process_step_ms": reference["ft_device_step_ms"],
        "launches": [w["launches"] for w in workers],
        "collectives": [w["collectives"] for w in workers],
        "ok": True,
    }


if __name__ == "__main__":
    raise SystemExit(_worker_main())
