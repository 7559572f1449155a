"""Command-line entry points of the port: train / infer / serve / baseline /
synth / export-model / import-weights / transfer / dryrun / sweep.

    python -m qbold_vi_tpu_torch train --preset optimal --set d=DATA_DIR
    python -m qbold_vi_tpu_torch infer vols.npy -o out/subj --preset optimal
    python -m qbold_vi_tpu_torch serve --warm 1 96 96 8 --preset optimal
    python -m qbold_vi_tpu_torch baseline vols.npy -o out/wls
    python -m qbold_vi_tpu_torch synth -o synthetic_data.npz
    python -m qbold_vi_tpu_torch export-model -o maps.pt2 --preset optimal
    python -m qbold_vi_tpu_torch import-weights pt_model.h5 --device cpu
    python -m qbold_vi_tpu_torch transfer --tau-start -0.028 --tau-step 0.004
        --tau-end 0.068 -o transferred --preset optimal
    python -m qbold_vi_tpu_torch train --mesh --coordinator localhost:29500
        --num-processes 2 --process-id 0 --preset optimal    # every rank
    python -m qbold_vi_tpu_torch dryrun --devices 4 --device cpu
    python -m qbold_vi_tpu_torch sweep --preset optimal --layers 2
        --units 60 --seeds 2
    python -m qbold_vi_tpu_torch sweep --space configurations/
        sweep_prior.yaml --trials 8 --parallel-trials 4

The counterpart of ``qbold_vi_tpu/cli.py`` (its names, flags, checkpoint
files, messages and exit codes), with these differences, each stated in
the help:

* ``--device {cuda,cpu}`` (default cuda) takes the place of
  ``QBOLD_CPU_DEVICES``: without a CUDA device and without ``--device
  cpu`` a command fails; it never falls back to the CPU;
* the seeds of the exports' sampled maps are ``seed=5`` (post-pretrain)
  and ``seed=7`` (fine-tuned), where the JAX CLI passes
  ``jax.random.PRNGKey(5 / 7)``; ``synth`` draws from a generator seeded
  with the config seed, where the JAX CLI splits ``PRNGKey(seed)``;
* ``export-model`` writes a ``torch.export`` artifact (.pt2) for the
  platforms cuda and cpu (a TPU artifact is the JAX package's: exit 2);
  ``--fused`` holds kernel B and runs on the card in a process that has
  imported qbold_vi_tpu_torch;
* ``import-weights`` reads the legacy Keras-2 HDF5 layout with h5py (the
  card's machine has no h5py: run it on a host that has it) and has no
  Keras fallback; ``--reference-dir`` is accepted and not read;
* ``train --coordinator HOST:PORT --num-processes N --process-id I``
  starts one process a device (run the same command for every rank; rank
  0 serves the rendezvous, and its card is ``I % device count``), and
  ``--mesh`` trains data-parallel over them (parallel/mesh.py; a world of
  one rank means no mesh, as in the JAX CLI); the exports shard too, and
  rank 0 writes the checkpoints, the logs and the maps; every rank prints
  its last metrics and kernel launches on a line of its own at the end;
* ``dryrun --devices N`` spawns N ranks, one device each
  (parallel/dryrun.py); with ``--processes P`` > 1 it certifies P ranks
  against one process (parallel/multihost.py), one device a rank, so
  ``--devices`` is not read;
* ``sweep --mesh`` splits each population's trials over the ranks of
  ``--coordinator`` (one process a device, as ``train --mesh``); every
  rank prints the ranked results;
* ``--config`` and ``sweep --space`` need pyyaml, and ``sweep --agent``
  needs wandb, which the CUDA machine lacks: there, give ``--preset
  optimal`` and ``--set key=value`` overrides, and a grid sweep; without
  them the command says so and exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np

from .config import (OPTIMAL, QBoldConfig, apply_flat_overrides,
                     load_ini_config, load_yaml_config)

__all__ = ["main", "build_parser"]

NOT_PORTED = 2          # the exit code of what the port does not run
MISSING = 2             # the exit code of a command whose package is missing


def _load_cfg(args) -> QBoldConfig:
    base = OPTIMAL if args.preset == "optimal" else QBoldConfig()
    if getattr(args, "ini", None):
        # the reference INI: scanner constants and the synthetic-population
        # section (reference config:1-61)
        base = load_ini_config(args.ini, base)
    strict = not getattr(args, "allow_unknown_keys", False)
    cfg = (load_yaml_config(args.config, base=base, strict=strict)
           if args.config else base)
    overrides = dict(kv.split("=", 1) for kv in (args.set or []))
    if overrides:
        # a typo'd --set key raises with a did-you-mean unless
        # --allow-unknown-keys
        cfg = apply_flat_overrides(cfg, overrides, strict=strict)
    return cfg


def _maybe_wandb(cfg: QBoldConfig):
    """wandb is optional (reference qbold_train_model.py:22-25)."""
    if not cfg.train.wandb_project:
        return None
    try:
        import wandb
    except ImportError:
        print("wandb not installed; logging to stdout only", file=sys.stderr)
        return None
    return wandb.init(project=cfg.train.wandb_project, config=cfg.__dict__)


def _with_brain_mask(arr: np.ndarray) -> np.ndarray:
    """A study set's (GM mask, brain mask) channels -> the brain mask."""
    return np.concatenate([arr[..., :-2], arr[..., -1:]], -1)


def _transforms(d: str, name: str) -> Optional[str]:
    """The data directory's ``transforms_<name>`` (MNI-space export), where
    it exists."""
    tdir = os.path.join(d, f"transforms_{name}")
    return tdir if os.path.isdir(tdir) else None


def cmd_train(args) -> int:
    """Two-phase training (reference train.py:188-282): pretrain (or resume
    save_directory's checkpoints), then, when the data directory holds ASE
    volumes, the post-pretrain exports, fine-tuning and the fine-tuned
    exports of the study sets."""
    import torch.distributed as dist

    from .parallel import mesh as pmesh

    backend = pmesh.initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        device=args.device)
    try:
        return _train(args)
    finally:
        if backend is not None:
            dist.destroy_process_group()


def _train(args) -> int:
    from .ops import launch_counts
    from .parallel import mesh as pmesh
    from .train.trainer import Trainer

    cfg = _load_cfg(args)
    if args.smoke:
        # a tiny end-to-end run: the same code path at small shapes
        cfg = dataclasses.replace(
            cfg,
            synth=dataclasses.replace(cfg.synth, sample_size=64),
            model=dataclasses.replace(cfg.model, no_units=8,
                                      no_intermediate_layers=1),
            train=dataclasses.replace(cfg.train, no_pt_epochs=1,
                                      no_ft_epochs=1, ft_steps_per_epoch=2,
                                      pt_batch_size=4))
    mesh = None
    if args.mesh and pmesh.process_count() > 1:
        mesh = pmesh.make_mesh(args.device)
    trainer = Trainer(cfg, device=args.device, mesh=mesh,
                      wandb_run=_maybe_wandb(cfg) if pmesh.process_index() == 0
                      else None)
    trainer.pretrain()
    rc = _train_real(cfg, trainer, mesh)
    if mesh is not None:
        print(f"rank {mesh.rank} of {mesh.world_size}: " + json.dumps({
            "pretrain": trainer.last_pretrain_metrics,
            "finetune": trainer.last_finetune_metrics,
            "launches": launch_counts()}), flush=True)
    return rc


def _train_real(cfg: QBoldConfig, trainer, mesh) -> int:
    from . import infer
    from .train import data as data_pipe
    from .train.trainer import WeightStatus

    d = cfg.train.data_directory
    if not os.path.exists(d):
        print(f"real data directory {d} not found; pretraining only",
              file=sys.stderr)
        return 0
    real = data_pipe.load_real_directory(d)
    if real["train"] is None:
        print("no ASE training volumes found; pretraining only",
              file=sys.stderr)
        return 0
    hyperv, baseline = real["hyperv"], real["baseline"]
    save = cfg.train.save_directory

    # post-pretrain exports and the population stats for prior
    # initialisation (reference train.py:241-251)
    if baseline is not None:
        stats = trainer.estimate_population_param_distribution(
            _with_brain_mask(baseline))
        if trainer.writes:
            print("population stats (for prior init):", stats)
        if trainer.status is WeightStatus.PRE_TRAINED:
            for name, arr in (("pt_baseline", baseline),
                              ("pt_hyperv", hyperv)):
                if arr is None:
                    continue
                infer.save_predictions(
                    trainer.tuner, cfg, _with_brain_mask(arr),
                    os.path.join(save, name), seed=5, mesh=mesh,
                    transform_directory=_transforms(d, name.split("_")[1]))

    # per-voxel priors from the pre-finetune encoder, for the KL maps of
    # the final exports (reference train.py:227-236)
    k = 5 if cfg.model.use_mvg else 4
    priors = {name: data_pipe.predict_priors(
        trainer._encode_fn(), _with_brain_mask(arr), k)
        for name, arr in (("baseline", baseline), ("hyperv", hyperv))
        if arr is not None}

    trainer.finetune(real["train"], study_data=real["study"])

    # posterior export of the study sets (reference train.py:241-279)
    for name, arr in (("baseline", baseline), ("hyperv", hyperv)):
        if arr is None:
            continue
        infer.save_predictions(
            trainer.tuner, cfg, _with_brain_mask(arr),
            os.path.join(save, name), seed=7,
            transform_directory=_transforms(d, name), use_first_op=False,
            fine_tuned=True, priors=priors.get(name), mesh=mesh)
    return 0


def cmd_baseline(args) -> int:
    """Log-linear WLS fit (reference loglinear.py:107-157). --protocol auto
    (default) takes the reference CLI's 24-tau streamlined grid (tau from
    -0.028 step 0.004, loglinear.py:149-152) when the data carries 24 tau
    channels and the config grid does not, else the config grid;
    'streamlined' / 'config' force one. With --transform-directory the
    (OEF, DBV, R2') maps are also warped to MNI space where FSL is
    installed (reference loglinear.py:31-61)."""
    from . import baseline
    from .io import fsl, nifti

    cfg = _load_cfg(args)
    data = _load_volumes(args.data)
    if args.strip_channels:
        data = data[..., :-args.strip_channels]
    scan = cfg.scan
    if args.protocol == "streamlined":
        scan = dataclasses.replace(scan, tau_start=-0.028, tau_step=0.004)
    elif (args.protocol == "auto" and data.shape[-1] == 24
          and scan.n_taus != data.shape[-1]):
        # never replace a configured grid that already matches the data
        scan = dataclasses.replace(scan, tau_start=-0.028, tau_step=0.004)
    if data.shape[-1] != scan.n_taus:
        print(f"data has {data.shape[-1]} tau channels but the "
              f"{args.protocol} protocol grid has {scan.n_taus}",
              file=sys.stderr)
        return 1
    maps = baseline.wls_maps(data, scan, device=args.device)
    base = args.output or os.path.splitext(args.data)[0]
    tdir = args.transform_directory
    if tdir and fsl.have_fsl():
        fsl.warp_maps_to_mni(maps[..., 0:1], maps[..., 1:2], maps[..., 2:3],
                             base, tdir)
    elif tdir:
        print("FSL not found; skipping MNI warp", file=sys.stderr)
    for i, name in enumerate(("oef", "dbv", "r2p")):
        nifti.save_im_data(maps[..., i:i + 1], f"{base}_{name}", tdir)
    print(f"wrote {base}_{{oef,dbv,r2p}}.nii.gz ({scan.n_taus}-tau grid)")
    return 0


def _load_volumes(path: str) -> np.ndarray:
    """An export request's volume stack: .npy, or .npz (the 'x' entry when
    present, else the archive's first array)."""
    arr = np.load(path)
    if hasattr(arr, "files"):
        # close the zip handle at once: serve opens one a request
        with arr:
            key = "x" if "x" in arr.files else arr.files[0]
            return np.asarray(arr[key])
    return np.asarray(arr)


def _infer_export(trainer, cfg: QBoldConfig, data: np.ndarray, output: str,
                  transform_directory: Optional[str], method: str) -> dict:
    """The one-stack export of ``infer`` and ``serve`` (reference
    model.py:772-887 driven by train.py:241-279). A fine-tuned
    checkpoint's KL map takes per-voxel priors from the PRETRAINED
    encoder (reference train.py:26-31), read from the pt checkpoint beside
    the final one, unless a population prior carries them."""
    from . import infer
    from .train import data as data_pipe
    from .train.trainer import WeightStatus

    # a typo'd estimator fails before the priors' encoder pass
    infer._check_method(method)
    fine_tuned = trainer.status is WeightStatus.FULL_TRAINED
    priors = None
    if fine_tuned and not cfg.model.use_population_prior:
        encode = trainer.pretrained_encode_fn()
        if encode is not None:
            priors = data_pipe.predict_priors(
                encode, data, 5 if cfg.model.use_mvg else 4)
    return infer.save_predictions(
        trainer.tuner, cfg, data, output, seed=7,
        transform_directory=transform_directory, use_first_op=not fine_tuned,
        fine_tuned=fine_tuned, priors=priors, method=method)


def cmd_infer(args) -> int:
    """Posterior map export from save_directory's checkpoint (reference
    model.py:772-887)."""
    from .train.trainer import Trainer, WeightStatus

    cfg = _load_cfg(args)
    trainer = Trainer(cfg, device=args.device)
    if trainer.status is WeightStatus.NOT_TRAINED:
        print("no checkpoint found in save_directory", file=sys.stderr)
        return 1
    _infer_export(trainer, cfg, _load_volumes(args.data), args.output,
                  args.transform_directory, args.method)
    return 0


def cmd_serve(args) -> int:
    """Warm inference server: restore the checkpoint once, then answer
    export requests, one JSON object a line on stdin, with one ack line
    each on stdout.

      {"data": "vols.npy", "output": "out/subj"}   an export request
          (optional: "method": "quadrature" | "mc")
      {"cmd": "ping"}                               readiness probe
      {"cmd": "shutdown"}  (or the end of stdin)    clean exit

    Acks: {"ok": true, "output", "subjects", "voxels", "wall_s"} or
    {"ok": false, "error"}; a bad request never ends the server.
    ``--warm S X Y Z`` runs one export of zeros of that geometry first."""
    import tempfile

    from .train.trainer import Trainer, WeightStatus

    if args.warm and min(args.warm) < 1:
        print(f"--warm dimensions must be >= 1, got {args.warm}",
              file=sys.stderr)
        return 1
    cfg = _load_cfg(args)
    trainer = Trainer(cfg, device=args.device)
    if trainer.status is WeightStatus.NOT_TRAINED:
        print("no checkpoint found in save_directory", file=sys.stderr)
        return 1

    def ack(obj: dict) -> None:
        print(json.dumps(obj), flush=True)

    if args.warm:
        s, x, y, z = args.warm
        t0 = time.perf_counter()
        vols = np.zeros((s, x, y, z, cfg.scan.n_taus + 1), np.float32)
        vols[..., -1] = 1.0
        with tempfile.TemporaryDirectory() as td:
            _infer_export(trainer, cfg, vols, os.path.join(td, "warm"),
                          None, args.method)
        print(f"warmed ({s},{x},{y},{z}) export in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    ack({"ok": True, "ready": True,
         "fine_tuned": trainer.status is WeightStatus.FULL_TRAINED})
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            ack({"ok": False, "error": f"bad json: {e}"})
            continue
        if not isinstance(req, dict):
            ack({"ok": False, "error": "request must be a JSON object, got "
                                       f"{type(req).__name__}"})
            continue
        if req.get("cmd") == "shutdown":
            ack({"ok": True, "shutdown": True})
            break
        if req.get("cmd") == "ping":
            ack({"ok": True, "ready": True})
            continue
        if "cmd" in req:
            ack({"ok": False, "error": f"unknown cmd: {req['cmd']!r}"})
            continue
        try:
            data = _load_volumes(req["data"])
            t0 = time.perf_counter()
            _infer_export(trainer, cfg, data, req["output"],
                          req.get("transform_directory"),
                          req.get("method", args.method))
            ack({"ok": True, "output": req["output"],
                 "subjects": int(data.shape[0]),
                 "voxels": int(np.prod(data.shape[:-1])),
                 "wall_s": round(time.perf_counter() - t0, 3)})
        except Exception as e:   # noqa: BLE001 -- a bad request must never
            # end the warm process
            ack({"ok": False, "error": f"{type(e).__name__}: {e}"})
    return 0


def cmd_synth(args) -> int:
    """Generate a synthetic dataset .npz (reference signals.py:302-332): the
    cross product of the population samples, drawn and decoded on the
    device (synth.create_synthetic_dataset) from the config seed."""
    from .synth import create_synthetic_dataset

    cfg = _load_cfg(args)
    x, y = create_synthetic_dataset(
        cfg.train.seed, cfg.scan, cfg.synth, full_model=cfg.train.full_model,
        use_blood=cfg.train.use_blood, quad_rule=cfg.model.quad_rule,
        device=args.device)
    np.savez(args.output, x=x.cpu().numpy(), y=y.cpu().numpy())
    print(f"wrote {args.output}: x{tuple(x.shape)} y{tuple(y.shape)}")
    return 0


def cmd_export_model(args) -> int:
    """Serialize the inference program to a torch.export serving artifact
    (io/export_model.py): the deployment story the reference lacks (its
    model.py:772-887 requires the training codebase to predict)."""
    from .io.export_model import (PLATFORMS, _check_platforms,
                                  export_inference, save_exported)
    from .train.trainer import Trainer, WeightStatus

    try:
        platforms = _check_platforms(p.strip() for p in
                                     args.platforms.split(",") if p.strip())
    except ValueError as e:
        print(f"--platforms {args.platforms!r}: {e}; python -m qbold_vi_tpu "
              "export-model writes TPU artifacts", file=sys.stderr)
        return NOT_PORTED
    cfg = _load_cfg(args)
    trainer = Trainer(cfg, device=args.device)
    if trainer.status is WeightStatus.NOT_TRAINED:
        print("no checkpoint found in save_directory", file=sys.stderr)
        return 1
    fine_tuned = trainer.status is WeightStatus.FULL_TRAINED
    if args.fused and platforms == PLATFORMS:
        platforms = ("cuda",)   # the fused artifact runs on the card only
    use_first_op = args.fused or not fine_tuned
    if args.fused and fine_tuned:
        print("note: --fused serves the stream-1 (voxelwise) posterior "
              "head -- the reference's save_predictions default "
              "(model.py:776) -- not the stream-2 maps the non-fused "
              "export of a fine-tuned checkpoint serves", file=sys.stderr)
    example = tuple(args.static_shape) if args.static_shape else (1, 64, 64, 8)
    polymorphic = not (args.static_shape or args.fused)
    exp = export_inference(trainer.tuner, use_first_op=use_first_op,
                           platforms=platforms, polymorphic=polymorphic,
                           example_shape=example, fused=args.fused)
    n = save_exported(exp, args.output)
    n_ch = cfg.scan.n_taus + 1
    shape = (f"{n_ch}, {int(np.prod(example))}" if args.fused
             else f"s, x, y, z, {n_ch}" if polymorphic
             else ", ".join(str(d) for d in example + (n_ch,)))
    print(f"wrote {args.output}: {n} bytes, platforms {','.join(platforms)}"
          f", input ({shape}) float32, "
          f"{'fine-tuned' if fine_tuned else 'pretrained'} checkpoint, "
          f"stream-{1 if use_first_op else 2} head")
    return 0


def _save_fresh(trainer, params: dict, phase: str) -> str:
    """Write ``params`` as the checkpoint of ``phase`` in the trainer's
    save_directory with a fresh optimiser state (and, for pretraining
    with SWA, a fresh average), as the JAX CLI's import-weights and
    transfer write theirs; returns the path."""
    from .train import optim

    trainer._load_params(params)
    named = list(trainer.tuner.named_parameters())
    if phase == "finetune":
        optimizer = optim.make_finetune_optimizer(
            [p for _, p in named], trainer.cfg.train)
        path = trainer.final_path
    else:
        optimizer = optim.make_pretrain_optimizer(named, trainer.cfg.train)
        trainer.swa = optim.swa_init(named) if trainer.cfg.train.use_swa \
            else None
        path = trainer.pt_path
    trainer._save(path, phase, optimizer)
    return path


def cmd_import_weights(args) -> int:
    """Convert a trained reference .h5 checkpoint into the Trainer's
    checkpoint files (io/keras_import.py): a pt_model.h5 becomes
    pt_model.msgpack; --final converts a fine-tuned final_model.h5 (with
    the learned population prior / trainable sigma extras, reference
    model.py:252-281) into final_model.msgpack, which a Trainer resumes as
    FULL_TRAINED."""
    from .io.keras_import import load_reference_h5
    from .train.trainer import Trainer

    cfg = _load_cfg(args)
    try:
        imported = load_reference_h5(args.h5, cfg.model)
    except ImportError as e:
        print(f"import-weights reads the .h5 with h5py, which is not "
              f"installed here ({e}): run it on a host that has h5py "
              "(--device cpu) and carry the checkpoint over",
              file=sys.stderr)
        return 1
    trainer = Trainer(cfg, device=args.device)
    params = {k: v for k, v in trainer._init_params().items()
              if not k.startswith("encoder.")}
    params.update(imported)   # encoder + pop_prior/log_sigma when present
    extras = sorted({k for k in imported if not k.startswith("encoder.")})
    out = _save_fresh(trainer, params,
                      "finetune" if args.final else "pretrain")
    print(f"imported {args.h5} -> {out}"
          + (f" (extras: {', '.join(extras)})" if extras else ""))
    return 0


def cmd_transfer(args) -> int:
    """Retarget a trained checkpoint to a different tau protocol
    (models/transfer.py): trunk weights are kept, the tau-dependent first
    conv and sigma head are re-initialised for the new grid, and the
    result is written as pt_model.msgpack in --output."""
    import torch

    from .models.transfer import transfer_params
    from .train.trainer import Trainer, WeightStatus

    cfg = _load_cfg(args)
    src = Trainer(cfg, device=args.device)
    if src.status is WeightStatus.NOT_TRAINED:
        print("no checkpoint in save_directory", file=sys.stderr)
        return 1
    new_scan = dataclasses.replace(
        cfg.scan, tau_start=args.tau_start, tau_step=args.tau_step,
        tau_end=args.tau_end)
    new_cfg = dataclasses.replace(
        cfg, scan=new_scan,
        train=dataclasses.replace(cfg.train, save_directory=args.output))
    sample = np.zeros((1, 4, 4, 2, new_scan.n_taus), np.float32)
    params = transfer_params(torch.Generator().manual_seed(cfg.train.seed),
                             src.tuner.state_dict(), new_cfg.model, new_scan,
                             sample)
    dst = Trainer(new_cfg, device=args.device)
    path = _save_fresh(dst, params, "pretrain")
    print(f"transferred to {new_scan.n_taus}-tau protocol -> {path}")
    return 0


def cmd_dryrun(args) -> int:
    """The sharded paths on ``--devices`` spawned ranks (parallel/
    dryrun.py), or with ``--processes`` > 1 on that many: both are the
    multi-process certification against one process (parallel/
    multihost.py); prints the result's JSON."""
    from .parallel import dryrun, multihost

    if args.processes > 1:
        out = multihost.certify(args.processes, device=args.device)
    else:
        out = dryrun.run(args.devices, device=args.device)
    print(json.dumps(out))
    return 0


def cmd_sweep(args) -> int:
    """A grid sweep over layers x units x seeds (reference wandb_sweep.py),
    a Bayesian (TPE, the YAML's ``method: bayes``) or random search from a
    space YAML (``--space``, reference configurations/sweep_prior.yaml),
    or an agent of an existing wandb sweep (``--agent``). Trials train the
    two-phase program when the data directory holds ASE volumes, else the
    pretrain objective; ``--parallel-trials`` trains them as populations,
    ``--mesh`` their trials over the ranks of ``--coordinator``. Prints
    the ranked results' JSON."""
    import torch.distributed as dist

    from .parallel import mesh as pmesh

    backend = pmesh.initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        device=args.device)
    try:
        return _sweep(args)
    finally:
        if backend is not None:
            dist.destroy_process_group()


def _sweep(args) -> int:
    from . import sweep
    from .parallel import mesh as pmesh

    cfg = _load_cfg(args)
    objective = sweep.default_objective(cfg)
    run_fn = None if objective is sweep._default_run else objective
    print("sweep objective: " + ("two-phase (real-data val_elbo)" if run_fn
                                 else "pretrain (synthetic val loss)"),
          file=sys.stderr)
    if args.parallel_trials > 1:
        print(f"populations of {args.parallel_trials} trials",
              file=sys.stderr)
    mesh = None
    if args.mesh and args.parallel_trials > 1 and pmesh.process_count() > 1:
        mesh = pmesh.make_mesh(args.device)
        print(f"population trials over {mesh.world_size} ranks",
              file=sys.stderr)
    if args.agent:
        try:
            import wandb
        except ImportError:
            print("sweep --agent needs wandb, which is not installed",
                  file=sys.stderr)
            return MISSING
        n = sweep.run_wandb_agent(args.agent, cfg, count=args.trials or None,
                                  run_fn=run_fn, wandb_module=wandb,
                                  parallel_trials=args.parallel_trials,
                                  mesh=mesh, device=args.device)
        print(json.dumps({"agent": args.agent, "trials_run": n}))
        return 0
    if args.space:
        try:
            import yaml
        except ImportError:
            print("sweep --space needs pyyaml, which is not installed: give "
                  "a grid sweep (--layers / --units / --seeds) and --set "
                  "overrides", file=sys.stderr)
            return MISSING
        with open(args.space) as f:
            spec = yaml.safe_load(f)
        if "parameters" in spec:
            # the reference's own wandb sweep grammar
            space, metric, goal, method = sweep.parse_wandb_sweep(spec)
        else:
            # flat: {space: {...}, metric: ..., goal: ..., method: ...}
            space = spec["space"]
            metric = spec.get("metric", "val_elbo")
            goal = spec.get("goal", "minimize")
            method = spec.get("method", "bayes")
        search = (sweep.bayes_search if (args.method or method) == "bayes"
                  else sweep.random_search)
        results = search(cfg, space, n_trials=args.trials, metric=metric,
                         run_fn=run_fn, maximize=goal == "maximize",
                         parallel_trials=args.parallel_trials, mesh=mesh,
                         device=args.device)
    else:
        results = sweep.run_grid_sweep(cfg, layers=args.layers,
                                       units=args.units, seeds=args.seeds,
                                       run_fn=run_fn, device=args.device)
    print(json.dumps(results, default=str, indent=1))
    return 0


def build_parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--config", "-c", default=None,
                        help="YAML config path (needs pyyaml, which the "
                             "CUDA machine lacks: use --preset and --set "
                             "there)")
    common.add_argument("--preset", default="default",
                        choices=["default", "optimal"])
    common.add_argument("--set", action="append", metavar="KEY=VAL",
                        help="flat config overrides (reference-style keys); "
                             "unknown keys raise with a did-you-mean")
    common.add_argument("--ini", default=None, metavar="CONFIG",
                        help="reference-style INI config file: the scanner "
                             "constants and the synthetic-population "
                             "section")
    common.add_argument("--allow-unknown-keys", action="store_true",
                        help="ignore (with a warning) config keys this "
                             "build does not know instead of raising")
    common.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the port runs (default: the CUDA card; "
                             "without one the command fails unless given "
                             "--device cpu -- the counterpart of the JAX "
                             "CLI's QBOLD_CPU_DEVICES)")

    p = argparse.ArgumentParser(prog="qbold_vi_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name, **kw):
        return sub.add_parser(name, parents=[common], **kw)

    sp = add("train", help="two-phase training")
    sp.add_argument("--smoke", action="store_true",
                    help="tiny end-to-end run (verification)")
    sp.add_argument("--mesh", action="store_true",
                    help="data-parallel over the ranks of --coordinator "
                         "(one process a device)")
    sp.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="the rendezvous of a multi-process run, served by "
                         "rank 0: run the SAME command for every rank with "
                         "its own --process-id; checkpoints, logs and maps "
                         "come from rank 0")
    sp.add_argument("--num-processes", type=int, default=None)
    sp.add_argument("--process-id", type=int, default=None)
    sp.set_defaults(fn=cmd_train)

    transform_help = ("directory with nonlin<i>.nii.gz warps + "
                      "MNI152_T1_2mm.nii.gz for the MNI-space export "
                      "(needs FSL and nibabel; without FSL the maps stay in "
                      "native space)")
    sp = add("baseline", help="log-linear WLS fit")
    sp.add_argument("data", help=".npy signal volumes")
    sp.add_argument("--output", "-o", default=None)
    sp.add_argument("--strip-channels", type=int, default=2,
                    help="trailing mask channels to drop (reference uses 2)")
    sp.add_argument("--protocol", default="auto",
                    choices=["auto", "streamlined", "config"],
                    help="tau grid: the reference CLI's 24-tau streamlined "
                         "protocol, the config grid, or auto-pick by "
                         "channel count (default)")
    sp.add_argument("--transform-directory", default=None,
                    help=transform_help)
    sp.set_defaults(fn=cmd_baseline)

    method_help = ("posterior summary estimator: Gaussian quadrature "
                   "(default) or the reference's 200-sample MC")
    sp = add("infer", help="posterior map export (sampled maps from seed "
                           "7, where the JAX CLI passes PRNGKey(7))")
    sp.add_argument("data", help=".npy volumes with trailing mask channel")
    sp.add_argument("--output", "-o", required=True)
    sp.add_argument("--transform-directory", default=None,
                    help=transform_help)
    sp.add_argument("--method", choices=("quadrature", "mc"),
                    default="quadrature", help=method_help)
    sp.set_defaults(fn=cmd_infer)

    sp = add("serve", help="warm inference server: JSON-line export "
                           "requests on stdin, one ack a line on stdout")
    sp.add_argument("--method", choices=("quadrature", "mc"),
                    default="quadrature",
                    help=method_help + "; a request's 'method' overrides")
    sp.add_argument("--warm", type=int, nargs=4, default=None,
                    metavar=("S", "X", "Y", "Z"),
                    help="run one export of this volume geometry before "
                         "accepting requests")
    sp.set_defaults(fn=cmd_serve)

    sp = add("synth", help="generate synthetic dataset (drawn from a "
                           "generator seeded with the config seed)")
    sp.add_argument("--output", "-o", default="synthetic_data.npz")
    sp.set_defaults(fn=cmd_synth)

    sp = add("export-model", help="serialize inference to a torch.export "
                                  "serving artifact (.pt2)")
    sp.add_argument("--output", "-o", required=True,
                    help="artifact path (e.g. model.pt2)")
    sp.add_argument("--platforms", default="cuda,cpu",
                    help="comma-separated platforms the artifact serves "
                         "(cuda, cpu; default both: the default artifact "
                         "loads on either; tpu exits 2)")
    sp.add_argument("--static-shape", type=int, nargs=4, default=None,
                    metavar=("S", "X", "Y", "Z"),
                    help="bake a fixed volume geometry instead of the "
                         "default shape-polymorphic (s, x, y, z) export")
    sp.add_argument("--fused", action="store_true",
                    help="export kernel B (the fused stream-1 encode + "
                         "quadrature, a registered op): channel-major "
                         "(n_taus+1, N) input with N baked from "
                         "--static-shape; runs on the card only, in a "
                         "process that has imported qbold_vi_tpu_torch")
    sp.set_defaults(fn=cmd_export_model)

    sp = add("import-weights", help="convert a reference .h5 checkpoint "
                                    "(needs h5py)")
    sp.add_argument("h5", help="path to reference pt_model.h5/final_model.h5")
    sp.add_argument("--reference-dir", default=None,
                    help="the JAX CLI's checkout of the upstream code for "
                         "its Keras fallback; the port has none and does "
                         "not read it")
    sp.add_argument("--final", action="store_true",
                    help="the .h5 is a fine-tuned final_model: write "
                         "final_model.msgpack (FULL_TRAINED resume)")
    sp.set_defaults(fn=cmd_import_weights)

    sp = add("transfer", help="retarget a checkpoint to a new tau protocol")
    sp.add_argument("--tau-start", type=float, required=True)
    sp.add_argument("--tau-step", type=float, required=True)
    sp.add_argument("--tau-end", type=float, required=True)
    sp.add_argument("--output", "-o", required=True,
                    help="save_directory for the transferred checkpoint")
    sp.set_defaults(fn=cmd_transfer)

    sp = add("dryrun", help="the sharded paths on spawned ranks")
    sp.add_argument("--devices", type=int, default=8,
                    help="ranks to spawn, one device each")
    sp.add_argument("--processes", type=int, default=1,
                    help="certify this many ranks against one process "
                         "(metrics bit-equal across ranks and within rtol "
                         "2e-5 of the single-process run); --devices is "
                         "then not read")
    sp.set_defaults(fn=cmd_dryrun)

    sp = add("sweep", help="grid sweep over layers x units, or a "
                           "Bayesian/random search from a space YAML")
    sp.add_argument("--layers", type=int, nargs="+", default=[2, 4, 6, 8, 10])
    sp.add_argument("--units", type=int, nargs="+", default=[2, 4, 6, 8, 10])
    sp.add_argument("--seeds", type=int, default=3)
    sp.add_argument("--space", default=None,
                    help="search-space YAML, wandb sweep grammar or flat "
                         "(e.g. configurations/sweep_prior.yaml; needs "
                         "pyyaml)")
    sp.add_argument("--method", default=None, choices=["bayes", "random"],
                    help="override the YAML's sweep method")
    sp.add_argument("--trials", type=int, default=20)
    sp.add_argument("--parallel-trials", type=int, default=1,
                    dest="parallel_trials",
                    help="train this many trials together as ONE "
                         "population (kernel S and kernel F once a step "
                         "for all of them)")
    sp.add_argument("--mesh", action="store_true",
                    help="split each population's trials over the ranks "
                         "of --coordinator (needs --parallel-trials > 1)")
    sp.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="the rendezvous of a multi-process sweep, served "
                         "by rank 0: run the SAME command for every rank "
                         "with its own --process-id")
    sp.add_argument("--num-processes", type=int, default=None)
    sp.add_argument("--process-id", type=int, default=None)
    sp.add_argument("--agent", default=None, metavar="SWEEP_ID",
                    help="attach to an existing wandb sweep as an agent "
                         "(needs wandb); --trials caps the run count")
    sp.set_defaults(fn=cmd_sweep)
    return p


def main(argv: Optional[list] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
