"""Two-phase training orchestrator (PyTorch).

The counterpart of ``qbold_vi_tpu/train/trainer.py`` (reference
train.py:17-72, 188-427):

* ``pretrain``: in host-set mode the fixed synthetic set of the JAX
  trainer (the same numpy draws from the same seed fold, synth.py), split
  into pseudo-volumes, uploaded once; each epoch takes its shuffled
  batches in the JAX trainer's order (``np.random.default_rng(seed)``);
  in streaming mode (``pt_on_device_synth``) each epoch runs
  ``round(0.9 sample_size^2 / 500 / pt_batch_size)`` steps, each on a
  fresh batch drawn on the device (kernel S, steps.
  make_pretrain_stream_epoch), and validates on the fixed seed fold
  (``pretrain_val_fold``); then the held-out validation; SWA when
  configured, adopted under ``swa_adopt``;
* ``prepare_real``: blank crop, per-voxel priors from the encoder's plain
  forward pass, and a ``RealCropSampler``;
* ``finetune``: the priors of the training and study crops are predicted
  once, on the first call, from the weights fine-tuning starts from (the
  JAX trainer predicts them from the pretrained encoder); the volumes and
  priors go to the device; each epoch runs ``ft_steps_per_epoch`` steps on
  crops drawn there (steps.make_finetune_epoch_on_device), reads its
  metrics back once, logs them and trips on a non-finite one; with study
  data, the ELBO validation runs after every epoch. Calls with ``epochs=``
  continue the schedule up to ``no_ft_epochs``; a call after it returns
  at once.

``WeightStatus`` and checkpoints follow the JAX trainer (its files, read
and written by train/checkpoint.py, cross both ways):

* a Trainer resumes the most advanced checkpoint of ``save_directory``:
  ``final_model.msgpack`` -> FULL_TRAINED, else ``pt_model.msgpack`` ->
  PRE_TRAINED; one with neither starts NOT_TRAINED from
  ``init_params(seed)``, and finetune() raises until pretrain() has run;
* one given ``state_dict`` starts PRE_TRAINED from it and refuses a
  directory that holds either file or ``pt_model.msgpack.partial``, and
  one that holds ``final_model.msgpack.partial`` unless
  ``resume_partial=True`` asks that its fine-tune resume it (the
  ``.partial``'s weights then replace the given ones);
* pretrain() writes ``pt_model.msgpack``; finetune() writes
  ``final_model.msgpack`` once ``no_ft_epochs`` are done;
* with ``checkpoint_every_epochs`` k > 0, every k-th epoch of a phase
  writes ``<file>.partial`` (after the NaN tripwire has passed the epoch,
  so a poisoned state never reaches disk), the next Trainer's phase
  resumes it at epoch ``step // steps_per_epoch``, and the phase's end
  removes it. A resume restarts ``self.generator`` from the config seed,
  as the JAX trainer restarts its key sequence (trainer.py:333-336), so a
  resumed run draws other crops and noise than an uninterrupted one;
  two runs resumed from one ``.partial`` end equal.

The tuner lives on the CUDA card unless ``device="cpu"`` is given.

Under a mesh (``Trainer(cfg, mesh=parallel.make_mesh())`` on every rank;
the JAX trainer's mesh branches) the weights are broadcast from rank 0
and stay replicated; the streaming pretrain runs the sharded epoch
(every rank draws its own volumes, kernel S on the card), the host-set
pretrain takes each rank's rows of every batch; fine-tuning runs the
replicated epoch (the volumes on every rank) or, under
``ft_shard_subjects`` "on" or "auto" above ``SHARD_SUBJECTS_AUTO_BYTES``,
the subject-sharded one (a rank holds ceil(S / n) subjects);
evaluation batches are sharded where the mesh divides them, replicated
otherwise. Only rank 0 writes checkpoints and calls the logger; the NaN
tripwire runs on every rank (the metrics are replicated, so all raise
together).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import QBoldConfig, normalize_mode
from ..models.vi import FineTuner, init_params
from ..parallel import mesh as pmesh
from ..synth import create_synthetic_dataset_host, pretrain_data_seed
from . import data as data_pipe
from .checkpoint import (CheckpointMismatchError, TrainState, _load_state,
                         _save_state, capture_state, opt_tail,
                         restore_optimizer)
from .optim import (make_finetune_optimizer, make_pretrain_optimizer,
                    swa_init, swa_update)
from .steps import (_subject_shard_counts, fold_seed,
                    make_finetune_epoch_on_device,
                    make_finetune_epoch_sharded,
                    make_finetune_epoch_subject_sharded, make_finetune_eval,
                    make_pretrain_eval, make_pretrain_step,
                    make_pretrain_stream_epoch)

__all__ = ["Trainer", "NaNLossError", "WeightStatus", "val_batch_count",
           "pretrain_val_fold", "stream_steps_per_epoch",
           "CheckpointMismatchError"]

_SEED_HI = 2 ** 62


class NaNLossError(RuntimeError):
    """A logged training metric was not finite."""


class WeightStatus(enum.Enum):
    """Training progress (reference qbold_build_model.py:11-14)."""
    NOT_TRAINED = 0
    PRE_TRAINED = 1
    FULL_TRAINED = 2


def pretrain_val_fold(cfg: QBoldConfig, device=None):
    """(vx, vy): the fixed held-out synthetic validation fold of the
    streaming pretrain -- the host set of ``min(sample_size, 160)`` from
    the config seed's fold (synth.pretrain_data_seed), split 90/10, its
    last 10% (the JAX trainer's, qbold_vi_tpu/train/trainer.py:59-80). The
    decode runs on ``device``, the CUDA card unless given another."""
    val_synth = dataclasses.replace(
        cfg.synth, sample_size=min(cfg.synth.sample_size, 160))
    x, y = create_synthetic_dataset_host(
        pretrain_data_seed(cfg.train.seed), cfg.scan, val_synth,
        full_model=cfg.train.full_model, use_blood=cfg.train.use_blood,
        quad_rule=cfg.model.quad_rule, device=device)
    _, val = data_pipe.split_synthetic(x, y)
    return val


def stream_steps_per_epoch(cfg: QBoldConfig) -> int:
    """The streaming pretrain's steps an epoch: 90% of sample_size^2
    voxels in pseudo-volumes of 500, over the batch (the JAX trainer's)."""
    return max(1, round(0.9 * cfg.synth.sample_size ** 2 / 500
                        / cfg.train.pt_batch_size))


def val_batch_count(n_volumes: int, vol_voxels: int) -> int:
    """The per-epoch validation batch bound, ~4k voxels."""
    return min(n_volumes, 4096 // vol_voxels + 1)


def _stdout_logger(phase: str, step: int, metrics: dict) -> None:
    body = " ".join(f"{k}={v:.5g}" for k, v in metrics.items())
    print(f"[{phase}] epoch {step}: {body}", flush=True)


class Trainer:
    """Synthetic pretraining and ELBO fine-tuning.

        t = Trainer(cfg)                        # on the card
        t.pretrain()                            # phase 1 (synthetic)
        t.finetune(train_data)                  # phase 2 (MC-ELBO)

    or ``Trainer(cfg, state_dict=params).finetune(train_data)`` from given
    weights (``init_params`` or io/from_jax.py)."""

    # the learned inverse-gamma hyperprior is logged as exp(raw), which may
    # overflow without the run diverging; the tripwire skips it, as the
    # JAX trainer does
    _TRIPWIRE_EXEMPT = frozenset(
        {"oef_alpha", "oef_beta", "dbv_alpha", "dbv_beta"})

    # the replicated volume + prior bytes above which ft_shard_subjects
    # "auto" shards the subjects under a mesh (the JAX trainer's): a few MB
    # at the published scale replicate for free; a cohort near a card's
    # memory must shard or cannot train
    SHARD_SUBJECTS_AUTO_BYTES: int = 1 << 30

    def __init__(self, cfg: QBoldConfig, *, state_dict: Optional[dict] = None,
                 resume_partial: bool = False, device=None, mesh=None,
                 logger: Callable[[str, int, dict], None] = _stdout_logger,
                 wandb_run=None):
        if mesh is not None:
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"{mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.cfg = cfg
        self.save_dir = cfg.train.save_directory
        if state_dict is not None:
            refused = [self.final_path, self.pt_path,
                       self._partial_path(self.pt_path)]
            if not resume_partial:
                refused.append(self._partial_path(self.final_path))
            found = [p for p in refused if os.path.isfile(p)]
            if found:
                raise ValueError(
                    f"a Trainer given state_dict= would not choose between "
                    f"its weights and {', '.join(found)}: pass another "
                    f"save_directory than {self.save_dir!r}, or no "
                    "state_dict to resume a checkpoint, or "
                    "resume_partial=True to resume final_model.msgpack."
                    "partial")
        self.tuner = FineTuner(cfg.model, cfg.scan, device=device,
                               full_model=cfg.train.full_model,
                               use_blood=cfg.train.use_blood)
        self.status = (WeightStatus.NOT_TRAINED if state_dict is None
                       else WeightStatus.PRE_TRAINED)
        self._load_params(self._init_params() if state_dict is None
                          else state_dict)
        self.generator = torch.Generator().manual_seed(cfg.train.seed)
        self.logger = logger
        self.wandb_run = wandb_run
        self.optimizer = None
        self.epochs_done = 0
        self.sampler = None
        self._ft_samplers = None      # (training, study) crops of finetune
        self._pt_tuner = None         # pretrained_encode_fn's weights
        self.swa = None
        self.last_pretrain_metrics: dict = {}
        self.last_finetune_metrics: dict = {}
        if state_dict is None:
            self._maybe_resume()
        self._replicate()

    @property
    def writes(self) -> bool:
        """Whether this process writes checkpoints and logs: rank 0 (of
        the mesh, or of an initialised process group without one)."""
        return (pmesh.process_index() if self.mesh is None
                else self.mesh.rank) == 0

    def _replicate(self) -> None:
        """Rank 0's weights on every rank."""
        if self.mesh is not None:
            pmesh.replicate(self.mesh, [p.detach()
                                        for p in self.tuner.parameters()])

    # ---- checkpoints ------------------------------------------------------

    @property
    def pt_path(self) -> str:
        return os.path.join(self.save_dir, "pt_model.msgpack")

    @property
    def final_path(self) -> str:
        return os.path.join(self.save_dir, "final_model.msgpack")

    def _init_params(self) -> dict:
        return init_params(self.cfg.model, self.cfg.scan,
                           torch.Generator().manual_seed(self.cfg.train.seed))

    def _with_extras(self, params: dict) -> dict:
        """``params`` with the population prior or noise scale that the
        config asks for and they lack taken from ``init_params``, as the
        JAX fine-tune tops them up (trainer.py:669-672)."""
        missing = [k for k in ("pop_prior", "log_sigma")
                   if hasattr(self.tuner, k) and k not in params]
        if not missing:
            return params
        init = self._init_params()
        return dict(params, **{k: init[k] for k in missing})

    def _load_params(self, params: dict) -> None:
        self.tuner.load_state_dict(self._with_extras(params))

    def _load_state(self, path: str, phase: str,
                    expect_steps_per_epoch: Optional[int] = None
                    ) -> TrainState:
        train = self.cfg.train
        return _load_state(path, self.cfg, tail=opt_tail(phase, train),
                           swa=phase == "pretrain" and train.use_swa,
                           expect_steps_per_epoch=expect_steps_per_epoch)

    def _maybe_resume(self) -> None:
        """Restore the most advanced checkpoint of save_directory
        (reference qbold_build_model.py:45-56)."""
        if os.path.isfile(self.final_path):
            state = self._load_state(self.final_path, "finetune")
            self.status = WeightStatus.FULL_TRAINED
            self.epochs_done = self.cfg.train.no_ft_epochs
        elif os.path.isfile(self.pt_path):
            state = self._load_state(self.pt_path, "pretrain")
            self.status = WeightStatus.PRE_TRAINED
        else:
            return
        self._load_params(state.params)

    @staticmethod
    def _partial_path(final_path: str) -> str:
        return final_path + ".partial"

    def _phase_start(self, final_path: str, phase: str,
                     steps_per_epoch: int):
        """(TrainState or None, start epoch): the phase's ``.partial``
        when mid-phase checkpoints are on and one exists."""
        partial = self._partial_path(final_path)
        if self.cfg.train.checkpoint_every_epochs <= 0 or \
                not os.path.isfile(partial):
            return None, 0
        state = self._load_state(partial, phase,
                                 expect_steps_per_epoch=steps_per_epoch)
        return state, state.step // max(1, steps_per_epoch)

    def _resume(self, state: TrainState, optimizer) -> None:
        """Load a ``.partial``'s weights and optimiser state and restart
        the generator from the config seed (the JAX trainer restarts its
        key sequence on a resume)."""
        self._load_params(state.params)
        restore_optimizer(optimizer, self.tuner, state.opt_state)
        self.generator.manual_seed(self.cfg.train.seed)
        self._replicate()

    def _save(self, path: str, phase: str, optimizer,
              steps_per_epoch: int = 0) -> int:
        """Write the phase's state to ``path`` (rank 0 of a mesh, the others
        waiting until it is written); the bytes written."""
        n = 0
        if self.writes:
            state = capture_state(self.tuner, optimizer,
                                  self.swa if phase == "pretrain" else None,
                                  opt_tail(phase, self.cfg.train))
            n = _save_state(path, state, cfg=self.cfg,
                            steps_per_epoch=steps_per_epoch)
        if self.mesh is not None:
            pmesh.barrier(self.mesh)
        return n

    def _phase_checkpoint(self, final_path: str, phase: str, optimizer,
                          epoch: int, steps_per_epoch: int) -> None:
        k = self.cfg.train.checkpoint_every_epochs
        if k > 0 and (epoch + 1) % k == 0:
            self._save(self._partial_path(final_path), phase, optimizer,
                       steps_per_epoch)

    def _phase_done(self, final_path: str) -> None:
        partial = self._partial_path(final_path)
        if self.writes and os.path.isfile(partial):
            os.remove(partial)

    def pretrained_params(self) -> Optional[dict]:
        """The pretrained weights (a state_dict): the current ones while
        PRE_TRAINED, else those of ``pt_model.msgpack`` (kept after
        fine-tuning) -- the encoder the reference predicts per-voxel
        priors with (train.py:26-31); None without a pt checkpoint."""
        if self.status is WeightStatus.PRE_TRAINED:
            return {k: v.detach().clone()
                    for k, v in self.tuner.state_dict().items()}
        if not os.path.isfile(self.pt_path):
            return None
        return self._with_extras(
            self._load_state(self.pt_path, "pretrain").params)

    # ---- phase 1: synthetic pretraining -----------------------------------

    def build_pretrain_data(self, synthetic: Optional[tuple] = None):
        """((train_x, train_y) or None, (val_x, val_y)): pseudo-volumes of
        the fixed synthetic set -- generated from the config (the JAX
        trainer's numbers: synth.pretrain_data_seed) unless ``synthetic``
        (x, y) is given -- split 90/10; in streaming mode no training set
        (its batches are drawn each step) and the seed fold
        (``pretrain_val_fold``)."""
        cfg = self.cfg
        if cfg.train.pt_on_device_synth and synthetic is None:
            return None, pretrain_val_fold(cfg, self.tuner.device)
        if synthetic is None:
            x, y = create_synthetic_dataset_host(
                pretrain_data_seed(cfg.train.seed), cfg.scan, cfg.synth,
                full_model=cfg.train.full_model,
                use_blood=cfg.train.use_blood,
                quad_rule=cfg.model.quad_rule, device=self.tuner.device)
        else:
            x, y = synthetic
        return data_pipe.split_synthetic(x, y)

    def _put_eval_batch(self, batch: dict) -> tuple:
        """(batch on the device, rows): under a mesh that divides its rows,
        the rank's rows and rows = (lo, hi, n); otherwise the whole batch
        (replicated) and None."""
        lead = len(next(iter(batch.values())))
        if self.mesh is not None and lead % self.mesh.world_size == 0:
            lo, hi = pmesh.host_local_rows(self.mesh, lead)
            return pmesh.shard_batch(self.mesh, batch), (lo, hi, lead)
        dev = self.tuner.device
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in batch.items()}, None

    def _clip_val_batch(self, vx: np.ndarray, vy: np.ndarray) -> tuple:
        """The validation batch (at most ~4k voxels; under a mesh, a
        multiple of the world size where the set allows) placed by
        _put_eval_batch."""
        n_val = val_batch_count(len(vx), int(np.prod(vx.shape[1:4])))
        if self.mesh is not None:
            n = self.mesh.world_size
            n_val = max(n_val // n * n, min(len(vx), n))
        return self._put_eval_batch({"x": vx[:n_val], "y": vy[:n_val]})

    def _seed(self) -> int:
        return int(torch.randint(0, _SEED_HI, (1,), generator=self.generator))

    def pretrain_val_metrics(self, synthetic: Optional[tuple] = None, *,
                             fold: bool = False) -> dict:
        """The held-out synthetic validation metrics of the current weights,
        on the set and batch pretrain() evaluates each epoch; ``fold=True``
        evaluates on the seed fold (``pretrain_val_fold``) whatever the
        pretrain mode, so that runs of both modes rank on one set; it
        takes no ``synthetic`` set."""
        if fold and synthetic is not None:
            raise ValueError("fold=True evaluates on the seed fold: pass "
                             "no synthetic set")
        if fold:
            vx, vy = pretrain_val_fold(self.cfg, self.tuner.device)
        else:
            _, (vx, vy) = self.build_pretrain_data(synthetic)
        evaluate = make_pretrain_eval(self.tuner, self.cfg, mesh=self.mesh)
        batch, rows = self._clip_val_batch(vx, vy)
        m = evaluate(batch, self._seed(), rows=rows)
        return {k: float(v) for k, v in m.items()}

    def pretrain(self, synthetic: Optional[tuple] = None) -> dict:
        """Pretrain on synthetic voxels (reference train.py:379-427) for
        ``no_pt_epochs`` epochs, resuming a ``.partial``, and write
        ``pt_model.msgpack``; returns the last epoch's metrics. A no-op
        once the weights are pretrained (given, restored, or pretrain()
        has run)."""
        cfg = self.cfg
        if self.status.value >= WeightStatus.PRE_TRAINED.value:
            return self.last_pretrain_metrics
        t0 = time.perf_counter()
        train_set, (vx, vy) = self.build_pretrain_data(synthetic)
        streaming = train_set is None
        dev = self.tuner.device
        if not streaming:
            tx_d, ty_d = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in train_set)
        val_batch, val_rows = self._clip_val_batch(vx, vy)
        data_s = time.perf_counter() - t0
        spe = (stream_steps_per_epoch(cfg) if streaming else
               max(1, len(tx_d) // cfg.train.pt_batch_size))
        named = list(self.tuner.named_parameters())
        optimizer = make_pretrain_optimizer(named, cfg.train)
        self.swa = swa_init(named) if cfg.train.use_swa else None
        state, start_epoch = self._phase_start(self.pt_path, "pretrain", spe)
        if state is not None:
            self._resume(state, optimizer)
            if cfg.train.use_swa:
                if state.swa is None:
                    raise CheckpointMismatchError(
                        f"{self._partial_path(self.pt_path)} holds no SWA "
                        "state and use_swa is set")
                # the average folds in the weights where they live
                self.swa = state.swa._replace(average={
                    k: v.to(dev) for k, v in state.swa.average.items()})
        if streaming:
            stream_epoch = make_pretrain_stream_epoch(
                self.tuner, cfg, optimizer, spe, mesh=self.mesh)
        else:
            step = make_pretrain_step(self.tuner, cfg, optimizer, self.mesh)
        evaluate = make_pretrain_eval(self.tuner, cfg, mesh=self.mesh)
        rng = np.random.default_rng(cfg.train.seed)
        metrics = {}
        for epoch in range(start_epoch, cfg.train.no_pt_epochs):
            t0 = time.perf_counter()
            if streaming:
                losses, self.swa = stream_epoch(self._seed(), swa=self.swa)
                loss = float(np.mean(losses))
            else:
                losses = []
                for idx in data_pipe.synthetic_batch_indices(
                        rng, len(tx_d), cfg.train.pt_batch_size):
                    seed, kw = self._seed(), {}
                    if self.mesh is not None:
                        idx, kw["live"] = self._rank_slots(idx)
                        seed = fold_seed(seed, self.mesh.rank)
                    i = torch.from_numpy(idx).to(dev)
                    losses.append(step({"x": tx_d[i], "y": ty_d[i]},
                                       seed=seed, **kw)["loss"])
                    if self.swa is not None:
                        self.swa = swa_update(self.swa, named,
                                              cfg.train.swa_start,
                                              cfg.train.swa_period)
                loss = float(torch.mean(torch.stack(losses)))
            m = evaluate(val_batch, self._seed(), rows=val_rows)
            metrics = {"loss": loss,
                       "epoch_time_s": time.perf_counter() - t0}
            metrics.update({k: float(v) for k, v in m.items()})
            if epoch == start_epoch:
                metrics["data_time_s"] = data_s
            # checkpoint only after the tripwire: a diverged state must
            # never reach the .partial
            self._log("pretrain", epoch, metrics)
            self.last_pretrain_metrics = dict(metrics)
            self._phase_checkpoint(self.pt_path, "pretrain", optimizer,
                                   epoch, spe)
        # SWA adoption is opt-in: the reference builds its SWA wrapper but
        # never assigns the averaged weights (train.py:382-385)
        if cfg.train.swa_adopt and self.swa is not None and self.swa.n_avg:
            with torch.no_grad():
                for name, p in named:
                    p.copy_(self.swa.average[name])
        self.status = WeightStatus.PRE_TRAINED
        self._save(self.pt_path, "pretrain", optimizer)
        self._phase_done(self.pt_path)
        return metrics

    # ---- phase 2: real-data fine-tuning -----------------------------------

    def _encode_fn(self, tuner: Optional[FineTuner] = None):
        """The encoder's plain forward pass on numpy volumes, with the
        current weights or ``tuner``'s."""
        tuner = self.tuner if tuner is None else tuner

        @torch.no_grad()
        def encode(images: np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
            return tuple(o.cpu().numpy()
                         for o in tuner.encode(x.to(tuner.device)))

        return encode

    def pretrained_encode_fn(self):
        """The encoder pass with the pretrained weights
        (``pretrained_params``), None without them; the weights are read
        once and kept in a second FineTuner, so a long-lived process
        (cli.cmd_serve) reads the checkpoint once."""
        if self._pt_tuner is None:
            params = self.pretrained_params()
            if params is None:
                return None
            cfg = self.cfg
            self._pt_tuner = FineTuner(cfg.model, cfg.scan,
                                       device=self.tuner.device,
                                       full_model=cfg.train.full_model,
                                       use_blood=cfg.train.use_blood)
            self._pt_tuner.load_state_dict(params)
        return self._encode_fn(self._pt_tuner)

    def _rank_slots(self, idx: np.ndarray) -> tuple:
        """(indices, live) of the rank's slots of a host-set batch of
        ``idx``: its _device_crop_counts rows, padded with the batch's
        first row (dead, live 0) to ceil(B / n) slots."""
        b, n = len(idx), self.mesh.world_size
        lo, hi = pmesh.crop_rows(b, n, self.mesh.rank)
        b_local = -(-b // n)
        slots = np.concatenate([idx[lo:hi], np.repeat(idx[:1],
                                                      b_local - (hi - lo))])
        live = torch.zeros(b_local, device=self.tuner.device)
        live[:hi - lo] = 1.0
        return slots, live

    def prepare_real(self, train_data: np.ndarray, *,
                     blank_crop: bool = True) -> data_pipe.RealCropSampler:
        """Blank-crop + predict priors -> RealCropSampler."""
        if blank_crop:
            train_data = data_pipe.blank_crop(train_data)
        k = 5 if self.cfg.model.use_mvg else 4
        priors = data_pipe.predict_priors(self._encode_fn(), train_data, k)
        self.sampler = data_pipe.RealCropSampler(
            train_data, priors, self.cfg.train.crop_size,
            rng=np.random.default_rng(self.cfg.train.seed))
        return self.sampler

    def _log(self, phase: str, step: int, metrics: dict) -> None:
        if self.writes:
            self.logger(phase, step, metrics)
            if self.wandb_run is not None:
                self.wandb_run.log(metrics)
        if not all(np.isfinite(v) for k, v in metrics.items()
                   if k not in self._TRIPWIRE_EXEMPT):
            raise NaNLossError(f"non-finite metrics at {phase} epoch {step}: "
                               f"{metrics}")

    def finetune(self, train_data: np.ndarray,
                 study_data: Optional[np.ndarray] = None, *,
                 epochs: Optional[int] = None) -> dict:
        """Fine-tune with the MC-ELBO on (S, X, Y, Z, T+1) volumes with a
        trailing mask channel; ``epochs`` (default: the rest of
        ``no_ft_epochs``) bounds this call, continuing the schedule, which
        ends at ``no_ft_epochs``, where ``final_model.msgpack`` is
        written. The first call predicts the priors of ``train_data`` and
        ``study_data`` with the current weights, then resumes a
        ``.partial``; a continuing call reuses its crops and priors and
        reads neither. Returns the last epoch's metrics (at once when
        fine-tuning has ended: FULL_TRAINED)."""
        cfg = self.cfg
        if self.status is WeightStatus.FULL_TRAINED:
            return self.last_finetune_metrics
        if self.status is WeightStatus.NOT_TRAINED:
            raise RuntimeError("pretrain() must run before finetune() (or "
                               "give the Trainer a state_dict)")
        spe = cfg.train.ft_steps_per_epoch
        if self._ft_samplers is None:
            sampler = self.prepare_real(train_data)
            eval_sampler = None
            if study_data is not None:
                eval_sampler = self._study_eval_sampler(study_data)
            self._ft_samplers = (sampler, eval_sampler)
        sampler, eval_sampler = self._ft_samplers
        if self.optimizer is None:
            self.optimizer = make_finetune_optimizer(self.tuner.parameters(),
                                                     cfg.train)
            state, self.epochs_done = self._phase_start(
                self.final_path, "finetune", spe)
            if state is not None:
                self._resume(state, self.optimizer)
        epoch_fn, volumes, priors = self._finetune_epoch(sampler, spe)
        stop = cfg.train.no_ft_epochs if epochs is None else min(
            self.epochs_done + epochs, cfg.train.no_ft_epochs)
        metrics = {}
        while self.epochs_done < stop:
            t0 = time.perf_counter()
            m = epoch_fn(self.generator if self.mesh is None
                         else self._seed(), volumes, priors)
            host = {k: v.cpu().numpy() for k, v in m.items()}   # one sync
            metrics = {"loss": float(np.mean(host.pop("loss"))),
                       "epoch_time_s": time.perf_counter() - t0}
            metrics.update({k: float(np.mean(v)) for k, v in host.items()})
            if eval_sampler is not None:
                metrics.update(self._elbo_eval(eval_sampler))
            # checkpoint only after the tripwire (see pretrain)
            self._log("finetune", self.epochs_done, metrics)
            self.last_finetune_metrics = dict(metrics)
            self._phase_checkpoint(self.final_path, "finetune",
                                   self.optimizer, self.epochs_done, spe)
            self.epochs_done += 1
        if self.epochs_done >= cfg.train.no_ft_epochs:
            self.status = WeightStatus.FULL_TRAINED
            self._save(self.final_path, "finetune", self.optimizer)
            self._phase_done(self.final_path)
        return metrics

    def _shard_subjects(self, sampler) -> bool:
        """ft_shard_subjects (auto|on|off) resolved for this cohort."""
        mode = normalize_mode(self.cfg.train.ft_shard_subjects,
                              ("auto", "on", "off"), "ft_shard_subjects")
        if mode != "auto":
            return mode == "on"
        nbytes = sampler.data.nbytes + sampler.priors.nbytes
        return nbytes > self.SHARD_SUBJECTS_AUTO_BYTES

    def _finetune_epoch(self, sampler, spe: int) -> tuple:
        """(epoch function, volumes, priors on the device): the on-device
        epoch; under a mesh the replicated sharded one, or the
        subject-sharded one with the rank's rows of the padded stack."""
        cfg, dev = self.cfg, self.tuner.device
        if self.mesh is None or not self._shard_subjects(sampler):
            make = (make_finetune_epoch_on_device if self.mesh is None else
                    lambda *a: make_finetune_epoch_sharded(*a, self.mesh))
            return (make(self.tuner, cfg, self.optimizer, spe),
                    torch.from_numpy(sampler.data).to(dev),
                    torch.from_numpy(sampler.priors).to(dev))
        n_subj = sampler.data.shape[0]
        s_pad = _subject_shard_counts(n_subj, self.mesh.world_size,
                                      cfg.train.ft_batch_size)[0]

        def pad(x):
            out = np.zeros((s_pad,) + x.shape[1:], np.float32)
            out[:n_subj] = x
            return out

        local = pmesh.shard_batch(self.mesh, {"v": pad(sampler.data),
                                              "p": pad(sampler.priors)})
        return (make_finetune_epoch_subject_sharded(
            self.tuner, cfg, self.optimizer, spe, self.mesh, n_subj),
            local["v"], local["p"])

    def _study_eval_sampler(self, study_data: np.ndarray
                            ) -> data_pipe.RealCropSampler:
        """Held-out study crops (76, the subjects in order) with per-voxel
        priors from the current encoder (reference train.py:26-31,
        223-238)."""
        sd = np.float32(study_data)
        priors = data_pipe.predict_priors(
            self._encode_fn(), sd, 5 if self.cfg.model.use_mvg else 4)
        return data_pipe.RealCropSampler(sd, priors, 76,
                                         rng=np.random.default_rng(0))

    def _elbo_eval(self, eval_sampler, batches: int = 4) -> dict:
        """Mean ELBO validation metrics over up to ``batches`` study
        batches (reference train.py:333)."""
        evaluate = make_finetune_eval(self.tuner, self.cfg, mesh=self.mesh)
        vals = []
        for i, vb in enumerate(eval_sampler.eval_batches(
                self.cfg.train.eval_batch_size)):
            if i >= batches:
                break
            vb, rows = self._put_eval_batch(vb)
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self.generator))
            vals.append(evaluate(vb, seed, rows=rows))
        return {k: float(torch.mean(torch.stack([v[k] for v in vals])))
                for k in (vals[0] if vals else {})}

    def finetune_val_metrics(self, study_data: Optional[np.ndarray] = None,
                             batches: int = 4) -> dict:
        """One ELBO validation pass of the current weights on held-out
        study data -- the reference sweep's ranking metric (``val_elbo``,
        train.py:325-359). Reuses the study crops that
        ``finetune(study_data=)`` built (priors from the encoder that
        fine-tuning started from); otherwise ``study_data`` must be given,
        and each call crops it anew with priors from the current encoder.
        The JAX trainer (trainer.py:764-814) keeps the crops of its first
        such call and scores them again on later calls, whatever they
        pass; the port scores the set it is given."""
        if self.status is WeightStatus.NOT_TRAINED:
            raise RuntimeError("no trained weights to evaluate")
        sampler = self._ft_samplers[1] if self._ft_samplers else None
        if sampler is None:
            if study_data is None:
                raise ValueError("no stored eval sampler: pass study_data")
            sampler = self._study_eval_sampler(study_data)
        return self._elbo_eval(sampler, batches)

    # ---- population statistics --------------------------------------------

    @torch.no_grad()
    def estimate_population_param_distribution(self, data: np.ndarray
                                               ) -> dict:
        """Masked population mean and std of the predicted logit means of
        OEF and DBV over (S, X, Y, Z, T+1) volumes with a trailing mask, for
        prior initialisation (reference model.py:756-770): ``mean_oef``,
        ``log_std_oef``, ``mean_dbv``, ``log_std_dbv``, the stds through
        ``LogitMVN.inv_transform_std``."""
        dev = self.tuner.device
        mask_np = data[..., -1:]
        x = torch.from_numpy(np.ascontiguousarray(
            data[..., :-1] * mask_np, np.float32)).to(dev)
        q = self.tuner.encode(x)[0]
        mask = torch.from_numpy(np.ascontiguousarray(
            mask_np, np.float32)).to(dev)
        n = torch.sum(mask)
        out = {}
        for name, idx in (("oef", 0), ("dbv", 2)):
            ch = q[..., idx:idx + 1] * mask
            mean = torch.sum(ch) / n
            std = torch.sqrt(torch.sum(torch.square(ch - mean) * mask) / n)
            out[f"mean_{name}"] = float(mean)
            out[f"log_std_{name}"] = float(
                self.tuner.dist.inv_transform_std(torch.log(std)))
        return out
