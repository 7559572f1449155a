"""Two-phase training orchestrator (PyTorch).

The counterpart of ``qbold_vi_tpu/train/trainer.py`` (reference
train.py:17-72, 188-427):

* ``pretrain``: the fixed synthetic set of the JAX trainer's host-set mode
  (the same numpy draws from the same seed fold, synth.py), split into
  pseudo-volumes, uploaded once; each epoch takes its shuffled batches in
  the JAX trainer's order (``np.random.default_rng(seed)``), then the
  held-out validation; SWA when configured, adopted under ``swa_adopt``;
* ``prepare_real``: blank crop, per-voxel priors from the encoder's plain
  forward pass, and a ``RealCropSampler``;
* ``finetune``: the volumes and priors go to the device once; each epoch
  runs ``ft_steps_per_epoch`` steps on crops drawn there
  (steps.make_finetune_epoch_on_device), reads its metrics back once,
  logs them and trips on a non-finite one; with study data, the ELBO
  validation runs after every epoch.

``WeightStatus`` follows the JAX trainer: a Trainer given ``state_dict``
starts PRE_TRAINED (pretrain() returns at once); one without it starts
NOT_TRAINED from ``init_params(seed)``, and finetune() raises until
pretrain() has run. The tuner lives on the CUDA card unless ``device="cpu"``
is given. Not ported yet, and raising ``NotImplementedError``: the
streaming pretrain (``pt_on_device_synth``), checkpoint files (resuming
from those of ``save_directory``, ``checkpoint_every_epochs``), and mesh /
subject sharding (ROADMAP.md). No checkpoint file is written: the caller
keeps ``tuner.state_dict()``.
"""

from __future__ import annotations

import enum
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import QBoldConfig
from ..models.vi import FineTuner, init_params
from ..synth import create_synthetic_dataset_host, pretrain_data_seed
from . import data as data_pipe
from .optim import (make_finetune_optimizer, make_pretrain_optimizer,
                    swa_init, swa_update)
from .steps import (make_finetune_epoch_on_device, make_finetune_eval,
                    make_pretrain_eval, make_pretrain_step)

__all__ = ["Trainer", "NaNLossError", "WeightStatus", "val_batch_count"]

_SEED_HI = 2 ** 62


class NaNLossError(RuntimeError):
    """A logged training metric was not finite."""


class WeightStatus(enum.Enum):
    """Training progress (reference qbold_build_model.py:11-14)."""
    NOT_TRAINED = 0
    PRE_TRAINED = 1
    FULL_TRAINED = 2


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
    weights (``init_params`` or a JAX checkpoint, io/from_jax.py)."""

    # the learned inverse-gamma hyperprior is logged as exp(raw), which may
    # overflow without the run diverging; the tripwire skips it, as the
    # JAX trainer does
    _TRIPWIRE_EXEMPT = frozenset(
        {"oef_alpha", "oef_beta", "dbv_alpha", "dbv_beta"})

    def __init__(self, cfg: QBoldConfig, *, state_dict: Optional[dict] = None,
                 device=None, mesh=None,
                 logger: Callable[[str, int, dict], None] = _stdout_logger):
        if mesh is not None:
            raise NotImplementedError(
                "mesh / subject-sharded training is not ported yet "
                "(ROADMAP.md)")
        if cfg.train.checkpoint_every_epochs > 0:
            raise NotImplementedError(
                "mid-phase checkpoints (checkpoint_every_epochs > 0) are not "
                "ported yet (ROADMAP.md)")
        found = [name for name in ("final_model.msgpack", "pt_model.msgpack")
                 if os.path.isfile(os.path.join(cfg.train.save_directory,
                                                name))]
        if found:
            raise NotImplementedError(
                f"resuming from {found[0]} in {cfg.train.save_directory!r} is "
                "not ported yet (ROADMAP.md); pass the weights as state_dict "
                "(io/from_jax.py) and another save_directory")
        self.cfg = cfg
        self.tuner = FineTuner(cfg.model, cfg.scan, device=device,
                               full_model=cfg.train.full_model,
                               use_blood=cfg.train.use_blood)
        self.status = (WeightStatus.NOT_TRAINED if state_dict is None
                       else WeightStatus.PRE_TRAINED)
        if state_dict is None:
            state_dict = init_params(cfg.model, cfg.scan,
                                     torch.Generator().manual_seed(
                                         cfg.train.seed))
        self.tuner.load_state_dict(state_dict)
        self.generator = torch.Generator().manual_seed(cfg.train.seed)
        self.logger = logger
        self.optimizer = None
        self.epochs_done = 0
        self.sampler = None
        self.swa = None
        self.last_pretrain_metrics: dict = {}
        self.last_finetune_metrics: dict = {}

    # ---- phase 1: synthetic pretraining -----------------------------------

    def build_pretrain_data(self, synthetic: Optional[tuple] = None):
        """((train_x, train_y), (val_x, val_y)) pseudo-volumes of the fixed
        synthetic set -- generated from the config (the JAX trainer's
        numbers: synth.pretrain_data_seed) unless ``synthetic`` (x, y) is
        given -- split 90/10."""
        cfg = self.cfg
        if cfg.train.pt_on_device_synth and synthetic is None:
            raise NotImplementedError(
                "the streaming pretrain (pt_on_device_synth=True) is not "
                "ported yet (ROADMAP.md); the host-set pretrain runs with "
                "pt_on_device_synth=False")
        if synthetic is None:
            x, y = create_synthetic_dataset_host(
                pretrain_data_seed(cfg.train.seed), cfg.scan, cfg.synth,
                full_model=cfg.train.full_model,
                use_blood=cfg.train.use_blood,
                quad_rule=cfg.model.quad_rule, device=self.tuner.device)
        else:
            x, y = synthetic
        return data_pipe.split_synthetic(x, y)

    def _clip_val_batch(self, vx: np.ndarray, vy: np.ndarray) -> dict:
        """The validation batch: at most ~4k voxels, on the device."""
        n_val = val_batch_count(len(vx), int(np.prod(vx.shape[1:4])))
        dev = self.tuner.device
        return {"x": torch.from_numpy(np.ascontiguousarray(vx[:n_val])).to(dev),
                "y": torch.from_numpy(np.ascontiguousarray(vy[:n_val])).to(dev)}

    def _seed(self) -> int:
        return int(torch.randint(0, _SEED_HI, (1,), generator=self.generator))

    def pretrain_val_metrics(self, synthetic: Optional[tuple] = None) -> dict:
        """The held-out synthetic validation metrics of the current weights,
        on the set and batch pretrain() evaluates each epoch."""
        _, (vx, vy) = self.build_pretrain_data(synthetic)
        evaluate = make_pretrain_eval(self.tuner, self.cfg)
        m = evaluate(self._clip_val_batch(vx, vy), self._seed())
        return {k: float(v) for k, v in m.items()}

    def pretrain(self, synthetic: Optional[tuple] = None) -> dict:
        """Pretrain on synthetic voxels (reference train.py:379-427) for
        ``no_pt_epochs`` epochs; returns the last epoch's metrics. A no-op
        once the weights are pretrained (given, or pretrain() has run)."""
        cfg = self.cfg
        if self.status.value >= WeightStatus.PRE_TRAINED.value:
            return self.last_pretrain_metrics
        t0 = time.perf_counter()
        (tx, ty), (vx, vy) = self.build_pretrain_data(synthetic)
        dev = self.tuner.device
        tx_d = torch.from_numpy(np.ascontiguousarray(tx)).to(dev)
        ty_d = torch.from_numpy(np.ascontiguousarray(ty)).to(dev)
        val_batch = self._clip_val_batch(vx, vy)
        data_s = time.perf_counter() - t0
        named = list(self.tuner.named_parameters())
        optimizer = make_pretrain_optimizer(named, cfg.train)
        self.swa = swa_init(named) if cfg.train.use_swa else None
        step = make_pretrain_step(self.tuner, cfg, optimizer)
        evaluate = make_pretrain_eval(self.tuner, cfg)
        rng = np.random.default_rng(cfg.train.seed)
        metrics = {}
        for epoch in range(cfg.train.no_pt_epochs):
            t0 = time.perf_counter()
            losses = []
            for idx in data_pipe.synthetic_batch_indices(
                    rng, len(tx), cfg.train.pt_batch_size):
                i = torch.from_numpy(idx).to(dev)
                losses.append(step({"x": tx_d[i], "y": ty_d[i]},
                                   seed=self._seed())["loss"])
                if self.swa is not None:
                    self.swa = swa_update(self.swa, named,
                                          cfg.train.swa_start,
                                          cfg.train.swa_period)
            m = evaluate(val_batch, self._seed())
            metrics = {"loss": float(torch.mean(torch.stack(losses))),
                       "epoch_time_s": time.perf_counter() - t0}
            metrics.update({k: float(v) for k, v in m.items()})
            if epoch == 0:
                metrics["data_time_s"] = data_s
            self._log("pretrain", epoch, metrics)
            self.last_pretrain_metrics = dict(metrics)
        # SWA adoption is opt-in: the reference builds its SWA wrapper but
        # never assigns the averaged weights (train.py:382-385)
        if cfg.train.swa_adopt and self.swa is not None and self.swa.n_avg:
            with torch.no_grad():
                for name, p in named:
                    p.copy_(self.swa.average[name])
        self.status = WeightStatus.PRE_TRAINED
        return metrics

    # ---- phase 2: real-data fine-tuning -----------------------------------

    def _encode_fn(self):
        """The encoder's plain forward pass on numpy volumes."""
        tuner = self.tuner

        @torch.no_grad()
        def encode(images: np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
            return tuple(o.cpu().numpy()
                         for o in tuner.encode(x.to(tuner.device)))

        return encode

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
        self.logger(phase, step, metrics)
        if not all(np.isfinite(v) for k, v in metrics.items()
                   if k not in self._TRIPWIRE_EXEMPT):
            raise NaNLossError(f"non-finite metrics at {phase} epoch {step}: "
                               f"{metrics}")

    def finetune(self, train_data: np.ndarray,
                 study_data: Optional[np.ndarray] = None, *,
                 epochs: Optional[int] = None) -> dict:
        """Fine-tune with the MC-ELBO on (S, X, Y, Z, T+1) volumes with a
        trailing mask channel; ``epochs`` (default: the rest of
        ``no_ft_epochs``) bounds this call, continuing the schedule.
        Returns the last epoch's metrics."""
        cfg = self.cfg
        if self.status is WeightStatus.NOT_TRAINED:
            raise RuntimeError("pretrain() must run before finetune() (or "
                               "give the Trainer a state_dict)")
        dev = self.tuner.device
        sampler = self.prepare_real(train_data)
        eval_sampler = None
        if study_data is not None:
            sd = np.float32(study_data)
            priors = data_pipe.predict_priors(
                self._encode_fn(), sd, 5 if cfg.model.use_mvg else 4)
            eval_sampler = data_pipe.RealCropSampler(
                sd, priors, 76, rng=np.random.default_rng(0))
        if self.optimizer is None:
            self.optimizer = make_finetune_optimizer(self.tuner.parameters(),
                                                     cfg.train)
        epoch_fn = make_finetune_epoch_on_device(
            self.tuner, cfg, self.optimizer, cfg.train.ft_steps_per_epoch)
        volumes = torch.from_numpy(sampler.data).to(dev)
        priors = torch.from_numpy(sampler.priors).to(dev)
        stop = cfg.train.no_ft_epochs if epochs is None else (
            self.epochs_done + epochs)
        metrics = {}
        while self.epochs_done < stop:
            t0 = time.perf_counter()
            m = epoch_fn(self.generator, volumes, priors)
            host = {k: v.cpu().numpy() for k, v in m.items()}   # one sync
            metrics = {"loss": float(np.mean(host.pop("loss"))),
                       "epoch_time_s": time.perf_counter() - t0}
            metrics.update({k: float(np.mean(v)) for k, v in host.items()})
            if eval_sampler is not None:
                metrics.update(self._elbo_eval(eval_sampler))
            self._log("finetune", self.epochs_done, metrics)
            self.last_finetune_metrics = dict(metrics)
            self.epochs_done += 1
        if self.epochs_done >= cfg.train.no_ft_epochs:
            self.status = WeightStatus.FULL_TRAINED
        return metrics

    def _elbo_eval(self, eval_sampler, batches: int = 4) -> dict:
        """Mean ELBO validation metrics over up to ``batches`` study
        batches (reference train.py:333)."""
        evaluate = make_finetune_eval(self.tuner, self.cfg)
        dev = self.tuner.device
        vals = []
        for i, vb in enumerate(eval_sampler.eval_batches(
                self.cfg.train.eval_batch_size)):
            if i >= batches:
                break
            vb = {k: torch.from_numpy(v).to(dev) for k, v in vb.items()}
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self.generator))
            vals.append(evaluate(vb, seed))
        return {k: float(torch.mean(torch.stack([v[k] for v in vals])))
                for k in (vals[0] if vals else {})}
