"""Fine-tuning orchestrator (PyTorch).

The counterpart of ``qbold_vi_tpu/train/trainer.py::Trainer.prepare_real``
and ``finetune`` (:609-751; reference train.py:17-72, 285-376), starting
from given weights (``init_params`` or a JAX checkpoint through
``io/from_jax.py``):

* ``prepare_real``: blank crop, per-voxel priors from the encoder's plain
  forward pass, and a ``RealCropSampler``;
* ``finetune``: the volumes and priors go to the device once; each epoch
  runs ``ft_steps_per_epoch`` steps on crops drawn there
  (steps.make_finetune_epoch_on_device), reads its metrics back once,
  logs them and trips on a non-finite one; with study data, the ELBO
  validation runs after every epoch.

The tuner lives on the CUDA card unless ``device="cpu"`` is given. Not
ported yet, and raising ``NotImplementedError``: pretraining, resuming
from the checkpoint files of ``save_directory``, mid-phase checkpoints
(``checkpoint_every_epochs``), and mesh / subject sharding (ROADMAP.md).
No checkpoint file is written: the caller keeps ``tuner.state_dict()``.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import QBoldConfig
from ..models.vi import FineTuner, init_params
from . import data as data_pipe
from .optim import make_finetune_optimizer
from .steps import make_finetune_epoch_on_device, make_finetune_eval

__all__ = ["Trainer", "NaNLossError"]


class NaNLossError(RuntimeError):
    """A logged fine-tune metric was not finite."""


def _stdout_logger(phase: str, step: int, metrics: dict) -> None:
    body = " ".join(f"{k}={v:.5g}" for k, v in metrics.items())
    print(f"[{phase}] epoch {step}: {body}", flush=True)


class Trainer:
    """Fine-tuning from given weights.

        t = Trainer(cfg, state_dict=params)     # on the card
        t.finetune(train_data)                  # MC-ELBO on real volumes
    """

    def __init__(self, cfg: QBoldConfig, *, state_dict: Optional[dict] = None,
                 device=None, mesh=None,
                 logger: Callable[[str, int, dict], None] = _stdout_logger):
        if mesh is not None:
            raise NotImplementedError(
                "mesh / subject-sharded training is not ported yet "
                "(ROADMAP.md)")
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
        self.last_finetune_metrics: dict = {}

    def pretrain(self, *args, **kwargs):
        raise NotImplementedError(
            "synthetic pretraining is not ported yet (ROADMAP.md); start "
            "from init_params or a JAX checkpoint (io/from_jax.py)")

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
        if not all(np.isfinite(v) for v in metrics.values()):
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
        if cfg.train.checkpoint_every_epochs > 0:
            raise NotImplementedError(
                "mid-phase checkpoints (checkpoint_every_epochs > 0) are not "
                "ported yet (ROADMAP.md)")
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
