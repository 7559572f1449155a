"""Optimisers: tfa-style AdamW with scheduled decoupled weight decay,
linear learning-rate decay, and stochastic weight averaging (PyTorch).

The counterpart of ``qbold_vi_tpu/train/optim.py`` (reference
train.py:287-312, 382-385): Adam (eps 1e-7) scaled by the scheduled
learning rate, then ``- wd(step) * param`` -- decoupled decay NOT
multiplied by the learning rate, which is why ``torch.optim.AdamW`` (decay
``lr * wd``) does not fit. Each step is, per parameter, the optax chain
scale_by_adam -> scale_by_schedule(-lr) -> add_scheduled_weight_decay in
the same float32 order. A parameter whose gradient is None steps as with a
zero gradient, as JAX's zero cotangent does (its decay still applies):
the pretraining loss reads stream 1 only, yet the stream-2 convs decay as
they do in the JAX package.

* fine-tuning: linear decay of lr and decay, b2 0.9;
* pretraining: plain Adam, or with SWA an AdamW at a constant lr and
  decay, masked to the encoder (pop_prior and log_sigma, which the
  reference's phase-1 model does not hold, must not shrink);
* SWA: a running average of the parameters every ``period`` steps from
  ``start`` (tfa.optimizers.SWA), adopted only under ``swa_adopt``.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import TrainConfig

__all__ = ["linear_decay_schedule", "ScheduledAdamW",
           "make_finetune_optimizer", "make_pretrain_optimizer", "SWAState",
           "swa_init", "swa_update"]


def linear_decay_schedule(init_value: float, total_steps: int,
                          final_div: float = 100.0) -> Callable:
    """value(step) = init + (init/final_div - init) * step / total_steps in
    float32, unclamped past total_steps (reference train.py:300-302)."""
    def schedule(step: int) -> np.float32:
        frac = np.float32(step) / np.float32(total_steps)
        final = init_value / final_div
        return np.float32(init_value) + np.float32(final - init_value) * frac
    return schedule


class ScheduledAdamW:
    """Adam with an lr schedule and an independently scheduled decoupled
    weight decay (``wd_schedule`` None: plain Adam); ``decay_mask``, one
    bool per parameter, limits the decay to the True ones."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr_schedule: Callable, wd_schedule: Optional[Callable] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7,
                 decay_mask: Optional[Sequence[bool]] = None):
        self.params = list(params)
        self.lr_schedule, self.wd_schedule = lr_schedule, wd_schedule
        self.decay_mask = ([True] * len(self.params) if decay_mask is None
                           else list(decay_mask))
        if len(self.decay_mask) != len(self.params):
            raise ValueError("decay_mask needs one entry per parameter")
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        t = self.count + 1
        c1 = 1.0 - np.float32(self.b1) ** np.float32(t)
        c2 = 1.0 - np.float32(self.b2) ** np.float32(t)
        neg_lr = -float(self.lr_schedule(self.count))
        wd = (None if self.wd_schedule is None
              else float(self.wd_schedule(self.count)))
        for p, mu, nu, decay in zip(self.params, self.mu, self.nu,
                                    self.decay_mask):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            update = (mu / float(c1)) / (torch.sqrt(nu / float(c2))
                                         + self.eps)
            update = update * neg_lr
            if wd is not None and decay:
                update = update - wd * p
            p.add_(update)
        self.count = t


def make_finetune_optimizer(params: Iterable[torch.nn.Parameter],
                            cfg: TrainConfig) -> ScheduledAdamW:
    """AdamW with linearly decayed lr and decay, b2 = 0.9 (reference
    train.py:308-312); plain Adam on the lr schedule when adamw_decay is 0."""
    total = cfg.no_ft_epochs * cfg.ft_steps_per_epoch
    lr = linear_decay_schedule(cfg.ft_lr, total)
    if cfg.adamw_decay > 0.0:
        return ScheduledAdamW(params, lr,
                              linear_decay_schedule(cfg.adamw_decay, total),
                              b2=0.9)
    return ScheduledAdamW(params, lr)


def make_pretrain_optimizer(named_params: Iterable, cfg: TrainConfig
                            ) -> ScheduledAdamW:
    """The pretraining optimiser of ``tuner.named_parameters()`` (reference
    train.py:382-385): with SWA, AdamW at the constant pt_lr and
    pt_adamw_decay, the decay on the encoder's parameters only; else plain
    Adam at pt_lr."""
    names, params = zip(*named_params)
    lr = np.float32(cfg.pt_lr)
    if cfg.use_swa:
        wd = np.float32(cfg.pt_adamw_decay)
        return ScheduledAdamW(params, lambda step: lr, lambda step: wd,
                              decay_mask=[n.startswith("encoder.")
                                          for n in names])
    return ScheduledAdamW(params, lambda step: lr)


class SWAState(NamedTuple):
    """Running parameter average (tfa.optimizers.SWA semantics)."""
    step: int               # optimiser steps taken
    n_avg: int              # snapshots averaged so far
    average: dict           # name -> tensor, like the parameters


def swa_init(named_params: Iterable) -> SWAState:
    return SWAState(0, 0, {k: p.detach().clone() for k, p in named_params})


def swa_update(state: SWAState, named_params: Iterable, start: int,
               period: int) -> SWAState:
    """Fold the parameters into the average when the step just taken is
    ``start`` + a multiple of ``period`` (reference train.py:385), as
    (avg * n + p) / (n + 1) in float32."""
    step = state.step + 1
    if not (step >= start and (step - start) % period == 0):
        return SWAState(step, state.n_avg, state.average)
    n = float(state.n_avg)
    with torch.no_grad():
        average = {k: (state.average[k] * n + p)
                   / p.new_tensor(n + 1.0) for k, p in named_params}
    return SWAState(step, state.n_avg + 1, average)
