"""Fine-tune optimiser: tfa-style AdamW with linearly decayed learning rate
and decoupled weight decay (PyTorch).

The counterpart of ``qbold_vi_tpu/train/optim.py:40-95,123-132``
(reference train.py:287-312): Adam (eps 1e-7, b2 0.9 for fine-tuning)
scaled by the scheduled learning rate, then ``- wd(step) * param`` --
decoupled decay NOT multiplied by the learning rate, which is why
``torch.optim.AdamW`` (decay ``lr * wd``) does not fit. Each step is, per
parameter, the optax chain scale_by_adam -> scale_by_schedule(-lr) ->
add_scheduled_weight_decay in the same float32 order. A parameter whose
gradient is None steps as with a zero gradient, as JAX's zero cotangent
does (its decay still applies). SWA and the pretraining optimiser are not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..config import TrainConfig

__all__ = ["linear_decay_schedule", "ScheduledAdamW",
           "make_finetune_optimizer"]


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
    weight decay (``wd_schedule`` None: plain Adam)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr_schedule: Callable, wd_schedule: Optional[Callable] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7):
        self.params = list(params)
        self.lr_schedule, self.wd_schedule = lr_schedule, wd_schedule
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
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            update = (mu / float(c1)) / (torch.sqrt(nu / float(c2))
                                         + self.eps)
            update = update * neg_lr
            if wd is not None:
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
