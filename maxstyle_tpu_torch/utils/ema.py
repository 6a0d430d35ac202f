"""Exponential moving average of parameters + LR schedules.

Counterpart of ``maxstyle_tpu/utils/ema.py`` (model_util.ExponentialMovingAverage
:86-165 and model_util.get_scheduler:677-722 of the reference).

* :func:`ema_init` / :func:`ema_update` work on {name: tensor} mappings of the
  port's parameter tensors (``dict(module.named_parameters())``); the
  warm-up decay is computed on the host in float32, as the JAX package
  computes it, so an update adds no host sync.
* :func:`make_lr_schedule` returns ``schedule(count) -> lr``, the learning
  rate of the update made after ``count`` updates, as optax counts them; it
  is computed on the host in float32 with optax's operations, so its
  values are optax's bit for bit. :class:`ScheduleLR` applies one to a torch
  optimizer, stepped after each ``optimizer.step()``.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]


def ema_init(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A detached copy of every tensor."""
    return {k: v.detach().clone() for k, v in params.items()}


def ema_decay(decay: float, num_updates: Optional[int] = None) -> float:
    """The decay of one update: ``decay``, or with ``num_updates`` (the
    1-based count including this update) the reference's warm-up
    min(decay, (1+n)/(10+n)), in float32."""
    if num_updates is None:
        return decay
    n = np.float32(num_updates)
    return float(np.minimum(np.float32(decay), (np.float32(1.0) + n) / (np.float32(10.0) + n)))


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float = 0.999, num_updates: Optional[int] = None
               ) -> Dict[str, torch.Tensor]:
    """One EMA step: decay * ema + (1 - decay) * param, for every name."""
    d = ema_decay(decay, num_updates)
    keep = float(np.float32(1.0) - np.float32(d)) if num_updates is not None else 1.0 - d
    return {k: d * e + keep * params[k].detach() for k, e in ema_params.items()}


def make_lr_schedule(policy: str, base_lr: float, *, lr_decay_epochs: int = 5,
                     gamma: Optional[float] = None, steps_per_epoch: int = 1,
                     total_epochs: int = 100) -> Schedule:
    """LR schedule menu (model_util.get_scheduler:677-722): 'step' (StepLR
    gamma=0.5, the policy the triplet solver attaches to SGD,
    advanced_triplet…:1070-1077), 'step2' (gamma=0.1), 'lambda' (linear
    decay to 0), 'step_warmstart'/'step_warmstart2', 'constant'."""
    lr = np.float32(base_lr)
    if policy == "constant":
        return lambda count: float(lr)
    if policy in ("step", "step2"):
        g = np.float32(gamma if gamma is not None else (0.5 if policy == "step" else 0.1))
        boundaries = [e * steps_per_epoch
                      for e in range(lr_decay_epochs, total_epochs, lr_decay_epochs)]

        def step_schedule(count: int) -> float:
            v = lr
            for threshold in boundaries:
                if count >= threshold:
                    v = np.float32(g * v)
            return float(v)

        return step_schedule
    if policy == "lambda":
        transition = total_epochs * steps_per_epoch

        def linear(count: int) -> float:
            c = np.float32(min(max(count, 0), transition))
            frac = np.float32(1.0) - c / np.float32(transition)
            return float(lr * frac + np.float32(0.0))

        return linear
    if policy in ("step_warmstart", "step_warmstart2"):
        hi = 100 if policy == "step_warmstart" else 50
        lo2 = 200 if policy == "step_warmstart" else 100

        def warmstart(count: int) -> float:
            epoch = count // steps_per_epoch
            scale = 0.1 if epoch < 5 else 1.0 if epoch < hi else 0.1 if epoch < lo2 else 0.01
            return float(lr * np.float32(scale))

        return warmstart
    raise NotImplementedError(policy)


class ScheduleLR(torch.optim.lr_scheduler.LRScheduler):
    """Sets every param group's lr to ``schedule(n)``, where n is the number
    of updates made so far (``last_epoch``): stepped after each
    ``optimizer.step()``, update n uses ``schedule(n)``, as optax's
    ``scale_by_schedule`` does. :meth:`seek` moves it to a restored step."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Schedule):
        self.schedule = schedule
        super().__init__(optimizer)

    def get_lr(self):
        return [self.schedule(self.last_epoch) for _ in self.optimizer.param_groups]

    def seek(self, step: int) -> None:
        self.last_epoch = int(step)
        for group, lr in zip(self.optimizer.param_groups, self.get_lr()):
            group["lr"] = lr
        self._last_lr = [g["lr"] for g in self.optimizer.param_groups]
