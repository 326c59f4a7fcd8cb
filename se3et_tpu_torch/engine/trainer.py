r"""Optimizer of the training engine (port of the ``OptimConfig`` /
``make_optimizer`` part of :mod:`se3et_tpu.engine.trainer`).

AdamW with decoupled weight decay (``torch.optim.AdamW``, betas (0.9,
0.999), eps 1e-8 -- the update of ``optax.adamw``), a stepped exponential
learning rate ``lr * lr_decay ** (epoch // lr_decay_steps)`` applied per
step, and optional global-norm clipping with optax's formula.  Gradient
accumulation and the epoch-based ``Trainer`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Field-for-field the JAX ``OptimConfig``."""

    lr: float = 1e-4
    lr_decay: float = 0.95
    lr_decay_steps: int = 1  # epochs between decays
    weight_decay: float = 1e-6
    max_epoch: int = 40
    grad_acc_steps: int = 1
    max_grad_norm: Optional[float] = None


def global_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every parameter's gradient (float32)."""
    sq = [p.grad.float().pow(2).sum() for p in params if p.grad is not None]
    return torch.sqrt(torch.stack(sq).sum())


class Optimizer:
    """AdamW + the stepped schedule (``LambdaLR``) + optional clipping.
    :meth:`step` applies one update from the parameters' ``.grad``."""

    def __init__(self, params, cfg: OptimConfig, steps_per_epoch: int):
        if cfg.grad_acc_steps != 1:
            raise NotImplementedError("not ported: gradient accumulation")
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.optimizer = torch.optim.AdamW(self.params, lr=cfg.lr, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=cfg.weight_decay)
        per_epoch = max(steps_per_epoch, 1)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer,
            lambda step: cfg.lr_decay ** ((step // per_epoch) // cfg.lr_decay_steps))

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> None:
        """Clip (``g * max_norm / norm`` where the norm exceeds ``max_norm``),
        update the parameters and advance the schedule by one step."""
        if self.cfg.max_grad_norm is not None:
            norm = global_norm(self.params) if grad_norm is None else grad_norm
            if norm >= self.cfg.max_grad_norm:
                for p in self.params:
                    p.grad.mul_(self.cfg.max_grad_norm / norm)
        self.optimizer.step()
        self.scheduler.step()


def make_optimizer(params, cfg: OptimConfig, steps_per_epoch: int) -> Optimizer:
    """The port's counterpart of the JAX ``make_optimizer``."""
    return Optimizer(params, cfg, steps_per_epoch)
