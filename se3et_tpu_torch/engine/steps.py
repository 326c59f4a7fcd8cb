r"""The single-pair training step and the serving forward (ports of
``make_train_step`` and ``make_forward`` in :mod:`se3et_tpu.engine.steps`).

One step runs the model's training forward (``train=True``,
``with_registration=False``), :func:`~se3et_tpu_torch.nn.loss.overall_loss`,
the backward through the port's kernels, and one optimizer update.  When
the global gradient norm is not finite the update is skipped: parameters,
optimizer state and schedule stay as they were, as the JAX step keeps them
with ``where(isfinite(norm), new, old)``.
"""

from __future__ import annotations

import torch

from se3et_tpu_torch.engine.trainer import Optimizer, global_norm
from se3et_tpu_torch.nn import loss as loss_lib


def make_train_step(model, loss_cfg: loss_lib.LossConfig, optimizer: Optimizer,
                    loss_scale: float = 1.0):
    """``train_step(data, generator=None, target_noise=None) -> losses``.

    ``data`` is the model's tensor pyramid; ``generator`` / ``target_noise``
    feed the Gumbel target sampling (see ``SE3ETModel.forward``).  Returns
    the float losses ``c_loss``, ``f_loss``, ``loss`` and ``grad_norm`` as
    0-d tensors.  ``loss_scale`` multiplies the loss before the backward and
    divides the gradients after (1.0: no-op)."""
    params = optimizer.params

    def train_step(data, generator=None, target_noise=None):
        for p in params:
            p.grad = None
        out = model(data, train=True, with_registration=False, generator=generator,
                    target_noise=target_noise)
        total, losses = loss_lib.overall_loss(out, data, loss_cfg)
        (total * loss_scale).backward()
        for p in params:
            if p.grad is None:  # unused by this forward: a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
            elif loss_scale != 1.0:
                p.grad.div_(loss_scale)
        gnorm = global_norm(params)
        if bool(torch.isfinite(gnorm)):
            optimizer.step(gnorm)
        losses = {k: v.detach() for k, v in losses.items()}
        losses["grad_norm"] = gnorm.detach()
        return losses

    return train_step


def make_forward(model, eval_cfg=None):
    """``forward(data) -> out``: the model's serving forward with the
    registration (``train=False, with_registration=True``), the function the
    JAX package jits and :func:`se3et_tpu_torch.engine.serving.capture_forward`
    captures.  The in-graph evaluation metrics (JAX ``nn/loss.py``
    ``evaluate``, added under ``out["metrics"]`` when ``eval_cfg`` is given)
    are not ported: a non-None ``eval_cfg`` raises."""
    if eval_cfg is not None:
        raise NotImplementedError("make_forward: eval_cfg needs loss.evaluate, which is not "
                                  "ported")

    def forward(data):
        return model(data, train=False, with_registration=True)

    return forward
