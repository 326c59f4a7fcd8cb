r"""Training engine of the PyTorch port: the optimizer, the epoch loop,
snapshots and resume (port of :mod:`se3et_tpu.engine.trainer`).

* :class:`Optimizer`: AdamW with decoupled weight decay
  (``torch.optim.AdamW``, betas (0.9, 0.999), eps 1e-8 -- the update of
  ``optax.adamw``), a stepped exponential learning rate ``lr * lr_decay **
  (epoch // lr_decay_steps)`` applied per update, optional global-norm
  clipping with optax's formula, and gradient accumulation with
  ``optax.MultiSteps`` semantics: the gradients of ``grad_acc_steps``
  micro-steps are averaged (a running mean, as optax keeps it), one update
  is applied every ``grad_acc_steps``-th micro-step, clipping acts on the
  averaged gradient, and the schedule counts updates, not micro-steps (so
  the schedule's epoch advances every ``steps_per_epoch`` updates, as in
  the JAX package).
* :class:`Trainer`: the JAX ``Trainer``'s constructor fields and methods
  (``initialize``, ``train_epoch`` and its pair-batched variant,
  ``validate``, ``run_iterations``, ``run``, ``save_snapshot`` /
  ``load_snapshot``) on the card unless the caller asks for the CPU.  Each
  epoch's Gumbel target noise comes from one ``torch.Generator`` on the
  model's device seeded ``seed + 1000 + epoch`` (JAX: ``PRNGKey(seed + 1000
  + epoch)`` split per step), so an epoch draws the same targets after a
  resume.  Snapshots are the port's own: ``torch.save`` of the model's
  ``state_dict``, the optimizer (AdamW, schedule, accumulator), ``epoch``
  and ``iteration`` at ``<output_dir>/snapshots/<name>/snapshot.pt``.
  ``load_snapshot`` restores the weights and counters and, by default, not
  the optimizer: a resumed run starts a fresh optimizer whose schedule
  counts from 0, as the JAX package does on purpose.  The data-parallel
  epoch (``data_parallel=True``) is not ported (ROADMAP §A8).
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from se3et_tpu_torch.nn import loss as loss_lib
from se3et_tpu_torch.nn.model import ModelConfig, SE3ETModel, pyramid_to_tensors
from se3et_tpu_torch.utils.metrics_writer import MetricsWriter
from se3et_tpu_torch.utils.summary import SummaryBoard, Timer, get_logger

SNAPSHOT_FILE = "snapshot.pt"


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
    """AdamW + the stepped schedule (``LambdaLR``) + optional clipping +
    gradient accumulation.  :meth:`step` takes one micro-step from the
    parameters' ``.grad``."""

    def __init__(self, params, cfg: OptimConfig, steps_per_epoch: int):
        if cfg.grad_acc_steps < 1:
            raise ValueError(f"grad_acc_steps must be >= 1, got {cfg.grad_acc_steps}")
        self.params = [p for p in params if p.requires_grad]
        self.cfg = cfg
        self.optimizer = torch.optim.AdamW(self.params, lr=cfg.lr, betas=(0.9, 0.999),
                                           eps=1e-8, weight_decay=cfg.weight_decay)
        per_epoch = max(steps_per_epoch, 1)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer,
            lambda step: cfg.lr_decay ** ((step // per_epoch) // cfg.lr_decay_steps))
        # optax.MultiSteps' state: micro-steps taken since the last update,
        # and the running mean of their gradients
        self.mini_step = 0
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if cfg.grad_acc_steps > 1 else None)

    def step(self, grad_norm: Optional[torch.Tensor] = None) -> bool:
        """One micro-step; returns whether it updated the parameters.

        With accumulation, the gradients join the running mean ``acc + (g -
        acc) / (n + 1)`` and every ``grad_acc_steps``-th micro-step applies
        the update from the mean, then zeroes it.  The update clips (``g *
        max_norm / norm`` where the norm reaches ``max_norm``; ``grad_norm``
        is the norm of the gradients without accumulation), steps AdamW and
        advances the schedule by one."""
        k = self.cfg.grad_acc_steps
        if k > 1:
            n = self.mini_step
            for a, p in zip(self.acc, self.params):
                a.add_((p.grad - a) / (n + 1))
            if n + 1 < k:
                self.mini_step = n + 1
                return False
            for a, p in zip(self.acc, self.params):
                p.grad = a.clone()
                a.zero_()
            self.mini_step = 0
            grad_norm = None
        if self.cfg.max_grad_norm is not None:
            norm = global_norm(self.params) if grad_norm is None else grad_norm
            if norm >= self.cfg.max_grad_norm:
                for p in self.params:
                    p.grad.mul_(self.cfg.max_grad_norm / norm)
        self.optimizer.step()
        self.scheduler.step()
        return True

    def state_dict(self) -> dict:
        return {"adamw": self.optimizer.state_dict(), "schedule": self.scheduler.state_dict(),
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["adamw"])
        self.scheduler.load_state_dict(state["schedule"])
        self.mini_step = state["mini_step"]
        if self.acc is not None:
            for a, saved in zip(self.acc, state["acc"]):
                a.copy_(saved)


def make_optimizer(params, cfg: OptimConfig, steps_per_epoch: int) -> Optimizer:
    """The port's counterpart of the JAX ``make_optimizer``."""
    return Optimizer(params, cfg, steps_per_epoch)


def stack_pairs(pair_dicts: list) -> dict:
    """Stack per-pair pyramid dicts along a new leading pair axis (the JAX
    package's ``parallel.mesh.stack_pairs``)."""
    return {k: np.stack([d[k] for d in pair_dicts], 0) for k in pair_dicts[0]}


class Trainer:
    """Epoch-based trainer for one experiment, on ``device`` (the card
    unless the caller asks for the CPU; without a CUDA device the default
    raises, there is no fallback)."""

    def __init__(self, model_cfg: ModelConfig, loss_cfg: loss_lib.LossConfig,
                 eval_cfg: loss_lib.EvalConfig, optim_cfg: OptimConfig, output_dir: str,
                 seed: int = 7351, log_steps: int = 10, data_parallel: Optional[bool] = None,
                 batch_size: int = 1, device="cuda"):
        if data_parallel:
            raise NotImplementedError("Trainer: the data-parallel epoch is not ported "
                                      "(ROADMAP §A8)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer: no CUDA device; pass device='cpu' to run on the CPU")
        self.data_parallel = False
        self.batch_size = int(batch_size)
        self.model_cfg = model_cfg
        self.loss_cfg = loss_cfg
        self.eval_cfg = eval_cfg
        self.optim_cfg = optim_cfg
        self.output_dir = output_dir
        self.snapshot_dir = osp.join(output_dir, "snapshots")
        os.makedirs(self.snapshot_dir, exist_ok=True)
        self.logger = get_logger(osp.join(output_dir, "logs"))
        self.metrics_writer = MetricsWriter(osp.join(output_dir, "events"))
        self.log_steps = log_steps
        self.seed = seed
        self.epoch = 0
        self.iteration = 0
        self.model = None
        self.optimizer = None
        self._train_step = None
        self._batched_train_step = None

    # ------------------------------------------------------------- setup
    def initialize(self, example_data: Optional[dict], steps_per_epoch: int):
        """Seeded weights (``SE3ETModel(model_cfg, seed=seed)``; the port's
        weights do not depend on the data, so ``example_data`` is unread),
        the optimizer and the training steps."""
        from se3et_tpu_torch.engine import steps as steps_lib  # steps imports this module

        self.model = SE3ETModel(self.model_cfg, seed=self.seed, device=self.device)
        self.optimizer = make_optimizer(self.model.parameters(), self.optim_cfg,
                                        steps_per_epoch)
        num_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"model initialized: {num_params / 1e6:.2f}M parameters")
        step = steps_lib.make_train_step(self.model, self.loss_cfg, self.optimizer)

        def train_step(data, generator):
            losses = step(data, generator=generator)
            losses["skipped"] = (~torch.isfinite(losses["grad_norm"])).float()
            return losses

        self._train_step = train_step
        if self.batch_size > 1:
            self._batched_train_step = steps_lib.make_batched_train_step(
                self.model, self.loss_cfg, self.optimizer)
            self.logger.info(f"single-device pair batching x{self.batch_size}")

    def _generator(self, offset: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.seed + offset)

    # ------------------------------------------------------- checkpointing
    def save_snapshot(self, name: str):
        path = osp.join(osp.abspath(self.snapshot_dir), name)
        os.makedirs(path, exist_ok=True)
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "epoch": self.epoch, "iteration": self.iteration}
        tmp = osp.join(path, SNAPSHOT_FILE + ".tmp")
        torch.save(state, tmp)
        os.replace(tmp, osp.join(path, SNAPSHOT_FILE))
        self.logger.info(f"snapshot saved to {path}")

    def load_snapshot(self, name: str, restore_optimizer: bool = False):
        """Restore the weights, ``epoch`` and ``iteration`` (and, with
        ``restore_optimizer``, the optimizer: AdamW's moments, the schedule
        and the accumulator).  By default the optimizer stays as
        ``initialize`` made it, as the JAX package (and the reference,
        ``base_trainer.py:165-179``) skip its state on resume."""
        path = osp.join(osp.abspath(self.snapshot_dir), name)
        state = torch.load(osp.join(path, SNAPSHOT_FILE), map_location=self.device,
                           weights_only=True)
        self.model.load_state_dict(state["model"])
        if restore_optimizer:
            self.optimizer.load_state_dict(state["optimizer"])
        self.epoch = int(state["epoch"])
        self.iteration = int(state["iteration"])
        self.logger.info(f"snapshot loaded from {path} (epoch {self.epoch})")

    # ------------------------------------------------------------- loops
    def _log_train(self, board: SummaryBoard, text: str):
        self.logger.info(text)
        self.metrics_writer.add_dict(board.summary(), self.iteration, prefix="train/")

    def train_epoch(self, loader: Iterable[dict]):
        if self._batched_train_step is not None:
            return self._train_epoch_batched(loader)
        board = SummaryBoard(last_n=self.log_steps)
        timer = Timer()
        generator = self._generator(1000 + self.epoch)
        timer.tic()
        for i, data in enumerate(loader):
            data = pyramid_to_tensors(data, self.device)
            timer.record_prepare()
            losses = self._train_step(data, generator)
            self.iteration += 1
            board.update_from_dict({k: float(v) for k, v in losses.items()})
            timer.record_process()
            if (i + 1) % self.log_steps == 0:
                self._log_train(board, f"epoch {self.epoch} iter {i + 1}: {board.format()} "
                                f"(prep {timer.prepare_time:.3f}s step "
                                f"{timer.process_time:.3f}s)")
            timer.tic()
        self.metrics_writer.flush()
        return board.summary()

    def _train_epoch_batched(self, loader: Iterable[dict]):
        """An epoch over batches of ``batch_size`` pairs, run one after
        another inside each step (``make_batched_train_step``); the trailing
        batch is padded with repeats of its last pair at weight 0, as the
        JAX package pads it."""
        board = SummaryBoard(last_n=self.log_steps)
        generator = self._generator(1000 + self.epoch)
        bs = self.batch_size
        pending = []
        steps = 0

        def run_batch(pairs):
            n_real = len(pairs)
            batch = stack_pairs(pairs + [pairs[-1]] * (bs - n_real))
            batch["pair_weights"] = (np.arange(bs) < n_real).astype(np.float32)
            losses = self._batched_train_step(pyramid_to_tensors(batch, self.device),
                                              generator=generator)
            self.iteration += 1
            board.update_from_dict({k: float(v) for k, v in losses.items()})

        for data in loader:
            pending.append(data)
            if len(pending) < bs:
                continue
            run_batch(pending)
            pending = []
            steps += 1
            if steps % self.log_steps == 0:
                self._log_train(board, f"epoch {self.epoch} step {steps} (x{bs} pairs): "
                                f"{board.format()}")
        if pending:
            run_batch(pending)
            steps += 1
            if steps % self.log_steps == 0:
                self._log_train(board, f"epoch {self.epoch} step {steps} (x{bs} pairs): "
                                f"{board.format()}")
        self.metrics_writer.flush()
        return board.summary()

    def validate(self, loader: Iterable[dict]):
        """The eval forward (registration and ground-truth overlaps), the
        losses and :func:`~se3et_tpu_torch.nn.loss.evaluate`'s metrics of
        every pair, eager and without gradients; their means under
        ``val/``."""
        board = SummaryBoard()
        with torch.no_grad():
            for data in loader:
                data = pyramid_to_tensors(data, self.device)
                out = self.model(data, train=False, with_registration=True, with_gt=True)
                _, losses = loss_lib.overall_loss(out, data, self.loss_cfg)
                metrics = loss_lib.evaluate(out, data, self.eval_cfg)
                metrics.update(losses)
                board.update_from_dict({k: float(v) for k, v in metrics.items()})
        summary = board.summary()
        self.logger.info(f"validation epoch {self.epoch}: " + board.format())
        self.metrics_writer.add_dict(summary, self.iteration, prefix="val/")
        self.metrics_writer.flush()
        return summary

    def run_iterations(self, loader: Iterable[dict], max_iterations: int,
                       val_loader_fn: Optional[Callable[[], Iterable[dict]]] = None,
                       val_every: int = 1000, snapshot_every: int = 1000):
        """Iteration-based training: one stream of steps over ``loader``
        (restarted when it ends) with validation and snapshots every
        ``val_every`` / ``snapshot_every`` iterations; target noise from a
        generator seeded ``seed + 2000``."""
        board = SummaryBoard(last_n=self.log_steps)
        generator = self._generator(2000)
        it = iter(loader)
        while self.iteration < max_iterations:
            try:
                data = next(it)
            except StopIteration:
                it = iter(loader)
                data = next(it)
            losses = self._train_step(pyramid_to_tensors(data, self.device), generator)
            self.iteration += 1
            board.update_from_dict({k: float(v) for k, v in losses.items()})
            if self.iteration % self.log_steps == 0:
                self._log_train(board, f"iter {self.iteration}: {board.format()}")
            if val_loader_fn is not None and self.iteration % val_every == 0:
                self.validate(val_loader_fn())
            if self.iteration % snapshot_every == 0:
                self.save_snapshot(f"iter-{self.iteration}")
                self.save_snapshot("latest")
        self.save_snapshot("latest")
        return board.summary()

    def run(self, train_loader_fn: Callable[[], Iterable[dict]],
            val_loader_fn: Optional[Callable[[], Iterable[dict]]] = None,
            resume: bool = False):
        """Epochs up to ``max_epoch``, each followed by validation and the
        snapshots ``epoch-<n>`` and ``latest``; with ``resume`` it starts
        from ``latest`` where one exists (weights and counters, a fresh
        optimizer)."""
        if resume and osp.isdir(osp.join(self.snapshot_dir, "latest")):
            self.load_snapshot("latest")
        while self.epoch < self.optim_cfg.max_epoch:
            self.epoch += 1
            self.train_epoch(train_loader_fn())
            if val_loader_fn is not None:
                self.validate(val_loader_fn())
            self.save_snapshot(f"epoch-{self.epoch}")
            self.save_snapshot("latest")
