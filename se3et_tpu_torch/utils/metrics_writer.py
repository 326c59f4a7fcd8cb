r"""Structured metrics logging: JSONL always, TensorBoard when available.

A copy of :mod:`se3et_tpu.utils.metrics_writer` (the standard library
and an optional tensorboard mirror), kept for the PyTorch port, which
imports nothing of the JAX package (``tests/test_torch_shared_copies.py``
holds the two equal after their docstrings).  Every scalar goes to an
append-only ``events.jsonl``, one JSON object a line (``t``, ``step`` and
the scalars by tag); if a tensorboard writer is importable it mirrors the
scalars there.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, event_dir: str):
        os.makedirs(event_dir, exist_ok=True)
        self._path = os.path.join(event_dir, "events.jsonl")
        self._f = open(self._path, "a")
        self._tb = None
        try:  # optional tensorboard mirror
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(event_dir)
        except Exception:
            pass

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(
            json.dumps({"t": time.time(), "step": step, tag: float(value)}) + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_dict(self, values: dict, step: int, prefix: str = ""):
        rec = {"t": time.time(), "step": step}
        for k, v in values.items():
            try:
                rec[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("t", "step"):
                    self._tb.add_scalar(k, v, step)

    def flush(self):
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()
