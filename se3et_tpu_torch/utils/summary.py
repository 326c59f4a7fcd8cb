r"""Metrics accumulation and timing utilities: a copy of
:mod:`se3et_tpu.utils.summary`, kept for the PyTorch port, which imports
nothing of the JAX package (``tests/test_torch_shared_copies.py`` holds the
two equal up to :func:`get_logger`).  :func:`get_logger` differs in two
ways: it names its logger ``se3et_tpu_torch``, so the two packages' logs
stay apart in one process; and a call with a directory adds the file there
also where an earlier call made the logger without one (the original
returns the logger as first made, so a ``Tester`` built after the runner's
first message would write no log file).
"""

from __future__ import annotations

import logging
import os
import sys
import time
from collections import deque


class AverageMeter:
    """Running average with an optional last-n window (``average_meter.py``)."""

    def __init__(self, last_n: int | None = None):
        self._records = []
        self._last_n = last_n

    def update(self, value):
        if isinstance(value, (list, tuple)):
            self._records.extend(value)
        else:
            self._records.append(float(value))

    def reset(self):
        self._records = []

    @property
    def records(self):
        if self._last_n is not None:
            return self._records[-self._last_n:]
        return self._records

    def sum(self):
        return sum(self.records)

    def mean(self):
        r = self.records
        return sum(r) / len(r) if r else 0.0

    def std(self):
        r = self.records
        if not r:
            return 0.0
        m = self.mean()
        return (sum((x - m) ** 2 for x in r) / len(r)) ** 0.5

    def median(self):
        r = sorted(self.records)
        return r[len(r) // 2] if r else 0.0


class SummaryBoard:
    """Dict of AverageMeters with adaptive registration (``summary_board.py``)."""

    def __init__(self, names=None, last_n: int | None = None, adaptive: bool = True):
        self.meters: dict[str, AverageMeter] = {}
        self._last_n = last_n
        self._adaptive = adaptive
        for name in names or []:
            self.register_meter(name)

    def register_meter(self, name):
        self.meters[name] = AverageMeter(last_n=self._last_n)

    def update(self, name, value):
        if name not in self.meters:
            if not self._adaptive:
                raise KeyError(name)
            self.register_meter(name)
        self.meters[name].update(value)

    def update_from_dict(self, d):
        for k, v in d.items():
            try:
                self.update(k, float(v))
            except (TypeError, ValueError):
                pass

    def reset_all(self):
        for m in self.meters.values():
            m.reset()

    def mean(self, name):
        return self.meters[name].mean()

    def summary(self, names=None):
        names = names or list(self.meters)
        return {n: self.meters[n].mean() for n in names if n in self.meters}

    def format(self, names=None) -> str:
        return ", ".join(f"{k}: {v:.4f}" for k, v in self.summary(names).items())


class Timer:
    """Prepare/process split timer (``utils/timer.py:4-59``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._total_prepare = 0.0
        self._total_process = 0.0
        self._count_prepare = 0
        self._count_process = 0
        self._last = time.time()

    def tic(self):
        self._last = time.time()

    def record_prepare(self):
        now = time.time()
        self._total_prepare += now - self._last
        self._count_prepare += 1
        self._last = now

    def record_process(self):
        now = time.time()
        self._total_process += now - self._last
        self._count_process += 1
        self._last = now

    @property
    def prepare_time(self):
        return self._total_prepare / max(self._count_prepare, 1)

    @property
    def process_time(self):
        return self._total_process / max(self._count_process, 1)


def get_logger(log_dir: str | None = None, name: str = "se3et_tpu_torch") -> logging.Logger:
    """Console + timestamped-file logger (``engine/logger.py:28-53``).  A
    call with ``log_dir`` logs to a file there from then on, also where an
    earlier call made the logger without one."""
    logger = logging.getLogger(name)
    fmt = logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        logger.propagate = False
    if log_dir:
        log_dir = os.path.abspath(log_dir)
        files = [h for h in logger.handlers if isinstance(h, logging.FileHandler)]
        if any(os.path.dirname(h.baseFilename) == log_dir for h in files):
            return logger
        for h in files:
            logger.removeHandler(h)
            h.close()
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        fh = logging.FileHandler(os.path.join(log_dir, f"train-{stamp}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
