"""Logging + smoothed meters.

The port's copy of ``mvpnet_tpu/utils/logger.py``: stdout+file logging and
windowed-average meters including data-time/batch-time.
"""
from __future__ import annotations

import logging
import os
import sys
import time
from collections import defaultdict, deque


def setup_logger(name: str = "mvpnet_torch", output_dir: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class AverageMeter:
    """Windowed + global average of a scalar stream."""

    def __init__(self, window: int = 50):
        self.values: deque = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.values.append(value)
        self.total += value
        self.count += 1

    @property
    def avg(self) -> float:
        return sum(self.values) / max(len(self.values), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """Dict of AverageMeters + iteration timing."""

    def __init__(self, window: int = 50):
        self.meters: dict[str, AverageMeter] = defaultdict(
            lambda: AverageMeter(window)
        )
        self._last = time.perf_counter()

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def tick(self, name: str = "time"):
        now = time.perf_counter()
        self.meters[name].update(now - self._last)
        self._last = now

    def __str__(self) -> str:
        return "  ".join(
            f"{k}: {m.avg:.4f}" for k, m in sorted(self.meters.items())
        )
