"""Scalar metric writer: JSONL always, TensorBoard when available.

The port's copy of ``mvpnet_tpu/utils/writer.py``. The JSONL stream
(`metrics.jsonl` in the output dir) is the primary record; TensorBoard event
files are written too when torch.utils.tensorboard is importable.
"""
from __future__ import annotations

import json
import os
import time


class MetricWriter:
    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(output_dir, "tb"))
        except ImportError:  # no tensorboard package: JSONL only
            pass

    def write(self, step: int, scalars: dict, prefix: str = ""):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            name = f"{prefix}{k}"
            try:
                rec[name] = float(v)
            except (TypeError, ValueError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(name, rec[name], step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
