"""Training metrics log: JSONL always, TensorBoard when its package imports
(the port's copy of ``com_tpu/utils/metrics.py``; reference
train_utils.py:192-196).  The JSONL file holds every scalar on its own, so
a machine without ``tensorboardX`` or ``torch.utils.tensorboard`` loses
nothing."""
from __future__ import annotations

import importlib
import json
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        for mod in ("tensorboardX", "torch.utils.tensorboard"):
            try:
                self._tb = importlib.import_module(mod).SummaryWriter(
                    str(self.log_dir / "tensorboard"))
                break
            except Exception:
                continue

    def log(self, step: int, scalars: dict):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
