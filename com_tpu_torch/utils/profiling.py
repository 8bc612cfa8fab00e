"""Tracing and profiling utilities (counterpart of
``com_tpu/utils/profiling.py``).

* ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU, and
  CUDA where a card is visible) that writes a Chrome trace
  (``<logdir>/trace.json``, for chrome://tracing or Perfetto);
* ``StepTimer``: the data / compute wall-time split of each step with
  running averages (the numbers the reference logs every 50 iterations);
* ``device_memory_stats()``: ``torch.cuda.memory_stats`` of each visible
  card.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir):
    """Profile the block; on exit write ``<logdir>/trace.json``.  Yields
    the profiler (its ``key_averages()`` sums time by op and kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path / "trace.json"))


class StepTimer:
    """data_time / step_time meters (train_utils.py per-iter timing parity).
    Call ``data_done()`` when a batch is ready and ``step_done()`` after the
    step; a step on the card should end in a synchronisation first, or the
    time is the host's issue time."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.data_sum = self.step_sum = 0.0
        self.count = 0
        self._mark = time.perf_counter()

    def data_done(self):
        now = time.perf_counter()
        self._data = now - self._mark
        self._mark = now

    def step_done(self):
        now = time.perf_counter()
        self.data_sum += self._data
        self.step_sum += now - self._mark
        self._mark = now
        self.count += 1

    @property
    def avg_data(self):
        return self.data_sum / max(self.count, 1)

    @property
    def avg_step(self):
        return self.step_sum / max(self.count, 1)


def device_memory_stats() -> dict:
    """{"cuda:i": torch.cuda.memory_stats(i)} for each visible card; empty
    without one."""
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
