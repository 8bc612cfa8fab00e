"""Training loop with the COM epoch feedback (counterpart of
``com_tpu/train/loop.py``; reference train_utils.py:219-387).

Per epoch: set the loader's epoch, zero the confidence accumulators, run
the steps over batches that a prefetch thread copies to the device while the
previous step runs, then take the epoch's (num_class, num_groups) mean
confidences, ``conf_sum / (conf_cnt + 0.01)``, to the host once and hand them
to ``loader.dataset.set_confidence_groups``, the COMAug sampler.  The loader
is duck-typed: ``set_epoch(epoch)``, iteration over dicts of numpy arrays,
and ``dataset.set_confidence_groups``.  Checkpoints are not ported yet.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from .state import check_same_device


class DevicePrefetcher:
    """Copies the next host batch to the device while the current step runs:
    a worker thread pins each array and copies it on a stream of its own;
    the consumer's stream waits for that copy before it reads the batch.
    Two batches may be in flight.  Only the numpy arrays under
    ``batch_keys`` are copied (every numpy array when it is None)."""

    def __init__(self, host_iter, device: torch.device, batch_keys=None):
        self.q = queue.Queue(maxsize=2)
        self._stop = object()
        self._error = None
        self.device = device
        on_card = device.type == "cuda"
        stream = torch.cuda.Stream(device) if on_card else None

        def to_device(batch):
            arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)
                      and (batch_keys is None or k in batch_keys)}
            if not on_card:
                return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}, None
            with torch.cuda.stream(stream):
                out = {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
                       for k, v in arrays.items()}
                done = torch.cuda.Event()
                done.record(stream)
            return out, done

        def worker():
            try:
                for batch in host_iter:
                    self.q.put(to_device(batch))
            except BaseException as e:  # surfaced in the consumer thread
                self._error = e
            finally:
                self.q.put(self._stop)

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._stop:
                # a loader or copy failure fails the run; it must not read as
                # the clean end of an epoch (which would feed the sampler
                # statistics of a truncated epoch)
                if self._error is not None:
                    raise RuntimeError("data prefetch worker failed") from self._error
                return
            batch, done = item
            if done is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(done)
                for t in batch.values():
                    t.record_stream(cur)
            yield batch


def train_model(step_fn, state, loader, num_epochs: int, ckpt_dir=None, metric_hook=None,
                device=None, batch_keys=None):
    """Run ``step_fn(state, batch, epoch)`` over ``loader`` for epochs
    ``0 .. num_epochs - 1``; returns (state, steps taken).
    ``metric_hook(epoch, it, metrics)`` sees each step's device metrics.
    ``batch_keys`` (``train.step.device_batch_keys``) are the arrays copied
    to the device; None copies every numpy array of a batch.

    ``device`` follows the entry-point rule (CUDA unless the caller passes
    another) and must hold ``state``'s model."""
    if ckpt_dir is not None:
        raise NotImplementedError("checkpoints are not ported yet")
    dev = check_same_device(state.net, device)
    steps = 0
    for epoch in range(num_epochs):
        loader.set_epoch(epoch)
        state.reset_epoch_stats()
        for it, batch in enumerate(DevicePrefetcher(iter(loader), dev, batch_keys)):
            state, metrics = step_fn(state, batch, epoch)
            steps += 1
            if metric_hook is not None:
                metric_hook(epoch, it, metrics)
        # epoch-end feedback: one small device -> host copy
        if state.conf_sum is not None:
            loader.dataset.set_confidence_groups(
                (state.conf_sum / (state.conf_cnt + 0.01)).cpu().numpy())
    return state, steps
