"""Training loop with the COM epoch feedback (counterpart of
``com_tpu/train/loop.py``; reference train_utils.py:219-387).

Per epoch: set the loader's epoch, zero the confidence accumulators, run
the steps over batches that a prefetch thread copies to the device while the
previous step runs, then take the epoch's (num_class, num_groups) mean
confidences, ``conf_sum / (conf_cnt + 0.01)``, to the host once and hand them
to ``loader.dataset.set_confidence_groups``, the COMAug sampler.  The loader
is duck-typed: ``set_epoch(epoch)``, iteration over dicts of numpy arrays,
and ``dataset.set_confidence_groups``.  With ``ckpt_dir``, every
``ckpt_save_interval`` epochs end with a checkpoint (``utils/checkpoint.py``)
that holds the sampler's confidences, and a rolling ``latest_model.pth`` is
written every ``ckpt_save_time_interval`` seconds inside an epoch.

Under an active data mesh (``parallel.sharding``) each rank runs the loop
over its loader shard (``build_dataloader(dist=True)``: every rank the same
number of steps).  At the epoch's end the accumulators are summed over the
ranks in one all-reduce before the confidences go to the host, so every
rank's sampler gets the same (the reference's all_gather,
train_utils.py:269-289); only rank 0 logs and writes checkpoints.
"""
from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from ..parallel.sharding import active_mesh, all_reduce_
from ..utils.checkpoint import save_checkpoint, save_latest
from ..utils.common import AverageMeter
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


def _sampler_state(loader):
    """``{"confidence_groups": ...}`` of the loader's COMAug sampler, or None
    (com_tpu/train/loop.py:133-141)."""
    aug = getattr(loader.dataset, "data_augmentor", None)
    sampler = aug.gt_sampler if aug is not None else None
    if sampler is None or sampler.confidence_groups is None:
        return None
    return {"confidence_groups": np.asarray(sampler.confidence_groups)}


def train_model(step_fn, state, loader, num_epochs: int, ckpt_dir=None, logger=None,
                start_epoch: int = 0, ckpt_save_interval: int = 1, max_ckpt_save_num: int = 50,
                log_interval: int = 50, metric_hook=None, device=None, batch_keys=None,
                ckpt_save_time_interval: float = 300.0, start_iter: int = 0):
    """Run ``step_fn(state, batch, epoch)`` over ``loader`` for epochs
    ``start_epoch .. num_epochs - 1``; returns (state, iterations), the
    iterations counted on from ``start_iter`` (a resume continues the
    reference's monotone ``it``, train_utils.py:354-370).
    ``metric_hook(epoch, it, metrics)`` sees each step's device metrics;
    ``logger`` gets the loss and the mean data and step times (host clock)
    every ``log_interval`` steps (rank 0's only).  ``batch_keys``
    (``train.step.device_batch_keys``) are the arrays copied to the device;
    None copies every numpy array of a batch.

    ``device`` follows the entry-point rule (CUDA unless the caller passes
    another; under a data mesh, the rank's device) and must hold
    ``state``'s model."""
    mesh = active_mesh()
    logger = logger if mesh is None or mesh.rank == 0 else None  # the saves check it too
    dev = check_same_device(state.net, device if device is not None or mesh is None
                            else mesh.device)
    accumulated_iter = start_iter
    last_timed_save = time.time()
    for epoch in range(start_epoch, num_epochs):
        loader.set_epoch(epoch)
        state.reset_epoch_stats()
        data_meter, step_meter = AverageMeter(), AverageMeter()
        end = time.time()
        for it, batch in enumerate(DevicePrefetcher(iter(loader), dev, batch_keys)):
            data_meter.update(time.time() - end)
            state, metrics = step_fn(state, batch, epoch)
            step_meter.update(time.time() - end - data_meter.val)
            end = time.time()
            accumulated_iter += 1
            if logger and it % log_interval == 0:
                logger.info("epoch %d it %d loss %.4f d_time %.3f s_time %.3f", epoch, it,
                            float(metrics["loss"]), data_meter.avg, step_meter.avg)
            if metric_hook is not None:
                metric_hook(epoch, it, metrics)
            if (ckpt_dir is not None and ckpt_save_time_interval > 0
                    and time.time() - last_timed_save > ckpt_save_time_interval):
                save_latest(state, ckpt_dir, epoch, accumulated_iter)
                last_timed_save = time.time()
                if logger:
                    logger.info("saved latest_model at epoch %d it %d", epoch, it)
        # epoch-end feedback: one small device -> host copy
        if state.conf_sum is not None:
            all_reduce_(state.conf_sum, state.conf_cnt)  # the whole batch's, on every rank
            conf = (state.conf_sum / (state.conf_cnt + 0.01)).cpu().numpy()
            loader.dataset.set_confidence_groups(conf)
            if logger:
                logger.info("epoch %d confidence groups updated (mean %.4f)", epoch,
                            float(conf.mean()))
        if ckpt_dir is not None and (epoch + 1) % ckpt_save_interval == 0:
            save_checkpoint(state, ckpt_dir, epoch + 1, accumulated_iter,
                            sampler_state=_sampler_state(loader),
                            max_ckpt_save_num=max_ckpt_save_num)
            if logger:
                logger.info("saved checkpoint epoch %d", epoch + 1)
    return state, accumulated_iter
