"""Micro-batching inference server (counterpart of
``com_tpu/serving/server.py``).

The inference function takes one static batch shape (B, N, F).  Traffic
arrives one scene at a time; this server turns that stream back into full
batches:

* requests enqueue a (points, future) pair;
* a dispatch thread collects up to B scenes (waiting at most ``max_wait_ms``
  after the first), pads the tail of a partial batch with masked-out empty
  scenes, moves the batch to the server's device, runs the function ONCE,
  and resolves each future with its slice, back on the host as numpy.

One dispatch thread, one device stream.  The device is fixed when the
server is built and passed explicitly, so the dispatch thread relies on no
thread-local current device.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    scenes_padded: int = 0
    wait_ms_total: float = 0.0
    infer_ms_total: float = 0.0

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        if self.batches:
            d["mean_occupancy"] = self.requests / max(
                1, self.requests + self.scenes_padded)
            d["mean_infer_ms"] = self.infer_ms_total / self.batches
        return d


@dataclass
class _Item:
    points: np.ndarray
    future: Future = field(default_factory=Future)


class BatchServer:
    """Batches single-scene requests onto a fixed-shape inference fn.

    run: callable(batch dict of tensors on ``device``) -> (boxes, scores,
        labels, valid) tensors, e.g. the step of train.eval.make_eval_step.
    input_spec: {"points": ((B, N, F), dtype), "points_mask": ((B, N), _)}
        shapes (manifest["input_spec"] accepted directly).
    max_wait_ms: how long the dispatcher waits for more scenes after the
        first before launching a partial batch.
    score_thresh: detections below this are dropped from responses.
    device: where batches go (CUDA unless the caller passes another).
    """

    def __init__(self, run, input_spec, max_wait_ms: float = 20.0,
                 score_thresh: float = 0.1, device=None):
        self.device = resolve_device(device)
        shape = tuple(input_spec["points"][0])
        self.batch_size, self.max_points, self.num_feats = (
            int(shape[0]), int(shape[1]), int(shape[2]))
        self._run = run
        self.max_wait_s = max_wait_ms / 1e3
        self.score_thresh = float(score_thresh)
        self.stats = ServerStats()
        self._q: queue.Queue = queue.Queue()
        self._stop = object()
        self._closed = False
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    # -- client side ------------------------------------------------------
    def submit(self, points: np.ndarray) -> Future:
        """points: (n, F) float32, n <= max_points.  Resolves to a dict
        {"boxes": (k, 7+), "scores": (k,), "labels": (k,)} above thresh."""
        points = np.asarray(points, np.float32)
        if points.ndim != 2 or points.shape[1] != self.num_feats:
            raise ValueError(
                f"expected (n, {self.num_feats}) points, got {points.shape}")
        if points.shape[0] > self.max_points:
            raise ValueError(
                f"{points.shape[0]} points exceeds the server's cap "
                f"{self.max_points}")
        if self._closed:
            raise RuntimeError("BatchServer is closed")
        item = _Item(points)
        self._q.put(item)
        return item.future

    def infer(self, points: np.ndarray, timeout: float | None = 60.0) -> dict:
        return self.submit(points).result(timeout=timeout)

    def close(self):
        self._closed = True
        self._q.put(self._stop)
        self._thread.join(timeout=30.0)
        # fail any request that raced past the closed check or was queued
        # behind the stop sentinel — a never-resolved future would block
        # its caller for the full timeout
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not self._stop and not item.future.done():
                item.future.set_exception(RuntimeError("BatchServer closed"))

    # -- dispatch side ----------------------------------------------------
    def _collect(self):
        """Block for the first item, then fill up to batch_size within the
        wait budget.  Returns (items, saw_stop, wait_ms) where wait_ms is
        the batching wait measured from the FIRST item's arrival (queue
        idle time before it does not count)."""
        first = self._q.get()
        if first is self._stop:
            return [], True, 0.0
        t0 = time.monotonic()
        items, deadline = [first], t0 + self.max_wait_s
        stop = False
        while len(items) < self.batch_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is self._stop:
                stop = True
                break
            items.append(nxt)
        return items, stop, (time.monotonic() - t0) * 1e3

    def _dispatch(self):
        while True:
            items, stop, wait_ms = self._collect()
            if items:
                self.stats.wait_ms_total += wait_ms
                try:
                    self._run_batch(items)
                except BaseException as e:  # resolve, don't kill the thread
                    for it in items:
                        if not it.future.done():
                            it.future.set_exception(e)
            if stop:
                return

    def _run_batch(self, items):
        b, n, f = self.batch_size, self.max_points, self.num_feats
        pts = np.zeros((b, n, f), np.float32)
        mask = np.zeros((b, n), bool)
        for i, it in enumerate(items):
            k = it.points.shape[0]
            pts[i, :k] = it.points
            mask[i, :k] = True
        t0 = time.monotonic()
        batch = {"points": torch.from_numpy(pts).to(self.device),
                 "points_mask": torch.from_numpy(mask).to(self.device)}
        boxes, scores, labels, valid = (
            t.cpu().numpy() for t in self._run(batch))
        self.stats.infer_ms_total += (time.monotonic() - t0) * 1e3
        self.stats.batches += 1
        self.stats.requests += len(items)
        self.stats.scenes_padded += b - len(items)
        for i, it in enumerate(items):
            keep = valid[i] & (scores[i] >= self.score_thresh)
            it.future.set_result({
                "boxes": boxes[i][keep],
                "scores": scores[i][keep],
                "labels": labels[i][keep].astype(np.int32),
            })
