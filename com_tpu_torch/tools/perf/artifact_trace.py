"""The serving artifact against the eager step on the card: where the
artifact's time goes.

    python -m com_tpu_torch.tools.perf.artifact_trace [--iters 20] [--trace DIR]

Run it from a checkout's root (it reads the flagship YAML and
``chip_smoke.py``'s scene generator there).  The flagship eval step at full
width (batch 2, 163,840 points a scene, 468x468, bf16, seeded weights) is
exported (``export_eval_step``), written and loaded (``load_artifact``);
then, alternating on one batch already on the card, the eager step, the
artifact as ``load_artifact`` runs it, and the program as
``torch.export.load`` gives it, with export's tensor-metadata asserts
(``aten._assert_tensor_metadata``, a host-side check of each dtype cast)
that ``load_artifact`` drops.  For each: the host's time to
issue a batch (from a synchronised start until the call returns) and the
batch's time (until ``torch.cuda.synchronize()`` returns), medians over
``--iters``; then one ``torch.profiler`` window of 3 batches each: the
device's busy share, its kernel count, the host ops by count and self CPU
time (``--trace DIR`` writes each window's Chrome trace there).  Prints
one JSON line a variant and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch


def _window(fn, logdir):
    """3 batches under torch.profiler: wall ms, device busy ms, device
    kernels, host ops by name (calls, self CPU ms)."""
    from torch.autograd import DeviceType

    from com_tpu_torch.utils.profiling import trace

    torch.cuda.synchronize()
    with trace(logdir) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:  # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    ops = Counter()
    self_ms = Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key.startswith("aten::"):
            ops[e.key] += e.count
            self_ms[e.key] += e.self_cpu_time_total / 1e3
    return wall, busy / 1e3, len(spans), ops, self_ms


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--trace", type=str, default=None,
                        help="directory for the profiler windows' Chrome traces")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("artifact_trace: no CUDA device")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.ops import _kernels
    from com_tpu_torch.train.eval import make_eval_step
    from com_tpu_torch.utils.serving import (export_eval_step, load_artifact, make_manifest,
                                             write_artifact)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    _kernels.build_all()
    dev = torch.device("cuda", 0)
    b, n = chip_smoke.BATCH, chip_smoke.POINTS
    cfg, meta = chip_smoke.load_config()
    names = list(cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, meta, device=dev, seed=0)
    step = make_eval_step(net, cfg.MODEL, names, meta, device=dev)
    spec = {"points": ((b, n, chip_smoke.FEATS), torch.float32),
            "points_mask": ((b, n), torch.bool)}
    with tempfile.TemporaryDirectory() as tmp:
        stem = Path(tmp) / "flagship"
        program = export_eval_step(net, cfg.MODEL, names, meta, spec, device=dev)
        write_artifact(stem, program, make_manifest(cfg, meta, spec, ["cuda"]))
        run, _ = load_artifact(stem, device=dev)
        guarded = torch.export.load(stem.with_suffix(".pt2")).module()
    pts = chip_smoke.waymo_like_points(np.random.RandomState(6), b, n, meta.point_cloud_range)
    batch = {"points": torch.as_tensor(pts, device=dev),
             "points_mask": torch.ones((b, n), dtype=torch.bool, device=dev)}
    variants = {
        "eager": lambda: step(batch),
        "artifact": lambda: run(batch),
        "artifact_with_asserts": lambda: guarded(batch["points"], batch["points_mask"]),
    }
    issue, total = {k: [] for k in variants}, {k: [] for k in variants}
    with torch.no_grad():
        for i in range(3 + args.iters):
            for name, fn in variants.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                if i >= 3:
                    issue[name].append((t1 - t0) * 1e3)
                    total[name].append((time.perf_counter() - t0) * 1e3)
        eager_ops = None
        for name, fn in variants.items():
            logdir = Path(args.trace) / name if args.trace else Path(tempfile.mkdtemp())
            wall, busy, kernels, ops, self_ms = _window(fn, logdir)
            extra = {}
            if eager_ops is None:
                eager_ops = ops
            else:
                extra = {"ops_beyond_eager": {k: v - eager_ops.get(k, 0) for k, v in ops.items()
                                              if v != eager_ops.get(k, 0)}}
            print(json.dumps({
                "variant": name, "issue_ms_median": float(np.median(issue[name])),
                "batch_ms_median": float(np.median(total[name])),
                "batch_ms_min": min(total[name]), "batch_ms_max": max(total[name]),
                "window_ms": wall, "device_busy_ms": busy, "device_busy_share": busy / wall,
                "device_kernels": kernels, "host_ops": sum(ops.values()),
                "host_self_ms": sum(self_ms.values()),
                "top_self_ms": {k: round(v, 3) for k, v in self_ms.most_common(12)},
                **extra, "card": smi}), flush=True)


if __name__ == "__main__":
    main()
