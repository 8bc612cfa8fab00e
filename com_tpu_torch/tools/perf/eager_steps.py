"""The flagship's eager serving batch and train step on the card, for
holding two checkouts of the port against each other in one call.

    python -m com_tpu_torch.tools.perf.eager_steps [--iters 20] [--warmup 3] [--label NAME]

Run it from a checkout's root: it imports that checkout's ``com_tpu_torch``
and ``chip_smoke.py`` (the flagship YAML, the Waymo-like scenes and
batches, the trainer), and uses only what older checkouts of the port
have too, so the same file times a parent commit:

    (cd PARENT && python /path/to/com_tpu_torch/tools/perf/eager_steps.py)

Serving: ``make_eval_step`` at full width (batch 2, 163,840 points a
scene, 468x468, bf16, seeded weights) on a batch already on the card, the
host clock around each call ending in ``torch.cuda.synchronize()`` (as
chip_smoke's serving phase times a batch).  Training: path A's step
(``make_train_step`` on a presorted batch with 500 object slots), CUDA
events between consecutive steps, issued back to back (as ``train_model``'s
steps are timed).  Prints one JSON line: each list of ms, its median and
range, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _summary(ms):
    return {"ms": [round(x, 3) for x in ms], "median": float(np.median(ms)), "min": min(ms),
            "max": max(ms)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--label", type=str, default=str(Path.cwd().name))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("eager_steps: no CUDA device")
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.ops import _kernels
    from com_tpu_torch.train.eval import make_eval_step

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build_all()
    dev = torch.device("cuda", 0)
    b, n = chip_smoke.BATCH, chip_smoke.POINTS

    cfg, meta = chip_smoke.load_config()
    net = build_network(cfg.MODEL, meta, device=dev, seed=0)
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    pts = chip_smoke.waymo_like_points(np.random.RandomState(6), b, n, meta.point_cloud_range)
    batch = {"points": torch.as_tensor(pts, device=dev),
             "points_mask": torch.ones((b, n), dtype=torch.bool, device=dev)}
    serving = []
    for i in range(args.warmup + args.iters):
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        if i >= args.warmup:
            serving.append((time.perf_counter() - t0) * 1e3)
    del net, step, batch
    torch.cuda.empty_cache()

    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True  # the batch comes presorted
    host = chip_smoke.waymo_like_batch(np.random.RandomState(16), b, n, meta.point_cloud_range,
                                       meta.voxel_size, len(cfg.CLASS_NAMES))
    net, _, state, train_step = chip_smoke.build_trainer(dev, cfg, meta, args.iters)
    dev_batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    marks = []
    for i in range(args.warmup + args.iters + 1):
        state, _ = train_step(state, dev_batch, 0)
        if i >= args.warmup:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
    torch.cuda.synchronize()
    train = [a.elapsed_time(z) for a, z in zip(marks, marks[1:])]
    print(json.dumps({"label": args.label, "serving": _summary(serving),
                      "train": _summary(train), "card": smi}), flush=True)


if __name__ == "__main__":
    main()
