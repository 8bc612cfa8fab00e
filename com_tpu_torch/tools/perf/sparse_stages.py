"""Where the sparse 3D backbone spends its time on the card, and how full its
voxel caps run.

``backbone_split(net, inputs, iters)`` times the model's ``backbone_3d``
forward (CUDA events, mean over ``iters`` after one warm-up) split into the
rulebooks (``ops.sparse.batched_subm_rulebook`` / ``batched_strided_
rulebook``: keys, tables, lookups, the sites' unique, the tap inversion),
the gathers and GEMMs (``batched_subm_conv3d`` / ``batched_gather_conv3d``),
the norms with their ReLU and mask (``backbone3d._norm_act``), the dense
scatter (``batched_scatter_to_dense``) and the rest (the gaps between
them).  The functions are wrapped only for the call, so the model runs its
own code; each wrapped call records an event before and after it, on the
current stream.

``site_counts(net, inputs)`` runs the backbone once and gives, for each
stage, the active sites a scene against the stage's cap and how many the
cap dropped (the downsampling's unique sites counted again without a cap).

``chip_smoke.py`` path F calls both.  Alone, on path F's model and scenes
(or path G's) from ``chip_smoke.py``:

    python -m com_tpu_torch.tools.perf.sparse_stages [--path F|G] [--iters N]

prints the split, the sites, the backbone's forward as the host issues it
against its device time, a backward of the backbone alone (train mode, the
sum of its output), and torch.profiler's kernel tables of one forward and
one forward + backward.  Run it from a checkout's root.  It needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from contextlib import contextmanager

import numpy as np
import torch

from ...models import backbone3d
from ...ops import sparse as sp

PARTS = {"rulebook": ("batched_subm_rulebook", "batched_strided_rulebook"),
         "gather_gemm": ("batched_subm_conv3d", "batched_gather_conv3d"),
         "dense": ("batched_scatter_to_dense",)}


@contextmanager
def _wrapped(targets, wrap):
    """Swap ``module.name`` for ``wrap(part, name, fn)`` over ``targets``
    [(module, name, part)] for the block."""
    orig = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    for (mod, name, part), (_, _, fn) in zip(targets, orig):
        setattr(mod, name, wrap(part, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in orig:
            setattr(mod, name, fn)


def _targets():
    return ([(sp, name, part) for part, names in PARTS.items() for name in names]
            + [(backbone3d, "_norm_act", "norm")])


def backbone_split(net, inputs, iters=3):
    """{part: mean ms a forward} for rulebook, gather_gemm, norm, dense and
    rest, and "backbone_3d" the whole; ``inputs`` as the model reads them,
    on the card."""
    events = []

    def wrap(part, name, fn):
        def timed(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            events.append((part, a, b))
            return out
        return timed

    def forward():
        batch = net.vfe(dict(inputs))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        net.backbone_3d(batch)
        end.record()
        return start, end

    with torch.no_grad():
        forward()  # warm-up
        sums = dict.fromkeys((*PARTS, "norm", "rest", "backbone_3d"), 0.0)
        with _wrapped(_targets(), wrap):
            for _ in range(iters):
                events.clear()
                start, end = forward()
                torch.cuda.synchronize()
                whole = start.elapsed_time(end)
                parts = 0.0
                for part, a, b in events:
                    ms = a.elapsed_time(b)
                    sums[part] += ms / iters
                    parts += ms
                sums["rest"] += (whole - parts) / iters
                sums["backbone_3d"] += whole / iters
    return sums


def site_counts(net, inputs):
    """Per stage: {"stage", "cap", "active" [a scene], "uncapped" [a scene],
    "dropped" [a scene]}; the input stage's cap is the voxel slots."""
    rows = []
    orig = sp.batched_strided_rulebook

    def counting(coords, valid, grid, out_cap, stride, kernel=3, pad=1):
        out = orig(coords, valid, grid, out_cap, stride, kernel, pad)
        big = coords.shape[1] * 8  # each input site reaches at most 8 outputs
        uncapped = sp.batched_downsample_sites(coords, valid, stride, big, grid, kernel,
                                               pad)[1].sum(1)
        active = out[3].sum(1)
        rows.append({"cap": out_cap, "active": active.tolist(), "uncapped": uncapped.tolist(),
                     "dropped": (uncapped - active).tolist()})
        return out

    with torch.no_grad():
        batch = net.vfe(dict(inputs))
        valid = (batch["voxel_coords"][..., 0] >= 0).sum(1).tolist()
        sp.batched_strided_rulebook = counting
        try:
            net.backbone_3d(batch)
        finally:
            sp.batched_strided_rulebook = orig
    slots = batch["voxel_coords"].shape[1]
    names = ["conv2", "conv3", "conv4", "conv_out"]
    return ([{"stage": "input", "cap": slots, "active": valid, "uncapped": valid,
              "dropped": [0] * len(valid)}]
            + [dict(stage=n, **r) for n, r in zip(names, rows)])


def main(argv=None):
    import chip_smoke
    from com_tpu_torch.models.detectors import build_network

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--path", choices=("F", "G"), default="F")
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sparse_stages times the card: it needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    rng = np.random.RandomState(32)
    if args.path == "F":
        cfg, meta, proc = chip_smoke.load_voxel(chip_smoke.VOXEL_CONFIG)
        batch = chip_smoke.f_batches(rng, meta, proc, "test", 1)[0]
    else:
        cfg, meta, proc = chip_smoke.load_voxel(chip_smoke.SECOND_CONFIG)
        batch = chip_smoke.voxelize_batch(chip_smoke.kitti_like_batch(
            rng, chip_smoke.E_BATCH, meta.point_cloud_range, (0.16, 0.16, 4.0)), meta, proc, "test")
    net = build_network(cfg.MODEL, meta, device=dev, seed=0)
    inputs = {k: torch.as_tensor(batch[k], device=dev) for k in chip_smoke.VOXEL_KEYS}
    split = backbone_split(net, inputs, iters=args.iters)
    print(f"path {args.path} backbone_3d split ms (mean of {args.iters}): "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})} ({smi})")
    for row in site_counts(net, inputs):
        print(f"  sites {row['stage']}: active {row['active']} of cap {row['cap']}, "
              f"{row['dropped']} dropped past the cap")

    def forward():
        return net.backbone_3d(net.vfe(dict(inputs)))["encoded_spconv_tensor"]

    with torch.no_grad():
        forward()
        torch.cuda.synchronize()
        host, device = [], []
        for _ in range(args.iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            forward()
            b.record()
            host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            device.append(a.elapsed_time(b))
    print(f"backbone_3d forward: the host issues it in {np.mean(host):.3f} ms, the card runs it "
          f"in {np.mean(device):.3f} ms (means of {args.iters}) ({smi})")
    net.train()
    back = []
    for _ in range(args.iters + 1):
        out = forward()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out.sum().backward()
        b.record()
        torch.cuda.synchronize()
        back.append(a.elapsed_time(b))
    print(f"backbone_3d backward (train mode, the sum of its output): "
          f"{np.mean(back[1:]):.3f} ms (mean of {args.iters}) ({smi})")

    from torch.profiler import ProfilerActivity, profile

    for label, fn in (("forward", lambda: forward()),
                      ("forward + backward", lambda: forward().sum().backward())):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        print(f"torch.profiler, one backbone_3d {label}:")
        print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))


if __name__ == "__main__":
    main()
