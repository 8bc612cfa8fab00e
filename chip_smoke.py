"""Drive the PyTorch/CUDA port's serving and training paths (the last one
over its own data pipeline) and its wgrad sweep on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Device and build: the card's name and power limit, TF32 switches set and
   printed, every CUDA kernel built from ``com_tpu_torch/csrc`` at once (one
   ``nvcc`` per source, all started together), the tensor-core
   instructions (HGMMA, HMMA) in the SASS of K2 and K2w counted (a source
   with none fails), and in each kernel function of T1-T4
   (``wgrad_variants.cu``: T1, T3 and T4 on ``wgmma``, T2 on ``mma.sync``;
   a function without its instructions fails).
2. Each kernel against its plain PyTorch version on the card, at the shapes
   its path gives it, with the stated tolerance: K1 forward (on a batch
   whose sample 1 is one whole-sample run, and on two real scenes) and its
   fused max backward (the run's gradient split over tied maxima), K2
   forward and dgrad (through
   the autograd.Function against conv3x3_plain's autograd), K2w, T1-T4 at
   (2,468,468,64->64) and (2,468,468,128->64) with th 8 and 16, K3 in both
   modes with its callers' dtypes; then CUDA-event times of the kernel (``ms``: calls as the host
   issues them; ``device_ms``: the calls queued behind a spin kernel, the
   device time of a call even where it is shorter than its launch), the
   plain version and, where one exists, a single library call computing the
   same function.
3. The wgrad-formulation sweep (``com_tpu_torch.tools.perf.
   microbench_wgrad_kernels.run``) at those shapes over T1-T4 and K2w, the
   path of T1-T4: every line within the oracle's tolerance.
4. Small-input references at a 64x64 grid in f32, the card against the CPU
   (plain versions only): the eval step, and one train step (loss, every
   gradient, the batch statistics per channel, the confidence
   accumulators).
5. Serving: CenterPoint-Pillar from the flagship YAML at full width (468x468
   grid, 163,840 points a scene, batch 2, K = 500) with seeded random
   weights behind the port's BatchServer; three single-scene requests (one
   full batch, one padded), responses checked.  Then the device time of
   each stage of one eval step (CUDA events), with ``decode_nms`` split into
   the decode, the score sort and gathers, the rotated IoU, K4,
   ``_kept_slots`` and the rest; and K4 on the boxes the model decodes (its
   valid and kept counts) and on two synthetic (2,500,500) cases, every
   candidate valid: none suppressed, and all suppressed by the first.
6. Training path A, the flagship config at full width: ``train_model`` for
   2 mini-epochs of 3 steps over synthetic Waymo-like batches (2 scenes of
   163,840 presorted points, 500 object slots of which ~100 are real),
   finite losses, gradients (at each epoch's last step, outside the timed
   intervals) and parameters, the epoch-end (3, 96) confidence feedback;
   the step time and its stages (forward, loss, backward, optimizer) by
   CUDA events, peak memory; then the loss must fall over 10 steps on one
   repeated batch.
7. Training path B, ``centerpoint_pillar_car_com1.yaml`` (single-class
   Vehicle, ``UCL: True``, ``MERGE_SCORES: True``): 2 steps, which launch
   K3 in last_wins mode for the COM loss mask.
8. Training path C, the flagship at full width over the port's own data
   pipeline with the curriculum loop closed (``train_path_c``): 8
   synthetic scenes (120,000 ground points, up to 48 objects, the in-memory
   GT database), COM2 GT-paste, world augmentations, range mask, shuffle,
   pillar presort and collate on 2 loader threads, ``DevicePrefetcher``
   with the model's batch keys, 3 epochs of 4 steps.  Gates: fixed shapes;
   each sample's pasted objects as the sampler pasted them less those the
   range mask drops, within the LIMIT_WHOLE_SCENE quota, some in the run;
   every sample pillar-sorted on the card; the sampler holding each epoch's
   card-computed confidences bitwise; COM2's group probabilities off the
   size shares at epochs 1 and 2 (pacing index and centre printed);
   finite losses, gradients and parameters; path A's launch counts a step.
   Prints the host pipeline's own rate, the step time, the main thread's
   wait for a batch and peak memory.
9. Launch counts: every counter is zeroed just before each path (the
   sweep, serving, A, B, C) and read just after, against the calls the sweep
   reports and the expected counts per forward or per step.  The device
   kernels one K3 call issues (1) and one K4 call (2, the pack and the
   sweep), counted by torch.profiler after every timed phase.  Then the
   ``kernels`` line, the card's name and power limit, and the device line
   as the last line.

``python3 chip_smoke.py --profile`` also runs torch.profiler over one sweep
pass over T1-T4, three eval steps and three train steps and prints the
kernel table of each (and the device busy share of the steps); the device
kernels of K3 and K4 are then counted before those sessions, after K4's
check.  It needs no
network and builds into ``build/kernels`` inside the checkout.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIG = "configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml"
BATCH, POINTS, FEATS = 2, 163840, 5
CAR_CONFIG = "configs/waymo_models/com/centerpoint_pillar_car_com1.yaml"
NUM_MAX_OBJS, REAL_OBJS = 500, 100
# kernel launches per serving forward and per train step (K1 forward +
# backward, K2 forward + dgrad, K2w, K3 by mode, K4)
EXPECT_SERVING = {"seg_scan": 2, "conv3x3": 14, "nms": 1}
EXPECT_TRAIN = {"seg_scan": 2, "seg_scan_bwd": 1, "conv3x3": 14, "conv3x3_dgrad": 14,
                "conv3x3_wgrad": 14, "stamp_gauss": 1}
EXPECT_TRAIN_UCL = {**EXPECT_TRAIN, "stamp_last_wins": 1}
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense bf16 tensor / f32 non-tensor
STATS_RTOL = 1e-5  # small train reference: batch statistics, card against CPU
WGRAD_SHAPES = ((2, 468, 468, 64, 64), (2, 468, 468, 128, 64))  # the sweep's (B, H, W, Cin, Cout)
PROFILE_SESSIONS = 3  # tries for a profiling session that sees the device
# path C: epochs, steps an epoch (of BATCH scenes: the dataset holds one
# epoch's scenes), loader threads, seed
C_EPOCHS, C_STEPS, C_WORKERS, C_SEED = 3, 4, 2, 9
WGRAD_THS = (8, 16)
# variant -> (TPU kernel, line of its pallas_call in tools/perf/microbench_wgrad_kernels.py)
WGRAD_VARIANTS = {"gcol": ("T1", 84), "xcol": ("T2", 128), "gt9": ("T3", 175),
                  "gtcol": ("T4", 220)}
WGRAD_SOURCE = "com_tpu_torch/csrc/wgrad_variants.cu"
# T1-T4's partial kernels in the SASS of wgrad_variants.cu: TPU kernel -> (a
# piece of the mangled name of each of its instances, the tensor-core instruction)
WGRAD_SASS = {"T1": ("gtcol_kernelILi1E", "HGMMA"), "T2": ("xcol_kernelI", "HMMA"),
              "T3": ("gt9_kernelI", "HGMMA"), "T4": ("gtcol_kernelILi4E", "HGMMA")}


def waymo_like_points(rng, b, n, pc_range):
    """Waymo-like synthetic scenes: a ground plane, ~1/r density falloff and
    32 object-sized blobs a scene; (b, n, 5) f32 [x, y, z, intensity,
    elongation]."""
    half = min(pc_range[3], pc_range[4])
    r = half * rng.rand(b, n) ** 0.75
    th = rng.uniform(-np.pi, np.pi, (b, n))
    x, y = r * np.cos(th), r * np.sin(th)
    is_ground = rng.rand(b, n) < 0.7
    z = np.where(is_ground, rng.normal(0.0, 0.05, (b, n)),
                 rng.uniform(pc_range[2] * 0.5, pc_range[5] * 0.7, (b, n)))
    n_blob = max(1, n // 4)
    centers = rng.uniform(-half * 0.8, half * 0.8, (b, 32, 2))
    blob_id = rng.randint(0, 32, (b, n_blob))
    off = rng.normal(0.0, 1.2, (b, n_blob, 2))
    x[:, :n_blob] = np.take_along_axis(centers[..., 0], blob_id, axis=1) + off[..., 0]
    y[:, :n_blob] = np.take_along_axis(centers[..., 1], blob_id, axis=1) + off[..., 1]
    z[:, :n_blob] = rng.uniform(0.0, 2.0, (b, n_blob))
    np.clip(x, pc_range[0], pc_range[3] - 1e-3, out=x)
    np.clip(y, pc_range[1], pc_range[4] - 1e-3, out=y)
    np.clip(z, pc_range[2], pc_range[5] - 1e-3, out=z)
    feats = rng.rand(b, n, 2)
    return np.concatenate([x[..., None], y[..., None], z[..., None], feats],
                          axis=2).astype(np.float32)


def cuda_ms(fn, iters, warmup=2):
    """Mean milliseconds a call of fn takes on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters):
    """Mean milliseconds a call takes on the card with the calls queued
    behind a spin kernel (the sweep's ``call_ms(..., queued=True)``): the
    device time of a call, also of one shorter than its launch."""
    from com_tpu_torch.tools.perf.conv_tiles import call_ms

    return call_ms(fn, iters, queued=True)


def check_device_kernels(calls):
    """For each (label, count, fn) the device kernels one call of fn issues
    (torch.profiler over one call after a warm-up call) must number
    ``count``.  Each session first runs ``torch.cuda._sleep`` as a marker
    (one ``spin_kernel``): a session whose trace lacks the marker saw no
    device activity at all, which happens now and then after earlier
    profiling sessions or long runs of threads on the card, and is run
    again, up to ``PROFILE_SESSIONS`` times.  Run after every timed phase (a
    profiling session left the host's launches after it slower)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, count, fn in calls:
        fn()
        torch.cuda.synchronize()
        for attempt in range(1, PROFILE_SESSIONS + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda._sleep(1000)
                fn()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
            if any("spin_kernel" in n for n in names):
                break
            print(f"{label}: profiling session {attempt} saw no device activity (no marker)")
        else:
            raise AssertionError(f"{label}: {PROFILE_SESSIONS} profiling sessions saw no device "
                                 "activity")
        names = [n for n in names if "spin_kernel" not in n]
        ok = len(names) == count
        print(f"{label}: one call issues {len(names)} device kernel(s) "
              f"{[n.replace('(anonymous namespace)::', '').split('(')[0] for n in names]} "
              f"({count}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} issues {len(names)} device kernels, not {count}")


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def presort_by_pillar(pts, pc_range, vsize):
    """Stable sort of each scene's points by flat BEV pillar id, as the
    ``sort_points_by_bev_pillar`` data processor does (out-of-range points
    last), so the VFE can take ``ASSUME_SORTED_POINTS``."""
    pr = np.asarray(pc_range, np.float32)
    vs = np.asarray(vsize, np.float32)
    nx = int(round((pc_range[3] - pc_range[0]) / vsize[0]))
    ny = int(round((pc_range[4] - pc_range[1]) / vsize[1]))
    nz = max(1, int(round((pc_range[5] - pc_range[2]) / vsize[2])))
    out = np.empty_like(pts)
    for b in range(pts.shape[0]):
        vi = np.floor((pts[b, :, :3] - pr[None, :3]) / vs[None, :]).astype(np.int64)
        ok = ((vi[:, 0] >= 0) & (vi[:, 0] < nx) & (vi[:, 1] >= 0) & (vi[:, 1] < ny)
              & (vi[:, 2] >= 0) & (vi[:, 2] < nz))
        out[b] = pts[b][np.argsort(np.where(ok, vi[:, 1] * nx + vi[:, 0], nx * ny),
                                   kind="stable")]
    return out


def waymo_like_batch(rng, b, n, pc_range, vsize, num_classes, m=NUM_MAX_OBJS, real=REAL_OBJS):
    """One training batch: presorted Waymo-like scenes and (b, m, 8) gt_boxes
    with ~``real`` objects a scene (Vehicle/Pedestrian/Cyclist-sized, three
    20 x 15 m ones whose gaussian radius, ~23 cells, passes the stamp's clip
    of 16), plus the COM side arrays made as the JAX package's synthetic
    batch makes them."""
    pts = presort_by_pillar(waymo_like_points(rng, b, n, pc_range), pc_range, vsize)
    gt = np.zeros((b, m, 8), np.float32)
    half = min(pc_range[3], pc_range[4]) * 0.9
    k = rng.randint(real - 10, real + 11, b)
    sizes = np.array([[4.6, 2.0, 1.7], [0.9, 0.9, 1.8], [1.8, 0.8, 1.7]], np.float32)
    for i in range(b):
        cls = rng.randint(1, num_classes + 1, k[i])
        gt[i, :k[i], 0:2] = rng.uniform(-half, half, (k[i], 2))
        gt[i, :k[i], 2] = rng.uniform(-0.5, 1.5, k[i])
        gt[i, :k[i], 3:6] = sizes[cls - 1] * rng.uniform(0.8, 1.25, (k[i], 3))
        gt[i, :3, 3:5] = (20.0, 15.0)
        gt[i, 3, :2] = gt[i, 4, :2] + 0.1  # two objects in one cell
        gt[i, :k[i], 6] = rng.uniform(-np.pi, np.pi, k[i])
        gt[i, :k[i], 7] = cls
    real_mask = gt[..., 7] > 0
    return {"points": pts, "points_mask": np.ones((b, n), bool), "gt_boxes": gt,
            "num_points_in_gt": real_mask.astype(np.float32) * 10,
            "true_object": real_mask.astype(np.float32),
            "occupancy_ratio": rng.rand(b, m).astype(np.float32),
            "facade_type": rng.randint(0, 4, (b, m)).astype(np.float32)}


COUNTERS = {  # counter name -> (module, attribute)
    "seg_scan": ("seg_scan", "launches"), "seg_scan_bwd": ("seg_scan", "bwd_launches"),
    "conv3x3": ("conv2d", "launches"), "conv3x3_dgrad": ("conv2d", "dgrad_launches"),
    "conv3x3_wgrad": ("conv2d", "wgrad_launches"), "stamp_gauss": ("stamp", "gauss_launches"),
    "stamp_last_wins": ("stamp", "last_wins_launches"), "nms": ("nms", "launches"),
    **{f"wgrad_{v}": ("wgrad_variants", f"{v}_launches") for v in WGRAD_VARIANTS},
}


def _ops_module(name):
    import importlib

    return importlib.import_module(f"com_tpu_torch.ops.{name}")


def reset_counters():
    for mod, attr in COUNTERS.values():
        setattr(_ops_module(mod), attr, 0)


def read_counters():
    return {k: getattr(_ops_module(mod), attr) for k, (mod, attr) in COUNTERS.items()}


def check_launches(what, counts, expect, units):
    """Each expected counter must read its count per unit times the units,
    the others 0."""
    per = {k: v / max(units, 1) for k, v in counts.items()}
    print(f"launches per {what}: {json.dumps(per)}")
    for k, v in counts.items():
        if v != expect.get(k, 0) * units:
            raise AssertionError(f"{what}: {k} launched {v} times in {units}, "
                                 f"expected {expect.get(k, 0)} each")


def phase_device_and_build():
    from com_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    paths = _kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(paths)} kernels "
          f"(nvcc each: {json.dumps({k: round(v, 1) for k, v in _kernels.build_seconds.items()})})")
    for name, path in paths.items():
        log = path.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")
    # the bf16 K2 and K2w and T1-T4 must run on the tensor cores: their SASS
    # holds HGMMA (wgmma) or HMMA (mma.sync) instructions
    cuobjdump = str(Path(_kernels._nvcc()).with_name("cuobjdump"))
    for name in ("conv3x3", "conv3x3_wgrad", "wgrad_variants"):
        sass = subprocess.run([cuobjdump, "-sass", str(paths[name])], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        counts = {op: sass.count(f" {op}.") for op in ("HGMMA", "HMMA")}
        ok = any(counts.values())
        print(f"sass: {name} holds {counts['HGMMA']} HGMMA and {counts['HMMA']} HMMA "
              f"instructions {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"csrc/{name}.cu holds no tensor-core instruction")
        if name == "wgrad_variants":
            check_wgrad_sass(sass)
    return smi


def sass_functions(sass):
    """cuobjdump's SASS split by kernel function: mangled name -> its code."""
    parts = sass.split("Function : ")[1:]
    return {p.split(None, 1)[0]: p for p in parts}


def check_wgrad_sass(sass):
    """Each of T1-T4's partial kernels, in both its load branches, holds its
    tensor-core instruction: no variant drifts off the tensor cores unseen."""
    funcs = sass_functions(sass)
    for tn, (piece, op) in WGRAD_SASS.items():
        found = {f: code.count(f" {op}.") for f, code in funcs.items() if piece in f}
        ok = len(found) == 2 and all(found.values())
        print(f"sass: {tn}'s kernels hold {sorted(found.values())} {op} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tn}: {op} in its kernel functions {found}")


def check_seg_scan(dev, entries):
    """K1 forward on the VFE's inputs: two Waymo-like scenes presorted by
    pillar, and the same with sample 1 one run over the whole sample (a
    padded, empty scene; the rows kept comparable with the first port)."""
    from com_tpu_torch.ops import seg_scan
    from com_tpu_torch.ops.voxelize import point_voxel_ids

    pc_range = (-74.88, -74.88, -2.0, 74.88, 74.88, 4.0)
    grid = (468, 468, 1)
    hw = grid[0] * grid[1]
    pts = torch.from_numpy(waymo_like_points(np.random.RandomState(1), BATCH, POINTS,
                                             pc_range)).to(dev)
    flat, _ = point_voxel_ids(pts[..., :3], pc_range, (0.32, 0.32, 6.0), grid)
    scenes = torch.sort(flat, dim=1).values.contiguous()
    padded = scenes.clone()
    padded[1] = hw  # sample 1: one run over the whole sample
    gen = torch.Generator(device=dev).manual_seed(2)
    ones = torch.ones((BATCH, POINTS, 1), device=dev)
    sum_in = torch.cat([pts[..., :3], ones, torch.zeros((BATCH, POINTS, 4), device=dev)],
                       -1).contiguous()
    max_in = torch.randn((BATCH, POINTS, 32), device=dev, generator=gen).to(torch.bfloat16)
    for seg, where in ((padded, ""), (scenes, ", two scenes")):
        for op, vals, label in (("sum", sum_in, f"f32 (2,163840,8){where}"),
                                ("max", max_in, f"bf16 (2,163840,32){where}")):
            got = seg_scan.run_bcast(vals, seg, op)
            want = seg_scan.run_bcast_plain(vals, seg, op)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if op == "max":
                tol = "bit-exact"
                ok = torch.equal(got, want)
            else:
                # f32 rounding of a differently ordered sum, scaled by sum |x|
                scale = seg_scan.run_bcast_plain(vals.abs(), seg, "sum")
                tol = "|err| <= 1e-5 * run sum|x| + 1e-6"
                ok = bool((err <= 1e-5 * scale + 1e-6).all())
            if not ok:
                raise AssertionError(f"K1 {op} {label} disagrees with its plain version")
            ms = cuda_ms(lambda: seg_scan.run_bcast(vals, seg, op), 50)
            dev_ms = device_ms(lambda: seg_scan.run_bcast(vals, seg, op), 50)
            plain_ms = cuda_ms(lambda: seg_scan.run_bcast_plain(vals, seg, op), 10)
            bms, by = bound_ms(nbytes(vals, seg, got), vals.numel(), torch.float32)
            print(f"K1 run_bcast {op} {label}: max_abs_err={err.max().item():.3e} ({tol}) ok; "
                  f"{ms:.4f} ms a call as the host issues them, {dev_ms:.4f} ms queued on the "
                  f"card, bound {bms:.5f} ms")
            entries.append(dict(name=f"seg_scan.run_bcast {op} {label}", route="cuda",
                                source="com_tpu_torch/csrc/seg_scan.cu",
                                replaces="com_tpu/ops/pallas/seg_scan.py:122",
                                max_abs_err=err.max().item(), ms=ms, device_ms=dev_ms,
                                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
                                kernel="seg_scan"))


def check_conv3x3(dev, entries):
    import torch.nn.functional as F

    from com_tpu_torch.ops import conv2d

    gen = torch.Generator(device=dev).manual_seed(3)
    for h, c in ((468, 64), (234, 128), (117, 256)):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((BATCH, h, h, c), device=dev, generator=gen).to(dt)
            w = (torch.randn((3, 3, c, c), device=dev, generator=gen) / math.sqrt(9 * c)).to(dt)
            got = conv2d.conv3x3(x, w)
            want = conv2d.conv3x3_plain(x, w)
            absref = conv2d.conv3x3_plain(x.float().abs(), w.float().abs())
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            # f32: summation order only; bf16: that, then one rounding to bf16
            rnd = 0.0 if dt == torch.float32 else 2.0 ** -7
            ok = bool((err <= 1e-5 * absref + rnd * want.float().abs()).all())
            label = f"{str(dt).split('.')[-1]} (2,{h},{h},{c}->{c})"
            print(f"K2 conv3x3 {label}: max_abs_err={err.max().item():.3e} "
                  f"(|err| <= 1e-5 * conv(|x|,|w|) + {rnd:g} * |plain|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2 {label} disagrees with its plain version")
            ms = cuda_ms(lambda: conv2d.conv3x3(x, w), 10)
            dev_ms = device_ms(lambda: conv2d.conv3x3(x, w), 10)
            plain_ms = cuda_ms(lambda: conv2d.conv3x3_plain(x, w), 5)
            xc = x.permute(0, 3, 1, 2)  # NHWC storage = channels_last NCHW view
            wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            lib_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), 10)
            flops = 2 * 9 * c * c * BATCH * h * h  # the serving path runs the bf16 case
            bms, by = bound_ms(nbytes(x, w, got), flops, dt)
            entries.append(dict(name=f"conv2d.conv3x3 {label}", route="cuda",
                                source="com_tpu_torch/csrc/conv3x3.cu",
                                replaces="com_tpu/ops/pallas/conv2d.py:208",
                                max_abs_err=err.max().item(), ms=ms,
                                device_ms=dev_ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, library_ms=lib_ms, kernel="conv3x3"))


def check_seg_scan_bwd(dev, entries):
    """K1's backward: the max over pillar runs in bf16 at (2, 163840, 32)
    with many tied maxima, against run_bcast_plain's autograd; timed as the
    one fused launch the backward makes."""
    from com_tpu_torch.ops import seg_scan
    from com_tpu_torch.ops.voxelize import point_voxel_ids

    pc_range = (-74.88, -74.88, -2.0, 74.88, 74.88, 4.0)
    pts = torch.from_numpy(waymo_like_points(np.random.RandomState(11), BATCH, POINTS,
                                             pc_range)).to(dev)
    flat, _ = point_voxel_ids(pts[..., :3], pc_range, (0.32, 0.32, 6.0), (468, 468, 1))
    seg = torch.sort(flat, dim=1).values.contiguous()
    gen = torch.Generator(device=dev).manual_seed(12)
    # values on a coarse grid, so most pillars hold tied maxima
    vals = (torch.randn((BATCH, POINTS, 32), device=dev, generator=gen) * 2).round() / 2
    vals = vals.to(torch.bfloat16)
    g = torch.randn((BATCH, POINTS, 32), device=dev, generator=gen).to(torch.bfloat16)
    runs = []
    for fn in (seg_scan.run_bcast, seg_scan.run_bcast_plain):
        v = vals.clone().requires_grad_()
        out = fn(v, seg, "max")
        runs.append((v, out, torch.autograd.grad(out, v, g, retain_graph=True)[0]))
    torch.cuda.synchronize()
    (v, out, got), (pv, pout, want) = runs
    scale = seg_scan.run_bcast_plain(g.float().abs(), seg, "sum")
    err = (got.float() - want.float()).abs()
    at_max = (vals == out).to(torch.float32)
    tied = int(((at_max > 0) & (seg_scan.run_bcast_plain(at_max, seg, "sum") > 1)).sum())
    ok = bool((err <= 1e-5 * scale + 2.0 ** -7 * want.float().abs() + 1e-6).all())
    print(f"K1 run_bcast max backward bf16 (2,163840,32): {tied} (row, channel) maxima tied "
          f"within their pillar; "
          f"max_abs_err={err.max().item():.3e} (|err| <= 1e-5 * run sum|g| + 2^-7 * |plain|,"
          f" two bf16 roundings) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K1 backward disagrees with its plain version")
    # the call the backward makes: one fused launch (out detached: the
    # forward's output as autograd saved it)
    fwd_out = out.detach()
    ms = cuda_ms(lambda: seg_scan.run_bcast_max_bwd(g, vals, fwd_out, seg), 50)
    dev_ms = device_ms(lambda: seg_scan.run_bcast_max_bwd(g, vals, fwd_out, seg), 50)
    plain_ms = cuda_ms(lambda: seg_scan.run_bcast_max_bwd_plain(g, vals, fwd_out, seg), 10)
    # reads g, vals, out and seg once, writes dvals; a few f32 operations an element
    bms, by = bound_ms(nbytes(g, vals, out, seg, got), 6 * g.numel(), torch.float32)
    print(f"K1 max backward: {ms:.4f} ms a fused call as the host issues them, {dev_ms:.4f} ms "
          f"queued on the card, bound {bms:.5f} ms")
    entries.append(dict(name="seg_scan.run_bcast max backward bf16 (2,163840,32)", route="cuda",
                        source="com_tpu_torch/csrc/seg_scan.cu",
                        replaces="com_tpu/ops/pallas/seg_scan.py:284",
                        max_abs_err=err.max().item(), ms=ms,
                        device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by, library_ms=None, kernel="seg_scan_bwd"))


def check_conv3x3_backward(dev, entries):
    """K2 dgrad (K2 on the output gradient with the rotated kernel) checked
    through the autograd.Function and timed as the call its backward makes
    (``conv3x3_dgrad``), and K2w, at the backbone's three shapes."""
    from com_tpu_torch.ops import conv2d

    gen = torch.Generator(device=dev).manual_seed(13)
    for h, c in ((468, 64), (234, 128), (117, 256)):
        flops = 2 * 9 * c * c * BATCH * h * h
        x0 = torch.randn((BATCH, h, h, c), device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn((3, 3, c, c), device=dev, generator=gen) / math.sqrt(9 * c))
        w = w.to(torch.bfloat16)
        g = torch.randn((BATCH, h, h, c), device=dev, generator=gen).to(torch.bfloat16)
        runs = []
        for fn in (conv2d.conv3x3, conv2d.conv3x3_plain):
            x = x0.clone().requires_grad_()
            y = fn(x, w)
            runs.append((x, y, torch.autograd.grad(y, x, g, retain_graph=True)[0]))
        torch.cuda.synchronize()
        (x, y, got), (px, py, want) = runs
        absref = conv2d.conv3x3_plain(g.float().abs(), conv2d.rotate_kernel(w.float().abs()))
        err = (got.float() - want.float()).abs()
        ok = bool((err <= 1e-5 * absref + 2.0 ** -7 * want.float().abs()).all())
        label = f"bf16 (2,{h},{h},{c}->{c})"
        print(f"K2 conv3x3 dgrad {label}: max_abs_err={err.max().item():.3e} "
              f"(|err| <= 1e-5 * conv(|g|,|w_rot|) + 2^-7 * |plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2 dgrad {label} disagrees with its plain version")
        # the call the backward makes: K2 on g with the rotated kernel
        ms = cuda_ms(lambda: conv2d.conv3x3_dgrad(g, w), 10)
        dev_ms = device_ms(lambda: conv2d.conv3x3_dgrad(g, w), 10)
        plain_ms = cuda_ms(lambda: conv2d.conv3x3_plain(g, conv2d.rotate_kernel(w)), 5)
        gc = g.permute(0, 3, 1, 2)  # NHWC storage = channels_last NCHW view
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib_ms = cuda_ms(lambda: torch.nn.grad.conv2d_input((BATCH, c, h, h), wc, gc,
                                                            padding=1), 10)
        bms, by = bound_ms(nbytes(g, w, got), flops, torch.bfloat16)
        entries.append(dict(name=f"conv2d.conv3x3 dgrad {label}", route="cuda",
                            source="com_tpu_torch/csrc/conv3x3.cu",
                            replaces="com_tpu/ops/pallas/conv2d.py:544",
                            max_abs_err=err.max().item(), ms=ms,
                            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms,
                            bound_by=by, library_ms=lib_ms, kernel="conv3x3_dgrad"))
        del runs, x, y, px, py, got, want, absref, err

        for dt in (torch.float32, torch.bfloat16):
            xd, gd = x0.to(dt), g.to(dt)
            got = conv2d.conv3x3_wgrad(xd, gd)
            want = conv2d.conv3x3_wgrad_plain(xd, gd)
            absref = conv2d.conv3x3_wgrad_plain(xd.float().abs(), gd.float().abs())
            torch.cuda.synchronize()
            err = (got - want).abs()
            rnd = 0.0 if dt == torch.float32 else 2.0 ** -8
            ok = bool((err <= 1e-5 * absref + rnd * want.abs()).all())
            label = f"{str(dt).split('.')[-1]} (2,{h},{h},{c}->{c})"
            print(f"K2w conv3x3_wgrad {label}: max_abs_err={err.max().item():.3e} "
                  f"(|err| <= 1e-5 * sum|x||g| + {rnd:g} * |plain|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2w {label} disagrees with its plain version")
            ms = cuda_ms(lambda: conv2d.conv3x3_wgrad(xd, gd), 10)
            dev_ms = device_ms(lambda: conv2d.conv3x3_wgrad(xd, gd), 10)
            plain_ms = cuda_ms(lambda: conv2d.conv3x3_wgrad_plain(xd, gd), 5)
            xc, gc = xd.permute(0, 3, 1, 2), gd.permute(0, 3, 1, 2)
            lib_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(xc, (c, c, 3, 3), gc,
                                                                 padding=1), 10)
            bms, by = bound_ms(nbytes(xd, gd, got), flops, dt)
            entries.append(dict(name=f"conv2d.conv3x3_wgrad {label}", route="cuda",
                                source="com_tpu_torch/csrc/conv3x3_wgrad.cu",
                                replaces="com_tpu/ops/pallas/conv2d.py:235",
                                max_abs_err=err.max().item(), ms=ms,
                                device_ms=dev_ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                                kernel="conv3x3_wgrad"))
            del got, want, absref, err


def check_wgrad_variants(dev, entries):
    """T1-T4 against their plain versions at the sweep's shapes and th, with
    the kernel's, the plain version's and conv2d_weight's times."""
    from com_tpu_torch.ops import wgrad_variants as wv

    gen = torch.Generator(device=dev).manual_seed(17)
    for b, h, w, cin, cout in WGRAD_SHAPES:
        x = (torch.randn((b, h, w, cin), device=dev, generator=gen) * 0.3).to(torch.bfloat16)
        g = (torch.randn((b, h, w, cout), device=dev, generator=gen) * 0.3).to(torch.bfloat16)
        absref = wv.oracle(x.abs(), g.abs())
        xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # channels_last NCHW views
        lib_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(xc, (cout, cin, 3, 3), gc,
                                                             padding=1), 10)
        flops = 2 * 9 * cin * cout * b * h * w
        label = f"bf16 ({b},{h},{w},{cin}->{cout})"
        for th in WGRAD_THS:
            for v, (tn, line) in WGRAD_VARIANTS.items():
                fn, plain = wv.VARIANTS[v]
                got = fn(x, g, th)
                want = plain(x, g, th)
                torch.cuda.synchronize()
                err = (got - want).abs()
                ok = bool((err <= 1e-5 * absref).all())
                name = f"wgrad_variants.wgrad_{v} ({tn}) th={th} {label}"
                print(f"{name}: max_abs_err={err.max().item():.3e} (|err| <= 1e-5 * sum|x||g|) "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{tn} th={th} {label} disagrees with its plain version")
                ms = cuda_ms(lambda: fn(x, g, th), 20)
                dev_ms = device_ms(lambda: fn(x, g, th), 20)
                plain_ms = cuda_ms(lambda: plain(x, g, th), 3, warmup=1)
                bms, by = bound_ms(nbytes(x, g, got), flops, torch.bfloat16)
                entries.append(dict(name=name, route="cuda", source=WGRAD_SOURCE,
                                    replaces=f"tools/perf/microbench_wgrad_kernels.py:{line}",
                                    max_abs_err=err.max().item(), ms=ms,
                                    device_ms=dev_ms, plain_ms=plain_ms,
                                    bound_ms=bms, bound_by=by, library_ms=lib_ms,
                                    kernel=f"wgrad_{v}"))
                del got, want, err
        del x, g, absref, xc, gc
    torch.cuda.empty_cache()


def wgrad_sweep(dev, iters=3):
    """The port's sweep over T1-T4 and K2w (v0) at full shapes: every row
    within the oracle's tolerance, and each kernel launched as often as the
    sweep says it called it."""
    from com_tpu_torch.tools.perf import microbench_wgrad_kernels as mb

    torch.cuda.synchronize()
    reset_counters()
    rows = mb.run(WGRAD_SHAPES, WGRAD_THS, ("v0", *WGRAD_VARIANTS), iters, device=dev)
    torch.cuda.synchronize()
    counts = read_counters()
    expect = {}
    for r in rows:
        key = "conv3x3_wgrad" if r["variant"] == "v0" else f"wgrad_{r['variant']}"
        expect[key] = expect.get(key, 0) + r["calls"]
    bad = [r["name"] for r in rows if not r["ok"]]
    print(f"wgrad sweep: {len(rows)} lines, launches {json.dumps(counts)}; "
          f"every line within 1e-5 * sum|x||g| of the oracle: {'ok' if not bad else bad}")
    if bad:
        raise AssertionError(f"wgrad sweep: {bad} disagree with the oracle")
    for k, v in counts.items():
        if v != expect.get(k, 0):
            raise AssertionError(f"wgrad sweep: {k} launched {v} times, the sweep called it "
                                 f"{expect.get(k, 0)} times")
    return counts


def profile_wgrad_sweep(dev):
    """torch.profiler over one sweep pass over T1-T4 (one timed call each)."""
    from torch.profiler import ProfilerActivity, profile

    from com_tpu_torch.tools.perf import microbench_wgrad_kernels as mb

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mb.run(WGRAD_SHAPES, WGRAD_THS, tuple(WGRAD_VARIANTS), 1, device=dev)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))


def check_stamp(dev, entries, calls):
    """K3 in both modes on the training path's canvas (2, 3, 468, 468) with
    500 object slots: ~100 real objects a sample, some invalid slots among
    them, radii past the clip, overlapping windows, centers on the edges.
    The inputs have the dtypes the path's callers pass (int32 ids, no values
    for the heatmap targets; int64 classes and f32 weights for the COM loss
    mask).  Each mode's call goes into ``calls`` with the one device kernel
    it must issue (counted by ``check_device_kernels`` at the end)."""
    from com_tpu_torch.ops import stamp

    rng = np.random.RandomState(14)
    b, n, c, h, w = BATCH, NUM_MAX_OBJS, 3, 468, 468
    centers = np.stack([rng.randint(0, w, (b, n)), rng.randint(0, h, (b, n))], -1)
    centers[:, :20] = centers[:, 20:40]  # overlapping windows, same centers
    centers[:, 40, 0] = 0
    centers[:, 41, 1] = h - 1
    radii = rng.randint(2, 24, (b, n))
    cls = rng.randint(0, c, (b, n))
    values = rng.uniform(0.5, 1.5, (b, n)).astype(np.float32)
    valid = np.zeros((b, n), bool)
    valid[:, :REAL_OBJS] = rng.rand(b, REAL_OBJS) > 0.05
    cen, rad, cl32, val, vld = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        centers.astype(np.int32), radii.astype(np.int32), cls.astype(np.int32), values, valid))
    r = np.clip(radii, 0, 16)
    cells = int(((2 * r + 1) ** 2 * valid).sum())
    for mode, fill, args in (("gauss", 0.0, (cen, rad, cl32, None, vld)),
                             ("last_wins", 1.0, (cen, rad, cl32.long(), val, vld))):
        got = stamp.stamp_windows(*args, c, h, w, mode, fill=fill)
        want = stamp.stamp_windows_plain(*args, c, h, w, mode, fill=fill)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        if mode == "gauss":
            bi, oi = np.nonzero(valid)
            centre = got[tuple(torch.as_tensor(a, device=dev) for a in (
                bi, cls[bi, oi], centers[bi, oi, 1], centers[bi, oi, 0]))]
            ok = err <= 2e-6 and bool((centre == 1.0).all())
            tol = "<= 2e-6 (analytic f32 exp against the f64-built table), centers exactly 1.0"
        else:
            ok, tol = err == 0.0, "exact"
        print(f"K3 stamp_windows {mode} (2,3,468,468) {int(valid.sum())} objects in "
              f"{b * n} slots: max_abs_err={err:.3e} ({tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K3 {mode} disagrees with its plain version")
        calls.append((f"K3 stamp_windows {mode}", 1, lambda a=args, m=mode, f=fill:
                      stamp.stamp_windows(*a, c, h, w, m, fill=f)))
        ms = cuda_ms(lambda: stamp.stamp_windows(*args, c, h, w, mode, fill=fill), 50)
        dev_ms = device_ms(lambda: stamp.stamp_windows(*args, c, h, w, mode, fill=fill), 50)
        plain_ms = cuda_ms(lambda: stamp.stamp_windows_plain(*args, c, h, w, mode, fill=fill), 10)
        print(f"K3 {mode}: {ms:.4f} ms a call as the host issues them, {dev_ms:.4f} ms queued on "
              f"the card")
        # the canvas written once, the objects read once; an exp and a max
        # (gauss) or one index max (last_wins) per window cell of a valid object
        bms, by = bound_ms(nbytes(got, *(a for a in args if a is not None)),
                           cells * (2 if mode == "gauss" else 1), torch.float32)
        entries.append(dict(name=f"stamp.stamp_windows {mode} (2,3,468,468) 500 slots",
                            route="cuda", source="com_tpu_torch/csrc/stamp.cu",
                            replaces="com_tpu/ops/pallas/stamp.py:137", max_abs_err=err, ms=ms,
                            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            library_ms=None, kernel=f"stamp_{mode}"))


def load_config(grid=None, config=CONFIG):
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / config))
    vsize = [0.32, 0.32, 6.0]
    pc_range = list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    if grid is None:
        grid = (468, 468, 1)
    else:  # a smaller scene for a smaller grid
        pc_range = [-grid[0] * vsize[0] / 2, -grid[1] * vsize[1] / 2, -2.0,
                    grid[0] * vsize[0] / 2, grid[1] * vsize[1] / 2, 4.0]
    return cfg, DatasetMeta(cfg.CLASS_NAMES, pc_range, vsize, grid, FEATS)


def check_nms(dev, entries, calls, net, cfg, meta):
    """K4 on the (2, 500, 500) overlap matrix of boxes the model decodes, and
    on two synthetic ones with every candidate valid: nothing suppressed
    (each box overlaps only itself, the longest run of kept candidates) and
    everything suppressed by the first.  Each case's call goes into
    ``calls`` with the two device kernels it must issue."""
    from com_tpu_torch.models.dense_heads.center_head import decode_center_boxes
    from com_tpu_torch.ops import nms
    from com_tpu_torch.ops.iou import boxes_iou_bev

    post = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    pts = torch.from_numpy(waymo_like_points(np.random.RandomState(4), BATCH, POINTS,
                                             meta.point_cloud_range)).to(dev)
    with torch.no_grad():
        out = net({"points": pts, "points_mask": torch.ones((BATCH, POINTS), dtype=torch.bool,
                                                            device=dev)})
        boxes, scores, _, valid = decode_center_boxes(
            out["pred_dicts"][0], (1, 2, 3), meta.point_cloud_range, meta.voxel_size, 1,
            k=int(post.MAX_OBJ_PER_SAMPLE), score_thresh=float(post.SCORE_THRESH),
            post_center_limit_range=post.POST_CENTER_LIMIT_RANGE)
        order = nms._score_order(scores, valid)
        sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 7))
        sv = torch.gather(valid, 1, order).contiguous()
        over = (boxes_iou_bev(sb, sb) > float(post.NMS_CONFIG.NMS_THRESH)).contiguous()
    k = over.shape[-1]
    eye = torch.eye(k, dtype=torch.bool, device=dev).repeat(BATCH, 1, 1)
    first = eye.clone()
    first[:, 0] = True
    every = torch.ones_like(sv)
    cases = (("decoded boxes", over, sv, ""), ("all valid, none suppressed", eye, every, ", none"),
             ("all valid, all suppressed by the first", first, every, ", first"))
    for label, ov, vd, tag in cases:
        got = nms.greedy_suppress(ov, vd)
        want = nms.greedy_suppress_plain(ov, vd)
        torch.cuda.synchronize()
        err = (got != want).sum().item()
        ms = cuda_ms(lambda: nms.greedy_suppress(ov, vd), 50)
        dev_ms = device_ms(lambda: nms.greedy_suppress(ov, vd), 50)
        print(f"K4 greedy_suppress (2,{k},{k}) {label}: {int(vd.sum())} valid, {int(got.sum())} "
              f"kept, {err} mismatches (exact); {ms:.4f} ms a call as the host issues them, "
              f"{dev_ms:.4f} ms queued on the card {'ok' if err == 0 else 'FAIL'}")
        if err:
            raise AssertionError(f"K4 on {label} disagrees with its plain version")
        # the pack and the sweep
        calls.append((f"K4 greedy_suppress {label}", 2,
                      lambda a=ov, v=vd: nms.greedy_suppress(a, v)))
        plain_ms = cuda_ms(lambda: nms.greedy_suppress_plain(ov, vd), 3, warmup=1)
        bms, by = bound_ms(nbytes(ov, vd, got), ov.numel(), torch.float32)
        entries.append(dict(name=f"nms.greedy_suppress (2,{k},{k}){tag}", route="cuda",
                            source="com_tpu_torch/csrc/nms.cu",
                            replaces="com_tpu/ops/pallas/nms_kernel.py:56",
                            max_abs_err=float(err), ms=ms,
                            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms,
                            bound_by=by, library_ms=None, kernel="nms"))


def check_small_reference(dev):
    """The eval step at a 64x64 grid in f32 on the card (kernels) against the
    same weights on the CPU (plain versions)."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta = load_config(grid=(64, 64, 1))
    cfg.MODEL.MIXED_PRECISION = False
    pts = waymo_like_points(np.random.RandomState(5), BATCH, 4096, meta.point_cloud_range)
    batch = {"points": pts, "points_mask": np.ones((BATCH, 4096), bool)}
    outs = []
    for d in (dev, "cpu"):
        net = build_network(cfg.MODEL, meta, device=d, seed=7)
        step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)
        outs.append([t.cpu().numpy() for t in step(batch)])
    (gb, gs, _, gv), (cb, cs, _, cv) = outs
    worst = 0.0
    for i in range(BATCH):
        a = np.concatenate([gb[i][gv[i]], gs[i][gv[i]][:, None]], -1)
        b = np.concatenate([cb[i][cv[i]], cs[i][cv[i]][:, None]], -1)
        if len(a) != len(b):
            raise AssertionError(f"small reference: {len(a)} vs {len(b)} detections")
        if len(a):
            d = np.abs(a[:, None] - b[None]).max(-1)
            worst = max(worst, float(d.min(1).max()))
    ok = worst <= 1e-3 and bool((gv == cv).all())
    print(f"small reference (64x64 f32, card vs CPU): {int(gv.sum())} detections, "
          f"worst box/score diff {worst:.2e} (<= 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's eval step disagrees with the CPU reference")


def serve(dev):
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.serving.server import BatchServer
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta = load_config()
    post = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    thresh = float(post.SCORE_THRESH)
    net = build_network(cfg.MODEL, meta, device=dev, seed=0)
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    scenes = waymo_like_points(np.random.RandomState(6), 3, POINTS, meta.point_cloud_range)
    step({"points": scenes[:2], "points_mask": np.ones((2, POINTS), bool)})  # warm-up
    torch.cuda.synchronize()

    latencies = []

    def timed_step(batch):
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        return out

    server = BatchServer(timed_step, {"points": ((BATCH, POINTS, FEATS), "float32")},
                         max_wait_ms=200.0, score_thresh=thresh, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    try:
        futures = [server.submit(scenes[i]) for i in range(3)]
        results = [f.result(timeout=600) for f in futures]
    finally:
        server.close()
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    forwards = server.stats.batches
    print(f"serving: {len(results)} requests in {forwards} batches "
          f"({server.stats.scenes_padded} padded scene), per-batch latency ms "
          f"{[round(x, 2) for x in latencies]}, max_memory_allocated {peak / 2**30:.2f} GiB")
    for i, r in enumerate(results):
        n = len(r["scores"])
        ok = (np.isfinite(r["boxes"]).all() and r["boxes"].shape == (n, 7)
              and (r["scores"] >= thresh).all() and np.isin(r["labels"], [1, 2, 3]).all())
        print(f"  request {i}: {n} detections, finite boxes and scores >= {thresh}: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"request {i} returned a malformed response")
    if forwards != 2:
        raise AssertionError(f"serving ran {forwards} forwards, expected 2")
    check_launches("serving forward", counts, EXPECT_SERVING, forwards)
    return counts, net, step, cfg, meta, scenes


NMS_PARTS = ("decode", "sort_gathers", "iou", "k4", "kept_slots", "rest")


def _mark_nms_steps(mark):
    """Wrap the steps of ``nms_bev`` so that each records a CUDA event by
    ``mark(label)``: "sort" before the score sort (the gathers follow it),
    "iou" before the rotated IoU over (B, K, K, 24, 2), "k4" and "k4_end"
    around K4, "rest" after ``_kept_slots``.  Returns the function that
    undoes the wrapping."""
    from com_tpu_torch.ops import nms

    orig = {n: getattr(nms, n) for n in ("_score_order", "boxes_iou_bev", "greedy_suppress",
                                         "_kept_slots")}

    def wrap(name, before=None, after=None):
        def fn(*args, **kw):
            if before:
                mark(before)
            out = orig[name](*args, **kw)
            if after:
                mark(after)
            return out
        return fn

    nms._score_order = wrap("_score_order", before="sort")
    nms.boxes_iou_bev = wrap("boxes_iou_bev", before="iou")
    nms.greedy_suppress = wrap("greedy_suppress", before="k4", after="k4_end")
    nms._kept_slots = wrap("_kept_slots", after="rest")
    return lambda: [setattr(nms, n, f) for n, f in orig.items()]


def stage_breakdown(net, step, scenes, iters=5):
    """Where one full-size eval step spends its time on the card: CUDA
    events recorded by forward hooks at each slot's start and end, mean over
    ``iters`` steps.  "upload" is the host-to-card copy of the batch,
    "decode_nms" the top-K decode and NMS after the head, itself split into
    the decode, the score sort and gathers, the rotated IoU, K4,
    ``_kept_slots`` and the rest (the final gathers)."""
    marks, sub = [], []
    slots = ("vfe", "backbone_2d", "dense_head")

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    def sub_mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        sub.append((label, ev))

    hooks = [h for s in slots for h in (getattr(net, s).register_forward_pre_hook(mark),
                                        getattr(net, s).register_forward_hook(mark))]
    undo = _mark_nms_steps(sub_mark)
    batch = {"points": scenes[:2], "points_mask": np.ones((2, POINTS), bool)}
    names = ("upload", "vfe", "map", "backbone_2d", "map", "dense_head", "decode_nms")
    sums = dict.fromkeys(names, 0.0)
    parts = dict.fromkeys(NMS_PARTS, 0.0)
    try:
        for _ in range(iters):
            marks.clear()
            sub.clear()
            mark()
            step(batch)
            mark()
            torch.cuda.synchronize()
            for name, a, b in zip(names, marks, marks[1:]):
                sums[name] += a.elapsed_time(b) / iters
            labels = [label for label, _ in sub]
            if labels != ["sort", "iou", "k4", "k4_end", "rest"]:
                raise AssertionError(f"decode_nms ran its steps as {labels}")
            seq = [marks[-2], *(ev for _, ev in sub), marks[-1]]
            for name, a, b in zip(NMS_PARTS, seq, seq[1:]):
                parts[name] += a.elapsed_time(b) / iters
    finally:
        undo()
        for h in hooks:
            h.remove()
    sums.pop("map")  # the gaps between slots
    total = sum(sums.values())
    print(f"stage ms (one eval step, batch {BATCH}, mean of {iters}): "
          f"{json.dumps({k: round(v, 3) for k, v in sums.items()})} total {total:.3f}")
    print(f"decode_nms ms (mean of {iters}): "
          f"{json.dumps({k: round(v, 4) for k, v in parts.items()})}")


def profile_step(step, scenes):
    """torch.profiler over three eval steps: device busy share of the
    window and the kernels by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = {"points": scenes[:2], "points_mask": np.ones((2, POINTS), bool)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:  # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    print(f"profile: 3 eval steps in {wall_us / 1e3:.3f} ms wall, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} %), {len(spans)} device events")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))


def shift_norm_biases(net, by=3.0):
    """Move every norm's bias up by ``by``: with almost no ReLU input near 0,
    a rounding-sized difference between two devices flips no ReLU, and the
    gradients can be compared element by element."""
    from com_tpu_torch.models.layers import BatchNorm

    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, BatchNorm):
                mod.bias.add_(by)
    return net


def build_trainer(dev, cfg, meta, steps_per_epoch, seed=0, **step_kw):
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.optim import build_optimizer
    from com_tpu_torch.train.state import TrainState
    from com_tpu_torch.train.step import conf_shape_for, make_train_step

    names = list(cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, meta, device=dev, seed=seed)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION,
                             int(cfg.OPTIMIZATION.NUM_EPOCHS) * steps_per_epoch, steps_per_epoch)
    state = TrainState.create(net, opt, len(cfg.MODEL.DENSE_HEAD.CLASS_NAMES_EACH_HEAD),
                              conf_shape_for(cfg.MODEL, names), device=dev)
    step = make_train_step(net, cfg.MODEL, names, meta, opt, meta.grid_size[1::-1], device=dev,
                           **step_kw)
    return net, opt, state, step


def stat_err(s0, s1, norm):
    """Per channel, the two runs' batch mean and variance of one norm apart,
    relative to the second moment E[x^2] = var + mean^2 (the mean against its
    square root): the scale of the f32 sums both are computed from."""
    mean, var = s1[f"{norm}.running_mean"], s1[f"{norm}.running_var"]
    second = (var + mean * mean).clamp_min(1e-12)
    return torch.maximum((s0[f"{norm}.running_mean"] - mean).abs() / second.sqrt(),
                         (s0[f"{norm}.running_var"] - var).abs() / second)


def check_small_train_reference(dev):
    """One train step at a 64x64 grid in f32 (UCL on, so both K3 modes run)
    on the card (kernels) against the same weights on the CPU (plain
    versions): loss, every gradient, the updated batch statistics and the
    confidence accumulators."""
    from com_tpu_torch.models.layers import BatchNorm

    cfg, meta = load_config(grid=(64, 64, 1))
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True
    cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM.UCL = True
    cfg.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 64
    batch = waymo_like_batch(np.random.RandomState(15), BATCH, 4096, meta.point_cloud_range,
                             meta.voxel_size, 3, m=64, real=20)
    runs = []
    for d in (dev, "cpu"):
        net, _, state, step = build_trainer(d, cfg, meta, 1, seed=7)
        shift_norm_biases(net)
        running = {k: v for k, v in net.state_dict().items() if "running" in k}
        for v in running.values():  # from 0, one update is (1 - 0.99) x the batch statistic
            v.zero_()
        loss = step.loss_fn(state, batch, 0)[0]
        loss.backward()
        grads = {k: p.grad.float().cpu().clone() for k, p in net.named_parameters()}
        stats = {k: v.cpu() / (1 - BatchNorm.MOMENTUM) for k, v in running.items()}
        runs.append((float(loss.detach()), grads, stats))
        net.zero_grad(set_to_none=True)
        state, _ = step(state, batch, 0)
        runs[-1] += (state.conf_sum.cpu(), state.conf_cnt.cpu())
    (l0, g0, s0, cs0, cc0), (l1, g1, s1, cs1, cc1) = runs
    gmax = max(float(g.abs().max()) for g in g1.values())
    gerr = max(float(((g0[k] - g1[k]).abs() / (1e-3 * g1[k].abs().max() + 1e-5 * gmax)).max())
               for k in g1)
    serr = max(float(stat_err(s0, s1, k.rsplit(".", 1)[0]).max())
               for k in s1 if k.endswith("running_mean"))
    ok = (abs(l0 - l1) <= 1e-4 * abs(l1) and gerr <= 1.0 and serr <= STATS_RTOL
          and torch.equal(cc0, cc1) and float((cs0 - cs1).abs().max()) <= 1e-4
          and float(cc1.sum()) > 0)
    print(f"small train reference (64x64 f32, card vs CPU): loss {l0:.6f} vs {l1:.6f}; "
          f"{len(g1)} gradients within 1e-3 of their max + 1e-5 of the net's max "
          f"(worst at {gerr:.3f} of that); batch statistics rel {serr:.2e} "
          f"(<= {STATS_RTOL:g}); "
          f"confidence counts {int(cc1.sum())} equal {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's train step disagrees with the CPU reference")


class SyntheticLoader:
    """The duck-typed loader ``train_model`` reads: ``set_epoch``, iteration
    over host batches, ``dataset.set_confidence_groups`` (which records)."""

    class _Dataset:
        def __init__(self):
            self.confidence_groups = []

        def set_confidence_groups(self, conf):
            self.confidence_groups.append(np.array(conf))

    def __init__(self, batches, steps):
        self.batches, self.steps = batches, steps
        self.dataset = self._Dataset()

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        return (self.batches[i % len(self.batches)] for i in range(self.steps))


def run_training(dev, label, cfg, meta, loader, epochs, steps, expect_launches,
                 step_wrap=None, epoch_hook=None):
    """``train_model`` over ``loader`` with the device batch keys of the
    model, from a fresh trainer; finite losses, gradients (at each epoch's
    last step, outside the timed intervals) and parameters, and the launch
    counts per step.  ``step_wrap(step)`` may wrap the train step;
    ``epoch_hook(epoch, state)`` runs at each epoch's first step.  Returns
    the counts, the trainer and the step times (CUDA events between steps,
    the first of each epoch left out)."""
    from com_tpu_torch.train.loop import train_model
    from com_tpu_torch.train.step import device_batch_keys

    net, opt, state, step = build_trainer(dev, cfg, meta, steps)
    run_step = step_wrap(step) if step_wrap else step
    params = [p for p in net.parameters()]
    marks, losses, finite = [], [], []

    def all_finite(tensors):
        return torch.stack([torch.isfinite(t).all() for t in tensors]).all()

    def hook(epoch, it, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((epoch, ev))
        losses.append(metrics["loss"])
        if it == 0 and epoch_hook is not None:
            epoch_hook(epoch, state)
        if it == steps - 1:  # the interval after an epoch's last step is not timed
            finite.append(all_finite(p.grad for p in params))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    t0 = time.perf_counter()
    state, iters = train_model(run_step, state, loader, num_epochs=epochs, metric_hook=hook,
                               device=dev, batch_keys=device_batch_keys(cfg.MODEL))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    # a non-finite gradient at any step leaves NaN in the parameters: the
    # global-norm clip spreads it to every gradient and Adam's moments keep it
    finite.append(all_finite(params))
    losses = torch.stack(losses).float().cpu().numpy()
    step_ms = [a.elapsed_time(b) for (ea, a), (eb, b) in zip(marks, marks[1:]) if ea == eb]
    ok = (iters == epochs * steps and np.isfinite(losses).all()
          and bool(torch.stack(finite).all()) and float(state.conf_cnt.sum()) > 0)
    print(f"training path {label}: {iters} steps in {epochs} mini-epochs, {wall:.2f} s wall; "
          f"losses {[round(float(x), 4) for x in losses]}; gradients (last step of each "
          f"epoch) and parameters finite: {bool(torch.stack(finite).all())}; conf_cnt of the "
          f"last epoch {int(state.conf_cnt.sum())} {'ok' if ok else 'FAIL'}")
    if step_ms:
        print(f"  step time (CUDA events between steps, the first of each epoch left out): "
              f"mean {np.mean(step_ms):.3f} ms over {len(step_ms)} "
              f"{[round(x, 3) for x in step_ms]}; max_memory_allocated {peak / 2**30:.2f} GiB")
    if not ok:
        raise AssertionError(f"training path {label} failed its checks")
    check_launches(f"{label} step", counts, expect_launches, iters)
    return counts, (net, opt, state, step), step_ms


def train_path(dev, config, label, epochs, steps, expect_conf, expect_launches, grid=None,
               points=POINTS):
    """``train_model`` over synthetic batches, at full width unless a
    smaller ``grid`` is given (for rehearsals); the epoch-end feedback
    reaches the recording loader.  Returns the launch counts and what the
    later phases need."""
    cfg, meta = load_config(grid, config)
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True  # the batches come presorted
    rng = np.random.RandomState(16)
    batches = [waymo_like_batch(rng, BATCH, points, meta.point_cloud_range, meta.voxel_size,
                                len(cfg.CLASS_NAMES)) for _ in range(2)]
    loader = SyntheticLoader(batches, steps)
    counts, (net, opt, state, step), _ = run_training(dev, label, cfg, meta, loader, epochs,
                                                       steps, expect_launches)
    conf = loader.dataset.confidence_groups
    ok = len(conf) == epochs and all(c.shape == expect_conf and np.isfinite(c).all()
                                     for c in conf)
    print(f"  feedback {[c.shape for c in conf]} finite {ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"training path {label}: the epoch-end feedback is wrong")
    return counts, (net, opt, state, step, batches[0], cfg, meta)


def path_c_dataset_cfg(cfg, bg_points=120000, max_points=POINTS):
    """The synthetic dataset of path C (the JAX package's end-to-end bench
    loader, ``bench.py`` ``_make_loader``): one epoch's scenes of
    ``bg_points`` ground points and up to 48 objects, the in-memory GT
    database, the flagship's DATA_AUGMENTOR (COM2 GT-paste, world flip,
    rotation, scaling) and DATA_PROCESSOR (range mask, shuffle, pillar
    presort at 0.32 m), 500 object slots."""
    import copy

    from com_tpu_torch.utils.config import CfgNode

    d = cfg.DATA_CONFIG
    return CfgNode({"DATASET": "SyntheticDataset", "NUM_SCENES": BATCH * C_STEPS,
                    "NUM_OBJECTS": 48,
                    "NUM_BG_POINTS": bg_points, "POINT_CLOUD_RANGE": list(d.POINT_CLOUD_RANGE),
                    "MAX_POINTS_PER_SCENE": max_points, "MAX_GT_OBJECTS": NUM_MAX_OBJS,
                    "POINT_FEATURE_ENCODING": copy.deepcopy(d.POINT_FEATURE_ENCODING),
                    "DATA_AUGMENTOR": copy.deepcopy(d.DATA_AUGMENTOR),
                    "DATA_PROCESSOR": copy.deepcopy(d.DATA_PROCESSOR)})


def host_pipeline_rate(ds_cfg, names):
    """Scenes a second that path C's host pipeline alone delivers (no
    device), as the JAX package's bench measures it: the loader's first
    batch warms the workers and is not timed, then every batch of path C's
    epochs."""
    from com_tpu_torch.data.dataset import build_dataloader

    _, loader = build_dataloader(ds_cfg, names, BATCH, training=True, seed=C_SEED,
                                 workers=C_WORKERS)
    n, t0 = 0, None
    for epoch in range(C_EPOCHS):
        loader.set_epoch(epoch)
        for _ in loader:
            if t0 is None:
                t0 = time.perf_counter()
            else:
                n += 1
    return BATCH * n / (time.perf_counter() - t0), n


class CheckedLoader:
    """The port's PrefetchLoader as ``train_model`` reads it, checking each
    host batch on its way to the device.  The fixed shapes.  The pasted
    objects (``true_object == 2``) of each sample: as many as the sampler
    pasted into the scene reach the range mask, as many of those as have
    their centre in the range reach the batch (both counted where it
    happens, by wrapping the sampler's paste and the mask step of this
    dataset), and no class past its LIMIT_WHOLE_SCENE quota (SAMPLE_GROUPS
    less the scene's own objects of the class)."""

    def __init__(self, loader, names, max_points, sample_groups):
        self.loader, self.dataset = loader, loader.dataset
        self.names, self.max_points = names, max_points
        self.quota_of = {c: int(n) for c, n in (g.split(":") for g in sample_groups)}
        self.samples = []  # (epoch, frame, quota by class, pasted by class)
        self.errors = []
        self.pasted, self.masked = {}, {}  # (epoch, frame) -> count
        ds = self.dataset
        sampler = ds.data_augmentor.gt_sampler
        paste = sampler.add_sampled_boxes_to_scene

        def counted_paste(data_dict, sampled_boxes, sampled_infos):
            self.pasted[(ds.epoch, data_dict["frame_id"])] = len(sampled_infos)
            return paste(data_dict, sampled_boxes, sampled_infos)

        sampler.add_sampled_boxes_to_scene = counted_paste
        queue = ds.data_processor.queue
        k = next(i for i, (fn, _) in enumerate(queue)
                 if fn.__name__ == "mask_points_and_boxes_outside_range")
        mask, mask_cfg = queue[k]
        pr = ds.point_cloud_range

        def counted_mask(data_dict, cfg):
            pasted = np.asarray(data_dict["true_object"]) == 2
            ctr = np.asarray(data_dict["gt_boxes"])[:, :3]
            inside = ((ctr >= pr[:3]) & (ctr <= pr[3:])).all(axis=1)
            self.masked[(ds.epoch, data_dict["frame_id"])] = (int(pasted.sum()),
                                                             int((pasted & inside).sum()))
            return mask(data_dict, cfg)

        queue[k] = (counted_mask, mask_cfg)

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.loader.set_epoch(epoch)

    def check(self, b):
        want = {"points": (BATCH, self.max_points, FEATS), "points_mask": (BATCH, self.max_points),
                "gt_boxes": (BATCH, NUM_MAX_OBJS, 8)}
        for k in ("points", "points_mask", "gt_boxes", "true_object", "num_points_in_gt",
                  "occupancy_ratio", "facade_type"):
            if b[k].shape != want.get(k, (BATCH, NUM_MAX_OBJS)):
                self.errors.append(f"{k} has shape {b[k].shape}")
        for i, frame in enumerate(b["frame_id"]):
            gt_names = self.dataset._scenes[frame]["gt_names"]
            quota = {c: self.quota_of[c] - int((gt_names == c).sum()) for c in self.names}
            rows = b["true_object"][i] == 2
            pasted = {c: int((rows & (b["gt_boxes"][i, :, 7] == k + 1)).sum())
                      for k, c in enumerate(self.names)}
            n_paste = self.pasted.get((self.epoch, frame), 0)
            n_in, n_out = self.masked[(self.epoch, frame)]
            if (n_in != n_paste or sum(pasted.values()) != n_out
                    or any(pasted[c] > max(quota[c], 0) for c in self.names)):
                self.errors.append(f"frame {frame}: quota {quota}, sampler pasted {n_paste}, "
                                   f"{n_in} tagged at the range mask, {n_out} of them inside, "
                                   f"batch {pasted}")
            self.samples.append((self.epoch, frame, quota, pasted))

    def __iter__(self):
        for b in self.loader:
            self.check(b)
            yield b


def train_path_c(dev, grid=None, bg_points=120000, max_points=POINTS):
    """Training path C: the flagship's model and optimizer at full width
    (unless a smaller ``grid`` is given, for rehearsals) over the port's own
    data pipeline, ``build_dataloader`` -> ``PrefetchLoader`` (COM2 GT-paste,
    world augmentations, presort, collate) -> ``DevicePrefetcher`` ->
    ``make_train_step``, with the curriculum loop closed: each epoch's
    card-computed confidences reach the COM2 sampler, which draws the next
    epoch's pastes by them.  Gates: fixed shapes and pasted objects
    (``CheckedLoader``); every sample's valid points sorted by pillar on the
    card (``point_voxel_ids``); the sampler holding each epoch's confidences
    bitwise; COM2's group probabilities away from the size-proportional ones
    at epochs 1 and 2; finite losses, gradients and parameters; path A's
    launch counts a step.  Prints the step time, the host pipeline's own
    rate, the main thread's wait for a batch and peak memory."""
    from com_tpu_torch.data.dataset import build_dataloader
    from com_tpu_torch.data.processor import pipeline_presorts_points
    from com_tpu_torch.ops.voxelize import point_voxel_ids

    cfg, meta = load_config(grid)
    names = list(cfg.CLASS_NAMES)
    ds_cfg = path_c_dataset_cfg(cfg, bg_points=bg_points, max_points=max_points)
    ds_cfg.POINT_CLOUD_RANGE = list(meta.point_cloud_range)
    presorted = pipeline_presorts_points(ds_cfg, meta.voxel_size)
    if "ASSUME_SORTED_POINTS" not in cfg.MODEL.VFE and presorted:
        cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True
    print(f"path C: pipeline_presorts_points {presorted}, ASSUME_SORTED_POINTS "
          f"{cfg.MODEL.VFE.get('ASSUME_SORTED_POINTS', False)}")
    if not presorted:
        raise AssertionError("path C: the flagship's DATA_PROCESSOR no longer presorts")

    rate, n_host = host_pipeline_rate(ds_cfg, names)
    print(f"path C host pipeline alone: {rate:.2f} scenes/s with {C_WORKERS} workers "
          f"({n_host} batches timed after a warm-up batch)")

    ds, loader = build_dataloader(ds_cfg, names, BATCH, training=True, seed=C_SEED,
                                  workers=C_WORKERS)
    sampler = ds.data_augmentor.gt_sampler
    aug = next(c for c in ds_cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST if c.NAME == "gt_sampling")
    checked = CheckedLoader(loader, names, max_points, aug.SAMPLE_GROUPS)
    conf_shape = (len(names), 96)
    acc = {}  # epoch -> (sum, count) of the steps' confidence statistics, on the card
    sorted_ok, waits, shares = [], [], []
    seen = {}  # epoch -> the sampler's confidences at its first step
    last = {"t": None}

    def step_wrap(step):
        def wrapped(state, batch, epoch):
            t = time.perf_counter()
            if last["t"] is not None and epoch == last["epoch"]:
                waits.append(t - last["t"])
            # every sample's valid points non-decreasing in pillar id
            ids, _ = point_voxel_ids(batch["points"][..., :3], meta.point_cloud_range,
                                     meta.voxel_size, meta.grid_size)
            pair = batch["points_mask"][:, 1:] & batch["points_mask"][:, :-1]
            sorted_ok.append(((ids[:, 1:] >= ids[:, :-1]) | ~pair).all(dim=1))
            state, metrics = step(state, batch, epoch)
            s, c = acc.get(epoch, (torch.zeros(conf_shape, device=dev),
                                   torch.zeros(conf_shape, device=dev)))
            acc[epoch] = (s.add_(metrics["confidence_sum"]), c.add_(metrics["confidence_cnt"]))
            last.update(t=time.perf_counter(), epoch=epoch)
            return state, metrics
        return wrapped

    def epoch_hook(epoch, state):
        """At each epoch's first step: what the sampler holds and COM2's
        group probabilities (host arrays only: no sync with the card)."""
        if epoch == 0:
            return
        seen[epoch] = np.array(sampler.confidence_groups)
        for c in names:
            group = sampler.sample_groups[c]
            sizes = np.array([len(g) for g in group["indices"]], np.float64)
            prob = sampler.group_probability(c, group)
            k, u, _ = sampler.pacing(c, len(sizes))
            shares.append((epoch, c, k, u, float(np.abs(prob - sizes / sizes.sum()).max()),
                           len(sizes)))

    counts, trainer, step_ms = run_training(dev, "C (flagship, own pipeline)", cfg, meta,
                                            checked, C_EPOCHS, C_STEPS, EXPECT_TRAIN,
                                            step_wrap=step_wrap, epoch_hook=epoch_hook)
    state = trainer[2]
    seen[C_EPOCHS] = np.array(sampler.confidence_groups)
    held = []
    for epoch in range(1, C_EPOCHS + 1):  # the feedback of epoch - 1 against the card's
        s_, c_ = acc[epoch - 1]
        want = (s_ / (c_ + 0.01)).cpu().numpy()
        got = seen[epoch]
        held.append(got.shape == want.shape and got.dtype == want.dtype
                    and got.tobytes() == want.tobytes())
    for epoch, c, k, u, diff, n in shares:
        print(f"  epoch {epoch} {c}: pacing index k = {k}, centre u = {u:.6f}, "
              f"max |p - size share| = {diff:.3e} over {n} groups")
    moved = [diff > 1e-6 for *_, diff, _n in shares]
    ok_sorted = bool(torch.stack(sorted_ok).all())
    room = sum(1 for *_, q, _p in checked.samples if sum(max(v, 0) for v in q.values()))
    with_paste = sum(1 for *_, p in checked.samples if sum(p.values()))
    pasted = sum(sum(p.values()) for *_, p in checked.samples)
    print(f"path C checks: {len(checked.samples)} samples, fixed shapes and pasted objects "
          f"{'ok' if not checked.errors else checked.errors}; {room} with room under "
          f"LIMIT_WHOLE_SCENE, {with_paste} carry pasted objects, {pasted} in all; valid points "
          f"pillar-sorted on the card {ok_sorted}; sampler holds each epoch's confidences "
          f"bitwise {held}; COM2 leaves the size shares {moved}")
    print(f"  main thread's wait for a batch (host clock between steps, the first of each "
          f"epoch left out): mean {1e3 * np.mean(waits):.3f} ms over {len(waits)}")
    if (checked.errors or not pasted or not ok_sorted or not all(held)
            or len(moved) != (C_EPOCHS - 1) * len(names) or not all(moved)
            or tuple(state.conf_sum.shape) != conf_shape):
        raise AssertionError("training path C failed its checks")
    return counts, step_ms


def stage_and_overfit(dev, trainer, steps=10):
    """The flagship step's stages by CUDA events (forward, loss, backward,
    optimizer; mean over the steps after the first), and the overfit check:
    the loss falls over ``steps`` steps on one repeated batch."""
    from com_tpu_torch.train.step import make_train_step

    net, opt, state, _, batch, cfg, meta = trainer
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    step = make_train_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, opt,
                           meta.grid_size[1::-1], device=dev, stage_hook=mark)
    dev_batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    losses, sums = [], {}
    for i in range(steps):
        marks.clear()
        state, metrics = step(state, dev_batch, 0)
        losses.append(metrics["loss"])
        torch.cuda.synchronize()
        if i:
            for (name, a), (_, b) in zip(marks, marks[1:]):
                sums[name] = sums.get(name, 0.0) + a.elapsed_time(b) / (steps - 1)
    losses = [float(x) for x in losses]
    total = sum(sums.values())
    print(f"stage ms (one flagship train step, batch {BATCH}, mean of {steps - 1}): "
          f"{json.dumps({k: round(v, 3) for k, v in sums.items()})} total {total:.3f}")
    ok = np.isfinite(losses).all() and losses[-1] < losses[0]
    print(f"overfit: loss over {steps} steps on one batch {[round(x, 4) for x in losses]} "
          f"falls {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the loss does not fall on a repeated batch")
    return step, dev_batch


def profile_train(state, step, dev_batch):
    """torch.profiler over three flagship train steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = step(state, dev_batch, 0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    print(f"profile: 3 train steps in {wall_us / 1e3:.3f} ms wall, device busy "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} %), {len(spans)} device events")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    profile = "--profile" in sys.argv[1:]
    smi = phase_device_and_build()
    entries = []
    check_seg_scan(dev, entries)
    check_seg_scan_bwd(dev, entries)
    check_conv3x3(dev, entries)
    check_conv3x3_backward(dev, entries)
    check_wgrad_variants(dev, entries)
    sweep_counts = wgrad_sweep(dev)
    calls = []  # (label, device kernels a call, call) for check_device_kernels
    check_stamp(dev, entries, calls)
    check_small_reference(dev)
    check_small_train_reference(dev)
    serve_counts, net, step, cfg, meta, scenes = serve(dev)
    stage_breakdown(net, step, scenes)
    check_nms(dev, entries, calls, net, cfg, meta)
    if profile:  # counted in the first profiling session, as without --profile
        check_device_kernels(calls)
        profile_wgrad_sweep(dev)
        profile_step(step, scenes)
    del net, step
    torch.cuda.empty_cache()
    a_counts, trainer = train_path(dev, CONFIG, "A (flagship)", 2, 3, (3, 96), EXPECT_TRAIN)
    step, dev_batch = stage_and_overfit(dev, trainer)
    if profile:
        profile_train(trainer[2], step, dev_batch)
    del trainer, step, dev_batch
    torch.cuda.empty_cache()
    b_counts, _ = train_path(dev, CAR_CONFIG, "B (car_com1, UCL)", 1, 2, (1, 96),
                             EXPECT_TRAIN_UCL)
    torch.cuda.empty_cache()
    train_path_c(dev)
    # each kernel's launches on the path that runs it: training path A,
    # serving for K4, path B for K3's last_wins mode, the sweep for T1-T4
    counts = {**a_counts, "nms": serve_counts["nms"],
              "stamp_last_wins": b_counts["stamp_last_wins"],
              **{f"wgrad_{v}": sweep_counts[f"wgrad_{v}"] for v in WGRAD_VARIANTS}}
    if not profile:
        check_device_kernels(calls)
    for e in entries:
        e["launches"] = counts[e.pop("kernel")]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
