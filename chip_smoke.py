"""Drive the PyTorch/CUDA port's serving and training paths (over its own
data pipeline, through its train, test and demo CLIs, for the PointPillars
anchor head and for the sparse-voxel detectors) and its wgrad sweep on one
NVIDIA GPU.

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
9. Path D, the flagship through the port's own entry points
   (``com_tpu_torch.tools``, in-process) over path C's data: train 2
   epochs with one checkpoint kept; resume to 3, checked before its first
   step against the file (epoch 2, iteration 8, the optimizer's count and
   moments, the curriculum, the sampler's confidences, the model, all
   bitwise); the checkpoint's size and save / load times; the test CLI on
   the val split (every frame, scores sorted, labels in range, at most
   NMS_POST_MAXSIZE a head, result.pkl, recall, s a frame and
   ``--infer_time``'s ms a frame); the demo over two ``.npy`` scenes.
   Path A's launch counts a train step, serving's an eval forward.
10. Path E, KITTI PointPillars (``configs/kitti_models/pointpillar.yaml``,
   the anchor head) at full width (432 x 496 pillars of 0.16 m, batch 4,
   32,768 point slots with ~20,000 presorted KITTI-like points a scene,
   128 object slots with ~40 real, NMS_PRE_MAXSIZE 4,096), seeded random
   weights with the class bias raised off its prior (``spread_anchor_
   scores``): the 64x64 f32 eval and train steps (anchor curriculum on),
   card against CPU; serving behind BatchServer (three requests, one
   forward with a padded scene) and its stages, the post-processing split
   into decode, top-k, sort and gathers, the row-blocked self-IoU, K4,
   ``_kept_slots`` and the rest; K1's sum and K4 at the path's shapes (K4
   on the decoded (4, 4096) candidates and on two synthetic cases), K2,
   its dgrad and K2w at (4,248,216,64), (4,124,108,128), (4,62,54,256);
   ``train_model`` 2 mini-epochs of 3 steps (the all-zero (3, 96)
   feedback reaches the loop), the step's stages and the overfit check;
   two steps with ``LOSS_CURRICULUM`` on (the AnchorCurriculumState moves,
   the (3, 96) counts only in the real objects' groups, the feedback
   bitwise); the demo CLI over two ``.bin`` scenes.
11. Path F, CenterPoint-voxel with COMLoss (``configs/waymo_models/com/
   centerpoint_voxel_comloss.yaml``: MeanVFE, the sparse 3D backbone,
   HeightCompression, UCL on) at full width: batch 2 of Waymo-like scenes
   (163,840 points) voxelized by the port's native host voxelizer into
   80,000 (train) / 90,000 (test) slots of 5 points, the 1498 x 1498 x 40
   grid, VOXEL_CAPS [80000, 60000, 30000, 16000], a 188 x 188 BEV, 500
   object slots ~100 real, bf16 BEV and head. The 64 x 64 x 40 f32 eval and
   train steps, card against CPU; three serving batches through
   ``make_eval_step`` (latency, peak memory), the eval step's stages, the
   3D backbone's split into rulebooks, gathers and GEMMs, norms and the
   dense scatter (``com_tpu_torch/tools/perf/sparse_stages.py``) and each
   stage's active sites against its cap with those dropped past it; K3 at
   (2,3,188,188) and K2, its dgrad and K2w at (2,188,188,256->128),
   (2,188,188,128->128) and (2,94,94,256->256); ``train_model`` 2
   mini-epochs of 3 steps (the (3, 96) feedback, the curriculum state
   moved), the step's stages and the overfit check; the train CLI (1 epoch
   of 2 steps over path C's synthetic scenes voxelized) and the test CLI on
   its checkpoint.
12. Path G, SECOND (``configs/kitti_models/second.yaml``) at full width:
   batch 4 of ~20,000 KITTI-like points a scene voxelized into 40,000 /
   16,000 slots, the 1408 x 1600 x 40 grid, scores spread as path E's: one
   serving batch, its stages, the 3D backbone's split and sites; K4 on its
   decoded (4, 4096) candidates and two synthetic cases; K2, dgrad and K2w
   at (4,200,176,256->128), (4,200,176,128->128), (4,100,88,256->256); 2
   train steps through ``train_model``.
13. Launch counts: every counter is zeroed just before each path (the
   sweep, serving, A, B, C, D's, E's, F's and G's phases) and read just
   after, against the calls the sweep reports and the expected counts per
   forward or per step.  The device
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
# path E: KITTI PointPillars (anchor head); batch, point slots (~20,000 real
# points a scene), features, object slots (~40 real objects a scene)
KITTI_CONFIG = "configs/kitti_models/pointpillar.yaml"
E_BATCH, E_POINTS, E_REAL_POINTS, E_FEATS, E_SLOTS, E_REAL_OBJS = 4, 32768, 20000, 4, 128, 40
E_CONV = ((4, 248, 216, 64), (4, 124, 108, 128), (4, 62, 54, 256))  # its K2's (B, H, W, C)
KITTI_SIZES = np.array([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]], np.float32)
# the anchor curriculum as tests/test_anchor_path.py sets it (no shipped YAML turns it on)
E_CURRICULUM = {"UCL": True, "HEIGHT": 1, "ELONGATION": -10, "OFFSET": 0, "FIXED": True,
                "ALPHA": 0.01}
# path E's launches per serving forward and per train step: K1's sum only
# (one PFN layer pools by a scatter), 13 stride-1 3x3 convs (the first of
# each block has stride 2), no K3 (the anchor loss stamps no heatmap)
EXPECT_E_SERVING = {"seg_scan": 1, "conv3x3": 13, "nms": 1}
EXPECT_E_TRAIN = {"seg_scan": 1, "conv3x3": 13, "conv3x3_dgrad": 13, "conv3x3_wgrad": 13}
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
FLAGSHIP_CONV = ((2, 468, 468, 64), (2, 234, 234, 128), (2, 117, 117, 256))  # K2's (B, H, W, C)
PROFILE_SESSIONS = 3  # tries for a profiling session that sees the device
# path C: epochs, steps an epoch (of BATCH scenes: the dataset holds one
# epoch's scenes), loader threads, seed
C_EPOCHS, C_STEPS, C_WORKERS, C_SEED = 3, 4, 2, 9
# path D: loader threads, seed (its scenes are path C's), the evaluation's score threshold
D_WORKERS, D_SEED, D_SCORE_THRESH = 2, 11, 0.0
# paths F and G: the sparse-voxel detectors, CenterPoint-voxel with COMLoss
# (Waymo) and SECOND (KITTI); their model inputs
VOXEL_CONFIG = "configs/waymo_models/com/centerpoint_voxel_comloss.yaml"
SECOND_CONFIG = "configs/kitti_models/second.yaml"
VOXEL_KEYS = ("voxels", "voxel_coords", "voxel_num_points")
# their K2's (B, H, W, Cin, Cout): block 0's first conv (stride 1, 256 ->
# 128) and the five after it, then block 1's five at half the size (its
# first conv has stride 2, a library conv)
F_CONV = ((2, 188, 188, 256, 128), (2, 188, 188, 128, 128), (2, 94, 94, 256, 256))
G_CONV = ((4, 200, 176, 256, 128), (4, 200, 176, 128, 128), (4, 100, 88, 256, 256))
# launches per serving forward and per train step: 6 + 5 stride-1 3x3 convs,
# K4 once; K3 in both modes for COMLoss with UCL; the anchor loss stamps none
EXPECT_F_SERVING = EXPECT_G_SERVING = {"conv3x3": 11, "nms": 1}
EXPECT_G_TRAIN = {"conv3x3": 11, "conv3x3_dgrad": 11, "conv3x3_wgrad": 11}
EXPECT_F_TRAIN = {**EXPECT_G_TRAIN, "stamp_gauss": 1, "stamp_last_wins": 1}
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


def conv_shape(shape):
    """(B, H, W, C) -> (B, H, W, C, C); (B, H, W, Cin, Cout) as it is."""
    return tuple(shape) if len(shape) == 5 else (*shape, shape[-1])


def check_conv3x3(dev, entries, shapes=FLAGSHIP_CONV, dtypes=(torch.float32, torch.bfloat16),
                  path=""):
    """K2 at each (B, H, W, C) (C -> C) or (B, H, W, Cin, Cout) of ``shapes``
    in each dtype; ``path`` prefixes the counter whose launches the entries
    report."""
    import torch.nn.functional as F

    from com_tpu_torch.ops import conv2d

    gen = torch.Generator(device=dev).manual_seed(3)
    for b, h, wd, c, co in map(conv_shape, shapes):
        for dt in dtypes:
            x = torch.randn((b, h, wd, c), device=dev, generator=gen).to(dt)
            w = (torch.randn((3, 3, c, co), device=dev, generator=gen) / math.sqrt(9 * c)).to(dt)
            got = conv2d.conv3x3(x, w)
            want = conv2d.conv3x3_plain(x, w)
            absref = conv2d.conv3x3_plain(x.float().abs(), w.float().abs())
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            # f32: summation order only; bf16: that, then one rounding to bf16
            rnd = 0.0 if dt == torch.float32 else 2.0 ** -7
            ok = bool((err <= 1e-5 * absref + rnd * want.float().abs()).all())
            label = f"{str(dt).split('.')[-1]} ({b},{h},{wd},{c}->{co})"
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
            flops = 2 * 9 * c * co * b * h * wd  # the serving path runs the bf16 case
            bms, by = bound_ms(nbytes(x, w, got), flops, dt)
            entries.append(dict(name=f"conv2d.conv3x3 {label}", route="cuda",
                                source="com_tpu_torch/csrc/conv3x3.cu",
                                replaces="com_tpu/ops/pallas/conv2d.py:208",
                                max_abs_err=err.max().item(), ms=ms,
                                device_ms=dev_ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                                kernel=path + "conv3x3"))


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


def check_conv3x3_backward(dev, entries, shapes=FLAGSHIP_CONV,
                           wgrad_dtypes=(torch.float32, torch.bfloat16), path=""):
    """K2 dgrad (K2 on the output gradient with the rotated kernel) checked
    through the autograd.Function and timed as the call its backward makes
    (``conv3x3_dgrad``), and K2w, at the backbone's shapes ``shapes``;
    ``path`` prefixes the counters whose launches the entries report."""
    from com_tpu_torch.ops import conv2d

    gen = torch.Generator(device=dev).manual_seed(13)
    for b, h, wd, c, co in map(conv_shape, shapes):
        flops = 2 * 9 * c * co * b * h * wd
        x0 = torch.randn((b, h, wd, c), device=dev, generator=gen).to(torch.bfloat16)
        w = (torch.randn((3, 3, c, co), device=dev, generator=gen) / math.sqrt(9 * c))
        w = w.to(torch.bfloat16)
        g = torch.randn((b, h, wd, co), device=dev, generator=gen).to(torch.bfloat16)
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
        label = f"bf16 ({b},{h},{wd},{c}->{co})"
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
        lib_ms = cuda_ms(lambda: torch.nn.grad.conv2d_input((b, c, h, wd), wc, gc,
                                                            padding=1), 10)
        bms, by = bound_ms(nbytes(g, w, got), flops, torch.bfloat16)
        entries.append(dict(name=f"conv2d.conv3x3 dgrad {label}", route="cuda",
                            source="com_tpu_torch/csrc/conv3x3.cu",
                            replaces="com_tpu/ops/pallas/conv2d.py:544",
                            max_abs_err=err.max().item(), ms=ms,
                            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms,
                            bound_by=by, library_ms=lib_ms, kernel=path + "conv3x3_dgrad"))
        del runs, x, y, px, py, got, want, absref, err

        for dt in wgrad_dtypes:
            xd, gd = x0.to(dt), g.to(dt)
            got = conv2d.conv3x3_wgrad(xd, gd)
            want = conv2d.conv3x3_wgrad_plain(xd, gd)
            absref = conv2d.conv3x3_wgrad_plain(xd.float().abs(), gd.float().abs())
            torch.cuda.synchronize()
            err = (got - want).abs()
            rnd = 0.0 if dt == torch.float32 else 2.0 ** -8
            ok = bool((err <= 1e-5 * absref + rnd * want.abs()).all())
            label = f"{str(dt).split('.')[-1]} ({b},{h},{wd},{c}->{co})"
            print(f"K2w conv3x3_wgrad {label}: max_abs_err={err.max().item():.3e} "
                  f"(|err| <= 1e-5 * sum|x||g| + {rnd:g} * |plain|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"K2w {label} disagrees with its plain version")
            ms = cuda_ms(lambda: conv2d.conv3x3_wgrad(xd, gd), 10)
            dev_ms = device_ms(lambda: conv2d.conv3x3_wgrad(xd, gd), 10)
            plain_ms = cuda_ms(lambda: conv2d.conv3x3_wgrad_plain(xd, gd), 5)
            xc, gc = xd.permute(0, 3, 1, 2), gd.permute(0, 3, 1, 2)
            lib_ms = cuda_ms(lambda: torch.nn.grad.conv2d_weight(xc, (co, c, 3, 3), gc,
                                                                 padding=1), 10)
            bms, by = bound_ms(nbytes(xd, gd, got), flops, dt)
            entries.append(dict(name=f"conv2d.conv3x3_wgrad {label}", route="cuda",
                                source="com_tpu_torch/csrc/conv3x3_wgrad.cu",
                                replaces="com_tpu/ops/pallas/conv2d.py:235",
                                max_abs_err=err.max().item(), ms=ms,
                                device_ms=dev_ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                                kernel=path + "conv3x3_wgrad"))
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


def check_stamp(dev, entries, calls, hw=(468, 468), path=""):
    """K3 in both modes on the training path's canvas (2, 3, 468, 468), or
    (2, 3, *hw), with 500 object slots: ~100 real objects a sample, some invalid slots among
    them, radii past the clip, overlapping windows, centers on the edges.
    The inputs have the dtypes the path's callers pass (int32 ids, no values
    for the heatmap targets; int64 classes and f32 weights for the COM loss
    mask).  Each mode's call goes into ``calls`` with the one device kernel
    it must issue (counted by ``check_device_kernels`` at the end).
    ``path`` prefixes the counters whose launches the entries report."""
    from com_tpu_torch.ops import stamp

    rng = np.random.RandomState(14)
    b, n, c, (h, w) = BATCH, NUM_MAX_OBJS, 3, hw
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
        print(f"K3 stamp_windows {mode} (2,3,{h},{w}) {int(valid.sum())} objects in "
              f"{b * n} slots: max_abs_err={err:.3e} ({tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K3 {mode} disagrees with its plain version")
        calls.append((f"K3 stamp_windows {mode} ({h},{w})", 1, lambda a=args, m=mode, f=fill:
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
        entries.append(dict(name=f"stamp.stamp_windows {mode} (2,3,{h},{w}) 500 slots",
                            route="cuda", source="com_tpu_torch/csrc/stamp.cu",
                            replaces="com_tpu/ops/pallas/stamp.py:137", max_abs_err=err, ms=ms,
                            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            library_ms=None, kernel=f"{path}stamp_{mode}"))


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


def check_nms(dev, entries, calls, net, cfg, meta, smi):
    """K4 at serving's (2, 500): ``check_k4_cases`` on the overlap matrix of
    boxes the flagship decodes."""
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
    check_k4_cases(dev, entries, calls, over, sv, smi, "", "nms", iters=50)


def check_k4_cases(dev, entries, calls, over, sv, smi, where, kernel, iters):
    """K4 on (over, sv), the candidates a model decodes, and on two
    synthetic cases of that shape with every candidate valid: nothing
    suppressed (each box overlaps only itself, the longest run of kept
    candidates) and everything suppressed by the first; bitwise against
    greedy_suppress_plain, timed over ``iters`` calls.  Each case's call
    goes into ``calls`` with the two device kernels it must issue; its
    entry reports the launches of counter ``kernel``."""
    from com_tpu_torch.ops import nms

    b, k = sv.shape
    eye = torch.eye(k, dtype=torch.bool, device=dev).repeat(b, 1, 1)
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
        ms = cuda_ms(lambda: nms.greedy_suppress(ov, vd), iters)
        dev_ms = device_ms(lambda: nms.greedy_suppress(ov, vd), iters)
        print(f"K4 greedy_suppress ({b},{k},{k}) {label}: {int(vd.sum())} valid, {int(got.sum())} "
              f"kept, {err} mismatches (exact); {ms:.4f} ms a call as the host issues them, "
              f"{dev_ms:.4f} ms queued on the card ({smi}) {'ok' if err == 0 else 'FAIL'}")
        if err:
            raise AssertionError(f"K4 at ({b},{k}) on {label} disagrees with its plain version")
        # the pack and the sweep
        calls.append((f"K4 greedy_suppress ({b},{k}) {label}", 2,
                      lambda a=ov, v=vd: nms.greedy_suppress(a, v)))
        plain_ms = cuda_ms(lambda: nms.greedy_suppress_plain(ov, vd), 2 if k > 1024 else 3,
                           warmup=1)
        bms, by = bound_ms(nbytes(ov, vd, got), ov.numel(), torch.float32)
        entries.append(dict(name=f"nms.greedy_suppress ({b},{k},{k}){tag}{where}", route="cuda",
                            source="com_tpu_torch/csrc/nms.cu",
                            replaces="com_tpu/ops/pallas/nms_kernel.py:56",
                            max_abs_err=float(err), ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                            bound_ms=bms, bound_by=by, library_ms=None, kernel=kernel))


def check_small_reference(dev):
    """The eval step at a 64x64 grid in f32 on the card (kernels) against the
    same weights on the CPU (plain versions)."""
    cfg, meta = load_config(grid=(64, 64, 1))
    cfg.MODEL.MIXED_PRECISION = False
    pts = waymo_like_points(np.random.RandomState(5), BATCH, 4096, meta.point_cloud_range)
    batch = {"points": pts, "points_mask": np.ones((BATCH, 4096), bool)}
    compare_eval_step(dev, cfg, meta, batch, "small reference (64x64 f32, card vs CPU)")


def compare_eval_step(dev, cfg, meta, batch, label, prepare=None):
    """The eval step of ``cfg`` on ``batch`` on the card (kernels) against
    the same weights on the CPU (plain versions): the same valid slots,
    each detection within 1e-3 of one of the other's.  ``prepare(net)``
    may adjust the seeded weights first."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    outs = []
    for d in (dev, "cpu"):
        net = build_network(cfg.MODEL, meta, device=d, seed=7)
        if prepare is not None:
            prepare(net)
        step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)
        outs.append([t.cpu().numpy() for t in step(batch)])
    (gb, gs, _, gv), (cb, cs, _, cv) = outs
    worst = 0.0
    for i in range(len(gb)):
        a = np.concatenate([gb[i][gv[i]], gs[i][gv[i]][:, None]], -1)
        b = np.concatenate([cb[i][cv[i]], cs[i][cv[i]][:, None]], -1)
        if len(a) != len(b):
            raise AssertionError(f"{label}: {len(a)} vs {len(b)} detections")
        if len(a):
            d = np.abs(a[:, None] - b[None]).max(-1)
            worst = max(worst, float(d.min(1).max()))
    ok = worst <= 1e-3 and bool((gv == cv).all())
    print(f"{label}: {int(gv.sum())} detections, worst box/score diff {worst:.2e} (<= 1e-3) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the card's eval step disagrees with the CPU")


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
E_NMS_PARTS = ("decode", "topk", "sort_gathers", "iou", "k4", "kept_slots", "rest")
NMS_MARKS = ["sort", "iou", "k4", "k4_end", "rest"]  # the marks _mark_nms_steps records


def _mark_nms_steps(mark):
    """Wrap the steps of ``nms_bev`` so that each records a CUDA event by
    ``mark(label)``: "sort" before the score sort (the gathers follow it),
    "iou" before the self-IoU (``_self_iou``), "k4" and "k4_end"
    around K4, "rest" after ``_kept_slots``.  Returns the function that
    undoes the wrapping."""
    from com_tpu_torch.ops import nms

    orig = {n: getattr(nms, n) for n in ("_score_order", "_self_iou", "greedy_suppress",
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
    nms._self_iou = wrap("_self_iou", before="iou")
    nms.greedy_suppress = wrap("greedy_suppress", before="k4", after="k4_end")
    nms._kept_slots = wrap("_kept_slots", after="rest")
    return lambda: [setattr(nms, n, f) for n, f in orig.items()]


def stage_breakdown(net, step, batch, label, iters=5, smi=""):
    """Where one full-size eval step spends its time on the card: CUDA
    events recorded by forward hooks at each slot's start and end, mean over
    ``iters`` steps.  "upload" is the host-to-card copy of the batch,
    "decode_nms" the decode and NMS after the head, itself split into the
    decode, for an anchor head the top NMS_PRE_MAXSIZE ("topk"), the score
    sort and gathers, the self-IoU, K4, ``_kept_slots`` and the rest (the
    final gathers)."""
    from com_tpu_torch.models.dense_heads import anchor_head

    marks, sub = [], []
    slots = [s for s in ("vfe", "backbone_3d", "map_to_bev", "backbone_2d", "dense_head")
             if getattr(net, s, None) is not None]

    def mark(*_):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)

    def sub_mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        sub.append((name, ev))

    hooks = [h for s in slots for h in (getattr(net, s).register_forward_pre_hook(mark),
                                        getattr(net, s).register_forward_hook(mark))]
    undo = _mark_nms_steps(sub_mark)
    orig_top = anchor_head.top_candidates

    def top(*args, **kw):
        sub_mark("topk")
        return orig_top(*args, **kw)

    anchor_head.top_candidates = top
    names = ["upload"] + [n for s in slots for n in (s, "gap")][:-1] + ["decode_nms"]
    sums = dict.fromkeys(names, 0.0)
    parts = {}
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
            labels = [name for name, _ in sub]
            if labels not in (NMS_MARKS, ["topk", *NMS_MARKS]):
                raise AssertionError(f"decode_nms ran its steps as {labels}")
            seq = [marks[-2], *(ev for _, ev in sub), marks[-1]]
            for name, a, b in zip(NMS_PARTS if labels == NMS_MARKS else E_NMS_PARTS, seq, seq[1:]):
                parts[name] = parts.get(name, 0.0) + a.elapsed_time(b) / iters
    finally:
        anchor_head.top_candidates = orig_top
        undo()
        for h in hooks:
            h.remove()
    sums.pop("gap", None)  # the gaps between slots
    total = sum(sums.values())
    card = f" ({smi})" if smi else ""
    print(f"{label}stage ms (one eval step, batch {len(next(iter(batch.values())))}, mean of "
          f"{iters}): "
          f"{json.dumps({k: round(v, 3) for k, v in sums.items()})} total {total:.3f}{card}")
    print(f"{label}decode_nms ms (mean of {iters}): "
          f"{json.dumps({k: round(v, 4) for k, v in parts.items()})}{card}")


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
    from com_tpu_torch.train.step import conf_shape_for, curriculum_kwargs, make_train_step

    names = list(cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, meta, device=dev, seed=seed)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION,
                             int(cfg.OPTIMIZATION.NUM_EPOCHS) * steps_per_epoch, steps_per_epoch)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names), device=dev,
                              **curriculum_kwargs(cfg.MODEL, names))
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
    cfg, meta = load_config(grid=(64, 64, 1))
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True
    cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM.UCL = True
    cfg.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 64
    batch = waymo_like_batch(np.random.RandomState(15), BATCH, 4096, meta.point_cloud_range,
                             meta.voxel_size, 3, m=64, real=20)
    compare_train_step(dev, cfg, meta, batch, "small train reference (64x64 f32, card vs CPU)")


def compare_train_step(dev, cfg, meta, batch, label):
    """One train step of ``cfg`` on ``batch`` on the card (kernels) against
    the same weights on the CPU (plain versions), every norm's bias moved
    by 3 and the running statistics started at 0: loss, every gradient, the
    batch statistics and the confidence accumulators."""
    from com_tpu_torch.models.layers import BatchNorm

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
    print(f"{label}: loss {l0:.6f} vs {l1:.6f}; "
          f"{len(g1)} gradients within 1e-3 of their max + 1e-5 of the net's max "
          f"(worst at {gerr:.3f} of that); batch statistics rel {serr:.2e} "
          f"(<= {STATS_RTOL:g}); "
          f"confidence counts {int(cc1.sum())} equal {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the card's train step disagrees with the CPU")


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
                 step_wrap=None, epoch_hook=None, counts_confidences=True, smi=""):
    """``train_model`` over ``loader`` with the device batch keys of the
    model, from a fresh trainer; finite losses, gradients (at each epoch's
    last step, outside the timed intervals) and parameters, the last
    epoch's confidence counts (non-zero, or zero where the path has no COM
    groups: ``counts_confidences`` False), and the launch counts per step.
    ``step_wrap(step)`` may wrap the train step; ``epoch_hook(epoch,
    state)`` runs at each epoch's first step.  Returns
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
          and bool(torch.stack(finite).all())
          and (float(state.conf_cnt.sum()) > 0) == counts_confidences)
    print(f"training path {label}: {iters} steps in {epochs} mini-epochs, {wall:.2f} s wall; "
          f"losses {[round(float(x), 4) for x in losses]}; gradients (last step of each "
          f"epoch) and parameters finite: {bool(torch.stack(finite).all())}; conf_cnt of the "
          f"last epoch {int(state.conf_cnt.sum())} {'ok' if ok else 'FAIL'}")
    if step_ms:
        print(f"  step time (CUDA events between steps, the first of each epoch left out): "
              f"mean {np.mean(step_ms):.3f} ms over {len(step_ms)} "
              f"{[round(x, 3) for x in step_ms]}; max_memory_allocated {peak / 2**30:.2f} GiB"
              + (f" ({smi})" if smi else ""))
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


def _plain(node):
    """A config tree as plain dicts and lists, for ``yaml.safe_dump``."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def _quiet_cli_logger():
    """The CLIs log every config key at INFO to the console: keep the
    console to warnings (their log files still get everything)."""
    import logging

    logger = logging.getLogger("com_tpu_torch.r0")
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(logging.WARNING)
        logger.addHandler(console)


def _same_tensors(a, b):
    """Bitwise equality of two nests of tensors (dicts, lists, tuples)."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_same_tensors(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tensors(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    return a == b


def path_d(dev, smi, pc_range=None, bg_points=120000):
    """Path D: the flagship through the port's own entry points, as a user
    runs it (``com_tpu_torch.tools``: train, resume, test, demo), in-process,
    over a YAML holding the flagship's MODEL and OPTIMIZATION unchanged (but
    the evaluation's SCORE_THRESH, ``D_SCORE_THRESH``) and path C's
    DATA_CONFIG (8 scenes, batch 2, 2 loader threads).  Train 2
    epochs with one checkpoint kept; resume to 3, checked before its first
    step (epoch 2, iteration 8, the optimizer's count 8 and moments, the
    curriculum states, the sampler's confidences and the model bitwise as
    in the file); test the epoch-3 checkpoint on the val split with
    ``--infer_time`` and ``--save_to_file``; the demo over two ``.npy``
    scenes.  Launch counts: path A's a train step, serving's an eval
    forward.  Prints the step time through the CLI, the checkpoint's size
    and save / load times, the test CLI's s a frame and ms a frame, recall
    and peak memory, each beside the card.  ``pc_range`` (a smaller scene,
    hence grid) and ``bg_points`` are for rehearsals."""
    import shutil

    import yaml

    from com_tpu_torch.data.synthetic import make_scene
    from com_tpu_torch.tools import demo, test, train
    from com_tpu_torch.utils import checkpoint as ckpt
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / CONFIG))
    names = list(cfg.CLASS_NAMES)
    root = REPO / "build" / "path_d"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        data_cfg = _plain(path_c_dataset_cfg(cfg, bg_points=bg_points))
        if pc_range is not None:
            data_cfg["POINT_CLOUD_RANGE"] = list(pc_range)
        # 12 steps from random weights leave every score under the flagship's
        # 0.1: the evaluation keeps every decoded candidate instead, so that
        # NMS, the trim and the sort see real work (training never reads it)
        model_cfg = _plain(cfg.MODEL)
        model_cfg["DENSE_HEAD"]["POST_PROCESSING"]["SCORE_THRESH"] = D_SCORE_THRESH
        yaml_path = root / "flagship_path_d.yaml"
        yaml_path.write_text(yaml.safe_dump({
            "CLASS_NAMES": names, "DATA_CONFIG": data_cfg, "MODEL": model_cfg,
            "OPTIMIZATION": _plain(cfg.OPTIMIZATION)}))
        _quiet_cli_logger()
        base = ["--cfg_file", str(yaml_path), "--output_dir", str(root / "out"),
                "--workers", str(D_WORKERS), "--device", str(dev)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)

        # 1. train 2 epochs, one checkpoint kept
        marks, losses = [], []

        def hook(epoch, it, metrics):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((epoch, ev))
            losses.append(metrics["loss"])

        reset_counters()
        t0 = time.perf_counter()
        first = train.main(base + ["--seed", str(D_SEED), "--epochs", "2",
                                   "--ckpt_save_interval", "1", "--max_ckpt_save_num", "1"],
                           metric_hook=hook)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = first["iterations"]
        check_launches("D train step (CLI)", read_counters(), EXPECT_TRAIN, steps)
        ckpt_dir = first["ckpt_dir"]
        kept = sorted(p.name for p in ckpt_dir.iterdir())
        logged = [json.loads(x) for x in
                  (first["out_dir"] / "metrics" / "metrics.jsonl").read_text().splitlines()]
        loss_host = [float(x) for x in losses]
        step_ms = [a.elapsed_time(b) for (ea, a), (eb, b) in zip(marks, marks[1:]) if ea == eb]
        ok = (steps == 2 * C_STEPS and kept == ["checkpoint_epoch_2.pth"] and logged
              and all(math.isfinite(x["loss"]) for x in logged) and np.isfinite(loss_host).all())
        print(f"path D train CLI: {steps} steps in 2 epochs, {wall:.2f} s wall (dataset, model and "
              f"loader included); kept {kept}; metrics.jsonl {len(logged)} lines, losses "
              f"{[round(x, 4) for x in loss_host]} {'ok' if ok else 'FAIL'}")
        print(f"  step time through the CLI (CUDA events between steps, the first of each epoch "
              f"left out): mean {np.mean(step_ms):.3f} ms over {len(step_ms)} "
              f"{[round(x, 3) for x in step_ms]} ({smi})")
        if not ok:
            raise AssertionError("path D: the train CLI failed its checks")

        # 2. resume to 3 epochs, checked against the file before the first step
        saved = ckpt_dir / "checkpoint_epoch_2.pth"
        checks = {}

        def on_start(info):
            state, ds = info["state"], info["dataset"]
            want = torch.load(saved, map_location=dev, weights_only=True)
            opt = state.optimizer.state_dict()
            conf = ds.data_augmentor.gt_sampler.confidence_groups
            checks.update(
                epoch=info["start_epoch"] == 2, it=info["start_iter"] == 2 * C_STEPS,
                count=state.optimizer.count == 2 * C_STEPS == want["optimizer_state"]["count"],
                moments=_same_tensors(opt["state"], want["optimizer_state"]["state"]),
                model=_same_tensors(state.net.state_dict(), want["model_state"]),
                curriculum=_same_tensors(
                    [{"kind": type(c).__name__, **c._asdict()} for c in state.curriculum],
                    want["curriculum"]),
                sampler=(conf is not None and conf.dtype == np.float32 and conf.tobytes()
                         == want["sampler"]["confidence_groups"].cpu().numpy().tobytes()))

        marks.clear()
        losses.clear()
        reset_counters()
        second = train.main(base + ["--seed", str(D_SEED), "--epochs", "3"], on_start=on_start,
                            metric_hook=hook)
        torch.cuda.synchronize()
        resumed = second["iterations"] - second["start_iter"]
        check_launches("D resumed train step (CLI)", read_counters(), EXPECT_TRAIN, resumed)
        resumed_ms = [a.elapsed_time(b) for (ea, a), (eb, b) in zip(marks, marks[1:])
                      if ea == eb]
        last = ckpt_dir / "checkpoint_epoch_3.pth"
        ok = (all(checks.values()) and len(checks) == 7 and resumed == C_STEPS
              and last.exists() and np.isfinite([float(x) for x in losses]).all())
        print(f"path D resume: started at epoch {second['start_epoch']} it "
              f"{second['start_iter']}; equal to the file before the first step: "
              f"{json.dumps(checks)}; {resumed} steps (ms after the first "
              f"{[round(x, 3) for x in resumed_ms]}), {last.name} written "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("path D: the resume is not the run that was saved")

        # the checkpoint's size, save and load times
        state = second["state"]
        size_mb = last.stat().st_size / 1e6
        save_ms, load_ms = [], []
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save_checkpoint(state, root / "timing", 3, 12, max_ckpt_save_num=1)
            save_ms.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.load_checkpoint(last, state)
            torch.cuda.synchronize()
            load_ms.append(1e3 * (time.perf_counter() - t0))
        print(f"path D checkpoint: {size_mb:.3f} MB; save {[round(x, 2) for x in save_ms]} ms, "
              f"load into the state {[round(x, 2) for x in load_ms]} ms (host clock, synced; "
              f"{smi})")
        del state, second, first
        torch.cuda.empty_cache()

        # 3. test the epoch-3 checkpoint
        reset_counters()
        (res,) = test.main(base + ["--ckpt", str(last), "--infer_time", "--save_to_file"])
        torch.cuda.synchronize()
        annos = res["det_annos"]
        n_batches = -(-len(annos) // BATCH)
        check_launches("D eval forward (test CLI)", read_counters(), EXPECT_SERVING,
                       res["infer_batches"] + 1 + n_batches)
        cap = int(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
        heads = [[names.index(n) + 1 for n in h]
                 for h in cfg.MODEL.DENSE_HEAD.CLASS_NAMES_EACH_HEAD]
        ok = (sorted(a["frame_id"] for a in annos) == list(range(BATCH * C_STEPS))
              and res["result_pkl"].exists() and "recall@0.5" in res["result_str"]
              and all(len(a["score"]) and np.isfinite(a["boxes_lidar"]).all()
                      and (np.diff(a["score"]) <= 0).all()
                      and set(a["pred_labels"].tolist()) <= set(range(1, len(names) + 1))
                      and all(np.isin(a["pred_labels"], h).sum() <= cap for h in heads)
                      for a in annos))
        rec = res["recalls"]
        print(f"path D test CLI: {len(annos)} frames, detections a frame "
              f"{[len(a['score']) for a in annos]}, {res['sec_per_frame']:.4f} s a frame "
              f"(eval_model, host clock), --infer_time {res['infer_ms_per_frame']:.3f} ms a frame "
              f"(median of {res['infer_batches']} batches, synced) ({smi}); recall "
              + " ".join(f"@{t}={rec[f'recall_{t}'] / max(rec['gt'], 1):.4f}"
                         for t in (0.3, 0.5, 0.7))
              + f" of {rec['gt']} GT; {res['result_str']}; result.pkl written "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("path D: the test CLI failed its checks")

        # 4. the demo over two point files
        rng = np.random.RandomState(D_SEED)
        scenes = root / "scenes"
        scenes.mkdir()
        for i in range(2):
            scene = make_scene(rng, names, num_objects=48, num_bg_points=bg_points,
                               pc_range=data_cfg["POINT_CLOUD_RANGE"])
            np.save(scenes / f"scene_{i}.npy", scene["points"])
        reset_counters()
        annos = demo.main(["--cfg_file", str(yaml_path), "--data_path", str(scenes), "--ext",
                           ".npy", "--ckpt", str(last), "--device", str(dev)])
        torch.cuda.synchronize()
        check_launches("D demo scene", read_counters(), EXPECT_SERVING, 2)
        ok = len(annos) == 2 and all(len(a["score"]) and np.isfinite(a["boxes_lidar"]).all()
                                     and np.isfinite(a["score"]).all() for a in annos)
        print(f"path D demo: {len(annos)} scenes, {[len(a['score']) for a in annos]} detections, "
              f"finite {'ok' if ok else 'FAIL'}; peak memory of path D "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB ({smi})")
        if not ok:
            raise AssertionError("path D: the demo failed its checks")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def kitti_like_points(rng, b, n, pc_range):
    """KITTI-like front-camera crops: ~70 % ground at z ~ -1.7 m (the
    sensor 1.73 m up), density falling with range, within +-45 degrees,
    a quarter of the points in 24 object-sized blobs; (b, n, 4) f32
    [x, y, z, intensity], every point inside ``pc_range``."""
    r = 2.0 + (pc_range[3] - 2.0) * rng.rand(b, n) ** 1.5
    th = rng.uniform(-np.pi / 4, np.pi / 4, (b, n))
    x, y = r * np.cos(th), r * np.sin(th)
    z = np.where(rng.rand(b, n) < 0.7, rng.normal(-1.7, 0.05, (b, n)),
                 rng.uniform(-1.7, 0.5, (b, n)))
    n_blob = n // 4
    centers = np.stack([rng.uniform(5, 60, (b, 24)), rng.uniform(-25, 25, (b, 24))], -1)
    blob = rng.randint(0, 24, (b, n_blob))
    off = rng.normal(0.0, 0.8, (b, n_blob, 2))
    x[:, :n_blob] = np.take_along_axis(centers[..., 0], blob, axis=1) + off[..., 0]
    y[:, :n_blob] = np.take_along_axis(centers[..., 1], blob, axis=1) + off[..., 1]
    z[:, :n_blob] = rng.uniform(-1.7, 0.0, (b, n_blob))
    np.clip(x, pc_range[0], pc_range[3] - 1e-3, out=x)
    np.clip(y, pc_range[1], pc_range[4] - 1e-3, out=y)
    np.clip(z, pc_range[2], pc_range[5] - 1e-3, out=z)
    return np.stack([x, y, z, rng.rand(b, n)], -1).astype(np.float32)


def kitti_like_batch(rng, b, pc_range, vsize, n=E_POINTS, real_points=E_REAL_POINTS,
                     m=E_SLOTS, real=E_REAL_OBJS):
    """One path E batch: scenes of about ``real_points`` points each,
    presorted by pillar and padded to ``n`` slots (the padding masked off,
    last); ``m`` object slots with about ``real`` KITTI-sized Cars,
    Pedestrians and Cyclists a scene; the COM side arrays."""
    pts = np.zeros((b, n, E_FEATS), np.float32)
    mask = np.zeros((b, n), bool)
    gt = np.zeros((b, m, 8), np.float32)
    for i in range(b):
        k = int(rng.randint(real_points - 1000, real_points + 1001))
        pts[i, :k] = presort_by_pillar(kitti_like_points(rng, 1, k, pc_range), pc_range,
                                       vsize)[0]
        mask[i, :k] = True
        j = int(rng.randint(real - 3, real + 4))
        cls = rng.randint(1, 4, j)
        gt[i, :j, 0] = rng.uniform(pc_range[0] + 3, pc_range[3] - 3, j)
        gt[i, :j, 1] = rng.uniform(pc_range[1] + 3, pc_range[4] - 3, j)
        gt[i, :j, 2] = rng.uniform(-1.1, -0.7, j)
        gt[i, :j, 3:6] = KITTI_SIZES[cls - 1] * rng.uniform(0.9, 1.1, (j, 3))
        gt[i, :j, 6] = rng.uniform(-np.pi, np.pi, j)
        gt[i, :j, 7] = cls
    real_mask = gt[..., 7] > 0
    return {"points": pts, "points_mask": mask, "gt_boxes": gt,
            "num_points_in_gt": real_mask.astype(np.float32) * 10,
            "true_object": real_mask.astype(np.float32),
            "occupancy_ratio": rng.rand(b, m).astype(np.float32),
            "facade_type": rng.randint(0, 4, (b, m)).astype(np.float32)}


def load_kitti(grid=None):
    """The KITTI PointPillars YAML and its meta: the full 432 x 496 grid of
    0.16 m pillars, or a small ``grid`` over a range cut to it."""
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / KITTI_CONFIG))
    vsize = [0.16, 0.16, 4.0]
    pc_range = list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    if grid is None:
        grid = (432, 496, 1)
    else:
        pc_range = [0.0, -grid[1] * 0.08, -3.0, grid[0] * 0.16, grid[1] * 0.08, 1.0]
    return cfg, DatasetMeta(cfg.CLASS_NAMES, pc_range, vsize, grid, E_FEATS)


def spread_anchor_scores(net):
    """Seeded random weights leave every class logit at conv_cls's prior
    bias, scores ~0.01 under SCORE_THRESH 0.1, so NMS and K4 would see no
    valid candidate: the bias moves up by 4 (scores spread over (0, 1)), and
    conv_box's weights shrink 50-fold (residuals as small as pcdet's init,
    std 0.001, makes them: boxes near their anchors)."""
    with torch.no_grad():
        net.dense_head.conv_cls.bias.add_(4.0)
        net.dense_head.conv_box.weight.mul_(0.02)
    return net


def check_e_seg_scan(dev, entries, batch, meta, smi):
    """K1's sum at path E's VFE input, (4, 32768, 8) f32: the cluster sums
    over the presorted pillar runs (padding in the trash run)."""
    from com_tpu_torch.ops import seg_scan
    from com_tpu_torch.ops.voxelize import point_voxel_ids

    pts = torch.as_tensor(batch["points"], device=dev)
    mask = torch.as_tensor(batch["points_mask"], device=dev)
    flat, in_range = point_voxel_ids(pts[..., :3], meta.point_cloud_range, meta.voxel_size,
                                     meta.grid_size)
    valid = mask & in_range
    hw = meta.grid_size[0] * meta.grid_size[1]
    seg = torch.where(valid, flat, torch.full_like(flat, hw)).contiguous()
    if not bool((seg[:, 1:] >= seg[:, :-1]).all()):
        raise AssertionError("path E: the batch is not presorted by pillar")
    ones = valid.to(torch.float32)[..., None]
    vals = torch.cat([pts[..., :3] * ones, ones, torch.zeros_like(pts)], -1).contiguous()
    got = seg_scan.run_bcast(vals, seg, "sum")
    want = seg_scan.run_bcast_plain(vals, seg, "sum")
    scale = seg_scan.run_bcast_plain(vals.abs(), seg, "sum")
    torch.cuda.synchronize()
    err = (got - want).abs()
    ok = bool((err <= 1e-5 * scale + 1e-6).all())
    label = f"f32 ({tuple(vals.shape)[0]},{vals.shape[1]},{vals.shape[2]}), path E"
    ms = cuda_ms(lambda: seg_scan.run_bcast(vals, seg, "sum"), 50)
    dev_ms = device_ms(lambda: seg_scan.run_bcast(vals, seg, "sum"), 50)
    plain_ms = cuda_ms(lambda: seg_scan.run_bcast_plain(vals, seg, "sum"), 10)
    bms, by = bound_ms(nbytes(vals, seg, got), vals.numel(), torch.float32)
    print(f"K1 run_bcast sum {label}: {int(valid.sum())} valid points, max_abs_err="
          f"{err.max().item():.3e} (|err| <= 1e-5 * run sum|x| + 1e-6); {ms:.4f} ms a call as "
          f"the host issues them, {dev_ms:.4f} ms queued on the card, bound {bms:.5f} ms ({smi}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K1 sum at path E's input disagrees with its plain version")
    entries.append(dict(name=f"seg_scan.run_bcast sum {label}", route="cuda",
                        source="com_tpu_torch/csrc/seg_scan.cu",
                        replaces="com_tpu/ops/pallas/seg_scan.py:122",
                        max_abs_err=err.max().item(), ms=ms, device_ms=dev_ms,
                        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
                        kernel="E:seg_scan"))


def e_decoded_candidates(net, cfg, meta, batch, dev):
    """What the eval step hands K4 for ``batch``: the boxes the model
    decodes, the top NMS_PRE_MAXSIZE by score (stable), in the NMS's score
    order, as (over, valid), (B, K, K) and (B, K)."""
    from com_tpu_torch.models.dense_heads.anchor_head import (box_coder_for, build_anchors,
                                                              decode_anchor_boxes,
                                                              top_candidates)
    from com_tpu_torch.ops import nms
    from com_tpu_torch.train.step import model_input_keys

    post = cfg.MODEL.POST_PROCESSING
    head = cfg.MODEL.DENSE_HEAD
    anchors = torch.as_tensor(build_anchors(head, list(cfg.CLASS_NAMES), meta.grid_size,
                                            meta.point_cloud_range)[0], device=dev)
    keys = model_input_keys(cfg.MODEL)
    with torch.no_grad():
        out = net({k: torch.as_tensor(batch[k], device=dev) for k in keys})
        boxes, scores, _ = decode_anchor_boxes(out, anchors, len(cfg.CLASS_NAMES),
                                               box_coder_for(head), head)
        top, idx = top_candidates(scores, int(post.NMS_CONFIG.NMS_PRE_MAXSIZE))
        top_bx = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
        _, sb, sv = nms._sorted(top_bx, top, top > float(post.SCORE_THRESH))
        over = (nms._self_iou(sb) > float(post.NMS_CONFIG.NMS_THRESH)).contiguous()
    return over, sv.contiguous()


def path_e_serve(dev, smi, entries, calls):
    """Path E serving: KITTI PointPillars at full width (432 x 496 pillars,
    batch 4, NMS_PRE_MAXSIZE 4096) with seeded random weights
    (``spread_anchor_scores``) behind BatchServer: three single-scene
    requests in one forward with one padded scene, responses checked; the
    eval step's stages; K1 and K4 at the path's shapes."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.serving.server import BatchServer
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta = load_kitti()
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True  # the scenes come presorted
    thresh = float(cfg.MODEL.POST_PROCESSING.SCORE_THRESH)
    names = list(cfg.CLASS_NAMES)
    net = spread_anchor_scores(build_network(cfg.MODEL, meta, device=dev, seed=0))
    step = make_eval_step(net, cfg.MODEL, names, meta, device=dev)
    batch = kitti_like_batch(np.random.RandomState(21), E_BATCH, meta.point_cloud_range,
                             meta.voxel_size)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    latencies = []

    def timed_step(b):
        t0 = time.perf_counter()
        out = step(b)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        return out

    server = BatchServer(timed_step, {"points": ((E_BATCH, E_POINTS, E_FEATS), "float32")},
                         max_wait_ms=500.0, score_thresh=thresh, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    try:
        futures = [server.submit(batch["points"][i][batch["points_mask"][i]]) for i in range(3)]
        results = [f.result(timeout=600) for f in futures]
    finally:
        server.close()
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    forwards = server.stats.batches
    print(f"path E serving: {len(results)} requests in {forwards} batch(es) "
          f"({server.stats.scenes_padded} padded scene), latency ms a batch "
          f"{[round(x, 2) for x in latencies]}, max_memory_allocated {peak / 2**30:.2f} GiB "
          f"({smi})")
    for i, r in enumerate(results):
        n = len(r["scores"])
        ok = (n > 0 and np.isfinite(r["boxes"]).all() and r["boxes"].shape == (n, 7)
              and (r["scores"] >= thresh).all() and np.isin(r["labels"], [1, 2, 3]).all())
        print(f"  request {i}: {n} detections, finite boxes and scores >= {thresh}: "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"path E request {i} returned a malformed response")
    if forwards != 1 or server.stats.scenes_padded != 1:
        raise AssertionError(f"path E serving ran {forwards} forwards, expected 1 with one "
                             "padded scene")
    check_launches("path E serving forward", counts, EXPECT_E_SERVING, forwards)
    stage_breakdown(net, step, batch, "path E ", iters=3, smi=smi)
    check_e_seg_scan(dev, entries, batch, meta, smi)
    over, sv = e_decoded_candidates(net, cfg, meta, batch, dev)
    check_k4_cases(dev, entries, calls, over, sv, smi, ", path E", "E:nms", iters=20)
    return counts


def e_curriculum_steps(dev, cfg, meta, batches, smi):
    """Two steps of the anchor curriculum (``E_CURRICULUM`` on the shipped
    YAML, as ``tests/test_anchor_path.py`` sets it) through ``train_model``,
    the COM side arrays in the batches: the AnchorCurriculumState moves from
    zero and stays finite; the (3, 96) counts are non-zero only in the
    groups of the real objects, and the epoch-end feedback is the state's
    sums over its counts, bitwise."""
    import copy

    from com_tpu_torch.train.step import com_groups_for

    ccfg = copy.deepcopy(cfg)
    ccfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM = dict(E_CURRICULUM)
    names = list(ccfg.CLASS_NAMES)
    loader = SyntheticLoader(batches, 2)
    counts, (net, opt, state, step), _ = run_training(
        dev, "E curriculum (KITTI PointPillars, LOSS_CURRICULUM)", ccfg, meta, loader, 1, 2,
        EXPECT_E_TRAIN, smi=smi)
    (cur,) = state.curriculum
    cells = set()
    for b in batches:
        gt = torch.as_tensor(b["gt_boxes"], device=dev)
        groups = com_groups_for({k: torch.as_tensor(v, device=dev) for k, v in b.items()},
                                gt, True, names).cpu().numpy()
        cls = b["gt_boxes"][..., 7].astype(int)
        cells |= {(c - 1, g - 1) for c, g in zip(cls.ravel(), groups.ravel()) if c > 0 and g > 0}
    cnt = state.conf_cnt.cpu().numpy()
    hit = {tuple(x) for x in np.argwhere(cnt > 0)}
    feedback = loader.dataset.confidence_groups
    want = (state.conf_sum / (state.conf_cnt + 0.01)).cpu().numpy()
    ok = (type(cur).__name__ == "AnchorCurriculumState"
          and bool(torch.isfinite(cur.means).all() and torch.isfinite(cur.stds).all())
          and bool((cur.means > 0).all() and (cur.stds > 0).all() and cur.initialized.all())
          and hit and hit <= cells and bool((state.conf_sum.cpu().numpy()[cnt > 0] > 0).all())
          and len(feedback) == 1 and feedback[0].tobytes() == want.tobytes())
    print(f"path E curriculum: means {[round(float(x), 5) for x in cur.means]} stds "
          f"{[round(float(x), 5) for x in cur.stds]}; (3, 96) counts {int(cnt.sum())} in "
          f"{len(hit)} cells, all among the {len(cells)} cells of the real objects' groups; "
          f"feedback bitwise {feedback[0].tobytes() == want.tobytes() if feedback else False} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path E: the anchor curriculum failed its checks")
    return counts


def path_e_train(dev, smi):
    """Path E training: ``train_model`` on the shipped KITTI PointPillars
    YAML at full width, 2 mini-epochs of 3 steps over path E's batches;
    the epoch-end (3, 96) feedback reaches the loop, all zeros (no COM
    groups without the curriculum: ``com_groups_for``); the step's stages
    and the overfit check; then the anchor curriculum's two steps."""
    cfg, meta = load_kitti()
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True  # the batches come presorted
    rng = np.random.RandomState(22)
    batches = [kitti_like_batch(rng, E_BATCH, meta.point_cloud_range, meta.voxel_size)
               for _ in range(2)]
    loader = SyntheticLoader(batches, 3)
    counts, (net, opt, state, step), _ = run_training(
        dev, "E (KITTI PointPillars)", cfg, meta, loader, 2, 3, EXPECT_E_TRAIN,
        counts_confidences=False, smi=smi)
    conf = loader.dataset.confidence_groups
    ok = len(conf) == 2 and all(c.shape == (3, 96) and not c.any() for c in conf)
    print(f"  path E feedback {[c.shape for c in conf]}, all zero (no COM groups) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path E: the epoch-end feedback is wrong")
    _, _, metrics = stage_and_overfit(dev, (net, opt, state, None, batches[0], cfg, meta),
                                      label="path E (KITTI PointPillars)", smi=smi)
    tb = {k: float(metrics[k]) for k in ("rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir")}
    if not all(math.isfinite(v) for v in tb.values()):
        raise AssertionError(f"path E: a loss term is not finite: {tb}")
    print(f"  path E last loss terms {json.dumps({k: round(v, 5) for k, v in tb.items()})}")
    del net, opt, state, step
    torch.cuda.empty_cache()
    e_curriculum_steps(dev, cfg, meta, batches, smi)
    return counts


def path_e_demo(dev, smi):
    """The demo CLI on the shipped KITTI PointPillars YAML over two ``.bin``
    scenes (float32 x 4) with a checkpoint of seeded random weights
    (``spread_anchor_scores``): finite detections, K4 once a scene."""
    import shutil

    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.tools import demo

    cfg, meta = load_kitti()
    root = REPO / "build" / "path_e"
    shutil.rmtree(root, ignore_errors=True)
    (root / "scenes").mkdir(parents=True)
    try:
        rng = np.random.RandomState(23)
        for i in range(2):
            kitti_like_points(rng, 1, E_REAL_POINTS, meta.point_cloud_range)[0].tofile(
                root / "scenes" / f"{i:06d}.bin")
        net = spread_anchor_scores(build_network(cfg.MODEL, meta, device=dev, seed=5))
        torch.save({"model_state": net.state_dict()}, root / "random_weights.pth")
        del net
        _quiet_cli_logger()
        reset_counters()
        annos = demo.main(["--cfg_file", str(REPO / KITTI_CONFIG), "--data_path",
                           str(root / "scenes"), "--ext", ".bin", "--ckpt",
                           str(root / "random_weights.pth"), "--device", str(dev)])
        torch.cuda.synchronize()
        check_launches("path E demo scene", read_counters(), EXPECT_E_SERVING, 2)
        ok = len(annos) == 2 and all(len(a["score"]) and np.isfinite(a["boxes_lidar"]).all()
                                     and np.isfinite(a["score"]).all() for a in annos)
        print(f"path E demo: {len(annos)} .bin scenes, {[len(a['score']) for a in annos]} "
              f"detections, finite {'ok' if ok else 'FAIL'} ({smi})")
        if not ok:
            raise AssertionError("path E: the demo failed its checks")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def check_small_anchor_reference(dev):
    """KITTI PointPillars at a 64x64 grid in f32, the card (kernels) against
    the CPU (plain versions), same weights: the eval step (NMS_PRE_MAXSIZE
    2048, past K4's shared-memory layout), and one train step with the
    anchor curriculum on (loss, every gradient, batch statistics, the new
    AnchorCurriculumState, the confidence accumulators)."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.models.layers import BatchNorm
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta = load_kitti(grid=(64, 64, 1))
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 2048
    cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM = dict(E_CURRICULUM)
    names = list(cfg.CLASS_NAMES)
    batch = kitti_like_batch(np.random.RandomState(24), BATCH, meta.point_cloud_range,
                             meta.voxel_size, n=4096, real_points=3000, m=16, real=6)
    outs = []
    for d in (dev, "cpu"):
        net = spread_anchor_scores(build_network(cfg.MODEL, meta, device=d, seed=7))
        outs.append([t.cpu().numpy() for t in make_eval_step(net, cfg.MODEL, names, meta,
                                                             device=d)(batch)])
    (gb, gs, _, gv), (cb, cs, _, cv) = outs
    worst = 0.0
    for i in range(BATCH):
        a = np.concatenate([gb[i][gv[i]], gs[i][gv[i]][:, None]], -1)
        b = np.concatenate([cb[i][cv[i]], cs[i][cv[i]][:, None]], -1)
        if len(a) != len(b) or not len(a):
            raise AssertionError(f"small anchor reference: {len(a)} vs {len(b)} detections")
        worst = max(worst, float(np.abs(a[:, None] - b[None]).max(-1).min(1).max()))
    ok = worst <= 1e-3 and bool((gv == cv).all())
    print(f"small anchor reference (64x64 f32, card vs CPU): eval {int(gv.sum())} detections, "
          f"worst box/score diff {worst:.2e} (<= 1e-3) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's anchor eval step disagrees with the CPU reference")

    runs = []
    for d in (dev, "cpu"):
        net, _, state, step = build_trainer(d, cfg, meta, 1, seed=7)
        shift_norm_biases(spread_anchor_scores(net))
        running = {k: v for k, v in net.state_dict().items() if "running" in k}
        for v in running.values():
            v.zero_()
        loss, new_cur, aux, _ = step.loss_fn(state, batch, 0)
        loss.backward()
        grads = {k: p.grad.float().cpu().clone() for k, p in net.named_parameters()}
        stats = {k: v.cpu() / (1 - BatchNorm.MOMENTUM) for k, v in running.items()}
        runs.append((float(loss.detach()), grads, stats, [t.cpu() for t in new_cur[0]],
                     aux[0].confidence_sum.cpu(), aux[0].confidence_cnt.cpu()))
    (l0, g0, s0, c0, cs0, cc0), (l1, g1, s1, c1, cs1, cc1) = runs
    gmax = max(float(g.abs().max()) for g in g1.values())
    gerr = max(float(((g0[k] - g1[k]).abs() / (1e-3 * g1[k].abs().max() + 1e-5 * gmax)).max())
               for k in g1)
    serr = max(float(stat_err(s0, s1, k.rsplit(".", 1)[0]).max())
               for k in s1 if k.endswith("running_mean"))
    cerr = max(float((a.float() - b.float()).abs().max()) for a, b in zip(c0, c1))
    ok = (abs(l0 - l1) <= 1e-4 * abs(l1) and gerr <= 1.0 and serr <= STATS_RTOL
          and cerr <= 1e-5 and torch.equal(cc0, cc1)
          and float((cs0 - cs1).abs().max()) <= 1e-4 and float(cc1.sum()) > 0)
    print(f"small anchor train reference (64x64 f32, card vs CPU, LOSS_CURRICULUM): loss "
          f"{l0:.6f} vs {l1:.6f}; {len(g1)} gradients within 1e-3 of their max + 1e-5 of the "
          f"net's max (worst at {gerr:.3f} of that); batch statistics rel {serr:.2e} "
          f"(<= {STATS_RTOL:g}); curriculum state within {cerr:.2e} (<= 1e-5); confidence "
          f"counts {int(cc1.sum())} equal {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's anchor train step disagrees with the CPU reference")


def path_e(dev, smi, entries, calls):
    """Path E, KITTI PointPillars (anchor head, COMLoss's anchor half, K4
    at 4,096 candidates): the small reference, serving, the kernels at the
    path's shapes, training, the curriculum steps and the demo.  Returns
    the launch counts of its serving forward and of its train steps."""
    check_small_anchor_reference(dev)
    torch.cuda.empty_cache()
    serve_counts = path_e_serve(dev, smi, entries, calls)
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=E_CONV, dtypes=(torch.bfloat16,), path="E:")
    check_conv3x3_backward(dev, entries, shapes=E_CONV, wgrad_dtypes=(torch.bfloat16,),
                           path="E:")
    torch.cuda.empty_cache()
    train_counts = path_e_train(dev, smi)
    torch.cuda.empty_cache()
    path_e_demo(dev, smi)
    return serve_counts, train_counts


def load_voxel(config, pc_range=None):
    """A sparse-voxel YAML, its meta (the grid of its
    ``transform_points_to_voxels`` over its range, or over ``pc_range`` for
    a rehearsal) and that processor's config."""
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.ops.voxelize import grid_size_from_range
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / config))
    proc = next(p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                if p.NAME == "transform_points_to_voxels")
    pr = list(pc_range or cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    grid = tuple(int(g) for g in grid_size_from_range(pr, proc.VOXEL_SIZE))
    feats = len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list)
    return cfg, DatasetMeta(cfg.CLASS_NAMES, pr, list(proc.VOXEL_SIZE), grid, feats), proc


def voxelize_batch(batch, meta, proc, mode):
    """``batch`` with each scene's valid points hard-voxelized by the port's
    native host voxelizer (``voxelize_native``, the data processor's) and
    padded to the processor's MAX_NUMBER_OF_VOXELS[mode] as the collate
    pads: voxels (B, V, T, F), coords (B, V, 3) (-1 rows padding), counts."""
    from com_tpu_torch.ops.host_native import voxelize_native

    pts, mask = batch["points"], batch["points_mask"]
    b, f = pts.shape[0], pts.shape[2]
    v, t = int(proc.MAX_NUMBER_OF_VOXELS[mode]), int(proc.MAX_POINTS_PER_VOXEL)
    vox = np.zeros((b, v, t, f), np.float32)
    coords = np.full((b, v, 3), -1, np.int32)
    num = np.zeros((b, v), np.int32)
    for i in range(b):
        a, c, n = voxelize_native(pts[i][mask[i]], meta.point_cloud_range, meta.voxel_size, t, v)
        vox[i, :len(a)], coords[i, :len(a)], num[i, :len(a)] = a, c, n
    return dict(batch, voxels=vox, voxel_coords=coords, voxel_num_points=num)


def f_batches(rng, meta, proc, mode, count, points=POINTS):
    """``count`` path F batches: Waymo-like scenes (``waymo_like_batch``:
    ~100 objects in 500 slots, the COM side arrays) voxelized."""
    return [voxelize_batch(waymo_like_batch(rng, BATCH, points, meta.point_cloud_range,
                                            (0.32, 0.32, 6.0), len(meta.class_names)),
                           meta, proc, mode) for _ in range(count)]


def check_small_voxel_reference(dev):
    """CenterPoint-voxel (COMLoss, UCL on) at a 64 x 64 x 40 grid (0.5 x 0.5
    x 0.1 m over +-16 m) at full width in f32, 2,048 voxels a scene: the
    eval step and one train step, the card against the CPU."""
    from com_tpu_torch.models.detectors import DatasetMeta

    cfg, _, proc = load_voxel(VOXEL_CONFIG)
    meta = DatasetMeta(cfg.CLASS_NAMES, (-16.0, -16.0, -2.0, 16.0, 16.0, 2.0), (0.5, 0.5, 0.1),
                       (64, 64, 40), FEATS)
    proc.MAX_NUMBER_OF_VOXELS = {"train": 2048, "test": 2048}
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.BACKBONE_3D.VOXEL_CAPS = [2048, 1024, 512, 256]
    cfg.MODEL.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 64
    rng = np.random.RandomState(34)
    batch = voxelize_batch(waymo_like_batch(rng, BATCH, 4096, meta.point_cloud_range,
                                            (0.32, 0.32, 6.0), 3, m=64, real=20),
                           meta, proc, "train")
    compare_eval_step(dev, cfg, meta, batch, "path F small reference (64x64x40 f32, card vs CPU)")
    compare_train_step(dev, cfg, meta, batch,
                       "path F small train reference (64x64x40 f32, COMLoss, card vs CPU)")


def path_f_serve(dev, smi, pc_range=None, points=POINTS):
    """Path F serving: CenterPoint-voxel at full width (1498 x 1498 x 40
    grid, bf16 BEV and head) with seeded random weights through
    ``make_eval_step``, three batches of two Waymo-like scenes voxelized to
    90,000 slots: outputs checked, latency, peak memory and launches; the
    eval step's stages; the 3D backbone's split (``sparse_stages``) and its
    active sites against the caps."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.tools.perf import sparse_stages
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, proc = load_voxel(VOXEL_CONFIG, pc_range)
    post = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
    thresh = float(post.SCORE_THRESH)
    net = build_network(cfg.MODEL, meta, device=dev, seed=0)
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    batches = f_batches(np.random.RandomState(32), meta, proc, "test", 3, points)
    step(batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    latencies, outs = [], []
    for b in batches:
        t0 = time.perf_counter()
        outs.append([t.cpu().numpy() for t in step(b)])
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    voxels = [int((b["voxel_num_points"] > 0).sum(1).min()) for b in batches]
    print(f"path F serving (CenterPoint-voxel, batch {BATCH}, {voxels} voxels at least a scene "
          f"of {proc.MAX_NUMBER_OF_VOXELS['test']} slots): latency ms a batch (host clock, "
          f"outputs copied back) {[round(x, 2) for x in latencies]}, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({smi})")
    for i, (boxes, scores, labels, valid) in enumerate(outs):
        ok = (boxes.shape == (BATCH, int(post.NMS_CONFIG.NMS_POST_MAXSIZE), 7)
              and np.isfinite(boxes[valid]).all() and (scores[valid] >= thresh).all()
              and np.isin(labels[valid], [1, 2, 3]).all())
        print(f"  batch {i}: {valid.sum(1).tolist()} detections, finite boxes and scores >= "
              f"{thresh}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"path F batch {i} returned malformed detections")
    check_launches("path F serving forward", counts, EXPECT_F_SERVING, len(batches))
    stage_breakdown(net, step, batches[0], "path F ", iters=3, smi=smi)
    inputs = {k: torch.as_tensor(batches[0][k], device=dev) for k in VOXEL_KEYS}
    split = sparse_stages.backbone_split(net, inputs, iters=3)
    print(f"path F backbone_3d ms (one forward, batch {BATCH}, mean of 3): "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})} ({smi})")
    for row in sparse_stages.site_counts(net, inputs):
        print(f"  sites {row['stage']}: active {row['active']} of cap {row['cap']}, "
              f"{row['dropped']} dropped past the cap")
    return counts


def path_f_train(dev, smi, pc_range=None, points=POINTS):
    """Path F training: ``train_model`` on the shipped CenterPoint-voxel
    COMLoss YAML (UCL on) at full width, 2 mini-epochs of 3 steps over two
    batches voxelized to 80,000 slots: the (3, 96) feedback each epoch, the
    curriculum state moved off its start, the step's stages and the
    overfit check."""
    cfg, meta, proc = load_voxel(VOXEL_CONFIG, pc_range)
    batches = f_batches(np.random.RandomState(33), meta, proc, "train", 2, points)
    loader = SyntheticLoader(batches, 3)
    counts, (net, opt, state, step), _ = run_training(
        dev, "F (CenterPoint-voxel, COMLoss)", cfg, meta, loader, 2, 3, EXPECT_F_TRAIN, smi=smi)
    conf = loader.dataset.confidence_groups
    (cur,) = state.curriculum
    ok = (len(conf) == 2 and all(c.shape == (3, 96) and np.isfinite(c).all() for c in conf)
          and bool(cur.initialized) and 0.0 < float(cur.avg_confidence) < 1.0
          and bool(torch.isfinite(torch.stack([cur.mean, cur.std])).all()))
    print(f"  path F feedback {[c.shape for c in conf]}; curriculum avg_confidence "
          f"{float(cur.avg_confidence):.5f} mean {float(cur.mean):.5f} std {float(cur.std):.5f} "
          f"initialized {bool(cur.initialized)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path F: the feedback or the curriculum state is wrong")
    stage_and_overfit(dev, (net, opt, state, None, batches[0], cfg, meta),
                      label="path F (CenterPoint-voxel)", smi=smi)
    return counts


def path_f_cli(dev, smi, pc_range=None, bg_points=120000):
    """The voxel YAML through the train CLI (1 epoch of 2 steps) and the test
    CLI on its checkpoint, over path C's synthetic dataset (4 scenes, the
    flagship's augmentor) with the voxel YAML's own DATA_PROCESSOR (the
    native voxelizer, 80,000 / 90,000 slots); SCORE_THRESH 0 for the
    evaluation, as path D.  Launches: path F's a train step."""
    import shutil

    import yaml

    from com_tpu_torch.tools import test, train

    cfg, meta, _ = load_voxel(VOXEL_CONFIG, pc_range)
    flagship, _ = load_config()
    root = REPO / "build" / "path_f"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        data_cfg = _plain(path_c_dataset_cfg(flagship, bg_points=bg_points))
        data_cfg.update(NUM_SCENES=2 * BATCH, POINT_CLOUD_RANGE=list(meta.point_cloud_range),
                        DATA_PROCESSOR=_plain(cfg.DATA_CONFIG.DATA_PROCESSOR))
        model_cfg = _plain(cfg.MODEL)
        model_cfg["DENSE_HEAD"]["POST_PROCESSING"]["SCORE_THRESH"] = D_SCORE_THRESH
        yaml_path = root / "voxel_path_f.yaml"
        yaml_path.write_text(yaml.safe_dump({
            "CLASS_NAMES": list(cfg.CLASS_NAMES), "DATA_CONFIG": data_cfg, "MODEL": model_cfg,
            "OPTIMIZATION": _plain(cfg.OPTIMIZATION)}))
        _quiet_cli_logger()
        base = ["--cfg_file", str(yaml_path), "--output_dir", str(root / "out"),
                "--workers", str(D_WORKERS), "--device", str(dev)]
        reset_counters()
        t0 = time.perf_counter()
        first = train.main(base + ["--seed", str(D_SEED), "--epochs", "1"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_launches("F train step (CLI)", read_counters(), EXPECT_F_TRAIN,
                       first["iterations"])
        ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
        t0 = time.perf_counter()
        (res,) = test.main(base + ["--ckpt", str(ckpt)])
        test_wall = time.perf_counter() - t0
        annos = res["det_annos"]
        post = cfg.MODEL.DENSE_HEAD.POST_PROCESSING
        ok = (first["iterations"] == 2 and ckpt.exists() and len(annos) > 0
              and all(np.isfinite(a["boxes_lidar"]).all() and (np.diff(a["score"]) <= 0).all()
                      and len(a["score"]) <= int(post.NMS_CONFIG.NMS_POST_MAXSIZE)
                      and set(a["pred_labels"]) <= {1, 2, 3} for a in annos))
        print(f"path F CLIs: train {first['iterations']} steps in {wall:.2f} s wall (dataset, "
              f"model and loader included); test {len(annos)} frames in {test_wall:.2f} s, "
              f"{[len(a['score']) for a in annos]} detections, {res['sec_per_frame']:.4f} s a "
              f"frame ({smi}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("path F: the train / test CLIs failed their checks")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def path_f(dev, smi, entries, calls):
    """Path F, CenterPoint-voxel with COMLoss (``centerpoint_voxel_comloss
    .yaml``) at full width: the small references, serving, K3 and K2 at the
    path's shapes, training and the CLIs.  Returns the launch counts of its
    serving forward and of its train steps."""
    check_small_voxel_reference(dev)
    torch.cuda.empty_cache()
    serve_counts = path_f_serve(dev, smi)
    torch.cuda.empty_cache()
    check_stamp(dev, entries, calls, hw=(188, 188), path="F:")
    check_conv3x3(dev, entries, shapes=F_CONV, dtypes=(torch.bfloat16,), path="F:")
    check_conv3x3_backward(dev, entries, shapes=F_CONV, wgrad_dtypes=(torch.bfloat16,),
                           path="F:")
    torch.cuda.empty_cache()
    train_counts = path_f_train(dev, smi)
    torch.cuda.empty_cache()
    path_f_cli(dev, smi)
    return serve_counts, train_counts


def path_g(dev, smi, entries, calls, pc_range=None, points=E_POINTS, real_points=E_REAL_POINTS):
    """Path G, SECOND (``configs/kitti_models/second.yaml``: MeanVFE, the
    sparse backbone, HeightCompression, the anchor head) at full width
    (1408 x 1600 x 40 grid, batch 4, ~20,000 KITTI-like points a scene,
    16,000 / 40,000 voxel slots), seeded random weights with the class bias
    raised (``spread_anchor_scores``): one serving batch and its stages, K4
    on its decoded (4, 4096) candidates, K2 at its shapes, two train steps.
    Returns the launch counts of the serving forward and of the steps."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.tools.perf import sparse_stages
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, proc = load_voxel(SECOND_CONFIG, pc_range)
    thresh = float(cfg.MODEL.POST_PROCESSING.SCORE_THRESH)
    rng = np.random.RandomState(35)
    batch = voxelize_batch(kitti_like_batch(rng, E_BATCH, meta.point_cloud_range,
                                            (0.16, 0.16, 4.0), n=points, real_points=real_points),
                           meta, proc, "test")
    net = spread_anchor_scores(build_network(cfg.MODEL, meta, device=dev, seed=0))
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    t0 = time.perf_counter()
    boxes, scores, labels, valid = (t.cpu().numpy() for t in step(batch))
    torch.cuda.synchronize()
    latency = (time.perf_counter() - t0) * 1e3
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    ok = (bool(valid.any(1).all()) and np.isfinite(boxes[valid]).all()
          and (scores[valid] >= thresh).all() and np.isin(labels[valid], [1, 2, 3]).all())
    print(f"path G serving (SECOND, KITTI, batch {E_BATCH}): latency {latency:.2f} ms (host "
          f"clock, outputs copied back), {valid.sum(1).tolist()} detections, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({smi}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path G returned malformed detections")
    check_launches("path G serving forward", counts, EXPECT_G_SERVING, 1)
    stage_breakdown(net, step, batch, "path G ", iters=3, smi=smi)
    inputs = {k: torch.as_tensor(batch[k], device=dev) for k in VOXEL_KEYS}
    split = sparse_stages.backbone_split(net, inputs, iters=3)
    print(f"path G backbone_3d ms (one forward, batch {E_BATCH}, mean of 3): "
          f"{json.dumps({k: round(v, 3) for k, v in split.items()})} ({smi})")
    for row in sparse_stages.site_counts(net, inputs):
        print(f"  sites {row['stage']}: active {row['active']} of cap {row['cap']}, "
              f"{row['dropped']} dropped past the cap")
    over, sv = e_decoded_candidates(net, cfg, meta, batch, dev)
    check_k4_cases(dev, entries, calls, over, sv, smi, ", path G", "G:nms", iters=20)
    del net, step
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=G_CONV, dtypes=(torch.bfloat16,), path="G:")
    check_conv3x3_backward(dev, entries, shapes=G_CONV, wgrad_dtypes=(torch.bfloat16,),
                           path="G:")
    torch.cuda.empty_cache()
    batches = [voxelize_batch(kitti_like_batch(rng, E_BATCH, meta.point_cloud_range,
                                               (0.16, 0.16, 4.0), n=points,
                                               real_points=real_points), meta, proc, "train")
               for _ in range(2)]
    train_counts, _, _ = run_training(dev, "G (SECOND, KITTI)", cfg, meta,
                                      SyntheticLoader(batches, 2), 1, 2, EXPECT_G_TRAIN,
                                      counts_confidences=False, smi=smi)
    return counts, train_counts


def stage_and_overfit(dev, trainer, steps=10, label="flagship", smi=""):
    """A train step's stages by CUDA events (forward, loss, backward,
    optimizer; mean over the steps after the first), and the overfit check:
    the loss falls over ``steps`` steps on one repeated batch.  Returns the
    step, the batch on the card and the last step's metrics."""
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
    losses, sums, metrics = [], {}, None
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
    batch_size = dev_batch["gt_boxes"].shape[0]
    print(f"stage ms (one {label} train step, batch {batch_size}, mean of {steps - 1}): "
          f"{json.dumps({k: round(v, 3) for k, v in sums.items()})} total {total:.3f}"
          + (f" ({smi})" if smi else ""))
    ok = np.isfinite(losses).all() and losses[-1] < losses[0]
    print(f"overfit: loss over {steps} steps on one batch {[round(x, 4) for x in losses]} "
          f"falls {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the loss does not fall on a repeated batch")
    return step, dev_batch, metrics


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
    stage_breakdown(net, step, {"points": scenes[:2], "points_mask": np.ones((2, POINTS), bool)},
                    "")
    check_nms(dev, entries, calls, net, cfg, meta, smi)
    if profile:  # counted in the first profiling session, as without --profile
        check_device_kernels(calls)
        profile_wgrad_sweep(dev)
        profile_step(step, scenes)
    del net, step
    torch.cuda.empty_cache()
    a_counts, trainer = train_path(dev, CONFIG, "A (flagship)", 2, 3, (3, 96), EXPECT_TRAIN)
    step, dev_batch, _ = stage_and_overfit(dev, trainer)
    if profile:
        profile_train(trainer[2], step, dev_batch)
    del trainer, step, dev_batch
    torch.cuda.empty_cache()
    b_counts, _ = train_path(dev, CAR_CONFIG, "B (car_com1, UCL)", 1, 2, (1, 96),
                             EXPECT_TRAIN_UCL)
    torch.cuda.empty_cache()
    train_path_c(dev)
    torch.cuda.empty_cache()
    path_d(dev, smi)
    torch.cuda.empty_cache()
    e_serve_counts, e_train_counts = path_e(dev, smi, entries, calls)
    torch.cuda.empty_cache()
    _, f_train_counts = path_f(dev, smi, entries, calls)
    torch.cuda.empty_cache()
    g_serve_counts, g_train_counts = path_g(dev, smi, entries, calls)
    # each kernel's launches on the path that runs it: training path A,
    # serving for K4, path B for K3's last_wins mode, the sweep for T1-T4;
    # paths E, F and G's shapes: their training, and their serving for K4
    counts = {**a_counts, "nms": serve_counts["nms"],
              "stamp_last_wins": b_counts["stamp_last_wins"],
              **{f"wgrad_{v}": sweep_counts[f"wgrad_{v}"] for v in WGRAD_VARIANTS},
              **{f"{p}:{k}": v for p, c in (("E", e_train_counts), ("F", f_train_counts),
                                            ("G", g_train_counts)) for k, v in c.items()},
              "E:nms": e_serve_counts["nms"], "G:nms": g_serve_counts["nms"]}
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
