"""Drive the PyTorch/CUDA port's serving and training paths (over its own
data pipeline, through its train, test and demo CLIs, for the PointPillars
anchor head, the sparse-voxel detectors, the two-stage Voxel-RCNN and
SECOND-IoU, PV-RCNN and PointRCNN; the KITTI configs from a KITTI tree on
disk), its
serving artifact (export, load and the HTTP server), its data-parallel
training and evaluation, and its wgrad sweep on one NVIDIA GPU.

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
   the registered op's autograd against conv3x3_plain's autograd), K2w, T1-T4 at
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
13. Path J, Voxel-RCNN (``configs/kitti_models/voxel_rcnn_car.yaml``: path
   G's first stage, the anchor head's proposals through the proposal layer,
   ``VoxelRCNNHead``'s voxel-query pooling over x_conv2/3/4) at full width:
   batch 2 of ~20,000 KITTI-like points a scene in 16,000 / 40,000 voxel
   slots, the 1408 x 1600 x 40 grid, 4,096 -> 512 proposals in training
   and 1,024 -> 100 in serving, 128 RoIs a scene, 6^3 grid points, scores
   spread as path E's: the 64 x 64 x 40 f32 eval step, card against CPU;
   three serving batches (latency, peak memory, launches: K2 11, K4 2 a
   forward) and the eval step's stages (the proposal layer's decode, sort,
   self-IoU, K4 and rest; ``voxel_query`` and the pooling a scale; the
   FCs; the final NMS's steps); K4 on the proposal candidates the model
   decodes at (2, 4096) and (2, 1024) and on the final NMS's (2, 100), each
   with two synthetic cases; K2, dgrad and K2w at (2,200,176,256->128),
   (2,200,176,128->128), (2,100,88,256->256); ``train_model`` 2 steps
   whose GT follow the model's own top proposals, every loss term
   finite, the foreground RoIs a step (> 0), K4 1 a step, and the step's
   stages.
14. Path K, SECOND-IoU (``configs/kitti_models/second_iou.yaml``:
   ``SECONDHead``'s 7 x 7 rotated sampling of the 512-channel BEV map) at
   full width, batch 4: the small f32 reference, one serving batch and its
   stages, 2 train steps with ``rcnn_loss_iou`` finite and foreground RoIs.
15. Path H, the serving artifact (``com_tpu_torch/utils/serving.py``, the
   export and serve CLIs): the flagship at full width exported on the card
   through ``com_tpu_torch.tools.export.main`` (its seconds and MB); the
   serve CLI started in a fresh process (``python -X importtime -m
   com_tpu_torch.tools.serve``, on a free port) until /health is ready,
   then 6 single-scene POST /infer from 3 client threads, each response
   equal, as float32, to the artifact called here on that scene in a batch
   padded as BatchServer pads it; the latencies, /stats and the modules the
   server imported (no ``com_tpu_torch.models`` or ``.train``, no JAX).  In
   process: ``load_artifact``, the artifact against the eager step on a
   full-width batch (within the eager step's own run-to-run difference)
   with one forward's launches (K1 2, K2 14, K4 1), and both timed, 20
   batches each after 3 warm-up, alternating.  A CPU-exported artifact of
   the synthetic config run on the card (``move_to_device_pass``) against
   the CPU, with the eager step's launches; the anchor branch exported on
   path E's configuration and held to its eager step with path E's
   launches.
16. Path I, the data mesh (``com_tpu_torch/parallel``): two ranks
   spawned on the card (``parallel.launch.run_ranks``, gloo: NCCL takes one
   rank a card) after the kernels are built.  I.1: the flagship at full
   width, seeded weights, a scene a rank of a global batch of 2, 3 steps
   in bf16 (as configured) and in f32 with the norm biases +3, against one
   process on the whole batch after step 1 and step 3 (loss, confidence
   sums and counts, running statistics, parameters where |g| is not tiny:
   gated in f32, the bf16 run gated on the step-1 loss and the counts and
   the rest printed), the ranks bitwise equal, each rank's launches, the
   all-reduces a step, their bytes and time, a rank's step beside one
   process's.  I.2: ``train_model`` over path C's pipeline with
   ``build_dataloader(dist=True)``, 2 epochs of 3 steps a rank: both
   samplers hold the same confidences, the all-reduce of the ranks' sums;
   checkpoints from rank 0 alone; the epoch-end reduction's time.  I.3:
   ``eval_model`` over 2 shards of 6 scenes against one process (in
   order, within 1e-4), K4's launches.  I.4: the train CLI under
   ``torchrun --nproc_per_node 1 ... --multihost`` (NCCL, world 1, 1 epoch
   of 3 steps, a checkpoint).  With two cards I.1 again over NCCL, else a
   line that says it did not run.
17. Path L, KITTI from disk (``com_tpu_torch/tools/kitti_tree.py``): a
   KITTI tree written from a seed under ``build/path_l`` (16 train and 8
   val frames of 120,000 points, a 360 degree sweep with its road plane,
   10-15 labelled Cars, Pedestrians and Cyclists a frame, the GT database
   and ``kitti_dbinfos_train.pkl``), each YAML at its own grid and batch 4
   with ``DATA_CONFIG.DATA_PATH`` set through ``--set``.  L.1:
   ``kitti_models/pointpillar.yaml`` through the train CLI (1 epoch of 4
   steps; how many pasted boxes the road plane, read without calib, moved
   out of the range's z) and the test CLI on the val split (the KITTI AP
   table, s a frame, ``--infer_time``; the val GT as detections through
   the same evaluation); L.2: ``second_multihead.yaml`` (AnchorHeadMulti,
   three-class NMS): a serving batch from the tree, its stages, K4 on its
   decoded (4, 4096) three-class candidates and two synthetic cases, the
   batch in f32 on the card against the CPU (plain versions) at
   NMS_PRE_MAXSIZE ``L_COMPARE_PRE``, K2 / dgrad / K2w at the heads'
   shared conv (4,200,176,512->64), 2 train steps; L.3: the host
   loader's rate and each augmentation's ms for ``pointpillar_newaugs`` and
   ``pointpillar_pyramid_aug``, one train step each; L.4:
   ``custom_models/second.yaml`` through the test CLI on a custom tree of
   4 frames (seeded weights, class bias raised), K2 at its 188 x 188 BEV's
   shapes.  Launch counts per step or forward: K1, K2, K2w and K4.
18. Path M, PV-RCNN (``configs/kitti_models/pv_rcnn.yaml``: path G's
   first stage, ``VoxelSetAbstraction``'s 4,096 FPS keypoints over the raw
   points, x_conv3, x_conv4 and the BEV map, ``PointHeadSimple``, the top
   1,024 anchors as proposals, 100 RoIs in serving and 128 sampled in
   training, ``PVRCNNHead``'s ball query of the keypoints at each RoI's
   6^3 grid points) at full width, batch 4 of ~20,000 KITTI-like points
   in 32,768 slots, scores spread as path E's.  M.1: the 64 x 64 x 40 f32
   eval step, card against CPU, with the FPS and every ball query's
   indices equal (the first difference named); three serving batches
   (latency, peak memory, launches: K2 11, K4 1 a forward) and the eval
   step's stages (the PFE split into FPS, each source's query and block,
   the BEV interpolation and the fusion; the RoI head into the grid's
   query, its PointNet and the FCs); K4 on the final NMS's (4, 100)
   candidates and two synthetic cases; K2, dgrad and K2w at path G's
   shapes.  M.2: 2 train steps whose GT follow the model's own proposals
   (every loss term finite, ``point_loss_cls`` among them; foreground
   RoIs; K2, dgrad and K2w 11 each a step), their stages and peak memory.
   M.3: ``pv_rcnn.yaml`` through the train CLI (1 epoch of 4 steps) and
   the test CLI (KITTI AP, ``--infer_time``) over a KITTI tree as path
   L's.  M.4: ``custom_models/pv_rcnn.yaml`` (1504 x 1504 x 40, 131,072
   points a scene) through the test CLI, peak memory printed.  M.5:
   PV-RCNN++'s modules at ``waymo_models/pv_rcnn_plusplus.yaml``'s widths
   (SPC ``VoxelSetAbstraction`` over 6 sectors around 128 RoIs a scene,
   ``PVRCNNPlusPlusHead``'s two vector-pool groups) on 2 Waymo-like scenes,
   timed, scene 0 card against CPU in f32.
19. Path N, PointRCNN (``configs/kitti_models/pointrcnn.yaml``:
   ``PointNet2MSG`` over the raw points, 4,096 / 1,024 / 256 / 64 FPS
   samples at two radii each and feature propagation back to every point,
   ``PointHeadBox``'s class and box a point, the 4,096 best point boxes
   through the proposal layer's NMS (K4) to 100 RoIs in serving, 512 and
   128 sampled in training, ``PointRCNNHead`` over 512 pooled points a
   RoI) at full width, batch 2 of ~20,000 KITTI-like points in 32,768
   slots, the point head's class bias +1 and box layer x0.02.  N.1:
   ``tests/test_pointrcnn.py``'s small config in f32, the eval step and one
   train step card against CPU (the step within the tolerances or twice
   either device's own difference with the scenes swapped).  N.2: three
   serving batches (latency, peak memory, K4 2 a forward) and the eval
   step's stages (each set abstraction's FPS, query and block, the FPs,
   the point head, the proposal IoU and K4, the RoI pool, the head's SAs
   and FCs, the final NMS); K4 on the (2, 4096) proposal candidates of
   serving and of training and on the final NMS's (2, 100), each with two
   synthetic cases.  N.3: 2 train steps whose GT follow the model's own
   proposals (every term finite, foreground RoIs, K4 1 a step) and their
   stages; ``train_model`` over the train split of a KITTI tree written
   under ``build/path_n`` through ``KittiDataset`` with the YAML's own
   DATA_CONFIG; one step of ``pointrcnn_iou.yaml``.  N.4: the train and
   test CLIs raise NotImplementedError, as ``com_tpu``'s cannot run
   PointRCNN.
20. Launch counts: every counter is zeroed just before each path (the
   sweep, serving, A, B, C, D's, E's, F's, G's, J's, K's, H's, L's, M's and
   N's phases, and in each rank of I) and read just after, against the calls the sweep
   reports and the expected counts per
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

import contextlib
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
H_DIR = REPO / "build" / "path_h"  # path H's artifacts, removed after the path
H_REQUESTS, H_CLIENTS, H_WARMUP, H_TIMED = 6, 3, 3, 20
H_SMALL_POINTS = 2048
SYNTH_CONFIG = "configs/synthetic_models/centerpoint_synth_com.yaml"
# TF32 as a fresh process has it, read before phase 1 turns it off
LIBRARY_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
VOXEL_RCNN_CONFIG = "configs/kitti_models/voxel_rcnn_car.yaml"
SECOND_IOU_CONFIG = "configs/kitti_models/second_iou.yaml"
J_BATCH, K_BATCH = 2, 4  # the YAMLs' BATCH_SIZE_PER_GPU
J_GT = 32  # GT cars a scene in training, on the model's own top proposals
J_CONV = ((2, 200, 176, 256, 128), (2, 200, 176, 128, 128), (2, 100, 88, 256, 256))
EXPECT_J_SERVING = {"conv3x3": 11, "nms": 2}  # the proposal NMS and the final one
EXPECT_J_TRAIN = {"conv3x3": 11, "conv3x3_dgrad": 11, "conv3x3_wgrad": 11, "nms": 1}
EXPECT_F_SERVING = EXPECT_G_SERVING = {"conv3x3": 11, "nms": 1}
EXPECT_G_TRAIN = {"conv3x3": 11, "conv3x3_dgrad": 11, "conv3x3_wgrad": 11}
EXPECT_F_TRAIN = {**EXPECT_G_TRAIN, "stamp_gauss": 1, "stamp_last_wins": 1}
L_DIR = REPO / "build" / "path_l"  # path L's trees and CLI outputs, removed after the path
L_SEED, L_TRAIN, L_VAL, L_POINTS, L_CUSTOM = 16, 16, 8, 120000, 4
L_WORKERS = 4
L_COMPARE_PRE = 512  # L.2's card-vs-CPU NMS_PRE_MAXSIZE: the CPU's (4, 4096) IoU takes minutes
MULTIHEAD_CONFIG = "configs/kitti_models/second_multihead.yaml"
NEWAUGS_CONFIG = "configs/kitti_models/pointpillar_newaugs.yaml"
PYRAMID_CONFIG = "configs/kitti_models/pointpillar_pyramid_aug.yaml"
CUSTOM_CONFIG = "configs/custom_models/second.yaml"
EXPECT_L2_SERVING = {"conv3x3": 12, "nms": 1}  # SECOND's 11 and the shared conv of the heads
L2_CONV = ((4, 200, 176, 512, 64),)  # the heads' shared conv; the rest are path G's shapes
L4_CONV = ((4, 188, 188, 256, 128), (4, 188, 188, 128, 128), (4, 94, 94, 256, 256))
EXPECT_L2_TRAIN = {"conv3x3": 12, "conv3x3_dgrad": 12, "conv3x3_wgrad": 12}
# path M: PV-RCNN on KITTI (its proposals are the top TEST_PRE / TRAIN_PRE
# anchors, no NMS: K4 runs in the final NMS alone), PV-RCNN++'s modules
PV_RCNN_CONFIG = "configs/kitti_models/pv_rcnn.yaml"
CUSTOM_PV_RCNN_CONFIG = "configs/custom_models/pv_rcnn.yaml"
PVRCNN_PP_CONFIG = "configs/waymo_models/pv_rcnn_plusplus.yaml"
M_DIR = REPO / "build" / "path_m"  # path M's trees and CLI outputs, removed after the path
M_BATCH = 4  # the YAML's BATCH_SIZE_PER_GPU
M4_POINTS = 160000  # a custom frame's points: past the 131,072 the collate keeps
M5_BATCH, M5_POINTS, M5_ROIS = 2, 65536, 128
M_TERMS = ("rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rcnn_loss_cls", "rcnn_loss_reg",
           "point_loss_cls")
EXPECT_M_SERVING = {"conv3x3": 11, "nms": 1}
EXPECT_M_TRAIN = {"conv3x3": 11, "conv3x3_dgrad": 11, "conv3x3_wgrad": 11}
# path N: PointRCNN on KITTI (no voxel or BEV stage: PointNet2MSG over the
# raw points, the points' boxes as proposals through K4, then the final NMS)
POINTRCNN_CONFIG = "configs/kitti_models/pointrcnn.yaml"
POINTRCNN_IOU_CONFIG = "configs/kitti_models/pointrcnn_iou.yaml"
N_DIR = REPO / "build" / "path_n"  # path N's tree and CLI outputs, removed after the path
N_BATCH = 2  # the YAML's BATCH_SIZE_PER_GPU
N_TRAIN = 8  # the tree's train frames: 4 steps of train_model
N_TERMS = ("point_loss_cls", "point_loss_box", "rcnn_loss_cls", "rcnn_loss_reg",
           "rcnn_loss_corner")
EXPECT_N_SERVING = {"nms": 2}  # the proposal NMS over the points' boxes and the final one
EXPECT_N_TRAIN = {"nms": 1}
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
    check_detections(label, *outs)


def check_detections(label, card, cpu):
    """The card's (boxes, scores, labels, valid) against the CPU's: the same
    valid slots, each detection within 1e-3 of one of the other's."""
    (gb, gs, _, gv), (cb, cs, _, cv) = card, cpu
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
# multi_class_nms_bev: no _kept_slots, its own top-k after K4 ("rest")
MULTI_NMS_MARKS = ["topk", "sort", "iou", "k4", "k4_end"]
MULTI_NMS_PARTS = ("decode", "topk", "sort_gathers", "iou", "k4", "rest")


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
            part_names = {tuple(NMS_MARKS): NMS_PARTS, ("topk", *NMS_MARKS): E_NMS_PARTS,
                          tuple(MULTI_NMS_MARKS): MULTI_NMS_PARTS}.get(tuple(labels))
            if part_names is None:
                raise AssertionError(f"decode_nms ran its steps as {labels}")
            seq = [marks[-2], *(ev for _, ev in sub), marks[-1]]
            for name, a, b in zip(part_names, seq, seq[1:]):
                parts[name] = parts.get(name, 0.0) + a.elapsed_time(b) / iters
    finally:
        anchor_head.top_candidates = orig_top
        undo()
        for h in hooks:
            h.remove()
    sums.pop("gap", None)  # the gaps between slots
    total = sum(sums.values())
    card = f" ({smi})" if smi else ""
    bs = batch.get("batch_size") or len(next(iter(batch.values())))
    print(f"{label}stage ms (one eval step, batch {bs}, mean of "
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


def compare_train_step(dev, cfg, meta, batch, label, counts_confidences=True,
                       own_noise=False):
    """One train step of ``cfg`` on ``batch`` on the card (kernels) against
    the same weights on the CPU (plain versions), every norm's bias moved
    by 3 and the running statistics started at 0: loss, every gradient, the
    batch statistics and the confidence accumulators (all zero where the
    model has no COM groups: ``counts_confidences`` False).  With
    ``own_noise`` each device also runs the batch with its scenes in the
    other order (the same step in other f32 sums), and the card may differ
    from the CPU by twice the larger of the two devices' differences from
    themselves there (two devices' rounding against one's), where that is
    more than the tolerances: a model whose max pools and few-row norms
    turn rounding into more than 1e-5 of a statistic."""
    from com_tpu_torch.models.layers import BatchNorm

    def run(d, b):
        net, _, state, step = build_trainer(d, cfg, meta, 1, seed=7)
        shift_norm_biases(net)
        running = {k: v for k, v in net.state_dict().items() if "running" in k}
        for v in running.values():  # from 0, one update is (1 - 0.99) x the batch statistic
            v.zero_()
        loss = step.loss_fn(state, b, 0)[0]
        loss.backward()
        grads = {k: p.grad.float().cpu().clone() for k, p in net.named_parameters()}
        stats = {k: v.cpu() / (1 - BatchNorm.MOMENTUM) for k, v in running.items()}
        net.zero_grad(set_to_none=True)
        state, _ = step(state, b, 0)
        return float(loss.detach()), grads, stats, state.conf_sum.cpu(), state.conf_cnt.cpu()

    def errors(a, b):
        (la, ga, sa), (lb, gb, sb) = a[:3], b[:3]
        gmax = max(float(g.abs().max()) for g in gb.values())
        gerr = max(float(((ga[k] - gb[k]).abs() / (1e-3 * gb[k].abs().max() + 1e-5 * gmax)).max())
                   for k in gb)
        serr = max(float(stat_err(sa, sb, k.rsplit(".", 1)[0]).max())
                   for k in sb if k.endswith("running_mean"))
        return abs(la - lb) / abs(lb), gerr, serr

    (l0, _, _, cs0, cc0), (l1, _, _, cs1, cc1) = card, cpu = run(dev, batch), run("cpu", batch)
    lerr, gerr, serr = errors(card, cpu)
    ltol, gtol, stol = 1e-4, 1.0, STATS_RTOL
    if own_noise:
        swapped = {k: v[::-1].copy() for k, v in batch.items()}
        own = [max(a, b) for a, b in zip(errors(run(dev, swapped), card),
                                         errors(run("cpu", swapped), cpu))]
        ltol, gtol, stol = max(ltol, 2 * own[0]), max(gtol, 2 * own[1]), max(stol, 2 * own[2])
        print(f"{label}: each device against itself with the scenes swapped, the larger: loss "
              f"rel {own[0]:.2e}, gradients at {own[1]:.3f} of the tolerance, batch statistics "
              f"rel {own[2]:.2e}")
    ok = (lerr <= ltol and gerr <= gtol and serr <= stol
          and torch.equal(cc0, cc1) and float((cs0 - cs1).abs().max()) <= 1e-4
          and (float(cc1.sum()) > 0) == counts_confidences)
    print(f"{label}: loss {l0:.6f} vs {l1:.6f}; "
          f"{len(cpu[1])} gradients within 1e-3 of their max + 1e-5 of the net's max "
          f"(worst at {gerr:.3f} of that, allowed {gtol:.3f}); batch statistics rel {serr:.2e} "
          f"(<= {stol:.2e}); "
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
                 step_wrap=None, epoch_hook=None, counts_confidences=True, smi="",
                 prepare=None, terms=()):
    """``train_model`` over ``loader`` with the device batch keys of the
    model, from a fresh trainer; finite losses, gradients (at each epoch's
    last step, outside the timed intervals) and parameters, the last
    epoch's confidence counts (non-zero, or zero where the path has no COM
    groups: ``counts_confidences`` False), and the launch counts per step.
    ``step_wrap(step)`` may wrap the train step; ``epoch_hook(epoch,
    state)`` runs at each epoch's first step; ``prepare(net)`` adjusts the
    seeded weights first; each of ``terms`` (metric names) is printed a
    step and must be finite.  Returns
    the counts, the trainer and the step times (CUDA events between steps,
    the first of each epoch left out)."""
    from com_tpu_torch.train.loop import train_model
    from com_tpu_torch.train.step import device_batch_keys

    net, opt, state, step = build_trainer(dev, cfg, meta, steps)
    if prepare is not None:
        prepare(net)
    run_step = step_wrap(step) if step_wrap else step
    params = [p for p in net.parameters()]
    marks, losses, finite, term_rows = [], [], [], []

    def all_finite(tensors):
        return torch.stack([torch.isfinite(t).all() for t in tensors]).all()

    def hook(epoch, it, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((epoch, ev))
        losses.append(metrics["loss"])
        term_rows.append(torch.stack([metrics[k].float() for k in terms]) if terms else None)
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
    if terms:
        rows = torch.stack(term_rows).cpu().numpy()
        ok = ok and bool(np.isfinite(rows).all())
        print(f"  {label} loss terms a step: " + "; ".join(
            f"{k} {[round(float(x), 5) for x in rows[:, i]]}" for i, k in enumerate(terms)))
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
    order, as (over, valid), (B, K, K) and (B, K); with MULTI_CLASSES_NMS
    the overlaps of two classes masked out, as ``multi_class_nms_bev``."""
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
        boxes, scores, labels = decode_anchor_boxes(out, anchors, len(cfg.CLASS_NAMES),
                                                    box_coder_for(head), head)
        top, idx = top_candidates(scores, int(post.NMS_CONFIG.NMS_PRE_MAXSIZE))
        top_bx = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
        order, sb, sv = nms._sorted(top_bx, top, top > float(post.SCORE_THRESH))
        over = nms._self_iou(sb) > float(post.NMS_CONFIG.NMS_THRESH)
        if post.NMS_CONFIG.get("MULTI_CLASSES_NMS", False):
            sl = torch.gather(torch.gather(labels, 1, idx), 1, order)
            over = over & (sl[:, :, None] == sl[:, None, :])
            sv = sv & (sl > 0)
    return over.contiguous(), sv.contiguous()


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


def two_stage_marks(net, mark):
    """Hooks that record a CUDA event (``mark(label)``) where each stage of a
    two-stage forward and its post-processing starts: the first-stage slots
    (a "gap" after each), the proposal layer ("proposal.decode", then
    ``nms_bev``'s sort and gathers, self-IoU, K4, kept slots and rest), the
    RoI head ("roi_head": grid points or the rotated sampling; Voxel-RCNN's
    "voxel_query" and "pool" a scale; "fcs"), then the final NMS's steps
    ("final.*"); with PV-RCNN's point stages (the "pfe" and "point_head"
    slots) also ``_mark_point_steps``'s.  Returns the function that removes
    them."""
    from com_tpu_torch.models.roi_heads import voxelrcnn_head

    phase = ["proposal"]
    hooks = []
    for s in ("vfe", "backbone_3d", "map_to_bev", "pfe", "backbone_2d", "dense_head",
              "point_head"):
        if getattr(net, s, None) is not None:
            # the PFE opens with its keypoint sampling
            name = "pfe.fps" if s == "pfe" else s
            hooks.append(getattr(net, s).register_forward_pre_hook(
                lambda *_, name=name: mark(name)))
            hooks.append(getattr(net, s).register_forward_hook(lambda *_: mark("gap")))
    if getattr(net, "pfe", None) is not None:
        undo_points = _mark_point_steps(net, mark)
    elif hasattr(net.backbone_3d, "SA_modules"):
        undo_points = _mark_pointnet2_steps(net, mark)
    else:
        undo_points = None
    hooks.append(net.roi_head.register_forward_pre_hook(lambda *_: mark("roi_head")))
    # the stack runs layer by layer (fc.run_stack): its first layer opens the FCs
    fcs = getattr(net.roi_head, "shared_fc_layer", None) or net.roi_head.cls_layers
    hooks.append(fcs[0].register_forward_pre_hook(lambda *_: mark("fcs")))

    def head_end(*_):
        phase[0] = "final"
        mark("final.decode")

    hooks.append(net.roi_head.register_forward_hook(head_end))
    orig_proposals = net._proposals
    wrapped = "_proposals" in net.__dict__  # follow_proposals' wrapper, kept

    def proposals(batch):
        phase[0] = "proposal"
        mark("proposal.decode")
        out = orig_proposals(batch)
        mark("stage2_rois")
        return out

    net._proposals = proposals
    orig_query = voxelrcnn_head.batched_voxel_query

    def query(*args, **kw):
        mark("voxel_query")
        out = orig_query(*args, **kw)
        mark("pool")
        return out

    voxelrcnn_head.batched_voxel_query = query
    nms_names = {"sort": "sort_gathers", "iou": "iou", "k4": "k4", "k4_end": "kept_slots",
                 "rest": "rest"}
    undo_nms = _mark_nms_steps(lambda n: mark(f"{phase[0]}.{nms_names[n]}"))

    def undo():
        undo_nms()
        if undo_points is not None:
            undo_points()
        voxelrcnn_head.batched_voxel_query = orig_query
        if wrapped:
            net._proposals = orig_proposals
        else:
            del net._proposals
        for h in hooks:
            h.remove()

    return undo


def two_stage_breakdown(net, run, label, iters=3, smi="", stage_hook_marks=None):
    """Device ms of each stage of ``run()`` (an eval step, or a train step
    whose ``stage_hook`` records "forward", "loss", "backward", "optimizer"
    through ``stage_hook_marks``), CUDA events by ``two_stage_marks``, summed
    a stage over its intervals, mean over ``iters`` runs after a warm-up;
    an interval is named by the mark that opens it."""
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    if stage_hook_marks is not None:
        stage_hook_marks.append(mark)
    undo = two_stage_marks(net, mark)
    sums = {}
    try:
        for i in range(iters + 1):
            marks.clear()
            mark("upload")
            run()
            mark("end")
            torch.cuda.synchronize()
            if i:
                for (name, a), (_, b) in zip(marks, marks[1:]):
                    sums[name] = sums.get(name, 0.0) + a.elapsed_time(b) / iters
    finally:
        undo()
        if stage_hook_marks is not None:
            stage_hook_marks.clear()
    total = sum(sums.values())
    print(f"{label} stage ms (mean of {iters}): "
          f"{json.dumps({k: round(v, 3) for k, v in sums.items()})} total {total:.3f}"
          + (f" ({smi})" if smi else ""))
    return sums


def kitti_voxel_batches(rng, meta, proc, mode, count, b, points, real_points):
    return [voxelize_batch(kitti_like_batch(rng, b, meta.point_cloud_range, (0.16, 0.16, 4.0),
                                            n=points, real_points=real_points), meta, proc, mode)
            for _ in range(count)]


def follow_proposals(net, per_scene=J_GT):
    """In training, put the first ``per_scene`` GT slots of each scene on the
    proposals ``net`` makes at that moment (boxes, labels), before the RoI
    targets are drawn and the anchor loss reads them.  Random weights
    propose nothing near fixed GT, and one Adam step at the one-cycle's
    first rate moves every proposal (each weight of conv_box moves by lr
    with its gradient's sign: a coherent shift over its 512 inputs; with GT
    set once from the seeded model's proposals, step 2 saw 0 foreground
    RoIs on the card).  Adds no launch: the proposals are the step's own."""
    orig = net._proposals

    def proposals(batch):
        out = orig(batch)
        if net.training and "gt_boxes" in batch:
            rois, _, labels, valid = out
            gt = batch["gt_boxes"].clone()
            k = min(per_scene, gt.shape[1], rois.shape[1])
            gt[:, :k, :7] = rois[:, :k, :7] * valid[:, :k, None]
            gt[:, :k, 7] = (labels[:, :k] * valid[:, :k]).to(gt.dtype)
            batch["gt_boxes"] = gt
        return out

    net._proposals = proposals
    return net


def check_small_two_stage_reference(dev, config, label):
    """``config`` at full width, f32, over a 64 x 64 x 40 grid (0.5 x 0.5 x
    0.1 m over +-16 m) with 2,048 voxels a scene, scores spread: the eval
    step on the card against the CPU."""
    from com_tpu_torch.models.detectors import DatasetMeta

    cfg, _, proc = load_voxel(config)
    meta = DatasetMeta(cfg.CLASS_NAMES, (-16.0, -16.0, -2.0, 16.0, 16.0, 2.0), (0.5, 0.5, 0.1),
                       (64, 64, 40), E_FEATS)
    proc.MAX_NUMBER_OF_VOXELS = {"train": 2048, "test": 2048}
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.BACKBONE_3D.VOXEL_CAPS = [2048, 1024, 512, 256]
    rng = np.random.RandomState(36)
    pts = np.concatenate([rng.uniform(-15, 15, (2, 4096, 2)), rng.uniform(-1.4, 1.4, (2, 4096, 1)),
                          rng.rand(2, 4096, 1)], -1).astype(np.float32)
    batch = voxelize_batch({"points": pts, "points_mask": np.ones((2, 4096), bool)}, meta, proc,
                           "test")
    compare_eval_step(dev, cfg, meta, batch, label, prepare=spread_anchor_scores)


def check_two_stage_serving(dev, label, cfg, meta, batches, expect, smi,
                            spread=spread_anchor_scores):
    """Seeded weights, scores spread (``spread(net)``), through
    ``make_eval_step``: each batch's
    latency (host clock, outputs copied back), peak memory, launches; as
    many slots as the final NMS gives (the lesser of NMS_POST_MAXSIZE and
    the RoIs), finite boxes, a valid detection a scene at least, scores
    over the threshold, labels in range.  Returns (net, step, counts)."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    post = cfg.MODEL.POST_PROCESSING
    thresh = float(post.SCORE_THRESH)
    net = spread(build_network(cfg.MODEL, meta, device=dev, seed=0))
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    rois = []
    hook = net.roi_head.register_forward_pre_hook(lambda m, args: rois.append(
        args[0]["rois"].shape[1]))
    step(batches[0])  # warm-up
    hook.remove()
    slots = min(int(post.NMS_CONFIG.NMS_POST_MAXSIZE), rois[0])  # the NMS's output slots
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
    labels_ok = list(range(1, len(cfg.CLASS_NAMES) + 1))
    print(f"path {label} serving (batch {len(batches[0]['points_mask'])}): latency ms a batch "
          f"{[round(x, 2) for x in latencies]}, max_memory_allocated {peak / 2**30:.2f} GiB "
          f"({smi})")
    for i, (boxes, scores, labels, valid) in enumerate(outs):
        ok = (boxes.shape[1] == slots
              and bool(valid.any(1).all()) and np.isfinite(boxes[valid]).all()
              and (scores[valid] > thresh).all() and np.isin(labels[valid], labels_ok).all())
        print(f"  batch {i}: {valid.sum(1).tolist()} detections, finite boxes, scores > "
              f"{thresh}: {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"path {label} batch {i} returned malformed detections")
    check_launches(f"path {label} serving forward", counts, expect, len(batches))
    return net, step, counts


def proposal_candidates(net, cfg, batch, dev, train):
    """What the proposal layer hands K4 for ``batch``, in ``net``'s training
    or eval mode: the top NMS_PRE_MAXSIZE decoded boxes, in the NMS's score
    order, as (over, valid)."""
    import copy

    from com_tpu_torch.models.dense_heads.anchor_head import decode_anchor_boxes
    from com_tpu_torch.models.detectors import Detector3D
    from com_tpu_torch.train.step import model_input_keys

    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG["TRAIN" if train else "TEST"]
    probe = copy.deepcopy(net).train(train)  # training mode moves the norms' statistics
    with torch.no_grad():
        first = Detector3D.forward(probe, {k: torch.as_tensor(batch[k], device=dev)
                                           for k in model_input_keys(cfg.MODEL)})
        boxes, scores, _ = decode_anchor_boxes(first, probe.anchors, len(cfg.CLASS_NAMES),
                                               probe.box_coder, cfg.MODEL.DENSE_HEAD)
        return nms_overlaps(boxes, scores, nms_cfg)


def nms_overlaps(boxes, scores, nms_cfg):
    """The proposal layer's K4 input: the top NMS_PRE_MAXSIZE of ``boxes``
    by ``scores``, in the NMS's score order, as (over, valid)."""
    from com_tpu_torch.models.dense_heads.anchor_head import top_candidates
    from com_tpu_torch.ops import nms

    top, idx = top_candidates(scores, min(int(nms_cfg.NMS_PRE_MAXSIZE), scores.shape[1]))
    bx = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
    _, sb, sv = nms._sorted(bx[..., :7], top, torch.isfinite(top))
    over = (nms._self_iou(sb) > float(nms_cfg.NMS_THRESH)).contiguous()
    return over, sv.contiguous()


def final_candidates(net, cfg, batch, dev):
    """What the two-stage eval step hands K4: the RCNN boxes of the RoIs
    scored and filtered, in score order, as (over, valid)."""
    from com_tpu_torch.models.roi_heads.roi_targets import decode_rcnn_boxes
    from com_tpu_torch.ops import nms
    from com_tpu_torch.train.step import model_input_keys

    post = cfg.MODEL.POST_PROCESSING
    with torch.no_grad():
        out = net({k: torch.as_tensor(batch[k], device=dev) for k in model_input_keys(cfg.MODEL)})
        boxes = decode_rcnn_boxes(out["rois"][..., :7], out["rcnn_reg"])
        scores = torch.sigmoid(out["rcnn_cls"])
        valid = (scores > float(post.SCORE_THRESH)) & out["roi_valid"]
        _, sb, sv = nms._sorted(boxes, scores, valid)
        over = (nms._self_iou(sb) > float(post.NMS_CONFIG.NMS_THRESH)).contiguous()
    return over, sv.contiguous()


def two_stage_training(dev, label, cfg, meta, batches, expect, terms, smi,
                       spread=spread_anchor_scores):
    """``train_model`` 1 mini-epoch of 2 steps over ``batches``, seeded
    weights with the scores spread (``spread(net)``) and GT following the
    proposals (``follow_proposals``): every term finite, the foreground
    RoIs a step (> 0), launches; then the step's stages, mean of 2 after a
    warm-up.  Returns the counts."""
    fg = []
    trainer = {}

    def prepare(net):
        follow_proposals(spread(net))
        trainer["net"] = net
        net.roi_head.register_forward_pre_hook(
            lambda m, args: fg.append(args[0]["roi_targets"].reg_valid.sum())
            if m.training and "roi_targets" in args[0] else None)

    counts, (net, opt, state, _), _ = run_training(
        dev, label, cfg, meta, SyntheticLoader(batches, 2), 1, 2, expect,
        counts_confidences=False, smi=smi, prepare=prepare, terms=terms)
    fg_counts = [int(x) for x in fg]
    ok = len(fg_counts) == 2 and min(fg_counts) > 0
    print(f"  path {label} foreground RoIs a step: {fg_counts} of "
          f"{int(cfg.MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE) * len(batches[0]['points_mask'])} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"path {label}: a train step saw no foreground RoI")
    from com_tpu_torch.train.step import device_batch_keys, make_train_step

    hook_marks = []
    step = make_train_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, opt, None, device=dev,
                           stage_hook=lambda name: [m(name) for m in hook_marks])
    keys = device_batch_keys(cfg.MODEL)
    dev_batch = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items() if k in keys}
    two_stage_breakdown(net, lambda: step(state, dev_batch, 0), f"path {label} train step",
                        iters=2, smi=smi, stage_hook_marks=hook_marks)
    return counts


def path_j(dev, smi, entries, calls, pc_range=None, points=E_POINTS, real_points=E_REAL_POINTS):
    """Path J, Voxel-RCNN (``configs/kitti_models/voxel_rcnn_car.yaml``: path
    G's first stage, the anchor head's proposals, ``VoxelRCNNHead`` over
    x_conv2/3/4) at full width: batch 2 of ~20,000 KITTI-like points a scene
    in 16,000 / 40,000 voxel slots, the 1408 x 1600 x 40 grid, 4,096 -> 512
    proposals in training and 1,024 -> 100 in serving, 128 RoIs a scene, a
    6^3 grid; seeded weights, scores spread.  The small f32 reference; three
    serving batches and the eval step's stages; K4 on the proposal
    candidates at (2, 4096) and (2, 1024) and the final NMS's (2, 100); K2,
    dgrad and K2w at its shapes; 2 train steps.  Returns the launch counts
    of the serving forward and of the steps."""
    check_small_two_stage_reference(dev, VOXEL_RCNN_CONFIG,
                                    "path J small reference (Voxel-RCNN 64x64x40 f32, card vs CPU)")
    cfg, meta, proc = load_voxel(VOXEL_RCNN_CONFIG, pc_range)
    rng = np.random.RandomState(37)
    batches = kitti_voxel_batches(rng, meta, proc, "test", 3, J_BATCH, points, real_points)
    net, step, serve_counts = check_two_stage_serving(dev, "J (Voxel-RCNN, KITTI)", cfg, meta,
                                                      batches, EXPECT_J_SERVING, smi)
    two_stage_breakdown(net, lambda: step(batches[0]), "path J eval step", smi=smi)
    for train, tag in ((True, ", path J train proposals"), (False, ", path J serving proposals")):
        over, sv = proposal_candidates(net, cfg, batches[0], dev, train)
        check_k4_cases(dev, entries, calls, over, sv, smi, tag,
                       "J:nms_train" if train else "J:nms", iters=20)
    over, sv = final_candidates(net, cfg, batches[0], dev)
    check_k4_cases(dev, entries, calls, over, sv, smi, ", path J final NMS", "J:nms", iters=50)
    del net, step
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=J_CONV, dtypes=(torch.bfloat16,), path="J:")
    check_conv3x3_backward(dev, entries, shapes=J_CONV, wgrad_dtypes=(torch.bfloat16,),
                           path="J:")
    torch.cuda.empty_cache()
    train_counts = two_stage_training(
        dev, "J (Voxel-RCNN, KITTI)", cfg, meta,
        kitti_voxel_batches(rng, meta, proc, "train", 2, J_BATCH, points, real_points),
        EXPECT_J_TRAIN,
        ("rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rcnn_loss_cls", "rcnn_loss_reg",
         "rcnn_loss_corner"), smi)
    return serve_counts, train_counts


def path_k(dev, smi, pc_range=None, points=E_POINTS, real_points=E_REAL_POINTS):
    """Path K, SECOND-IoU (``configs/kitti_models/second_iou.yaml``: path G's
    first stage, its proposals, ``SECONDHead``'s 7 x 7 rotated sampling of
    the 512-channel BEV map) at full width, batch 4: the small f32
    reference, one serving batch and its stages, 2 train steps with
    ``rcnn_loss_iou``.  Returns the launch counts of the serving forward and
    of the steps."""
    check_small_two_stage_reference(dev, SECOND_IOU_CONFIG,
                                    "path K small reference (SECOND-IoU 64x64x40 f32, card vs CPU)")
    cfg, meta, proc = load_voxel(SECOND_IOU_CONFIG, pc_range)
    rng = np.random.RandomState(38)
    batches = kitti_voxel_batches(rng, meta, proc, "test", 1, K_BATCH, points, real_points)
    net, step, serve_counts = check_two_stage_serving(dev, "K (SECOND-IoU, KITTI)", cfg, meta,
                                                      batches, EXPECT_J_SERVING, smi)
    two_stage_breakdown(net, lambda: step(batches[0]), "path K eval step", smi=smi)
    del net, step
    torch.cuda.empty_cache()
    train_counts = two_stage_training(
        dev, "K (SECOND-IoU, KITTI)", cfg, meta,
        kitti_voxel_batches(rng, meta, proc, "train", 2, K_BATCH, points, real_points),
        EXPECT_J_TRAIN,
        ("rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rcnn_loss_iou"), smi)
    return serve_counts, train_counts


@contextlib.contextmanager
def library_defaults():
    """TF32 switched as a fresh process has it (phase 1 turns it off here):
    the serve CLI runs with the library's defaults, so the calls held
    against its responses run with them too."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = LIBRARY_TF32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def _host(out):
    return [t.cpu().numpy() for t in out]


def detection_diff(a, b):
    """max |a - b| over the boxes and scores of two eval outputs (boxes,
    scores, labels, valid), or inf where their valid slots or labels
    differ."""
    (ab, asc, al, av), (bb, bsc, bl, bv) = a, b
    if not (np.array_equal(av, bv) and np.array_equal(al[av], bl[bv])):
        return math.inf
    if not av.any():
        return 0.0
    return float(max(np.abs(ab[av] - bb[bv]).max(), np.abs(asc[av] - bsc[bv]).max()))


def held_to_eager(label, run, step, batch, expect, smi):
    """The artifact's ``run`` against the eager ``step`` on ``batch``:
    within the eager step's own run-to-run difference (two calls), with
    one forward's launch counts as ``expect``."""
    e1, e2 = _host(step(batch)), _host(step(batch))
    torch.cuda.synchronize()
    reset_counters()
    got = _host(run(batch))
    counts = read_counters()
    eager, art = detection_diff(e1, e2), detection_diff(got, e1)
    ok = art <= eager
    print(f"{label}: {int(got[3].sum())} detections; against the eager step max |diff| {art:.3e}, "
          f"the eager step against itself {eager:.3e} {'ok' if ok else 'FAIL'} ({smi})")
    if not ok:
        raise AssertionError(f"{label}: the artifact disagrees with the eager step")
    check_launches(f"{label} forward", counts, expect, 1)


def _serve_address(proc, timeout):
    """host:port from the first line the serve CLI prints."""
    import select

    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    line = proc.stdout.readline() if ready else ""
    if "http://" not in line:
        raise AssertionError(f"path H: the serve CLI printed {line!r} (exit {proc.poll()})")
    return line.split("http://", 1)[1].split()[0]


def h_http(stem, scenes, thresh, dev):
    """``python -X importtime -m com_tpu_torch.tools.serve`` on a free port
    (its stderr lists every module the process imports): /health until
    ready, one POST /infer a scene from ``H_CLIENTS`` client threads, then
    /stats.  Returns the responses, their latencies (ms), the stats, the
    seconds to ready and the modules imported."""
    import urllib.error
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    log = H_DIR / "serve_imports.log"
    t0 = time.perf_counter()
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "com_tpu_torch.tools.serve", "--artifact",
             str(stem), "--port", "0", "--score_thresh", str(thresh), "--max_wait_ms", "50",
             "--device", str(dev)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        base = "http://" + _serve_address(proc, 300)
        deadline = time.perf_counter() + 300
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=10) as r:
                    if json.load(r)["ready"]:
                        break
            except (urllib.error.URLError, ConnectionError):
                pass
            if proc.poll() is not None or time.perf_counter() > deadline:
                raise AssertionError(f"path H: the server never became ready (exit "
                                     f"{proc.poll()}): {log.read_text()[-2000:]}")
            time.sleep(0.2)
        ready_s = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            warm = json.load(r)  # the warm-up scene's batch

        def request(pts):
            req = urllib.request.Request(base + "/infer", data=pts.tobytes(), method="POST",
                                         headers={"X-Num-Feats": str(pts.shape[1])})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                body = json.load(r)
            return body, (time.perf_counter() - t) * 1e3

        with ThreadPoolExecutor(H_CLIENTS) as pool:
            answered = list(pool.map(request, scenes))
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.load(r)
        stats["requests_batches_ms"] = stats["infer_ms_total"] - warm["infer_ms_total"]
        stats["requests_batches"] = stats["batches"] - warm["batches"]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    imported = [line.rsplit("|", 1)[-1].strip() for line in log.read_text().splitlines()
                if line.startswith("import time:")]
    return [a[0] for a in answered], [a[1] for a in answered], stats, ready_s, imported


def path_h(dev, smi, pc_range=None, points=POINTS, kitti_grid=None):
    """Path H, the serving artifact: the flagship exported on the card
    through the export CLI and served over HTTP by the serve CLI in a fresh
    process; in process, the artifact against the eager step, its launches
    a forward and both timed; a CPU-exported artifact run on the card; the
    anchor branch on path E's configuration.  ``pc_range``, ``points`` and
    ``kitti_grid`` cut it for a rehearsal."""
    import shutil

    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.tools import export
    from com_tpu_torch.train.eval import make_eval_step
    from com_tpu_torch.utils.serving import load_artifact

    shutil.rmtree(H_DIR, ignore_errors=True)
    cfg, meta = load_config()
    args = ["--cfg_file", str(REPO / CONFIG), "--output", str(H_DIR / "flagship"),
            "--batch_size", str(BATCH), "--max_points", str(points), "--device", str(dev)]
    if pc_range is not None:
        args += ["--set", "DATA_CONFIG.POINT_CLOUD_RANGE", str(list(pc_range))]
        cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(pc_range)
        meta = export.export_meta(cfg)
    t0 = time.perf_counter()
    stem, manifest = export.main(args)
    export_s = time.perf_counter() - t0
    mb = stem.with_suffix(".pt2").stat().st_size / 1e6
    print(f"path H export (flagship, batch {BATCH}, {points} points, grid "
          f"{manifest['grid_size']}, on the card): {export_s:.2f} s, artifact {mb:.2f} MB ({smi})")

    # the HTTP server in a fresh process
    thresh = float(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH)
    rng = np.random.RandomState(31)
    sizes = [points - points // 40 * i for i in range(H_REQUESTS)]
    scenes = [waymo_like_points(rng, 1, n, meta.point_cloud_range)[0] for n in sizes]
    responses, latencies, stats, ready_s, imported = h_http(stem, scenes, thresh, dev)
    forbidden = [m for m in imported if m.split(".")[0] in ("jax", "com_tpu")
                 or m.startswith(("com_tpu_torch.models", "com_tpu_torch.train"))]
    batches = stats.pop("requests_batches")
    infer_ms = stats.pop("requests_batches_ms") / max(batches, 1)
    print(f"path H serve CLI: ready {ready_s:.2f} s after its start (interpreter, imports, "
          f"load, one warm-up scene); {len(scenes)} POST /infer from {H_CLIENTS} threads, "
          f"latency ms {[round(x, 2) for x in latencies]} (p50 {np.median(latencies):.2f}, max "
          f"{max(latencies):.2f}); /stats {json.dumps(stats)} (the warm-up scene's batch "
          f"included), the requests' {batches} batches {infer_ms:.2f} ms each ({smi})")
    loaded = "com_tpu_torch.utils.serving" in imported  # the log was read
    print(f"path H serve CLI imported {len(imported)} modules, com_tpu_torch.utils.serving "
          f"{'among them' if loaded else 'NOT among them'}; com_tpu_torch.models, "
          f"com_tpu_torch.train, jax or com_tpu: {forbidden or 'none'} "
          f"{'ok' if loaded and not forbidden else 'FAIL'}")
    if forbidden or not loaded:
        raise AssertionError("path H: the serve CLI imported model code")
    if stats["requests"] != H_REQUESTS + 1:  # and the warm-up scene
        raise AssertionError(f"path H: /stats counts {stats['requests']} requests")

    # each response against the artifact called here on its scene alone,
    # padded as BatchServer pads
    t0 = time.perf_counter()
    run, _ = load_artifact(stem, device=dev)
    load_s = time.perf_counter() - t0
    worst = 0.0
    with library_defaults():
        for i, (scene, resp) in enumerate(zip(scenes, responses)):
            pts = np.zeros((BATCH, points, FEATS), np.float32)
            mask = np.zeros((BATCH, points), bool)
            pts[0, :len(scene)], mask[0, :len(scene)] = scene, True
            boxes, scores, labels, valid = _host(run({"points": pts, "points_mask": mask}))
            keep = valid[0] & (scores[0] >= thresh)
            got = [np.asarray(resp[k], np.float32).reshape(-1, *shape)
                   for k, shape in (("boxes", (7,)), ("scores", ()))]
            same = (np.array_equal(np.asarray(resp["labels"]), labels[0][keep])
                    and got[0].shape == boxes[0][keep].shape)
            if same:
                worst = max(worst, float(np.abs(got[0] - boxes[0][keep]).max(initial=0)),
                            float(np.abs(got[1] - scores[0][keep]).max(initial=0)))
            print(f"  request {i}: {len(scene)} points, {len(resp['scores'])} detections; labels "
                  f"{'equal' if same else 'DIFFER'} to the artifact called directly")
            if not same:
                raise AssertionError(f"path H request {i}: the response is not the artifact's")
    ok = worst == 0.0
    print(f"path H responses against the direct call: boxes and scores max |diff| {worst:.3e} "
          f"(equal as float32) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path H: a response differs from the artifact's direct call")

    # in process: against the eager step, launches, times
    net = build_network(cfg.MODEL, meta, device=dev, seed=0)  # the export CLI's weights
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    full = waymo_like_points(np.random.RandomState(6), BATCH, points, meta.point_cloud_range)
    batch = {"points": torch.as_tensor(full, device=dev),
             "points_mask": torch.ones((BATCH, points), dtype=torch.bool, device=dev)}
    t0 = time.perf_counter()
    run(batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    print(f"path H load_artifact in process: {load_s:.2f} s (the kernels built already), first "
          f"batch {first_ms:.2f} ms ({smi})")
    held_to_eager("path H artifact (flagship, full width)", run, step, batch, EXPECT_SERVING, smi)
    times = {"artifact": [], "eager": []}
    for i in range(H_WARMUP + H_TIMED):
        for name, fn in (("artifact", run), ("eager", step)):
            t0 = time.perf_counter()
            fn(batch)
            torch.cuda.synchronize()
            if i >= H_WARMUP:
                times[name].append((time.perf_counter() - t0) * 1e3)
    print("path H batch ms (host clock, synced, on the card; alternating, "
          f"{H_WARMUP} warm-up each): " + "; ".join(
              f"{k} median {np.median(v):.3f} (min {min(v):.3f}, max {max(v):.3f}) over {len(v)}"
              for k, v in times.items()) + f" ({smi})")
    del net, step, run, batch
    torch.cuda.empty_cache()
    h_cpu_artifact(dev, smi)
    h_anchor(dev, smi, kitti_grid)
    shutil.rmtree(H_DIR, ignore_errors=True)


def h_cpu_artifact(dev, smi, points=H_SMALL_POINTS):
    """The synthetic config exported on the CPU, loaded for the card (the
    program moved by ``move_to_device_pass``) and for the CPU: the same
    detections as the CPU (``check_detections``), and the eager step's
    launches on the card."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.tools import export
    from com_tpu_torch.train.eval import make_eval_step
    from com_tpu_torch.utils.config import cfg_from_yaml_file
    from com_tpu_torch.utils.serving import load_artifact

    stem, manifest = export.main(["--cfg_file", str(REPO / SYNTH_CONFIG), "--output",
                                  str(H_DIR / "synth_cpu"), "--batch_size", str(BATCH),
                                  "--max_points", str(points), "--device", "cpu"])
    run_cpu, _ = load_artifact(stem, device="cpu")
    t0 = time.perf_counter()
    run_card, _ = load_artifact(stem, device=dev)
    move_s = time.perf_counter() - t0
    pts = waymo_like_points(np.random.RandomState(32), BATCH, points,
                            manifest["point_cloud_range"])
    batch = {"points": pts, "points_mask": np.ones((BATCH, points), bool)}
    cfg = cfg_from_yaml_file(str(REPO / SYNTH_CONFIG))
    meta = export.export_meta(cfg)
    step = make_eval_step(build_network(cfg.MODEL, meta, device=dev), cfg.MODEL,
                          list(cfg.CLASS_NAMES), meta, device=dev)
    reset_counters()
    step(batch)
    eager = read_counters()
    reset_counters()
    card = _host(run_card(batch))
    counts = read_counters()
    print(f"path H CPU-exported artifact (synthetic config, batch {BATCH}, {points} points): "
          f"loaded for the card in {move_s:.2f} s ({smi})")
    check_detections("path H CPU-exported artifact on the card against it on the CPU", card,
                     _host(run_cpu(batch)))
    check_launches("path H CPU-exported artifact forward on the card", counts,
                   {k: v for k, v in eager.items() if v}, 1)
    if not all(eager[k] for k in ("seg_scan", "conv3x3", "nms")):
        raise AssertionError(f"path H: the synthetic eval step launched {eager}")


def h_anchor(dev, smi, grid=None):
    """The anchor branch exported on path E's configuration (KITTI
    PointPillars, batch 4, K4 at NMS_PRE_MAXSIZE 4,096, scores spread) and
    held to its eager step on one batch."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step
    from com_tpu_torch.utils.serving import (export_eval_step, load_artifact, make_manifest,
                                             write_artifact)

    cfg, meta = load_kitti(grid)
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True  # the scenes come presorted
    names = list(cfg.CLASS_NAMES)
    net = spread_anchor_scores(build_network(cfg.MODEL, meta, device=dev, seed=0))
    spec = {"points": ((E_BATCH, E_POINTS, E_FEATS), torch.float32),
            "points_mask": ((E_BATCH, E_POINTS), torch.bool)}
    stem = H_DIR / "kitti_pointpillar"
    t0 = time.perf_counter()
    program = export_eval_step(net, cfg.MODEL, names, meta, spec, device=dev)
    write_artifact(stem, program, make_manifest(cfg, meta, spec, [dev.type]))
    export_s = time.perf_counter() - t0
    run, _ = load_artifact(stem, device=dev)
    print(f"path H anchor export (KITTI PointPillars, batch {E_BATCH}, grid "
          f"{list(meta.grid_size)}): {export_s:.2f} s, artifact "
          f"{stem.with_suffix('.pt2').stat().st_size / 1e6:.2f} MB ({smi})")
    batch = kitti_like_batch(np.random.RandomState(21), E_BATCH, meta.point_cloud_range,
                             meta.voxel_size, n=E_POINTS, real_points=E_REAL_POINTS)
    batch = {k: batch[k] for k in ("points", "points_mask")}
    step = make_eval_step(net, cfg.MODEL, names, meta, device=dev)
    held_to_eager("path H anchor artifact (KITTI PointPillars)", run, step, batch,
                  EXPECT_E_SERVING, smi)


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


# ----------------------------------------------------------------- path I
I_RANKS, I_STEPS, I_EPOCHS, I_EVAL_SCENES, I_SEED = 2, 3, 2, 6, 21
I_TIMEOUT_S = 300  # a collective of path I that waits longer fails its rank
I_DIR = REPO / "build" / "path_i"  # the ranks' results and checkpoints, removed after the path
# path I.1 against the single process.  In bf16 (the flagship as configured)
# a rank's norms sum its rows and the all-reduce adds the partial sums where
# one process sums the batch at once, so a bf16 rounding of an activation can
# fall the other way and flip a ReLU or the sign of a small gradient (then
# Adam moves that parameter by -lr, not +lr): there the gates are the ranks
# bitwise equal, the counts exact and the step-1 loss (the forward alone)
# within I_BF16_LOSS_RTOL; the rest is printed.  The f32 run (norm biases
# +3, as every whole-model gradient comparison of the repo) is gated on all
# of it, after 1 step and after I_STEPS:
I_BF16_LOSS_RTOL = 2e-3
I_LOSS_RTOL = (1e-5, 1e-4)
I_CONF_RTOL = (1e-4, 1e-3)  # the confidence sums; the counts are exact
I_STATS_TOL = (1e-5, 1e-3)  # ``stat_err`` of the running statistics
# parameters where the step-1 gradient is not tiny (above I_SURE of its
# tensor's max and I_SURE / 10 of the net's): after one Adam step the update
# is +-lr wherever the signs agree, so 1e-6; after I_STEPS 0.1 of the lr sum
I_SURE = 1e-2
I_THREADS = 4  # torch's host threads a rank (8 cores, 2 ranks)


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def counted_collectives(log):
    """Record (bytes, host seconds) of every ``torch.distributed.all_reduce``
    in the block (the data mesh's reductions call it through the module;
    gloo's call on a CUDA tensor returns once the result is back on the
    card)."""
    import torch.distributed as dist

    real = dist.all_reduce

    def counted(t, *args, **kwargs):
        t0 = time.perf_counter()
        out = real(t, *args, **kwargs)
        log.append((t.numel() * t.element_size(), time.perf_counter() - t0))
        return out

    dist.all_reduce = counted
    try:
        yield log
    finally:
        dist.all_reduce = real


def i_config(grid=None):
    cfg, meta = load_config(grid)
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True  # the batches and the pipeline presort
    return cfg, meta


def i_snapshot(state, net):
    """Loss-independent state of a step for the comparisons: confidence
    sums and counts (reduced over the ranks, the state's own left as they
    are), running statistics, parameters; on the host."""
    from com_tpu_torch.parallel.sharding import all_reduce_

    conf = [state.conf_sum.clone(), state.conf_cnt.clone()]
    all_reduce_(*conf)
    return {"conf_sum": conf[0].cpu(), "conf_cnt": conf[1].cpu(),
            "stats": {k: v.cpu().clone() for k, v in net.state_dict().items() if "running" in k},
            "params": {k: p.detach().cpu().clone() for k, p in net.named_parameters()}}


def i1_steps(dev, batch, grid, mesh=None, f32=False):
    """I_STEPS train steps of the flagship (seed I_SEED) on ``batch`` (the
    rank's shard under ``mesh``): the loss and ``i_snapshot`` after step 1
    and the last, the step-1 gradients (single process), the launch counts,
    the step times (host clock between syncs, steps 2..) and, under a mesh,
    each step's all-reduce bytes.  ``f32``: MIXED_PRECISION off and every
    norm's bias moved up by 3 (``shift_norm_biases``), the repo's setting
    for comparing whole-model gradients element by element."""
    cfg, meta = i_config(grid)
    if f32:
        cfg.MODEL.MIXED_PRECISION = False
    net, opt, state, step = build_trainer(dev, cfg, meta, I_STEPS, seed=I_SEED)
    if f32:
        shift_norm_biases(net)
    out = {"snap": [], "loss": [], "ms": [], "collectives": [],
           "lr": [opt.lr_fn(i) for i in range(I_STEPS)]}
    reset_counters()
    for s in range(I_STEPS):
        log = []
        _sync(dev)
        t0 = time.perf_counter()
        with counted_collectives(log):
            state, metrics = step(state, batch, 0)
            _sync(dev)
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["collectives"].append(log)
        out["loss"].append(float(metrics["loss"]))
        if s == 0 and mesh is None:
            out["grads"] = {k: p.grad.float().cpu().clone() for k, p in net.named_parameters()}
        if s in (0, I_STEPS - 1):
            out["snap"].append(i_snapshot(state, net))
    out["counts"] = read_counters()
    del net, opt, state, step
    return out


def i_batch(grid, points):
    _, meta = i_config(grid)
    return waymo_like_batch(np.random.RandomState(I_SEED), BATCH, points, meta.point_cloud_range,
                            meta.voxel_size, 3)


def i_dataset_cfg(cfg, meta, scenes, bg_points, max_points):
    ds_cfg = path_c_dataset_cfg(cfg, bg_points=bg_points, max_points=max_points)
    ds_cfg.NUM_SCENES = scenes
    ds_cfg.POINT_CLOUD_RANGE = list(meta.point_cloud_range)
    return ds_cfg


def i2_loop(mesh, grid, points, bg_points, out):
    """I_EPOCHS mini-epochs of I_STEPS steps a rank of ``train_model`` over
    path C's pipeline (``build_dataloader(dist=True)``, a scene a rank a
    step): each epoch's confidences as the sampler holds them, the rank's
    own sums before the epoch-end all-reduce and its time, the launch
    counts, the trained weights; checkpoints into ``ckpt_rank{r}``."""
    import com_tpu_torch.train.loop as loop
    from com_tpu_torch.data.dataset import build_dataloader
    from com_tpu_torch.train.step import device_batch_keys

    dev = mesh.device
    cfg, meta = i_config(grid)
    names = list(cfg.CLASS_NAMES)
    ds_cfg = i_dataset_cfg(cfg, meta, I_RANKS * I_STEPS, bg_points, points)
    ds, loader = build_dataloader(ds_cfg, names, 1, dist=True, training=True, seed=C_SEED,
                                  workers=C_WORKERS)
    net, opt, state, step = build_trainer(dev, cfg, meta, I_STEPS, seed=I_SEED)
    held, local, reduce_ms = [], [], []
    set_conf = ds.set_confidence_groups

    def record(conf):
        set_conf(conf)
        held.append(np.array(ds.data_augmentor.gt_sampler.confidence_groups))

    def timed_reduce(*tensors, **kw):
        _sync(dev)
        local.append([t.cpu().clone() for t in tensors])
        t0 = time.perf_counter()
        real_reduce(*tensors, **kw)
        _sync(dev)
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
        return tensors

    real_reduce = loop.all_reduce_
    ds.set_confidence_groups, loop.all_reduce_ = record, timed_reduce
    reset_counters()
    try:
        state, iters = loop.train_model(step, state, loader, I_EPOCHS, device=dev,
                                        ckpt_dir=Path(out) / f"ckpt_rank{mesh.rank}",
                                        batch_keys=device_batch_keys(cfg.MODEL))
    finally:
        loop.all_reduce_ = real_reduce
    return {"iters": iters, "held": held, "local": local, "reduce_ms": reduce_ms,
            "counts": read_counters(),
            "weights": {k: v.cpu() for k, v in net.state_dict().items()}}


def i3_eval(dev, weights, grid, points, bg_points, mesh=None):
    """``eval_model`` of the trained weights over I_EVAL_SCENES scenes of
    path C's val split, a scene a batch, with every decoded candidate kept
    (``D_SCORE_THRESH``): over the mesh's shards, or in one process."""
    from com_tpu_torch.data.dataset import build_dataloader
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import eval_model, make_eval_step

    cfg, meta = i_config(grid)
    cfg.MODEL.DENSE_HEAD.POST_PROCESSING.SCORE_THRESH = D_SCORE_THRESH
    names = list(cfg.CLASS_NAMES)
    net = build_network(cfg.MODEL, meta, device=dev)
    net.load_state_dict(weights)
    _, loader = build_dataloader(i_dataset_cfg(cfg, meta, I_EVAL_SCENES, bg_points, points),
                                 names, 1,
                                 training=False, workers=C_WORKERS, dist=mesh is not None)
    reset_counters()
    annos, recalls, spf = eval_model(make_eval_step(net, cfg.MODEL, names, meta, device=dev),
                                     loader, names, mesh=mesh)
    return {"annos": annos, "recalls": recalls, "spf": spf, "counts": read_counters()}


def i_rank(mesh, out, grid, points, bg_points, i1_only=False):
    """A rank of path I (spawned): I.1 on its scene of the global batch in
    both precisions, then (unless ``i1_only``) I.2 and I.3 on the weights
    I.2 trained; results to ``rank{r}.pt``."""
    from com_tpu_torch.parallel.mesh import shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = shard_batch(i_batch(grid, points), mesh)
    res = {"i1": {prec: i1_steps(mesh.device, batch, grid, mesh, f32=prec == "f32")
                  for prec in ("bf16", "f32")}}
    if not i1_only:
        res["i2"] = i2_loop(mesh, grid, points, bg_points, out)
        res["i3"] = i3_eval(mesh.device, res["i2"]["weights"], grid, points, bg_points, mesh)
        if mesh.rank != 0:
            del res["i2"]["weights"]
    torch.save(res, Path(out) / f"rank{mesh.rank}.pt")


def i1_check(label, ref, ranks, smi):
    """I.1 of each precision (``ref`` and the ranks' results keyed "bf16",
    "f32"): the ranks' parameters, statistics and losses bitwise equal;
    loss, confidence sums and counts, running statistics and parameters
    against the single process after step 1 and step I_STEPS (gated as the
    constants above say); the launch counts a step."""
    ok = True
    for prec in ("bf16", "f32"):
        a, b = (r["i1"][prec] for r in ranks)
        rf = ref[prec]
        same = a["loss"] == b["loss"] and all(
            _same_tensors(x["params"], y["params"]) and _same_tensors(x["stats"], y["stats"])
            for x, y in zip(a["snap"], b["snap"]))
        grads = rf["grads"]
        gmax = max(float(g.abs().max()) for g in grads.values())
        sure = {k: (g.abs() > I_SURE * g.abs().max()) & (g.abs() > I_SURE / 10 * gmax)
                for k, g in grads.items()}
        n_sure = sum(int(m.sum()) for m in sure.values())
        ok &= same
        for i, s in enumerate((0, I_STEPS - 1)):
            got, want = a["snap"][i], rf["snap"][i]
            loss_err = abs(a["loss"][s] - rf["loss"][s]) / abs(rf["loss"][s])
            cnt_ok = (torch.equal(got["conf_cnt"], want["conf_cnt"])
                      and float(want["conf_cnt"].sum()) > 0)
            conf_err = float(((got["conf_sum"] - want["conf_sum"]).abs()
                              / want["conf_sum"].abs().clamp_min(1e-3)).max())
            stats_err = max(float(stat_err(got["stats"], want["stats"],
                                           k.rsplit(".", 1)[0]).max())
                            for k in want["stats"] if k.endswith("running_mean"))
            param_tol = 1e-6 if i == 0 else 0.1 * sum(rf["lr"])
            param_err = max(float((got["params"][k] - want["params"][k]).abs()[m].max())
                            if bool(m.any()) else 0.0 for k, m in sure.items())
            if prec == "f32":
                good = (loss_err <= I_LOSS_RTOL[i] and cnt_ok and conf_err <= I_CONF_RTOL[i]
                        and stats_err <= I_STATS_TOL[i] and param_err <= param_tol)
                gates = (f"<= {I_LOSS_RTOL[i]:g}", f"<= {I_CONF_RTOL[i]:g}",
                         f"<= {I_STATS_TOL[i]:g}", f"<= {param_tol:.2e}")
            else:
                good = cnt_ok and (i > 0 or loss_err <= I_BF16_LOSS_RTOL)
                gates = (f"<= {I_BF16_LOSS_RTOL:g}" if i == 0 else "printed",
                         "printed", "printed", "printed")
            ok &= good
            print(f"path I.1 {label} {prec}, after {s + 1} step(s): loss {a['loss'][s]:.6f} vs "
                  f"one process {rf['loss'][s]:.6f} (rel {loss_err:.2e} {gates[0]}); "
                  f"confidence counts {int(got['conf_cnt'].sum())} equal {cnt_ok}, sums rel "
                  f"{conf_err:.2e} ({gates[1]}); running statistics {stats_err:.2e} "
                  f"({gates[2]}); parameters at the {n_sure} entries of |g| >= {I_SURE:g} of "
                  f"their max: {param_err:.2e} ({gates[3]}) {'ok' if good else 'FAIL'}")
        print(f"path I.1 {label} {prec}: the {I_RANKS} ranks' losses, running statistics and "
              f"parameters bitwise equal after 1 and {I_STEPS} steps {same} "
              f"{'ok' if same else 'FAIL'}")
        for r, rank in enumerate(ranks):
            check_launches(f"I.1 {label} {prec} rank {r} step", rank["i1"][prec]["counts"],
                           EXPECT_TRAIN, I_STEPS)
        per_step = [(len(log), sum(n for n, _ in log)) for log in a["collectives"]]
        inside = [round(1e3 * sum(t for _, t in log), 3) for log in a["collectives"][1:]]
        grads = [round(1e3 * max(log)[1], 3) for log in a["collectives"][1:]]
        print(f"path I.1 {label} {prec}: {per_step[-1][0]} all-reduces a step, "
              f"{per_step[-1][1]} bytes (rank 0, step {I_STEPS}; each step {per_step}), "
              f"{inside} ms of the step inside them (the gradients' {grads} ms); step "
              f"time a rank {[round(x, 3) for x in a['ms'][1:]]} / "
              f"{[round(x, 3) for x in b['ms'][1:]]} ms against one process at the global batch "
              f"{[round(x, 3) for x in rf['ms'][1:]]} ms (host clock between syncs, step 1 left "
              f"out; {'ranks sharing a card over gloo are no scaling figure; ' if 'gloo' in label else ''}"
              f"{smi})")
    if not ok:
        raise AssertionError(f"path I.1 {label}: the data-parallel step disagrees")


def i2_check(ranks, out):
    a, b = (r["i2"] for r in ranks)
    same = len(a["held"]) == len(b["held"]) == I_EPOCHS and all(
        np.array_equal(x, y) for x, y in zip(a["held"], b["held"]))
    err = 0.0
    for e in range(I_EPOCHS):
        s = sum(r["local"][e][0] for r in (a, b))
        c = sum(r["local"][e][1] for r in (a, b))
        err = max(err, float(np.abs(a["held"][e] - (s / (c + 0.01)).numpy()).max()))
    files = sorted(p.name for p in (Path(out) / "ckpt_rank0").iterdir())
    alone = not (Path(out) / "ckpt_rank1").exists() and files == [
        f"checkpoint_epoch_{e + 1}.pth" for e in range(I_EPOCHS)]
    ok = same and err <= 1e-6 and alone and a["iters"] == I_EPOCHS * I_STEPS
    print(f"path I.2 (path C's pipeline, build_dataloader(dist=True), {I_RANKS} ranks x "
          f"{I_EPOCHS} epochs x {I_STEPS} steps): both samplers hold the same "
          f"{a['held'][0].shape} confidences each epoch {same}; they are the all-reduce of the "
          f"ranks' sums (max err {err:.1e}); checkpoints by rank 0 alone {files} {alone}; "
          f"epoch-end reduction {[round(x, 3) for x in a['reduce_ms']]} ms "
          f"{'ok' if ok else 'FAIL'}")
    for r, rank in enumerate(ranks):
        check_launches(f"I.2 rank {r} step", rank["i2"]["counts"], EXPECT_TRAIN,
                       rank["i2"]["iters"])
    if not ok:
        raise AssertionError("path I.2: the epoch-end feedback is not the same on every rank")


def i3_check(dev, ranks, grid, points, bg_points, smi):
    single = i3_eval(dev, ranks[0]["i2"]["weights"], grid, points, bg_points)
    worst, ok = 0.0, True
    for r, rank in enumerate(ranks):
        got = rank["i3"]
        ok &= (len(got["annos"]) == I_EVAL_SCENES and got["recalls"] == single["recalls"]
               and [x["frame_id"] for x in got["annos"]] == [x["frame_id"] for x in single["annos"]])
        for g, w in zip(got["annos"], single["annos"]):
            ok &= len(g["score"]) == len(w["score"]) and np.array_equal(g["pred_labels"],
                                                                         w["pred_labels"])
            if len(g["score"]) == len(w["score"]) and len(w["score"]):
                worst = max(worst, float(np.abs(g["boxes_lidar"] - w["boxes_lidar"]).max()),
                            float(np.abs(g["score"] - w["score"]).max()))
        check_launches(f"I.3 rank {r} forward", got["counts"], EXPECT_SERVING,
                       len(got["annos"]) // I_RANKS)
    n = sum(len(x["score"]) for x in single["annos"])
    ok &= worst <= 1e-4 and n > 0
    print(f"path I.3 eval_model over {I_RANKS} shards of {I_EVAL_SCENES} scenes: each rank's "
          f"det_annos in dataset order equal the single process's ({n} detections, max err "
          f"{worst:.1e} <= 1e-4), recall {single['recalls']}; s a frame a rank "
          f"{[round(r['i3']['spf'], 4) for r in ranks]}, one process {single['spf']:.4f} "
          f"({smi}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path I.3: the data-parallel eval disagrees with one process")


def i4_nccl(dev, smi, grid=None, points=POINTS, bg_points=120000):
    """The train CLI under ``torchrun --standalone --nproc_per_node 1
    ... --multihost``: a world-1 group (NCCL on the card), the sharded
    loader, 1 epoch of I_STEPS steps at the flagship's batch 2, rank 0's
    checkpoint.  Its own process group: every process it starts ends."""
    import os
    import signal

    import yaml

    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / CONFIG))
    data_cfg = _plain(path_c_dataset_cfg(cfg, bg_points=bg_points, max_points=points))
    data_cfg["NUM_SCENES"] = BATCH * I_STEPS
    data_cfg["POINT_CLOUD_RANGE"] = list(i_config(grid)[1].point_cloud_range)
    root = I_DIR / "nccl"
    root.mkdir(parents=True)
    yaml_path = root / "flagship_path_i.yaml"
    yaml_path.write_text(yaml.safe_dump({
        "CLASS_NAMES": list(cfg.CLASS_NAMES), "DATA_CONFIG": data_cfg,
        "MODEL": _plain(cfg.MODEL), "OPTIMIZATION": _plain(cfg.OPTIMIZATION)}))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "1", "-m", "com_tpu_torch.tools.train", "--cfg_file", str(yaml_path), "--output_dir",
           str(root / "out"), "--workers", str(C_WORKERS), "--batch_size", str(BATCH),
           "--epochs", "1", "--device", str(torch.device(dev).type), "--multihost"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=I_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"path I.4: torchrun did not end in {I_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    ckpts = sorted(p.name for p in (root / "out").rglob("checkpoint_epoch_*.pth"))
    train_log = "".join(p.read_text() for p in (root / "out").rglob("log_train_*.txt"))
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    ok = (proc.returncode == 0 and ckpts == ["checkpoint_epoch_1.pth"]
          and f"rank 0 of 1 ({backend})" in train_log
          and f"x {I_STEPS} steps, global batch {BATCH}" in train_log)
    print(f"path I.4 torchrun --nproc_per_node 1 -m com_tpu_torch.tools.train --multihost: rc "
          f"{proc.returncode}, {wall:.1f} s wall (interpreter, {backend} group, dataset, "
          f"model, 1 epoch of {I_STEPS} steps, checkpoint), checkpoints {ckpts} "
          f"{'ok' if ok else 'FAIL'} ({smi})")
    if not ok:
        print(log[-4000:])
        raise AssertionError("path I.4: the torchrun train CLI failed")


def path_i(dev, smi, grid=None, points=POINTS, bg_points=120000):
    """Path I, the data mesh (``com_tpu_torch/parallel``): I.1-I.3 on
    I_RANKS ranks spawned on ``dev`` over gloo (one card: NCCL refuses two
    ranks on one card) against one process; I.4 through torchrun and the
    train CLI (NCCL on the card); I.1 again over NCCL where there are two
    cards.  ``grid``, ``points`` (a scene's point slots) and ``bg_points``
    are for rehearsals."""
    import shutil

    from com_tpu_torch.parallel.launch import run_ranks

    shutil.rmtree(I_DIR, ignore_errors=True)
    I_DIR.mkdir(parents=True)
    start = time.perf_counter()
    try:
        batch = i_batch(grid, points)
        ref = {prec: i1_steps(dev, batch, grid, f32=prec == "f32") for prec in ("bf16", "f32")}
        for prec, r in ref.items():
            check_launches(f"I.1 one process {prec} step", r["counts"], EXPECT_TRAIN, I_STEPS)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        run_ranks(i_rank, I_RANKS, args=(str(I_DIR), grid, points, bg_points), backend="gloo",
                  device=str(dev), timeout_s=I_TIMEOUT_S, init_dir=I_DIR, threads=I_THREADS)
        print(f"path I: {I_RANKS} ranks spawned on {dev} over gloo ran I.1-I.3 in "
              f"{time.perf_counter() - t0:.1f} s wall; two ranks sharing one card over gloo "
              "are no scaling figure")
        ranks = [torch.load(I_DIR / f"rank{r}.pt", weights_only=False) for r in range(I_RANKS)]
        i1_check(f"gloo on {dev}", ref, ranks, smi)
        i2_check(ranks, I_DIR)
        i3_check(dev, ranks, grid, points, bg_points, smi)
        del ranks
        i4_nccl(dev, smi, grid, points, bg_points)
        if torch.device(dev).type == "cuda" and torch.cuda.device_count() >= 2:
            shutil.rmtree(I_DIR / "two", ignore_errors=True)
            (I_DIR / "two").mkdir()
            run_ranks(i_rank, I_RANKS, args=(str(I_DIR / "two"), grid, points, bg_points, True),
                      backend="nccl", timeout_s=I_TIMEOUT_S, init_dir=I_DIR, threads=I_THREADS)
            i1_check("NCCL on two cards", ref, [
                torch.load(I_DIR / "two" / f"rank{r}.pt", weights_only=False)
                for r in range(I_RANKS)], smi)
        else:
            print(f"path I.1 over NCCL on two cards: not run ({torch.cuda.device_count()} "
                  "card(s)); multi-card scaling is not measured")
        print(f"path I: {time.perf_counter() - start:.1f} s wall in all")
    finally:
        shutil.rmtree(I_DIR, ignore_errors=True)


def l_cfg(config, tree, extra_set=()):
    """A YAML with ``DATA_CONFIG.DATA_PATH`` at ``tree`` and the ``--set``
    pairs ``extra_set`` (a rehearsal's cuts), as the CLIs read it."""
    from com_tpu_torch.utils.config import cfg_from_list, cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / config))
    cfg_from_list(["DATA_CONFIG.DATA_PATH", str(tree), *extra_set], cfg)
    return cfg


@contextlib.contextmanager
def road_plane_tally(pc_range):
    """Count, for the duration, the pasted boxes the GT sampler lifts onto
    the road plane: in all, with calib, and those the lift leaves below or
    above the range's z (``com_tpu``'s lift without calib, a points-only
    item, reads the rect-frame plane as a lidar one)."""
    import threading

    from com_tpu_torch.data.augmentor.database_sampler import DataBaseSampler

    orig = DataBaseSampler.put_boxes_on_road_planes
    tally = {"lifted": 0, "with_calib": 0, "below_range": 0, "above_range": 0}
    lock = threading.Lock()

    def lift(gt_boxes, road_plane, calib=None):
        boxes, mv = orig(gt_boxes, road_plane, calib)
        with lock:
            tally["lifted"] += len(boxes)
            tally["with_calib"] += len(boxes) if calib is not None else 0
            tally["below_range"] += int((boxes[:, 2] < pc_range[2]).sum())
            tally["above_range"] += int((boxes[:, 2] > pc_range[5]).sum())
        return boxes, mv

    DataBaseSampler.put_boxes_on_road_planes = staticmethod(lift)
    try:
        yield tally
    finally:
        DataBaseSampler.put_boxes_on_road_planes = staticmethod(orig)


def spread_multihead_scores(net):
    """``spread_anchor_scores`` for AnchorHeadMulti: each head's class bias
    +4, its box weights x0.02."""
    with torch.no_grad():
        for head in net.dense_head.rpn_heads:
            head.conv_cls.bias.add_(4.0)
            head.conv_box.weight.mul_(0.02)
    return net


def l1_pointpillar(dev, smi, tree, extra_set=()):
    """L.1: ``kitti_models/pointpillar.yaml`` through the train CLI (1 epoch
    over the tree's train split, batch 4) and the test CLI (val split)."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.tools import test, train

    cfg = l_cfg(KITTI_CONFIG, tree, extra_set)
    base = ["--cfg_file", str(REPO / KITTI_CONFIG), "--output_dir", str(L_DIR / "out"),
            "--workers", str(L_WORKERS), "--device", str(dev)]
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tree), *extra_set]
    marks, losses = [], []

    def hook(epoch, it, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        losses.append(metrics["loss"])

    reset_counters()
    t0 = time.perf_counter()
    with road_plane_tally(cfg.DATA_CONFIG.POINT_CLOUD_RANGE) as tally:
        first = train.main(base + ["--epochs", "1", "--seed", str(L_SEED)] + data,
                           metric_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = first["iterations"]
    check_launches("L.1 train step (CLI)", read_counters(), EXPECT_E_TRAIN, steps)
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    loss_host = [float(x) for x in losses]
    ok = steps == L_TRAIN // 4 and np.isfinite(loss_host).all()
    print(f"path L.1 train CLI (pointpillar.yaml, batch 4, the tree's {L_TRAIN} train frames): "
          f"{steps} steps, {wall:.2f} s wall (dataset, model and loader included), losses "
          f"{[round(x, 4) for x in loss_host]}; step ms after the first "
          f"{[round(x, 3) for x in step_ms]} ({smi}) {'ok' if ok else 'FAIL'}")
    print(f"  road plane (points-only item, no calib): {json.dumps(tally)} of the pasted boxes "
          f"(range z {cfg.DATA_CONFIG.POINT_CLOUD_RANGE[2]} .. "
          f"{cfg.DATA_CONFIG.POINT_CLOUD_RANGE[5]} m)")
    if not ok or tally["lifted"] == 0:
        raise AssertionError("path L.1: the train CLI over the KITTI tree failed its checks")
    ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
    del first
    torch.cuda.empty_cache()
    reset_counters()
    (res,) = test.main(base + ["--ckpt", str(ckpt), "--infer_time"] + data)
    torch.cuda.synchronize()
    annos = res["det_annos"]
    check_launches("L.1 eval forward (test CLI)", read_counters(), EXPECT_E_SERVING,
                   res["infer_batches"] + 1 + -(-len(annos) // 4))
    ok = (len(annos) == L_VAL and set(res["result"]) == {
        f"{c}_{m}" for c in cfg.CLASS_NAMES for m in ("bev", "3d")}
        and all(np.isfinite(a["boxes_lidar"]).all() and (np.diff(a["score"]) <= 0).all()
                for a in annos))
    print(f"path L.1 test CLI: {len(annos)} val frames, detections a frame "
          f"{[len(a['score']) for a in annos]}, {res['sec_per_frame']:.4f} s a frame "
          f"(eval_model, host clock), --infer_time {res['infer_ms_per_frame']:.3f} ms a frame "
          f"(median of {res['infer_batches']} batches, synced) ({smi}) {'ok' if ok else 'FAIL'}")
    print("  KITTI AP (R40) of the 4-step checkpoint:\n    "
          + res["result_str"].replace("\n", "\n    "))
    # the same evaluation with the val GT as detections: the evaluator on the tree
    dataset, _ = build_dataloader(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), 4, training=False,
                                  workers=1)
    gt_annos = []
    for idx in dataset.sample_ids:
        gt = dataset.frame_gt_annos(idx)
        gt_annos.append({"frame_id": idx, "name": gt["name"], "boxes_lidar": gt["gt_boxes_lidar"],
                         "score": np.ones(len(gt["name"]), np.float32)})
    gt_str, gt_res = dataset.evaluation(gt_annos, list(cfg.CLASS_NAMES))
    print("  the val GT as detections, same evaluation:\n    " + gt_str.replace("\n", "\n    "))
    ok = ok and gt_res["Car_3d"][2] > 50.0
    if not ok:
        raise AssertionError("path L.1: the test CLI over the KITTI tree failed its checks")


def l2_multihead(dev, smi, tree, entries, calls, extra_set=()):
    """L.2: ``kitti_models/second_multihead.yaml`` (SECONDNet with
    AnchorHeadMulti) on the tree: a serving batch (4 val frames), its
    stages, K4 on its decoded three-class candidates, that batch in f32 on
    the card against the CPU, K2 / dgrad / K2w at the heads' shared conv, 2
    train steps.  Returns the launch counts of the serving forward and of
    the steps."""
    import copy

    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.tools.train import dataset_meta
    from com_tpu_torch.train.eval import make_eval_step

    cfg = l_cfg(MULTIHEAD_CONFIG, tree, extra_set)
    names = list(cfg.CLASS_NAMES)
    dataset, loader = build_dataloader(cfg.DATA_CONFIG, names, 4, training=False,
                                       workers=L_WORKERS)
    meta = dataset_meta(cfg, dataset)
    batch = next(iter(loader))
    net = spread_multihead_scores(build_network(cfg.MODEL, meta, device=dev, seed=0))
    step = make_eval_step(net, cfg.MODEL, names, meta, device=dev)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    boxes, scores, labels, valid = (t.cpu().numpy() for t in step(batch))
    torch.cuda.synchronize()
    latency = (time.perf_counter() - t0) * 1e3
    counts = read_counters()
    thresh = float(cfg.MODEL.POST_PROCESSING.SCORE_THRESH)
    ok = (bool(valid.any(1).all()) and np.isfinite(boxes[valid]).all()
          and (scores[valid] >= thresh).all() and set(np.unique(labels[valid])) <= {1, 2, 3})
    print(f"path L.2 serving (second_multihead.yaml, {meta.grid_size} grid, batch 4 val frames "
          f"of the tree): latency {latency:.2f} ms (host clock, outputs copied back), "
          f"detections {valid.sum(1).tolist()}, labels {sorted(set(labels[valid].tolist()))} "
          f"({smi}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path L.2 returned malformed detections")
    check_launches("L.2 serving forward", counts, EXPECT_L2_SERVING, 1)
    stage_breakdown(net, step, batch, "path L.2 ", iters=3, smi=smi)
    over, sv = e_decoded_candidates(net, cfg, meta, batch, dev)
    check_k4_cases(dev, entries, calls, over, sv, smi, ", path L.2 (three-class)", "L2:nms",
                   iters=20)
    del net, step, over, sv
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=L2_CONV, dtypes=(torch.bfloat16,), path="L2:")
    check_conv3x3_backward(dev, entries, shapes=L2_CONV, wgrad_dtypes=(torch.bfloat16,),
                           path="L2:")
    torch.cuda.empty_cache()
    f32 = copy.deepcopy(cfg)
    f32.MODEL.MIXED_PRECISION = False
    f32.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = L_COMPARE_PRE
    t0 = time.perf_counter()
    compare_eval_step(dev, f32, meta, batch, f"path L.2 batch in f32 at NMS_PRE_MAXSIZE "
                      f"{L_COMPARE_PRE}, card vs CPU (plain versions)",
                      prepare=spread_multihead_scores)
    print(f"  (the comparison took {time.perf_counter() - t0:.1f} s wall)")
    torch.cuda.empty_cache()
    _, train_loader = build_dataloader(cfg.DATA_CONFIG, names, 4, training=True,
                                       workers=L_WORKERS, seed=L_SEED)
    batches = [b for _, b in zip(range(2), train_loader)]
    train_counts, _, _ = run_training(dev, "L.2 (second_multihead, the KITTI tree)", cfg, meta,
                                      SyntheticLoader(batches, 2), 1, 2, EXPECT_L2_TRAIN,
                                      counts_confidences=False, smi=smi)
    return counts, train_counts


def timed_queue(augmentor, aug_cfg):
    """Wrap each step of a DataAugmentor's queue (built from ``aug_cfg``,
    DATA_AUGMENTOR) to add its seconds to ``times[name]``; returns ``times``."""
    import threading

    disable = set(aug_cfg.get("DISABLE_AUG_LIST", []))
    names = [c["NAME"] for c in aug_cfg["AUG_CONFIG_LIST"] if c["NAME"] not in disable]
    times = {n: [] for n in names}
    lock = threading.Lock()

    def wrap(name, fn):
        def timed(data_dict):
            t0 = time.perf_counter()
            out = fn(data_dict)
            with lock:
                times[name].append(time.perf_counter() - t0)
            return out
        return timed

    augmentor.data_augmentor_queue = [wrap(n, f) for n, f in
                                      zip(names, augmentor.data_augmentor_queue, strict=True)]
    return times


def l3_loaders(dev, smi, tree, extra_set=()):
    """L.3: the host loader of ``pointpillar_newaugs`` and
    ``pointpillar_pyramid_aug`` over the tree: scenes/s on one thread
    (each augmentation's ms) and through the loader's L_WORKERS threads,
    then one train step each on a batch it made."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.tools.train import dataset_meta

    for config in (NEWAUGS_CONFIG, PYRAMID_CONFIG):
        cfg = l_cfg(config, tree, extra_set)
        names = list(cfg.CLASS_NAMES)
        label = Path(config).stem
        dataset, loader = build_dataloader(cfg.DATA_CONFIG, names, 4, training=True,
                                           workers=L_WORKERS, seed=L_SEED)
        times = timed_queue(dataset.data_augmentor, cfg.DATA_CONFIG.DATA_AUGMENTOR)
        with road_plane_tally(cfg.DATA_CONFIG.POINT_CLOUD_RANGE) as tally:
            t0 = time.perf_counter()
            for i in range(8):
                dataset[i]
            one = 8 / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            batches = [b for _, b in zip(range(2), loader)]
            threaded = 8 / (time.perf_counter() - t0)
        ms = {k: round(1e3 * float(np.mean(v)), 3) for k, v in times.items() if v}
        print(f"path L.3 host loader {label}: {one:.2f} scenes/s on one thread, "
              f"{threaded:.2f} scenes/s through {L_WORKERS} loader threads (8 scenes, batch 4, "
              f"host clock); ms a scene a step: {json.dumps(ms)}; road plane {json.dumps(tally)}")
        meta = dataset_meta(cfg, dataset)
        run_training(dev, f"L.3 ({label}, one step)", cfg, meta, SyntheticLoader(batches[:1], 1),
                     1, 1, EXPECT_E_TRAIN, counts_confidences=False, smi=smi)
        torch.cuda.empty_cache()


def l4_custom(dev, smi, root, entries, extra_set=()):
    """L.4: ``custom_models/second.yaml`` through the test CLI on a custom
    tree of L_CUSTOM frames, seeded weights with the class bias raised
    saved as the checkpoint; K2 at its BEV's shapes.  Returns the test
    CLI's launch counts."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.tools import test
    from com_tpu_torch.tools.kitti_tree import write_custom_tree
    from com_tpu_torch.tools.train import dataset_meta

    write_custom_tree(root, seed=L_SEED, num_train=0, num_val=L_CUSTOM, num_points=L_POINTS)
    cfg = l_cfg(CUSTOM_CONFIG, root, extra_set)
    dataset, _ = build_dataloader(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), 4, training=False,
                                  workers=1)
    net = spread_anchor_scores(build_network(cfg.MODEL, dataset_meta(cfg, dataset), device=dev,
                                             seed=1))
    ckpt = L_DIR / "custom_seeded.pth"
    torch.save({"model_state": net.state_dict()}, ckpt)
    del net
    reset_counters()
    (res,) = test.main(["--cfg_file", str(REPO / CUSTOM_CONFIG), "--output_dir",
                        str(L_DIR / "out"), "--workers", str(L_WORKERS), "--device", str(dev),
                        "--ckpt", str(ckpt), "--infer_time", "--set", "DATA_CONFIG.DATA_PATH",
                        str(root), *extra_set])
    torch.cuda.synchronize()
    annos = res["det_annos"]
    counts = read_counters()
    check_launches("L.4 eval forward (test CLI)", counts, EXPECT_G_SERVING,
                   res["infer_batches"] + 1 + -(-len(annos) // 4))
    ok = (len(annos) == L_CUSTOM and all(len(a["score"]) and np.isfinite(a["boxes_lidar"]).all()
                                         for a in annos)
          and "Vehicle AP_bev R40" in res["result_str"])
    print(f"path L.4 test CLI (custom_models/second.yaml, {L_CUSTOM} frames of {L_POINTS} points): "
          f"detections a frame {[len(a['score']) for a in annos]}, {res['sec_per_frame']:.4f} s "
          f"a frame, --infer_time {res['infer_ms_per_frame']:.3f} ms a frame ({smi}) "
          f"{'ok' if ok else 'FAIL'}")
    print("  " + res["result_str"].replace("\n", "\n  "))
    if not ok:
        raise AssertionError("path L.4: the custom config through the test CLI failed")
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=L4_CONV, dtypes=(torch.bfloat16,), path="L4:")
    return counts


def path_l(dev, smi, entries, calls, points=L_POINTS, sets=None):
    """Path L, KITTI from disk: the tree written from L_SEED, then L.1-L.4
    (see the module docstring).  Returns the launch counts its kernel
    entries report: L.2's steps (K2, dgrad, K2w) and serving forward (K4),
    L.4's test CLI (K2).  ``points`` (a scan's size) and ``sets`` ({"L.1":
    ``--set`` pairs, ...}: cuts of a config's range or voxels) are for
    rehearsals."""
    import shutil

    from com_tpu_torch.tools.kitti_tree import write_kitti_tree

    sets = sets or {}
    shutil.rmtree(L_DIR, ignore_errors=True)
    L_DIR.mkdir(parents=True)
    start = time.perf_counter()
    try:
        tree = L_DIR / "kitti"
        t0 = time.perf_counter()
        info = write_kitti_tree(tree, seed=L_SEED, num_train=L_TRAIN, num_val=L_VAL,
                                num_points=points)
        print(f"path L: KITTI tree of {L_TRAIN} train and {L_VAL} val frames of {points} points "
              f"written in {time.perf_counter() - t0:.1f} s; GT database {json.dumps(info['db'])}")
        if min(info["db"].values()) < 40 or info["db"]["Car"] < 60:
            raise AssertionError(f"path L: the GT database is too small: {info['db']}")
        l1_pointpillar(dev, smi, tree, sets.get("L.1", ()))
        torch.cuda.empty_cache()
        serve_counts, train_counts = l2_multihead(dev, smi, tree, entries, calls,
                                                  sets.get("L.2", ()))
        torch.cuda.empty_cache()
        l3_loaders(dev, smi, tree, sets.get("L.3", ()))
        torch.cuda.empty_cache()
        custom_counts = l4_custom(dev, smi, L_DIR / "custom", entries, sets.get("L.4", ()))
        print(f"path L: {time.perf_counter() - start:.1f} s wall in all")
    finally:
        shutil.rmtree(L_DIR, ignore_errors=True)
    return {**{f"L2:{k}": v for k, v in train_counts.items()}, "L2:nms": serve_counts["nms"],
            "L4:conv3x3": custom_counts["conv3x3"]}


def _mark_point_steps(net, mark):
    """Marks inside PV-RCNN's point stages, for ``two_stage_marks``: the
    PFE's BEV interpolation ("pfe.bev"), each source's ball query and
    grouping ("pfe.<source>.query") and its PointNet block
    ("pfe.<source>.block"), the fusion ("pfe.fusion"); PVRCNNHead's grid
    ball query ("roi.grid_query") and grid PointNet ("roi.grid_pointnet").
    The PFE's own pre-hook opens "pfe.fps" (the keypoint sampling).
    Returns the function that removes them."""
    from com_tpu_torch.ops import pointnet2

    pfe, head = net.pfe, net.roi_head
    queue, hooks = [], []
    sources = (["raw_points"] if pfe.SA_rawpoints is not None else []) + list(pfe.conv_sources)
    hooks.append(pfe.register_forward_pre_hook(
        lambda *_: queue.extend(f"pfe.{s}.query" for s in sources)))
    blocks = list(zip(sources, ([pfe.SA_rawpoints] if pfe.SA_rawpoints is not None else [])
                      + list(pfe.SA_layers)))
    for s, blk in blocks:
        hooks.append(blk.register_forward_pre_hook(lambda *_, s=s: mark(f"pfe.{s}.block")))
    hooks.append(pfe.vsa_point_feature_fusion[0].register_forward_pre_hook(
        lambda *_: mark("pfe.fusion")))
    if hasattr(head, "roi_grid_pool_layer"):
        hooks.append(head.register_forward_pre_hook(lambda *_: queue.append("roi.grid_query")))
        hooks.append(head.roi_grid_pool_layer.register_forward_pre_hook(
            lambda *_: mark("roi.grid_pointnet")))
    orig_interp, orig_group = pfe.interpolate_bev, pointnet2.query_and_group

    def interp(*args, **kw):
        mark("pfe.bev")
        return orig_interp(*args, **kw)

    def group(*args, **kw):
        mark(queue.pop(0) if queue else "query")
        return orig_group(*args, **kw)

    pfe.interpolate_bev, pointnet2.query_and_group = interp, group

    def undo():
        pointnet2.query_and_group = orig_group
        del pfe.interpolate_bev
        for h in hooks:
            h.remove()

    return undo


def check_small_pvrcnn_reference(dev):
    """``kitti_models/pv_rcnn.yaml`` at full width (4,096 keypoints, the 6^3
    grid), f32, over path J's 64 x 64 x 40 grid (2 scenes of 4,096 points),
    scores spread: the eval step on the card against the CPU; the FPS
    indices and every ball query's indices exactly (the first difference
    named), the detections as path J's."""
    from com_tpu_torch.models.detectors import DatasetMeta, build_network
    from com_tpu_torch.ops import pointnet2
    from com_tpu_torch.train.eval import make_eval_step

    cfg, _, proc = load_voxel(PV_RCNN_CONFIG)
    meta = DatasetMeta(cfg.CLASS_NAMES, (-16.0, -16.0, -2.0, 16.0, 16.0, 2.0), (0.5, 0.5, 0.1),
                       (64, 64, 40), E_FEATS)
    proc.MAX_NUMBER_OF_VOXELS = {"train": 2048, "test": 2048}
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.BACKBONE_3D.VOXEL_CAPS = [2048, 1024, 512, 256]
    rng = np.random.RandomState(46)
    pts = np.concatenate([rng.uniform(-15, 15, (2, 4096, 2)), rng.uniform(-1.4, 1.4, (2, 4096, 1)),
                          rng.rand(2, 4096, 1)], -1).astype(np.float32)
    mask = rng.rand(2, 4096) < 0.95
    batch = voxelize_batch({"points": pts, "points_mask": mask}, meta, proc, "test")
    orig_fps, orig_query = pointnet2.farthest_point_sample, pointnet2.ball_query
    record = []

    def fps(*args, **kw):
        out = orig_fps(*args, **kw)
        record.append(("FPS", out.cpu()))
        return out

    def query(*args, **kw):
        out = orig_query(*args, **kw)
        record.append((f"ball query r={args[0]}", out[0].cpu()))
        return out

    outs, records = [], []
    pointnet2.farthest_point_sample, pointnet2.ball_query = fps, query
    try:
        for d in (dev, "cpu"):
            record.clear()
            net = spread_anchor_scores(build_network(cfg.MODEL, meta, device=d, seed=7))
            step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)
            outs.append([t.cpu().numpy() for t in step(batch)])
            records.append(list(record))
    finally:
        pointnet2.farthest_point_sample, pointnet2.ball_query = orig_fps, orig_query
    label = "path M small reference (PV-RCNN 64x64x40 f32, card vs CPU)"
    names = [n for n, _ in records[1]]
    if [n for n, _ in records[0]] != names:
        raise AssertionError(f"{label}: the card ran {[n for n, _ in records[0]]}, the CPU {names}")
    for (name, a), (_, b) in zip(*records):
        diff = (a != b).nonzero()
        if len(diff):
            raise AssertionError(f"{label}: {name} indices differ first at (scene, row"
                                 f"{', slot' if a.dim() == 3 else ''}) {diff[0].tolist()}: "
                                 f"card {a[tuple(diff[0])].item()}, CPU {b[tuple(diff[0])].item()}")
    print(f"{label}: indices equal in {', '.join(f'{n} {tuple(a.shape)}' for n, a in records[1])}")
    check_detections(label, *outs)


def m3_clis(dev, smi, tree, extra_set=()):
    """M.3: ``kitti_models/pv_rcnn.yaml`` through the train CLI (1 epoch of
    4 steps over the tree's train split, batch 4) and the test CLI (val
    split, KITTI AP, ``--infer_time``)."""
    from com_tpu_torch.tools import test, train

    cfg = l_cfg(PV_RCNN_CONFIG, tree, extra_set)
    base = ["--cfg_file", str(REPO / PV_RCNN_CONFIG), "--output_dir", str(M_DIR / "out"),
            "--workers", str(L_WORKERS), "--device", str(dev)]
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tree), *extra_set]
    marks, rows = [], []

    def hook(epoch, it, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        rows.append(torch.stack([metrics[k].float() for k in ("loss",) + M_TERMS]))

    reset_counters()
    t0 = time.perf_counter()
    first = train.main(base + ["--epochs", "1", "--seed", str(L_SEED)] + data, metric_hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = first["iterations"]
    check_launches("M.3 train step (CLI)", read_counters(), EXPECT_M_TRAIN, steps)
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    rows = torch.stack(rows).cpu().numpy()
    ok = steps == L_TRAIN // 4 and bool(np.isfinite(rows).all())
    print(f"path M.3 train CLI (pv_rcnn.yaml, batch 4, the tree's {L_TRAIN} train frames): "
          f"{steps} steps, {wall:.2f} s wall (dataset, model and loader included); step ms "
          f"after the first {[round(x, 3) for x in step_ms]} ({smi}) {'ok' if ok else 'FAIL'}")
    print("  loss and terms a step: " + "; ".join(
        f"{k} {[round(float(x), 5) for x in rows[:, i]]}"
        for i, k in enumerate(("loss",) + M_TERMS)))
    if not ok:
        raise AssertionError("path M.3: the train CLI over the KITTI tree failed its checks")
    ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
    del first
    torch.cuda.empty_cache()
    reset_counters()
    (res,) = test.main(base + ["--ckpt", str(ckpt), "--infer_time"] + data)
    torch.cuda.synchronize()
    annos = res["det_annos"]
    check_launches("M.3 eval forward (test CLI)", read_counters(), EXPECT_M_SERVING,
                   res["infer_batches"] + 1 + -(-len(annos) // 4))
    post_max = int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE)
    ok = (len(annos) == L_VAL and set(res["result"]) == {
        f"{c}_{m}" for c in cfg.CLASS_NAMES for m in ("bev", "3d")}
        and all(np.isfinite(a["boxes_lidar"]).all() and (np.diff(a["score"]) <= 0).all()
                and len(a["score"]) <= post_max for a in annos))
    print(f"path M.3 test CLI: {len(annos)} val frames, detections a frame "
          f"{[len(a['score']) for a in annos]}, {res['sec_per_frame']:.4f} s a frame "
          f"(eval_model, host clock), --infer_time {res['infer_ms_per_frame']:.3f} ms a frame "
          f"(median of {res['infer_batches']} batches, synced) ({smi}) {'ok' if ok else 'FAIL'}")
    print("  KITTI AP (R40) of the 4-step checkpoint:\n    "
          + res["result_str"].replace("\n", "\n    "))
    if not ok:
        raise AssertionError("path M.3: the test CLI over the KITTI tree failed its checks")


def m4_custom(dev, smi, root, points=M4_POINTS, extra_set=()):
    """M.4: ``custom_models/pv_rcnn.yaml`` (1504 x 1504 x 40) through the
    test CLI on a custom tree of L_CUSTOM frames of ``points`` points (the
    collate keeps MAX_POINTS_PER_SCENE, 131,072), seeded weights with the
    class bias raised saved as the checkpoint: detections, s a frame,
    ``--infer_time``, peak memory, launches."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.tools import test
    from com_tpu_torch.tools.kitti_tree import write_custom_tree
    from com_tpu_torch.tools.train import dataset_meta

    write_custom_tree(root, seed=L_SEED, num_train=0, num_val=L_CUSTOM, num_points=points)
    cfg = l_cfg(CUSTOM_PV_RCNN_CONFIG, root, extra_set)
    dataset, _ = build_dataloader(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), 4, training=False,
                                  workers=1)
    net = spread_anchor_scores(build_network(cfg.MODEL, dataset_meta(cfg, dataset), device=dev,
                                             seed=1))
    ckpt = M_DIR / "custom_seeded.pth"
    torch.save({"model_state": net.state_dict()}, ckpt)
    del net
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    (res,) = test.main(["--cfg_file", str(REPO / CUSTOM_PV_RCNN_CONFIG), "--output_dir",
                        str(M_DIR / "out"), "--workers", str(L_WORKERS), "--device", str(dev),
                        "--ckpt", str(ckpt), "--infer_time", "--set", "DATA_CONFIG.DATA_PATH",
                        str(root), *extra_set])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    annos = res["det_annos"]
    check_launches("M.4 eval forward (test CLI)", read_counters(), EXPECT_M_SERVING,
                   res["infer_batches"] + 1 + -(-len(annos) // 4))
    ok = (len(annos) == L_CUSTOM and all(len(a["score"]) and np.isfinite(a["boxes_lidar"]).all()
                                         for a in annos)
          and "Vehicle AP_bev R40" in res["result_str"])
    print(f"path M.4 test CLI (custom_models/pv_rcnn.yaml, {L_CUSTOM} frames of {points} points, "
          f"{cfg.DATA_CONFIG.MAX_POINTS_PER_SCENE} kept): detections a frame "
          f"{[len(a['score']) for a in annos]}, {res['sec_per_frame']:.4f} s a frame, "
          f"--infer_time {res['infer_ms_per_frame']:.3f} ms a frame, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({smi}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path M.4: the custom config through the test CLI failed")


def m5_inputs(rng, meta, b, n, channels, caps, rois=M5_ROIS):
    """PV-RCNN++'s module inputs on ``b`` Waymo-like scenes of ``n`` points:
    the points, a seeded BEV map at stride 8 (HeightCompression's width),
    x_conv3 / x_conv4 as the cells (stride 4 / 8) the points occupy, up to
    their VOXEL_CAPS, with seeded features, and ``rois`` Waymo-sized boxes a
    scene centred on points."""
    pr, vs = meta.point_cloud_range, meta.voxel_size
    pts = waymo_like_points(rng, b, n, pr)
    bev_hw = (meta.grid_size[1] // 8 + (meta.grid_size[1] % 8 > 0),
              meta.grid_size[0] // 8 + (meta.grid_size[0] % 8 > 0))
    batch = {"points": pts, "points_mask": np.ones((b, n), bool),
             "spatial_features": rng.randn(b, *bev_hw, channels["bev"]).astype(np.float32),
             "spatial_features_stride": 8, "multi_scale_3d_features": {}}
    for src, stride in (("x_conv3", 4), ("x_conv4", 8)):
        cap = int(caps[src])
        coords = np.full((b, cap, 3), -1, np.int32)
        for i in range(b):
            cell = np.floor((pts[i, :, [2, 1, 0]].T - np.array([pr[2], pr[1], pr[0]]))
                            / (np.array([vs[2], vs[1], vs[0]]) * stride)).astype(np.int32)
            cells = np.unique(cell, axis=0)
            cells = cells[rng.permutation(len(cells))[:cap]]
            coords[i, :len(cells)] = cells
        batch["multi_scale_3d_features"][src] = (
            rng.randn(b, cap, channels[src]).astype(np.float32), coords, coords[..., 0] >= 0)
    centre = pts[np.arange(b)[:, None], rng.randint(0, n, (b, rois)), :3]
    size = np.array([4.7, 2.1, 1.7], np.float32) * rng.uniform(0.8, 1.2, (b, rois, 3))
    batch["rois"] = np.concatenate([centre, size, rng.uniform(-np.pi, np.pi, (b, rois, 1))],
                                   -1).astype(np.float32)
    return batch


def m5_tensors(batch, dev, scenes=None):
    def conv(v):
        t = torch.as_tensor(v)
        return (t if scenes is None else t[:scenes]).to(dev)

    out = {k: conv(v) for k, v in batch.items() if k not in ("multi_scale_3d_features",
                                                               "spatial_features_stride")}
    out["spatial_features_stride"] = batch["spatial_features_stride"]
    out["multi_scale_3d_features"] = {
        src: (conv(x), conv(c), conv(m), None)
        for src, (x, c, m) in batch["multi_scale_3d_features"].items()}
    return out


def m5_plusplus_modules(dev, smi, b=M5_BATCH, points=M5_POINTS):
    """M.5: PV-RCNN++'s modules at ``waymo_models/pv_rcnn_plusplus.yaml``'s
    widths (the whole detector fails at the Waymo grid in both packages):
    ``VoxelSetAbstraction`` with SPC (6 sectors, ``sample_points_with_roi``
    around 128 RoIs a scene, 4,096 keypoints) over ``m5_inputs``, then
    ``PVRCNNPlusPlusHead`` (two vector-pool groups of 32 neighbours, local
    interpolation) on those keypoints; seeded weights, eval, f32.  The card
    times each module (mean of 3 after a warm-up) and its peak memory;
    scene 0 on the CPU against the card: the keypoints exactly, the
    features and the RCNN outputs within 1e-4 of the CPU's largest value."""
    import copy

    from com_tpu_torch.models.detectors import init_weights
    from com_tpu_torch.models.pfe import VoxelSetAbstraction
    from com_tpu_torch.models.roi_heads.pvrcnn_head import PVRCNNPlusPlusHead

    cfg, meta, _ = load_voxel(PVRCNN_PP_CONFIG)
    m = cfg.MODEL
    channels = {"bev": int(m.MAP_TO_BEV.NUM_BEV_FEATURES),
                **{f"x_conv{s + 1}": int(c) for s, c in enumerate(m.BACKBONE_3D.CHANNELS)}}
    caps = {f"x_conv{s + 1}": c for s, c in enumerate(m.BACKBONE_3D.VOXEL_CAPS)}
    batch = m5_inputs(np.random.RandomState(47), meta, b, points, channels, caps)
    modules = torch.nn.ModuleDict({
        "pfe": VoxelSetAbstraction(m.PFE, meta.num_point_features, meta.grid_size,
                                   meta.voxel_size, meta.point_cloud_range,
                                   bev_channels=channels["bev"], multi_scale_channels=channels),
        "roi_head": PVRCNNPlusPlusHead(m.ROI_HEAD, 1,
                                       input_channels=int(m.PFE.NUM_OUTPUT_FEATURES))})
    init_weights(modules, torch.Generator().manual_seed(5))
    cpu_modules = copy.deepcopy(modules).eval()
    modules = modules.to(dev).eval()

    @torch.no_grad()
    def run(mods, inputs):
        out = mods["pfe"](dict(inputs))
        return mods["roi_head"](out)

    inputs = m5_tensors(batch, dev)
    run(modules, inputs)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = {"pfe": 0.0, "roi_head": 0.0}
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        with torch.no_grad():
            out = modules["pfe"](dict(inputs))
            ev[1].record()
            out = modules["roi_head"](out)
        ev[2].record()
        torch.cuda.synchronize()
        times["pfe"] += ev[0].elapsed_time(ev[1]) / 3
        times["roi_head"] += ev[1].elapsed_time(ev[2]) / 3
    peak = torch.cuda.max_memory_allocated(dev)
    want = run(cpu_modules, m5_tensors(batch, "cpu", scenes=1))
    worst = {}
    for k in ("point_coords", "point_valid"):
        if not torch.equal(out[k][:1].cpu(), want[k]):
            diff = (out[k][:1].cpu() != want[k]).nonzero()[0].tolist()
            raise AssertionError(f"path M.5: {k} differs between card and CPU first at {diff}")
    for k in ("point_features", "rcnn_cls", "rcnn_reg"):
        ref = want[k].abs().max().item()
        worst[k] = (out[k][:1].cpu() - want[k]).abs().max().item() / max(ref, 1e-12)
    ok = max(worst.values()) <= 1e-4 and bool(want["point_valid"].any())
    print(f"path M.5 PV-RCNN++ modules (pv_rcnn_plusplus.yaml widths, {b} Waymo-like scenes of "
          f"{points} points, {M5_ROIS} RoIs a scene): SPC VoxelSetAbstraction "
          f"{times['pfe']:.3f} ms ({int(out['point_valid'].sum())} valid keypoints of "
          f"{out['point_valid'].numel()}), PVRCNNPlusPlusHead {times['roi_head']:.3f} ms, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({smi}); scene 0 card vs CPU: keypoints "
          f"equal, worst |diff| / max |CPU| "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})} "
          f"(<= 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path M.5: PV-RCNN++'s modules on the card disagree with the CPU")


def path_m(dev, smi, entries, calls, pc_range=None, points=E_POINTS, real_points=E_REAL_POINTS,
           tree_points=L_POINTS, custom_points=M4_POINTS, pp_points=M5_POINTS, sets=None):
    """Path M, PV-RCNN (``configs/kitti_models/pv_rcnn.yaml``: path G's first
    stage, the keypoints of ``VoxelSetAbstraction``, ``PointHeadSimple``,
    the top 1,024 anchors as proposals, 100 RoIs in serving and 128 sampled
    in training, ``PVRCNNHead``'s 6^3 grid over the keypoints) at full
    width, batch 4: M.1 the small f32 reference, three serving batches and
    the eval step's stages, K4 on the final NMS's (4, 100) candidates and
    two synthetic cases, K2 / dgrad / K2w at its shapes (path G's); M.2 2
    train steps (GT on the model's own proposals), their terms and stages;
    M.3 the train and test CLIs over a KITTI tree; M.4 the custom config
    through the test CLI; M.5 PV-RCNN++'s modules.  Returns the launch
    counts of the serving forward and of the steps.  ``pc_range``, the
    point counts and ``sets`` ({"M.3": ``--set`` pairs, "M.4": ...}) are
    for rehearsals."""
    import shutil

    from com_tpu_torch.tools.kitti_tree import write_kitti_tree

    sets = sets or {}
    start = time.perf_counter()
    check_small_pvrcnn_reference(dev)
    cfg, meta, proc = load_voxel(PV_RCNN_CONFIG, pc_range)
    rng = np.random.RandomState(48)
    batches = kitti_voxel_batches(rng, meta, proc, "test", 3, M_BATCH, points, real_points)
    net, step, serve_counts = check_two_stage_serving(dev, "M (PV-RCNN, KITTI)", cfg, meta,
                                                      batches, EXPECT_M_SERVING, smi)
    two_stage_breakdown(net, lambda: step(batches[0]), "path M eval step", smi=smi)
    over, sv = final_candidates(net, cfg, batches[0], dev)
    check_k4_cases(dev, entries, calls, over, sv, smi, ", path M final NMS", "M:nms", iters=50)
    del net, step
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=G_CONV, dtypes=(torch.bfloat16,), path="M:")
    check_conv3x3_backward(dev, entries, shapes=G_CONV, wgrad_dtypes=(torch.bfloat16,),
                           path="M:")
    torch.cuda.empty_cache()
    train_counts = two_stage_training(
        dev, "M (PV-RCNN, KITTI)", cfg, meta,
        kitti_voxel_batches(rng, meta, proc, "train", 2, M_BATCH, points, real_points),
        EXPECT_M_TRAIN, M_TERMS, smi)
    torch.cuda.empty_cache()
    shutil.rmtree(M_DIR, ignore_errors=True)
    M_DIR.mkdir(parents=True)
    try:
        tree = M_DIR / "kitti"
        write_kitti_tree(tree, seed=L_SEED, num_train=L_TRAIN, num_val=L_VAL,
                         num_points=tree_points)
        m3_clis(dev, smi, tree, sets.get("M.3", ()))
        torch.cuda.empty_cache()
        m4_custom(dev, smi, M_DIR / "custom", custom_points, sets.get("M.4", ()))
    finally:
        shutil.rmtree(M_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    m5_plusplus_modules(dev, smi, points=pp_points)
    print(f"path M: {time.perf_counter() - start:.1f} s wall in all")
    return serve_counts, train_counts


def pointrcnn_small_case(seed=0):
    """``tests/test_pointrcnn.py``'s small PointRCNN (its ``pointrcnn_cfg``,
    written out: nothing here imports the JAX package's tests), f32, with
    ``pointrcnn.yaml``'s OPTIMIZATION, over 2 scenes of 1,024 points with 5
    features, 95 % valid: a car and a pedestrian cluster a scene (4 GT
    slots).  Returns (cfg, meta, batch)."""
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.utils.config import CfgNode, cfg_from_yaml_file

    names = ["Vehicle", "Pedestrian", "Cyclist"]
    nms = {"NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 16}
    model = {
        "NAME": "PointRCNN",
        "BACKBONE_3D": {"NAME": "PointNet2MSG", "SA_CONFIG": {
            "NPOINTS": [256, 64], "RADIUS": [[0.5, 1.0], [1.0, 2.0]], "NSAMPLE": [[8, 8], [8, 8]],
            "MLPS": [[[8, 8], [8, 8]], [[16, 16], [16, 16]]]},
            "FP_MLPS": [[16, 16], [16, 16]]},
        "POINT_HEAD": {
            "NAME": "PointHeadBox", "CLS_FC": [32], "REG_FC": [32],
            "TARGET_CONFIG": {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2], "BOX_CODER": "PointResidualCoder",
                              "BOX_CODER_CONFIG": {"use_mean_size": True, "mean_size": [
                                  [4.7, 2.1, 1.7], [0.91, 0.86, 1.73], [1.78, 0.84, 1.78]]}},
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {"point_cls_weight": 1.0, "point_box_weight": 1.0}}},
        "ROI_HEAD": {
            "NAME": "PointRCNNHead",
            "ROI_POINT_POOL": {"POOL_EXTRA_WIDTH": [0.0, 0.0, 0.0], "NUM_SAMPLED_POINTS": 64,
                               "DEPTH_NORMALIZER": 70.0},
            "XYZ_UP_LAYER": [16, 16], "CLS_FC": [16], "REG_FC": [16], "USE_BN": True,
            "SA_CONFIG": {"NPOINTS": [32, -1], "RADIUS": [0.4, 100], "NSAMPLE": [8, 8],
                          "MLPS": [[16, 16], [16, 32]]},
            "NMS_CONFIG": {"TRAIN": dict(nms, NMS_THRESH=0.8), "TEST": dict(nms, NMS_THRESH=0.85)},
            "TARGET_CONFIG": {"ROI_PER_IMAGE": 16, "FG_RATIO": 0.5, "REG_FG_THRESH": 0.55,
                              "CLS_FG_THRESH": 0.6, "CLS_BG_THRESH": 0.45},
            "LOSS_CONFIG": {"CORNER_LOSS_REGULARIZATION": True, "LOSS_WEIGHTS": {
                "rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0, "rcnn_corner_weight": 1.0,
                "code_weights": [1.0] * 7}}},
    }
    opt = cfg_from_yaml_file(str(REPO / POINTRCNN_CONFIG)).OPTIMIZATION
    cfg = CfgNode({"MODEL": model, "CLASS_NAMES": names, "OPTIMIZATION": opt})
    meta = DatasetMeta(names, (-10.0, -10.0, -2.0, 10.0, 10.0, 4.0), (0.1, 0.1, 6.0),
                       (200, 200, 1), 5)
    rng = np.random.RandomState(seed)
    gt = np.zeros((2, 4, 8), np.float32)
    pts = []
    for s in range(2):
        gt[s, 0] = [*rng.uniform(-6, 6, 2), 0.0, 4.2, 1.9, 1.6, rng.uniform(-3, 3), 1]
        gt[s, 1] = [*rng.uniform(-6, 6, 2), 0.0, 0.9, 0.8, 1.7, rng.uniform(-3, 3), 2]
        parts = [np.concatenate([rng.randn(200, 3) * 0.25 + box[None, :3], rng.rand(200, 2)], 1)
                 for box in gt[s, :2]]
        parts.append(np.concatenate([rng.uniform(-10, 10, (624, 2)), rng.uniform(-1, 2, (624, 1)),
                                     rng.rand(624, 2)], 1))
        pts.append(np.concatenate(parts))
    real = gt[..., 7] > 0
    batch = {"points": np.stack(pts).astype(np.float32), "points_mask": rng.rand(2, 1024) < 0.95,
             "gt_boxes": gt, "num_points_in_gt": real.astype(np.float32) * 200,
             "true_object": real.astype(np.float32)}
    return cfg, meta, batch


def spread_point_scores(net):
    """PointRCNN's seeded weights as path E's anchor head: the point head's
    class biases up by 1 (its scores spread over (0.5, 1)) and its box
    output layer 50-fold smaller (boxes near their class's mean size)."""
    with torch.no_grad():
        net.point_head.cls_layers[-1].bias.add_(1.0)
        net.point_head.box_layers[-1].weight.mul_(0.02)
    return net


def _mark_pointnet2_steps(net, mark):
    """Marks inside PointRCNN's point stages, for ``two_stage_marks``: each
    set abstraction of the backbone ("sa{k}.fps", "sa{k}.query",
    "sa{k}.block") and of the RoI head ("roi.sa{k}.*"; a group-all one
    opens with its block), each feature propagation ("fp{i}") and the RoI
    head's shared MLPs after its pooling ("roi.mlp"; the head's own mark,
    "roi_head", is the pooling).  Returns the function that removes
    them."""
    from com_tpu_torch.ops import pointnet2

    where, hooks, pooled = ["sa"], [], []

    def sa_marks(prefix, mods):
        for k, m in enumerate(mods):
            name = f"{prefix}{k}"

            def opens(*_, n=name, first=f"{name}.fps" if m.npoint is not None else None):
                where[0] = n
                mark(first or f"{n}.block")

            hooks.append(m.register_forward_pre_hook(opens))
            orig = m.pool

            def pool(*args, n=name, o=orig, **kw):
                mark(f"{n}.block")
                return o(*args, **kw)

            m.pool = pool
            pooled.append(m)

    sa_marks("sa", net.backbone_3d.SA_modules)
    for i, m in enumerate(net.backbone_3d.FP_modules):
        hooks.append(m.register_forward_pre_hook(lambda *_, i=i: mark(f"fp{i}")))
    head = net.roi_head
    sa_marks("roi.sa", head.SA_modules)
    hooks.append(head.xyz_up_layer.register_forward_pre_hook(lambda *_: mark("roi.mlp")))
    orig_group = pointnet2.query_and_group

    def group(*args, **kw):
        mark(f"{where[0]}.query")
        return orig_group(*args, **kw)

    pointnet2.query_and_group = group

    def undo():
        pointnet2.query_and_group = orig_group
        for m in pooled:
            del m.pool
        for h in hooks:
            h.remove()

    return undo


def check_small_pointrcnn_reference(dev):
    """N.1: ``pointrcnn_small_case`` on the card against the CPU, the same
    seeded weights: the eval step's detections (scores spread), and one
    train step (loss, gradients, batch statistics; no COM groups) within
    the tolerances or the CPU's own difference with the scenes swapped."""
    cfg, meta, batch = pointrcnn_small_case()
    label = "path N small reference (tests/test_pointrcnn.py's PointRCNN f32"
    compare_eval_step(dev, cfg, meta, batch, f"{label}, eval step, card vs CPU)",
                      prepare=spread_point_scores)
    compare_train_step(dev, cfg, meta, batch, f"{label}, train step, card vs CPU)",
                       counts_confidences=False, own_noise=True)


def point_proposal_candidates(net, cfg, batch, dev, train):
    """What PointRCNN's proposal layer hands K4 for ``batch`` in ``net``'s
    training or eval mode: the top NMS_PRE_MAXSIZE boxes of the valid
    points by score, in the NMS's score order, as (over, valid)."""
    import copy

    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG["TRAIN" if train else "TEST"]
    probe = copy.deepcopy(net).train(train)  # training mode moves the norms' statistics
    with torch.no_grad():
        out = probe.point_head(probe.backbone_3d({k: torch.as_tensor(batch[k], device=dev)
                                                  for k in ("points", "points_mask")}))
        scores = torch.where(out["point_valid"], out["point_cls_scores"],
                             torch.full_like(out["point_cls_scores"], -math.inf))
        return nms_overlaps(out["point_box_preds"], scores, nms_cfg)


def n3_training(dev, smi, cfg, meta, batches, tree, extra_set=()):
    """N.3: 2 steps with GT on the model's own proposals and the step's
    stages (``two_stage_training``); ``train_model`` over the tree's train
    split through the port's ``KittiDataset`` with ``pointrcnn.yaml``'s own
    DATA_CONFIG (batch 2, 1 epoch); one step of ``pointrcnn_iou.yaml``.
    Returns the launch counts of the 2 steps."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.tools.train import dataset_meta

    counts = two_stage_training(dev, "N (PointRCNN, KITTI)", cfg, meta, batches, EXPECT_N_TRAIN,
                                N_TERMS, smi, spread=spread_point_scores)
    torch.cuda.empty_cache()
    tcfg = l_cfg(POINTRCNN_CONFIG, tree, extra_set)
    names = list(tcfg.CLASS_NAMES)
    dataset, loader = build_dataloader(tcfg.DATA_CONFIG, names, N_BATCH, training=True,
                                       workers=L_WORKERS, seed=L_SEED)
    run_training(dev, "N.3 (pointrcnn.yaml, train_model over KittiDataset)", tcfg,
                 dataset_meta(tcfg, dataset), loader, 1, len(loader), EXPECT_N_TRAIN,
                 counts_confidences=False, smi=smi, prepare=spread_point_scores, terms=N_TERMS)
    torch.cuda.empty_cache()
    icfg, imeta, _ = load_voxel(POINTRCNN_IOU_CONFIG, meta.point_cloud_range)
    run_training(dev, "N.3 (pointrcnn_iou.yaml, one step)", icfg, imeta,
                 SyntheticLoader(batches[:1], 1), 1, 1, EXPECT_N_TRAIN, counts_confidences=False,
                 smi=smi, prepare=lambda net: follow_proposals(spread_point_scores(net)),
                 terms=N_TERMS)
    return counts


def n4_clis(dev, tree):
    """N.4: the train and test CLIs on ``pointrcnn.yaml`` raise
    NotImplementedError, as ``com_tpu``'s cannot run PointRCNN either (its
    train CLI initialises the model without points, its test CLI reads
    MODEL.DENSE_HEAD)."""
    from com_tpu_torch.tools import test, train

    base = ["--cfg_file", str(REPO / POINTRCNN_CONFIG), "--output_dir", str(N_DIR / "out"),
            "--device", str(dev), "--set", "DATA_CONFIG.DATA_PATH", str(tree)]
    for name, cli, extra in (("train", train, ["--epochs", "1"]),
                             ("test", test, ["--ckpt", str(N_DIR / "none.pth")])):
        try:
            cli.main(extra + base)
        except NotImplementedError as e:
            print(f"path N.4 {name} CLI on pointrcnn.yaml: NotImplementedError ({e}) ok")
        else:
            raise AssertionError(f"path N.4: the {name} CLI ran PointRCNN, com_tpu's cannot")


def path_n(dev, smi, entries, calls, pc_range=None, points=E_POINTS, real_points=E_REAL_POINTS,
           tree_points=L_POINTS, sets=None):
    """Path N, PointRCNN (``configs/kitti_models/pointrcnn.yaml``:
    ``PointNet2MSG`` over 4,096 / 1,024 / 256 / 64 FPS samples at two radii
    each and feature propagation back to every point, ``PointHeadBox``'s
    class and box a point, 4,096 point boxes -> 100 RoIs by K4 in serving,
    4,096 -> 512 -> 128 sampled in training, ``PointRCNNHead`` over 512
    pooled points a RoI) at full width, batch 2 of ~20,000 KITTI-like
    points in 32,768 slots, scores spread (``spread_point_scores``).  N.1
    the small f32 reference; N.2 three serving batches (latency, peak
    memory, K4 2 a forward), the eval step's stages, K4 on the (2, 4096)
    proposal candidates of serving and of training and on the final NMS's
    (2, 100), each with two synthetic cases; N.3 training
    (``n3_training``: K4 1 a step); N.4 the CLIs (``n4_clis``).  Returns
    the launch counts of a serving forward and of the 2 steps.
    ``pc_range``, the point counts and ``sets`` ({"N.3": ``--set`` pairs})
    are for rehearsals."""
    import shutil

    from com_tpu_torch.tools.kitti_tree import write_kitti_tree

    sets = sets or {}
    start = time.perf_counter()
    check_small_pointrcnn_reference(dev)
    cfg, meta, _ = load_voxel(POINTRCNN_CONFIG, pc_range)
    rng = np.random.RandomState(52)

    def batches(count):
        return [kitti_like_batch(rng, N_BATCH, meta.point_cloud_range, (0.16, 0.16, 4.0),
                                 n=points, real_points=real_points) for _ in range(count)]

    serve_batches, train_batches = batches(3), batches(2)
    net, step, serve_counts = check_two_stage_serving(
        dev, "N (PointRCNN, KITTI)", cfg, meta, serve_batches, EXPECT_N_SERVING, smi,
        spread=spread_point_scores)
    two_stage_breakdown(net, lambda: step(serve_batches[0]), "path N eval step", smi=smi)
    for what, kernel, (over, sv) in (
            ("serving proposals", "N:nms",
             point_proposal_candidates(net, cfg, serve_batches[0], dev, train=False)),
            ("train proposals", "N:nms_train",
             point_proposal_candidates(net, cfg, train_batches[0], dev, train=True)),
            ("final NMS", "N:nms", final_candidates(net, cfg, serve_batches[0], dev))):
        check_k4_cases(dev, entries, calls, over, sv, smi, f", path N {what}", kernel,
                       iters=20 if sv.shape[1] > 1024 else 50)
    del net, step
    torch.cuda.empty_cache()
    shutil.rmtree(N_DIR, ignore_errors=True)
    N_DIR.mkdir(parents=True)
    try:
        tree = N_DIR / "kitti"
        write_kitti_tree(tree, seed=L_SEED, num_train=N_TRAIN, num_val=1, num_points=tree_points)
        train_counts = n3_training(dev, smi, cfg, meta, train_batches, tree, sets.get("N.3", ()))
        n4_clis(dev, tree)
    finally:
        shutil.rmtree(N_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"path N: {time.perf_counter() - start:.1f} s wall in all")
    return serve_counts, train_counts


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
    torch.cuda.empty_cache()
    j_serve_counts, j_train_counts = path_j(dev, smi, entries, calls)
    torch.cuda.empty_cache()
    path_k(dev, smi)
    torch.cuda.empty_cache()
    path_h(dev, smi)
    torch.cuda.empty_cache()
    path_i(dev, smi)
    torch.cuda.empty_cache()
    l_counts = path_l(dev, smi, entries, calls)
    torch.cuda.empty_cache()
    m_serve_counts, m_train_counts = path_m(dev, smi, entries, calls)
    torch.cuda.empty_cache()
    n_serve_counts, n_train_counts = path_n(dev, smi, entries, calls)
    # each kernel's launches on the path that runs it: training path A,
    # serving for K4, path B for K3's last_wins mode, the sweep for T1-T4;
    # paths E, F, G and J's shapes: their training, and their serving for
    # K4 (path J's train proposals: its training); path L's shapes: L.2's
    # steps and serving forward, L.4's test CLI; path M's: its training,
    # and its serving for K4; path N's: its serving (K4 twice a forward) and
    # its 2 steps
    counts = {**a_counts, "nms": serve_counts["nms"],
              "stamp_last_wins": b_counts["stamp_last_wins"],
              **{f"wgrad_{v}": sweep_counts[f"wgrad_{v}"] for v in WGRAD_VARIANTS},
              **{f"{p}:{k}": v for p, c in (("E", e_train_counts), ("F", f_train_counts),
                                            ("G", g_train_counts), ("J", j_train_counts),
                                            ("M", m_train_counts))
                 for k, v in c.items()},
              "E:nms": e_serve_counts["nms"], "G:nms": g_serve_counts["nms"],
              "J:nms": j_serve_counts["nms"], "J:nms_train": j_train_counts["nms"], **l_counts,
              "M:nms": m_serve_counts["nms"], "N:nms": n_serve_counts["nms"],
              "N:nms_train": n_train_counts["nms"]}
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
