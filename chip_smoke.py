"""Drive the PyTorch/CUDA port's serving and training paths (over its own
data pipeline, through its train, test and demo CLIs, for the PointPillars
anchor head, the sparse-voxel detectors, the two-stage Voxel-RCNN and
SECOND-IoU, PV-RCNN, PointRCNN and PartA2, the CenterHead-RPN Voxel-RCNN
and PV-RCNN on Waymo, MPPNetE2E's streaming, the nuScenes and Lyft
configs, MPPNet and the other Waymo configs; the KITTI, nuScenes, Lyft and
Pandaset configs from trees on disk; the flagship from a Waymo tree the port
prepares, with the COM rehearsal; two-stage training under a data mesh; the
image models CaDDN and the focal multimodal Voxel-RCNN),
its
serving artifact (export, load and the HTTP server), its data-parallel
training and evaluation, and its wgrad sweep on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. Device and build: the card's name and power limit, TF32 switches set and
   printed, every CUDA kernel built from ``com_tpu_torch/csrc`` at once (one
   ``nvcc`` per source, all started together), the tensor-core
   instructions (HGMMA, HMMA) in the SASS of K2 and K2w counted (a source
   with none fails), TF32 ones in each instance of the f32 K2 and K2w
   kernels, and in each kernel function of T1-T4
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
   same function (the convs' under ``cudnn.benchmark``: cuDNN's fastest
   algorithm, TF32 off).  A row's bound is max(bytes / 3.35 TB/s,
   operations / peak): bf16 989 TFLOP/s, f32 67 (FMA), the f32 convs 495 / 3
   (three TF32 products an operation).
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
   path E's configuration at batch 2 and held to its eager step with path
   E's launches.
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
20. Path O, PartA2 (``kitti_models/PartA2.yaml``, batch 4) and
   PartA2-free (``path_o``'s docstring).
21. Path P, the CenterHead RPN, DynamicMeanVFE and MPPNetE2E: P.1 the
   Waymo YAMLs narrowed over a 64 x 64 x 40 grid in f32, card against CPU
   (Voxel-RCNN's eval step and a train step, PV-RCNN's eval step,
   MPPNetE2E's eval step and a 3-frame stream). P.2
   ``voxel_rcnn_with_centerhead_dyn_voxel.yaml`` at full width (batch 4
   of 163,840 points, DynamicMeanVFE into 80,000 slots, 1498 x 1498 x 40):
   the voxels its cap drops, three serving batches and their stages
   (``vfe.dynamic`` to ``final.*``), K4 on the (4, 512) serving and train
   proposals and the (4, 100) final NMS, K2 / dgrad / K2w at (4, 188,
   188) and (4, 94, 94), K3 at (4, 3, 188, 188), 2 train steps. P.3
   ``pv_rcnn_with_centerhead_rpn.yaml`` (batch 2): two serving batches,
   their stages (FPS of 4,096 keypoints over 163,840 points), K4 on the
   (2, 100) final NMS, 1 train step. P.4
   ``mppnet_e2e_memorybank_inference.yaml`` (batch 2): a 4-frame synthetic
   sequence, frame 0 through the eval step and the 4 frames through
   ``make_stream_step`` (the first step equal to the eval step), its
   stages, K4 on the (2, 96) final NMS.
22. Path Q, the nuScenes, Lyft and Pandaset datasets (``path_q``'s
   docstring): trees written from a seed (``com_tpu_torch/tools/
   dataset_trees.py``), Q.1 small f32 references card against CPU, Q.2
   ``nuscenes_models/cbgs_dyn_pp_centerpoint.yaml`` at full width (512 x 512,
   batch 4, 262,144 points a scene from 10 fused sweeps) fed by the port's
   loader: serving, stages, K1 / its backward / K3 / K4 on the inputs the
   path gave them, K2 / dgrad / K2w at its shapes, 2 steps of
   ``train_model``; Q.3 ``cbgs_pp_multihead``, ``cbgs_voxel0075`` /
   ``voxel01_res3d_centerpoint`` and Lyft's two SECOND-multihead configs,
   Lyft's mAP; Q.4 the train and test CLIs on both trees, the three
   loaders' rates.
23. Path R, MPPNet and the eight Waymo configs no earlier path runs
   (``path_r``'s docstring): R.0 MPPNet at the YAMLs' widths over 2,000
   points and 48 proposals a frame, card against CPU (linking, eval step,
   one f32 step); R.1 / R.2 ``mppnet_4frames`` /
   ``mppnet_16frames.yaml`` serving at full width (batch 2, 4 / 16 frames
   of 163,840 points fused, 500 proposals a frame), stages, K4 at the final
   NMS's (2, 500); R.3 both trained at the function level (12 steps, the
   loss below 0.8 of its first); R.4 ``centerpoint_4frames.yaml``'s boxes
   served through MPPNet; R.5 ``centerpoint``, ``centerpoint_without_
   resnet``, ``centerpoint_pillar``, the three ``com/`` single-class
   configs (2 epochs of 2 steps over their own YAML's pipeline, path C's
   gates: the epoch-end feedback reaching the dataset's COM2 sampler,
   (1, 96) / (1, 15), which draws the next epoch by it; K3 at (2, 1, 468,
   468)) and Waymo ``pointrcnn.yaml``: card against CPU small, a serving
   batch and two steps at full width each.
24. Path S, the flagship from raw frames (``path_s``'s docstring): a
   seeded Waymo tree (2 train sequences of 20 frames, 163,840 points a
   frame), its COM database through the port's ``create_data`` CLI
   (created, annotated, packed; every entry checked) and the COM2
   sampler's 96 / 15 / 15 groups; WaymoDataset's host rate; the flagship's
   feedback loop through the train CLI (3 epochs and one resumed: the
   rehearsal's table, the confidences reaching the sampler bitwise); the
   test CLI's Waymo AP; the rehearsal (``com_tpu_torch.tools.
   com_rehearsal``) with its bars on its synthetic config.
25. Path T, two-stage training under a data mesh (``path_t``):
   ``voxel_rcnn_car.yaml`` at full width in f32 on 2 ranks spawned on the
   card over gloo (2 scenes a rank), one step against one process over the
   global batch of 4 (loss and terms, foreground RoIs, running statistics,
   the gradient), the all-reduces a step; K2, dgrad and K2w in f32 at a
   rank's BEV shapes.
26. Path U, the image models (``path_u``): U.1 CaDDN, the focal backbone
   and ``focal_split_and_spawn`` card against CPU; U.2 ``CaDDN.yaml`` at
   full width (375 x 1242 images, batch 2): 3 serving batches and their
   stages, K4 on its (2, 4096) candidates, K2 / dgrad / K2w in f32 at its
   BEV shapes, 2 train steps with ``ddn_loss``; U.3
   ``voxel_rcnn_car_focal_multimodal.yaml`` from its own DATA_CONFIG over a
   seeded KITTI tree with PNG images (the loader's rate, the pastes that
   survive the 2D prefilter, 3 serving batches, 2 steps, K2 and its
   backward at SemSegEncoder's shapes, the train and test CLIs with the
   KITTI AP line); U.4 a pcdet-layout Voxel-RCNN state dict through the
   train CLI's ``--pretrained_model``, its eval step against the folded
   model's.
27. Launch counts: every counter is zeroed just before each path (the
   sweep, serving, A, B, C, D's, E's, F's, G's, J's, K's, H's, L's, M's,
   N's, O's, P's, Q's, R's, S's, T's and U's phases, and in each rank of
   I and T) and read
   just after, against the calls the sweep
   reports and the expected counts per
   forward or per step.  The device
   kernels one K3 call issues (1) and one K4 call (2, the pack and the
   sweep), counted by torch.profiler in a child process after every timed
   phase.  Then the
   ``kernels`` line, the card's name and power limit, and the device line
   as the last line.  Each phase's wall seconds are printed as it ends
   (``phase time``) and all together before the ``kernels`` line.

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
import pickle
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
# the conv kernels' peaks: bf16 on the tensor cores; f32 as three TF32
# products on them (dense TF32 495 TFLOP/s, three passes an operation)
CONV_PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
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
# the anchor artifact's batch: its export traces the row-blocked IoU once a
# row block a sample (8 blocks a sample at NMS_PRE_MAXSIZE 4,096), ~3.7 s a block
H_ANCHOR_BATCH = 1
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
# path O: PartA2 on KITTI (UNetV2's encoder and decoder, the part head, the
# anchor proposals through K4, RoI-aware pooling, PartA2FCHead), and
# PartA2-free (PointRCNN over MeanVFE and UNetV2)
PARTA2_CONFIG = "configs/kitti_models/PartA2.yaml"
PARTA2_FREE_CONFIG = "configs/kitti_models/PartA2_free.yaml"
O_DIR = REPO / "build" / "path_o"  # path O's tree and CLI outputs, removed after the path
O_BATCH, O_FREE_BATCH = 4, 2  # the YAMLs' BATCH_SIZE_PER_GPU
O_TRAIN, O_VAL = 8, 2  # the tree's frames: 2 steps of batch 4
O_TERMS = ("rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "point_loss_cls", "point_loss_part",
           "rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner")
O_FREE_TERMS = ("point_loss_cls", "point_loss_box", "point_loss_part", "rcnn_loss_cls",
                "rcnn_loss_reg", "rcnn_loss_corner")
EXPECT_O_SERVING = {"conv3x3": 11, "nms": 2}  # the proposal NMS and the final one
EXPECT_O_TRAIN = {"conv3x3": 11, "conv3x3_dgrad": 11, "conv3x3_wgrad": 11, "nms": 1}
WGRAD_THS = (8, 16)
# variant -> (TPU kernel, line of its pallas_call in tools/perf/microbench_wgrad_kernels.py)
WGRAD_VARIANTS = {"gcol": ("T1", 84), "xcol": ("T2", 128), "gt9": ("T3", 175),
                  "gtcol": ("T4", 220)}
WGRAD_SOURCE = "com_tpu_torch/csrc/wgrad_variants.cu"
# T1-T4's partial kernels in the SASS of wgrad_variants.cu: TPU kernel -> (a
# piece of the mangled name of each of its instances, the tensor-core instruction)
WGRAD_SASS = {"T1": ("gtcol_kernelILi1E", "HGMMA"), "T2": ("xcol_kernelI", "HMMA"),
              "T3": ("gt9_kernelI", "HGMMA"), "T4": ("gtcol_kernelILi4E", "HGMMA")}
# the f32 K2 and K2w kernels: source -> (a piece of the mangled name of each
# instance, the instances: the 16- and 4-byte load branches, K2's for 2 and
# 4 warpgroups a block); each must hold TF32 tensor-core instructions
# (HGMMA or HMMA ... TF32)
F32_SASS = {"conv3x3": ("conv3x3_f32_kernelI", 4), "conv3x3_wgrad": ("wgrad_f32_kernelI", 2)}


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


def library_ms(fn, iters):
    """``cuda_ms`` of one PyTorch library call under ``cudnn.benchmark``, so
    that cuDNN times its algorithms on the first calls and keeps the fastest
    (TF32 stays as set); the setting is restored afterwards."""
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        return cuda_ms(fn, iters, warmup=3)
    finally:
        torch.backends.cudnn.benchmark = prev


def device_ms(fn, iters):
    """Mean milliseconds a call takes on the card with the calls queued
    behind a spin kernel (the sweep's ``call_ms(..., queued=True)``): the
    device time of a call, also of one shorter than its launch."""
    from com_tpu_torch.tools.perf.conv_tiles import call_ms

    return call_ms(fn, iters, queued=True)


def check_device_kernels(calls):
    """For each (label, count, op, args, kw) the device kernels one call of
    ``com_tpu_torch.ops.<op>(*args, **kw)`` issues must number ``count``.
    A label is counted once: it names the kernel and its shape, which decide
    the kernels a call issues.  The count runs in a child process
    (``count_device_kernels``), since in a process that has run the paths a
    profiling session now and then sees no device activity at all, every
    try after some session (once from the 79th on, once from the 29th)."""
    cases, seen = [], set()
    for label, count, op, args, kw in calls:
        if label not in seen:
            seen.add(label)
            cases.append((label, count, op, moved(args, "cpu"), moved(kw, "cpu")))
    path = REPO / "build" / "device_kernels.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(cases, path)
    sys.stdout.flush()
    try:
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--device-kernels",
                        str(path)], check=True, timeout=600)
    finally:
        path.unlink(missing_ok=True)


def moved(x, dev):
    """``x`` with every tensor in it (in tuples, lists and dicts) on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(moved(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: moved(v, dev) for k, v in x.items()}
    return x


def count_device_kernels(path):
    """``--device-kernels PATH``: the cases ``check_device_kernels`` saved,
    counted in one torch.profiler session after a warm-up call of each: a
    marker (``torch.cuda._sleep``, one ``spin_kernel``) before each call and
    after the last, so the device events between two markers are one call's.
    A session that lacks a marker is run again, up to ``PROFILE_SESSIONS``
    times."""
    import importlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda", 0)
    fns = []
    for label, count, op, args, kw in torch.load(path, weights_only=False):
        mod, name = op.rsplit(".", 1)
        fn = getattr(importlib.import_module(f"com_tpu_torch.ops.{mod}"), name)
        fns.append((label, count, lambda f=fn, a=moved(args, dev), k=moved(kw, dev): f(*a, **k)))
    for _, _, fn in fns:
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _, _, fn in fns:
                torch.cuda._sleep(1000)
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if len(marks) == len(fns) + 1:
            break
        print(f"device kernels: profiling session {attempt} saw {len(marks)} of "
              f"{len(fns) + 1} markers")
    else:
        raise AssertionError(f"{PROFILE_SESSIONS} profiling sessions missed markers")
    bad = []
    for (label, count, _), a, b in zip(fns, marks, marks[1:]):
        names = [e.name for e in events[a + 1:b]]
        ok = len(names) == count
        print(f"{label}: one call issues {len(names)} device kernel(s) "
              f"{[n.replace('(anonymous namespace)::', '').split('(')[0] for n in names]} "
              f"({count}) {'ok' if ok else 'FAIL'}")
        bad += [] if ok else [label]
    if bad:
        raise AssertionError(f"{bad} issue other numbers of device kernels")


def bound_ms(nbytes, ops, dtype, peaks=PEAK_OPS):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peaks[dtype] * 1e3
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
        if name in F32_SASS:
            check_f32_sass(sass, name)
    return smi


def sass_functions(sass):
    """cuobjdump's SASS split by kernel function: mangled name -> its code."""
    parts = sass.split("Function : ")[1:]
    return {p.split(None, 1)[0]: p for p in parts}


def check_f32_sass(sass, name):
    """Each instance of the f32 K2 / K2w kernel holds TF32 tensor-core
    instructions: the per-file count above would pass on the bf16 kernels
    alone."""
    piece, instances = F32_SASS[name]
    found = {f: sum(1 for line in code.splitlines()
                    if ("HGMMA." in line or "HMMA." in line) and "TF32" in line)
             for f, code in sass_functions(sass).items() if piece in f}
    ok = len(found) == instances and all(found.values())
    print(f"sass: csrc/{name}.cu's f32 kernels hold {sorted(found.values())} TF32 tensor-core "
          f"instructions {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"csrc/{name}.cu: TF32 tensor-core instructions {found}")


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
                  path="", f32_path=None):
    """K2 at each (B, H, W, C) (C -> C) or (B, H, W, Cin, Cout) of ``shapes``
    in each dtype; ``path`` prefixes the counter whose launches the entries
    report (``f32_path``, where given, the f32 entries')."""
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
            lib_ms = library_ms(lambda: F.conv2d(xc, wc, padding=1), 10)
            flops = 2 * 9 * c * co * b * h * wd  # the serving path runs the bf16 case
            bms, by = bound_ms(nbytes(x, w, got), flops, dt, CONV_PEAK_OPS)
            entries.append(dict(name=f"conv2d.conv3x3 {label}", route="cuda",
                                source="com_tpu_torch/csrc/conv3x3.cu",
                                replaces="com_tpu/ops/pallas/conv2d.py:208",
                                max_abs_err=err.max().item(), ms=ms,
                                device_ms=dev_ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                                kernel=(f32_path if dt == torch.float32 and f32_path else path)
                                + "conv3x3"))


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
                           wgrad_dtypes=(torch.float32, torch.bfloat16), path="",
                           dgrad_dtype=torch.bfloat16, f32_path=None):
    """K2 dgrad (K2 on the output gradient with the rotated kernel) checked
    through the autograd.Function and timed as the call its backward makes
    (``conv3x3_dgrad``) in ``dgrad_dtype``, and K2w, at the backbone's
    shapes ``shapes``; ``path`` prefixes the counters whose launches the
    entries report (``f32_path``, where given, the f32 entries')."""
    from com_tpu_torch.ops import conv2d

    gen = torch.Generator(device=dev).manual_seed(13)
    for b, h, wd, c, co in map(conv_shape, shapes):
        flops = 2 * 9 * c * co * b * h * wd
        x0 = torch.randn((b, h, wd, c), device=dev, generator=gen).to(dgrad_dtype)
        w = (torch.randn((3, 3, c, co), device=dev, generator=gen) / math.sqrt(9 * c))
        w = w.to(dgrad_dtype)
        g = torch.randn((b, h, wd, co), device=dev, generator=gen).to(dgrad_dtype)
        runs = []
        for fn in (conv2d.conv3x3, conv2d.conv3x3_plain):
            x = x0.clone().requires_grad_()
            y = fn(x, w)
            runs.append((x, y, torch.autograd.grad(y, x, g, retain_graph=True)[0]))
        torch.cuda.synchronize()
        (x, y, got), (px, py, want) = runs
        absref = conv2d.conv3x3_plain(g.float().abs(), conv2d.rotate_kernel(w.float().abs()))
        err = (got.float() - want.float()).abs()
        rnd = 0.0 if dgrad_dtype == torch.float32 else 2.0 ** -7
        ok = bool((err <= 1e-5 * absref + rnd * want.float().abs()).all())
        label = f"{str(dgrad_dtype).split('.')[-1]} ({b},{h},{wd},{c}->{co})"
        print(f"K2 conv3x3 dgrad {label}: max_abs_err={err.max().item():.3e} "
              f"(|err| <= 1e-5 * conv(|g|,|w_rot|) + {rnd:g} * |plain|) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K2 dgrad {label} disagrees with its plain version")
        # the call the backward makes: K2 on g with the rotated kernel
        ms = cuda_ms(lambda: conv2d.conv3x3_dgrad(g, w), 10)
        dev_ms = device_ms(lambda: conv2d.conv3x3_dgrad(g, w), 10)
        plain_ms = cuda_ms(lambda: conv2d.conv3x3_plain(g, conv2d.rotate_kernel(w)), 5)
        gc = g.permute(0, 3, 1, 2)  # NHWC storage = channels_last NCHW view
        wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        lib_ms = library_ms(lambda: torch.nn.grad.conv2d_input((b, c, h, wd), wc, gc,
                                                               padding=1), 10)
        bms, by = bound_ms(nbytes(g, w, got), flops, dgrad_dtype, CONV_PEAK_OPS)
        entries.append(dict(name=f"conv2d.conv3x3 dgrad {label}", route="cuda",
                            source="com_tpu_torch/csrc/conv3x3.cu",
                            replaces="com_tpu/ops/pallas/conv2d.py:544",
                            max_abs_err=err.max().item(), ms=ms,
                            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms,
                            bound_by=by, library_ms=lib_ms,
                            kernel=(f32_path if dgrad_dtype == torch.float32 and f32_path
                                    else path) + "conv3x3_dgrad"))
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
            lib_ms = library_ms(lambda: torch.nn.grad.conv2d_weight(xc, (co, c, 3, 3), gc,
                                                                    padding=1), 10)
            bms, by = bound_ms(nbytes(xd, gd, got), flops, dt, CONV_PEAK_OPS)
            entries.append(dict(name=f"conv2d.conv3x3_wgrad {label}", route="cuda",
                                source="com_tpu_torch/csrc/conv3x3_wgrad.cu",
                                replaces="com_tpu/ops/pallas/conv2d.py:235",
                                max_abs_err=err.max().item(), ms=ms,
                                device_ms=dev_ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by, library_ms=lib_ms,
                                kernel=(f32_path if dt == torch.float32 and f32_path else path)
                                + "conv3x3_wgrad"))
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
        lib_ms = library_ms(lambda: torch.nn.grad.conv2d_weight(xc, (cout, cin, 3, 3), gc,
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


def check_stamp(dev, entries, calls, hw=(468, 468), path="", b=BATCH,
                modes=("gauss", "last_wins")):
    """K3 in ``modes`` on the training path's canvas (2, 3, 468, 468), or
    (b, 3, *hw), with 500 object slots: ~100 real objects a sample, some invalid slots among
    them, radii past the clip, overlapping windows, centers on the edges.
    The inputs have the dtypes the path's callers pass (int32 ids, no values
    for the heatmap targets; int64 classes and f32 weights for the COM loss
    mask).  Each mode's call goes into ``calls`` with the one device kernel
    it must issue (counted by ``check_device_kernels`` at the end).
    ``path`` prefixes the counters whose launches the entries report."""
    rng = np.random.RandomState(14)
    n, c, (h, w) = NUM_MAX_OBJS, 3, hw
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
    for mode, fill, args in (("gauss", 0.0, (cen, rad, cl32, None, vld)),
                             ("last_wins", 1.0, (cen, rad, cl32.long(), val, vld))):
        if mode not in modes:
            continue
        got = check_k3_call(dev, entries, calls, (*args, c, h, w, mode), {"fill": fill}, "",
                            f"{path}stamp_{mode}", "")
        if mode == "gauss":  # every valid object's centre cell exactly 1.0
            bi, oi = np.nonzero(valid)
            centre = got[tuple(torch.as_tensor(a, device=dev) for a in (
                bi, cls[bi, oi], centers[bi, oi, 1], centers[bi, oi, 0]))]
            if not bool((centre == 1.0).all()):
                raise AssertionError("K3 gauss: a valid object's centre is not 1.0")


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
        calls.append((f"K4 greedy_suppress ({b},{k}) {label}", 2, "nms.greedy_suppress",
                      (ov, vd), {}))
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


def stage_breakdown(net, step, batch, label, iters=5, smi="", inner=()):
    """Where one full-size eval step spends its time on the card: CUDA
    events recorded by forward hooks at each slot's start and end, mean over
    ``iters`` steps.  "upload" is the host-to-card copy of the batch,
    "decode_nms" the decode and NMS after the head, itself split into the
    decode, for an anchor head the top NMS_PRE_MAXSIZE ("topk"), the score
    sort and gathers, the self-IoU, K4, ``_kept_slots`` and the rest (the
    final gathers).  ``inner`` holds (slot, name, module) triples: a module
    that the slot's forward calls once, timed under ``name`` and taken out
    of the slot's time."""
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

    hooks = [h for m in [getattr(net, s) for s in slots] + [m for _, _, m in inner]
             for h in (m.register_forward_pre_hook(mark), m.register_forward_hook(mark))]
    split = {s: (s, n, s) for s, n, _ in inner}  # the slot's time either side of the module
    undo = _mark_nms_steps(sub_mark)
    orig_top = anchor_head.top_candidates

    def top(*args, **kw):
        sub_mark("topk")
        return orig_top(*args, **kw)

    anchor_head.top_candidates = top
    names = (["upload"] + [n for s in slots for n in (*split.get(s, (s,)), "gap")][:-1]
             + ["decode_nms"])
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
            groups = len(labels) // len(NMS_MARKS)
            if part_names is None and groups > 1 and labels == NMS_MARKS * groups:
                # one decode and NMS a head group: "rest" then runs on to the
                # next group's sort (its decode included), summed over groups
                part_names = NMS_PARTS[:1] + NMS_PARTS[1:] * groups
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
                       own_noise=False, prepare=None):
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
    turn rounding into more than 1e-5 of a statistic.  ``prepare(net)`` may
    adjust the weights after the norms' shift."""
    from com_tpu_torch.models.layers import BatchNorm

    def run(d, b):
        net, _, state, step = build_trainer(d, cfg, meta, 1, seed=7)
        shift_norm_biases(net)
        if prepare is not None:
            prepare(net)
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
        norms = [k.rsplit(".", 1)[0] for k in sb if k.endswith("running_mean")]
        serr, worst[0] = max((float(stat_err(sa, sb, n).max()), n) for n in norms)
        return abs(la - lb) / abs(lb), gerr, serr

    worst = [None]  # the norm of the largest statistic error of the last ``errors``

    (l0, _, _, cs0, cc0), (l1, _, _, cs1, cc1) = card, cpu = run(dev, batch), run("cpu", batch)
    lerr, gerr, serr = errors(card, cpu)
    worst_norm = worst[0]
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
          f"(<= {stol:.2e}; worst {worst_norm}); "
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


def path_c_dataset_cfg(cfg, bg_points=120000, max_points=POINTS, scenes=BATCH * C_STEPS,
                       objects=48):
    """The synthetic dataset of path C (the JAX package's end-to-end bench
    loader, ``bench.py`` ``_make_loader``): ``scenes`` scenes (path C's
    epoch) of ``bg_points`` ground points and up to ``objects`` objects,
    the in-memory GT database, ``cfg``'s DATA_AUGMENTOR (the flagship's:
    COM2 GT-paste, world flip, rotation, scaling) and DATA_PROCESSOR (the
    flagship's: range mask, shuffle, pillar presort at 0.32 m), 500 object
    slots."""
    import copy

    from com_tpu_torch.utils.config import CfgNode

    d = cfg.DATA_CONFIG
    return CfgNode({"DATASET": "SyntheticDataset", "NUM_SCENES": scenes,
                    "NUM_OBJECTS": objects,
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
    data pipeline (``pipeline_training``), its DATA_PROCESSOR presorting
    the points by pillar.  Prints the host pipeline's own rate first."""
    from com_tpu_torch.data.processor import pipeline_presorts_points

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
    counts, _, step_ms, _ = pipeline_training(dev, "path C", "C (flagship, own pipeline)", cfg,
                                              meta, ds_cfg, C_EPOCHS, C_STEPS, EXPECT_TRAIN,
                                              (len(names), 96))
    return counts, step_ms


def pipeline_training(dev, name, label, cfg, meta, ds_cfg, epochs, steps, expect, conf_shape):
    """``train_model`` (``label``) over the port's own data pipeline on
    ``ds_cfg``: ``build_dataloader`` -> ``PrefetchLoader`` (COM2 GT-paste,
    world augmentations, the processor, collate) -> ``DevicePrefetcher``
    -> ``make_train_step``, with the curriculum loop closed: each epoch's
    card-computed confidences reach the dataset's COM2 sampler through
    ``DatasetTemplate.set_confidence_groups``, and the sampler draws the
    next epoch's pastes by them.  Gates: fixed shapes and pasted objects
    (``CheckedLoader``); every sample's valid points sorted by pillar on
    the card (``point_voxel_ids``) where ASSUME_SORTED_POINTS is set; the
    sampler a DataBaseSamplerCOM2 holding each epoch's confidences
    bitwise, of ``conf_shape``; COM2's group probabilities away from the
    size-proportional ones at every epoch past the first; finite losses,
    gradients and parameters; ``expect`` launches a step.  Prints the step
    time, the main thread's wait for a batch and peak memory.  Returns the
    counts, the trainer (net, opt, state, step), the step times and the
    sampler."""
    from com_tpu_torch.data.dataset import build_dataloader
    from com_tpu_torch.ops.voxelize import point_voxel_ids

    names = list(cfg.CLASS_NAMES)
    sorted_in = bool(cfg.MODEL.VFE.get("ASSUME_SORTED_POINTS", False))
    ds, loader = build_dataloader(ds_cfg, names, BATCH, training=True, seed=C_SEED,
                                  workers=C_WORKERS)
    sampler = ds.data_augmentor.gt_sampler
    aug = next(c for c in ds_cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST if c.NAME == "gt_sampling")
    checked = CheckedLoader(loader, names, int(ds_cfg.MAX_POINTS_PER_SCENE), aug.SAMPLE_GROUPS)
    acc = {}  # epoch -> (sum, count) of the steps' confidence statistics, on the card
    sorted_ok, waits, shares = [], [], []
    seen = {}  # epoch -> the sampler's confidences at its first step
    last = {"t": None}

    def step_wrap(step):
        def wrapped(state, batch, epoch):
            t = time.perf_counter()
            if last["t"] is not None and epoch == last["epoch"]:
                waits.append(t - last["t"])
            if sorted_in:  # every sample's valid points non-decreasing in pillar id
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

    counts, trainer, step_ms = run_training(dev, label, cfg, meta, checked, epochs, steps,
                                            expect, step_wrap=step_wrap, epoch_hook=epoch_hook)
    state = trainer[2]
    seen[epochs] = np.array(sampler.confidence_groups)
    held = []
    for epoch in range(1, epochs + 1):  # the feedback of epoch - 1 against the card's
        s_, c_ = acc[epoch - 1]
        want = (s_ / (c_ + 0.01)).cpu().numpy()
        got = seen[epoch]
        held.append(got.shape == want.shape == conf_shape and got.dtype == want.dtype
                    and got.tobytes() == want.tobytes())
    for epoch, c, k, u, diff, n in shares:
        print(f"  epoch {epoch} {c}: pacing index k = {k}, centre u = {u:.6f}, "
              f"max |p - size share| = {diff:.3e} over {n} groups")
    moved = [diff > 1e-6 for *_, diff, _n in shares]
    ok_sorted = bool(torch.stack(sorted_ok).all()) if sorted_in else True
    room = sum(1 for *_, q, _p in checked.samples if sum(max(v, 0) for v in q.values()))
    with_paste = sum(1 for *_, p in checked.samples if sum(p.values()))
    pasted = sum(sum(p.values()) for *_, p in checked.samples)
    kind = type(sampler).__name__
    print(f"{name} checks: {len(checked.samples)} samples, fixed shapes and pasted objects "
          f"{'ok' if not checked.errors else checked.errors}; {room} with room under "
          f"LIMIT_WHOLE_SCENE, {with_paste} carry pasted objects, {pasted} in all; "
          + (f"valid points pillar-sorted on the card {ok_sorted}; " if sorted_in else "")
          + f"the dataset's {kind} holds each epoch's confidences {conf_shape} bitwise {held}; "
          f"COM2 leaves the size shares {moved}")
    print(f"  main thread's wait for a batch (host clock between steps, the first of each "
          f"epoch left out): mean {1e3 * np.mean(waits):.3f} ms over {len(waits)}")
    if (checked.errors or not pasted or not ok_sorted or not all(held)
            or kind != "DataBaseSamplerCOM2"
            or len(moved) != (epochs - 1) * len(names) or not all(moved)
            or tuple(state.conf_sum.shape) != conf_shape):
        raise AssertionError(f"training {name} failed its checks")
    return counts, trainer, step_ms, sampler


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
    print(f"path E: {int(valid.sum())} valid points in K1's input")
    check_k1_call(dev, entries, vals, seg, "sum", "path E", "E:seg_scan", smi)


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


def voxel_yaml_clis(dev, smi, config, label, expect, batch, post_max, pc_range=None,
                    bg_points=120000, edit_model=None):
    """A voxel YAML through the train CLI (1 epoch of 2 steps at ``batch``)
    and the test CLI on its checkpoint, over path C's synthetic dataset
    (2 x ``batch`` scenes, the flagship's augmentor) with the YAML's own
    DATA_PROCESSOR (the native voxelizer); ``edit_model(model_cfg)`` may
    change the written MODEL.  Checks the train step's launches
    (``expect``), finite boxes, scores in descending order, at most
    ``post_max`` a frame and labels in range."""
    import shutil

    import yaml

    from com_tpu_torch.tools import test, train

    cfg, meta, _ = load_voxel(config, pc_range)
    flagship, _ = load_config()
    root = REPO / "build" / f"path_{label[0].lower()}"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        data_cfg = _plain(path_c_dataset_cfg(flagship, bg_points=bg_points))
        data_cfg.update(NUM_SCENES=2 * batch, POINT_CLOUD_RANGE=list(meta.point_cloud_range),
                        DATA_PROCESSOR=_plain(cfg.DATA_CONFIG.DATA_PROCESSOR))
        model_cfg = _plain(cfg.MODEL)
        if edit_model is not None:
            edit_model(model_cfg)
        yaml_path = root / f"{Path(config).stem}_clis.yaml"
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
        check_launches(f"{label} train step (CLI)", read_counters(), expect,
                       first["iterations"])
        ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
        t0 = time.perf_counter()
        (res,) = test.main(base + ["--ckpt", str(ckpt)])
        test_wall = time.perf_counter() - t0
        annos = res["det_annos"]
        ok = (first["iterations"] == 2 and ckpt.exists() and len(annos) > 0
              and all(np.isfinite(a["boxes_lidar"]).all() and (np.diff(a["score"]) <= 0).all()
                      and len(a["score"]) <= post_max and set(a["pred_labels"]) <= {1, 2, 3}
                      for a in annos))
        print(f"path {label} CLIs: train {first['iterations']} steps in {wall:.2f} s wall "
              f"(dataset, model and loader included); test {len(annos)} frames in "
              f"{test_wall:.2f} s, {[len(a['score']) for a in annos]} detections, "
              f"{res['sec_per_frame']:.4f} s a frame ({smi}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"path {label}: the train / test CLIs failed their checks")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def path_f_cli(dev, smi, pc_range=None, bg_points=120000):
    """The voxel YAML through the train and test CLIs (``voxel_yaml_clis``,
    batch 2); SCORE_THRESH 0 for the evaluation, as path D.  Launches: path
    F's a train step."""
    cfg, _, _ = load_voxel(VOXEL_CONFIG, pc_range)

    def edit(model_cfg):
        model_cfg["DENSE_HEAD"]["POST_PROCESSING"]["SCORE_THRESH"] = D_SCORE_THRESH

    voxel_yaml_clis(dev, smi, VOXEL_CONFIG, "F", EXPECT_F_TRAIN, BATCH,
                    int(cfg.MODEL.DENSE_HEAD.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE),
                    pc_range, bg_points, edit_model=edit)


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
    slots) also ``_mark_point_steps``'s, with PointRCNN's
    ``_mark_pointnet2_steps``'s, with PartA2's UNet ``_mark_parta2_steps``'s
    (the slot's mark then "unet.encoder").  Returns the function that
    removes them."""
    from com_tpu_torch.models.roi_heads import voxelrcnn_head

    phase = ["proposal"]
    hooks = []
    unet = hasattr(net.backbone_3d, "conv_up_t4")
    for s in ("vfe", "backbone_3d", "map_to_bev", "pfe", "backbone_2d", "dense_head",
              "point_head"):
        if getattr(net, s, None) is not None:
            # the PFE opens with its keypoint sampling, a UNet with its encoder
            name = {"pfe": "pfe.fps", "backbone_3d": "unet.encoder" if unet else s,
                    "vfe": "vfe.dynamic" if type(net.vfe).__name__ == "DynamicMeanVFE"
                    else s}.get(s, s)
            hooks.append(getattr(net, s).register_forward_pre_hook(
                lambda *_, name=name: mark(name)))
            hooks.append(getattr(net, s).register_forward_hook(lambda *_: mark("gap")))
    if getattr(net, "pfe", None) is not None:
        undo_points = _mark_point_steps(net, mark)
    elif hasattr(net.backbone_3d, "SA_modules"):
        undo_points = _mark_pointnet2_steps(net, mark)
    elif unet:
        undo_points = _mark_parta2_steps(net, mark)
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


def two_stage_breakdown(net, run, label, iters=3, smi="", stage_hook_marks=None,
                        marks_fn=None):
    """Device ms of each stage of ``run()`` (an eval step, or a train step
    whose ``stage_hook`` records "forward", "loss", "backward", "optimizer"
    through ``stage_hook_marks``), CUDA events by ``two_stage_marks`` (or
    ``marks_fn``), summed
    a stage over its intervals, mean over ``iters`` runs after a warm-up;
    an interval is named by the mark that opens it."""
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    if stage_hook_marks is not None:
        stage_hook_marks.append(mark)
    undo = (marks_fn or two_stage_marks)(net, mark)
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


def follow_proposals(net, per_scene=J_GT, off=False):
    """In training, put the first ``per_scene`` GT slots of each scene on the
    proposals ``net`` makes at that moment (boxes, labels), before the RoI
    targets are drawn and the anchor loss reads them.  Random weights
    propose nothing near fixed GT, and one Adam step at the one-cycle's
    first rate moves every proposal (each weight of conv_box moves by lr
    with its gradient's sign: a coherent shift over its 512 inputs; with GT
    set once from the seeded model's proposals, step 2 saw 0 foreground
    RoIs on the card).  Adds no launch: the proposals are the step's own.
    With ``off`` each GT is moved a little off its proposal (x, z, size,
    heading): a CenterHead's L1 box loss at a GT equal to its own decode
    sits on its kink, where the card and the CPU take the sign of rounding."""
    orig = net._proposals

    def proposals(batch):
        out = orig(batch)
        if net.training and "gt_boxes" in batch:
            rois, _, labels, valid = out
            gt = batch["gt_boxes"].clone()
            k = min(per_scene, gt.shape[1], rois.shape[1])
            gt[:, :k, :7] = rois[:, :k, :7] * valid[:, :k, None]
            if off:
                step = torch.arange(1, k + 1, dtype=gt.dtype, device=gt.device)[None]
                gt[:, :k, 0] += 0.05 * step
                gt[:, :k, 2] += 0.03 * step
                gt[:, :k, 3:6] *= 1.0 + 0.04 * step[..., None]
                gt[:, :k, 6] += 0.05 * step
                gt[:, :k, :7] *= valid[:, :k, None]
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
    thresh = float(post.get("SCORE_THRESH", 0.1))
    net = spread(build_network(cfg.MODEL, meta, device=dev, seed=0))
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    rois = []
    hook = net.roi_head.register_forward_pre_hook(lambda m, args: rois.append(
        args[0]["rois"].shape[1]))
    step(batches[0])  # warm-up
    hook.remove()
    slots = min(int(post.get("NMS_CONFIG", {}).get("NMS_POST_MAXSIZE", 500)),
                rois[0])  # the NMS's output slots
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
    from com_tpu_torch.models.dense_heads.center_head import decode_center_proposals
    from com_tpu_torch.models.detectors import Detector3D
    from com_tpu_torch.train.step import model_input_keys

    nms_cfg = cfg.MODEL.ROI_HEAD.NMS_CONFIG["TRAIN" if train else "TEST"]
    probe = copy.deepcopy(net).train(train)  # training mode moves the norms' statistics
    with torch.no_grad():
        first = Detector3D.forward(probe, {k: torch.as_tensor(batch[k], device=dev)
                                           for k in model_input_keys(cfg.MODEL)})
        if probe.anchor_rpn:
            boxes, scores, _ = decode_anchor_boxes(first, probe.anchors, len(cfg.CLASS_NAMES),
                                                   probe.box_coder, cfg.MODEL.DENSE_HEAD)
        else:  # the CenterHead's top 512 a head, -inf where not valid
            boxes, scores, _, valid = decode_center_proposals(first, cfg.MODEL.DENSE_HEAD,
                                                              probe.meta)
            scores = torch.where(valid, scores, torch.full_like(scores, -math.inf))
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
    """What the two-stage eval step hands K4: the RCNN boxes of the RoIs (or
    the boxes a head decodes itself, MPPNet's) scored and filtered, in score
    order, as (over, valid)."""
    from com_tpu_torch.models.roi_heads.roi_targets import decode_rcnn_boxes
    from com_tpu_torch.ops import nms
    from com_tpu_torch.train.step import model_input_keys

    post = cfg.MODEL.POST_PROCESSING
    with torch.no_grad():
        out = net({k: torch.as_tensor(batch[k], device=dev) for k in model_input_keys(cfg.MODEL)})
        if "batch_box_preds" in out:
            boxes = out["batch_box_preds"][..., :7]
            scores = torch.sigmoid(out["batch_cls_preds"].max(dim=-1).values)
        else:
            boxes = decode_rcnn_boxes(out["rois"][..., :7], out["rcnn_reg"])
            scores = torch.sigmoid(out["rcnn_cls"])
        roi_valid = out.get("roi_valid", torch.ones_like(scores, dtype=torch.bool))
        valid = (scores > float(post.get("SCORE_THRESH", 0.1))) & roi_valid
        _, sb, sv = nms._sorted(boxes, scores, valid)
        thresh = float(post.get("NMS_CONFIG", {}).get("NMS_THRESH", 0.7))
        over = (nms._self_iou(sb) > thresh).contiguous()
    return over, sv.contiguous()


def two_stage_training(dev, label, cfg, meta, batches, expect, terms, smi,
                       spread=spread_anchor_scores, steps=2):
    """``train_model`` 1 mini-epoch of ``steps`` steps over ``batches``, seeded
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
        dev, label, cfg, meta, SyntheticLoader(batches, steps), 1, steps, expect,
        counts_confidences=False, smi=smi, prepare=prepare, terms=terms)
    fg_counts = [int(x) for x in fg]
    ok = len(fg_counts) == steps and min(fg_counts) > 0
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
    PointPillars, K4 at NMS_PRE_MAXSIZE 4,096, scores spread) at batch
    H_ANCHOR_BATCH and held to its eager step on one batch."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step
    from com_tpu_torch.utils.serving import (export_eval_step, load_artifact, make_manifest,
                                             write_artifact)

    cfg, meta = load_kitti(grid)
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True  # the scenes come presorted
    names = list(cfg.CLASS_NAMES)
    net = spread_anchor_scores(build_network(cfg.MODEL, meta, device=dev, seed=0))
    spec = {"points": ((H_ANCHOR_BATCH, E_POINTS, E_FEATS), torch.float32),
            "points_mask": ((H_ANCHOR_BATCH, E_POINTS), torch.bool)}
    stem = H_DIR / "kitti_pointpillar"
    t0 = time.perf_counter()
    program = export_eval_step(net, cfg.MODEL, names, meta, spec, device=dev)
    write_artifact(stem, program, make_manifest(cfg, meta, spec, [dev.type]))
    export_s = time.perf_counter() - t0
    run, _ = load_artifact(stem, device=dev)
    print(f"path H anchor export (KITTI PointPillars, batch {H_ANCHOR_BATCH}, grid "
          f"{list(meta.grid_size)}): {export_s:.2f} s, artifact "
          f"{stem.with_suffix('.pt2').stat().st_size / 1e6:.2f} MB ({smi})")
    batch = kitti_like_batch(np.random.RandomState(21), H_ANCHOR_BATCH, meta.point_cloud_range,
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
    are for rehearsals.  Returns the launch counts of I.1's one-process f32
    steps (the flagship's f32 K2, dgrad and K2w rows report them)."""
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
    return ref["f32"]["counts"]


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
    +4, its box weights x0.02 (each regression conv's, with
    SEPARATE_REG_CONFIG)."""
    with torch.no_grad():
        for head in net.dense_head.rpn_heads:
            head.conv_cls.bias.add_(4.0)
            for conv in (head.conv_box.values() if isinstance(head.conv_box, torch.nn.ModuleDict)
                         else (head.conv_box,)):
                conv.weight.mul_(0.02)
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
            for i in range(4):
                dataset[i]
            one = 4 / (time.perf_counter() - t0)
            t0 = time.perf_counter()
            batches = [b for _, b in zip(range(2), loader)]
            threaded = 8 / (time.perf_counter() - t0)
        ms = {k: round(1e3 * float(np.mean(v)), 3) for k, v in times.items() if v}
        print(f"path L.3 host loader {label}: {one:.2f} scenes/s on one thread (4 scenes), "
              f"{threaded:.2f} scenes/s through {L_WORKERS} loader threads (8 scenes, batch 4; "
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


def parta2_small_case(which="parta2", seed=0):
    """``kitti_models/PartA2.yaml`` or ``PartA2_free.yaml`` narrowed as the
    CPU tests narrow them (``tests/torch_port_parta2_setup.py`` ``small_cfg``:
    UNetV2 CHANNELS [8, 16, 16, 32], a one-layer BEV backbone, heads [16],
    PartA2FCHead at POOL_SIZE 4 with FCs [32]; written out here, as nothing
    on the card imports the JAX package's tests), f32, over path J's 64 x 64
    x 40 grid: 2 scenes of 16,384 points over the range (95 % valid), 8,192
    voxel slots, 16 object slots of KITTI-like boxes.  Returns (cfg, meta,
    batch)."""
    from com_tpu_torch.models.detectors import DatasetMeta

    cfg, _, proc = load_voxel(PARTA2_CONFIG if which == "parta2" else PARTA2_FREE_CONFIG)
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    if "BACKBONE_2D" in m:
        m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], LAYER_STRIDES=[1, 2], NUM_FILTERS=[32, 64],
                             UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[32, 32])
    m.BACKBONE_3D.update(CHANNELS=[8, 16, 16, 32], VOXEL_CAPS=[2048, 1024, 512, 256])
    ph, r = m.POINT_HEAD, m.ROI_HEAD
    ph.CLS_FC, ph.PART_FC = [16], [16]
    if "REG_FC" in ph:
        ph.REG_FC = [16]
    r.DP_RATIO = 0.0
    if which == "parta2":
        r.ROI_AWARE_POOL.update(POOL_SIZE=4, NUM_FEATURES=16, MAX_POINTS_PER_ROI=64)
        r.SHARED_FC, r.CLS_FC, r.REG_FC = [32], [32], [32]
        posts = (("TRAIN", 64), ("TEST", 32))
    else:
        r.ROI_POINT_POOL.NUM_SAMPLED_POINTS = 64
        r.XYZ_UP_LAYER, r.CLS_FC, r.REG_FC = [16, 16], [16], [16]
        r.SA_CONFIG.update(NPOINTS=[32, -1], RADIUS=[0.8, 100], NSAMPLE=[8, 8],
                           MLPS=[[16, 16], [16, 32]])
        posts = (("TRAIN", 64), ("TEST", 16))
    for mode, post in posts:
        r.NMS_CONFIG[mode].update(NMS_PRE_MAXSIZE=256, NMS_POST_MAXSIZE=post)
    r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    pr = (-16.0, -16.0, -2.0, 16.0, 16.0, 2.0)
    meta = DatasetMeta(cfg.CLASS_NAMES, pr, (0.5, 0.5, 0.1), (64, 64, 40), E_FEATS)
    proc.MAX_NUMBER_OF_VOXELS = {"train": 8192, "test": 8192}
    rng = np.random.RandomState(seed)
    batch = kitti_like_batch(rng, 2, pr, (0.5, 0.5, 4.0), n=4096, real_points=3000, m=16, real=6)
    # points over the whole range at the boxes' heights, dense enough that a
    # RoI sampled in training holds some (KITTI's wedge, or 2,048 voxels,
    # leave most of them empty: constant rows in the RoI head's norms)
    batch["points"] = np.concatenate([rng.uniform(-15, 15, (2, 16384, 2)),
                                      rng.uniform(-1.7, 0.3, (2, 16384, 1)),
                                      rng.rand(2, 16384, 1)], -1).astype(np.float32)
    batch["points_mask"] = rng.rand(2, 16384) < 0.95
    return cfg, meta, voxelize_batch(batch, meta, proc, "test")


def _mark_parta2_steps(net, mark):
    """Marks inside PartA2's stages, for ``two_stage_marks``: the UNet's
    decoder ("unet.decoder"); with PartA2FCHead its two RoI-aware pools
    ("roi.pool_part", "roi.pool_rpn") and the 3D convs over the pooled grids
    ("roi.conv3d"; the head's own mark, "roi_head", is the part features'
    gate).  Returns the function that removes them."""
    from com_tpu_torch.models.roi_heads import parta2_head

    hooks = [net.backbone_3d.conv_up_t4.register_forward_pre_hook(
        lambda *_: mark("unet.decoder"))]
    head = net.roi_head
    orig_pool = parta2_head.roiaware_pool3d
    if hasattr(head, "conv_part"):
        hooks.append(head.conv_part[0].register_forward_pre_hook(lambda *_: mark("roi.conv3d")))

        def pool(*args, **kw):
            mark("roi.pool_part" if args[6] == "avg" else "roi.pool_rpn")
            return orig_pool(*args, **kw)

        parta2_head.roiaware_pool3d = pool

    def undo():
        parta2_head.roiaware_pool3d = orig_pool
        for h in hooks:
            h.remove()

    return undo


def check_small_parta2_reference(dev):
    """O.1: ``parta2_small_case`` on the card against the CPU, the same
    seeded weights: PartA2's eval step (norm biases +3: at the seeded
    init the UNet's 13 convs leave its dense tensor at ~1e-5, so every
    anchor scores alike and the proposals' top-k ranks ties by rounding;
    anchor scores spread) and one train
    step (anchor scores spread, so that the sampled RoIs are box-sized and
    hold points; loss, gradients, batch statistics; no COM groups) within the
    tolerances or twice either device's own difference with the scenes
    swapped (its RoI head's norms over 32 RoIs, as PointRCNN's); PartA2-free's
    eval step (point scores spread)."""
    cfg, meta, batch = parta2_small_case()
    label = "path O small reference (PartA2 narrowed, f32, 64x64x40"
    compare_eval_step(dev, cfg, meta, batch, f"{label}, eval step, card vs CPU)",
                      prepare=lambda net: spread_anchor_scores(shift_norm_biases(net)))
    compare_train_step(dev, cfg, meta, batch, f"{label}, train step, card vs CPU)",
                       counts_confidences=False, own_noise=True, prepare=spread_anchor_scores)
    cfg, meta, batch = parta2_small_case("free")
    compare_eval_step(dev, cfg, meta, batch, "path O small reference (PartA2-free narrowed, f32, "
                      "64x64x40, eval step, card vs CPU)", prepare=spread_point_scores)


def o3_kitti(dev, smi, tree, extra_set=()):
    """O.3: ``PartA2.yaml`` with its own DATA_CONFIG over the tree: 1 epoch
    of ``train_model`` through the port's ``KittiDataset`` (batch 4); then
    the train CLI (1 epoch, the anchor head spread at its start) and the
    test CLI on its checkpoint (val split, KITTI AP, ``--infer_time``), as
    ``com_tpu``'s CLIs run PartA2."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.tools import test, train
    from com_tpu_torch.tools.train import dataset_meta

    tcfg = l_cfg(PARTA2_CONFIG, tree, extra_set)
    names = list(tcfg.CLASS_NAMES)
    dataset, loader = build_dataloader(tcfg.DATA_CONFIG, names, O_BATCH, training=True,
                                       workers=L_WORKERS, seed=L_SEED)
    run_training(dev, "O.3 (PartA2.yaml, train_model over KittiDataset)", tcfg,
                 dataset_meta(tcfg, dataset), loader, 1, len(loader), EXPECT_O_TRAIN,
                 counts_confidences=False, smi=smi, prepare=spread_anchor_scores, terms=O_TERMS)
    del loader, dataset
    torch.cuda.empty_cache()
    base = ["--cfg_file", str(REPO / PARTA2_CONFIG), "--output_dir", str(O_DIR / "out"),
            "--workers", str(L_WORKERS), "--device", str(dev)]
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tree), *extra_set]
    reset_counters()
    t0 = time.perf_counter()
    # the seeded anchor head spread before the first step, as everywhere on
    # this path: its unshrunk box codes decode to boxes of e^10 m
    first = train.main(base + ["--epochs", "1", "--seed", str(L_SEED)] + data,
                       on_start=lambda info: spread_anchor_scores(info["state"].net))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = first["iterations"]
    check_launches("O.3 train step (CLI)", read_counters(), EXPECT_O_TRAIN, steps)
    ok = steps == O_TRAIN // O_BATCH and all(bool(torch.isfinite(p).all())
                                            for p in first["state"].net.parameters())
    print(f"path O.3 train CLI (PartA2.yaml, batch 4, the tree's {O_TRAIN} train frames): "
          f"{steps} steps, {wall:.2f} s wall (dataset, model, loader and checkpoint included), "
          f"parameters finite ({smi}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path O.3: the train CLI over the KITTI tree failed its checks")
    ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
    del first
    torch.cuda.empty_cache()
    reset_counters()
    (res,) = test.main(base + ["--ckpt", str(ckpt), "--infer_time"] + data)
    torch.cuda.synchronize()
    annos = res["det_annos"]
    check_launches("O.3 eval forward (test CLI)", read_counters(), EXPECT_O_SERVING,
                   res["infer_batches"] + 1 + -(-len(annos) // O_BATCH))
    finite = [int(np.isfinite(a["boxes_lidar"]).all(1).sum()) for a in annos]
    ok = (len(annos) == O_VAL and finite == [len(a["score"]) for a in annos]
          and all((np.diff(a["score"]) <= 0).all() for a in annos))
    print(f"path O.3 test CLI: {len(annos)} val frames, detections a frame "
          f"{[len(a['score']) for a in annos]} (finite boxes {finite}, scores in descending "
          f"order), {res['sec_per_frame']:.4f} s a frame, "
          f"--infer_time {res['infer_ms_per_frame']:.3f} ms a frame ({smi}) "
          f"{'ok' if ok else 'FAIL'}")
    print("  KITTI AP (R40) of the checkpoint:\n    " + res["result_str"].replace("\n", "\n    "))
    if not ok:
        raise AssertionError("path O.3: the test CLI over the KITTI tree failed its checks")


def o4_free(dev, smi, rng, pc_range=None, points=E_POINTS, real_points=E_REAL_POINTS):
    """O.4: ``PartA2_free.yaml`` at full width, batch 2: one serving batch
    (K4 in the proposal NMS over the points' boxes and in the final one)
    and one train step with GT on its own proposals (K4 once)."""
    cfg, meta, proc = load_voxel(PARTA2_FREE_CONFIG, pc_range)
    serve_b, train_b = (kitti_voxel_batches(rng, meta, proc, mode, 1, O_FREE_BATCH, points,
                                            real_points) for mode in ("test", "train"))
    net, step, _ = check_two_stage_serving(dev, "O.4 (PartA2-free, KITTI)", cfg, meta, serve_b,
                                           EXPECT_N_SERVING, smi, spread=spread_point_scores)
    del net, step
    torch.cuda.empty_cache()
    run_training(dev, "O.4 (PartA2-free, one step)", cfg, meta, SyntheticLoader(train_b, 1), 1,
                 1, EXPECT_N_TRAIN, counts_confidences=False, smi=smi,
                 prepare=lambda net: follow_proposals(spread_point_scores(net)),
                 terms=O_FREE_TERMS)


def path_o(dev, smi, entries, calls, pc_range=None, points=E_POINTS, real_points=E_REAL_POINTS,
           tree_points=L_POINTS, sets=None):
    """Path O, PartA2 (``configs/kitti_models/PartA2.yaml``: MeanVFE, UNetV2
    over the 1408 x 1600 x 40 grid, HeightCompression, the BEV backbone on
    K2, the anchor head, the part head, 1,024 -> 100 proposals by K4 in
    serving and 4,096 -> 512 -> 128 sampled in training, PartA2FCHead's
    12^3 RoI-aware pools) at full width, batch 4 of ~20,000 KITTI-like
    points in 16,000 / 40,000 voxel slots, anchor scores spread.  O.1 the
    small f32 references; three serving batches (latency, peak memory, K2
    11 and K4 2 a forward), the eval step's stages, K4 on the (4, 1024)
    serving and (4, 4096) train proposal candidates and the final NMS's (4,
    100); K2, dgrad and K2w at its BEV shapes (path G's); O.2 2 train steps
    at DP_RATIO 0.3 with GT on the model's own proposals, their terms and
    stages; O.3 ``train_model`` over a KITTI tree through ``KittiDataset``
    and the train and test CLIs (``o3_kitti``); O.4 PartA2-free
    (``o4_free``).  Returns the launch counts of a serving forward and of
    the 2 steps.  ``pc_range``, the point counts and ``sets`` ({"O.3":
    ``--set`` pairs}) are for rehearsals."""
    import shutil

    from com_tpu_torch.tools.kitti_tree import write_kitti_tree

    sets = sets or {}
    start = time.perf_counter()
    check_small_parta2_reference(dev)
    cfg, meta, proc = load_voxel(PARTA2_CONFIG, pc_range)
    rng = np.random.RandomState(57)
    batches = kitti_voxel_batches(rng, meta, proc, "test", 3, O_BATCH, points, real_points)
    net, step, serve_counts = check_two_stage_serving(dev, "O (PartA2, KITTI)", cfg, meta,
                                                      batches, EXPECT_O_SERVING, smi)
    two_stage_breakdown(net, lambda: step(batches[0]), "path O eval step", smi=smi)
    train_batches = kitti_voxel_batches(rng, meta, proc, "train", 2, O_BATCH, points,
                                        real_points)
    for what, kernel, (over, sv) in (
            ("serving proposals", "O:nms",
             proposal_candidates(net, cfg, batches[0], dev, train=False)),
            ("train proposals", "O:nms_train",
             proposal_candidates(net, cfg, train_batches[0], dev, train=True)),
            ("final NMS", "O:nms", final_candidates(net, cfg, batches[0], dev))):
        check_k4_cases(dev, entries, calls, over, sv, smi, f", path O {what}", kernel,
                       iters=20 if sv.shape[1] > 1024 else 50)
    del net, step
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=G_CONV, dtypes=(torch.bfloat16,), path="O:")
    check_conv3x3_backward(dev, entries, shapes=G_CONV, wgrad_dtypes=(torch.bfloat16,),
                           path="O:")
    torch.cuda.empty_cache()
    train_counts = two_stage_training(dev, "O (PartA2, KITTI)", cfg, meta, train_batches,
                                      EXPECT_O_TRAIN, O_TERMS, smi)
    torch.cuda.empty_cache()
    shutil.rmtree(O_DIR, ignore_errors=True)
    O_DIR.mkdir(parents=True)
    try:
        tree = O_DIR / "kitti"
        write_kitti_tree(tree, seed=L_SEED, num_train=O_TRAIN, num_val=O_VAL,
                         num_points=tree_points)
        o3_kitti(dev, smi, tree, sets.get("O.3", ()))
    finally:
        shutil.rmtree(O_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    o4_free(dev, smi, rng, pc_range, points, real_points)
    torch.cuda.empty_cache()
    print(f"path O: {time.perf_counter() - start:.1f} s wall in all")
    return serve_counts, train_counts


P_VOXEL_RCNN_CONFIG = "configs/waymo_models/voxel_rcnn_with_centerhead_dyn_voxel.yaml"
P_PV_RCNN_CONFIG = "configs/waymo_models/pv_rcnn_with_centerhead_rpn.yaml"
P_MPPNET_CONFIG = "configs/waymo_models/mppnet_e2e_memorybank_inference.yaml"
P_CONFIGS = {"voxel_rcnn": P_VOXEL_RCNN_CONFIG, "pv_rcnn": P_PV_RCNN_CONFIG,
             "mppnet": P_MPPNET_CONFIG}
P_BATCH, P_PV_BATCH, P_MPP_BATCH = 4, 2, 2  # the YAMLs' BATCH_SIZE_PER_GPU
P_FRAMES = 4  # MPPNetE2E's num_frames: P.4's sequence
P_CONV = ((4, 188, 188, 256, 128), (4, 188, 188, 128, 128), (4, 94, 94, 256, 256))
EXPECT_P_SERVING = {"conv3x3": 11, "nms": 2}  # the proposal NMS and the final one
EXPECT_P_TRAIN = {"conv3x3": 11, "conv3x3_dgrad": 11, "conv3x3_wgrad": 11, "nms": 1,
                  "stamp_gauss": 1}
EXPECT_P_PV_SERVING = EXPECT_P_MPP_SERVING = {"conv3x3": 11, "nms": 1}  # top-k RoIs, final NMS
EXPECT_P_PV_TRAIN = {"conv3x3": 11, "conv3x3_dgrad": 11, "conv3x3_wgrad": 11, "stamp_gauss": 1}
P_TERMS = ("hm_loss_head_0", "loc_loss_head_0", "rcnn_loss_cls", "rcnn_loss_reg",
           "rcnn_loss_corner")
P_PV_TERMS = ("hm_loss_head_0", "loc_loss_head_0", "rcnn_loss_cls", "rcnn_loss_reg",
              "point_loss_cls")
P_SMALL_RANGE = (-3.2, -3.2, -2.0, 3.2, 3.2, 4.0)


def spread_center_scores(net):
    """A CenterHead's heatmap bias +1.5 (scores off the proposal decode's 0.1
    threshold) and its size kernel x0.02 (boxes of about a metre)."""
    from com_tpu_torch.models.dense_heads.center_head import SeparateHead

    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, SeparateHead):
                mod.hm[-1].bias.add_(1.5)
                mod.dim[-1].weight.mul_(0.02)
    return net


def centerhead_small_case(which="voxel_rcnn", seed=0, frames=1):
    """``P_CONFIGS[which]`` narrowed as the CPU tests narrow it
    (``tests/torch_port_centerhead_setup.py`` ``small_cfg``, written out
    here: nothing on the card imports the JAX package's tests), f32, over a
    64 x 64 x 40 grid of 0.1 x 0.1 x 0.15 m: 2 scenes of 3,000 points over
    the range (95 % valid; MPPNetE2E's with a zero timestamp column),
    4,096 voxel slots, 16 object slots with 4 boxes.  Returns (cfg, meta,
    batch), or with ``frames`` > 1 (cfg, meta, [batch a frame]): the
    scenes' first quarter of points moved 5 cm a frame."""
    from com_tpu_torch.models.detectors import DatasetMeta

    cfg, _, proc = load_voxel(P_CONFIGS[which])
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    m.BACKBONE_3D.update(CHANNELS=[8, 16, 16, 32], OUT_CHANNELS=32,
                         VOXEL_CAPS=[4096, 2048, 1024, 512])
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], LAYER_STRIDES=[1, 2], NUM_FILTERS=[32, 64],
                         UPSAMPLE_STRIDES=[1, 2], NUM_UPSAMPLE_FILTERS=[32, 32])
    m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
    m.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 16
    r = m.ROI_HEAD
    if which == "voxel_rcnn":
        m.VFE.MAX_VOXELS = 4096
        r.DP_RATIO = 0.0
        r.SHARED_FC, r.CLS_FC, r.REG_FC = [32, 32], [32, 32], [32, 32]
        r.ROI_GRID_POOL.GRID_SIZE = 3
        for src, radius in (("x_conv2", 0.2), ("x_conv3", 0.4), ("x_conv4", 0.8)):
            r.ROI_GRID_POOL.POOL_LAYERS[src].update(MLPS=[[16, 16]], QUERY_RANGES=[[2, 2, 2]],
                                                    POOL_RADIUS=[radius], NSAMPLE=[8])
        for mode, post in (("TRAIN", 64), ("TEST", 32)):
            r.NMS_CONFIG[mode].NMS_POST_MAXSIZE = post
        r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    elif which == "pv_rcnn":
        m.PFE.update(NUM_KEYPOINTS=256, NSAMPLE=8, NUM_OUTPUT_FEATURES=32)
        m.PFE.SA_LAYER = {"raw_points": {"RADIUS": [0.4], "MLPS": [[8, 8]]},
                          "x_conv3": {"RADIUS": [0.8], "MLPS": [[16, 16]]},
                          "x_conv4": {"RADIUS": [1.6], "MLPS": [[16, 16]]}}
        m.POINT_HEAD.CLS_FC = [16]
        r.NMS_CONFIG.TEST_POST = 32
        r.ROI_GRID_POOL.update(GRID_SIZE=3, RADIUS=0.4, NSAMPLE=8, MLPS=[[16, 16]])
        r.SHARED_FC = [32, 32]
        r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    else:
        r.TRANS_INPUT = 32
        r.ROI_GRID_POOL.update(GRID_SIZE=2, MLPS=[[16, 16], [16, 16]], POOL_RADIUS=[0.4, 0.8],
                               NSAMPLE=[8, 8])
        r.Transformer.update(num_lidar_points=32, num_proxy_points=8, dim_feedforward=64,
                             hidden_dim=32)
        r.Transformer.use_mlp_mixer.hidden_dim = 8
        r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    feats = 6 if which == "mppnet" else 5
    meta = DatasetMeta(cfg.CLASS_NAMES, P_SMALL_RANGE, (0.1, 0.1, 0.15), (64, 64, 40), feats)
    proc.MAX_NUMBER_OF_VOXELS = {"train": 4096, "test": 4096}
    rng = np.random.RandomState(seed)
    lo, hi = np.array(P_SMALL_RANGE[:3]) + 0.05, np.array(P_SMALL_RANGE[3:]) - 0.05
    pts = np.concatenate([rng.uniform(lo, hi, (2, 3000, 3)), rng.rand(2, 3000, 2),
                          np.zeros((2, 3000, feats - 5))], -1).astype(np.float32)
    gt = np.zeros((2, 16, 8), np.float32)
    gt[:, :4, 0:2] = rng.uniform(-2.5, 2.5, (2, 4, 2))
    gt[:, :4, 2] = rng.uniform(-0.5, 1.0, (2, 4))
    gt[:, :4, 3:6] = rng.uniform(0.8, 2.0, (2, 4, 3))
    gt[:, :4, 6] = rng.uniform(-np.pi, np.pi, (2, 4))
    gt[:, :4, 7] = rng.randint(1, 4, (2, 4))
    real = gt[..., 7] > 0
    base = {"points_mask": rng.rand(2, 3000) < 0.95, "gt_boxes": gt,
            "num_points_in_gt": real.astype(np.float32) * 10,
            "true_object": real.astype(np.float32)}
    out = []
    for f in range(frames):
        moved = pts.copy()
        moved[:, :750, 0:2] += np.float32(0.05 * f)
        batch = dict(base, points=moved)
        out.append(batch if which == "voxel_rcnn" else voxelize_batch(batch, meta, proc, "test"))
    return cfg, meta, (out[0] if frames == 1 else out)


def compare_stream(dev, cfg, meta, frames, label, prepare=None):
    """MPPNetE2E's ``make_stream_step`` over ``frames`` on the card against
    the CPU, the same seeded weights: each frame's detections as
    ``check_detections`` holds them."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_stream_step

    outs = []
    for d in (dev, "cpu"):
        net = build_network(cfg.MODEL, meta, device=d, seed=7)
        if prepare is not None:
            prepare(net)
        step = make_stream_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=d)
        bank, dets = None, []
        for f, frame in enumerate(frames):
            det, bank = step(frame, bank, f == 0)
            dets.append([t.cpu().numpy() for t in det])
        outs.append(dets)
    for f in range(len(frames)):
        check_detections(f"{label}, frame {f}", outs[0][f], outs[1][f])


def check_small_centerhead_reference(dev):
    """P.1: ``centerhead_small_case`` on the card against the CPU, the same
    seeded weights with every norm's bias +3 (as paths N and O) and the
    heatmap spread (``spread_center_scores``): Voxel-RCNN's eval step and
    one train step (GT on its own proposals, a little off them: the
    CenterHead's L1 box loss; within the tolerances or twice either
    device's own difference with the scenes swapped, its RoI head's norms
    over 32 RoIs), PV-RCNN's eval step (its RCNN class bias +3.5, so that
    boxes pass the score threshold), MPPNetE2E's single-frame eval step and
    a 3-frame stream."""
    def prep(net):
        return spread_center_scores(shift_norm_biases(net))

    def prep_pv(net):  # its RCNN logits sit at ~-3.5 after the shift: lift them past 0.1
        with torch.no_grad():
            prep(net).roi_head.cls_layers[-1].bias.add_(3.5)
        return net

    for which, name in (("voxel_rcnn", "Voxel-RCNN"), ("pv_rcnn", "PV-RCNN"),
                        ("mppnet", "MPPNetE2E")):
        cfg, meta, batch = centerhead_small_case(which)
        label = f"path P small reference ({name} CenterHead RPN narrowed, f32, 64x64x40"
        compare_eval_step(dev, cfg, meta, batch, f"{label}, eval step, card vs CPU)",
                          prepare=prep_pv if which == "pv_rcnn" else prep)
        if which == "voxel_rcnn":
            compare_train_step(dev, cfg, meta, batch, f"{label}, train step, card vs CPU)",
                               counts_confidences=False, own_noise=True,
                               prepare=lambda net: follow_proposals(
                                   spread_center_scores(net), per_scene=2, off=True))
        if which == "mppnet":
            cfg, meta, frames = centerhead_small_case(which, frames=3)
            compare_stream(dev, cfg, meta, frames, f"{label}, 3-frame stream, card vs CPU)",
                           prepare=prep)


def report_voxel_cap(dev, net, batch, smi):
    """DynamicMeanVFE's voxels a scene before its MAX_VOXELS cap and after:
    the same VFE with a slot a point, and the model's own."""
    from com_tpu_torch.models.vfe import DynamicMeanVFE

    vfe = net.vfe
    uncapped = DynamicMeanVFE({"MAX_VOXELS": batch["points"].shape[1]}, vfe.num_point_features,
                              vfe.voxel_size, vfe.point_cloud_range, vfe.grid_size)
    inputs = {k: torch.as_tensor(batch[k], device=dev) for k in ("points", "points_mask")}
    with torch.no_grad():
        before = (uncapped(dict(inputs))["voxel_coords"][..., 0] >= 0).sum(1).tolist()
        coords = vfe(dict(inputs))["voxel_coords"]
    after = (coords[..., 0] >= 0).sum(1).tolist()
    top = [int(c[c[:, 0] >= 0, 0].max()) for c in coords]
    z0, vz = vfe.point_cloud_range[2], vfe.voxel_size[2]
    print(f"path P.2 DynamicMeanVFE: voxels a scene before the {vfe.max_voxels:,} cap {before}, "
          f"after {after} (dropped {[b - a for b, a in zip(before, after)]}: the highest z; "
          f"the top z plane kept {top} of {vfe.grid_size[2] - 1}, nothing kept above z "
          f"{[round(z0 + (t + 1) * vz, 2) for t in top]} m) ({smi})")


def p2_voxel_rcnn(dev, smi, entries, calls, pc_range=None, points=POINTS):
    """P.2: ``voxel_rcnn_with_centerhead_dyn_voxel.yaml`` at full width
    (DynamicMeanVFE into 80,000 slots, the 1498 x 1498 x 40 grid,
    VoxelBackBone8x, the CenterHead's top 512 a scene through the proposal
    NMS (K4 at (4, 512)) to 100 RoIs in serving, 512 -> 128 sampled in
    training), batch 4 of Waymo-like scenes of 163,840 points with ~100
    objects in 500 slots, seeded weights: the voxels the cap drops; three
    serving batches and the eval step's stages; K4 on the serving and
    train proposals and the final NMS's (4, 100); K2, dgrad and K2w at its
    BEV shapes, K3 at (4, 3, 188, 188); 2 train steps with GT on its own
    proposals.  Returns the launch counts of a serving forward and of the
    steps."""
    cfg, meta, _ = load_voxel(P_VOXEL_RCNN_CONFIG, pc_range)
    rng = np.random.RandomState(61)

    def batches(count):
        return [waymo_like_batch(rng, P_BATCH, points, meta.point_cloud_range, (0.32, 0.32, 6.0),
                                 len(meta.class_names)) for _ in range(count)]

    serve_b, train_b = batches(3), batches(2)
    label = "P.2 (Voxel-RCNN, CenterHead RPN, DynamicMeanVFE, Waymo)"
    net, step, serve_counts = check_two_stage_serving(dev, label, cfg, meta, serve_b,
                                                      EXPECT_P_SERVING, smi, spread=lambda n: n)
    report_voxel_cap(dev, net, serve_b[0], smi)
    two_stage_breakdown(net, lambda: step(serve_b[0]), "path P.2 eval step", smi=smi)
    for what, kernel, (over, sv) in (
            ("serving proposals", "P:nms",
             proposal_candidates(net, cfg, serve_b[0], dev, train=False)),
            ("train proposals", "P:nms_train",
             proposal_candidates(net, cfg, train_b[0], dev, train=True)),
            ("final NMS", "P:nms", final_candidates(net, cfg, serve_b[0], dev))):
        check_k4_cases(dev, entries, calls, over, sv, smi, f", path P.2 {what}", kernel,
                       iters=50)
    del net, step
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=P_CONV, dtypes=(torch.bfloat16,), path="P:")
    check_conv3x3_backward(dev, entries, shapes=P_CONV, wgrad_dtypes=(torch.bfloat16,),
                           path="P:")
    check_stamp(dev, entries, calls, hw=(188, 188), path="P:", b=P_BATCH, modes=("gauss",))
    torch.cuda.empty_cache()
    train_counts = two_stage_training(dev, label, cfg, meta, train_b, EXPECT_P_TRAIN, P_TERMS,
                                      smi, spread=lambda n: n)
    return serve_counts, train_counts


def p2_clis(dev, smi, pc_range=None, bg_points=120000):
    """P.2's YAML through the port's train and test CLIs
    (``voxel_yaml_clis``, batch 4), as ``com_tpu``'s CLIs run it (checked
    over such a dataset at a 12.8 m range).  Launches: P.2's a train
    step."""
    cfg, _, _ = load_voxel(P_VOXEL_RCNN_CONFIG, pc_range)
    voxel_yaml_clis(dev, smi, P_VOXEL_RCNN_CONFIG, "P.2", EXPECT_P_TRAIN, P_BATCH,
                    int(cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_POST_MAXSIZE), pc_range,
                    bg_points)


def p3_pv_rcnn(dev, smi, entries, calls, pc_range=None, points=POINTS):
    """P.3: ``pv_rcnn_with_centerhead_rpn.yaml`` at full width (MeanVFE over
    the host voxelizer's 90,000 / 80,000 slots, VoxelSetAbstraction's 4,096
    FPS keypoints over the raw points, the CenterHead's top 512 a scene,
    the top 100 RoIs in serving, PVRCNNHead), batch 2: two serving batches
    and the eval step's stages (FPS, each source's query and block), K4 on
    the final NMS's (2, 100); 1 train step.  Returns the launch counts of
    a serving forward and of the step."""
    cfg, meta, proc = load_voxel(P_PV_RCNN_CONFIG, pc_range)
    rng = np.random.RandomState(62)

    def batches(mode, count):
        return [voxelize_batch(waymo_like_batch(rng, P_PV_BATCH, points, meta.point_cloud_range,
                                                (0.32, 0.32, 6.0), len(meta.class_names)),
                               meta, proc, mode) for _ in range(count)]

    serve_b = batches("test", 2)
    label = "P.3 (PV-RCNN, CenterHead RPN, Waymo)"
    net, step, serve_counts = check_two_stage_serving(dev, label, cfg, meta, serve_b,
                                                      EXPECT_P_PV_SERVING, smi,
                                                      spread=lambda n: n)
    two_stage_breakdown(net, lambda: step(serve_b[0]), "path P.3 eval step", smi=smi)
    over, sv = final_candidates(net, cfg, serve_b[0], dev)
    check_k4_cases(dev, entries, calls, over, sv, smi, ", path P.3 final NMS", "P:nms_pv",
                   iters=50)
    del net, step
    torch.cuda.empty_cache()
    train_counts = two_stage_training(dev, label, cfg, meta, batches("train", 1),
                                      EXPECT_P_PV_TRAIN, P_PV_TERMS, smi, spread=lambda n: n,
                                      steps=1)
    return serve_counts, train_counts


def p_sequence(rng, meta, proc, b, n, frames=P_FRAMES):
    """A synthetic sequence: Waymo-like scenes whose object blobs (the first
    quarter of the points) move 0.3 m in x and -0.2 m in y a frame, each
    frame a batch of its own (the timestamp column 0: each is the current
    frame when it is served), voxelized to the test slots."""
    base = waymo_like_points(rng, b, n, meta.point_cloud_range)
    out = []
    for f in range(frames):
        pts = base.copy()
        pts[:, :n // 4, 0:2] += np.array([0.3, -0.2], np.float32) * f
        pts[..., 0:2] = np.clip(pts[..., 0:2], meta.point_cloud_range[0],
                                meta.point_cloud_range[3] - 1e-3)
        pts = np.concatenate([pts, np.zeros((b, n, 1), np.float32)], -1)
        out.append(voxelize_batch({"points": pts, "points_mask": np.ones((b, n), bool)}, meta,
                                  proc, "test"))
    return out


def _mark_mppnet_steps(net, mark):
    """Marks of an MPPNetE2E forward for ``two_stage_breakdown``: the first
    stage's slots, the CenterHead's proposal decode ("proposal.decode"),
    then in the memory-bank head the trajectory linking ("roi.trajectory":
    a rotated 3D IoU a past frame), the point crop ("roi.crop"), the
    geometry MLP ("roi.geometry"), the proxy grid's ball queries and pool
    ("roi.grid_pool"), the motion features ("roi.motion"), the box sequence
    ("roi.seqbox"), the transformer ("roi.transformer"), the joint head
    ("roi.joint"), then the final NMS's steps ("final.*").  Returns the
    function that removes them."""
    from com_tpu_torch.models.mppnet import mppnet_e2e

    hooks = []
    for s in ("vfe", "backbone_3d", "map_to_bev", "backbone_2d", "dense_head"):
        hooks.append(getattr(net, s).register_forward_pre_hook(lambda *_, s=s: mark(s)))
        hooks.append(getattr(net, s).register_forward_hook(
            lambda *_, s=s: mark("proposal.decode" if s == "dense_head" else "gap")))
    hooks.append(net.roi_head.register_forward_pre_hook(lambda *_: mark("roi.trajectory")))
    undo_head = _mark_mppnet_head(net.roi_head, mppnet_e2e, mark)

    def undo():
        undo_head()
        for h in hooks:
            h.remove()

    return undo


def _mark_mppnet_head(head, module, mark):
    """The marks inside an MPPNet head (``_mark_mppnet_steps``' "roi.crop"
    through "roi.joint", then "final.decode" and the final NMS's steps),
    its crop looked up in ``module``.  Returns the function that removes
    them."""
    hooks = []
    for name, sub in (("roi.geometry", head.up_dimension_geometry),
                      ("roi.motion", head.up_dimension_motion), ("roi.seqbox", head.seqboxembed),
                      ("roi.transformer", head.transformer), ("roi.joint", head.jointembed)):
        hooks.append(sub.register_forward_pre_hook(lambda *_, n=name: mark(n)))
    hooks.append(head.register_forward_hook(lambda *_: mark("final.decode")))
    orig_crop, orig_pool = module.crop_trajectory_points, head.roi_grid_pool

    def crop(*args, **kw):
        mark("roi.crop")
        return orig_crop(*args, **kw)

    def pool(*args, **kw):
        mark("roi.grid_pool")
        return orig_pool(*args, **kw)

    module.crop_trajectory_points, head.roi_grid_pool = crop, pool
    nms_names = {"sort": "sort_gathers", "iou": "iou", "k4": "k4", "k4_end": "kept_slots",
                 "rest": "rest"}
    undo_nms = _mark_nms_steps(lambda n: mark(f"final.{nms_names[n]}"))

    def undo():
        undo_nms()
        module.crop_trajectory_points = orig_crop
        del head.roi_grid_pool
        for h in hooks:
            h.remove()

    return undo


def p4_mppnet(dev, smi, entries, calls, pc_range=None, points=POINTS):
    """P.4: ``mppnet_e2e_memorybank_inference.yaml`` at full width (MeanVFE
    over 400,000 voxel slots, VoxelResBackBone8x, a CenterHead with
    velocity, its top 96 boxes as RoIs, MPPNetHeadE2E: 128 points a RoI, a
    4^3 proxy grid at two radii, 3 encoder layers of 4 heads over 4 frames
    in 4 groups, TRANS_INPUT 256), batch 2 over a 4-frame synthetic
    sequence (``p_sequence``): frame 0 through ``make_eval_step`` (three
    timed runs, a zero bank), then the 4 frames through
    ``make_stream_step``, each step timed; the first stream step's
    detections as the eval step's; the RoIs a later step links to a banked
    proposal; the eval step's stages; K4 on the final NMS's (2, 96).
    Returns the launch counts of the stream's steps."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step, make_stream_step

    cfg, meta, proc = load_voxel(P_MPPNET_CONFIG, pc_range)
    names = list(cfg.CLASS_NAMES)
    frames = p_sequence(np.random.RandomState(63), meta, proc, P_MPP_BATCH, points)
    net = build_network(cfg.MODEL, meta, device=dev, seed=0)
    eval_step = make_eval_step(net, cfg.MODEL, names, meta, device=dev)
    stream_step = make_stream_step(net, cfg.MODEL, names, meta, device=dev)
    linked = []
    hook = net.roi_head.register_forward_hook(
        lambda m, args, out: linked.append(out["valid_length"][:, 1:].sum().item()))
    eval_step(frames[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    single, latencies = None, []
    for _ in range(3):
        t0 = time.perf_counter()
        single = [t.cpu().numpy() for t in eval_step(frames[0])]
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    check_launches("path P.4 eval forward", read_counters(), EXPECT_P_MPP_SERVING, 3)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"path P.4 (MPPNetE2E, Waymo) one frame through make_eval_step (batch {P_MPP_BATCH}, "
          f"{[int((f['voxel_num_points'] > 0).sum(1).min()) for f in frames]} voxels at least "
          f"a scene a frame): latency ms {[round(x, 2) for x in latencies]}, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({smi})")
    linked.clear()
    reset_counters()
    bank, stream, step_ms = None, [], []
    for f, frame in enumerate(frames):
        t0 = time.perf_counter()
        det, bank = stream_step(frame, bank, f == 0)
        stream.append([t.cpu().numpy() for t in det])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counters()
    hook.remove()
    diff = max(float(np.abs(a.astype(np.float64) - b).max()) for a, b in zip(stream[0], single))
    same_valid = np.array_equal(stream[0][3], single[3])
    ok = same_valid and diff <= 1e-4 and bool(bank.geo[:, 1:].abs().max() > 0)
    for i, (boxes, scores, labels, valid) in enumerate(stream):
        ok = ok and (boxes.shape[1] == int(cfg.MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE)
                     and bool(valid.any(1).all()) and np.isfinite(boxes[valid]).all()
                     and (scores[valid] > 0.1).all() and np.isin(labels[valid], [1, 2, 3]).all())
    print(f"path P.4 stream of {len(frames)} frames through make_stream_step: ms a step "
          f"{[round(x, 2) for x in step_ms]}; detections a step "
          f"{[d[3].sum(1).tolist() for d in stream]}; RoIs linked to a banked proposal in a past "
          f"frame, a step {[int(x) for x in linked]}; the first step against the eval step: "
          f"valid slots equal {same_valid}, max abs diff {diff:.3e} (<= 1e-4) ({smi}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path P.4: the stream's detections or its bank are wrong")
    check_launches("path P.4 stream step", counts, EXPECT_P_MPP_SERVING, len(frames))
    two_stage_breakdown(net, lambda: eval_step(frames[0]), "path P.4 eval step", smi=smi,
                        marks_fn=_mark_mppnet_steps)
    over, sv = final_candidates(net, cfg, frames[0], dev)
    check_k4_cases(dev, entries, calls, over, sv, smi, ", path P.4 final NMS", "P:nms_mpp",
                   iters=50)
    del net, eval_step, stream_step, bank
    torch.cuda.empty_cache()
    return counts


def path_p(dev, smi, entries, calls, pc_range=None, points=POINTS, bg_points=120000):
    """Path P, the CenterHead RPN (``decode_center_proposals``),
    DynamicMeanVFE and MPPNetE2E's memory-bank head: P.1 the small f32
    references, card against CPU (``check_small_centerhead_reference``);
    P.2 Voxel-RCNN with the CenterHead RPN (``p2_voxel_rcnn``); P.3 PV-RCNN
    with it (``p3_pv_rcnn``) and through the train and test CLIs
    (``p2_clis``); P.4 MPPNetE2E streaming (``p4_mppnet``).  Returns the
    launch counts {P.2 serving, P.2 steps, P.3 serving, P.3 step, P.4
    stream}.  ``pc_range``, ``points`` and ``bg_points`` are for
    rehearsals."""
    start = time.perf_counter()
    check_small_centerhead_reference(dev)
    torch.cuda.empty_cache()
    out = {}
    out["serve"], out["train"] = p2_voxel_rcnn(dev, smi, entries, calls, pc_range, points)
    torch.cuda.empty_cache()
    p2_clis(dev, smi, pc_range, bg_points)
    torch.cuda.empty_cache()
    out["pv_serve"], out["pv_train"] = p3_pv_rcnn(dev, smi, entries, calls, pc_range, points)
    torch.cuda.empty_cache()
    out["mpp"] = p4_mppnet(dev, smi, entries, calls, pc_range, points)
    torch.cuda.empty_cache()
    print(f"path P: {time.perf_counter() - start:.1f} s wall in all")
    return out


Q_DIR = REPO / "build" / "path_q"  # path Q's trees and CLI outputs, removed after the path
Q_NUS_CONFIG = "configs/nuscenes_models/cbgs_dyn_pp_centerpoint.yaml"
Q_MULTI_CONFIG = "configs/nuscenes_models/cbgs_pp_multihead.yaml"
Q_V0075_CONFIG = "configs/nuscenes_models/cbgs_voxel0075_res3d_centerpoint.yaml"
Q_V01_CONFIG = "configs/nuscenes_models/cbgs_voxel01_res3d_centerpoint.yaml"
Q_LYFT_CONFIG = "configs/lyft_models/cbgs_second_multihead.yaml"
Q_LYFT_NORES_CONFIG = "configs/lyft_models/cbgs_second-nores_multihead.yaml"
Q_PANDASET_CONFIG = "configs/dataset_configs/pandaset_dataset.yaml"
Q_SEED, Q_WORKERS, Q_BATCH = 22, 4, 4  # Q_BATCH: the YAMLs' BATCH_SIZE_PER_GPU
Q_NUS_TRAIN, Q_LYFT_TRAIN, Q_VAL = 2, 8, 8  # 10 CBGS items / 8 frames: 2 steps; 2 val batches
Q_SWEEP_POINTS = {"nuscenes": 34000, "lyft": 60000, "pandaset": 110000}
Q_CONV = ((4, 256, 256, 64), (4, 128, 128, 128), (4, 64, 64, 256))  # K2's at the 512 x 512 grid
EXPECT_Q_SERVING = {"seg_scan": 2, "conv3x3": 13, "nms": 6}  # a K4 a head group
EXPECT_Q_TRAIN = {"seg_scan": 2, "seg_scan_bwd": 1, "conv3x3": 13, "conv3x3_dgrad": 13,
                  "conv3x3_wgrad": 13, "stamp_gauss": 6}
# the BEV backbone's 13, the heads' shared conv and each group's middle conv
EXPECT_Q_MULTI_SERVING = {"seg_scan": 2, "conv3x3": 20, "nms": 1}
EXPECT_Q_MULTI_TRAIN = {"seg_scan": 2, "seg_scan_bwd": 1, "conv3x3": 20, "conv3x3_dgrad": 20,
                        "conv3x3_wgrad": 20}
EXPECT_Q_VOXEL_SERVING = {"conv3x3": 11, "nms": 6}
EXPECT_Q_VOXEL_TRAIN = {"conv3x3": 11, "conv3x3_dgrad": 11, "conv3x3_wgrad": 11,
                        "stamp_gauss": 6}
EXPECT_Q_LYFT_SERVING = {"conv3x3": 12, "nms": 1}  # SECOND's 11 and the heads' shared conv
EXPECT_Q_LYFT_TRAIN = {"conv3x3": 12, "conv3x3_dgrad": 12, "conv3x3_wgrad": 12}


def _short(t):
    """A tensor's dtype and shape as the entries name them: f32 (4,262144,8)."""
    dt = {torch.float32: "f32", torch.bfloat16: "bf16"}.get(t.dtype, str(t.dtype))
    return f"{dt} ({','.join(map(str, t.shape))})"


@contextlib.contextmanager
def captured(module, name):
    """Record each call's (args, kwargs) of ``module.name`` for the duration
    (the callers look the name up at call time); yields the list."""
    orig, calls = getattr(module, name), []

    def wrapper(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, orig)


def check_k1_call(dev, entries, vals, seg, op, label, kernel, smi):
    """K1 (``run_bcast``) on inputs a model gave it: the max bit-exact, the
    sum to f32 rounding of a differently ordered sum; timed."""
    from com_tpu_torch.ops import seg_scan

    got = seg_scan.run_bcast(vals, seg, op)
    want = seg_scan.run_bcast_plain(vals, seg, op)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    if op == "max":
        ok, tol = torch.equal(got, want), "bit-exact"
    else:
        scale = seg_scan.run_bcast_plain(vals.float().abs(), seg, "sum")
        ok, tol = bool((err <= 1e-5 * scale + 1e-6).all()), "|err| <= 1e-5 * run sum|x| + 1e-6"
    ms = cuda_ms(lambda: seg_scan.run_bcast(vals, seg, op), 50)
    dev_ms = device_ms(lambda: seg_scan.run_bcast(vals, seg, op), 50)
    plain_ms = cuda_ms(lambda: seg_scan.run_bcast_plain(vals, seg, op), 10)
    bms, by = bound_ms(nbytes(vals, seg, got), vals.numel(), torch.float32)
    name = f"{_short(vals)}, {label}"
    print(f"K1 run_bcast {op} {name}: max_abs_err={err.max().item():.3e} ({tol}); {ms:.4f} ms a "
          f"call as the host issues them, {dev_ms:.4f} ms queued on the card, bound {bms:.5f} ms"
          f"{f' ({smi})' if smi else ''} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K1 {op} at {label} disagrees with its plain version")
    entries.append(dict(name=f"seg_scan.run_bcast {op} {name}", route="cuda",
                        source="com_tpu_torch/csrc/seg_scan.cu",
                        replaces="com_tpu/ops/pallas/seg_scan.py:122",
                        max_abs_err=err.max().item(), ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None, kernel=kernel))


def check_k1_bwd_call(dev, entries, g, vals, out, seg, label, kernel, smi):
    """K1's fused max backward on the (g, vals, out, seg) a train step gave
    it, against ``run_bcast_max_bwd_plain``: f32 rounding of the split, and
    for bf16 one rounding more; timed."""
    from com_tpu_torch.ops import seg_scan

    got = seg_scan.run_bcast_max_bwd(g, vals, out, seg)
    want = seg_scan.run_bcast_max_bwd_plain(g, vals, out, seg)
    torch.cuda.synchronize()
    scale = seg_scan.run_bcast_plain(g.float().abs(), seg, "sum")
    err = (got.float() - want.float()).abs()
    rnd = 0.0 if g.dtype == torch.float32 else 2.0 ** -7
    ok = bool((err <= 1e-5 * scale + rnd * want.float().abs() + 1e-6).all())
    ms = cuda_ms(lambda: seg_scan.run_bcast_max_bwd(g, vals, out, seg), 50)
    dev_ms = device_ms(lambda: seg_scan.run_bcast_max_bwd(g, vals, out, seg), 50)
    plain_ms = cuda_ms(lambda: seg_scan.run_bcast_max_bwd_plain(g, vals, out, seg), 10)
    bms, by = bound_ms(nbytes(g, vals, out, seg, got), 6 * g.numel(), torch.float32)
    name = f"{_short(g)}, {label}"
    print(f"K1 run_bcast max backward {name}: max_abs_err={err.max().item():.3e} (|err| <= "
          f"1e-5 * run sum|g| + {rnd:g} * |plain| + 1e-6); {ms:.4f} ms a fused call as the host "
          f"issues them, {dev_ms:.4f} ms queued on the card, bound {bms:.5f} ms ({smi}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K1 backward at {label} disagrees with its plain version")
    entries.append(dict(name=f"seg_scan.run_bcast max backward {name}", route="cuda",
                        source="com_tpu_torch/csrc/seg_scan.cu",
                        replaces="com_tpu/ops/pallas/seg_scan.py:284",
                        max_abs_err=err.max().item(), ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None, kernel=kernel))


def check_k3_call(dev, entries, calls, args, kw, label, kernel, smi):
    """K3 (``stamp_windows``) on ``args`` / ``kw`` (the objects a train
    step's targets gave it, or a synthetic case): gauss within 2e-6 of the
    plain version, last_wins exact; timed; its call goes into ``calls`` (one
    device kernel).  Returns K3's output."""
    from com_tpu_torch.ops import gaussian, stamp

    centers, radii, _, _, valid, c, h, w, mode = args[:9]
    got = stamp.stamp_windows(*args, **kw)
    want = stamp.stamp_windows_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = err <= 2e-6 if mode == "gauss" else err == 0.0
    calls.append((f"K3 stamp_windows {mode} ({h},{w})" + (f", {label}" if label else ""), 1,
                  "stamp.stamp_windows", args, kw))
    ms = cuda_ms(lambda: stamp.stamp_windows(*args, **kw), 50)
    dev_ms = device_ms(lambda: stamp.stamp_windows(*args, **kw), 50)
    plain_ms = cuda_ms(lambda: stamp.stamp_windows_plain(*args, **kw), 10)
    r = radii.clamp(0, kw.get("max_radius", gaussian.MAX_STAMP_RADIUS))
    cells = int((((2 * r + 1) ** 2) * valid).sum())
    bms, by = bound_ms(nbytes(got, *(a for a in args[:5] if a is not None)),
                       cells * (2 if mode == "gauss" else 1), torch.float32)
    b = got.shape[0]
    print(f"K3 stamp_windows {mode} ({b},{c},{h},{w}) {int(valid.sum())} objects in "
          f"{valid.numel()} slots{', ' + label if label else ''}: max_abs_err={err:.3e} "
          f"({'<= 2e-6' if mode == 'gauss' else 'exact'}); {ms:.4f} ms a call as the host issues "
          f"them, {dev_ms:.4f} ms queued on the card{f' ({smi})' if smi else ''} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K3 {mode} {label} disagrees with its plain version")
    entries.append(dict(name=f"stamp.stamp_windows {mode} ({b},{c},{h},{w}) {valid.shape[1]} "
                             f"slots" + (f", {label}" if label else ""), route="cuda",
                        source="com_tpu_torch/csrc/stamp.cu",
                        replaces="com_tpu/ops/pallas/stamp.py:137", max_abs_err=err, ms=ms,
                        device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        library_ms=None, kernel=kernel))
    return got


def q_small_case(which, root, seed=0):
    """Q.1's small cases, the YAML at its own width over a small tree written
    from ``seed`` under ``root`` (the key frame and its sweeps of 2,000
    points), f32, batch 2 from the port's loader (one thread): "nuscenes",
    ``Q_NUS_CONFIG`` at 64 x 64 x 1 (1.6 m pillars over its range), 2 train
    and 2 val frames; "lyft", ``Q_LYFT_CONFIG`` at 64 x 64 x 40 (2.5 x 2.5 x
    0.2 m voxels, 8,192 voxel slots and backbone caps), 4 train and 2 val
    frames.  Returns (cfg, meta, the val batch, a train batch's arrays the
    train step reads)."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.tools.dataset_trees import write_lyft_tree, write_nuscenes_tree
    from com_tpu_torch.tools.train import dataset_meta
    from com_tpu_torch.train.step import device_batch_keys

    if which == "nuscenes":
        write_nuscenes_tree(root, seed=seed, num_train=2, num_val=2, num_points=2000)
        cfg = l_cfg(Q_NUS_CONFIG, root, ("DATA_CONFIG.DATA_PROCESSOR.2.VOXEL_SIZE",
                                         "[1.6, 1.6, 8.0]"))
    else:
        write_lyft_tree(root, seed=seed, num_train=4, num_val=2, num_points=2000)
        cfg = l_cfg(Q_LYFT_CONFIG, root, (
            "DATA_CONFIG.DATA_PROCESSOR.2.VOXEL_SIZE", "[2.5, 2.5, 0.2]",
            "DATA_CONFIG.DATA_PROCESSOR.2.MAX_NUMBER_OF_VOXELS.train", "8192",
            "DATA_CONFIG.DATA_PROCESSOR.2.MAX_NUMBER_OF_VOXELS.test", "8192",
            "MODEL.BACKBONE_3D.VOXEL_CAPS", "[8192, 8192, 4096, 2048]"))
    cfg.MODEL.MIXED_PRECISION = False
    names = list(cfg.CLASS_NAMES)
    out = []
    for training in (False, True):
        dataset, loader = build_dataloader(cfg.DATA_CONFIG, names, 2, training=training,
                                           workers=1, seed=seed)
        out.append(next(iter(loader)))
    train = {k: out[1][k] for k in device_batch_keys(cfg.MODEL)}
    return cfg, dataset_meta(cfg, dataset), out[0], train


def q1_small_references(dev):
    """Q.1: ``q_small_case`` on the card against the CPU (plain versions),
    the same seeded weights with every norm's bias +3: the nuScenes
    CenterPoint-pillar eval step (heatmaps spread, ``spread_center_scores``)
    and one train step (within the tolerances or twice either device's own
    difference with the scenes swapped: the pillar VFE over ~20,000 points a
    scene); the Lyft SECOND-multihead eval step (``spread_multihead_
    scores``)."""
    import tempfile

    Q_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=Q_DIR) as tmp:
        cfg, meta, val, train = q_small_case("nuscenes", Path(tmp) / "nuscenes")
        label = "path Q.1 small reference (nuScenes CenterPoint-pillar, f32, 64x64x1"
        compare_eval_step(dev, cfg, meta, val, f"{label}, eval step, card vs CPU)",
                          prepare=lambda net: spread_center_scores(shift_norm_biases(net)))
        compare_train_step(dev, cfg, meta, train, f"{label}, train step, card vs CPU)",
                           counts_confidences=False, own_noise=True)
        cfg, meta, val, _ = q_small_case("lyft", Path(tmp) / "lyft")
        compare_eval_step(dev, cfg, meta, val, "path Q.1 small reference (Lyft SECOND-multihead, "
                          "f32, 64x64x40, eval step, card vs CPU)",
                          prepare=lambda net: spread_multihead_scores(shift_norm_biases(net)))


def q_loader(cfg, training):
    """(dataset, loader, meta) of ``cfg``'s DATA_CONFIG at batch Q_BATCH."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.tools.train import dataset_meta

    dataset, loader = build_dataloader(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), Q_BATCH,
                                       training=training, workers=Q_WORKERS, seed=Q_SEED)
    return dataset, loader, dataset_meta(cfg, dataset)


def q_serve(dev, smi, label, cfg, meta, batches, expect, spread, runs=None):
    """``make_eval_step`` over ``batches`` (``runs``: their order, default
    each once) after a warm-up: latency a batch, peak memory, launches a
    forward, finite detections above the score threshold with labels in
    range.  Returns (net, step, launch counts, the outputs)."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    names = list(cfg.CLASS_NAMES)
    net = spread(build_network(cfg.MODEL, meta, device=dev, seed=0))
    step = make_eval_step(net, cfg.MODEL, names, meta, device=dev)
    step(batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    runs = runs or list(range(len(batches)))
    latencies, outs = [], []
    for i in runs:
        t0 = time.perf_counter()
        outs.append([t.cpu().numpy() for t in step(batches[i])])
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    post = cfg.MODEL.get("POST_PROCESSING", {})
    thresh = float((cfg.MODEL.get("DENSE_HEAD") or {}).get("POST_PROCESSING", post)
                   .get("SCORE_THRESH", 0.1))
    ok = all(bool(v.any(1).all()) and np.isfinite(b[v]).all() and (s[v] >= thresh).all()
             and np.isin(lab[v], np.arange(1, len(names) + 1)).all() for b, s, lab, v in outs)
    shown = sorted({int(x) for _, _, lab, v in outs for x in lab[v]})
    print(f"path {label} serving ({tuple(meta.grid_size)} grid, batch "
          f"{len(batches[0]['points_mask'])}): latency ms "
          f"{[round(x, 2) for x in latencies]} (host clock, outputs copied back), detections a "
          f"batch {[int(o[3].sum()) for o in outs]}, labels {shown}, max_memory_allocated "
          f"{peak / 2**30:.2f} GiB ({smi}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"path {label}: malformed detections")
    check_launches(f"{label} serving forward", counts, expect, len(runs))
    return net, step, counts, outs


def q_train(dev, smi, label, cfg, meta, loader, steps, expect, terms=()):
    """``train_model`` over ``loader`` for ``steps`` steps (one mini-epoch),
    with the main thread's wait for each batch (host clock from a step's
    end to the next one's start).  Returns the launch counts."""
    waits, last = [], {"t": None}

    def step_wrap(step):
        def wrapped(state, batch, epoch):
            t = time.perf_counter()
            if last["t"] is not None:
                waits.append(t - last["t"])
            out = step(state, batch, epoch)
            last["t"] = time.perf_counter()
            return out
        return wrapped

    counts, _, _ = run_training(dev, label, cfg, meta, loader, 1, steps, expect,
                                step_wrap=step_wrap, counts_confidences=False, smi=smi,
                                terms=terms)
    if waits:
        print(f"  {label}: the main thread's wait for a batch (host clock between steps) ms "
              f"{[round(1e3 * x, 3) for x in waits]}")
    return counts


def q2_centerpoint(dev, smi, entries, calls, tree, extra_set=()):
    """Q.2: ``Q_NUS_CONFIG`` at full width from the nuScenes tree: three
    serving batches of 4 val frames and the eval step's stages; K1's sum
    and max at the VFE's inputs of a serving forward, K4 at each head
    group's (4, 500) candidates; K2, dgrad and K2w at the BEV backbone's
    shapes; K1's max backward and K3 at each group's targets from one train
    step; the host pipeline's own rate over the train split; 2 steps of
    ``train_model`` over the port's loader (CBGS, GT sampling, world
    augmentations).  Returns (serving counts, train counts, the serving
    det_annos' evaluation input)."""
    from com_tpu_torch.models import vfe as vfe_mod
    from com_tpu_torch.ops import nms, seg_scan, stamp
    from com_tpu_torch.train.eval import eval_model
    from com_tpu_torch.train.step import device_batch_keys

    cfg = l_cfg(Q_NUS_CONFIG, tree, extra_set)
    names = list(cfg.CLASS_NAMES)
    dataset, loader, meta = q_loader(cfg, False)
    t0 = time.perf_counter()
    val = list(loader)
    print(f"path Q.2 val loader: {len(val)} batches of {Q_BATCH} in "
          f"{time.perf_counter() - t0:.2f} s; real points a scene "
          f"{[int(m.sum()) for b in val for m in b['points_mask']]} of "
          f"{val[0]['points'].shape[1]} slots")
    net, step, serve_counts, outs = q_serve(dev, smi, "Q.2 (nuScenes CenterPoint-pillar)", cfg,
                                            meta, val, EXPECT_Q_SERVING, spread_center_scores,
                                            runs=[0, 1, 0])
    stage_breakdown(net, step, val[0], "path Q.2 ", iters=3, smi=smi)
    annos, _, sec = eval_model(step, val, names)
    with captured(vfe_mod, "run_bcast") as k1, captured(nms, "greedy_suppress") as k4:
        step(val[0])
    torch.cuda.synchronize()
    for (vals, seg, op), _ in k1:
        check_k1_call(dev, entries, vals, seg, op, "path Q.2's VFE", "Q:seg_scan", smi)
    sizes = [int(a[1].sum()) for a, _ in k4]
    print(f"path Q.2 K4 calls a forward: {len(k4)} of shape {tuple(k4[0][0][0].shape)}, valid "
          f"candidates a group {sizes}")
    big = max(range(len(k4)), key=sizes.__getitem__)
    for i in sorted({0, big}):
        over, sv = k4[i][0]
        check_k4_cases(dev, entries, calls, over, sv, smi, f", path Q.2 head group {i}",
                       "Q:nms", iters=50)
    del net, step, k1, k4
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=Q_CONV, dtypes=(torch.bfloat16,), path="Q:")
    check_conv3x3_backward(dev, entries, shapes=Q_CONV, wgrad_dtypes=(torch.bfloat16,),
                           path="Q:")
    torch.cuda.empty_cache()
    train_ds, train_loader, _ = q_loader(cfg, True)
    rate_loader = q_loader(cfg, True)[1]
    n, t0 = 0, time.perf_counter()
    for epoch in range(3):  # an epoch is 2 batches: each epoch's workers start cold
        rate_loader.set_epoch(epoch)
        n += sum(1 for _ in rate_loader)
    rate = Q_BATCH * n / (time.perf_counter() - t0)
    print(f"path Q.2 host pipeline alone (CBGS: {len(train_ds)} items of {Q_NUS_TRAIN} train "
          f"frames; GT sampling, flip, rotation, scaling, range mask, shuffle, voxels): "
          f"{rate:.3f} scenes/s with {Q_WORKERS} workers ({n} batches over 3 epochs, host clock "
          f"from the first request)")
    # one step's K1 backward and K3 calls, captured outside the counted run
    first = next(iter(train_loader))
    _, _, state, tstep = build_trainer(dev, cfg, meta, 1)
    keys = device_batch_keys(cfg.MODEL)
    with captured(seg_scan, "run_bcast_max_bwd") as bwd, captured(stamp, "stamp_windows") as k3:
        tstep.loss_fn(state, {k: first[k] for k in keys}, 0)[0].backward()
    torch.cuda.synchronize()
    for (g, vals, out, seg), _ in bwd:
        check_k1_bwd_call(dev, entries, g, vals, out, seg, "path Q.2's VFE", "Q:seg_scan_bwd",
                          smi)
    print(f"path Q.2 K3 calls a step: {len(k3)}, (B, C, H, W) "
          f"{[(a[0].shape[0], a[5], a[6], a[7]) for a, _ in k3]}")
    for i in sorted({0, len(k3) - 1}):
        check_k3_call(dev, entries, calls, *k3[i], f"path Q.2 head group {i}", "Q:stamp_gauss",
                      smi)
    del state, tstep, bwd, k3
    torch.cuda.empty_cache()
    steps = len(train_loader)
    train_counts = q_train(dev, smi, "Q.2 (nuScenes CenterPoint-pillar, the port's loader)", cfg,
                           meta, train_loader, steps, EXPECT_Q_TRAIN,
                           terms=tuple(f"hm_loss_head_{i}" for i in range(6)))
    return serve_counts, train_counts, (dataset, annos, sec)


def q3_configs(dev, smi, entries, calls, nus_tree, lyft_tree, sets=None):
    """Q.3: ``cbgs_pp_multihead`` (2 serving batches, a step), ``cbgs_voxel0075_
    res3d_centerpoint`` (2 and a step), ``cbgs_voxel01_res3d_centerpoint`` (1)
    on the nuScenes tree; Lyft ``cbgs_second_multihead`` (2 serving batches
    and their stages, K4 on its nine-class candidates, a step, the
    ``lyft_eval`` mAP table of its val frames) and ``cbgs_second-nores_
    multihead`` (1) on the Lyft tree.  Returns the Lyft serving counts."""
    from com_tpu_torch.train.eval import eval_model

    sets = sets or {}
    plan = (
        ("Q.3 (nuScenes PointPillars-multihead)", Q_MULTI_CONFIG, nus_tree,
         EXPECT_Q_MULTI_SERVING, EXPECT_Q_MULTI_TRAIN, spread_multihead_scores, 2, True),
        ("Q.3 (nuScenes CenterPoint voxel0075)", Q_V0075_CONFIG, nus_tree,
         EXPECT_Q_VOXEL_SERVING, EXPECT_Q_VOXEL_TRAIN, spread_center_scores, 2, True),
        ("Q.3 (nuScenes CenterPoint voxel01)", Q_V01_CONFIG, nus_tree,
         EXPECT_Q_VOXEL_SERVING, None, spread_center_scores, 1, False),
        ("Q.3 (Lyft SECOND-multihead)", Q_LYFT_CONFIG, lyft_tree,
         EXPECT_Q_LYFT_SERVING, EXPECT_Q_LYFT_TRAIN, spread_multihead_scores, 2, True),
        ("Q.3 (Lyft SECOND-multihead, no res)", Q_LYFT_NORES_CONFIG, lyft_tree,
         EXPECT_Q_LYFT_SERVING, None, spread_multihead_scores, 1, False))
    lyft_counts = None
    for label, config, tree, expect, expect_train, spread, serve_n, train in plan:
        cfg = l_cfg(config, tree, sets.get(config, ()))
        names = list(cfg.CLASS_NAMES)
        dataset, loader, meta = q_loader(cfg, False)
        val = [b for _, b in zip(range(serve_n), loader)]
        net, step, counts, _ = q_serve(dev, smi, label, cfg, meta, val, expect, spread)
        if config == Q_LYFT_CONFIG:
            lyft_counts = counts
            stage_breakdown(net, step, val[0], "path Q.3 Lyft ", iters=3, smi=smi)
            over, sv = e_decoded_candidates(net, cfg, meta, val[0], dev)
            check_k4_cases(dev, entries, calls, over, sv, smi, ", path Q.3 Lyft (nine-class)",
                           "Q3:nms", iters=20)
            del over, sv
            annos, _, sec = eval_model(step, val, names)
            text, res = dataset.evaluation(annos, names, eval_metric="lyft")
            ok = set(res) == {*names, "mAP"} and all(np.isfinite(v) for v in res.values())
            print(f"path Q.3 Lyft mAP (lyft_eval over EVAL_LYFT_IOU_LIST) of {len(annos)} val "
                  f"frames, seeded weights ({sec:.4f} s a frame through eval_model) "
                  f"{'ok' if ok else 'FAIL'}:\n    " + text.strip().replace("\n", "\n    "))
            if not ok:
                raise AssertionError("path Q.3: the Lyft evaluation is malformed")
        del net, step
        torch.cuda.empty_cache()
        if train:
            _, train_loader, _ = q_loader(cfg, True)
            q_train(dev, smi, f"{label}, one step", cfg, meta,
                    SyntheticLoader([next(iter(train_loader))], 1), 1, expect_train)
            torch.cuda.empty_cache()
    return lyft_counts


def q4_clis(dev, smi, nus_tree, lyft_tree, sets=None):
    """Q.4: the train CLI (1 epoch: 2 steps) and the test CLI (the 8 val
    frames) of ``Q_NUS_CONFIG`` on the nuScenes tree and of
    ``Q_LYFT_CONFIG`` on the Lyft tree, as ``com_tpu``'s CLIs run them."""
    from com_tpu_torch.tools import test, train

    _quiet_cli_logger()
    sets = sets or {}
    for config, tree, expect_train, expect_serve in (
            (Q_NUS_CONFIG, nus_tree, EXPECT_Q_TRAIN, EXPECT_Q_SERVING),
            (Q_LYFT_CONFIG, lyft_tree, EXPECT_Q_LYFT_TRAIN, EXPECT_Q_LYFT_SERVING)):
        stem = Path(config).stem
        cfg = l_cfg(config, tree, sets.get(config, ()))
        base = ["--cfg_file", str(REPO / config), "--output_dir", str(Q_DIR / "out"),
                "--workers", str(Q_WORKERS), "--device", str(dev)]
        data = ["--set", "DATA_CONFIG.DATA_PATH", str(tree), *sets.get(config, ())]
        reset_counters()
        t0 = time.perf_counter()
        first = train.main(base + ["--epochs", "1", "--seed", str(Q_SEED)] + data)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = first["iterations"]
        check_launches(f"Q.4 {stem} train step (CLI)", read_counters(), expect_train, steps)
        ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
        ok = steps == 2 and ckpt.exists()
        print(f"path Q.4 train CLI ({stem}, batch {Q_BATCH}): {steps} steps, {wall:.2f} s wall "
              f"(dataset, model and loader included) ({smi}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"path Q.4: the {stem} train CLI failed its checks")
        del first
        torch.cuda.empty_cache()
        reset_counters()
        (res,) = test.main(base + ["--ckpt", str(ckpt), "--infer_time"] + data)
        torch.cuda.synchronize()
        annos = res["det_annos"]
        check_launches(f"Q.4 {stem} eval forward (test CLI)", read_counters(), expect_serve,
                       res["infer_batches"] + 1 + -(-len(annos) // Q_BATCH))
        ok = (len(annos) == Q_VAL and all(np.isfinite(a["boxes_lidar"]).all()
                                          and (np.diff(a["score"]) <= 0).all() for a in annos)
              and bool(res["result_str"]))
        print(f"path Q.4 test CLI ({stem}): {len(annos)} val frames, detections a frame "
              f"{[len(a['score']) for a in annos]}, {res['sec_per_frame']:.4f} s a frame, "
              f"--infer_time {res['infer_ms_per_frame']:.3f} ms a frame ({smi}) "
              f"{'ok' if ok else 'FAIL'}; EVAL_METRIC {cfg.MODEL.POST_PROCESSING.EVAL_METRIC}:\n"
              "    " + res["result_str"].strip().replace("\n", "\n    "))
        if not ok:
            raise AssertionError(f"path Q.4: the {stem} test CLI failed its checks")
        torch.cuda.empty_cache()


def q4_loaders(smi, nus_tree, lyft_tree, panda_tree, sets=None):
    """Q.4: the host loader of the three datasets, training mode under
    their configs' DATA_CONFIG (``Q_PANDASET_CONFIG`` alone for Pandaset, its
    training categories as classes): scenes/s on one thread (each
    augmentation's ms a scene) and through Q_WORKERS loader threads, 8
    scenes each (host clock)."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.utils.config import cfg_from_list, cfg_from_yaml_file

    sets = sets or {}
    for label, config, tree in (("nuScenes", Q_NUS_CONFIG, nus_tree),
                                ("Lyft", Q_LYFT_CONFIG, lyft_tree),
                                ("Pandaset (pre-extracted)", Q_PANDASET_CONFIG, panda_tree)):
        if config == Q_PANDASET_CONFIG:
            ds_cfg = cfg_from_yaml_file(str(REPO / config))
            cfg_from_list(["DATA_PATH", str(tree), *sets.get(config, ())], ds_cfg)
            names = sorted(set(ds_cfg.TRAINING_CATEGORIES.values()))
        else:
            cfg = l_cfg(config, tree, sets.get(config, ()))
            ds_cfg, names = cfg.DATA_CONFIG, list(cfg.CLASS_NAMES)
        dataset, loader = build_dataloader(ds_cfg, names, Q_BATCH, training=True,
                                           workers=Q_WORKERS, seed=Q_SEED)
        times = timed_queue(dataset.data_augmentor, ds_cfg.DATA_AUGMENTOR)
        n = min(8, len(dataset))
        t0 = time.perf_counter()
        pts = [dataset[i]["points"].shape[0] for i in range(n)]
        one = n / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        got = sum(b["batch_size"] for _, b in zip(range(-(-n // Q_BATCH)), loader))
        threaded = got / (time.perf_counter() - t0)
        ms = {k: round(1e3 * float(np.mean(v)), 3) for k, v in times.items() if v}
        print(f"path Q.4 host loader {label}: {one:.2f} scenes/s on one thread ({n} scenes of "
              f"{min(pts)}-{max(pts)} points after the pipeline), {threaded:.2f} scenes/s through "
              f"{Q_WORKERS} loader threads ({got} scenes, batch {Q_BATCH}); ms a scene a step: "
              f"{json.dumps(ms)} ({smi})")


def path_q(dev, smi, entries, calls, points=None, sets=None):
    """Path Q, the nuScenes, Lyft and Pandaset datasets: Q.1 the small f32
    references, card against CPU; the trees written from Q_SEED under
    Q_DIR (nuScenes: 2 train and 8 val frames, each a key frame and 9
    sweeps of 34,000 points; Lyft: 8 and 8, a key frame and 4 sweeps of
    60,000; Pandaset pre-extracted: 8 and 2 frames of 110,000); Q.2
    ``cbgs_dyn_pp_centerpoint`` at full width (``q2_centerpoint``); Q.3 the
    other five configs (``q3_configs``); Q.4 the CLIs and the loaders.
    Returns the launch counts its kernel entries report: Q.2's steps (K1,
    its backward, K2, dgrad, K2w, K3) and serving forwards (K4), Q.3
    Lyft's serving (K4).  ``points`` ({kind: points a sweep or frame}) and
    ``sets`` ({config: ``--set`` pairs}) are for rehearsals."""
    import shutil

    from com_tpu_torch.tools.dataset_trees import (write_lyft_tree, write_nuscenes_tree,
                                                   write_pandaset_tree)

    points = {**Q_SWEEP_POINTS, **(points or {})}
    sets = sets or {}
    shutil.rmtree(Q_DIR, ignore_errors=True)
    Q_DIR.mkdir(parents=True)
    start = time.perf_counter()
    try:
        q1_small_references(dev)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        nus = write_nuscenes_tree(Q_DIR / "nuscenes", seed=Q_SEED, num_train=Q_NUS_TRAIN,
                                  num_val=Q_VAL, num_points=points["nuscenes"])
        lyft = write_lyft_tree(Q_DIR / "lyft", seed=Q_SEED, num_train=Q_LYFT_TRAIN,
                               num_val=Q_VAL, num_points=points["lyft"])
        write_pandaset_tree(Q_DIR / "pandaset", seed=Q_SEED, num_train=8, num_val=2,
                            num_points=points["pandaset"])
        print(f"path Q: trees written in {time.perf_counter() - t0:.1f} s: nuScenes GT database "
              f"{json.dumps(nus['db'])}; Lyft {json.dumps(lyft['db'])}")
        nus_tree, lyft_tree = Q_DIR / "nuscenes", Q_DIR / "lyft"
        serve_counts, train_counts, (nus_ds, annos, sec) = q2_centerpoint(
            dev, smi, entries, calls, nus_tree, sets.get(Q_NUS_CONFIG, ()))
        names = list(nus_ds.class_names)
        text, res = nus_ds.evaluation(annos, names)
        ok = set(res) == {f"{c}_{m}" for c in names for m in ("bev", "3d")}
        print(f"path Q.2 nuScenes evaluation of {len(annos)} val frames (no devkit: the KITTI-"
              f"style fallback), seeded weights ({sec:.4f} s a frame through eval_model) "
              f"{'ok' if ok else 'FAIL'}:\n    " + text.strip().replace("\n", "\n    "))
        if not ok:
            raise AssertionError("path Q.2: the nuScenes evaluation is malformed")
        torch.cuda.empty_cache()
        lyft_counts = q3_configs(dev, smi, entries, calls, nus_tree, lyft_tree, sets)
        torch.cuda.empty_cache()
        q4_clis(dev, smi, nus_tree, lyft_tree, sets)
        torch.cuda.empty_cache()
        q4_loaders(smi, nus_tree, lyft_tree, Q_DIR / "pandaset", sets)
        print(f"path Q: {time.perf_counter() - start:.1f} s wall in all")
    finally:
        shutil.rmtree(Q_DIR, ignore_errors=True)
    return {**{f"Q:{k}": v for k, v in train_counts.items()}, "Q:nms": serve_counts["nms"],
            "Q3:nms": lyft_counts["nms"]}

R_MPP4_CONFIG = "configs/waymo_models/mppnet_4frames.yaml"
R_MPP16_CONFIG = "configs/waymo_models/mppnet_16frames.yaml"
R_CP4_CONFIG = "configs/waymo_models/centerpoint_4frames.yaml"
R_BATCH = 2  # the MPPNet YAMLs' BATCH_SIZE_PER_GPU
R_PROPOSALS = 500  # centerpoint.yaml's NMS_POST_MAXSIZE: a first stage's stored boxes a frame
R_OBJECTS, R_COPIES = 32, 4  # moving objects a scene, jittered proposals of each a frame
R_SIZES = np.array([[4.6, 2.0, 1.7], [0.9, 0.9, 1.8], [1.8, 0.8, 1.7]], np.float32)
R_SMALL_RANGE = (-12.8, -12.8, -2.0, 12.8, 12.8, 4.0)


def mppnet_sequence(rng, b, n, frames, pc_range, proposals=R_PROPOSALS, objects=R_OBJECTS,
                    copies=R_COPIES, m=64):
    """A synthetic sequence for MPPNet: ``b`` Waymo-like scenes
    (``waymo_like_points``, ``n`` points a frame) whose first quarter of
    points lie in ``objects`` boxes of the three classes, each box moving
    by its own displacement a frame (uniform in +-0.6 m in x and y), frame
    f being f frames back.  Returns {"points" (b, frames * n, 6): the
    frames fused, the timestamp 0.1 f last (the sequence loader's layout);
    "points_mask"; "frames": each frame's (b, n, 5) points; "roi_boxes" (b,
    frames, proposals, 9): a first stage's stored boxes a frame, ``copies``
    jittered copies of each object's box (about 0.15 m, 4 % of the size,
    0.05 rad) with the displacement (+ 2 cm of noise) at 7:9, scored
    0.4-0.95, then background boxes scored 0.02-0.2, shuffled a frame;
    "roi_scores" (b, frames, proposals); "roi_labels" (b, proposals): frame
    0's classes; "gt_boxes" (b, m, 8): the objects' frame-0 boxes with
    their class}."""
    half = min(pc_range[3], pc_range[4]) * 0.8
    cls = rng.randint(1, 4, (b, objects))
    box = np.zeros((b, objects, 7), np.float32)
    box[..., 0:2] = rng.uniform(-half, half, (b, objects, 2))
    box[..., 2] = rng.uniform(0.3, 1.2, (b, objects))
    box[..., 3:6] = R_SIZES[cls - 1] * rng.uniform(0.9, 1.1, (b, objects, 3))
    box[..., 6] = rng.uniform(-np.pi, np.pi, (b, objects))
    vel = rng.uniform(-0.6, 0.6, (b, objects, 2)).astype(np.float32)
    base = waymo_like_points(rng, b, n, pc_range)
    n_obj = n // 4
    owner = rng.randint(0, objects, (b, n_obj))
    own = np.take_along_axis(box, owner[..., None], axis=1)  # (b, n_obj, 7)
    local = rng.uniform(-0.5, 0.5, (b, n_obj, 3)).astype(np.float32) * own[..., 3:6]
    c, s = np.cos(own[..., 6]), np.sin(own[..., 6])
    rot = np.stack([local[..., 0] * c - local[..., 1] * s, local[..., 0] * s + local[..., 1] * c,
                    local[..., 2]], -1)
    fused, per_frame = [], []
    for f in range(frames):
        pts = base.copy()
        shift = np.take_along_axis(vel, owner[..., None], axis=1) * f
        pts[:, :n_obj, 0:3] = rot + own[..., 0:3]
        pts[:, :n_obj, 0:2] += shift
        per_frame.append(pts)
        fused.append(np.concatenate([pts, np.full((b, n, 1), 0.1 * f, np.float32)], -1))
    k = objects * copies
    roi_boxes = np.zeros((b, frames, proposals, 9), np.float32)
    roi_scores = np.zeros((b, frames, proposals), np.float32)
    roi_labels = np.zeros((b, proposals), np.int32)
    for f in range(frames):
        obj = np.repeat(box, copies, axis=1)
        obj[..., 0:2] += np.repeat(vel, copies, axis=1) * f + rng.normal(0, 0.15, (b, k, 2))
        obj[..., 2] += rng.normal(0, 0.05, (b, k))
        obj[..., 3:6] *= 1 + rng.normal(0, 0.04, (b, k, 3))
        obj[..., 6] += rng.normal(0, 0.05, (b, k))
        bg_cls = rng.randint(1, 4, (b, proposals - k))
        bg = np.zeros((b, proposals - k, 7), np.float32)
        bg[..., 0:2] = rng.uniform(-half, half, (b, proposals - k, 2))
        bg[..., 2] = rng.uniform(0.0, 1.5, (b, proposals - k))
        bg[..., 3:6] = R_SIZES[bg_cls - 1] * rng.uniform(0.8, 1.2, (b, proposals - k, 3))
        bg[..., 6] = rng.uniform(-np.pi, np.pi, (b, proposals - k))
        rows = np.concatenate([obj, bg], 1)
        disp = np.concatenate([np.repeat(vel, copies, axis=1) + rng.normal(0, 0.02, (b, k, 2)),
                               np.zeros((b, proposals - k, 2))], 1)
        score = np.concatenate([rng.uniform(0.4, 0.95, (b, k)),
                                rng.uniform(0.02, 0.2, (b, proposals - k))], 1)
        label = np.concatenate([np.repeat(cls, copies, axis=1), bg_cls], 1)
        for i in range(b):
            perm = rng.permutation(proposals)
            roi_boxes[i, f] = np.concatenate([rows[i], disp[i]], -1)[perm]
            roi_scores[i, f] = score[i][perm]
            if f == 0:
                roi_labels[i] = label[i][perm]
    gt = np.zeros((b, m, 8), np.float32)
    gt[:, :objects, :7] = box
    gt[:, :objects, 7] = cls
    points = np.concatenate(fused, 1)
    return {"points": points, "points_mask": np.ones(points.shape[:2], bool),
            "frames": per_frame, "roi_boxes": roi_boxes, "roi_scores": roi_scores,
            "roi_labels": roi_labels, "gt_boxes": gt}


R_OTHER_VOXEL = (("R.5 (centerpoint.yaml)", "configs/waymo_models/centerpoint.yaml"),
                 ("R.5 (centerpoint_without_resnet.yaml)",
                  "configs/waymo_models/centerpoint_without_resnet.yaml"))
R_PILLAR_CONFIG = "configs/waymo_models/centerpoint_pillar.yaml"
R_COM_CONFIGS = (("R.5 (car_com2, COM2 sampler)",
                  "configs/waymo_models/com/centerpoint_pillar_car_com2.yaml", (1, 96)),
                 ("R.5 (ped_com)", "configs/waymo_models/com/centerpoint_pillar_ped_com.yaml",
                  (1, 15)),
                 ("R.5 (ped_com2)", "configs/waymo_models/com/centerpoint_pillar_ped_com2.yaml",
                  (1, 15)))
# R.5's COM configs over their own pipeline: mini-epochs, steps an epoch, objects a scene at
# most (one class a scene: LIMIT_WHOLE_SCENE leaves room for 15 - 8 Vehicles, 10 - 8
# Pedestrians)
R_COM_EPOCHS, R_COM_STEPS, R_COM_OBJECTS = 2, 2, 8
R_POINTRCNN_CONFIG = "configs/waymo_models/pointrcnn.yaml"
R_POINTRCNN_BATCH, R_POINTRCNN_POINTS = 4, 16384  # the YAML's batch and sample_points
EXPECT_R_MPP_SERVING = {"nms": 1}  # the final NMS; MPPNet's head runs no other kernel
EXPECT_R_VOXEL_SERVING = {"conv3x3": 11, "nms": 1}
EXPECT_R_VOXEL_TRAIN = {"conv3x3": 11, "conv3x3_dgrad": 11, "conv3x3_wgrad": 11,
                        "stamp_gauss": 1}
EXPECT_R_PILLAR_SERVING = {"seg_scan": 2, "conv3x3": 14, "nms": 1}
EXPECT_R_PILLAR_TRAIN = {"seg_scan": 2, "seg_scan_bwd": 1, "conv3x3": 14, "conv3x3_dgrad": 14,
                         "conv3x3_wgrad": 14, "stamp_gauss": 1}
R_TRAIN_STEPS = 12
# mppnet_16frames.yaml keeps the 4-frame YAML's pool MLPS [[128, 128], [128, 128]] with
# TRANS_INPUT 64: its pooled geometry (2 x 128) cannot add to its motion features (64), and
# its forward fails in both packages (tests/test_torch_port_mppnet.py).  Path R runs it with
# the pool's last widths summing to TRANS_INPUT, as the 4-frame YAML's do (2 x 128 = 256)
R_MPP16_MLPS = [[32, 32], [32, 32]]
R_LOSS_DROP = 0.8  # the loss must end below this share of its first value (tests/test_mppnet.py)


def load_points_yaml(config, pc_range=None):
    """A YAML without a voxel processor (MPPNet's, Waymo PointRCNN's) and
    its meta: the YAML's range (or ``pc_range``), 0.1 x 0.1 x 0.15 m cells
    (read by neither model), its points' features."""
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.ops.voxelize import grid_size_from_range
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / config))
    pr = list(pc_range or cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    vsize = [0.1, 0.1, 0.15]
    feats = len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list)
    return cfg, DatasetMeta(cfg.CLASS_NAMES, pr, vsize, grid_size_from_range(pr, vsize), feats)


def load_mppnet(config, pc_range=None):
    """``load_points_yaml`` of an MPPNet YAML, the 16-frame one's pool MLPS
    set to R_MPP16_MLPS."""
    cfg, meta = load_points_yaml(config, pc_range)
    if config == R_MPP16_CONFIG:
        cfg.MODEL.ROI_HEAD.ROI_GRID_POOL.MLPS = R_MPP16_MLPS
    return cfg, meta


def mppnet_width_case(config=R_MPP4_CONFIG, seed=0, points=2000, proposals=48, objects=6):
    """An MPPNet YAML at its own head widths (``load_mppnet``), f32,
    dropout 0 and 16 RoIs a sample in training, over ``mppnet_sequence``
    of ``objects`` boxes and ``proposals`` boxes a frame on R_SMALL_RANGE,
    ``points`` points a frame, batch 2: few points and RoIs, so that a
    comparison's CPU side stays quick.  Returns (cfg, meta, batch)."""
    cfg, meta = load_mppnet(config, R_SMALL_RANGE)
    r = cfg.MODEL.ROI_HEAD
    r.Transformer.dropout = 0.0
    r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    frames = int(r.Transformer.num_frames)
    batch = mppnet_sequence(np.random.RandomState(seed), 2, points, frames, R_SMALL_RANGE,
                            proposals=proposals, objects=objects, copies=4, m=16)
    return cfg, meta, batch


def mppnet_small_case(config=R_MPP4_CONFIG, seed=0, points=2000, proposals=48, objects=6):
    """``mppnet_width_case`` narrowed as the CPU tests narrow it
    (TRANS_INPUT 32, a 2^3 proxy grid at the YAML's two radii of 8
    neighbours, 32 points a RoI, FFN 64, mixer 8).  Returns (cfg, meta,
    batch)."""
    cfg, meta, batch = mppnet_width_case(config, seed, points, proposals, objects)
    r = cfg.MODEL.ROI_HEAD
    r.TRANS_INPUT = 32
    r.ROI_GRID_POOL.update(GRID_SIZE=2, MLPS=[[16, 16], [16, 16]], NSAMPLE=[8, 8])
    r.Transformer.update(num_lidar_points=32, num_proxy_points=8, dim_feedforward=64,
                         hidden_dim=32)
    r.Transformer.use_mlp_mixer.hidden_dim = 8
    return cfg, meta, batch


def mppnet_links(cfg, batch, dev):
    """The linking's validity (B, F, R) and each linked frame's best IoU
    (B, F - 1, R), from ``batch`` on ``dev``."""
    from com_tpu_torch.models.mppnet import generate_trajectory
    from com_tpu_torch.ops.iou import boxes_iou3d

    props = torch.as_tensor(batch["roi_boxes"], device=dev)
    traj, valid = generate_trajectory(props[:, 0], props)
    best = []
    for i in range(1, props.shape[1]):
        prev = traj[:, i - 1]
        pred = torch.cat([prev[..., 0:2] + prev[..., 7:9], prev[..., 2:7]], -1)
        best.append(boxes_iou3d(pred, props[:, i, :, :7]).max(dim=2).values)
    return valid.cpu(), torch.stack(best, 1).cpu()


def compare_mppnet(dev, cfg, meta, batch, label):
    """MPPNet on the card against the CPU, the same seeded weights, every
    norm's bias +3: the trajectory linking (a (RoI, frame) pair that links
    on one device and not on the other is reported with its IoU, and
    fails unless that IoU is within 1e-4 of the 0.5 threshold), the eval
    step's detections (``check_detections``), the train-mode targets (the
    foreground mask; a flip must sit within 1e-4 of REG_FG_THRESH) and one
    f32 step's loss (rel 1e-4) and gradients (within 1e-3 of each
    gradient's max + 1e-5 of the net's max, or twice either device's own
    difference with the scenes swapped)."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.models.mppnet import mppnet_loss
    from com_tpu_torch.train.eval import make_eval_step

    (vc, ic), (vp, ip) = mppnet_links(cfg, batch, dev), mppnet_links(cfg, batch, "cpu")
    flips = (vc != vp)[:, 1:]
    near = bool((torch.abs(ip[flips] - 0.5) <= 1e-4).all())
    print(f"{label}, linking card vs CPU: {int(vc[:, 1:].sum())} vs {int(vp[:, 1:].sum())} "
          f"linked (RoI, frame) pairs, {int(flips.sum())} flipped"
          + (f" at IoUs {ip[flips].tolist()}" if flips.any() else "")
          + f" {'ok' if near else 'FAIL'}")
    if not near:
        raise AssertionError(f"{label}: the card links trajectories the CPU does not")
    compare_eval_step(dev, cfg, meta, batch, f"{label}, eval step, card vs CPU",
                      prepare=shift_norm_biases)
    keys = ("roi_boxes", "roi_scores", "roi_labels", "points", "points_mask", "gt_boxes")
    loss_cfg = cfg.MODEL.ROI_HEAD.LOSS_CONFIG

    def run(d, b):
        net = shift_norm_biases(build_network(cfg.MODEL, meta, device=d, seed=7)).train()
        out = net({k: torch.as_tensor(b[k], device=d) for k in keys})
        loss, _ = mppnet_loss(out["mppnet_preds"], out["mppnet_targets"], loss_cfg)
        loss.backward()
        grads = {k: p.grad.float().cpu() for k, p in net.named_parameters()}
        return float(loss.detach()), grads, out["mppnet_targets"].reg_valid.cpu()

    def gerr(ga, gb):
        gmax = max(float(g.abs().max()) for g in gb.values())
        return max(float(((ga[k] - gb[k]).abs() / (1e-3 * gb[k].abs().max() + 1e-5 * gmax)).max())
                   for k in gb)

    card, cpu = run(dev, batch), run("cpu", batch)
    fg_flips = int((card[2] != cpu[2]).sum())
    swapped = {k: np.ascontiguousarray(batch[k][::-1]) for k in keys}
    own = max(gerr(run(dev, swapped)[1], card[1]), gerr(run("cpu", swapped)[1], cpu[1]))
    lerr, err = abs(card[0] - cpu[0]) / abs(cpu[0]), gerr(card[1], cpu[1])
    ok = fg_flips == 0 and lerr <= 1e-4 and err <= max(1.0, 2 * own)
    print(f"{label}, one f32 train step card vs CPU: loss {card[0]:.6f} vs {cpu[0]:.6f} (rel "
          f"{lerr:.2e} <= 1e-4); foreground RoIs {int(card[2].sum())} vs {int(cpu[2].sum())} "
          f"({fg_flips} flipped); {len(cpu[1])} gradients at {err:.3f} of the tolerance (allowed "
          f"{max(1.0, 2 * own):.3f}: each device against itself with the scenes swapped "
          f"{own:.3f}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the card's MPPNet step disagrees with the CPU")


def r_serve_mppnet(dev, smi, entries, calls, label, config, points, kernel, batch=None,
                   timed=3, stage_iters=3):
    """MPPNet at full width through ``make_eval_step``: one warm-up, then
    ``timed`` timed batches of ``mppnet_sequence`` (R_BATCH scenes of
    ``points`` points a frame, R_PROPOSALS proposals a frame; or ``batch``):
    latency, peak memory, the linked (RoI, frame) pairs (> 0), finite
    detections above SCORE_THRESH with labels in range, K4 once a forward;
    the eval step's stages (the mean of ``stage_iters``); K4 on the final
    NMS's candidates.  Returns (counts, cfg, meta, batch)."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.models.mppnet import mppnet_head
    from com_tpu_torch.train.eval import make_eval_step
    from com_tpu_torch.train.step import model_input_keys

    cfg, meta = load_mppnet(config)
    frames = int(cfg.MODEL.ROI_HEAD.Transformer.num_frames)
    if batch is None:
        batch = mppnet_sequence(np.random.RandomState(71), R_BATCH, points, frames,
                                meta.point_cloud_range)
    inputs = {k: batch[k] for k in model_input_keys(cfg.MODEL)}
    net = build_network(cfg.MODEL, meta, device=dev, seed=0)
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    linked = []
    hook = net.roi_head.register_forward_hook(
        lambda m, args, out: linked.append(out["valid_length"][:, 1:].sum()))
    step(inputs)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    linked.clear()
    reset_counters()
    latencies, outs = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        outs.append([t.cpu().numpy() for t in step(inputs)])
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    hook.remove()
    pairs = [int(x) for x in linked]
    thresh = float(cfg.MODEL.POST_PROCESSING.SCORE_THRESH)
    # a zero-padded proposal slot has label 0 and, as in com_tpu (no roi_valid), may surface
    padded = int((np.abs(inputs["roi_boxes"][:, 0, :, :6]).sum(-1) == 0).sum())
    ok = min(pairs) > 0 and all(
        bool(v.any(1).all()) and np.isfinite(b[v]).all() and (s[v] > thresh).all()
        and np.isin(lab[v], [1, 2, 3] if padded == 0 else [0, 1, 2, 3]).all()
        for b, s, lab, v in outs)
    n_roi = inputs["roi_boxes"].shape[2]
    mlps = cfg.MODEL.ROI_HEAD.ROI_GRID_POOL.MLPS
    print(f"path {label} serving through make_eval_step (batch {R_BATCH}, {frames} frames fused: "
          f"{inputs['points'].shape[1]:,} points a scene, {n_roi} proposals a frame, TRANS_INPUT "
          f"{cfg.MODEL.ROI_HEAD.TRANS_INPUT}, pool MLPS {list(map(list, mlps))}): latency ms "
          f"{[round(x, 2) for x in latencies]} (host clock, outputs copied back), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; linked (RoI, frame) pairs past frame 0 "
          f"{pairs} of {R_BATCH * n_roi * (frames - 1)}; detections a batch "
          f"{[int(o[3].sum()) for o in outs]}"
          + (f" ({int(((outs[0][2] == 0) & outs[0][3]).sum())} of the first from the "
             f"{padded} zero-padded proposal slots, label 0, as com_tpu's)" if padded else "")
          + f" ({smi}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"path {label}: no linked pair or malformed detections")
    check_launches(f"{label} eval forward", counts, EXPECT_R_MPP_SERVING, timed)
    two_stage_breakdown(
        net, lambda: step(inputs), f"path {label} eval step", iters=stage_iters, smi=smi,
        marks_fn=lambda n, mark: _mark_detector_then_head(n, mppnet_head, mark))
    over, sv = final_candidates(net, cfg, inputs, dev)
    check_k4_cases(dev, entries, calls, over, sv, smi, f", path {label} final NMS", kernel,
                   iters=50)
    del net, step
    torch.cuda.empty_cache()
    return counts, cfg, meta, batch


def _mark_detector_then_head(net, module, mark):
    """MPPNet's marks: "roi.trajectory" as the detector starts (the
    linking), then ``_mark_mppnet_head``'s."""
    hook = net.register_forward_pre_hook(lambda *_: mark("roi.trajectory"))
    undo = _mark_mppnet_head(net.roi_head, module, mark)

    def undo_all():
        undo()
        hook.remove()

    return undo_all


def r_train_mppnet(dev, smi, label, cfg, meta, batch, steps=R_TRAIN_STEPS):
    """MPPNet trained at the function level at full width, as either
    package trains it: the detector in train mode (ROI_PER_IMAGE
    trajectories sampled a sample, dropout from ``step_generators``),
    ``mppnet_loss``, backward and ``AdamOneCycle`` (the YAML's schedule over
    ``steps``), ``steps`` steps on one batch: every loss finite, foreground
    RoIs every step, the last loss below R_LOSS_DROP of the first, no
    kernel launched; step ms (CUDA events, the first left out) and peak
    memory.  Returns the counts."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.models.mppnet import mppnet_loss
    from com_tpu_torch.train.optim import build_optimizer
    from com_tpu_torch.train.step import step_generators

    keys = ("roi_boxes", "roi_scores", "roi_labels", "points", "points_mask", "gt_boxes")
    inputs = {k: torch.as_tensor(batch[k], device=dev) for k in keys}
    net = build_network(cfg.MODEL, meta, device=dev, seed=0).train()
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, steps, steps)
    loss_cfg = cfg.MODEL.ROI_HEAD.LOSS_CONFIG
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    losses, fg, marks = [], [], []
    for i in range(steps):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        out = net(dict(inputs, rngs=step_generators(17, i, dev)))
        loss, parts = mppnet_loss(out["mppnet_preds"], out["mppnet_targets"], loss_cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(torch.stack([loss.detach(), *(v.detach() for v in parts.values())]))
        fg.append(out["mppnet_targets"].reg_valid.sum())
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    marks.append(ev)
    torch.cuda.synchronize()
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    rows = torch.stack(losses).cpu().numpy()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks[1:], marks[2:])]
    fg = [int(x) for x in fg]
    ok = (np.isfinite(rows).all() and min(fg) > 0 and rows[-1, 0] < R_LOSS_DROP * rows[0, 0])
    print(f"path {label} training at the function level ({steps} steps on one batch, "
          f"{int(cfg.MODEL.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE)} RoIs a sample): loss "
          f"{[round(float(x), 4) for x in rows[:, 0]]} (last below {R_LOSS_DROP} of the first: "
          f"{rows[-1, 0] / rows[0, 0]:.3f}); parts at the first and last step "
          f"{dict(zip(('cls', 'reg', 'corner'), rows[0, 1:].round(4).tolist()))} -> "
          f"{dict(zip(('cls', 'reg', 'corner'), rows[-1, 1:].round(4).tolist()))}; foreground "
          f"RoIs a step {fg[:3]}...; step ms median {np.median(step_ms):.2f} "
          f"[{min(step_ms):.2f}, {max(step_ms):.2f}], max_memory_allocated {peak / 2**30:.2f} GiB "
          f"({smi}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"path {label}: MPPNet's loss did not fall or was not finite")
    check_launches(f"{label} function-level step", counts, {}, steps)
    del net, opt
    torch.cuda.empty_cache()
    return counts


def r_first_stage(dev, smi, seq):
    """R.4: ``centerpoint_4frames.yaml`` at full width (MeanVFE over 90,000
    voxel slots of 0.1 x 0.1 x 0.15 m, VoxelResBackBone8x, a CenterHead
    with velocity) serves each frame of ``seq`` as the current one, fused
    with its past frames of the sequence in the sequence loader's layout
    (the current frame's points with time 0, a past frame's with 0.1 a
    frame back; the sequence's last frames have fewer past frames, as a
    sequence's start has); its boxes (up to 500 a frame, velocity at 7:9)
    are packed as ``roi_boxes`` (invalid slots zero) with their scores and
    frame 0's labels.  Then two train steps of the YAML at full width.
    Returns (the MPPNet batch, launch counts of the forwards, of the
    step)."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, proc = load_voxel(R_CP4_CONFIG)
    frames = seq["frames"]
    f_n, (b, n) = len(frames), frames[0].shape[:2]
    net = build_network(cfg.MODEL, meta, device=dev, seed=0)
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    boxes = np.zeros((b, f_n, R_PROPOSALS, 9), np.float32)
    scores = np.zeros((b, f_n, R_PROPOSALS), np.float32)
    labels = np.zeros((b, R_PROPOSALS), np.int32)
    batches = []
    for f in range(f_n):
        pts = np.zeros((b, f_n * n, 6), np.float32)
        mask = np.zeros((b, f_n * n), bool)
        for j in range(f, f_n):
            pts[:, (j - f) * n:(j - f + 1) * n] = np.concatenate(
                [frames[j], np.full((b, n, 1), 0.1 * (j - f), np.float32)], -1)
            mask[:, (j - f) * n:(j - f + 1) * n] = True
        batches.append(voxelize_batch({"points": pts, "points_mask": mask}, meta, proc, "test"))
    step(batches[0])  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    ms = []
    for f, vb in enumerate(batches):
        t0 = time.perf_counter()
        bx, sc, lb, vd = (t.cpu().numpy() for t in step(vb))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        boxes[:, f, :bx.shape[1]] = np.where(vd[..., None], bx, 0.0)
        scores[:, f, :sc.shape[1]] = np.where(vd, sc, 0.0)
        if f == 0:
            labels[:, :lb.shape[1]] = np.where(vd, lb, 0)
    counts = read_counters()
    valid = (np.abs(boxes[..., :6]).sum(-1) > 0).sum(-1)
    ok = boxes.shape[-1] == 9 and bool((valid > 0).all()) and np.isfinite(boxes).all()
    print(f"path R.4 centerpoint_4frames.yaml as MPPNet's first stage (batch {b}, "
          f"{[int((v['voxel_num_points'] > 0).sum(1).min()) for v in batches]} voxels at least a "
          f"scene a frame): ms a frame {[round(x, 2) for x in ms]}; boxes a frame with velocity "
          f"{valid.tolist()} of {R_PROPOSALS} ({smi}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path R.4: the first stage gave no boxes")
    check_launches("R.4 centerpoint_4frames eval forward", counts, EXPECT_R_VOXEL_SERVING, f_n)
    del net, step
    torch.cuda.empty_cache()
    tb = waymo_like_batch(np.random.RandomState(72), R_BATCH, n, meta.point_cloud_range,
                          (0.32, 0.32, 6.0), len(meta.class_names))
    tb["points"] = np.concatenate([tb["points"], np.zeros((b, n, 1), np.float32)], -1)
    gt = tb["gt_boxes"]  # a velocity head's GT carries (vx, vy) before the class: zero here
    tb["gt_boxes"] = np.concatenate([gt[..., :7], np.zeros((*gt.shape[:2], 2), np.float32),
                                     gt[..., 7:]], -1)
    train_counts = r_train_config(dev, smi, "R.4 (centerpoint_4frames.yaml)", cfg, meta,
                                  voxelize_batch(tb, meta, proc, "train"), EXPECT_R_VOXEL_TRAIN)
    mpp = {"roi_boxes": boxes, "roi_scores": scores, "roi_labels": labels,
           "points": seq["points"], "points_mask": seq["points_mask"]}
    return mpp, counts, train_counts


def r_train_config(dev, smi, label, cfg, meta, batch, expect, counts_confidences=False,
                   prepare=None):
    """Two ``train_model`` steps of ``cfg`` at full width on ``batch``
    (``run_training``; the second timed): finite loss, gradients and
    parameters, launches."""
    counts, _, _ = run_training(dev, label, cfg, meta, SyntheticLoader([batch], 2), 1, 2, expect,
                                counts_confidences=counts_confidences, smi=smi, prepare=prepare)
    torch.cuda.empty_cache()
    return counts


def r_small_voxel(config):
    """``config`` at its own width and cell, f32, over P_SMALL_RANGE (64 x 64
    x 40 cells of 0.1 x 0.1 x 0.15 m), 4,096 voxel slots and backbone caps,
    2 Waymo-like scenes of 3,000 points (a zero time column for a
    6-feature YAML)."""
    cfg, meta, proc = load_voxel(config, P_SMALL_RANGE)
    cfg.MODEL.MIXED_PRECISION = False
    cfg.MODEL.BACKBONE_3D.VOXEL_CAPS = [4096, 4096, 2048, 1024]
    proc.MAX_NUMBER_OF_VOXELS = {"train": 4096, "test": 4096}
    pts = waymo_like_points(np.random.RandomState(73), 2, 3000, P_SMALL_RANGE)
    if meta.num_point_features == 6:
        pts = np.concatenate([pts, np.zeros((2, 3000, 1), np.float32)], -1)
    batch = voxelize_batch({"points": pts, "points_mask": np.ones((2, 3000), bool)}, meta, proc,
                           "test")
    return cfg, meta, batch


def r_pointrcnn_small_case():
    """Waymo ``pointrcnn.yaml`` narrowed as ``pointrcnn_small_case`` narrows
    PointRCNN (its SA levels, FPs, point head and RoI head widths, 128 ->
    16 proposals), the YAML's own targets, coder and NMS thresholds, f32,
    over that case's 2 scenes of 1,024 points.  Returns (cfg, meta,
    batch)."""
    small, meta, batch = pointrcnn_small_case(seed=1)
    cfg, _ = load_points_yaml(R_POINTRCNN_CONFIG)
    m, sm = cfg.MODEL, small.MODEL
    m.MIXED_PRECISION = False
    m.BACKBONE_3D = sm.BACKBONE_3D
    m.POINT_HEAD.update(CLS_FC=sm.POINT_HEAD.CLS_FC, REG_FC=sm.POINT_HEAD.REG_FC)
    for k in ("ROI_POINT_POOL", "XYZ_UP_LAYER", "CLS_FC", "REG_FC", "SA_CONFIG"):
        m.ROI_HEAD[k] = sm.ROI_HEAD[k]
    m.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 16
    for mode in ("TRAIN", "TEST"):
        m.ROI_HEAD.NMS_CONFIG[mode].update(NMS_PRE_MAXSIZE=128, NMS_POST_MAXSIZE=16)
    return cfg, meta, batch


def report_pointrcnn_full_width(dev, cfg, meta, rng):
    """Not a gate: the full-width Waymo PointRCNN on 4,096 points a scene
    (``cfg``: f32, NMS_PRE_MAXSIZE 256), the card against the CPU (the same
    seeded weights, scores spread): the
    first level's FPS indices, the point scores, and the top-256 candidate
    sets.  A discrete choice made either way in rounding (an FPS argmax, a
    score at the cut) sends the two devices' detections apart from there."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.ops.pointnet2 import farthest_point_sample

    pts = waymo_like_points(rng, 2, 4096, meta.point_cloud_range)
    outs = []
    for d in (dev, "cpu"):
        xyz = torch.as_tensor(pts[..., :3], device=d)
        valid = torch.ones((2, 4096), dtype=torch.bool, device=d)
        fps = farthest_point_sample(xyz, valid, 1024).cpu()
        net = spread_point_scores(build_network(cfg.MODEL, meta, device=d, seed=7))
        with torch.no_grad():
            out = net({"points": torch.as_tensor(pts, device=d), "points_mask": valid})
        score = out["point_cls_scores"].float().cpu()
        outs.append((fps, score, set(map(tuple, torch.topk(score, 256, dim=1).indices.tolist()))))
    (fa, sa, ta), (fb, sb, tb) = outs
    first = (fa != fb).any(0).nonzero()
    print(f"path R.5 Waymo PointRCNN at full width, 4,096 points a scene, card vs CPU (a "
          f"report): FPS of 1,024 from 4,096 differs at {int((fa != fb).sum())} slots (first at "
          f"{int(first[0]) if len(first) else None}); point scores max abs diff "
          f"{float((sa - sb).abs().max()):.3e}; the top-256 candidate sets "
          f"{'equal' if ta == tb else 'differ'}")


def r_pointrcnn(dev, smi, entries, calls):
    """Waymo ``pointrcnn.yaml`` through ``make_eval_step`` and
    ``make_train_step`` (neither package's CLI runs PointRCNN): the f32 eval
    step card against CPU on ``r_pointrcnn_small_case``, and a report of
    the full width on 4,096 points (``report_pointrcnn_full_width``); then
    at full width (batch 4 of 16,384 Waymo-like points a scene, scores
    spread): one serving batch, K4 on its (4, 4096) proposal candidates,
    two train steps with GT on its own proposals.  Returns (serving counts,
    step counts)."""
    cfg, meta = load_points_yaml(R_POINTRCNN_CONFIG)
    rng = np.random.RandomState(74)
    scfg, smeta, sbatch = r_pointrcnn_small_case()
    compare_eval_step(dev, scfg, smeta, sbatch, "path R.5 small reference (Waymo PointRCNN "
                      "narrowed, f32, 1,024 points, eval step, card vs CPU)",
                      prepare=spread_point_scores)
    import copy

    small = copy.deepcopy(cfg)
    small.MODEL.MIXED_PRECISION = False
    for mode in ("TRAIN", "TEST"):  # the CPU's (2, 4096) rotated IoU would take minutes
        small.MODEL.ROI_HEAD.NMS_CONFIG[mode].NMS_PRE_MAXSIZE = 256
    report_pointrcnn_full_width(dev, small, meta, rng)

    def batch():
        return waymo_like_batch(rng, R_POINTRCNN_BATCH, R_POINTRCNN_POINTS,
                                meta.point_cloud_range, (0.32, 0.32, 6.0), 3)

    serve_b, train_b = batch(), batch()
    label = "R.5 (Waymo PointRCNN)"
    net, _, serve_counts, _ = q_serve(dev, smi, label, cfg, meta, [serve_b], EXPECT_N_SERVING,
                                      spread_point_scores)
    over, sv = point_proposal_candidates(net, cfg, serve_b, dev, train=False)
    check_k4_cases(dev, entries, calls, over, sv, smi, ", path R.5 Waymo PointRCNN proposals",
                   "R:nms_prcnn", iters=20)
    del net, over, sv
    torch.cuda.empty_cache()
    train_counts = two_stage_training(dev, label, cfg, meta, [train_b], EXPECT_N_TRAIN, N_TERMS,
                                      smi, spread=spread_point_scores)
    return serve_counts, train_counts


def r_com_configs(dev, smi, entries, calls, grid=None, points=POINTS, bg_points=120000):
    """The paper's single-class COM configs (``COM: True``: the COM2
    sampler; ``UCL: True``): each one's f32 eval step at a 64 x 64 grid
    card against CPU, one serving batch at full width (468 x 468, batch 2
    of 163,840 points), then ``pipeline_training`` over the port's
    ``SyntheticDataset`` built from the YAML's own DATA_AUGMENTOR and
    DATA_PROCESSOR (R_COM_EPOCHS mini-epochs of R_COM_STEPS steps, scenes
    of ``bg_points`` ground points and up to R_COM_OBJECTS objects, room
    under LIMIT_WHOLE_SCENE): ``train_model``'s epoch-end confidences reach
    the dataset's own DataBaseSamplerCOM2 through its
    ``set_confidence_groups``, (1, 96) for the vehicle config and (1, 15)
    for the pedestrian ones, and the sampler draws the next epoch's
    pastes by them.  K3 in both modes at car_com2's (2, 1, 468, 468) from
    one step.  Returns car_com2's train counts (the K3 entries'
    launches)."""
    from com_tpu_torch.ops import stamp
    from com_tpu_torch.train.step import device_batch_keys

    first = None
    for label, config, conf in R_COM_CONFIGS:
        cfg, meta = load_config(grid=(64, 64, 1), config=config)
        cfg.MODEL.MIXED_PRECISION = False
        pts = waymo_like_points(np.random.RandomState(75), BATCH, 4096, meta.point_cloud_range)
        compare_eval_step(dev, cfg, meta, {"points": pts, "points_mask": np.ones((BATCH, 4096),
                                                                                 bool)},
                          f"path {label} small reference (64x64 f32, eval step, card vs CPU)",
                          prepare=spread_center_scores)
        cfg, meta = load_config(grid, config)
        serve_b = waymo_like_batch(np.random.RandomState(76), BATCH, points,
                                   meta.point_cloud_range, meta.voxel_size, 1)
        q_serve(dev, smi, label, cfg, meta, [serve_b], EXPECT_SERVING, lambda n: n)
        torch.cuda.empty_cache()
        ds_cfg = path_c_dataset_cfg(cfg, bg_points=bg_points, max_points=points,
                                    scenes=BATCH * R_COM_STEPS, objects=R_COM_OBJECTS)
        ds_cfg.POINT_CLOUD_RANGE = list(meta.point_cloud_range)
        counts, trainer, _, _ = pipeline_training(dev, f"path {label}", label, cfg, meta, ds_cfg,
                                                  R_COM_EPOCHS, R_COM_STEPS, EXPECT_TRAIN_UCL,
                                                  conf)
        if first is None:
            first = counts
            net, _, state, step = trainer
            keys = device_batch_keys(cfg.MODEL)
            with captured(stamp, "stamp_windows") as k3:
                step.loss_fn(state, {k: serve_b[k] for k in keys}, 0)
            torch.cuda.synchronize()
            for args, kw in k3:
                check_k3_call(dev, entries, calls, args, kw, f"path {label}",
                              f"R:stamp_{args[8]}", smi)
            del k3, net, state, step
        del trainer
        torch.cuda.empty_cache()
    return first


def path_r(dev, smi, entries, calls, points=POINTS, grid=None, voxel_range=None,
           bg_points=120000):
    """Path R, MPPNet (the multi-frame second stage over a first stage's
    stored boxes) and the eight Waymo configs no earlier path runs: R.0 the
    small f32 references, card against CPU (``compare_mppnet`` on
    ``mppnet_width_case``: the YAMLs' head widths, few points and RoIs); R.1 / R.2 ``mppnet_4frames.yaml`` /
    ``mppnet_16frames.yaml`` serving at full width over a 4- / 16-frame
    ``mppnet_sequence`` (``points`` points a frame, 500 proposals a frame)
    with K4 at the final NMS's (2, 500); R.3 both trained at the function
    level (``r_train_mppnet``); R.4 ``centerpoint_4frames.yaml`` as the
    first stage, its boxes served through ``mppnet_4frames.yaml``
    (``r_first_stage``); R.5 ``centerpoint.yaml``, ``centerpoint_
    without_resnet.yaml`` and ``centerpoint_pillar.yaml`` (card against
    CPU at a small grid, a serving batch and two steps at full width), the COM
    configs (``r_com_configs``) and Waymo PointRCNN (``r_pointrcnn``).
    Returns the launch counts its kernel entries report.  ``points``,
    ``grid``, ``voxel_range`` and ``bg_points`` are for rehearsals."""
    start = time.perf_counter()
    out = {}
    for config in (R_MPP4_CONFIG, R_MPP16_CONFIG):
        cfg, meta, batch = mppnet_width_case(config)
        compare_mppnet(dev, cfg, meta, batch, f"path R.0 small reference ({Path(config).stem} "
                       "at its widths, 2,000 points and 48 proposals a frame, f32)")
    torch.cuda.empty_cache()
    counts4, cfg4, meta4, seq4 = r_serve_mppnet(
        dev, smi, entries, calls, "R.1 (mppnet_4frames)", R_MPP4_CONFIG, points, "R:nms_mpp4")
    counts16, cfg16, meta16, seq16 = r_serve_mppnet(
        dev, smi, entries, calls, "R.2 (mppnet_16frames)", R_MPP16_CONFIG, points, "R:nms_mpp16",
        timed=2, stage_iters=1)  # 2.4 s a batch
    out.update({"R:nms_mpp4": counts4["nms"], "R:nms_mpp16": counts16["nms"]})
    del seq16["frames"]
    r_train_mppnet(dev, smi, "R.3 (mppnet_4frames)", cfg4, meta4, seq4)
    r_train_mppnet(dev, smi, "R.3 (mppnet_16frames)", cfg16, meta16, seq16)
    del seq16
    torch.cuda.empty_cache()
    mpp, _, _ = r_first_stage(dev, smi, seq4)
    r_serve_mppnet(dev, smi, [], [], "R.4 (mppnet_4frames over centerpoint_4frames' boxes)",
                   R_MPP4_CONFIG, points, "R:nms_mpp4", batch=mpp)
    print("  R.4: the weights are random, so most of the first stage's boxes link to none "
          "in a past frame (a trajectory of length 1)")
    del seq4, mpp
    torch.cuda.empty_cache()
    out.update(r5_configs(dev, smi, entries, calls, points, grid, voxel_range, bg_points))
    print(f"path R: {time.perf_counter() - start:.1f} s wall in all")
    return out


def r5_configs(dev, smi, entries, calls, points=POINTS, grid=None, voxel_range=None,
               bg_points=120000):
    """R.5: the seven Waymo configs besides centerpoint_4frames (``path_r``).
    Returns the launch counts of the kernel entries it adds."""
    out = {}
    rng = np.random.RandomState(77)
    for label, config in R_OTHER_VOXEL:
        cfg, meta, batch = r_small_voxel(config)
        compare_eval_step(dev, cfg, meta, batch, f"path {label} small reference (64x64x40 f32, "
                          "eval step, card vs CPU)", prepare=spread_center_scores)
        cfg, meta, proc = load_voxel(config, voxel_range)
        b = waymo_like_batch(rng, R_BATCH, points, meta.point_cloud_range, (0.32, 0.32, 6.0),
                             len(meta.class_names))
        q_serve(dev, smi, label, cfg, meta, [voxelize_batch(b, meta, proc, "test")],
                EXPECT_R_VOXEL_SERVING, lambda n: n)
        torch.cuda.empty_cache()
        r_train_config(dev, smi, label, cfg, meta, voxelize_batch(b, meta, proc, "train"),
                       EXPECT_R_VOXEL_TRAIN)
    label = "R.5 (centerpoint_pillar.yaml)"
    cfg, meta = load_config(grid=(64, 64, 1), config=R_PILLAR_CONFIG)
    cfg.MODEL.MIXED_PRECISION = False
    pts = waymo_like_points(np.random.RandomState(78), BATCH, 4096, meta.point_cloud_range)
    compare_eval_step(dev, cfg, meta, {"points": pts, "points_mask": np.ones((BATCH, 4096), bool)},
                      f"path {label} small reference (64x64 f32, eval step, card vs CPU)",
                      prepare=spread_center_scores)
    cfg, meta = load_config(grid, R_PILLAR_CONFIG)
    b = waymo_like_batch(rng, BATCH, points, meta.point_cloud_range, meta.voxel_size, 3)
    q_serve(dev, smi, label, cfg, meta, [b], EXPECT_R_PILLAR_SERVING, lambda n: n)
    torch.cuda.empty_cache()
    r_train_config(dev, smi, label, cfg, meta, b, EXPECT_R_PILLAR_TRAIN)
    com_counts = r_com_configs(dev, smi, entries, calls, grid, points, bg_points)
    out.update({f"R:{k}": v for k, v in com_counts.items() if k.startswith("stamp")})
    prcnn_serve, _ = r_pointrcnn(dev, smi, entries, calls)
    out["R:nms_prcnn"] = prcnn_serve["nms"]
    return out


S_DIR = REPO / "build" / "path_s"  # path S's tree, rehearsal and test outputs, removed after it
S_SEED = 24
S_TRAIN_FRAMES, S_VAL_FRAMES = 20, 4  # a train sequence's frames (2 sequences), the val one's
S_OBJECTS = (30, 60)
S_EPOCHS = 3  # the flagship's feedback loop: epochs, then one more resumed
S_REHEARSAL = (3, 5)  # the rehearsal's epochs, and again at 5 where a bar is not met at 3
EXPECT_SYNTH_TRAIN = {"seg_scan": 2, "seg_scan_bwd": 1, "conv3x3": 5, "conv3x3_dgrad": 5,
                      "conv3x3_wgrad": 5, "stamp_gauss": 1, "stamp_last_wins": 1}
S_DB = "waymo_dbinfos_train.pkl"
S_ANNOTATED = "waymo_dbinfos_train_annotated.pkl"
S_GROUPS = {"Vehicle": 96, "Pedestrian": 15, "Cyclist": 15}


def s_yaml(path, cfg, tree, db_info=None):
    """A YAML of the flagship's CLASS_NAMES, MODEL, OPTIMIZATION and
    DATA_CONFIG, the last with DATA_PATH ``tree`` (and DB_INFO_PATH
    ``[db_info]`` where given) and nothing else changed."""
    import yaml

    data_cfg = _plain(cfg.DATA_CONFIG)
    data_cfg["DATA_PATH"] = str(tree)
    if db_info is not None:
        (aug,) = [a for a in data_cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"]
                  if a["NAME"] == "gt_sampling"]
        aug["DB_INFO_PATH"] = [db_info]
    path.write_text(yaml.safe_dump({
        "CLASS_NAMES": list(cfg.CLASS_NAMES), "DATA_CONFIG": data_cfg,
        "MODEL": _plain(cfg.MODEL), "OPTIMIZATION": _plain(cfg.OPTIMIZATION)}))
    return path


def s1_prepare(smi, cfg, root, points):
    """S.1: the Waymo tree and its COM database through the port's
    ``create_data`` CLI (create_gt_database, annotate_database,
    integrate_database), each entry checked; the COM2 sampler's 96 / 15
    groups from the annotated pickle.  Returns the rehearsal's YAML."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.data.augmentor.database_sampler import DataBaseSamplerCOM2
    from com_tpu_torch.tools import create_data
    from com_tpu_torch.tools.dataset_trees import write_waymo_tree
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    tree, secs = root / "tree", {}
    t0 = time.perf_counter()
    out = write_waymo_tree(tree, seed=S_SEED, num_train=S_TRAIN_FRAMES, num_val=S_VAL_FRAMES,
                           num_points=points, objects=S_OBJECTS)
    secs["write_waymo_tree"] = time.perf_counter() - t0
    prep = s_yaml(root / "flagship_path_s_prepare.yaml", cfg, tree)
    db = tree / S_DB
    for func, argv in (("create_gt_database", ["--cfg_file", str(prep)]),
                       ("annotate_database", ["--db_info_path", str(db)]),
                       ("integrate_database", ["--db_info_path", str(tree / S_ANNOTATED)])):
        t0 = time.perf_counter()
        create_data.main(["--func", func, *argv])
        secs[func] = time.perf_counter() - t0
    with open(tree / S_ANNOTATED, "rb") as f:
        ann = pickle.load(f)
    bad = []
    for name, entries in ann.items():
        for e in entries:
            occ, fac = e["occupancy_ratio"], e["facade_type"]
            pts = np.fromfile(tree / e["path"], np.float32).reshape(-1, FEATS)
            if not (0 <= occ <= 1 and round(occ * 12) == occ * 12
                    and fac in ((0, 1, 2, 3) if name == "Vehicle" else (-1,))
                    and e["num_points_in_gt"] == len(pts)):
                bad.append((name, e["path"], occ, fac, e["num_points_in_gt"], len(pts)))
    frames = sum(out["frames"][q] for q in out["train"])
    print(f"path S.1: Waymo tree of {len(out['train'])} train sequences x {S_TRAIN_FRAMES} "
          f"frames and {len(out['val'])} val x {S_VAL_FRAMES}, {points} points a frame; "
          f"create_data: {json.dumps({k: len(v) for k, v in ann.items()})} entries from the "
          f"{frames // 5} frames SAMPLED_INTERVAL 5 keeps of {frames}; seconds "
          f"{json.dumps({k: round(v, 2) for k, v in secs.items()})} (host, {smi})")
    for name, entries in ann.items():
        occ = np.bincount([round(e["occupancy_ratio"] * 12) for e in entries], minlength=13)
        fac = {int(k): int(v) for k, v in zip(*np.unique([e["facade_type"] for e in entries],
                                                         return_counts=True))}
        print(f"  {name}: occupancy k/12 for k=0..12 {occ.tolist()}; facade {json.dumps(fac)}")
    ok = not bad and set(ann) == set(S_GROUPS) and all(ann.values())
    print(f"  every entry: occupancy on the 1/12 lattice in [0, 1], facade_type in "
          f"{{-1, 0, 1, 2, 3}} (-1 exactly off Vehicle), num_points_in_gt its .bin's points "
          f"{'ok' if ok else f'FAIL {bad[:5]}'}")
    if not ok:
        raise AssertionError("path S.1: the annotated database failed its checks")
    glob = np.load(tree / "waymo_dbinfos_train_annotated_global.npy")
    if len(glob) != sum(e["num_points_in_gt"] for v in ann.values() for e in v):
        raise AssertionError("path S.1: the integrated array is not the entries' points")

    rehearsal_yaml = s_yaml(root / "flagship_path_s.yaml", cfg, tree, db_info=S_ANNOTATED)
    rcfg = cfg_from_yaml_file(str(rehearsal_yaml))
    ds, _ = build_dataloader(rcfg.DATA_CONFIG, list(rcfg.CLASS_NAMES), BATCH, training=True,
                             workers=1)
    sampler = ds.data_augmentor.gt_sampler
    sizes = {c: [len(g) for g in sampler.sample_groups[c]["indices"]] for c in S_GROUPS}
    ok = isinstance(sampler, DataBaseSamplerCOM2) and all(
        len(sizes[c]) == n and sum(sizes[c]) > 0 for c, n in S_GROUPS.items())
    for c, s in sizes.items():
        print(f"  COM2 groups {c}: {len(s)} groups, {sum(1 for x in s if x)} non-empty, "
              f"{sum(s)} entries: {s}")
    print(f"path S.1: the flagship's COM2 sampler from {S_ANNOTATED} forms its 96 / 15 / 15 "
          f"groups {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path S.1: the COM2 sampler's groups")
    return rehearsal_yaml, rcfg


def s_host_rate(smi, rcfg, points):
    """Scenes a second of the flagship's training pipeline from disk
    (WaymoDataset, the COM2 paste, augmentations, range mask, presort,
    collate) with 1 and 2 loader threads: 2 epochs, the first batch
    untimed."""
    from com_tpu_torch.data import build_dataloader

    rates = {}
    for workers in (1, 2):
        _, loader = build_dataloader(rcfg.DATA_CONFIG, list(rcfg.CLASS_NAMES), BATCH,
                                     training=True, workers=workers, seed=S_SEED)
        n, t0 = 0, None
        for epoch in range(2):
            loader.set_epoch(epoch)
            for batch in loader:
                if t0 is None:
                    t0 = time.perf_counter()
                else:
                    n += 1
                if batch["points"].shape != (BATCH, rcfg.DATA_CONFIG.MAX_POINTS_PER_SCENE, FEATS):
                    raise AssertionError(f"path S: a batch of {batch['points'].shape}")
        rates[workers] = BATCH * n / (time.perf_counter() - t0)
    print(f"path S host rate of WaymoDataset from disk ({points} points a frame, the flagship's "
          f"train pipeline): {rates[1]:.2f} scenes/s with 1 loader thread, {rates[2]:.2f} with 2 "
          f"(host clock, {smi})")
    return rates


def s_train_runner(dev, record, expect=EXPECT_TRAIN):
    """A ``train(argv)`` for the rehearsal: the port's train CLI in-process
    (``train.main``), its launches counted against ``expect`` a step, CUDA
    events after each step, and on a resume the dataset's sampler checked
    against the checkpoint it started from, bitwise.  Each run appends
    {"steps", "start_epoch", "step_ms", "resume", "ckpt_dir", "confidence"
    (the dataset's sampler's at the end)} to ``record``."""
    from com_tpu_torch.tools import train

    def run(argv):
        marks, seen = [], {}

        def hook(epoch, it, metrics):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((epoch, ev))

        def on_start(info):
            seen["dataset"] = info["dataset"]
            payload = info["payload"]
            if payload is not None:
                conf = info["dataset"].data_augmentor.gt_sampler.confidence_groups
                want = payload["sampler"]["confidence_groups"].cpu().numpy()
                seen["resume"] = (conf is not None and conf.dtype == want.dtype
                                  and conf.tobytes() == want.tobytes())

        reset_counters()
        out = train.main(argv, on_start=on_start, metric_hook=hook)
        torch.cuda.synchronize()
        steps = out["iterations"] - out["start_iter"]
        check_launches("S train step (train CLI)", read_counters(), expect, steps)
        record.append({"steps": steps, "start_epoch": out["start_epoch"],
                       "step_ms": [a.elapsed_time(b) for (ea, a), (eb, b)
                                   in zip(marks, marks[1:]) if ea == eb],
                       "resume": seen.get("resume"), "ckpt_dir": out["ckpt_dir"],
                       "confidence": seen["dataset"].data_augmentor.gt_sampler.confidence_groups})
        return out

    return run


def s_resumed_ok(first, resumed, epochs):
    """The resume started at ``epochs`` with the sampler's confidences
    bitwise the file's, and the dataset's sampler ends holding the resumed
    epoch's confidences (the file ``checkpoint_epoch_{epochs + 1}.pth``)."""
    from com_tpu_torch.tools.com_rehearsal import checkpoint_confidences

    last = first["ckpt_dir"] / f"checkpoint_epoch_{epochs + 1}.pth"
    held, want = resumed["confidence"], checkpoint_confidences(last)
    return last, (resumed["resume"] is True and resumed["start_epoch"] == epochs
                  and held is not None and held.tobytes() == want.tobytes())


def s2_feedback(dev, smi, rehearsal_yaml, root):
    """S.2: the flagship's feedback loop over the tree through the train CLI
    on the card, as the rehearsal drives it (``com_rehearsal.train_argv``):
    S_EPOCHS epochs, then one more as a resume.  Each epoch's (3, 96)
    confidences reach the dataset's COM2 sampler (the resume checked
    bitwise against the file, the sampler at the end holding the last
    epoch's), and the rehearsal's table of the group distribution a fed
    epoch (``distribution_report`` over ``sampler_for``), every fed epoch
    off the size prior.  The rehearsal's L1 > 0.05 bar is not this path's:
    at this size the flagship moves the draw by ~0.001 (120 steps: 0.03-0.05;
    ``com_tpu_torch/tools/perf/rehearsal_scale.py``); ``s2_rehearsal`` holds
    the bars.  Returns the resumed epoch's file."""
    from com_tpu_torch.tools import com_rehearsal
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    out_dir, record = root / "feedback", []
    run = s_train_runner(dev, record)
    run(com_rehearsal.train_argv(rehearsal_yaml, S_EPOCHS, out_dir, str(dev)))
    saved = record[0]["ckpt_dir"] / f"checkpoint_epoch_{S_EPOCHS}.pth"
    before = com_rehearsal.checkpoint_confidences(saved)
    run(com_rehearsal.train_argv(rehearsal_yaml, S_EPOCHS + 1, out_dir, str(dev)))
    first, resumed = record
    last, ok = s_resumed_ok(first, resumed, S_EPOCHS)
    ok = ok and before.tobytes() == com_rehearsal.checkpoint_confidences(saved).tobytes()
    cfg = cfg_from_yaml_file(str(rehearsal_yaml))
    names = list(cfg.CLASS_NAMES)
    sampler = com_rehearsal.sampler_for(cfg)
    rows = []
    for ep, path in com_rehearsal.epoch_checkpoints(out_dir).items():
        conf = com_rehearsal.checkpoint_confidences(path)
        ok = ok and conf.shape == (len(names), 96) and bool(np.isfinite(conf).all())
        sampler.epoch, sampler.confidence_groups = ep, conf
        rows.append({"epoch": ep, "conf_mean": float(conf.mean()),
                     "dist": com_rehearsal.distribution_report(sampler, names)})
    l1 = [[d["l1_from_size_prior"] for d in r["dist"].values()] for r in rows]
    ok = ok and len(rows) == S_EPOCHS + 1 and all(min(x) > 0 for x in l1)
    step_ms = first["step_ms"] + resumed["step_ms"]
    print(f"path S.2 the flagship's feedback through the train CLI: {first['steps']} + "
          f"{resumed['steps']} steps ({S_EPOCHS} epochs and one resumed); the group "
          "distribution a fed epoch:")
    print("  | epoch | conf mean | class | entropy | top group | L1 vs size prior |")
    for line in com_rehearsal.report_rows(rows):
        print(f"  {line}")
    print(f"  confidences (3, 96) and finite every epoch, every fed epoch off the size prior, "
          f"the resume at epoch {resumed['start_epoch']} with the sampler's confidences "
          f"bitwise the file's (the file unchanged by it), the sampler ending on epoch "
          f"{S_EPOCHS + 1}'s {'ok' if ok else 'FAIL'}")
    print(f"  step time through the train CLI (CUDA events between steps, each epoch's first "
          f"left out): mean {np.mean(step_ms):.3f} ms over {len(step_ms)} "
          f"{[round(x, 3) for x in step_ms]} ({smi})")
    if not ok:
        raise AssertionError("path S.2: the flagship's feedback loop")
    return last


def s2_rehearsal(dev, smi, root):
    """S.2: the port's rehearsal (``com_tpu_torch.tools.com_rehearsal``, its
    default config: ``centerpoint_synth_com.yaml``, 32 scenes, 16 steps an
    epoch) on the card through the train CLI in-process, at S_REHEARSAL[0]
    epochs and, where a bar is not met, at S_REHEARSAL[1]: every bar, the
    per-epoch table (printed by the tool), its launches a step and step
    times, the resume bitwise, the sampler ending on the resumed epoch's
    confidences."""
    from com_tpu_torch.tools import com_rehearsal

    for epochs in S_REHEARSAL:
        record = []
        try:
            result = com_rehearsal.main(["--epochs", str(epochs), "--device", str(dev),
                                         "--output_dir", str(root / "rehearsal")],
                                        train=s_train_runner(dev, record, EXPECT_SYNTH_TRAIN))
            break
        except AssertionError as e:
            print(f"path S.2: the rehearsal at {epochs} epochs missed a bar: {e}")
            if epochs == S_REHEARSAL[-1]:
                raise
    first, resumed = record
    _, ok = s_resumed_ok(first, resumed, epochs)
    ok = ok and first["steps"] == epochs * resumed["steps"] and result["conf_shape"] == (3, 96)
    step_ms = first["step_ms"] + resumed["step_ms"]
    print(f"path S.2 rehearsal ({Path(SYNTH_CONFIG).name}): bars met at {epochs} epochs (L1 > "
          f"0.05 at the last fed epoch, epoch-1 shift > 0, move > 0.01, the epoch-{epochs} file "
          f"unchanged by the resume, finite confidences); the resume at epoch "
          f"{resumed['start_epoch']} with the sampler's confidences bitwise the file's, the "
          f"sampler ending on epoch {epochs + 1}'s {'ok' if ok else 'FAIL'}; step time mean "
          f"{np.mean(step_ms):.3f} ms over {len(step_ms)} (CUDA events, {smi})")
    if not ok:
        raise AssertionError("path S.2: the rehearsal's resume or fed-back confidences")


def s3_test(dev, smi, cfg, rehearsal_yaml, last, root):
    """S.3: the test CLI on the resumed checkpoint over the val split
    (``--infer_time``), the numpy Waymo AP; path A's serving launches."""
    from com_tpu_torch.tools import test

    reset_counters()
    (res,) = test.main(["--cfg_file", str(rehearsal_yaml), "--ckpt", str(last), "--infer_time",
                        "--device", str(dev), "--output_dir", str(root / "test")])
    torch.cuda.synchronize()
    annos = res["det_annos"]
    check_launches("S eval forward (test CLI)", read_counters(), EXPECT_SERVING,
                   res["infer_batches"] + 1 + -(-len(annos) // BATCH))
    names = list(cfg.CLASS_NAMES)
    result = res["result"]
    aps = {k: round(v, 4) for k, v in result.items() if k.endswith(("/AP", "/APH"))}
    ok = (len(annos) == S_VAL_FRAMES and "TF-free" in res["result_str"]
          and all(np.isfinite(a["boxes_lidar"]).all() and np.isfinite(a["score"]).all()
                  and (np.diff(a["score"]) <= 0).all()
                  and set(a["pred_labels"].tolist()) <= set(range(1, len(names) + 1))
                  for a in annos)
          and aps and all(np.isfinite(v) and 0 <= v <= 1 for v in aps.values()))
    print(f"path S.3 test CLI: {len(annos)} val frames, detections a frame "
          f"{[len(a['score']) for a in annos]}, {res['sec_per_frame']:.4f} s a frame (eval_model, "
          f"host clock), --infer_time {res['infer_ms_per_frame']:.3f} ms a frame ({smi}); "
          f"Waymo AP (numpy) {json.dumps(aps)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path S.3: the test CLI failed its checks")


def path_s(dev, smi, points=POINTS):
    """Path S: the flagship from raw frames, as a user prepares and trains
    it on Waymo (``com_tpu_torch.tools``: ``dataset_trees.write_waymo_tree``,
    ``create_data``, the train CLI, ``com_rehearsal``, the test CLI), at
    full width from the flagship's own DATA_CONFIG with only DATA_PATH and
    DB_INFO_PATH set.  S.1 (``s1_prepare``): a seeded Waymo tree of 2 train
    sequences of 20 frames (8 after SAMPLED_INTERVAL 5: 4 steps an epoch)
    and a val sequence of 4, ``points`` a frame, 30-60 objects; the
    database created, annotated and integrated, and checked; the COM2
    sampler's groups.  The WaymoDataset pipeline's host rate.  S.2
    (``s2_feedback``, ``s2_rehearsal``): the flagship's feedback loop and
    the rehearsal with its bars, on the card, their tables, launches and
    step times.  S.3 (``s3_test``): the test CLI and its Waymo AP.  Peak
    memory.  Everything is written under ``build/path_s`` and removed."""
    import shutil

    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / CONFIG))
    shutil.rmtree(S_DIR, ignore_errors=True)
    S_DIR.mkdir(parents=True)
    try:
        _quiet_cli_logger()
        rehearsal_yaml, rcfg = s1_prepare(smi, cfg, S_DIR, points)
        s_host_rate(smi, rcfg, points)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        last = s2_feedback(dev, smi, rehearsal_yaml, S_DIR)
        s3_test(dev, smi, cfg, rehearsal_yaml, last, S_DIR)
        print(f"path S peak memory (S.2's flagship and S.3) "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB ({smi})")
        s2_rehearsal(dev, smi, S_DIR)
    finally:
        shutil.rmtree(S_DIR, ignore_errors=True)


# ---- path T: two-stage training under a data mesh ----

T_DIR = REPO / "build" / "path_t"  # the ranks' results, removed after the path
T_RANKS, T_BATCH, T_SEED = 2, 2, 25  # ranks on the card, scenes a rank
T_TERMS = ("rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rcnn_loss_cls", "rcnn_loss_reg",
           "rcnn_loss_corner")
# the ranks against one process over the global batch, f32 with every norm's
# bias +3 (the repo's setting for whole-model gradient comparisons): a rank's
# norms sum its rows and the all-reduce adds the partial sums, and the card's
# GEMMs may tile two scenes otherwise than four, so the sums round apart:
T_LOSS_RTOL = 1e-4  # the loss and each term
T_STATS_TOL = 1e-3  # ``stat_err`` of the running statistics
T_GRAD_RTOL = 1e-3  # the whole net's gradient, relative L2 norm of the difference


def t_case(pc_range=None, points=E_POINTS, real_points=E_REAL_POINTS):
    """``voxel_rcnn_car.yaml`` at full width in f32 and one global batch of
    T_RANKS x T_BATCH KITTI-like scenes."""
    cfg, meta, proc = load_voxel(VOXEL_RCNN_CONFIG, pc_range)
    cfg.MODEL.MIXED_PRECISION = False
    batch = kitti_voxel_batches(np.random.RandomState(T_SEED), meta, proc, "train", 1,
                                T_RANKS * T_BATCH, points, real_points)[0]
    return cfg, meta, batch


def t_step(dev, case, mesh=None):
    """``case``'s model (seeded weights, scores spread, GT on the model's own
    proposals, norm biases +3) on its batch or, under ``mesh``, on the
    rank's rows.  First the compared step: ``loss_fn`` with deterministic
    RoI sampling and dropout off (a random draw is a slot's: a near-tie in
    the proposals' scores, ordered otherwise by a rounding, would hand a
    slot's draw to another RoI), backward and the reduction over the
    ranks: loss, terms, foreground RoIs, gradients, running statistics,
    launches.  Then the whole ``train_step`` with its seeded RoI sampling
    and the YAML's dropout: its loss and the step's all-reduces (bytes)."""
    from com_tpu_torch.models.roi_heads.fc import Dropout
    from com_tpu_torch.parallel.mesh import shard_batch
    from com_tpu_torch.parallel.sharding import reduce_gradients
    from com_tpu_torch.train.step import device_batch_keys

    cfg, meta, batch = case
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    net, _, state, step = build_trainer(dev, cfg, meta, 1, seed=T_SEED)
    shift_norm_biases(follow_proposals(spread_anchor_scores(net)))
    fg = []
    net.roi_head.register_forward_pre_hook(lambda m, args: fg.append(
        int(args[0]["roi_targets"].reg_valid.sum())) if "roi_targets" in args[0] else None)
    keys = device_batch_keys(cfg.MODEL)
    dev_batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items() if k in keys}
    drops = [(m, m.p) for m in net.modules() if isinstance(m, Dropout)]
    for m, _ in drops:
        m.p = 0.0
    _sync(dev)
    reset_counters()
    loss, _, _, tb = step.loss_fn(state, dev_batch, 0)
    loss.backward()
    reduce_gradients(net.parameters())
    _sync(dev)
    out = dict(loss=float(loss.detach()), terms={k: float(tb[k]) for k in T_TERMS}, fg=fg[:1],
               counts=read_counters(),
               grads={k: p.grad.detach().float().cpu() for k, p in net.named_parameters()
                      if p.grad is not None},
               stats={k: v.cpu().clone() for k, v in net.state_dict().items()
                      if "running" in k})
    for m, p in drops:
        m.p = p
    log = []
    t0 = time.perf_counter()
    with counted_collectives(log):
        state, metrics = step(state, dev_batch, 0)
        _sync(dev)
    out.update(ms=1e3 * (time.perf_counter() - t0), collectives=[b for b, _ in log],
               step_loss=float(metrics["loss"]), step_fg=fg[1:], dropout=[p for _, p in drops])
    return out


def t_rank(mesh, out, pc_range, points, real_points):
    """A rank of path T (spawned): ``t_step`` on its scenes of the global
    batch; results to ``rank{r}.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.save(t_step(mesh.device, t_case(pc_range, points, real_points), mesh),
               Path(out) / f"rank{mesh.rank}.pt")


def t_check(one, ranks, smi):
    """The ranks bitwise alike; the compared step against one process over
    the global batch: the loss and terms (T_LOSS_RTOL), the foreground
    RoIs, the running statistics (T_STATS_TOL) and the gradient
    (T_GRAD_RTOL); the seeded whole step finite and alike on the ranks;
    the launches of the compared step and the all-reduces of a whole one."""
    a = ranks[0]
    for r in ranks[1:]:
        same = (r["loss"] == a["loss"] and r["terms"] == a["terms"]
                and all(torch.equal(r["grads"][k], v) for k, v in a["grads"].items())
                and all(torch.equal(r["stats"][k], v) for k, v in a["stats"].items()))
        if not same:
            raise AssertionError("path T: the ranks' loss, gradients or statistics differ")
    fails = []
    for name, want, got in [("loss", one["loss"], a["loss"])] + [
            (k, one["terms"][k], a["terms"][k]) for k in T_TERMS]:
        err = abs(got - want) / max(abs(want), 1e-6)
        print(f"  path T {name}: ranks {got:.6f}, one process {want:.6f}, rel err {err:.2e} "
              f"(<= {T_LOSS_RTOL:g})")
        if err > T_LOSS_RTOL and abs(got - want) > 1e-7:
            fails.append(name)
    seeded = [r["step_loss"] for r in ranks]
    print(f"  path T whole step (seeded RoI sampling, dropout {a['dropout']}): loss ranks "
          f"{seeded}, one process {one['step_loss']:.6f} (the RoIs a slot's draw picks follow "
          f"the proposals' order), foreground RoIs ranks {[r['step_fg'] for r in ranks]}")
    if len(set(seeded)) != 1 or not all(math.isfinite(x) for x in seeded + [one["step_loss"]]):
        fails.append("the seeded step's loss (ranks alike, finite)")
    fg = sum(r["fg"][0] for r in ranks)
    print(f"  path T foreground RoIs: ranks {[r['fg'][0] for r in ranks]} (sum {fg}), one "
          f"process {one['fg'][0]}")
    if fg != one["fg"][0] or fg == 0:
        fails.append("foreground RoIs")
    norms = sorted({k.rsplit(".", 1)[0] for k in one["stats"] if k.endswith("running_mean")})
    worst_stat = max(float(stat_err(a["stats"], one["stats"], n).max()) for n in norms)
    diff = sum(float(((a["grads"][k] - g) ** 2).sum()) for k, g in one["grads"].items())
    total = sum(float((g ** 2).sum()) for g in one["grads"].values())
    grad_err = math.sqrt(diff / max(total, 1e-30))
    worst_tensor = max(one["grads"], key=lambda k: float((a["grads"][k] - one["grads"][k]).abs()
                                                         .max() / one["grads"][k].abs().max()
                                                         .clamp_min(1e-30)))
    print(f"  path T running statistics: worst stat_err {worst_stat:.2e} (<= {T_STATS_TOL:g}); "
          f"gradient: relative L2 error {grad_err:.2e} (<= {T_GRAD_RTOL:g}), worst tensor "
          f"{worst_tensor}")
    if worst_stat > T_STATS_TOL:
        fails.append("running statistics")
    if grad_err > T_GRAD_RTOL:
        fails.append("gradients")
    per_step = [len(r["collectives"]) for r in ranks]
    print(f"path T: all-reduces a step {per_step[0]} a rank ({sum(a['collectives']) / 1e6:.3f} "
          f"MB), a rank's step {[round(r['ms'], 1) for r in ranks]} ms against one process "
          f"{one['ms']:.1f} ms over the global batch ({smi}); two ranks sharing one card over "
          "gloo are no scaling figure")
    for r, res in enumerate(ranks):
        check_launches(f"path T rank {r} step", res["counts"], EXPECT_J_TRAIN, 1)
    if fails:
        raise AssertionError(f"path T: the ranks disagree with one process on {fails}")


def path_t(dev, smi, entries, pc_range=None, points=E_POINTS, real_points=E_REAL_POINTS):
    """Path T, two-stage training under a data mesh: ``voxel_rcnn_car.yaml``
    at full width in f32, T_RANKS ranks spawned on the card over gloo (as
    path I), T_BATCH scenes a rank, one step against one process over the
    global batch of T_RANKS x T_BATCH (``t_step``); K2, dgrad and K2w in
    f32 at a rank's BEV shapes.  Returns a rank's launch counts (the
    compared step's forward and backward)."""
    import shutil

    from com_tpu_torch.parallel.launch import run_ranks

    shutil.rmtree(T_DIR, ignore_errors=True)
    T_DIR.mkdir(parents=True)
    try:
        one = t_step(dev, t_case(pc_range, points, real_points))
        check_launches("path T one process step", one["counts"], EXPECT_J_TRAIN, 1)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        run_ranks(t_rank, T_RANKS, args=(str(T_DIR), pc_range, points, real_points),
                  backend="gloo", device=str(dev), timeout_s=I_TIMEOUT_S, init_dir=T_DIR,
                  threads=I_THREADS)
        print(f"path T: {T_RANKS} ranks spawned on {dev} over gloo ran their step in "
              f"{time.perf_counter() - t0:.1f} s wall")
        ranks = [torch.load(T_DIR / f"rank{r}.pt", weights_only=False) for r in range(T_RANKS)]
        t_check(one, ranks, smi)
    finally:
        shutil.rmtree(T_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=J_CONV, dtypes=(torch.float32,), path="T:")
    check_conv3x3_backward(dev, entries, shapes=J_CONV, wgrad_dtypes=(torch.float32,),
                           dgrad_dtype=torch.float32, path="T:")
    return ranks[0]["counts"]


# ---- path U: the image models ----

U_DIR = REPO / "build" / "path_u"  # path U's tree, checkpoints and CLI outputs, removed after it
CADDN_CONFIG = "configs/kitti_models/CaDDN.yaml"
FOCAL_CONFIG = "configs/kitti_models/voxel_rcnn_car_focal_multimodal.yaml"
U_BATCH, U_SEED = 2, 25
U_IMAGE = (375, 1242)  # KITTI's camera images
U_CADDN_CONV = ((2, 188, 140, 64), (2, 94, 70, 128), (2, 47, 35, 256))  # its BEV blocks' K2
# SemSegEncoder's stride-1 conv at the collate's padded 384 x 1280 and at the
# unpadded 375 x 1242 (an odd width)
U_SEMSEG_CONV = ((2, 96, 320, 64), (2, 94, 311, 64))
EXPECT_U_CADDN_SERVING = {"conv3x3": 30, "nms": 1}
EXPECT_U_CADDN_TRAIN = {"conv3x3": 30, "conv3x3_dgrad": 30, "conv3x3_wgrad": 30}
EXPECT_U_FOCAL_SERVING = {"conv3x3": 12, "nms": 2}  # the BEV's 11 and SemSegEncoder's body
EXPECT_U_FOCAL_TRAIN = {"conv3x3": 12, "conv3x3_dgrad": 12, "conv3x3_wgrad": 12, "nms": 1}
U_TRAIN, U_VAL, U_TREE_POINTS = 8, 6, 120000
U_TERMS = T_TERMS + ("loss_box_of_pts",)
U_POOL_TOL = 1e-4  # U.4: the eval step of the unfolded-then-folded pool against the folded


def kitti_camera_batch(rng, b, meta, image=None, objects=12, m=64):
    """A camera batch as ``tests/test_caddn.py`` builds one, at KITTI's
    image size and calibration (``tools/kitti_tree``'s frame 000000):
    images and depth maps from the seed, GT boxes in the camera's view
    inside ``meta``'s range (KITTI's three classes) and their image boxes."""
    from com_tpu_torch.data.kitti.calibration import (boxes3d_kitti_camera_to_imageboxes,
                                                      boxes3d_lidar_to_kitti_camera,
                                                      calib_to_matricies)
    from com_tpu_torch.tools.kitti_tree import calibration

    image = image or U_IMAGE
    calib = calibration()
    l2c, c2i = calib_to_matricies(calib)
    pr = meta.point_cloud_range
    gt = np.zeros((b, m, 8), np.float32)
    g2 = np.zeros((b, m, 4), np.float32)
    for i in range(b):
        cls = rng.randint(0, 3, objects)
        x = rng.uniform(pr[0] + 4, pr[3] - 4, objects)
        y = rng.uniform(-0.45, 0.45, objects) * x
        gt[i, :objects, :3] = np.stack([x, y, np.full(objects, -1.0)], -1)
        gt[i, :objects, 3:6] = KITTI_SIZES[cls]
        gt[i, :objects, 6] = rng.uniform(-np.pi, np.pi, objects)
        gt[i, :objects, 7] = cls + 1
        g2[i, :objects] = boxes3d_kitti_camera_to_imageboxes(
            boxes3d_lidar_to_kitti_camera(gt[i, :objects, :7], calib), calib, image)
    return {"images": rng.rand(b, *image, 3).astype(np.float32),
            "depth_maps": rng.uniform(2.5, 45.0, (b, *image)).astype(np.float32),
            "image_shape": np.tile(np.array(image, np.int32), (b, 1)),
            "trans_lidar_to_cam": np.tile(l2c.astype(np.float32), (b, 1, 1)),
            "trans_cam_to_img": np.tile(c2i.astype(np.float32), (b, 1, 1)),
            "gt_boxes": gt, "gt_boxes2d": g2}


def caddn_small_case(seed=0):
    """``tests/test_caddn.py``'s small CaDDN (16 LID bins, 16 channels, a 32
    x 32 x 16 grid, one Car anchor) with post-processing, on a batch of 2
    built as that test builds one (64 x 96 images)."""
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.utils.config import CfgNode

    model = {
        "NAME": "CaDDN",
        "VFE": {"NAME": "ImageVFE", "DOWNSAMPLE_FACTOR": 4,
                "FFN": {"NAME": "DepthFFN",
                        "DISCRETIZE": {"mode": "LID", "num_bins": 16, "depth_min": 2.0,
                                       "depth_max": 30.0},
                        "CHANNEL_REDUCE": {"out_channels": 16},
                        "LOSS": {"NAME": "DDNLoss", "ARGS": {"weight": 3.0, "alpha": 0.25,
                                                            "gamma": 2.0, "fg_weight": 13,
                                                            "bg_weight": 1}}}},
        "MAP_TO_BEV": {"NAME": "Conv2DCollapse", "NUM_BEV_FEATURES": 32},
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1], "LAYER_STRIDES": [1],
                        "NUM_FILTERS": [32], "UPSAMPLE_STRIDES": [1],
                        "NUM_UPSAMPLE_FILTERS": [32]},
        "DENSE_HEAD": {"NAME": "AnchorHeadSingle", "USE_DIRECTION_CLASSIFIER": True,
                       "DIR_OFFSET": 0.78539, "NUM_DIR_BINS": 2,
                       "ANCHOR_GENERATOR_CONFIG": [
                           {"class_name": "Car", "anchor_sizes": [[4.0, 1.8, 1.6]],
                            "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [0],
                            "align_center": False, "feature_map_stride": 1,
                            "matched_threshold": 0.6, "unmatched_threshold": 0.45}],
                       "LOSS_CONFIG": {"LOSS_WEIGHTS": {"cls_weight": 1.0, "loc_weight": 2.0,
                                                        "dir_weight": 0.2,
                                                        "code_weights": [1.0] * 7}}},
        "POST_PROCESSING": {"SCORE_THRESH": 0.1, "NMS_CONFIG": {
            "MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
            "NMS_PRE_MAXSIZE": 256, "NMS_POST_MAXSIZE": 50}}}
    cfg = CfgNode({"CLASS_NAMES": ["Car"], "MODEL": model})
    rng = np.random.RandomState(seed)
    b, h, w = 2, 64, 96
    l2c = np.zeros((b, 4, 4), np.float32)
    l2c[:, 0, 1], l2c[:, 1, 2], l2c[:, 2, 0], l2c[:, 3, 3] = -1.0, -1.0, 1.0, 1.0
    c2i = np.zeros((b, 3, 4), np.float32)
    c2i[:, 0, 0] = c2i[:, 1, 1] = 60.0
    c2i[:, 0, 2], c2i[:, 1, 2], c2i[:, 2, 2] = w / 2, h / 2, 1.0
    batch = {"images": rng.rand(b, h, w, 3).astype(np.float32),
             "trans_lidar_to_cam": l2c, "trans_cam_to_img": c2i}
    meta = DatasetMeta(["Car"], (2.0, -8.0, -2.0, 18.0, 8.0, 2.0), (0.5, 0.5, 0.25),
                       (32, 32, 16), 0)
    return cfg, meta, batch


def focal_small_case(seed=0):
    """``tests/test_focal_multimodal.py``'s SECONDNet over the focal
    backbone (IMG_CHANNELS 8, focal convs at stages 0 and 1 beside the
    multimodal one) on 2 scenes of 2,000 points with their images (96 x
    160) and calibration, voxelized by the port's host voxelizer."""
    from com_tpu_torch.data.kitti.calibration import Calibration, calib_to_matricies
    from com_tpu_torch.models.detectors import DatasetMeta
    from com_tpu_torch.utils.config import CfgNode

    rng = np.random.RandomState(seed)
    pc_range, vsize = (0.0, -16.0, -2.0, 32.0, 16.0, 2.0), (0.5, 0.5, 0.1)
    meta = DatasetMeta(["Car"], pc_range, vsize, (64, 64, 40), 4)
    pts = np.concatenate([rng.uniform(1, 30, (2, 2000, 1)), rng.uniform(-14, 14, (2, 2000, 1)),
                          rng.uniform(-1.4, 1.4, (2, 2000, 1)), rng.rand(2, 2000, 1)],
                         -1).astype(np.float32)
    proc = {"MAX_NUMBER_OF_VOXELS": {"test": 1024}, "MAX_POINTS_PER_VOXEL": 5}
    batch = voxelize_batch({"points": pts, "points_mask": np.ones((2, 2000), bool)}, meta,
                           CfgNode(proc), "test")
    v2c = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]], np.float64)
    l2c, c2i = calib_to_matricies(Calibration({
        "P2": np.array([100.0, 0, 200, 0, 0, 100, 150, 0, 0, 0, 1, 0]),
        "R0_rect": np.eye(3).ravel(), "Tr_velo_to_cam": v2c.ravel()}))
    batch.update(images=rng.rand(2, 96, 160, 3).astype(np.float32),
                 image_shape=np.array([[96, 160], [90, 150]], np.int32),
                 trans_lidar_to_cam=np.stack([l2c, l2c]).astype(np.float32),
                 trans_cam_to_img=np.stack([c2i, c2i]).astype(np.float32),
                 noise_rot=np.array([0.0, 0.1], np.float32),
                 noise_scale=np.array([1.0, 1.02], np.float32),
                 flip_x=np.array([False, True]), flip_y=np.array([False, False]))
    model = {
        "NAME": "SECONDNet", "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "VoxelBackBone8xFocal", "USE_IMG": True, "IMG_CHANNELS": 8,
                        "CHANNELS": [8, 16, 32, 32], "VOXEL_CAPS": [1024, 512, 256, 128],
                        "FOCAL_STAGES": [0, 1], "FOCAL_THRESHOLD": 0.5, "SPAWN_CAP": 256},
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 32},
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1], "LAYER_STRIDES": [1],
                        "NUM_FILTERS": [32], "UPSAMPLE_STRIDES": [1],
                        "NUM_UPSAMPLE_FILTERS": [32]},
        "DENSE_HEAD": {"NAME": "AnchorHeadSingle", "USE_DIRECTION_CLASSIFIER": True,
                       "DIR_OFFSET": 0.78539, "NUM_DIR_BINS": 2,
                       "ANCHOR_GENERATOR_CONFIG": [
                           {"class_name": "Car", "anchor_sizes": [[4.7, 2.1, 1.7]],
                            "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [0],
                            "align_center": False, "feature_map_stride": 8,
                            "matched_threshold": 0.55, "unmatched_threshold": 0.4}],
                       "LOSS_CONFIG": {"LOSS_WEIGHTS": {"cls_weight": 1.0, "loc_weight": 2.0,
                                                        "dir_weight": 0.2,
                                                        "code_weights": [1.0] * 7}}},
        "POST_PROCESSING": {"SCORE_THRESH": 0.1, "NMS_CONFIG": {
            "MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
            "NMS_PRE_MAXSIZE": 256, "NMS_POST_MAXSIZE": 50}}}
    return CfgNode({"CLASS_NAMES": ["Car"], "MODEL": model}), meta, batch


def card_vs_cpu_forward(dev, cfg, meta, batch, label, keys, prepare=None):
    """The eval-mode forward of ``cfg`` (seeded weights, ``prepare(net)``
    applied) on ``batch`` on the card and on the CPU: each of ``keys``
    within 1e-4 of its largest magnitude.  (A detection comparison would
    hang on near-tied scores of random weights at the top-k and NMS cuts.)
    Returns both outputs."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.step import model_input_keys

    outs = []
    for d in (dev, "cpu"):
        net = build_network(cfg.MODEL, meta, device=d, seed=7)
        if prepare is not None:
            prepare(net)
        with torch.no_grad():
            outs.append(net({k: torch.as_tensor(batch[k], device=d)
                             for k in model_input_keys(cfg.MODEL) if k in batch}))
    for k in keys:
        got, want = outs[0][k].cpu(), outs[1][k]
        err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))
        print(f"{label} {k} {tuple(want.shape)}: max err {err:.2e} of its max (<= 1e-4)")
        if err > 1e-4:
            raise AssertionError(f"{label}: {k} differs on the card")
    return outs


def u1_small_references(dev):
    """Card against CPU in f32: CaDDN's forward (depth logits, voxel volume,
    BEV map, head), the focal model's with its norm biases +3 (seeded norms
    at identity shrink its activations layer by layer until the importance
    logits sit at 0, every focal decision on its threshold; then its focal
    convs' voxel sets exact, their importance, the volume, the head) and
    ``focal_split_and_spawn`` (exact, tied scores) at the focal YAML's
    stage-1 size."""
    from com_tpu_torch.ops.sparse import focal_split_and_spawn

    cfg, meta, batch = caddn_small_case()
    card_vs_cpu_forward(dev, cfg, meta, batch, "path U.1 small reference (CaDDN)",
                        ("depth_logits", "encoded_spconv_tensor", "spatial_features",
                         "cls_preds_raw", "box_preds_raw"))
    cfg, meta, batch = focal_small_case()
    card, cpu = card_vs_cpu_forward(dev, cfg, meta, batch,
                                    "path U.1 small reference (focal multimodal)",
                                    ("encoded_spconv_tensor", "cls_preds_raw", "box_preds_raw"),
                                    prepare=shift_norm_biases)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card["focal_coords"] + card["focal_valid"],
                                                       cpu["focal_coords"] + cpu["focal_valid"]))
    perr = max(float((a.cpu() - b)[v].abs().max())
               for a, b, v in zip(card["focal_probs"], cpu["focal_probs"], cpu["focal_valid"]))
    print(f"path U.1 focal convs' voxel sets card vs CPU: {'exact' if same else 'DIFFER'}, own "
          f"importance max err {perr:.2e} (<= 1e-5)")
    if not same or perr > 1e-5:
        raise AssertionError("path U.1: the focal convs' voxel sets differ on the card")
    gen = np.random.RandomState(U_SEED)
    b, v, c, grid = 2, 20000, 16, (41, 1600, 1408)
    coords = np.stack([gen.randint(0, 41, (b, v)), gen.randint(0, 1600, (b, v)),
                       gen.randint(0, 1408, (b, v))], -1).astype(np.int32)
    coords[:, :, 1:] = coords[:, :, 1:] // 8  # clustered: neighbours exist and collide
    valid = np.ones((b, v), bool)
    for i in range(b):
        valid[i] = False
        valid[i, np.unique(coords[i] @ np.array([1600 * 1408, 1408, 1]), return_index=True)[1]] \
            = True
    args = (gen.randn(b, v, c).astype(np.float32), coords, valid,
            np.round(gen.randn(b, v, 27) * 2).astype(np.float32))  # rounded: tied scores
    res = [focal_split_and_spawn(*(torch.as_tensor(a, device=d) for a in args), grid, 0.5, 2500)
           for d in (dev, "cpu")]
    exact = all(torch.equal(x.cpu(), y) for x, y in zip(res[0][1:3], res[1][1:3]))
    ferr = float((res[0][0].cpu() - res[1][0]).abs().max())
    spawned = int(res[1][2][:, v:].sum())
    print(f"path U.1 focal_split_and_spawn (2, {v}, {c}) cap 2500 card vs CPU: {spawned} spawned, "
          f"voxels and slots {'exact' if exact else 'DIFFER'}, features max err {ferr:.2e}")
    if not exact or ferr > 1e-6 or spawned == 0:
        raise AssertionError("path U.1: focal_split_and_spawn differs on the card")


def u2_caddn(dev, smi, entries, calls):
    """CaDDN.yaml at full width (80 LID bins, 64 channels, the 280 x 376 x 25
    grid of 0.16 m, 375 x 1242 images), batch 2 on a batch built as
    ``tests/test_caddn.py`` builds one (KITTI's calibration): 3 serving
    batches and their stages from the DDN to the final NMS; K4 on its
    three-class candidates (2, 4096) and K2 / dgrad / K2w at its BEV shapes
    in f32; 2 train steps with ``ddn_loss``; peak memory.  Returns the
    launch counts of the serving forward and of the steps."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, _ = load_voxel(CADDN_CONFIG)
    rng = np.random.RandomState(U_SEED)
    batches = [kitti_camera_batch(rng, U_BATCH, meta) for _ in range(3)]
    net = spread_anchor_scores(build_network(cfg.MODEL, meta, device=dev, seed=0))
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), meta, device=dev)
    step(batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    lat, outs = [], []
    for b in batches:
        t0 = time.perf_counter()
        outs.append([t.cpu().numpy() for t in step(b)])
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    ok = all(np.isfinite(bx[v]).all() and v.any() for bx, _, _, v in outs)
    print(f"path U.2 CaDDN serving (batch {U_BATCH}, 375 x 1242): latency ms a batch "
          f"{[round(x, 2) for x in lat]}, detections {[int(o[3].sum()) for o in outs]}, "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({smi}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path U.2: CaDDN's serving returned no or non-finite detections")
    check_launches("path U.2 CaDDN serving forward", counts, EXPECT_U_CADDN_SERVING, len(batches))
    stage_breakdown(net, step, batches[0], "path U.2 CaDDN ", iters=3, smi=smi,
                    inner=[("vfe", "ddn", net.vfe.ffn)])
    over, sv = e_decoded_candidates(net, cfg, meta, batches[0], dev)
    check_k4_cases(dev, entries, calls, over, sv, smi, ", path U.2 CaDDN candidates", "U:nms",
                   iters=10)
    del net, step, over, sv
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=U_CADDN_CONV, dtypes=(torch.float32,), path="U:")
    check_conv3x3_backward(dev, entries, shapes=U_CADDN_CONV, wgrad_dtypes=(torch.float32,),
                           dgrad_dtype=torch.float32, path="U:")
    torch.cuda.empty_cache()
    train_counts = u_train_steps(dev, smi, "U.2 (CaDDN)", cfg, meta, batches[:2],
                                 EXPECT_U_CADDN_TRAIN, ("rpn_loss_cls", "rpn_loss_loc",
                                                       "rpn_loss_dir", "ddn_loss"))
    return counts, train_counts


def u_train_steps(dev, smi, label, cfg, meta, batches, expect, terms):
    """A step on each of ``batches`` from seeded weights (scores spread):
    every term finite, ``ddn_loss`` / ``loss_box_of_pts`` > 0 where named,
    the step times (host clock, synced), peak memory, launches."""
    from com_tpu_torch.train.step import device_batch_keys

    net, _, state, step = build_trainer(dev, cfg, meta, len(batches), seed=0)
    spread_anchor_scores(net)
    keys = device_batch_keys(cfg.MODEL)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    ms, rows = [], []
    for b in batches:
        dev_b = {k: torch.as_tensor(v, device=dev) for k, v in b.items() if k in keys}
        t0 = time.perf_counter()
        state, metrics = step(state, dev_b, 0)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        rows.append({k: float(metrics[k]) for k in ("loss",) + tuple(terms)})
    counts = read_counters()
    peak = torch.cuda.max_memory_allocated(dev)
    ok = all(np.isfinite(list(r.values())).all() for r in rows) and all(
        r[k] > 0 for r in rows for k in ("ddn_loss", "loss_box_of_pts") if k in r)
    ok = ok and all(torch.isfinite(p).all() for p in net.parameters())
    print(f"path {label} train steps (batch {len(batches[0]['gt_boxes'])}): "
          f"{json.dumps([{k: round(v, 5) for k, v in r.items()} for r in rows])}, ms "
          f"{[round(x, 1) for x in ms]}, max_memory_allocated {peak / 2**30:.2f} GiB ({smi}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"path {label}: a train step is not finite or a term is 0")
    check_launches(f"path {label} train step", counts, expect, len(batches))
    return counts


def u_focal_cfg(tree):
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(REPO / FOCAL_CONFIG))
    cfg.DATA_CONFIG.DATA_PATH = str(tree)
    return cfg


def u3_focal(dev, smi, entries, calls, tree_points=U_TREE_POINTS, sets=()):
    """``voxel_rcnn_car_focal_multimodal.yaml`` from its own DATA_CONFIG over
    a KITTI tree with images written from the seed (``kitti_tree
    --images``): the loader's rate (2 threads, an epoch) and the pastes that
    survive the 2D prefilter; 3 serving batches of the val frames; 2 train
    steps (GT on the model's proposals); K2 and its backward in f32 at
    SemSegEncoder's shapes; then the train and test CLIs for one epoch
    (the KITTI AP line).  ``sets`` are --set pairs for a rehearsal.
    Returns the launch counts of the serving forward and of the steps."""
    from com_tpu_torch.data import build_dataloader
    from com_tpu_torch.tools import test, train
    from com_tpu_torch.tools.kitti_tree import write_kitti_tree
    from com_tpu_torch.tools.train import dataset_meta
    from com_tpu_torch.utils.config import cfg_from_list

    root = U_DIR / "kitti"
    t0 = time.perf_counter()
    write_kitti_tree(root, seed=U_SEED, num_train=U_TRAIN, num_val=U_VAL,
                     num_points=tree_points, images=True)
    print(f"path U.3 tree: {U_TRAIN} + {U_VAL} frames of {tree_points} points with 375 x 1242 "
          f"PNG images in {time.perf_counter() - t0:.2f} s")
    cfg = u_focal_cfg(root)
    if sets:
        cfg_from_list(list(sets), cfg)
    names = list(cfg.CLASS_NAMES)
    ds, loader = build_dataloader(cfg.DATA_CONFIG, names, U_BATCH, training=True, seed=3,
                                  workers=2)
    loader.set_epoch(0)
    t0 = time.perf_counter()
    train_batches = list(loader)
    rate = len(train_batches) * U_BATCH / (time.perf_counter() - t0)
    pastes = sum(int((b["true_object"] == 2).sum()) for b in train_batches)
    print(f"path U.3 loader (2 threads, images read by the port's PNG decoder, the image "
          f"copy-paste): {rate:.2f} scenes/s over {len(train_batches) * U_BATCH} scenes; "
          f"{pastes} pasted objects survive the 2D prefilter ({smi})")
    if pastes == 0 or train_batches[0]["images"].shape[1:] != (384, 1280, 3):
        raise AssertionError("path U.3: no paste survived, or the images are not batched")
    _, val_loader = build_dataloader(cfg.DATA_CONFIG, names, U_BATCH, training=False, seed=3,
                                     workers=2)
    val_batches = list(val_loader)
    meta = dataset_meta(cfg, ds)
    net, step, serve_counts = check_two_stage_serving(dev, "U.3 (focal multimodal, KITTI)", cfg,
                                                      meta, val_batches, EXPECT_U_FOCAL_SERVING,
                                                      smi)
    del net, step
    torch.cuda.empty_cache()
    check_conv3x3(dev, entries, shapes=U_SEMSEG_CONV, dtypes=(torch.float32,), path="U.3:")
    check_conv3x3_backward(dev, entries, shapes=U_SEMSEG_CONV, wgrad_dtypes=(torch.float32,),
                           dgrad_dtype=torch.float32, path="U.3:")
    torch.cuda.empty_cache()
    train_counts = two_stage_training(dev, "U.3 (focal multimodal, KITTI)", cfg, meta,
                                      train_batches[:2], EXPECT_U_FOCAL_TRAIN, U_TERMS, smi)
    torch.cuda.empty_cache()
    _quiet_cli_logger()
    base = ["--cfg_file", str(REPO / FOCAL_CONFIG), "--workers", "2", "--output_dir",
            str(U_DIR / "out"), "--batch_size", str(U_BATCH), "--device", str(dev)]
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(root), *sets]
    t0 = time.perf_counter()
    first = train.main(base + ["--epochs", "1", "--seed", "3"] + data)
    t_train = time.perf_counter() - t0
    ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
    t0 = time.perf_counter()
    (res,) = test.main(base + ["--ckpt", str(ckpt)] + data)
    line = res["result_str"].splitlines()[0]
    print(f"path U.3 CLIs: train 1 epoch ({first['iterations']} steps) {t_train:.1f} s, test "
          f"{len(res['det_annos'])} frames {time.perf_counter() - t0:.1f} s; {line}")
    if first["iterations"] != U_TRAIN // U_BATCH or not line.startswith("Car AP_bev R40"):
        raise AssertionError("path U.3: the train or test CLI did not run the focal config")
    return serve_counts, train_counts, meta


def pcdet_pool_state(net, rng):
    """``net``'s state dict in pcdet's Voxel-RCNN layout: each grid pool's
    ``pre`` unfolded into mlps_in / mlps_pos (Conv1d) with norms of seeded
    statistics (eps 1e-5) that fold back to it, ``out`` / ``out_bn`` as
    mlps_out and its norm (the running variance moved to eps 1e-5)."""
    sd = {k: v.detach().cpu().double() for k, v in net.state_dict().items()}
    out = {k: v.float() for k, v in sd.items() if ".roi_grid_pool_layers." not in k}
    for i in range(len(net.roi_head.roi_grid_pool_layers)):
        t = f"roi_head.roi_grid_pool_layers.{i}"
        pre_w, pre_b = sd[f"{t}.pre.weight"], sd[f"{t}.pre.bias"]
        mid = pre_w.shape[0]
        b_pos = None
        for name, cols in (("mlps_pos", slice(0, 3)), ("mlps_in", slice(3, None))):
            gamma = torch.from_numpy(rng.uniform(0.8, 1.2, mid))
            mean = torch.from_numpy(0.1 * rng.randn(mid))
            var = torch.from_numpy(rng.uniform(0.5, 1.5, mid))
            scale = gamma / torch.sqrt(var + 1e-5)
            if name == "mlps_pos":
                beta = torch.from_numpy(0.1 * rng.randn(mid))
                b_pos = beta - mean * scale  # the pos norm's share of pre's bias
            else:
                beta = pre_b - b_pos + mean * scale
            out[f"{t}.{name}.0.0.weight"] = (pre_w[:, cols] / scale[:, None])[..., None].float()
            for k, v in (("weight", gamma), ("bias", beta), ("running_mean", mean),
                         ("running_var", var)):
                out[f"{t}.{name}.0.1.{k}"] = v.float()
        out[f"{t}.mlps_out.0.0.weight"] = sd[f"{t}.out.weight"][..., None].float()
        for k in ("weight", "bias", "running_mean"):
            out[f"{t}.mlps_out.0.1.{k}"] = sd[f"{t}.out_bn.{k}"].float()
        out[f"{t}.mlps_out.0.1.running_var"] = (sd[f"{t}.out_bn.running_var"]
                                                + (1e-3 - 1e-5)).float()
    return out


def u4_pcdet_pool(dev, smi, tree, pc_range=None, points=E_POINTS, real_points=E_REAL_POINTS,
                  sets=()):
    """A pcdet-layout Voxel-RCNN state dict (``pcdet_pool_state`` of seeded
    weights) saved as a .pth and loaded by the train CLI's
    ``--pretrained_model`` (its ``on_start`` reads the net before the first
    step): the eval step on the card against the folded model's, detections
    within U_POOL_TOL."""
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.tools import train
    from com_tpu_torch.train.eval import make_eval_step

    cfg, meta, proc = load_voxel(VOXEL_RCNN_CONFIG, pc_range)
    names = list(cfg.CLASS_NAMES)
    batch = kitti_voxel_batches(np.random.RandomState(U_SEED), meta, proc, "test", 1, J_BATCH,
                                points, real_points)[0]
    folded = spread_anchor_scores(build_network(cfg.MODEL, meta, device=dev, seed=0))
    want = [t.cpu().numpy() for t in make_eval_step(folded, cfg.MODEL, names, meta,
                                                     device=dev)(batch)]
    path = U_DIR / "voxel_rcnn_pcdet.pth"
    torch.save({"model_state": pcdet_pool_state(folded, np.random.RandomState(U_SEED))}, path)
    del folded
    got = {}

    class Loaded(Exception):
        pass

    def on_start(info):
        net = info["state"].net.eval()
        got["out"] = [t.cpu().numpy() for t in make_eval_step(net, cfg.MODEL, names, meta,
                                                              device=dev)(batch)]
        raise Loaded

    _quiet_cli_logger()
    try:
        train.main(["--cfg_file", str(REPO / VOXEL_RCNN_CONFIG), "--workers", "1",
                    "--device", str(dev),
                    "--output_dir", str(U_DIR / "pcdet"), "--batch_size", str(J_BATCH),
                    "--epochs", "1", "--pretrained_model", str(path),
                    "--set", "DATA_CONFIG.DATA_PATH", str(tree), *sets], on_start=on_start)
    except Loaded:
        pass
    (wb, ws, wl, wv), (gb, gs, gl, gv) = want, got["out"]
    worst = max(float(np.abs(gb[gv] - wb[wv]).max()), float(np.abs(gs[gv] - ws[wv]).max())) \
        if wv.any() and (gv == wv).all() else math.inf
    ok = bool((gv == wv).all()) and wv.any() and worst <= U_POOL_TOL and (gl[gv] == wl[wv]).all()
    print(f"path U.4 pcdet-layout Voxel-RCNN pool through --pretrained_model: {int(gv.sum())} "
          f"detections, worst box/score diff {worst:.2e} against the folded model (<= "
          f"{U_POOL_TOL:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("path U.4: the folded pcdet pool disagrees with the port's")


def path_u(dev, smi, entries, calls, tree_points=U_TREE_POINTS, sets=None, pc_range=None):
    """Path U, the image models: U.1 the small references card against CPU;
    U.2 CaDDN at full width; U.3 the focal multimodal Voxel-RCNN from its
    own DATA_CONFIG over a seeded KITTI tree with images, through the CLIs;
    U.4 a pcdet-layout Voxel-RCNN state dict through ``--pretrained_model``.
    ``sets`` maps "U.3" and "U.4" to --set pairs and ``pc_range`` is U.4's
    range, for a rehearsal.  Returns the
    launch counts keyed as the ``kernels`` line reads them."""
    import shutil

    sets = sets or {}
    shutil.rmtree(U_DIR, ignore_errors=True)
    U_DIR.mkdir(parents=True)
    try:
        u1_small_references(dev)
        torch.cuda.empty_cache()
        caddn_serve, caddn_train = u2_caddn(dev, smi, entries, calls)
        torch.cuda.empty_cache()
        focal_serve, focal_train, _ = u3_focal(dev, smi, entries, calls, tree_points,
                                               sets.get("U.3", ()))
        torch.cuda.empty_cache()
        u4_pcdet_pool(dev, smi, U_DIR / "kitti", pc_range, sets=sets.get("U.4", ()))
    finally:
        shutil.rmtree(U_DIR, ignore_errors=True)
    return {**{f"U:{k}": v for k, v in caddn_train.items()}, "U:nms": caddn_serve["nms"],
            **{f"U.3:{k}": v for k, v in focal_train.items()}}


class Laps:
    """Wall seconds of each phase of ``main``, printed as each ends."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds = {}

    def __call__(self, label):
        now = time.perf_counter()
        self.seconds[label] = now - self.last
        print(f"phase time: {label} {now - self.last:.1f} s (total {now - self.start:.1f} s)",
              flush=True)
        self.last = now


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if sys.argv[1:2] == ["--device-kernels"]:
        count_device_kernels(sys.argv[2])
        return
    dev = torch.device("cuda", 0)
    profile = "--profile" in sys.argv[1:]
    lap = Laps()
    smi = phase_device_and_build()
    lap("build")
    entries = []
    check_seg_scan(dev, entries)
    check_seg_scan_bwd(dev, entries)
    # the flagship's f32 rows report path I.1's one-process f32 steps
    check_conv3x3(dev, entries, f32_path="I.f32:")
    check_conv3x3_backward(dev, entries, f32_path="I.f32:")
    check_conv3x3_backward(dev, entries, wgrad_dtypes=(), dgrad_dtype=torch.float32,
                           f32_path="I.f32:")
    check_wgrad_variants(dev, entries)
    sweep_counts = wgrad_sweep(dev)
    lap("kernels against plain, sweep")
    calls = []  # (label, device kernels a call, op, args, kw) for check_device_kernels
    check_stamp(dev, entries, calls)
    check_small_reference(dev)
    check_small_train_reference(dev)
    lap("K3, small references")
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
    lap("serving")
    a_counts, trainer = train_path(dev, CONFIG, "A (flagship)", 2, 3, (3, 96), EXPECT_TRAIN)
    step, dev_batch, _ = stage_and_overfit(dev, trainer)
    if profile:
        profile_train(trainer[2], step, dev_batch)
    del trainer, step, dev_batch
    torch.cuda.empty_cache()
    lap("A")
    b_counts, _ = train_path(dev, CAR_CONFIG, "B (car_com1, UCL)", 1, 2, (1, 96),
                             EXPECT_TRAIN_UCL)
    torch.cuda.empty_cache()
    lap("B")
    train_path_c(dev)
    lap("C")
    torch.cuda.empty_cache()
    path_d(dev, smi)
    lap("D")
    torch.cuda.empty_cache()
    e_serve_counts, e_train_counts = path_e(dev, smi, entries, calls)
    lap("E")
    torch.cuda.empty_cache()
    _, f_train_counts = path_f(dev, smi, entries, calls)
    lap("F")
    torch.cuda.empty_cache()
    g_serve_counts, g_train_counts = path_g(dev, smi, entries, calls)
    lap("G")
    torch.cuda.empty_cache()
    j_serve_counts, j_train_counts = path_j(dev, smi, entries, calls)
    lap("J")
    torch.cuda.empty_cache()
    path_k(dev, smi)
    lap("K")
    torch.cuda.empty_cache()
    path_h(dev, smi)
    lap("H")
    torch.cuda.empty_cache()
    i_counts = path_i(dev, smi)
    lap("I")
    torch.cuda.empty_cache()
    l_counts = path_l(dev, smi, entries, calls)
    lap("L")
    torch.cuda.empty_cache()
    m_serve_counts, m_train_counts = path_m(dev, smi, entries, calls)
    lap("M")
    torch.cuda.empty_cache()
    n_serve_counts, n_train_counts = path_n(dev, smi, entries, calls)
    lap("N")
    torch.cuda.empty_cache()
    o_serve_counts, o_train_counts = path_o(dev, smi, entries, calls)
    lap("O")
    torch.cuda.empty_cache()
    p_counts = path_p(dev, smi, entries, calls)
    lap("P")
    torch.cuda.empty_cache()
    q_counts = path_q(dev, smi, entries, calls)
    lap("Q")
    torch.cuda.empty_cache()
    r_counts = path_r(dev, smi, entries, calls)
    lap("R")
    torch.cuda.empty_cache()
    path_s(dev, smi)
    lap("S")
    torch.cuda.empty_cache()
    t_counts = path_t(dev, smi, entries)
    lap("T")
    torch.cuda.empty_cache()
    u_counts = path_u(dev, smi, entries, calls)
    lap("U")
    # each kernel's launches on the path that runs it: training path A (the
    # flagship's f32 K2, dgrad and K2w: path I.1's one-process f32 steps),
    # serving for K4, path B for K3's last_wins mode, the sweep for T1-T4;
    # paths E, F, G and J's shapes: their training, and their serving for
    # K4 (path J's train proposals: its training); path L's shapes: L.2's
    # steps and serving forward, L.4's test CLI; path M's: its training,
    # and its serving for K4; path N's: its serving (K4 twice a forward) and
    # its 2 steps; path O's: its 2 steps, and its serving for K4 (its train
    # proposals: the steps); path P's: P.2's 2 steps (K2, dgrad, K2w, K3, its
    # train proposals' K4) and serving (K4 twice a forward), P.3's serving
    # and P.4's stream for their final NMS; path Q's: Q.2's 2 steps (K1, its
    # backward, K2, dgrad, K2w, K3) and serving (K4 six times a forward), Q.3
    # Lyft's serving (K4); path R's: R.1 / R.2's MPPNet serving (K4 at the
    # final NMS), car_com2's 2 x 2 steps (K3 at (2, 1, 468, 468)), Waymo
    # PointRCNN's serving (K4 twice a forward); path T's: a rank's step (f32);
    # path U's: U.2 CaDDN's 2 steps and its serving (K4 once a forward), U.3's
    # 2 steps (SemSegEncoder's body among its K2 calls)
    counts = {**a_counts, "nms": serve_counts["nms"],
              "stamp_last_wins": b_counts["stamp_last_wins"],
              **{f"wgrad_{v}": sweep_counts[f"wgrad_{v}"] for v in WGRAD_VARIANTS},
              **{f"{p}:{k}": v for p, c in (("E", e_train_counts), ("F", f_train_counts),
                                            ("G", g_train_counts), ("J", j_train_counts),
                                            ("M", m_train_counts), ("O", o_train_counts))
                 for k, v in c.items()},
              "E:nms": e_serve_counts["nms"], "G:nms": g_serve_counts["nms"],
              "J:nms": j_serve_counts["nms"], "J:nms_train": j_train_counts["nms"], **l_counts,
              "M:nms": m_serve_counts["nms"], "N:nms": n_serve_counts["nms"],
              "N:nms_train": n_train_counts["nms"], "O:nms": o_serve_counts["nms"],
              "O:nms_train": o_train_counts["nms"],
              **{f"P:{k}": v for k, v in p_counts["train"].items()},
              "P:nms": p_counts["serve"]["nms"], "P:nms_train": p_counts["train"]["nms"],
              "P:nms_pv": p_counts["pv_serve"]["nms"], "P:nms_mpp": p_counts["mpp"]["nms"],
              **q_counts, **r_counts, **{f"T:{k}": v for k, v in t_counts.items()}, **u_counts,
              **{f"I.f32:{k}": v for k, v in i_counts.items()}}
    if not profile:
        check_device_kernels(calls)
    lap("device kernels")
    print(f"phase times: {json.dumps({k: round(v, 1) for k, v in lap.seconds.items()})}")
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
