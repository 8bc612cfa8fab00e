"""Shared setup of the two-stage slice tests (``tests/test_torch_port_two_
stage_*.py``; no tests here): Voxel-RCNN (``configs/kitti_models/
voxel_rcnn_car.yaml``) and SECOND-IoU (``configs/kitti_models/
second_iou.yaml``) narrowed as ``tests/test_voxelrcnn.py``'s config is
small, over ``test_torch_port_voxel_model.py``'s scenes (64 x 64 x 40 grid
of 0.5 x 0.5 x 0.1 m, 2,048 voxel slots, f32).

The narrowing: the first stage as ``test_torch_port_voxel_model.narrow``;
the RoI head's FCs [32, 32]; Voxel-RCNN pooling x_conv3 and x_conv4 (2
scales) on a 3^3 grid, MLPS [[16, 16]], query range 2, NSAMPLE 8;
SECOND-IoU a 3 x 3 grid; 256 -> 64 proposals in training, 32 in eval, 16
RoIs a scene.  The JAX variables are perturbed from a seed (norm biases
+3), the anchor head's class bias raised by 4 and its box kernel shrunk
50-fold (scores spread, boxes near their anchors), and carried into the
port by the weight bridge.  The GT are Cars (and, for SECOND-IoU, the other classes) placed on
anchors with their sizes and headings, so that proposals match them.
"""
from pathlib import Path

import numpy as np

from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.utils.config import cfg_from_yaml_file
from com_tpu_torch.models.dense_heads.anchor_head import build_anchors
from com_tpu_torch.models.detectors import build_network
from com_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_voxel_model import jax_variables, metas, narrow, scenes

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"voxel_rcnn": "configs/kitti_models/voxel_rcnn_car.yaml",
           "second_iou": "configs/kitti_models/second_iou.yaml"}


def small_cfg(which, dp_ratio=0.0):
    cfg = narrow(cfg_from_yaml_file(str(REPO / CONFIGS[which])))
    r = cfg.MODEL.ROI_HEAD
    r.DP_RATIO = dp_ratio
    r.SHARED_FC = [32, 32]
    if which == "voxel_rcnn":
        r.CLS_FC, r.REG_FC = [32, 32], [32, 32]
        pool = r.ROI_GRID_POOL
        pool.FEATURES_SOURCE, pool.GRID_SIZE = ["x_conv3", "x_conv4"], 3
        for src, radius in (("x_conv3", 1.2), ("x_conv4", 2.4)):
            pool.POOL_LAYERS[src].update(MLPS=[[16, 16]], QUERY_RANGES=[[2, 2, 2]],
                                         POOL_RADIUS=[radius], NSAMPLE=[8])
    else:
        r.IOU_FC = [32, 32]
        r.ROI_GRID_POOL.GRID_SIZE = 3
    for mode, post in (("TRAIN", 64), ("TEST", 32)):
        r.NMS_CONFIG[mode].update(NMS_PRE_MAXSIZE=256, NMS_POST_MAXSIZE=post)
    r.TARGET_CONFIG.ROI_PER_IMAGE = 16
    return cfg


def anchor_gt(cfg, meta, rng, b, m=16, real=12):
    """(b, m, 8) GT: ``real`` anchors a scene taken as boxes (a few cm off),
    class ids of their anchors."""
    names = list(cfg.CLASS_NAMES)
    anchors, index, _, _, class_ids = build_anchors(cfg.MODEL.DENSE_HEAD, names, meta.grid_size,
                                                    meta.point_cloud_range)
    cls_of = np.zeros(len(anchors), np.int32)
    for idx, cid in zip(index, class_ids):
        cls_of[idx] = cid
    gt = np.zeros((b, m, 8), np.float32)
    for i in range(b):
        pick = rng.choice(len(anchors), real, replace=False)
        gt[i, :real, :7] = anchors[pick]
        gt[i, :real, :3] += rng.uniform(-0.05, 0.05, (real, 3))
        gt[i, :real, 7] = cls_of[pick]
    return gt


def setup(which, seed, dp_ratio=0.0):
    """(cfg, jmeta, pmeta, jnet, variables, net, host) for ``which``."""
    host, pc_range, vsize = scenes(seed=seed)
    cfg = small_cfg(which, dp_ratio)
    jmeta, pmeta = metas(cfg, pc_range, vsize)
    rng = np.random.RandomState(seed + 100)
    gt = anchor_gt(cfg, pmeta, rng, host["gt_boxes"].shape[0])
    real = gt[..., 7] > 0
    host.update(gt_boxes=gt, num_points_in_gt=real.astype(np.float32) * 10,
                true_object=real.astype(np.float32))
    # raw points for SCORE_TYPE num_pts_iou_cls (the voxel model reads voxels)
    pts = np.concatenate([rng.uniform(-15, 15, (2, 3000, 2)), rng.uniform(-2, 1, (2, 3000, 1)),
                          rng.rand(2, 3000, 2)], -1).astype(np.float32)
    host.update(points=pts, points_mask=rng.rand(2, 3000) < 0.95)
    jnet = jax_build_network(cfg.MODEL, jmeta)
    variables = jax_variables(jnet, host, seed=seed + 1)
    head = variables["params"]["AnchorHeadSingle_0"]
    head["conv_cls"]["bias"] = head["conv_cls"]["bias"] + np.float32(4.0)
    head["conv_box"]["kernel"] = head["conv_box"]["kernel"] * np.float32(0.02)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    return cfg, jmeta, pmeta, jnet, variables, net, host
