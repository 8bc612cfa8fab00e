"""Shared setup of the CenterHead-RPN and MPPNetE2E slice tests
(``tests/test_torch_port_centerhead_rpn.py``, ``tests/test_torch_port_
mppnet_e2e.py``; no tests here): ``configs/waymo_models/
voxel_rcnn_with_centerhead_dyn_voxel.yaml``, ``pv_rcnn_with_centerhead_
rpn.yaml`` and ``mppnet_e2e_memorybank_inference.yaml`` narrowed, over a
64 x 64 x 40 grid of 0.1 x 0.1 x 0.15 m on [-3.2, -3.2, -2, 3.2, 3.2, 4]
(40 z planes: the JAX package's VoxelBackBone8x needs ~25 or more to keep
a height after conv_out; ``tests/test_hybrid_compositions.py``'s 8 fail in
its init), 2 scenes of 3,000 points, f32.

The narrowing: the 3D backbone CHANNELS [8, 16, 16, 32], OUT_CHANNELS 32,
VOXEL_CAPS [4096, 2048, 1024, 512]; a one-layer BEV backbone; the
CenterHead's shared conv 16 wide (its 8 x 8 x 3 heatmap decodes 192
proposal candidates a scene); Voxel-RCNN's grid pool 3^3 at x_conv2/3/4
with MLPS [[16, 16]], query range 2, NSAMPLE 8, FCs [32, 32]; PV-RCNN's
256 keypoints and the 3^3 grid of 8 neighbours; 64 (train) / 32 (test)
RoIs after the proposal NMS, 16 sampled; MPPNetE2E's head TRANS_INPUT 32,
a 2^3 proxy grid, 32 points a RoI, FFN 64, 4 heads, 4 frames and groups,
16 RoIs.

The weights are the port's seeded init carried to flax by the weight
bridge's rules backwards (``flax_variables``: no JAX init is traced),
perturbed (``common.perturb``: every norm's bias +3), the heatmap's bias
+1.5 (scores off the decode's 0.1 threshold) and the size kernel x 0.02
(boxes of about a metre), then carried back into the port.
"""
import copy
from pathlib import Path

import numpy as np
import torch

from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.ops.voxelize import voxelize_points
from com_tpu.utils.config import cfg_from_yaml_file
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.utils.jax_weights import bridge_rules, load_jax_variables
import test_torch_port_train_common as common
from torch_port_parta2_setup import _TO_FLAX

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"voxel_rcnn": "configs/waymo_models/voxel_rcnn_with_centerhead_dyn_voxel.yaml",
           "pv_rcnn": "configs/waymo_models/pv_rcnn_with_centerhead_rpn.yaml",
           "mppnet": "configs/waymo_models/mppnet_e2e_memorybank_inference.yaml"}
PC_RANGE = (-3.2, -3.2, -2.0, 3.2, 3.2, 4.0)
VOXEL = (0.1, 0.1, 0.15)
GRID = (64, 64, 40)
POINTS = 3000
VOXEL_KEYS = ("voxels", "voxel_coords", "voxel_num_points")
INPUT_KEYS = {"voxel_rcnn": ("points", "points_mask"),
              "pv_rcnn": VOXEL_KEYS + ("points", "points_mask"),
              "mppnet": VOXEL_KEYS + ("points", "points_mask")}


def small_cfg(which):
    cfg = cfg_from_yaml_file(str(REPO / CONFIGS[which]))
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
    return cfg


def flax_transforms(nheads):
    """The bridge's layout changes undone, port -> flax; the attention
    projections need the head count."""
    out = dict(_TO_FLAX)
    out.update(mha_in=lambda a: a.T.reshape(a.shape[1], nheads, -1),
               flatten=lambda a: a.reshape(nheads, -1),
               mha_out=lambda a: a.T.reshape(nheads, -1, a.shape[0]))
    return out


def flax_variables(net, cfg, scopes):
    """The flax variables of ``net``'s weights, through the weight bridge's
    rules backwards; ``scopes`` are the top-level flax scope names."""
    nheads = int((cfg.MODEL.get("ROI_HEAD") or {}).get("Transformer", {}).get("nheads", 1))
    to_flax = flax_transforms(nheads)
    tree = {"params": {}, "batch_stats": {}}
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    for key, coll, path, transform in bridge_rules(cfg.MODEL, list(cfg.CLASS_NAMES),
                                                   dict.fromkeys(scopes)):
        node = tree[coll]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(to_flax[transform](sd[key]), np.float32)
    return tree


def scene_points(rng, b=2, n=POINTS, timestamp=False):
    """(b, n, 5) points over the range (x, y, z, intensity, elongation), a
    sixth column of zeros (the current frame's timestamp) with
    ``timestamp``."""
    lo, hi = np.array(PC_RANGE[:3]) + 0.05, np.array(PC_RANGE[3:]) - 0.05
    pts = np.concatenate([rng.uniform(lo, hi, (b, n, 3)), rng.rand(b, n, 2)], -1)
    if timestamp:
        pts = np.concatenate([pts, np.zeros((b, n, 1))], -1)
    return pts.astype(np.float32)


def voxelize(points, max_voxels=4096):
    out = [voxelize_points(p, PC_RANGE, VOXEL, 5, max_voxels, pad_to_max=True) for p in points]
    return {k: np.stack([o[i] for o in out]) for i, k in enumerate(VOXEL_KEYS)}


def host_batch(which, seed):
    """The model's inputs and 4 random GT boxes of the three classes in 16
    slots, a scene."""
    rng = np.random.RandomState(seed)
    pts = scene_points(rng, timestamp=which == "mppnet")
    host = {"points": pts, "points_mask": rng.rand(*pts.shape[:2]) < 0.95}
    if which != "voxel_rcnn":
        host.update(voxelize(np.where(host["points_mask"][..., None], pts, 1e3)))
    gt = np.zeros((2, 16, 8), np.float32)
    gt[:, :4, 0:2] = rng.uniform(-2.5, 2.5, (2, 4, 2))
    gt[:, :4, 2] = rng.uniform(-0.5, 1.0, (2, 4))
    gt[:, :4, 3:6] = rng.uniform(0.8, 2.0, (2, 4, 3))
    gt[:, :4, 6] = rng.uniform(-np.pi, np.pi, (2, 4))
    gt[:, :4, 7] = rng.randint(1, 4, (2, 4))
    real = gt[..., 7] > 0
    host.update(gt_boxes=gt, num_points_in_gt=real.astype(np.float32) * 10,
                true_object=real.astype(np.float32))
    return host


def spread(variables):
    """The CenterHead's heatmap bias +1.5 and size kernel x 0.02, in place."""
    head = next(v for k, v in variables["params"].items() if k.startswith("CenterHead"))
    head["head_0"]["hm_out"]["bias"] = head["head_0"]["hm_out"]["bias"] + np.float32(1.5)
    head["head_0"]["dim_out"]["kernel"] = head["head_0"]["dim_out"]["kernel"] * np.float32(0.02)
    return variables


SCOPES = {"voxel_rcnn": ("VoxelBackBone8x_0", "BaseBEVBackbone_0", "CenterHead_0", "roi_head"),
          "pv_rcnn": ("VoxelBackBone8x_0", "VoxelSetAbstraction_0", "BaseBEVBackbone_0",
                      "CenterHead_0", "point_head", "PVRCNNHead_0"),
          "mppnet": ("VoxelResBackBone8x_0", "BaseBEVBackbone_0", "CenterHead_0", "roi_head")}


def setup(which, seed=51):
    """(cfg, jmeta, pmeta, jnet, variables, net, host); the port's net in
    eval mode."""
    cfg = small_cfg(which)
    names = list(cfg.CLASS_NAMES)
    feats = 6 if which == "mppnet" else 5
    jmeta = JaxMeta(names, PC_RANGE, VOXEL, GRID, feats)
    pmeta = DatasetMeta(names, PC_RANGE, VOXEL, GRID, feats)
    net = build_network(cfg.MODEL, pmeta, device="cpu", seed=seed)
    variables = spread(common.perturb(flax_variables(net, cfg, SCOPES[which]), seed=seed + 1))
    load_jax_variables(net, variables, cfg.MODEL, names)
    jnet = jax_build_network(copy.deepcopy(cfg.MODEL), jmeta)
    return cfg, jmeta, pmeta, jnet, variables, net, host_batch(which, seed)


def proposal_gt(net, host, keys, per_scene=2, first=4):
    """``host`` with GT slots ``first``.. on the first ``per_scene`` RoIs of
    a train-mode forward of a copy of ``net`` (no GT in its batch), each a
    little off: GT on a RoI ties at IoU 1, and a GT size, height or heading
    equal to the CenterHead's own decode puts its L1 regression loss on its
    kink (the sign of a rounding-sized difference)."""
    probe = copy.deepcopy(net).train()
    with torch.no_grad():
        out = probe({k: torch.from_numpy(np.array(host[k])) for k in keys})
    assert out["roi_valid"][:, :per_scene].all()
    host = dict(host, gt_boxes=host["gt_boxes"].copy())
    slots = slice(first, first + per_scene)
    host["gt_boxes"][:, slots, :7] = out["rois"][:, :per_scene, :7].numpy()
    off = np.arange(1, per_scene + 1, dtype=np.float32)
    host["gt_boxes"][:, slots, 0] += np.float32(0.05) * off
    host["gt_boxes"][:, slots, 2] += np.float32(0.03) * off
    host["gt_boxes"][:, slots, 3:6] *= np.float32(1.0) + np.float32(0.04) * off[:, None]
    host["gt_boxes"][:, slots, 6] += np.float32(0.05) * off
    host["gt_boxes"][:, slots, 7] = out["roi_labels"][:, :per_scene].numpy()
    real = host["gt_boxes"][..., 7] > 0
    host.update(num_points_in_gt=real.astype(np.float32) * 10, true_object=real.astype(np.float32))
    return host
