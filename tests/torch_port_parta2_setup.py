"""Shared setup of the PartA2 slice tests (``tests/test_torch_port_parta2*.py``;
no tests here): ``configs/kitti_models/PartA2.yaml`` and
``PartA2_free.yaml`` narrowed, over ``test_torch_port_voxel_model.py``'s
scenes (2 scenes, 64 x 64 x 40 grid of 0.5 x 0.5 x 0.1 m, 2,048 voxel
slots, f32).

The narrowing: UNetV2 CHANNELS [8, 16, 16, 32] with VOXEL_CAPS [2048, 1024,
512, 256], the BEV backbone one layer a block, the point head's branches
[16]; PartA2FCHead at POOL_SIZE 4, NUM_FEATURES 16, 64 points a RoI, FCs
[32] and DP_RATIO 0 (the card runs the YAML's 0.3); PartA2-free's
PointRCNNHead as ``tests/test_pointrcnn.py``'s small one; 256 -> 64
proposals in training, 32 in eval (16 for PartA2-free), 16 RoIs a scene.

The weights are the port's seeded init carried to flax (``flax_variables``),
perturbed from a seed (``common.perturb``), every norm's bias +3
(``shift_norm_biases``: the point and RoI heads' norms are not named
"*Norm*"), the anchor head's class bias +4 and box kernel x 0.02 (scores
spread, boxes near their anchors), the point head's class bias -2.5 (its
segmentation scores spread across SEG_MASK_SCORE_THRESH) and, for
PartA2-free, its box kernel x 0.02; then carried back into the port by
the weight bridge.  PartA2's GT are anchors taken as boxes
(``torch_port_two_stage_setup.anchor_gt``), PartA2-free's 6 random boxes;
for training, two empty GT slots a scene take the model's own train-mode
proposals, a few cm off (``proposal_gt``), so that sampled RoIs overlap a
GT.
"""
import copy
from pathlib import Path

import numpy as np
import torch

from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.utils.config import cfg_from_yaml_file
from com_tpu_torch.models.detectors import build_network
from com_tpu_torch.utils.jax_weights import bridge_rules, load_jax_variables
import test_torch_port_train_common as common
from test_torch_port_voxel_model import VOXEL_KEYS, metas, narrow, scenes
from torch_port_pointrcnn_setup import shift_norm_biases
from torch_port_two_stage_setup import anchor_gt

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"parta2": "configs/kitti_models/PartA2.yaml",
           "free": "configs/kitti_models/PartA2_free.yaml"}


def small_cfg(which, dp_ratio=0.0, pool_size=4):
    cfg = cfg_from_yaml_file(str(REPO / CONFIGS[which]))
    m = cfg.MODEL
    encoded = m.BACKBONE_3D.RETURN_ENCODED_TENSOR
    if "BACKBONE_2D" in m:
        narrow(cfg)
    m.MIXED_PRECISION = False
    m.BACKBONE_3D = type(m.BACKBONE_3D)({
        "NAME": "UNetV2", "CHANNELS": [8, 16, 16, 32], "VOXEL_CAPS": [2048, 1024, 512, 256],
        "RETURN_ENCODED_TENSOR": encoded})
    ph = m.POINT_HEAD
    ph.CLS_FC, ph.PART_FC = [16], [16]
    if "REG_FC" in ph:
        ph.REG_FC = [16]
    r = m.ROI_HEAD
    r.DP_RATIO = dp_ratio
    if which == "parta2":
        r.ROI_AWARE_POOL.update(POOL_SIZE=pool_size, NUM_FEATURES=16, MAX_POINTS_PER_ROI=64)
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
    return cfg


def spread(variables, which):
    """The perturbed JAX variables' heads moved so that scores spread, in
    place (see the module's docstring)."""
    params = variables["params"]
    shift_norm_biases(params)
    head = params["point_head"]
    head["cls_out"]["bias"] = head["cls_out"]["bias"] - np.float32(2.5)
    if which == "parta2":
        anchor = params["AnchorHeadSingle_0"]
        anchor["conv_cls"]["bias"] = anchor["conv_cls"]["bias"] + np.float32(4.0)
        anchor["conv_box"]["kernel"] = anchor["conv_box"]["kernel"] * np.float32(0.02)
    else:
        head["box_out"]["kernel"] = head["box_out"]["kernel"] * np.float32(0.02)
    return variables


def proposal_gt(net, host, first=6, per_scene=2):
    """``host`` with GT slots ``first``.. of each scene on the first
    ``per_scene`` proposals of a train-mode forward of a copy of ``net``
    (with no GT in the batch the detector keeps its proposals as the RoIs)."""
    probe = copy.deepcopy(net).train()  # training mode moves the norms' statistics
    with torch.no_grad():
        out = probe({k: torch.from_numpy(np.array(host[k])) for k in VOXEL_KEYS})
    assert out["roi_valid"][:, :per_scene].all()
    host = dict(host, gt_boxes=host["gt_boxes"].copy())
    slots = slice(first, first + per_scene)
    host["gt_boxes"][:, slots, :7] = out["rois"][:, :per_scene, :7].numpy()
    # a box each a few cm off its proposal, by different amounts: RoIs
    # exactly on a GT tie at IoU 1, and either package may rank a tie first
    host["gt_boxes"][:, slots, 0] += np.float32(0.05) * np.arange(1, per_scene + 1)
    host["gt_boxes"][:, slots, 7] = out["roi_labels"][:, :per_scene].numpy()
    real = host["gt_boxes"][..., 7] > 0
    host.update(num_points_in_gt=real.astype(np.float32) * 10,
                true_object=real.astype(np.float32))
    return host


# the layout changes of the weight bridge, undone: port -> flax
_TO_FLAX = {
    "copy": lambda a: a,
    "linear": lambda a: a.T,
    "conv2d": lambda a: a.transpose(2, 3, 1, 0),
    "deconv2d": lambda a: a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1),
    "spconv27": lambda a: a.transpose(1, 2, 3, 4, 0).reshape(27, a.shape[4], a.shape[0]),
    "spconv3": lambda a: a.transpose(1, 2, 3, 4, 0).reshape(3, a.shape[4], a.shape[0]),
    "conv1d": lambda a: a[..., 0].T,
    "conv1x1": lambda a: a[..., 0, 0].T,
    "spconv_dense": lambda a: a.transpose(1, 2, 3, 4, 0),
    "var_shift": lambda a: a - np.float32(1e-3 - 1e-5),
}
SCOPES = {"parta2": ("UNetV2_0", "BaseBEVBackbone_0", "AnchorHeadSingle_0", "point_head",
                     "roi_head"),
          "free": ("UNetV2_0", "point_head", "roi_head")}


def flax_variables(net, cfg, which):
    """The flax variables of ``net``'s weights, through the weight bridge's
    rules backwards (the JAX package's init is not traced: tracing and
    compiling it costs as much as a forward)."""
    tree = {"params": {}, "batch_stats": {}}
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    for key, coll, path, transform in bridge_rules(cfg.MODEL, list(cfg.CLASS_NAMES),
                                                   dict.fromkeys(SCOPES[which])):
        node = tree[coll]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(_TO_FLAX[transform](sd[key]), np.float32)
    return tree


def setup(which="parta2", seed=41):
    """(cfg, jmeta, pmeta, jnet, variables, net, host); the port's net in
    eval mode.  The weights start from the port's seeded init."""
    host, pc_range, vsize = scenes(seed=seed)
    cfg = small_cfg(which)
    jmeta, pmeta = metas(cfg, pc_range, vsize)
    if which == "parta2":
        gt = anchor_gt(cfg, pmeta, np.random.RandomState(seed + 100), host["gt_boxes"].shape[0])
        real = gt[..., 7] > 0
        host.update(gt_boxes=gt, num_points_in_gt=real.astype(np.float32) * 10,
                    true_object=real.astype(np.float32))
    jnet = jax_build_network(cfg.MODEL, jmeta)
    net = build_network(cfg.MODEL, pmeta, device="cpu", seed=seed)
    variables = spread(common.perturb(flax_variables(net, cfg, which), seed=seed + 1), which)
    load_jax_variables(net, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    if which == "free":
        host = proposal_gt(net, host)
    return cfg, jmeta, pmeta, jnet, variables, net, host
