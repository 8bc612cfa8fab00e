"""Shared setup of the PV-RCNN slice tests (``tests/test_torch_port_
pvrcnn*.py``; no tests here): ``tests/test_pvrcnn.py``'s small PV-RCNN
(64 x 64 x 40 grid of 0.5 x 0.5 x 0.1 m over +-16 m, 2 scenes of 2,000
points with 5 features, 256 keypoints, NSAMPLE 8, a 3^3 RoI grid, SHARED_FC
[32, 32]) with CLS_FC and REG_FC [16] written out (the JAX head's default
is none; pcdet's make_fc_layers then has a block and its dropout slot),
and its PV-RCNN++ variant as ``tests/test_pvrcnn_plusplus.py`` builds it
(SPC over 4 sectors, two vector-pool groups of 8 neighbours, 16 RoIs a
scene; 64 proposals in training, not 16, so that some lie on a GT box).

The GT are anchors taken as boxes (``torch_port_two_stage_setup.
anchor_gt``), so that proposals match them; the JAX variables are
perturbed from a seed (norm biases +3), the anchor head's class bias
raised by 4 and its box kernel shrunk 50-fold, and carried into the port
by the weight bridge.
"""
import copy

import jax
import numpy as np

from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.utils.config import CfgNode as JaxCfgNode
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.utils.config import CfgNode
from com_tpu_torch.utils.jax_weights import load_jax_variables
import test_torch_port_train_common as common
from test_pvrcnn import make_batch, pvrcnn_cfg
from torch_port_two_stage_setup import anchor_gt

CLASS_NAMES = ["Vehicle"]
GRID = (64, 64, 40)
VOXEL_KEYS = ("voxels", "voxel_coords", "voxel_num_points")
INPUT_KEYS = VOXEL_KEYS + ("points", "points_mask")


def small_cfg(which="pvrcnn", dp_ratio=0.0):
    """The model config (a dict) of ``which``: "pvrcnn" or "pvrcnn_plusplus"."""
    cfg = copy.deepcopy(dict(pvrcnn_cfg()))
    roi = cfg["ROI_HEAD"]
    roi.update(CLS_FC=[16], REG_FC=[16], DP_RATIO=dp_ratio)
    roi["LOSS_CONFIG"] = {"LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0}}
    if which == "pvrcnn_plusplus":
        cfg["NAME"] = "PVRCNNPlusPlus"
        cfg["PFE"]["SAMPLE_METHOD"] = "SPC"
        cfg["PFE"]["SPC_SAMPLING"] = {"NUM_SECTORS": 4, "SAMPLE_RADIUS_WITH_ROI": 1.6}
        roi["NAME"] = "PVRCNNPlusPlusHead"
        roi["NMS_CONFIG"] = {
            "TRAIN": {"NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 64, "NMS_THRESH": 0.8},
            "TEST": {"NMS_PRE_MAXSIZE": 128, "NMS_POST_MAXSIZE": 16, "NMS_THRESH": 0.7}}
        roi["TARGET_CONFIG"]["ROI_PER_IMAGE"] = 16
        roi["ROI_GRID_POOL"] = {
            "GRID_SIZE": 3, "LOCAL_AGGREGATION_TYPE": "local_interpolation",
            "GROUPS": [{"NUM_LOCAL_VOXEL": [2, 2, 2], "MAX_NEIGHBOR_DISTANCE": 0.8,
                        "NEIGHBOR_NSAMPLE": 8, "POST_MLPS": [16]},
                       {"NUM_LOCAL_VOXEL": [2, 2, 2], "MAX_NEIGHBOR_DISTANCE": 1.6,
                        "NEIGHBOR_NSAMPLE": 8, "POST_MLPS": [16]}]}
    return cfg


OPTIMIZATION = {"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.01,
                "MOMENTUM": 0.9, "MOMS": [0.95, 0.85], "PCT_START": 0.4, "DIV_FACTOR": 10,
                "DECAY_STEP_LIST": [35, 45], "LR_DECAY": 0.1, "LR_CLIP": 1e-7,
                "LR_WARMUP": False, "WARMUP_EPOCH": 1, "GRAD_NORM_CLIP": 10}


def host_batch(seed):
    """(host arrays, pc_range, voxel size): ``test_pvrcnn.make_batch``'s
    scenes, GT on anchors (12 of 16 slots real)."""
    rng = np.random.RandomState(seed)
    batch, pc_range, vsize = make_batch(rng)
    host = {k: np.array(v) for k, v in batch.items()}
    return host, tuple(float(v) for v in pc_range), tuple(float(v) for v in vsize)


def setup(which="pvrcnn", seed=41, dp_ratio=0.0):
    """(cfg, jmeta, pmeta, jnet, variables, net, host) for ``which``: cfg a
    port CfgNode with MODEL, CLASS_NAMES and OPTIMIZATION."""
    host, pc_range, vsize = host_batch(seed)
    model = small_cfg(which, dp_ratio)
    cfg = CfgNode({"MODEL": model, "CLASS_NAMES": CLASS_NAMES, "OPTIMIZATION": OPTIMIZATION})
    jmeta = JaxMeta(CLASS_NAMES, pc_range, vsize, GRID, 5)
    pmeta = DatasetMeta(CLASS_NAMES, pc_range, vsize, GRID, 5)
    gt = anchor_gt(cfg, pmeta, np.random.RandomState(seed + 100), 2)
    real = gt[..., 7] > 0
    host.update(gt_boxes=gt, num_points_in_gt=real.astype(np.float32) * 10,
                true_object=real.astype(np.float32))
    jnet = jax_build_network(JaxCfgNode(copy.deepcopy(model)), jmeta)
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), {k: host[k] for k in INPUT_KEYS}, train=False)
    variables = common.perturb(jax.tree_util.tree_map(np.asarray, dict(variables)),
                               seed=seed + 1)
    head = variables["params"]["AnchorHeadSingle_0"]
    head["conv_cls"]["bias"] = head["conv_cls"]["bias"] + np.float32(4.0)
    head["conv_box"]["kernel"] = head["conv_box"]["kernel"] * np.float32(0.02)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, CLASS_NAMES)
    return cfg, jmeta, pmeta, jnet, variables, net, host
