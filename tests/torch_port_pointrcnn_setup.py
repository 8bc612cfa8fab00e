"""Shared setup of the PointRCNN slice tests (``tests/test_torch_port_
pointrcnn*.py``; no tests here): ``tests/test_pointrcnn.py``'s small
PointRCNN (``pointrcnn_cfg``: PointNet2MSG over 256 / 64 samples at two
radii, FP back to every point, PointHeadBox [32], 128 -> 16 proposals,
64 pooled points a RoI, an SA of 32 then group-all) over 2 scenes of
1,024 points with 5 features, 95 % of them valid: two clusters of 200
points a scene around a car and a pedestrian, the rest spread over the
20 m range.

The JAX variables are perturbed from a seed (every norm's bias +3, so
that no ReLU input sits near 0), the point head's class biases lowered by
6 (the norms' shift saturates the scores otherwise; they spread over
0.13-1) and its box kernel shrunk 50-fold (boxes near their class's mean
size),
and carried into the port by the weight bridge.  For training, the empty
GT slots take the train-mode forward's own first proposals
(``proposal_gt``), so that sampled RoIs overlap a GT.
"""
import copy

import jax
import numpy as np
import torch

from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.utils.config import CfgNode
from com_tpu_torch.utils.jax_weights import load_jax_variables
import test_torch_port_train_common as common
from test_pointrcnn import CLASS_NAMES, pointrcnn_cfg

RANGE = (-10.0, -10.0, -2.0, 10.0, 10.0, 4.0)
META = (CLASS_NAMES, RANGE, (0.1, 0.1, 6.0), (200, 200, 1), 5)
INPUT_KEYS = ("points", "points_mask")
OPTIMIZATION = {"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.01,
                "MOMENTUM": 0.9, "MOMS": [0.95, 0.85], "PCT_START": 0.4, "DIV_FACTOR": 10,
                "DECAY_STEP_LIST": [35, 45], "LR_DECAY": 0.1, "LR_CLIP": 1e-7,
                "LR_WARMUP": False, "WARMUP_EPOCH": 1, "GRAD_NORM_CLIP": 10}


def scenes(seed, b=2, n=1024):
    """Host arrays: points (b, n, 5), points_mask, gt_boxes (b, 4, 8) (a car
    and a pedestrian a scene, 2 empty slots), the GT's side arrays."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((b, 4, 8), np.float32)
    pts = []
    for s in range(b):
        gt[s, 0] = [*rng.uniform(-6, 6, 2), 0.0, 4.2, 1.9, 1.6, rng.uniform(-3, 3), 1]
        gt[s, 1] = [*rng.uniform(-6, 6, 2), 0.0, 0.9, 0.8, 1.7, rng.uniform(-3, 3), 2]
        parts = [np.concatenate([rng.randn(200, 3) * 0.25 + box[None, :3], rng.rand(200, 2)], 1)
                 for box in gt[s, :2]]
        parts.append(np.concatenate([rng.uniform(-10, 10, (n - 400, 2)),
                                     rng.uniform(-1, 2, (n - 400, 1)), rng.rand(n - 400, 2)], 1))
        pts.append(np.concatenate(parts))
    real = gt[..., 7] > 0
    return {"points": np.stack(pts).astype(np.float32), "points_mask": rng.rand(b, n) < 0.95,
            "gt_boxes": gt, "num_points_in_gt": real.astype(np.float32) * 200,
            "true_object": real.astype(np.float32)}


def shift_norm_biases(tree, by=3.0):
    """Every norm's bias (a scope holding "scale" and "bias") + ``by`` where
    ``common.perturb`` left it (it shifts the scopes named "*Norm*" only;
    PointRCNN's FP, head and RoI-head norms are "bn_{j}", "cls_bn_{i}"...)."""
    for name, node in tree.items():
        if isinstance(node, dict) and set(node) == {"scale", "bias"}:
            if "Norm" not in name:
                node["bias"] = node["bias"] + np.float32(by)
        elif isinstance(node, dict):
            shift_norm_biases(node, by)
    return tree


def spread(variables):
    """Every norm's bias past +3 (``shift_norm_biases``), the point head's
    class biases -6 and its box kernel x 0.02, in place."""
    shift_norm_biases(variables["params"])
    head = variables["params"]["point_head"]
    head["cls_out"]["bias"] = head["cls_out"]["bias"] - np.float32(6.0)
    head["box_out"]["kernel"] = head["box_out"]["kernel"] * np.float32(0.02)
    return variables


def setup(seed=61):
    """(cfg, jmeta, pmeta, jnet, variables, net, host): cfg a port CfgNode
    with MODEL, CLASS_NAMES and OPTIMIZATION; the port's net in eval mode."""
    host = scenes(seed)
    model = copy.deepcopy(dict(pointrcnn_cfg()))
    cfg = CfgNode({"MODEL": model, "CLASS_NAMES": CLASS_NAMES, "OPTIMIZATION": OPTIMIZATION})
    jmeta, pmeta = JaxMeta(*META), DatasetMeta(*META)
    jnet = jax_build_network(pointrcnn_cfg(), jmeta)
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), {k: host[k] for k in INPUT_KEYS}, train=False)
    variables = spread(common.perturb(jax.tree_util.tree_map(np.asarray, dict(variables)),
                                      seed=seed + 1))
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, CLASS_NAMES)
    return cfg, jmeta, pmeta, jnet, variables, net, host


def proposal_gt(net, host, per_scene=2):
    """``host`` with its empty GT slots (2 and 3) of each scene put on the
    first ``per_scene`` proposals of a train-mode forward of a copy of
    ``net`` (box and class; with no GT in the batch the detector keeps its
    proposals as the RoIs)."""
    probe = copy.deepcopy(net).train()  # training mode moves the norms' statistics
    with torch.no_grad():
        out = probe({k: torch.from_numpy(host[k]) for k in INPUT_KEYS})
    assert out["roi_valid"][:, :per_scene].all()
    host = dict(host, gt_boxes=host["gt_boxes"].copy())
    host["gt_boxes"][:, 2:2 + per_scene, :7] = out["rois"][:, :per_scene, :7].numpy()
    host["gt_boxes"][:, 2:2 + per_scene, 7] = out["roi_labels"][:, :per_scene].numpy()
    real = host["gt_boxes"][..., 7] > 0
    host.update(num_points_in_gt=real.astype(np.float32) * 200,
                true_object=real.astype(np.float32))
    return host
