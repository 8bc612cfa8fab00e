"""CenterHead (+ curriculum names), box decoding, the two-stage detectors'
proposal decode and NMS post-processing.

Counterpart of ``com_tpu/models/dense_heads/center_head.py`` (pcdet
center_head.py:48-369).  The JAX package runs the five branches as one fused
hidden conv and one block-masked final conv; that is a compute layout only,
and here each branch runs on its own.  Module names follow pcdet:
``shared_conv.{0,1}``, ``heads_list.{h}.{name}.{j}.{0,1}`` for the hidden
ConvBNReLUs and ``heads_list.{h}.{name}.{num_conv-1}`` for the final conv.
All these convs carry a bias in the flagship config, so they are library
convs, as they are XLA convs in the JAX package.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.nms import circle_nms, fast_nms_bev, nms_bev
from ...utils.registry import DENSE_HEADS
from ..layers import Conv2d, ConvBNReLU


class SeparateHead(nn.Module):
    """Per target: (num_conv - 1) ConvBNReLU (BN eps 1e-5) + a final 3x3 conv
    with bias; the heatmap's final bias starts at init_bias."""

    def __init__(self, cin: int, sep_head_dict: dict, init_bias: float = -2.19,
                 use_bias: bool = False, dtype=None):
        super().__init__()
        self.names = list(sep_head_dict)
        for name, spec in sep_head_dict.items():
            layers = [ConvBNReLU(cin, cin, 3, bias=use_bias, eps=1e-5, dtype=dtype)
                      for _ in range(int(spec["num_conv"]) - 1)]
            layers.append(Conv2d(cin, int(spec["out_channels"]), 3, bias=True, dtype=dtype))
            setattr(self, name, nn.Sequential(*layers))
        self.init_bias = init_bias

    def forward(self, x):
        return {name: getattr(self, name)(x).float() for name in self.names}


@DENSE_HEADS.register
class CenterHead(nn.Module):
    """Shared conv + one SeparateHead per class group -> batch["pred_dicts"],
    a list of {branch: (B, H, W, C) f32}."""

    def __init__(self, model_cfg, input_channels: int, num_class: int, class_names):
        super().__init__()
        self.model_cfg = model_cfg
        self.class_names = tuple(class_names)
        self.dtype = torch.bfloat16 if model_cfg.get("MIXED_PRECISION", False) else None
        use_bias = bool(model_cfg.get("USE_BIAS_BEFORE_NORM", False))
        ch = int(model_cfg["SHARED_CONV_CHANNEL"])
        self.shared_conv = ConvBNReLU(input_channels, ch, 3, bias=use_bias, eps=1e-5,
                                      dtype=self.dtype)
        head_dict = dict(model_cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"])
        self.heads_list = nn.ModuleList()
        for class_ids in self.head_class_groups():
            sep = dict(head_dict)
            sep["hm"] = {"out_channels": len(class_ids),
                         "num_conv": model_cfg.get("NUM_HM_CONV", 2)}
            self.heads_list.append(SeparateHead(ch, sep, use_bias=use_bias, dtype=self.dtype))

    def head_class_groups(self):
        """[global 1-based class ids] per head, from CLASS_NAMES_EACH_HEAD."""
        return [tuple(self.class_names.index(n) + 1 for n in names if n in self.class_names)
                for names in self.model_cfg["CLASS_NAMES_EACH_HEAD"]]

    def forward(self, batch):
        x = batch["spatial_features_2d"]
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.shared_conv(x)
        batch["pred_dicts"] = [head(x) for head in self.heads_list]
        return batch


for _name in ("CurriculumCenterHead", "CurriculumCenterHead_x5",
              "CurriculumCenterHead_car_merge", "CurriculumCenterHead_ped_merge"):
    DENSE_HEADS.register(CenterHead, name=_name)


def _topk_stable(flat: torch.Tensor, k: int):
    """Top-k along the last axis with ties to the lower index, as
    ``lax.top_k``: a stable descending sort."""
    scores, inds = torch.sort(flat, dim=-1, descending=True, stable=True)
    return scores[..., :k], inds[..., :k]


def decode_center_boxes(pred_dict, class_ids, point_cloud_range, voxel_size,
                        feature_map_stride: int, k: int = 500, score_thresh: float = 0.1,
                        post_center_limit_range=None,
                        head_order=("center", "center_z", "dim", "rot")):
    """Top-K decode from the heatmap (centernet_utils.py:199-279).

    Returns (boxes (B, K, 7+), scores (B, K), labels (B, K) global 1-based,
    valid (B, K) bool)."""
    hm = torch.sigmoid(pred_dict["hm"])  # (B, H, W, C)
    b, h, w, c = hm.shape
    k = min(int(k), h * w * c)
    scores, inds = _topk_stable(hm.reshape(b, h * w * c), k)
    cls = inds % c
    cell = torch.div(inds, c, rounding_mode="floor")
    ys = torch.div(cell, w, rounding_mode="floor").to(hm.dtype)
    xs = (cell % w).to(hm.dtype)

    def gather(name):
        t = pred_dict[name]
        tf = t.reshape(b, h * w, t.shape[-1])
        return torch.gather(tf, 1, cell[..., None].expand(-1, -1, t.shape[-1]))

    center = gather("center")
    center_z = gather("center_z")
    dim = torch.exp(torch.clamp(gather("dim"), -8.0, 8.0))
    rot = gather("rot")
    angle = torch.atan2(rot[..., 1:2], rot[..., 0:1])
    xs = (xs[..., None] + center[..., 0:1]) * feature_map_stride * voxel_size[0] \
        + point_cloud_range[0]
    ys = (ys[..., None] + center[..., 1:2]) * feature_map_stride * voxel_size[1] \
        + point_cloud_range[1]
    parts = [xs, ys, center_z, dim, angle]
    if "vel" in pred_dict and "vel" in head_order:
        parts.append(gather("vel"))
    boxes = torch.cat(parts, dim=-1)

    valid = scores > score_thresh
    if post_center_limit_range is not None:
        lim = torch.as_tensor(list(post_center_limit_range), dtype=boxes.dtype,
                              device=boxes.device)
        valid = valid & (boxes[..., :3] >= lim[:3]).all(-1) & (boxes[..., :3] <= lim[3:6]).all(-1)
    label_map = torch.as_tensor(list(class_ids), dtype=torch.int32, device=boxes.device)
    return boxes, scores, label_map[cls], valid


def decode_center_proposals(batch, dh_cfg, meta, k: int = 512):
    """The CenterHead's per-head top-``k`` boxes as one flat set of proposal
    candidates (the JAX package's ``detectors.decode_center_proposals``):
    (boxes (B, P, 7+), scores (B, P), labels (B, P), valid (B, P)), heads
    concatenated, no NMS.  ``decode_center_boxes`` at its default score
    threshold and without POST_CENTER_LIMIT_RANGE; a score is multiplied
    by its validity.  A CLASS_NAMES_EACH_HEAD entry missing from the
    dataset's class names raises ValueError (a head would keep that
    channel with no label for it)."""
    stride = int(dh_cfg["TARGET_ASSIGNER_CONFIG"].get("FEATURE_MAP_STRIDE", 1))
    class_names = list(meta.class_names)
    parts = []
    for pred_dict, names in zip(batch["pred_dicts"], dh_cfg["CLASS_NAMES_EACH_HEAD"]):
        missing = [n for n in names if n not in class_names]
        if missing:
            raise ValueError(f"CLASS_NAMES_EACH_HEAD entries {missing} are not in the "
                             f"dataset CLASS_NAMES {class_names}")
        ids = tuple(class_names.index(n) + 1 for n in names)
        hm = pred_dict["hm"]
        boxes, scores, labels, valid = decode_center_boxes(
            pred_dict, ids, meta.point_cloud_range, meta.voxel_size, stride,
            k=min(k, int(hm.shape[1] * hm.shape[2] * hm.shape[3])),
            head_order=tuple(dh_cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"]))
        parts.append((boxes, scores * valid.to(scores.dtype), labels, valid))
    return tuple(torch.cat(p, dim=1) for p in zip(*parts))


def post_process_nms(boxes, scores, labels, valid, nms_cfg, num_out: int):
    """Class-agnostic NMS over decoded boxes (model_nms_utils.py:6-40)."""
    nms_type = nms_cfg.get("NMS_TYPE", "nms_gpu")
    post = int(nms_cfg.get("NMS_POST_MAXSIZE", num_out))
    if nms_type == "circle_nms":
        sel, sel_valid = circle_nms(boxes[..., :2], scores, valid,
                                    float(nms_cfg.get("MIN_RADIUS", 4)), post)
    elif nms_type == "fast_nms":
        sel, sel_valid = fast_nms_bev(boxes, scores, valid, float(nms_cfg["NMS_THRESH"]), post)
    else:
        sel, sel_valid = nms_bev(boxes, scores, valid, float(nms_cfg["NMS_THRESH"]), post)
    take = torch.gather
    return (take(boxes, 1, sel[..., None].expand(-1, -1, boxes.shape[-1])),
            take(scores, 1, sel), take(labels, 1, sel), sel_valid)
