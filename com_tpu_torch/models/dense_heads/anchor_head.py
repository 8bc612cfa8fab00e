"""AnchorHeadSingle (+ the COM curriculum names), AnchorHeadMulti, anchor
decoding and post-processing.

Counterpart of ``com_tpu/models/dense_heads/anchor_head.py`` (pcdet
anchor_head_{template,single}.py and the curriculum variants).  The head
only predicts: target assignment (``anchor_assign.py``) and the losses
(``losses/anchor_losses.py``) run in the train step.  The three 1x1 convs
keep pcdet's names (``conv_cls``, ``conv_box``, ``conv_dir_cls``) and run in
f32 on the backbone's output, as flax promotes a bf16 input with f32
parameters; they are library convs, as they are XLA convs in the JAX
package.  Predictions stay NHWC, (B, H, W, A * X), so the flat anchor
layout (B, H * W * A, X) is a plain reshape.  ``AnchorHeadMulti`` writes
the same layout, so assignment, losses, decoding and NMS run unchanged.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops.boxes import ResidualCoder
from ...ops.nms import multi_class_nms_bev, nms_bev
from ...utils.registry import DENSE_HEADS
from ..layers import Conv2d, ConvBNReLU
from .anchor_generator import generate_anchors

CLS_PRIOR = 0.01  # the foreground probability conv_cls's bias starts at
CLS_BIAS_INIT = -math.log((1 - CLS_PRIOR) / CLS_PRIOR)


def build_anchors(model_cfg, class_names, grid_size, point_cloud_range):
    """Static anchors in the prediction layout: location-major, the classes'
    (size, rotation) slots interleaved at each cell as the head's channels
    are, so that anchor ``a`` of cell ``(y, x)`` is row ``(y * W + x) * A +
    a`` of the flat (B, H * W * A, X) predictions.

    Returns (anchors_flat (A, 7), per_class_index [(A_c,) int32], matched
    thresholds, unmatched thresholds, class_ids), numpy."""
    agc = model_cfg["ANCHOR_GENERATOR_CONFIG"]
    per_class, _ = generate_anchors(agc, grid_size, point_cloud_range)
    combined = np.concatenate(per_class, axis=3)  # classes concatenated on the size axis
    h, w, z, s_total, r, _ = combined.shape
    anchors_flat = combined.reshape(-1, 7)
    slot_class = np.concatenate([
        np.full(p.shape[3], class_names.index(cfg["class_name"]) + 1, np.int32)
        for cfg, p in zip(agc, per_class)])
    class_of_anchor = np.broadcast_to(slot_class[None, None, None, :, None],
                                      (h, w, z, s_total, r)).reshape(-1)
    per_class_index, matched, unmatched, class_ids = [], [], [], []
    for cfg in agc:
        cid = class_names.index(cfg["class_name"]) + 1
        per_class_index.append(np.where(class_of_anchor == cid)[0].astype(np.int32))
        matched.append(cfg["matched_threshold"])
        unmatched.append(cfg["unmatched_threshold"])
        class_ids.append(cid)
    return anchors_flat, per_class_index, matched, unmatched, tuple(class_ids)


def box_coder_for(head_cfg) -> ResidualCoder:
    """The head's ``BOX_CODER_CONFIG`` (code size, sincos heading)."""
    coder_cfg = head_cfg.get("TARGET_ASSIGNER_CONFIG", {}).get("BOX_CODER_CONFIG", {})
    return ResidualCoder(code_size=int(coder_cfg.get("code_size", 7)),
                         encode_angle_by_sincos=bool(coder_cfg.get("encode_angle_by_sincos",
                                                                   False)))


def anchors_per_location(agc) -> dict:
    """{class name: anchors a BEV cell} of ANCHOR_GENERATOR_CONFIG."""
    return {c["class_name"]: len(c["anchor_sizes"]) * len(c["anchor_rotations"])
            * len(c["anchor_bottom_heights"]) for c in agc}


@DENSE_HEADS.register
class AnchorHeadSingle(nn.Module):
    """1x1 conv heads for class, box and direction over the BEV map: writes
    ``cls_preds_raw``, ``box_preds_raw`` and ``dir_cls_preds_raw``, f32
    (B, H, W, A * X)."""

    def __init__(self, model_cfg, input_channels: int, num_class: int, class_names):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        num_anchors = sum(anchors_per_location(model_cfg["ANCHOR_GENERATOR_CONFIG"]).values())
        code_size = box_coder_for(model_cfg).code_size
        f32 = torch.float32
        self.conv_cls = Conv2d(input_channels, num_anchors * num_class, 1, bias=True, dtype=f32)
        self.conv_box = Conv2d(input_channels, num_anchors * code_size, 1, bias=True, dtype=f32)
        self.conv_dir_cls = None
        if model_cfg.get("USE_DIRECTION_CLASSIFIER", False):
            nbins = int(model_cfg.get("NUM_DIR_BINS", 2))
            self.conv_dir_cls = Conv2d(input_channels, num_anchors * nbins, 1, bias=True,
                                       dtype=f32)

    def forward(self, batch):
        x = batch["spatial_features_2d"]
        batch["cls_preds_raw"] = self.conv_cls(x)
        batch["box_preds_raw"] = self.conv_box(x)
        if self.conv_dir_cls is not None:
            batch["dir_cls_preds_raw"] = self.conv_dir_cls(x)
        return batch


for _name in ("AnchorHeadCurriculum", "CurriculumAnchorHeadSingle",
              "CurriculumAnchorHeadSingle_x1", "CurriculumAnchorHeadSingle_car",
              "CurriculumAnchorHeadSingle_car_x2"):
    DENSE_HEADS.register(AnchorHeadSingle, name=_name)


def _conv_bn_relu_f32(block: ConvBNReLU, x: torch.Tensor) -> torch.Tensor:
    """A ConvBNReLU whose norm runs and returns f32 whatever the conv's
    dtype: flax's norm without a dtype promotes a bf16 input to f32."""
    conv, norm, relu = block
    return relu(norm(conv(x).float()))


class SingleHead(nn.Module):
    """One group's head of ``AnchorHeadMulti``: ``conv_mid`` (SEPARATE_REG_
    CONFIG's NUM_MIDDLE_CONV ConvBNReLUs, shared by the branches), then the
    1x1 convs ``conv_cls`` (the group's classes), ``conv_box`` (a conv, or
    with SEPARATE_REG_CONFIG a ModuleDict ``conv_{attribute}`` a regression
    attribute) and ``conv_dir_cls``."""

    def __init__(self, cin: int, num_anchors: int, num_cls: int, code_size: int,
                 reg_list=None, num_middle: int = 0, middle_ch: int = 0, nbins=None):
        super().__init__()
        f32 = torch.float32
        mids = []
        for _ in range(num_middle):
            mids.append(ConvBNReLU(cin, middle_ch, 3))
            cin = middle_ch
        self.conv_mid = nn.Sequential(*mids)
        self.num_anchors = num_anchors
        self.conv_cls = Conv2d(cin, num_anchors * num_cls, 1, bias=True, dtype=f32)
        if reg_list:
            self.conv_box = nn.ModuleDict({
                f"conv_{name}": Conv2d(cin, num_anchors * ch, 1, bias=True, dtype=f32)
                for name, ch in reg_list})
        else:
            self.conv_box = Conv2d(cin, num_anchors * code_size, 1, bias=True, dtype=f32)
        self.conv_dir_cls = (None if nbins is None else
                             Conv2d(cin, num_anchors * nbins, 1, bias=True, dtype=f32))

    def forward(self, x):
        """(cls (B, H, W, A, classes), box (B, H, W, A, code), dir or None)."""
        for block in self.conv_mid:
            x = _conv_bn_relu_f32(block, x)
        b, h, w, _ = x.shape
        a = self.num_anchors
        split = lambda t: t.reshape(b, h, w, a, -1)  # noqa: E731
        if isinstance(self.conv_box, nn.ModuleDict):
            box = torch.cat([split(conv(x)) for conv in self.conv_box.values()], dim=-1)
        else:
            box = split(self.conv_box(x))
        return (split(self.conv_cls(x)), box,
                None if self.conv_dir_cls is None else split(self.conv_dir_cls(x)))


@DENSE_HEADS.register
class AnchorHeadMulti(nn.Module):
    """The grouped multi-head RPN (pcdet anchor_head_multi.py role, as
    ``com_tpu`` builds it): ``shared_conv`` (a 3x3 ConvBNReLU to
    SHARED_CONV_NUM_FILTER, its norm in f32), then one ``SingleHead`` a
    RPN_HEAD_CFGS entry in ``rpn_heads``.  Each head's anchors are the
    slots of its classes; the heads' blocks are concatenated at each cell
    in config order, the flat class-blocked layout of ``build_anchors``.
    The classes a head does not predict get the logit -20 (sigmoid ~2e-9;
    pcdet never computes them).  The box code is SEPARATE_REG_CONFIG's
    REG_LIST summed, else 7 (``BOX_CODER_CONFIG`` is not read here, as in
    ``com_tpu``)."""

    FILLER = -20.0

    def __init__(self, model_cfg, input_channels: int, num_class: int, class_names):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        class_names = tuple(class_names)
        shared_ch = int(model_cfg.get("SHARED_CONV_NUM_FILTER", 64))
        self.shared_conv = ConvBNReLU(input_channels, shared_ch, 3)
        per_loc = anchors_per_location(model_cfg["ANCHOR_GENERATOR_CONFIG"])
        sep = model_cfg.get("SEPARATE_REG_CONFIG")
        reg_list = ([(r.split(":")[0], int(r.split(":")[1])) for r in sep["REG_LIST"]]
                    if sep else None)
        code_size = sum(ch for _, ch in reg_list) if reg_list else 7
        nbins = (int(model_cfg.get("NUM_DIR_BINS", 2))
                 if model_cfg.get("USE_DIRECTION_CLASSIFIER", False) else None)
        self.rpn_heads = nn.ModuleList()
        self.head_class_index = []
        for head_cfg in model_cfg["RPN_HEAD_CFGS"]:
            names = list(head_cfg["HEAD_CLS_NAME"])
            self.head_class_index.append([class_names.index(n) for n in names])
            self.rpn_heads.append(SingleHead(
                shared_ch, sum(per_loc[n] for n in names), len(names), code_size, reg_list,
                int(sep.get("NUM_MIDDLE_CONV", 0)) if sep else 0,
                int(sep.get("NUM_MIDDLE_FILTER", shared_ch)) if sep else 0, nbins))

    def forward(self, batch):
        x = _conv_bn_relu_f32(self.shared_conv, batch["spatial_features_2d"])
        b, h, w, _ = x.shape
        cls_blocks, box_blocks, dir_blocks = [], [], []
        for head, index in zip(self.rpn_heads, self.head_class_index):
            cls, box, dir_cls = head(x)
            full = cls.new_full((*cls.shape[:4], self.num_class), self.FILLER)
            cls_blocks.append(full.index_copy(4, torch.tensor(index, device=cls.device), cls))
            box_blocks.append(box)
            if dir_cls is not None:
                dir_blocks.append(dir_cls)
        batch["cls_preds_raw"] = torch.cat(cls_blocks, dim=3).reshape(b, h, w, -1)
        batch["box_preds_raw"] = torch.cat(box_blocks, dim=3).reshape(b, h, w, -1)
        if dir_blocks:
            batch["dir_cls_preds_raw"] = torch.cat(dir_blocks, dim=3).reshape(b, h, w, -1)
        return batch


def reshape_anchor_preds(batch, num_class, code_size=7, nbins=2):
    """(B, H, W, A * X) -> (B, H * W * A, X), the layout of ``build_anchors``."""
    cls = batch["cls_preds_raw"]
    b = cls.shape[0]
    dir_raw = batch.get("dir_cls_preds_raw")
    return (cls.reshape(b, -1, num_class), batch["box_preds_raw"].reshape(b, -1, code_size),
            None if dir_raw is None else dir_raw.reshape(b, -1, nbins))


def decode_anchor_boxes(batch, anchors_flat, num_class, box_coder: ResidualCoder,
                        dir_cfg=None):
    """Every anchor's prediction as a box, its best class score and label.

    anchors_flat: (A, 7) tensor in the predictions' layout.  With ``dir_cfg``
    the direction bin sets the heading's half turn.  Returns boxes (B, A,
    code), scores (B, A), labels (B, A) int32 1-based."""
    cls_flat, box_flat, dir_flat = reshape_anchor_preds(batch, num_class,
                                                        code_size=box_coder.code_size)
    cls_scores = torch.sigmoid(cls_flat)
    scores = cls_scores.max(dim=-1).values
    boxes = box_coder.decode(box_flat, anchors_flat[None])
    if dir_flat is not None and dir_cfg is not None:
        dir_offset = float(dir_cfg.get("DIR_OFFSET", 0.78539))
        dir_limit = float(dir_cfg.get("DIR_LIMIT_OFFSET", 0.0))
        nbins = int(dir_cfg.get("NUM_DIR_BINS", 2))
        dir_labels = torch.argmax(dir_flat, dim=-1)
        period = 2 * math.pi / nbins
        rot = boxes[..., 6] - dir_offset
        rot = rot - torch.floor(rot / period + dir_limit) * period
        boxes = torch.cat([boxes[..., :6], (rot + dir_offset + period * dir_labels)[..., None],
                           boxes[..., 7:]], dim=-1)
    labels = torch.argmax(cls_scores, dim=-1).to(torch.int32) + 1
    return boxes, scores, labels


def top_candidates(scores, k: int):
    """The top ``k`` scores along the last axis with ties to the lower index,
    as ``lax.top_k``: a stable descending sort, sliced."""
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def anchor_post_process(boxes, scores, labels, nms_cfg, score_thresh=0.1,
                        num_classes: int | None = None):
    """Top ``NMS_PRE_MAXSIZE`` by score, the score filter, then rotated NMS
    (``MULTI_CLASSES_NMS``: within each class).  Returns (boxes, scores,
    labels, valid), each (B, NMS_POST_MAXSIZE, ...)."""
    pre = int(nms_cfg.get("NMS_PRE_MAXSIZE", 4096))
    post = int(nms_cfg.get("NMS_POST_MAXSIZE", 500))
    multi = bool(nms_cfg.get("MULTI_CLASSES_NMS", False)) and num_classes
    top_sc, idx = top_candidates(scores, min(pre, scores.shape[1]))
    top_bx = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
    top_lb = torch.gather(labels, 1, idx)
    valid = top_sc > score_thresh
    thresh = float(nms_cfg["NMS_THRESH"])
    if multi:
        sel, sel_valid = multi_class_nms_bev(top_bx, top_sc, top_lb, valid, int(num_classes),
                                             thresh, post)
    else:
        sel, sel_valid = nms_bev(top_bx, top_sc, valid, thresh, post)
    return (torch.gather(top_bx, 1, sel[..., None].expand(-1, -1, top_bx.shape[-1])),
            torch.gather(top_sc, 1, sel), torch.gather(top_lb, 1, sel), sel_valid)
