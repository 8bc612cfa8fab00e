"""Point heads (counterpart of ``com_tpu/models/dense_heads/point_head.py``;
pcdet point_head_simple.py, point_head_box.py and
point_intra_part_head.py): ``PointHeadSimple``, PV-RCNN's keypoint
foreground score, and ``point_head_loss``, its focal loss against the
keypoints inside a slightly enlarged GT box; ``PointHeadBox``, PointRCNN's
first stage (a class score and a ``PointResidualCoder`` box a point), and
``point_head_box_loss``; ``PointIntraPartOffsetHead``, PartA2's first
stage (a foreground score and the intra-object part location a point;
with REG_FC, PartA2-free's, a box a point too), and ``point_part_loss``.

Names are pcdet's: ``point_head.cls_layers.{3i}`` (Linear, no bias),
``.{3i + 1}`` (``BatchNorm1d``, statistics over the valid points), then
the biased output layer; ``point_head.box_layers`` and
``part_reg_layers`` likewise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...losses.anchor_losses import sigmoid_ce_with_logits
from ...ops.boxes import PointResidualCoder, enlarge_box3d, points_in_rbbox
from ...parallel.sharding import global_sum
from ...utils.registry import DENSE_HEADS
from ..layers import BatchNorm1d, run_masked


def fc_layers(cin: int, fcs, out: int) -> nn.Sequential:
    """pcdet's make_fc_layers of a point head: [Linear (no bias),
    ``BatchNorm1d``, ReLU] a width, then the biased output layer."""
    layers = []
    for ch in fcs:
        layers += [nn.Linear(cin, ch, bias=False), BatchNorm1d(ch), nn.ReLU()]
        cin = ch
    layers.append(nn.Linear(cin, out))
    return nn.Sequential(*layers)


@DENSE_HEADS.register
class PointHeadSimple(nn.Module):
    """An MLP over ``point_features`` -> ``point_cls_scores_raw`` (B, S)."""

    def __init__(self, model_cfg, input_channels: int, num_class: int = 1):
        super().__init__()
        self.model_cfg = model_cfg
        self.cls_layers = fc_layers(int(input_channels), model_cfg.get("CLS_FC", [256, 256]), 1)

    def forward(self, batch):
        x = run_masked(self.cls_layers, batch["point_features"], batch.get("point_valid"))
        batch["point_cls_scores_raw"] = x[..., 0]
        return batch


def point_box_coder(model_cfg) -> PointResidualCoder:
    return PointResidualCoder(**dict(model_cfg.get("TARGET_CONFIG", {}).get("BOX_CODER_CONFIG",
                                                                            {})))


@DENSE_HEADS.register
class PointHeadBox(nn.Module):
    """Class logits "point_cls_preds" (B, N, num_class) and box codes
    "point_box_preds_raw" (B, N, 8) a point; "point_cls_scores" the sigmoid
    of the largest logit, "point_pred_labels" its class (1-based),
    "point_box_preds" the codes decoded at the points for that class."""

    def __init__(self, model_cfg, input_channels: int, num_class: int = 3):
        super().__init__()
        self.model_cfg = model_cfg
        self.box_coder = point_box_coder(model_cfg)
        self.cls_layers = fc_layers(int(input_channels), model_cfg.get("CLS_FC", [256, 256]),
                                    num_class)
        self.box_layers = fc_layers(int(input_channels), model_cfg.get("REG_FC", [256, 256]),
                                    self.box_coder.code_size)

    def forward(self, batch):
        feats, valid = batch["point_features"], batch.get("point_valid")
        cls = run_masked(self.cls_layers, feats, valid)
        box = run_masked(self.box_layers, feats, valid)
        batch["point_cls_preds"] = cls
        batch["point_box_preds_raw"] = box
        batch["point_cls_scores"] = torch.sigmoid(cls.max(dim=-1).values)
        labels = cls.argmax(dim=-1) + 1
        batch["point_box_preds"] = self.box_coder.decode(box, batch["point_coords"], labels)
        batch["point_pred_labels"] = labels
        return batch


@DENSE_HEADS.register
class PointIntraPartOffsetHead(nn.Module):
    """PartA2's first-stage point head (point_intra_part_head.py): class
    logits "point_cls_preds" (B, N, num_class) and their largest,
    "point_cls_scores_raw", with its sigmoid "point_cls_scores"; the
    intra-object part location "point_part_logits" (B, N, 3) and its
    sigmoid "point_part_offset".  With REG_FC (PartA2-free, the head that
    makes the proposals) also PointHeadBox's box codes, decoded boxes and
    labels.  Branch widths default to [128]."""

    def __init__(self, model_cfg, input_channels: int, num_class: int = 1):
        super().__init__()
        self.model_cfg = model_cfg
        cin = int(input_channels)
        self.cls_layers = fc_layers(cin, model_cfg.get("CLS_FC", [128]), num_class)
        self.part_reg_layers = fc_layers(cin, model_cfg.get("PART_FC", [128]), 3)
        self.box_coder = self.box_layers = None
        if "REG_FC" in model_cfg:
            self.box_coder = point_box_coder(model_cfg)
            self.box_layers = fc_layers(cin, model_cfg["REG_FC"], self.box_coder.code_size)

    def forward(self, batch):
        feats, valid = batch["point_features"], batch.get("point_valid")
        cls = run_masked(self.cls_layers, feats, valid)
        part = run_masked(self.part_reg_layers, feats, valid)
        top = cls.max(dim=-1).values
        batch["point_cls_scores_raw"] = top
        batch["point_cls_preds"] = cls
        batch["point_part_offset"] = torch.sigmoid(part)
        batch["point_part_logits"] = part
        batch["point_cls_scores"] = torch.sigmoid(top)
        if self.box_layers is not None:
            box = run_masked(self.box_layers, feats, valid)
            labels = cls.argmax(dim=-1) + 1
            batch["point_box_preds_raw"] = box
            batch["point_box_preds"] = self.box_coder.decode(box, batch["point_coords"], labels)
            batch["point_pred_labels"] = labels
        return batch


def focal_terms(logits, targets):
    """The sigmoid focal loss (alpha 0.25, gamma 2) of each logit."""
    pred = torch.sigmoid(logits)
    alpha, gamma = 0.25, 2.0
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1 - pred) + (1 - targets) * pred
    return alpha_w * torch.pow(pt, gamma) * sigmoid_ce_with_logits(logits, targets)


def point_head_box_loss(batch, model_cfg):
    """PointHeadBox's losses (point_head_template get_cls_layer_loss and
    get_box_layer_loss): a point inside a GT box is of its class (the first
    such box), one inside only the box enlarged by GT_EXTRA_WIDTH is
    ignored, others are background; the focal loss over the one-hot
    classes of the valid, not ignored points over the foreground count,
    and smooth-L1 (beta 1/9) of the foreground points' codes against the
    coder's encoding of their box.  Returns (point_cls_weight x cls +
    point_box_weight x box, {"point_loss_cls", "point_loss_box"})."""
    tc = model_cfg.get("TARGET_CONFIG", {})
    extra = tuple(tc.get("GT_EXTRA_WIDTH", [0.2, 0.2, 0.2]))
    coder = point_box_coder(model_cfg)
    logits, box_raw = batch["point_cls_preds"], batch["point_box_preds_raw"]
    pts = batch["point_coords"]
    pvalid = batch.get("point_valid")
    if pvalid is None:
        pvalid = torch.ones(pts.shape[:2], dtype=torch.bool, device=pts.device)
    gt = batch["gt_boxes"]  # (B, M, 8)
    num_class = logits.shape[-1]

    gt_valid = (gt[..., -1] > 0)[:, None, :]
    inside = points_in_rbbox(pts, gt[..., :7]) & gt_valid
    inside_ext = points_in_rbbox(pts, enlarge_box3d(gt[..., :7], extra)) & gt_valid
    fg = inside.any(dim=-1)
    ignore = inside_ext.any(dim=-1) & ~fg
    gidx = inside.to(torch.uint8).argmax(dim=-1)  # the first box holding the point
    box = torch.gather(gt, 1, gidx[..., None].expand(-1, -1, gt.shape[-1]))
    cls_t = torch.where(fg, box[..., -1].to(torch.int32), torch.zeros_like(gidx, dtype=torch.int32))
    cls_t = torch.where(ignore, torch.full_like(cls_t, -1), cls_t)
    enc_t = coder.encode(box[..., :7], pts, torch.clamp(cls_t, min=1))

    one_hot = F.one_hot(torch.clamp(cls_t, min=0).long(), num_class + 1)[..., 1:].to(logits.dtype)
    cls_valid = (cls_t >= 0) & pvalid
    fg_valid = (cls_t > 0) & pvalid
    per = focal_terms(logits, one_hot)

    fgf = fg_valid.to(torch.float32)
    d = box_raw - enc_t
    ad = torch.abs(d)
    beta = 1.0 / 9.0
    sl1 = torch.where(ad < beta, 0.5 * d ** 2 / beta, ad - 0.5 * beta).sum(dim=-1)
    # the whole batch's sums and counts under a data mesh
    cls_sum, n_fg, box_sum, fg_sum = global_sum((per.sum(dim=-1) * cls_valid).sum(),
                                                fg_valid.sum(), (sl1 * fgf).sum(), fgf.sum())
    cls_loss = cls_sum / torch.clamp(n_fg, min=1)
    box_loss = box_sum / torch.clamp(fg_sum, min=1.0)

    lw = model_cfg.get("LOSS_CONFIG", {}).get("LOSS_WEIGHTS", {})
    total = (cls_loss * float(lw.get("point_cls_weight", 1.0))
             + box_loss * float(lw.get("point_box_weight", 1.0)))
    return total, {"point_loss_cls": cls_loss, "point_loss_box": box_loss}


def point_part_targets(points, gt_boxes, extra_width=(0.2, 0.2, 0.2)):
    """A point's label (1 inside a GT box, -1 only inside the box enlarged
    by ``extra_width``, else 0) and its part target: its place in the
    canonical frame of the first box holding it over the box's size, + 0.5,
    clipped to [0, 1] (0 for background).  points (B, N, 3), gt_boxes (B,
    M, 8) -> (label (B, N), part (B, N, 3))."""
    gt_valid = (gt_boxes[..., -1] > 0)[:, None, :]
    inside = points_in_rbbox(points, gt_boxes[..., :7]) & gt_valid
    inside_ext = points_in_rbbox(points, enlarge_box3d(gt_boxes[..., :7], extra_width)) & gt_valid
    fg = inside.any(dim=-1)
    ignore = inside_ext.any(dim=-1) & ~fg
    gidx = inside.to(torch.uint8).argmax(dim=-1)  # the first box holding the point
    box = torch.gather(gt_boxes, 1, gidx[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    shifted = points - box[..., 0:3]
    c, s = torch.cos(-box[..., 6]), torch.sin(-box[..., 6])
    local = torch.stack([shifted[..., 0] * c - shifted[..., 1] * s,
                         shifted[..., 0] * s + shifted[..., 1] * c, shifted[..., 2]], dim=-1)
    part = local / torch.clamp(box[..., 3:6], min=1e-5) + 0.5
    part = torch.clamp(part, 0.0, 1.0) * fg[..., None].to(part.dtype)
    label = torch.where(ignore, torch.full_like(part[..., 0], -1.0), fg.to(part.dtype))
    return label, part


def point_part_loss(batch, extra_width=(0.2, 0.2, 0.2), include_cls=True):
    """PartA2's point losses (point_head_template get_cls_layer_loss and
    get_part_layer_loss): the focal loss of "point_cls_scores_raw" against
    the foreground over the valid, not ignored points over the foreground
    count, and the mean binary cross-entropy of the part logits against the
    part targets over the foreground points.  ``include_cls`` False leaves
    the class term to the box loss (PartA2-free: the logits are shared).
    Returns (total, {"point_loss_cls"?, "point_loss_part"})."""
    logits, part_logits = batch["point_cls_scores_raw"], batch["point_part_logits"]
    kp_valid = batch.get("point_valid")
    if kp_valid is None:
        kp_valid = torch.ones_like(logits, dtype=torch.bool)
    label, part_t = point_part_targets(batch["point_coords"], batch["gt_boxes"], extra_width)
    fg = torch.clamp(label, 0.0, 1.0)
    cls_valid = ((label >= 0) & kp_valid).to(logits.dtype)
    fg_mask = ((label > 0) & kp_valid).to(logits.dtype)
    part_bce = sigmoid_ce_with_logits(part_logits, part_t)
    # the whole batch's sums and counts under a data mesh
    cls_sum, cls_n, part_sum, part_n = global_sum(
        (focal_terms(logits, fg) * cls_valid).sum(), (fg * cls_valid).sum(),
        (part_bce.mean(dim=-1) * fg_mask).sum(), fg_mask.sum())
    cls_loss = cls_sum / torch.clamp(cls_n, min=1.0)
    part_loss = part_sum / torch.clamp(part_n, min=1.0)
    if not include_cls:
        return part_loss, {"point_loss_part": part_loss}
    return cls_loss + part_loss, {"point_loss_cls": cls_loss, "point_loss_part": part_loss}


def point_head_loss(batch, extra_width=(0.2, 0.2, 0.2)):
    """Focal loss (alpha 0.25, gamma 2) of the keypoints' foreground logits
    against membership of a GT box enlarged by ``extra_width``, over the
    valid keypoints, normalised by the foreground count (at least 1)."""
    logits = batch["point_cls_scores_raw"]  # (B, S)
    kp = batch["point_coords"]
    kp_valid = batch.get("point_valid")
    if kp_valid is None:
        kp_valid = torch.ones_like(logits, dtype=torch.bool)
    gt = batch["gt_boxes"]  # (B, M, 8)
    inside = (points_in_rbbox(kp, enlarge_box3d(gt[..., :7], extra_width))
              & (gt[..., -1] > 0)[:, None, :])
    fg = inside.any(dim=-1).to(torch.float32)
    loss = focal_terms(logits, fg) * kp_valid.to(logits.dtype)
    # the whole batch's sum and count under a data mesh
    total, pos = global_sum(loss.sum(), (fg * kp_valid.to(fg.dtype)).sum())
    return total / torch.clamp(pos, min=1.0)
