"""Axis-aligned anchor target assignment, batched (counterpart of
``com_tpu/models/dense_heads/anchor_assign.py``; pcdet
AxisAlignedTargetAssigner and CurriculumAxisAlignedTargetAssigner).

Per class, max-IoU matching of the dense anchors to the padded GT boxes
with force-matching of each GT's best anchors; positive anchors take their
GT's box target (``ResidualCoder``) and COM difficulty group id.  The JAX
package vmaps over the batch; here it is a leading axis.  The ATSS assigner
waits for a later slice.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...ops.boxes import ResidualCoder
from ...ops.iou import boxes_iou_aligned_bev


class AnchorTargets(NamedTuple):
    box_cls_labels: torch.Tensor   # (B, A) int32: class id, 0 background, -1 ignored
    box_reg_targets: torch.Tensor  # (B, A, code)
    reg_weights: torch.Tensor      # (B, A)
    groups: torch.Tensor           # (B, A) int32 COM group of the matched GT (0 none)


def nearest_bev_iou(boxes_a, boxes_b):
    """Axis-aligned BEV IoU after snapping headings to the nearest axis
    (box_utils.boxes3d_nearest_bev_iou)."""
    return boxes_iou_aligned_bev(boxes_a, boxes_b)


def assign_anchors_single_class(anchors, gt_boxes, gt_valid, gt_groups,
                                matched_threshold: float, unmatched_threshold: float,
                                box_coder: ResidualCoder, class_id: int):
    """One class's assignment over a batch.

    anchors (A, 7); gt_boxes (B, M, 7); gt_valid (B, M) bool, this class's
    real boxes; gt_groups (B, M) int32.  Returns (labels (B, A) int32:
    class_id positive, 0 negative, -1 ignored; targets (B, A, code); groups
    (B, A) int32).  An anchor whose IoU equals a GT's best (> 0) is forced
    positive, to the first such GT; ties of argmax go to the first index."""
    iou = nearest_bev_iou(anchors[None], gt_boxes)  # (B, A, M)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    anchor_best = iou.max(dim=2).values
    anchor_best_gt = torch.argmax(iou, dim=2)
    gt_best = iou.max(dim=1).values  # (B, M)
    force = iou == torch.where(gt_valid & (gt_best > 0), gt_best,
                               torch.full_like(gt_best, math.inf))[:, None, :]
    force_any = force.any(dim=2)
    force_gt = torch.argmax(force.to(torch.uint8), dim=2)

    pos = (anchor_best >= matched_threshold) | force_any
    neg = anchor_best < unmatched_threshold
    labels = torch.where(pos, class_id, torch.where(neg, 0, -1)).to(torch.int32)
    assigned = torch.where(force_any, force_gt, anchor_best_gt)  # (B, A)
    tgt_boxes = torch.gather(gt_boxes, 1, assigned[..., None].expand(-1, -1, 7))
    targets = box_coder.encode(tgt_boxes, anchors[None].expand(tgt_boxes.shape[0], -1, -1))
    targets = targets * pos[..., None].to(targets.dtype)
    groups = torch.where(pos, torch.gather(gt_groups, 1, assigned),
                         torch.zeros_like(assigned)).to(torch.int32)
    return labels, targets, groups


def assign_anchor_targets(anchors_flat, per_class_index, gt_boxes, gt_groups, class_ids,
                          matched_thresholds, unmatched_thresholds,
                          box_coder: ResidualCoder) -> AnchorTargets:
    """Assignment over every class in the flat anchor layout.

    anchors_flat (A, 7) and per_class_index [(A_c,) int64] tensors on the
    batch's device; gt_boxes (B, M, 8), the class id in the last column
    (0: padding); gt_groups (B, M) int32.  The regression weight of a
    positive anchor is 1 over its sample's positive count."""
    b = gt_boxes.shape[0]
    a_total = anchors_flat.shape[0]
    dev = gt_boxes.device
    gclass = gt_boxes[..., -1].to(torch.int32)
    labels = torch.zeros((b, a_total), dtype=torch.int32, device=dev)
    targets = torch.zeros((b, a_total, box_coder.code_size), dtype=anchors_flat.dtype,
                          device=dev)
    groups = torch.zeros((b, a_total), dtype=torch.int32, device=dev)
    for ci, (idx, cid) in enumerate(zip(per_class_index, class_ids)):
        lab, tgt, grp = assign_anchors_single_class(
            anchors_flat[idx], gt_boxes[..., :7], gclass == cid, gt_groups,
            float(matched_thresholds[ci]), float(unmatched_thresholds[ci]), box_coder, cid)
        labels[:, idx] = lab
        targets[:, idx] = tgt
        groups[:, idx] = grp
    reg_w = (labels > 0).to(torch.float32)
    reg_w = reg_w / torch.clamp(reg_w.sum(dim=1, keepdim=True), min=1.0)
    return AnchorTargets(labels, targets, reg_w, groups)


def atss_assign_targets(*args, **kwargs):
    """The ATSS assigner (``com_tpu``'s ``atss_assign_targets``) waits for a
    later slice, with AnchorHeadMulti."""
    raise NotImplementedError("ATSSTargetAssigner is not ported yet")
