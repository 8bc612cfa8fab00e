"""MPPNet's RoI and trajectory target sampling (counterpart of ``com_tpu/
models/mppnet/targets.py``; pcdet ProposalTargetLayerMPPNet,
mppnet_head.py:15-296), over the batch at once with fixed shapes.

The sampling is deterministic, as the JAX package's: foregrounds ranked by
their IoU, backgrounds by their proposal score, every sort stable on the
negated key as ``jnp.argsort(-key)``.  There is no RoI or trajectory
augmentation: ``USE_ROI_AUG`` and ``USE_TRAJ_AUG`` are read by no code of
the JAX package, and by none here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...ops.iou import boxes_iou3d
from ..roi_heads.proposal_layer import take_rows
from ..roi_heads.roi_targets import canonical_transform


class MPPNetTargets(NamedTuple):
    trajectory_rois: torch.Tensor  # (B, F, R, D) the sampled trajectories
    valid_length: torch.Tensor  # (B, F, R)
    rois: torch.Tensor  # (B, R, 7) their frame-0 boxes
    roi_scores: torch.Tensor  # (B, R)
    roi_labels: torch.Tensor  # (B, R)
    gt_of_rois_ct: torch.Tensor  # (B, R, 7) the matched GT in the RoI's frame
    gt_of_rois_src: torch.Tensor  # (B, R, 7) the matched GT in the world frame
    cls_labels: torch.Tensor  # (B, R) soft IoU labels, -1 = ignore
    reg_valid: torch.Tensor  # (B, R) the foreground mask


def canonical_gt(gt_boxes, rois):
    """The GT in the RoI's frame (centre at the origin, heading along x):
    the centre and heading of ``canonical_transform``, the GT's own size."""
    rel = canonical_transform(gt_boxes, rois)
    return torch.cat([rel[..., 0:3], gt_boxes[..., 3:6], rel[..., 6:7]], dim=-1)


def _ranks(key):
    """Each entry's place in the stable descending order of ``key`` (B, P)."""
    order = torch.argsort(-key, dim=1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(key.shape[1], device=key.device).expand_as(order))
    return ranks


def sample_mppnet_targets(trajectory, valid_length, roi_scores, roi_labels, gt_boxes,
                          roi_per_image: int = 96, fg_ratio: float = 0.5,
                          reg_fg_thresh: float = 0.55, cls_fg_thresh: float = 0.75,
                          cls_bg_thresh: float = 0.25,
                          sample_by_class: bool = True) -> MPPNetTargets:
    """``roi_per_image`` trajectories a sample out of P: trajectory (B, F, P,
    D), valid_length (B, F, P), roi_scores (B, P), roi_labels (B, P),
    gt_boxes (B, M, 8) with the class last (0 = padding).  A frame-0 box
    (non-zero) is foreground when its best 3D IoU against a GT (of its own
    class with ``sample_by_class``) reaches ``reg_fg_thresh``; the best
    ``round(roi_per_image * fg_ratio)`` foregrounds by IoU come first, every
    other slot goes to the backgrounds by score (a sparse frame's
    foreground quota is backfilled), slots past the valid proposals are
    zero trajectories with class label -1."""
    fg_cap = int(round(roi_per_image * fg_ratio))
    roi = trajectory[:, 0]  # (B, P, D)
    valid = torch.abs(roi[..., :6]).sum(-1) > 0
    gt_valid = gt_boxes[..., -1] > 0
    iou = boxes_iou3d(roi[..., :7], gt_boxes[..., :7])  # (B, P, M)
    keep = gt_valid[:, None, :] & valid[:, :, None]
    if sample_by_class:
        keep = keep & (roi_labels.to(torch.int32)[:, :, None]
                       == gt_boxes[..., -1].to(torch.int32)[:, None, :])
    iou = torch.where(keep, iou, torch.zeros_like(iou))
    max_iou, gt_idx = iou.max(dim=2)

    is_fg = (max_iou >= reg_fg_thresh) & valid
    neg_inf = torch.full_like(max_iou, -math.inf)
    fg_key = torch.where(is_fg, max_iou, neg_inf)
    fg_in = is_fg & (_ranks(fg_key) < fg_cap)
    bg_key = torch.where(~is_fg & valid, roi_scores.to(max_iou.dtype), neg_inf)
    prio = torch.where(fg_in, 4.0 + torch.nan_to_num(fg_key, neginf=0.0), bg_key)
    sel = torch.argsort(-prio, dim=1, stable=True)[:, :roi_per_image]  # (B, R)
    sel_valid = torch.isfinite(torch.gather(prio, 1, sel))

    straj = torch.gather(trajectory, 2, sel[:, None, :, None].expand(
        -1, trajectory.shape[1], -1, trajectory.shape[-1]))
    straj = straj * sel_valid[:, None, :, None].to(straj.dtype)
    svlen = torch.gather(valid_length, 2, sel[:, None, :].expand(-1, valid_length.shape[1], -1))
    svlen = svlen * sel_valid[:, None, :].to(svlen.dtype)
    sroi = straj[:, 0, :, :7]
    siou = torch.gather(max_iou, 1, sel)
    sgt = take_rows(gt_boxes, torch.gather(gt_idx, 1, sel))
    sfg = torch.gather(is_fg, 1, sel) & sel_valid

    cls = torch.clamp((siou - cls_bg_thresh) / (cls_fg_thresh - cls_bg_thresh), 0.0, 1.0)
    cls = torch.where(siou >= cls_fg_thresh, torch.ones_like(cls), cls)
    cls = torch.where(siou <= cls_bg_thresh, torch.zeros_like(cls), cls)
    cls = torch.where(sel_valid, cls, torch.full_like(cls, -1.0))
    return MPPNetTargets(straj, svlen, sroi, torch.gather(roi_scores, 1, sel),
                         torch.gather(roi_labels, 1, sel), canonical_gt(sgt[..., :7], sroi),
                         sgt[..., :7], cls, sfg)
