"""RoI target assignment (counterpart of ``com_tpu/models/roi_heads/
roi_targets.py``; pcdet proposal_target_layer.py and the target plumbing
of roi_head_template.py): match the proposals to the GT by rotated 3D IoU
within their class, pick a fixed mix of foreground and background RoIs,
and emit IoU-derived soft class labels and canonical-frame regression
targets, over the batch at once.

Sampling is random when the caller gives uniforms ``u`` (B, P), one a
proposal, or a ``torch.Generator`` to draw them from (under a data mesh
the rank's rows of the global batch's draw, ``parallel.sharding.
rank_rand``): foregrounds uniform,
backgrounds split into a hard tier (IoU >= CLS_BG_THRESH_LO) holding
HARD_BG_RATIO of the background slots and an easy tier, random within
each, unfilled slots backfilled.  Without either it is deterministic
(foregrounds by IoU, backgrounds by score), as the JAX package's branch
without a key.  Every sort is stable on the negated key, as
``jnp.argsort(-key)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...ops.iou import boxes_iou3d
from ...parallel.sharding import rank_rand
from .proposal_layer import take_rows

_TWO_PI = 2 * math.pi


class RoITargets(NamedTuple):
    rois: torch.Tensor  # (B, R, 7)
    roi_valid: torch.Tensor  # (B, R)
    roi_scores: torch.Tensor  # (B, R)
    roi_labels: torch.Tensor  # (B, R) int32
    gt_iou: torch.Tensor  # (B, R) max IoU against the GT
    cls_labels: torch.Tensor  # (B, R) soft IoU labels in [0, 1], -1 = ignore
    reg_targets: torch.Tensor  # (B, R, 7) canonical-frame encodings
    reg_valid: torch.Tensor  # (B, R) foreground mask
    gt_of_rois_src: torch.Tensor  # (B, R, 7) the matched GT in the world frame


def _mod(x, period):
    """``jnp.mod``: the remainder with the divisor's sign."""
    r = torch.fmod(x, period)
    return torch.where((r != 0) & (r < 0), r + period, r)


def canonical_transform(gt_boxes, rois):
    """The GT encoded in each RoI's frame (roi_head_template's regression
    target).  A heading opposite the RoI's (between a quarter and three
    quarters of a turn off) is flipped by pi, then clamped to [-pi/2,
    pi/2] (roi_head_template.py:125-130)."""
    cos, sin = torch.cos(-rois[..., 6]), torch.sin(-rois[..., 6])
    dx = gt_boxes[..., 0] - rois[..., 0]
    dy = gt_boxes[..., 1] - rois[..., 1]
    h = _mod(gt_boxes[..., 6] - rois[..., 6], _TWO_PI)
    opposite = (h > math.pi * 0.5) & (h < math.pi * 1.5)
    h = torch.where(opposite, _mod(h + math.pi, _TWO_PI), h)
    h = torch.where(h > math.pi, h - _TWO_PI, h)
    return torch.stack([dx * cos - dy * sin, dx * sin + dy * cos,
                        gt_boxes[..., 2] - rois[..., 2],
                        gt_boxes[..., 3] - rois[..., 3],
                        gt_boxes[..., 4] - rois[..., 4],
                        gt_boxes[..., 5] - rois[..., 5],
                        torch.clamp(h, -math.pi / 2, math.pi / 2)], dim=-1)


def decode_rcnn_boxes(rois, reg):
    """Inverse of ``canonical_transform``: RCNN deltas on the RoIs -> world
    boxes."""
    yaw = rois[..., 6]
    cos, sin = torch.cos(yaw), torch.sin(yaw)
    return torch.stack([rois[..., 0] + (reg[..., 0] * cos - reg[..., 1] * sin),
                        rois[..., 1] + (reg[..., 0] * sin + reg[..., 1] * cos),
                        rois[..., 2] + reg[..., 2],
                        rois[..., 3] + reg[..., 3],
                        rois[..., 4] + reg[..., 4],
                        rois[..., 5] + reg[..., 5],
                        yaw + reg[..., 6]], dim=-1)


def _desc_order(key):
    """Indices sorting ``key`` descending, ties to the lower index."""
    return torch.argsort(-key, dim=-1, stable=True)


def _rank(key):
    """Each entry's position in ``_desc_order(key)``."""
    return torch.argsort(_desc_order(key), dim=-1, stable=True)


def assign_roi_targets(rois, roi_scores, roi_labels, roi_valid, gt_boxes,
                       roi_per_image: int = 128, fg_ratio: float = 0.5,
                       reg_fg_thresh: float = 0.55, cls_fg_thresh: float = 0.75,
                       cls_bg_thresh: float = 0.25, cls_bg_thresh_lo: float = 0.1,
                       hard_bg_ratio: float = 0.8, generator: torch.Generator | None = None,
                       u: torch.Tensor | None = None) -> RoITargets:
    """rois (B, P, 7), roi_scores (B, P), roi_labels (B, P) int, roi_valid
    (B, P), gt_boxes (B, M, 8) (class in the last column, 0 = padding).
    ``u`` (B, P) in [0, 1), or ``generator`` to draw it, selects the random
    branch.  Returns ``RoITargets`` of ``roi_per_image`` RoIs a scene."""
    fg_cap = int(roi_per_image * fg_ratio)
    bg_cap = roi_per_image - fg_cap
    hard_cap = int(bg_cap * hard_bg_ratio)
    neg_inf = torch.tensor(-math.inf, dtype=rois.dtype, device=rois.device)

    gt_valid = gt_boxes[..., -1] > 0
    iou = boxes_iou3d(rois[..., :7], gt_boxes[..., :7])  # (B, P, M)
    same = roi_labels[:, :, None] == gt_boxes[:, None, :, -1].to(torch.int32)
    iou = torch.where(gt_valid[:, None, :] & roi_valid[:, :, None] & same, iou,
                      torch.zeros_like(iou))
    max_iou = iou.max(dim=-1).values
    gt_idx = iou.argmax(dim=-1)  # ties to the lower index, as jnp.argmax

    is_fg = (max_iou >= reg_fg_thresh) & roi_valid
    is_bg = ~is_fg & roi_valid
    if u is not None or generator is not None:
        if u is None:
            u = rank_rand(max_iou.shape, generator, rois.device)
        fg_key = torch.where(is_fg, u, neg_inf)
        hard = is_bg & (max_iou >= cls_bg_thresh_lo)
        easy = is_bg & ~hard
        # hard in (2, 3) within its quota, then easy in (1, 2), then the hard
        # overflow in (0, 1) as filler
        in_quota = hard & (_rank(torch.where(hard, u, neg_inf)) < hard_cap)
        bg_key = torch.where(in_quota, 2.0 + u,
                             torch.where(easy, 1.0 + u, torch.where(hard, u, neg_inf)))
    else:
        fg_key = torch.where(is_fg, max_iou, neg_inf)
        bg_key = torch.where(is_bg, roi_scores, neg_inf)
    # foregrounds within their quota outrank every background tier; the
    # unused foreground slots go to the backgrounds in tier order
    fg_in = is_fg & (_rank(fg_key) < fg_cap)
    prio = torch.where(fg_in, 4.0 + torch.nan_to_num(fg_key, neginf=0.0), bg_key)
    sel = _desc_order(prio)[:, :roi_per_image]
    sel_valid = torch.isfinite(take_rows(prio, sel))

    sroi = take_rows(rois, sel)
    siou = take_rows(max_iou, sel)
    sgt = take_rows(gt_boxes, take_rows(gt_idx, sel))
    sfg = take_rows(fg_in, sel) & sel_valid

    cls = torch.clamp((siou - cls_bg_thresh) / (cls_fg_thresh - cls_bg_thresh), 0.0, 1.0)
    cls = torch.where(siou >= cls_fg_thresh, torch.ones_like(cls), cls)
    cls = torch.where(siou <= cls_bg_thresh, torch.zeros_like(cls), cls)
    cls = torch.where(sel_valid, cls, torch.full_like(cls, -1.0))
    return RoITargets(sroi, sel_valid, take_rows(roi_scores, sel), take_rows(roi_labels, sel),
                      siou, cls, canonical_transform(sgt[..., :7], sroi[..., :7]), sfg,
                      sgt[..., :7])
