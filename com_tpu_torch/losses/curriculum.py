"""COMLoss: the curriculum focal loss of the CenterPoint path.

Counterpart of ``com_tpu/losses/curriculum.py`` (FocalLossCenterCurriculum,
pcdet loss_utils.py:998-1309):

* each object's confidence is the sigmoid heatmap at its GT center;
* an EMA of the mean positive confidence sets the easy/hard threshold
  (the merge variant keeps an EMA of the mean and std instead);
* each object's weight h / (1 + exp(e (p - thr))) + 1 - h/2 is stamped as a
  constant square into a per-pixel heatmap mask (kernel K3, last_wins) and
  weights its regression loss;
* per-(class, difficulty-group) confidence sums and counts go back to the
  COMAug sampler at the epoch's end.

The EMA lives in an explicit ``CurriculumState`` of 0-d tensors carried by
the train state.  ``.detach()`` stands where the JAX package has
``stop_gradient``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.dense_heads.target_assign import CenterTargets
from ..ops.gaussian import stamp_squares_batched
from ..parallel.sharding import global_sum
from .centernet import focal_loss_centernet


class CurriculumState(NamedTuple):
    """EMA statistics carried across steps (0-d tensors on the device)."""

    avg_confidence: torch.Tensor  # f32 EMA of the mean positive confidence
    mean: torch.Tensor            # f32 EMA mean of positive-pixel scores (merge)
    std: torch.Tensor             # f32 EMA std of positive-pixel scores (merge)
    initialized: torch.Tensor     # bool: the first batch with objects seeded mean/std

    @classmethod
    def create(cls, device=None):
        z = torch.zeros((), dtype=torch.float32, device=device)
        return cls(z, z.clone(), z.clone(), torch.zeros((), dtype=torch.bool, device=device))


class CurriculumAux(NamedTuple):
    confidence_sum: torch.Tensor  # (num_class, num_groups)
    confidence_cnt: torch.Tensor  # (num_class, num_groups)
    avg_confidence: torch.Tensor  # () batch mean positive confidence
    box_mask: torch.Tensor        # (B, M) regression weights


def _object_confidences(pred_hm, targets: CenterTargets):
    """The (detached) heatmap value at each GT center, in its class: (B, M)."""
    b, h, w, c = pred_hm.shape
    flat = pred_hm.detach().reshape(b, h * w, c)
    at_cell = torch.gather(flat, 1, targets.inds.long()[..., None].expand(-1, -1, c))
    return torch.gather(at_cell, 2, targets.class_local.long()[..., None])[..., 0]


def group_confidences(pred_hm, targets: CenterTargets, num_class, num_groups):
    """Per-(class, group) confidence sums and counts
    (confidence_of_all_groups, loss_utils.py:1160-1177); rows are global
    classes."""
    p = _object_confidences(pred_hm, targets)
    valid = (targets.mask > 0) & (targets.group >= 1)
    seg = targets.class_global.long() * num_groups + (targets.group.long() - 1)
    seg = torch.where(valid, seg, num_class * num_groups).reshape(-1)
    n = num_class * num_groups + 1
    zeros = torch.zeros(n, dtype=torch.float32, device=p.device)
    sums = zeros.index_add(0, seg, torch.where(valid, p, 0.0).reshape(-1).float())
    cnts = zeros.index_add(0, seg, valid.reshape(-1).to(torch.float32))
    return sums[:-1].reshape(num_class, num_groups), cnts[:-1].reshape(num_class, num_groups)


def focal_loss_center_curriculum(pred_hm, targets: CenterTargets, state: CurriculumState,
                                 curriculum_cfg, epoch, num_class: int, num_groups: int):
    """Returns (loss, new_state, CurriculumAux); ``pred_hm`` is post-sigmoid."""
    cfg = curriculum_cfg
    alpha = float(cfg.get("ALPHA", 0.001))
    use_curriculum = bool(cfg.get("UCL", True))
    fix_threshold = bool(cfg.get("FIX", False))
    threshold_cfg = float(cfg.get("THRESHOLD", 0.2))
    elongation = float(cfg.get("ELONGATION", -10))
    height = float(cfg.get("HEIGHT", 1))
    start_epoch = int(cfg.get("START", 0))
    end_epoch = int(cfg.get("END", 30))
    straight = bool(cfg.get("STRAIGHT", False))
    tuning = bool(cfg.get("TUNING", False))
    k_straight = float(cfg.get("K", 1.0))
    add_radius = int(cfg.get("ADD", 0))
    fixed_radius = int(cfg.get("RADIUS", 0))
    only_center = bool(cfg.get("CENTER", False))
    merge_scores = bool(cfg.get("MERGE_SCORES", False))
    offset = float(cfg.get("OFFSET", 0))

    gt = targets.heatmaps
    pos_inds = (gt == 1.0).to(pred_hm.dtype)
    num_obj = pos_inds.sum()
    p_pos_sum = (pred_hm * pos_inds).sum().detach()
    p_pos_sq = (pred_hm * pred_hm * pos_inds).sum().detach()
    # the EMA's batch statistics over every rank: one threshold for all
    num_obj, p_pos_sum, p_pos_sq = global_sum(num_obj, p_pos_sum, p_pos_sq)
    n_clip = torch.clamp(num_obj, min=1.0)
    batch_avg_conf = p_pos_sum / n_clip
    batch_std = torch.sqrt(torch.clamp(p_pos_sq / n_clip - batch_avg_conf ** 2, min=0.0))
    # EMA (the reference seeds avg from 0 and always EMAs; the merge variant
    # seeds mean/std from the first batch with objects)
    new_avg = alpha * batch_avg_conf + (1 - alpha) * state.avg_confidence
    has = num_obj > 0
    new_mean = torch.where(has, torch.where(state.initialized,
                                            (1 - alpha) * state.mean + alpha * batch_avg_conf,
                                            batch_avg_conf), state.mean)
    new_std = torch.where(has, torch.where(state.initialized,
                                           (1 - alpha) * state.std + alpha * batch_std,
                                           batch_std), state.std)
    new_state = CurriculumState(new_avg, new_mean, new_std, state.initialized | has)

    conf_sum, conf_cnt = group_confidences(pred_hm, targets, num_class, num_groups)

    box_mask = targets.mask
    hm_mask = None
    if use_curriculum:
        p = _object_confidences(pred_hm, targets)
        if merge_scores:
            threshold = new_mean + offset * new_std
        elif fix_threshold:
            threshold = threshold_cfg
        else:
            threshold = new_avg * threshold_cfg
        if straight:
            weight = k_straight * (p - threshold) + 1.0
        elif tuning:
            weight = torch.ones_like(p)
        else:
            weight = height / (1.0 + torch.exp(elongation * (p - threshold))) + 1.0 - height / 2.0
        in_window = start_epoch <= int(epoch) <= end_epoch
        valid = targets.mask > 0
        box_mask = torch.where(valid & in_window, weight, targets.mask)
        if fixed_radius != 0:
            radius = torch.full_like(targets.radius, fixed_radius)
        else:
            radius = targets.radius + add_radius
        if only_center:
            radius = torch.zeros_like(radius)
        b, h, w, c = pred_hm.shape
        hm_mask = stamp_squares_batched(targets.center_int, radius, targets.class_local, weight,
                                        valid & in_window, c, h, w, fill=1.0).to(pred_hm.dtype)
        hm_mask = hm_mask.permute(0, 2, 3, 1)  # NHWC

    loss = focal_loss_centernet(pred_hm, gt, mask=hm_mask)
    return loss, new_state, CurriculumAux(conf_sum, conf_cnt, batch_avg_conf, box_mask)
