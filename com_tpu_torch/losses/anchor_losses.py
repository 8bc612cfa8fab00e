"""Anchor-head losses: sigmoid focal, smooth-L1, direction cross-entropy,
and the COM curriculum focal loss with its explicit EMA state.

Counterpart of ``com_tpu/losses/anchor_losses.py`` (pcdet loss_utils.py:
SigmoidFocalClassificationLoss, WeightedSmoothL1Loss,
WeightedCrossEntropyLoss and CurriculumSigmoidFocalClassificationLoss):
per-class EMA mean and std of the positive anchors' scores set a threshold
T = mean + OFFSET * std; each positive anchor's weight is the COM sigmoid
h / (1 + exp(e (p - T) / var)) + 1 - h / 2 with an epoch-decayed height,
normalised by Gaussian-CDF halves; per-(class, group) confidence sums feed
COMAug.  ``.detach()`` stands where the JAX package has ``stop_gradient``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel.sharding import global_sum


def _norm_cdf(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def sigmoid_ce_with_logits(logits, targets):
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def sigmoid_focal_loss(logits, targets, weights, gamma=2.0, alpha=0.25):
    """(B, A, C) focal loss, weighted by anchor ((B, A)) or element."""
    pred = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1.0 - pred) + (1.0 - targets) * pred
    loss = alpha_w * torch.pow(pt, gamma) * sigmoid_ce_with_logits(logits, targets)
    if weights.dim() == 2:
        weights = weights[..., None]
    return loss * weights


def weighted_smooth_l1(pred, target, weights, beta=1.0 / 9.0, code_weights=None):
    """(B, A, D) smooth-L1; non-finite targets count as no error."""
    diff = pred - torch.where(torch.isfinite(target), target, pred)
    if code_weights is not None:
        diff = diff * torch.as_tensor(list(code_weights), dtype=diff.dtype, device=diff.device)
    n = torch.abs(diff)
    loss = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def weighted_cross_entropy(logits, one_hot, weights):
    """(B, A, C) cross-entropy against one-hot targets, weighted by anchor."""
    return -(one_hot * torch.log_softmax(logits, dim=-1)).sum(-1) * weights


class AnchorCurriculumState(NamedTuple):
    """Per-class EMA of the positive anchors' score statistics."""

    means: torch.Tensor        # (C,) f32
    stds: torch.Tensor         # (C,) f32
    initialized: torch.Tensor  # (C,) bool

    @classmethod
    def create(cls, num_class: int, device=None):
        z = torch.zeros((num_class,), dtype=torch.float32, device=device)
        return cls(z, z.clone(), torch.zeros((num_class,), dtype=torch.bool, device=device))


TRASH_BINS = 4096  # where anchors without a group add their zeros


def anchor_group_confidences(pred_sigmoid, groups, num_class, num_groups=96):
    """Per-(class, group) sums and counts of the (detached) scores of the
    anchors whose one-hot group id (B, A, C) is that group (0: none).  The
    JAX package sends every anchor without a group to one trash segment;
    here they spread over ``TRASH_BINS`` of them by position, since on a
    card millions of atomic adds to one address take milliseconds."""
    c = pred_sigmoid.shape[-1]
    g = groups.to(torch.int64)
    valid = g > 0
    cls_idx = torch.arange(c, device=g.device).expand_as(g)
    n = num_class * num_groups
    trash = n + torch.arange(g.numel(), device=g.device).reshape(g.shape) % TRASH_BINS
    seg = torch.where(valid, cls_idx * num_groups + (g - 1), trash).reshape(-1)
    p = pred_sigmoid.detach().to(torch.float32)
    sums = torch.zeros(n + TRASH_BINS, dtype=torch.float32, device=p.device).index_add_(
        0, seg, torch.where(valid, p, torch.zeros_like(p)).reshape(-1))
    cnts = torch.zeros(n + TRASH_BINS, dtype=torch.float32, device=p.device).index_add_(
        0, seg, valid.to(torch.float32).reshape(-1))
    return sums[:n].reshape(num_class, num_groups), cnts[:n].reshape(num_class, num_groups)


def curriculum_sigmoid_focal_loss(logits, one_hot_targets, weights, groups,
                                  state: AnchorCurriculumState, curriculum_cfg: dict, epoch,
                                  gamma=2.0, alpha=0.25, num_groups=96):
    """logits and one_hot_targets (B, A, C), weights (B, A), groups (B, A, C)
    int (0: none).  Returns (weighted loss (B, A, C), curriculum weight
    (B, A, C), new state, (conf_sums, conf_cnts))."""
    cfg = curriculum_cfg
    use_cl = bool(cfg.get("UCL", True))
    al = float(cfg.get("ALPHA", 0.001))
    elong = float(cfg.get("ELONGATION", -10))
    height_cfg = cfg.get("HEIGHT", 1)
    offset = float(cfg.get("OFFSET", 0))
    inverse = bool(cfg.get("INV", False))
    use_norm = bool(cfg.get("NORM", False))
    pos_weight = float(cfg.get("POSW", 1))
    fixed = bool(cfg.get("FIXED", False))
    oto = bool(cfg.get("OTO", False))
    start_epoch = int(cfg.get("START", 0))
    end_epoch_cfg = cfg.get("END", 30)
    cut_epoch = int(cfg.get("CUT", 10000))
    sm, sma = bool(cfg.get("SM", False)), bool(cfg.get("SMA", False))
    sme = int(cfg.get("SME", 20))
    smt = float(cfg.get("SMT", 0.15))

    pos_norm = 0.5 / max(1.0 - _norm_cdf(offset), 1e-8) * pos_weight
    neg_norm = 0.5 / max(_norm_cdf(offset), 1e-8)

    pred = torch.sigmoid(logits)
    p_det = pred.detach()
    c = logits.shape[-1]
    dev = logits.device
    epoch = float(epoch)
    conf = anchor_group_confidences(pred, groups, c, num_groups)

    new_state = state
    cw = torch.ones_like(pred)
    if use_cl:
        # "positive" anchors are those with a group id > 0 (update_score)
        pos = (groups > 0).to(torch.float32)
        n_pos = pos.sum(dim=(0, 1))
        s1 = (p_det * pos).sum(dim=(0, 1))
        s2 = (p_det * p_det * pos).sum(dim=(0, 1))
        n_pos, s1, s2 = global_sum(n_pos, s1, s2)  # every rank's anchors: one EMA for all
        mean_b = s1 / torch.clamp(n_pos, min=1.0)
        var_b = torch.clamp(s2 / torch.clamp(n_pos, min=1.0) - mean_b ** 2, min=0.0)
        std_b = torch.sqrt(var_b)
        has = n_pos > 0
        means = torch.where(has, torch.where(state.initialized,
                                             (1 - al) * state.means + al * mean_b, mean_b),
                            state.means)
        stds = torch.where(has, torch.where(state.initialized,
                                            (1 - al) * state.stds + al * std_b, std_b),
                           state.stds)
        inited = state.initialized | has
        new_state = AnchorCurriculumState(means, stds, inited)

        threshold = torch.where(inited, means + offset * stds, torch.full_like(means, 0.5))
        var = (torch.where(inited, stds, torch.full_like(stds, 0.2)) if use_norm
               else torch.ones_like(stds))
        var = torch.clamp(var, min=1e-6)

        def per_class(v):
            return torch.as_tensor(list(v) if isinstance(v, (list, tuple)) else [v] * c,
                                   dtype=torch.float32, device=dev)

        heights, ends = per_class(height_cfg), per_class(end_epoch_cfg)
        # as the reference (loss_utils.py:267-269): no epoch >= START gate,
        # so with START > 0 the height overshoots before START
        decay = (ends - epoch) / torch.clamp(ends - start_epoch, min=1e-6)
        if not inverse:
            decay = torch.clamp(decay, min=0.0)
        h = heights if fixed else heights * decay
        if epoch > cut_epoch:
            h = torch.zeros_like(h)

        mask = (groups > 0) if oto else (one_hot_targets > 0)
        w = h / (1.0 + torch.exp(elong * (p_det - threshold) / var)) + 1.0 - h / 2.0
        w = torch.where(p_det > threshold, w * pos_norm, w * neg_norm)
        if sm or sma:
            if sma:
                m2 = (one_hot_targets > 0) & (groups <= 0) & (p_det <= smt)
            else:
                m2 = mask & (p_det <= smt)
            cw = torch.where(m2 & (epoch >= sme), torch.full_like(pred, 0.5),
                             torch.ones_like(pred))
        else:
            cw = torch.where(mask, w, torch.ones_like(w))

    loss = sigmoid_focal_loss(logits, one_hot_targets, weights, gamma, alpha)
    return loss * cw, cw, new_state, conf
