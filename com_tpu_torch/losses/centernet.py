"""CenterNet losses (counterpart of ``com_tpu/losses/centernet.py``; pcdet
loss_utils.py:655-663, 1312-1385)."""
from __future__ import annotations

import torch

from ..parallel.sharding import global_sum


def sigmoid_clamped(x, eps=1e-4):
    """clamp(sigmoid(x), 1e-4, 1 - 1e-4) (curriculum_center_head.py:311)."""
    return torch.clamp(1.0 / (1.0 + torch.exp(-x)), eps, 1.0 - eps)


def focal_loss_centernet(pred, gt, mask=None):
    """Penalty-reduced pixelwise focal loss (CornerNet / FocalLossCenterNet).

    pred: (B, H, W, C) post-sigmoid heatmap; gt: same shape; mask: optional
    per-pixel weights (the COM curriculum mask), applied elementwise.  With a
    mask the normaliser is the mask-weighted positive count, the reference's
    own semantics (loss_utils.py:1296).  Positives are the cells where gt is
    exactly 1.0."""
    pos_inds = (gt == 1.0).to(pred.dtype)
    neg_inds = (gt < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - gt, 4)
    pos_loss = torch.log(pred) * torch.pow(1.0 - pred, 2) * pos_inds
    neg_loss = torch.log(1.0 - pred) * torch.pow(pred, 2) * neg_weights * neg_inds
    if mask is not None:
        pos_loss = pos_loss * mask
        neg_loss = neg_loss * mask
        num_pos = (pos_inds * mask).sum()
    else:
        num_pos = pos_inds.sum()
    # the batch's sums over every rank under a data mesh
    pos_loss, neg_loss, num_pos = global_sum(pos_loss.sum(), neg_loss.sum(), num_pos)
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / torch.clamp(num_pos, min=1e-4))


def reg_loss_centernet(pred, inds, target, mask):
    """Gather-at-index L1 regression loss (RegLossCenterNet).

    pred: (B, H, W, D); inds: (B, M) flat y*W+x; target: (B, M, D); mask:
    (B, M) 0/1 validity or per-object curriculum weights, which scale both
    the per-object loss and the normaliser (loss_utils.py:1364-1385).
    Returns the (D,) per-dimension losses."""
    b, h, w, d = pred.shape
    gathered = torch.gather(pred.reshape(b, h * w, d), 1, inds.long()[..., None].expand(-1, -1, d))
    m = mask[..., None] * torch.isfinite(target).to(pred.dtype)
    loss = torch.abs(gathered * m - target * m)
    total, num = global_sum(loss.sum(dim=(0, 1)), mask.sum())  # over every rank's objects
    return total / (num + 1e-4)
