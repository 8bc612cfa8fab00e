"""Point heads (counterpart of ``com_tpu/models/dense_heads/point_head.py``;
pcdet point_head_simple.py): ``PointHeadSimple``, PV-RCNN's keypoint
foreground score, and ``point_head_loss``, its focal loss against the
keypoints inside a slightly enlarged GT box.

Names are pcdet's: ``point_head.cls_layers.{3i}`` (Linear, no bias),
``.{3i + 1}`` (``BatchNorm1d``, statistics over the valid keypoints),
then the biased output layer.  PointRCNN's ``PointHeadBox`` and PartA2's
``PointIntraPartOffsetHead`` raise by name.
"""
from __future__ import annotations

import torch
from torch import nn

from ...losses.anchor_losses import sigmoid_ce_with_logits
from ...ops.boxes import points_in_rbbox
from ...utils.registry import DENSE_HEADS
from ..layers import BatchNorm, BatchNorm1d


@DENSE_HEADS.register
class PointHeadSimple(nn.Module):
    """An MLP over ``point_features`` -> ``point_cls_scores_raw`` (B, S)."""

    def __init__(self, model_cfg, input_channels: int, num_class: int = 1):
        super().__init__()
        self.model_cfg = model_cfg
        layers, cin = [], int(input_channels)
        for ch in model_cfg.get("CLS_FC", [256, 256]):
            layers += [nn.Linear(cin, ch, bias=False), BatchNorm1d(ch), nn.ReLU()]
            cin = ch
        layers.append(nn.Linear(cin, 1))
        self.cls_layers = nn.Sequential(*layers)

    def forward(self, batch):
        x, valid = batch["point_features"], batch.get("point_valid")
        for layer in self.cls_layers:
            x = layer(x, mask=valid) if isinstance(layer, BatchNorm) else layer(x)
        batch["point_cls_scores_raw"] = x[..., 0]
        return batch


DENSE_HEADS.register_unported("PointHeadBox", "PointRCNN's point-wise box head")
DENSE_HEADS.register_unported("PointIntraPartOffsetHead", "PartA2's part-offset head")


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
    boxes = torch.cat([gt[..., :3], gt[..., 3:6] + torch.tensor(extra_width, dtype=gt.dtype,
                                                                device=gt.device),
                       gt[..., 6:7]], dim=-1)
    inside = points_in_rbbox(kp, boxes) & (gt[..., -1] > 0)[:, None, :]
    fg = inside.any(dim=-1).to(torch.float32)
    pred = torch.sigmoid(logits)
    alpha, gamma = 0.25, 2.0
    alpha_w = fg * alpha + (1 - fg) * (1 - alpha)
    pt = fg * (1 - pred) + (1 - fg) * pred
    loss = alpha_w * torch.pow(pt, gamma) * sigmoid_ce_with_logits(logits, fg)
    loss = loss * kp_valid.to(loss.dtype)
    pos = (fg * kp_valid.to(fg.dtype)).sum()
    return loss.sum() / torch.clamp(pos, min=1.0)
