"""SECOND-IoU head (counterpart of ``com_tpu/models/roi_heads/
second_head.py``; pcdet second_head.py): rotated RoI-aligned pooling of
the dense BEV map (a G x G bilinear lattice over each box, the affine grid
of pcdet's ``affine_grid`` + ``grid_sample`` with align_corners=True and
zero padding), shared FCs and an IoU branch that scores each RoI; the
boxes pass through unchanged.  The FCs keep pcdet's names and its Conv1d
layout (``shared_fc_layer``, ``iou_layers``, weights (O, I, 1)); dropout
after the shared blocks but the last, as the JAX head.  Also the IoU loss
and the score fusion by point count.
"""
from __future__ import annotations

import torch
from torch import nn

from ...utils.registry import ROI_HEADS
from ..layers import Conv1x1
from .fc import fc_stack, run_stack


def bilinear_sample(fmap, px, py):
    """fmap (B, H, W, C); px, py (B, ...) pixel coordinates (x along W, y
    along H) -> (B, ..., C) in f32, zero outside the map."""
    b, h, w, c = fmap.shape
    x0, y0 = torch.floor(px), torch.floor(py)
    wx, wy = px - x0, py - y0
    flat = fmap.reshape(b, h * w, c)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            cell = (torch.clamp(yi, 0, h - 1).to(torch.int64) * w
                    + torch.clamp(xi, 0, w - 1).to(torch.int64)).reshape(b, -1)
            v = torch.gather(flat, 1, cell[..., None].expand(-1, -1, c)).view(*px.shape, c)
            wgt = (wx if dx else 1 - wx) * (wy if dy else 1 - wy)
            out = out + v.float() * (wgt * inside)[..., None]
    return out


def rotated_roi_grid_sample(fmap, rois, pc_range, voxel_size, downsample, grid_size: int):
    """(B, H, W, C) BEV map + (B, R, 7) RoIs -> (B, R, G, G, C): lattice u, v
    in linspace(-1, 1, G), px = cx + ex (u cos - v sin), py = cy + ey (u sin +
    v cos), the box's centre and half extents in map pixels."""
    g = grid_size
    sx, sy = voxel_size[0] * downsample, voxel_size[1] * downsample
    x1 = (rois[..., 0] - rois[..., 3] / 2 - pc_range[0]) / sx
    x2 = (rois[..., 0] + rois[..., 3] / 2 - pc_range[0]) / sx
    y1 = (rois[..., 1] - rois[..., 4] / 2 - pc_range[1]) / sy
    y2 = (rois[..., 1] + rois[..., 4] / 2 - pc_range[1]) / sy
    cx, ex = ((x1 + x2) / 2)[..., None], ((x2 - x1) / 2)[..., None]
    cy, ey = ((y1 + y2) / 2)[..., None], ((y2 - y1) / 2)[..., None]
    cos, sin = torch.cos(rois[..., 6])[..., None], torch.sin(rois[..., 6])[..., None]
    lin = torch.linspace(-1.0, 1.0, g, dtype=rois.dtype, device=rois.device)
    u = lin[:, None].expand(g, g).reshape(-1)  # (G*G,) row-major (u, v)
    v = lin[None, :].expand(g, g).reshape(-1)
    px = cx + ex * (u * cos - v * sin)
    py = cy + ey * (u * sin + v * cos)
    return bilinear_sample(fmap, px, py).view(*rois.shape[:2], g, g, -1)


@ROI_HEADS.register
class SECONDHead(nn.Module):
    """IoU-scoring second stage: writes ``rcnn_iou`` (B, R), and the RoIs as
    ``batch_box_preds`` with the IoU logits as ``batch_cls_preds``."""

    def __init__(self, model_cfg, num_class: int = 1, point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 voxel_size=(0.05, 0.05, 0.1), input_channels: int = 512):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        pool = model_cfg["ROI_GRID_POOL"]
        self.grid = int(pool["GRID_SIZE"])
        self.downsample = float(pool.get("DOWNSAMPLE_RATIO", 8))
        dp = float(model_cfg.get("DP_RATIO", 0.0))
        shared = list(model_cfg.get("SHARED_FC", [256, 256]))
        self.shared_fc_layer = fc_stack(self.grid ** 2 * int(input_channels), shared, Conv1x1,
                                        lambda i: dp > 0 and i != len(shared) - 1, drop=dp)
        # pcdet's make_fc_layers has a dropout after the first block; the
        # JAX head drops nothing there
        self.iou_layers = fc_stack(shared[-1], list(model_cfg.get("IOU_FC", [256, 256])), Conv1x1,
                                   lambda i: i == 0, out=1)

    def forward(self, batch):
        rois = batch["rois"].detach()
        fmap = batch["spatial_features_2d"].detach()
        b, r = rois.shape[:2]
        pooled = rotated_roi_grid_sample(fmap, rois, self.point_cloud_range, self.voxel_size,
                                         self.downsample, self.grid)
        x = run_stack(self.shared_fc_layer, pooled.reshape(b, r, -1),
                      batch.get("rngs", {}).get("dropout"))
        rcnn_iou = run_stack(self.iou_layers, x)[..., 0]
        batch["rcnn_iou"] = rcnn_iou
        batch["batch_box_preds"] = rois
        batch["batch_cls_preds"] = rcnn_iou[..., None]
        batch["cls_preds_normalized"] = False
        return batch


def second_iou_loss(batch, loss_cfg):
    """The IoU loss (second_head.py:153-188): BinaryCrossEntropy, L2 or
    smoothL1 of the IoU logits against the soft labels, over the labelled
    RoIs, times ``rcnn_iou_weight``."""
    iou = batch["rcnn_iou"].reshape(-1)
    labels = batch["roi_targets"].cls_labels.reshape(-1)
    valid = (labels >= 0).to(torch.float32)
    kind = loss_cfg.get("IOU_LOSS", "BinaryCrossEntropy")
    if kind == "BinaryCrossEntropy":
        p = torch.sigmoid(iou)
        per = -(labels * torch.log(torch.clamp(p, 1e-7, 1.0))
                + (1 - labels) * torch.log(torch.clamp(1 - p, 1e-7, 1.0)))
    elif kind == "L2":
        per = (iou - labels) ** 2
    elif kind == "smoothL1":
        d = torch.abs(iou - labels)
        beta = 1.0 / 9.0
        per = torch.where(d < beta, 0.5 * d ** 2 / beta, d - 0.5 * beta)
    else:
        raise NotImplementedError(f"IOU_LOSS {kind}")
    loss = (per * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    return loss * float(loss_cfg["LOSS_WEIGHTS"].get("rcnn_iou_weight", 1.0))


def fuse_scores_by_npoints(cls_scores, iou_scores, num_points_in_box, cls_thresh=10,
                           iou_thresh=100):
    """Score fusion by point count (second_net_iou.py:38-57): alpha ramps 0
    -> 1 between ``cls_thresh`` and ``iou_thresh`` points."""
    alpha = torch.clamp((num_points_in_box - cls_thresh) / (iou_thresh - cls_thresh), 0.0, 1.0)
    return (1 - alpha) * cls_scores + alpha * iou_scores
