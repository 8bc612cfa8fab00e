"""PartA2's RoI head (counterpart of ``com_tpu/models/roi_heads/
parta2_head.py``; pcdet partA2_head.py): the points of each RoI pooled
into a POOL_SIZE^3 grid of its box (``ops/roiaware.py``
``roiaware_pool3d``): [part offsets gated by the segmentation score, the
score] averaged a cell, the UNet's point features max-pooled a cell.  Two
3x3x3 conv blocks over each grid (``conv_part``, ``conv_rpn``), the cells
where the part pool is nonzero masking them and their norms' statistics;
the whole grid flattened (cell-major, [rpn, part] a cell) into the shared
FCs and the class and box branches.

pcdet convolves the pooled grid with sparse convs; the JAX package and the
port run dense ones (``F.conv3d``: the JAX package computes them outside
any Pallas kernel), masked as a submanifold conv would be.  Names are
pcdet's: ``roi_head.conv_{part,rpn}.{j}.0`` (spconv 2.x layout (O, kz,
ky, kx, I)) / ``.1`` (eps 1e-3), ``shared_fc_layer`` (a dropout after
each block but the last when DP_RATIO > 0), ``cls_layers`` and
``reg_layers`` (make_fc_layers: a dropout after the first block, the
biased output last), Conv1d layout, their norms ``BatchNorm1d``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.roiaware import roiaware_pool3d
from ...utils.registry import ROI_HEADS
from ..backbone3d import SparseConv3d
from ..layers import Conv1x1, MaskedBatchNorm
from .fc import fc_stack, run_stack


class Conv3DBNReLU(nn.Sequential):
    """A dense 3x3x3 conv over (N, X, Y, Z, C) grids ``0``, zero outside
    ``mask``, the norm ``1`` over the masked cells, ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__(SparseConv3d(cin, cout, 3), MaskedBatchNorm(cout, eps=1e-3))

    def forward(self, x, mask):
        w = self[0].weight.permute(0, 4, 1, 2, 3)  # (O, kz, ky, kx, I) -> (O, I, kz, ky, kx)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)
        y = y * mask[..., None].to(y.dtype)
        return torch.relu(self[1](y, mask))


@ROI_HEADS.register
class PartA2FCHead(nn.Module):
    """Reads "rois" (B, R, 7), "point_coords", "point_features",
    "point_valid", "point_cls_scores" and "point_part_offset"; writes
    "rcnn_cls" (B, R) and "rcnn_reg" (B, R, 7).  Dropout draws from
    ``batch["rngs"]["dropout"]`` in training."""

    def __init__(self, model_cfg, num_class: int = 1, point_cloud_range=None, voxel_size=None,
                 input_channels: int = 16):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        pool = model_cfg["ROI_AWARE_POOL"]
        self.pool_size = int(pool.get("POOL_SIZE", 12))
        nf = int(pool.get("NUM_FEATURES", 128))
        self.max_points = int(pool.get("MAX_POINTS_PER_ROI", 512))
        self.thresh = float(model_cfg.get("SEG_MASK_SCORE_THRESH", 0.3))
        self.conv_part = nn.Sequential(Conv3DBNReLU(4, 64), Conv3DBNReLU(64, nf // 2))
        self.conv_rpn = nn.Sequential(Conv3DBNReLU(int(input_channels), 64),
                                      Conv3DBNReLU(64, nf // 2))
        dp = float(model_cfg.get("DP_RATIO", 0.0))
        drop = dp if dp > 0 else None
        shared = list(model_cfg.get("SHARED_FC", [256, 256]))
        self.shared_fc_layer = fc_stack(self.pool_size ** 3 * 2 * (nf // 2), shared, Conv1x1,
                                        lambda i: dp > 0 and i != len(shared) - 1, drop=drop)
        for name, out_ch in (("cls", num_class), ("reg", 7)):
            setattr(self, f"{name}_layers", fc_stack(
                shared[-1], list(model_cfg.get(f"{name.upper()}_FC", [256, 256])), Conv1x1,
                lambda i: i == 0, drop=drop, out=out_ch))

    def pool(self, batch):
        """(pooled part (B x R, S, S, S, 4), pooled features (B x R, S, S, S,
        C)) of each RoI."""
        rois = batch["rois"].detach()
        pc, pf = batch["point_coords"], batch["point_features"]
        pv = batch.get("point_valid")
        if pv is None:
            pv = torch.ones(pc.shape[:2], dtype=torch.bool, device=pc.device)
        seg = batch["point_cls_scores"].detach()
        part = batch["point_part_offset"]
        gate = (seg >= self.thresh)[..., None].to(part.dtype)
        part_feat = torch.cat([part * gate, seg[..., None]], dim=-1)
        ps = self.pool_size
        pooled_part = roiaware_pool3d(pc, part_feat, pv, rois, ps, self.max_points, "avg")
        pooled_rpn = roiaware_pool3d(pc, pf, pv, rois, ps, self.max_points, "max")
        return (pooled_part.reshape(-1, ps, ps, ps, pooled_part.shape[-1]),
                pooled_rpn.reshape(-1, ps, ps, ps, pooled_rpn.shape[-1]))

    def forward(self, batch):
        b, r = batch["rois"].shape[:2]
        pooled_part, pooled_rpn = self.pool(batch)
        nonempty = torch.abs(pooled_part).sum(dim=-1) > 0
        x_part, x_rpn = pooled_part, pooled_rpn
        for blk in self.conv_part:
            x_part = blk(x_part, nonempty)
        for blk in self.conv_rpn:
            x_rpn = blk(x_rpn, nonempty)
        x = torch.cat([x_rpn, x_part], dim=-1).reshape(b * r, -1)
        gen = batch.get("rngs", {}).get("dropout")
        x = run_stack(self.shared_fc_layer, x, gen)
        batch["rcnn_cls"] = run_stack(self.cls_layers, x, gen).reshape(b, r)
        batch["rcnn_reg"] = run_stack(self.reg_layers, x, gen).reshape(b, r, 7)
        return batch
