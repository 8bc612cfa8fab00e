"""PointRCNN's RoI head (counterpart of ``com_tpu/models/roi_heads/
pointrcnn_head.py``; pcdet pointrcnn_head.py): each RoI's member points
(``ops/roiaware.py`` ``roipoint_pool3d``, the RoI enlarged by
POOL_EXTRA_WIDTH) in its canonical frame, each with the point head's score
and its depth before its features; the [xyz, score, depth] part lifted by
``xyz_up_layer``, merged with the features by ``merge_down_layer``, then a
set-abstraction stack over the pooled points (the last one groups all) and
the class and box FCs.

Names are pcdet's: ``roi_head.xyz_up_layer.{3j}`` / ``merge_down_layer.0``
(Conv2d 1x1), ``roi_head.SA_modules.{k}.mlps.0``, ``roi_head.cls_layers``
and ``reg_layers`` (make_fc_layers' Conv1d blocks, the slot of pcdet's
dropout after the first kept for the numbering: the JAX head drops
nothing, whatever DP_RATIO says).  The norms are ``BatchNorm1d``: the
pooled points' statistics over the points with a nonzero row, the FCs'
over every RoI.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.boxes import enlarge_box3d
from ...ops.roiaware import roipoint_pool3d
from ...utils.registry import ROI_HEADS
from ..layers import Conv1x1, run_masked
from ..pfe import shared_mlp
from ..pointnet2_backbone import SAModuleMSG
from .fc import fc_stack, run_stack


@ROI_HEADS.register
class PointRCNNHead(nn.Module):
    """Reads "rois" (B, R, 7), "point_coords", "point_features",
    "point_valid" and "point_cls_scores"; writes "rcnn_cls" (B, R) and
    "rcnn_reg" (B, R, 7)."""

    def __init__(self, model_cfg, num_class: int = 1, point_cloud_range=None, voxel_size=None,
                 input_channels: int = 128):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        pool = model_cfg["ROI_POINT_POOL"]
        self.num_points = int(pool.get("NUM_SAMPLED_POINTS", 512))
        self.depth_normalizer = float(pool.get("DEPTH_NORMALIZER", 70.0))
        self.extra_width = [float(v) for v in pool.get("POOL_EXTRA_WIDTH", [0.0, 0.0, 0.0])]
        xyz_up = [int(c) for c in model_cfg.get("XYZ_UP_LAYER", [128, 128])]
        self.xyz_up_layer = shared_mlp(5, xyz_up)
        self.merge_down_layer = shared_mlp(xyz_up[-1] + int(input_channels), xyz_up[-1:])
        sa = model_cfg["SA_CONFIG"]
        mods, c = [], xyz_up[-1]
        for k, npoint in enumerate(sa["NPOINTS"]):
            mods.append(SAModuleMSG(None if int(npoint) == -1 else int(npoint), [sa["RADIUS"][k]],
                                    [sa["NSAMPLE"][k]], 3 + c, [list(sa["MLPS"][k])]))
            c = mods[-1].out_channels
        self.SA_modules = nn.ModuleList(mods)
        for name, out_ch in (("cls", num_class), ("reg", 7)):
            setattr(self, f"{name}_layers", fc_stack(
                c, list(model_cfg.get(f"{name.upper()}_FC", [256, 256])), Conv1x1,
                lambda i: i == 0, out=out_ch))

    def pool(self, batch):
        """(B x R, K, 5 + C) pooled points: local xyz, score, depth, features."""
        rois = batch["rois"].detach()
        pc, pf = batch["point_coords"], batch["point_features"]
        pv = batch.get("point_valid")
        if pv is None:
            pv = torch.ones(pc.shape[:2], dtype=torch.bool, device=pc.device)
        depth = torch.linalg.vector_norm(pc, dim=-1) / self.depth_normalizer - 0.5
        feats = torch.cat([batch["point_cls_scores"].detach()[..., None], depth[..., None], pf],
                          dim=-1)
        pooled, empty = roipoint_pool3d(pc, feats, pv, enlarge_box3d(rois[..., :7],
                                                                     self.extra_width),
                                        self.num_points)
        pooled = pooled * (~empty).to(pooled.dtype)[..., None, None]
        return pooled.reshape(-1, self.num_points, pooled.shape[-1])

    def forward(self, batch):
        b, r = batch["rois"].shape[:2]
        pooled = self.pool(batch)
        pvalid = torch.abs(pooled).sum(dim=-1) > 0
        xyz_feat = run_masked(self.xyz_up_layer, pooled[..., :5], pvalid)
        merged = run_masked(self.merge_down_layer, torch.cat([xyz_feat, pooled[..., 5:]], dim=-1),
                            pvalid)
        xyz, feats, valid = pooled[..., :3], merged, pvalid
        for sa in self.SA_modules:
            xyz, feats, valid = sa(xyz, feats, valid)
        shared = feats[:, 0, :]
        batch["rcnn_cls"] = run_stack(self.cls_layers, shared).reshape(b, r)
        batch["rcnn_reg"] = run_stack(self.reg_layers, shared).reshape(b, r, 7)
        return batch
