"""PV-RCNN's RoI heads (counterpart of ``com_tpu/models/roi_heads/
pvrcnn_head.py``; pcdet pvrcnn_head.py): a GRID_SIZE^3 lattice in each RoI
(``roi_grid_points``) whose points gather the PFE's keypoints.

``PVRCNNHead`` ball-queries the keypoints at each grid point and pools
them with a max-pooled mini PointNet (``roi_grid_pool_layer``, pcdet's
StackSAModuleMSG names), then shared FCs and the class and box branches,
all in pcdet's Conv1d layout: ``shared_fc_layer`` (no dropout, as the JAX
head; pcdet's dropout slots kept for the numbering), ``cls_layers`` and
``reg_layers`` (make_fc_layers: a dropout after the first block, the
biased output last).  The flattened grid is grid-point-major (g * C + c)
as in the JAX head.

``PVRCNNPlusPlusHead`` pools each grid point's neighbourhood with PV-RCNN++'s
vector pool (``ops/pointnet2.py`` ``vector_pool_features``), one group a
GROUPS entry, each through its POST_MLPS, then the same FCs.  pcdet's
importer has no rule for it, so its names are the JAX head's flax scopes:
``g{i}_mlp_{j}`` / ``g{i}_bn_{j}``, ``shared_fc_{i}`` / ``shared_bn_{i}``,
``{cls,reg}_fc_{i}`` / ``_bn_{i}``, ``rcnn_cls``, ``rcnn_reg`` (Linear
layout, the JAX norms' eps 1e-3).  Both heads run in f32.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import pointnet2 as pn2
from ...utils.registry import ROI_HEADS
from ..layers import Conv1x1, MaskedBatchNorm
from ..pfe import PointNetBlock
from .fc import Dropout, fc_stack, run_stack


def roi_grid_points(rois: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(..., R, 7) RoIs -> (..., R, G^3, 3) world-frame grid points: the
    centres of a G x G x G lattice over each box, (x, y, z) index order
    row-major, rotated by the box's heading."""
    g = grid_size
    idx = np.stack(np.meshgrid(*([np.arange(g)] * 3), indexing="ij"), -1).reshape(-1, 3)
    frac = torch.as_tensor((idx + 0.5) / g - 0.5, dtype=torch.float32, device=rois.device)
    local = frac * rois[..., None, 3:6]
    cos, sin = torch.cos(rois[..., 6])[..., None], torch.sin(rois[..., 6])[..., None]
    x = local[..., 0] * cos - local[..., 1] * sin
    y = local[..., 0] * sin + local[..., 1] * cos
    return torch.stack([x, y, local[..., 2]], dim=-1) + rois[..., None, :3]


@ROI_HEADS.register
class PVRCNNHead(nn.Module):
    def __init__(self, model_cfg, num_class: int = 1, point_cloud_range=None, voxel_size=None,
                 input_channels: int = 128):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        pool = model_cfg.get("ROI_GRID_POOL", {})
        self.grid = int(pool.get("GRID_SIZE", 6))
        self.radius = float(pool.get("RADIUS", 0.8))
        self.nsample = int(pool.get("NSAMPLE", 16))
        self.roi_grid_pool_layer = PointNetBlock(3 + int(input_channels),
                                                 list(pool.get("MLPS", [[64, 64]])[0]))
        dp = float(model_cfg.get("DP_RATIO", 0.0))
        shared = list(model_cfg.get("SHARED_FC", [256, 256]))
        self.shared_fc_layer = fc_stack(
            self.grid ** 3 * self.roi_grid_pool_layer.out_channels, shared, Conv1x1,
            lambda i: dp > 0 and i != len(shared) - 1)
        for name, out_ch in (("cls", num_class), ("reg", 7)):
            setattr(self, f"{name}_layers", fc_stack(
                shared[-1], list(model_cfg.get(f"{name.upper()}_FC", [])), Conv1x1,
                lambda i: i == 0, drop=dp if dp > 0 else None, out=out_ch))

    def pool(self, batch):
        """(B, R, G^3 * C) pooled grid of each RoI."""
        rois = batch["rois"].detach()
        b, r = rois.shape[:2]
        grid_pts = roi_grid_points(rois, self.grid).reshape(b, r * self.grid ** 3, 3)
        grouped, _, empty, slot = pn2.query_and_group(
            self.radius, self.nsample, batch["point_coords"], grid_pts,
            batch["point_features"], valid=batch.get("point_valid"))
        return self.roi_grid_pool_layer(grouped, empty, slot).reshape(b, r, -1)

    def forward(self, batch):
        x = run_stack(self.shared_fc_layer, self.pool(batch))
        gen = batch.get("rngs", {}).get("dropout")
        batch["rcnn_cls"] = run_stack(self.cls_layers, x, gen)[..., 0]
        batch["rcnn_reg"] = run_stack(self.reg_layers, x, gen)
        return batch


DEFAULT_GROUPS = [
    {"NUM_LOCAL_VOXEL": [2, 2, 2], "MAX_NEIGHBOR_DISTANCE": 0.8, "NEIGHBOR_NSAMPLE": 32,
     "POST_MLPS": [64, 64]},
    {"NUM_LOCAL_VOXEL": [3, 3, 3], "MAX_NEIGHBOR_DISTANCE": 1.6, "NEIGHBOR_NSAMPLE": 32,
     "POST_MLPS": [64, 64]}]


@ROI_HEADS.register
class PVRCNNPlusPlusHead(nn.Module):
    def __init__(self, model_cfg, num_class: int = 1, point_cloud_range=None, voxel_size=None,
                 input_channels: int = 128):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        pool = model_cfg.get("ROI_GRID_POOL", {})
        self.grid = int(pool.get("GRID_SIZE", 6))
        self.groups = list(pool.get("GROUPS", DEFAULT_GROUPS))
        self.aggregation = pool.get("LOCAL_AGGREGATION_TYPE", "local_interpolation")
        self.mlp_names, c_grid = [], 0
        for gi, gc in enumerate(self.groups):
            nv = [int(v) for v in gc["NUM_LOCAL_VOXEL"]]
            cin, names = nv[0] * nv[1] * nv[2] * (3 + int(input_channels)), []
            for li, ch in enumerate(list(gc.get("POST_MLPS", [64]))):
                setattr(self, f"g{gi}_mlp_{li}", nn.Linear(cin, ch, bias=False))
                setattr(self, f"g{gi}_bn_{li}", MaskedBatchNorm(ch))
                names.append((f"g{gi}_mlp_{li}", f"g{gi}_bn_{li}"))
                cin = ch
            self.mlp_names.append(names)
            c_grid += cin
        cin = self.grid ** 3 * c_grid
        self.shared = len(model_cfg.get("SHARED_FC", [256, 256]))
        for i, ch in enumerate(model_cfg.get("SHARED_FC", [256, 256])):
            setattr(self, f"shared_fc_{i}", nn.Linear(cin, ch, bias=False))
            setattr(self, f"shared_bn_{i}", MaskedBatchNorm(ch))
            cin = ch
        self.dropout = Dropout(float(model_cfg.get("DP_RATIO", 0.0)))
        self.branch = {}
        for name, out_ch in (("cls", num_class), ("reg", 7)):
            c, fcs = cin, list(model_cfg.get(f"{name.upper()}_FC", []))
            for i, ch in enumerate(fcs):
                setattr(self, f"{name}_fc_{i}", nn.Linear(c, ch, bias=False))
                setattr(self, f"{name}_bn_{i}", MaskedBatchNorm(ch))
                c = ch
            setattr(self, f"rcnn_{name}", nn.Linear(c, out_ch))
            self.branch[name] = len(fcs)

    def _fc_branch(self, name, x, gen):
        for i in range(self.branch[name]):
            x = torch.relu(getattr(self, f"{name}_bn_{i}")(getattr(self, f"{name}_fc_{i}")(x)))
            if i == 0:
                x = self.dropout(x, gen)
        return getattr(self, f"rcnn_{name}")(x)

    def forward(self, batch):
        rois = batch["rois"].detach()
        kp, kf = batch["point_coords"], batch["point_features"]
        kv = batch.get("point_valid")
        if kv is None:
            kv = torch.ones(kp.shape[:2], dtype=torch.bool, device=kp.device)
        b, r = rois.shape[:2]
        grid_pts = roi_grid_points(rois, self.grid).reshape(b, r * self.grid ** 3, 3)
        feats = []
        for gc, names in zip(self.groups, self.mlp_names):
            x, empty = pn2.vector_pool_features(
                kp, kf, kv, grid_pts, gc["NUM_LOCAL_VOXEL"], float(gc["MAX_NEIGHBOR_DISTANCE"]),
                int(gc.get("NEIGHBOR_NSAMPLE", 32)), self.aggregation)
            for lin, bn in names:
                x = torch.relu(getattr(self, bn)(getattr(self, lin)(x), mask=~empty))
            feats.append(x * (~empty).to(x.dtype)[..., None])
        x = torch.cat(feats, dim=-1).reshape(b, r, -1)
        for i in range(self.shared):
            x = torch.relu(getattr(self, f"shared_bn_{i}")(getattr(self, f"shared_fc_{i}")(x)))
        gen = batch.get("rngs", {}).get("dropout")
        batch["rcnn_cls"] = self._fc_branch("cls", x, gen)[..., 0]
        batch["rcnn_reg"] = self._fc_branch("reg", x, gen)
        return batch


ROI_HEADS.register_unported("PartA2FCHead", "PartA2's RoI-aware pooling")
ROI_HEADS.register_unported("MPPNetHead", "MPPNet's multi-frame proxy points")
ROI_HEADS.register_unported("MPPNetHeadE2E", "MPPNet's multi-frame proxy points")
