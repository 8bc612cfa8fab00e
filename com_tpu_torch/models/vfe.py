"""Voxel feature encoders (counterpart of ``com_tpu/models/vfe.py``): the
dynamic pillar encoder's sorted-scan path and MeanVFE.

DynamicPillarVFE (``DynamicPillarVFE._sorted_scan``):

Raw padded points (B, N, F) go straight to the BEV canvas: each point gets a
flat pillar id, points are sorted by it (unless the host already did), the
per-pillar reductions that the PFN broadcasts back to every point run on
``run_bcast`` (kernel K1), and the last PFN layer max-pools into the canvas
with a library scatter.  Emits ``batch["spatial_features"]`` (B, ny, nx, C).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.seg_scan import run_bcast
from ..ops.voxelize import point_voxel_ids
from ..utils.registry import VFES
from .layers import MaskedBatchNorm


@VFES.register
class MeanVFE(nn.Module):
    """Mean of each hard voxel's points (mean_vfe.py): (B, V, T, F) voxels
    and (B, V) counts -> ``batch["pillar_features"]`` (B, V, F), the sum
    over the count clamped at 1.  The host voxelizer made the voxels;
    ``VOXELIZE_ON_DEVICE`` is not ported."""

    def __init__(self, model_cfg, num_point_features, voxel_size=None, point_cloud_range=None,
                 grid_size=None):
        super().__init__()
        if model_cfg.get("VOXELIZE_ON_DEVICE"):
            raise NotImplementedError("VOXELIZE_ON_DEVICE (device_hard_voxelize) is not "
                                      "ported yet")
        self.num_point_features = int(num_point_features)

    def forward(self, batch):
        voxels = batch["voxels"]
        denom = torch.clamp(batch["voxel_num_points"][..., None].to(voxels.dtype), min=1.0)
        batch["pillar_features"] = voxels.sum(dim=2) / denom
        return batch


VFES.register_unported("PillarVFE", "hard-voxel pillar encoder")
VFES.register_unported("DynamicMeanVFE", "dynamic voxel mean")


def decorate_points(xyz, feats, pillar_xy_center, cluster_mean, use_absolute_xyz=True):
    """Concatenate [raw, f_cluster, f_center] per point (pillar_vfe.py:97-113)."""
    f_cluster = xyz - cluster_mean
    f_center = xyz - pillar_xy_center
    if use_absolute_xyz:
        return torch.cat([xyz, feats, f_cluster, f_center], dim=-1)
    return torch.cat([feats, f_cluster, f_center], dim=-1)


class PFNLayer(nn.Module):
    """Linear (no bias) + MaskedBatchNorm + ReLU, padded rows re-zeroed
    (the JAX package's remask=True form).  Hidden layers emit half their
    width and concatenate the pooled feature back."""

    def __init__(self, cin: int, cout: int, last: bool, dtype=None):
        super().__init__()
        self.last, self.dtype = last, dtype
        units = cout if last else cout // 2
        self.linear = nn.Linear(cin, units, bias=False)
        self.norm = MaskedBatchNorm(units, eps=1e-3)

    def forward(self, feats, mask, pool_fn):
        dt = self.dtype or feats.dtype
        x = torch.nn.functional.linear(feats.to(dt), self.linear.weight.to(dt))
        x = torch.relu(self.norm(x, mask))
        x = x * mask[..., None].to(x.dtype)
        x_max, x_max_back = pool_fn(x)
        if self.last:
            return x_max, None
        return x_max, torch.cat([x, x_max_back], dim=-1)


@VFES.register
class DynamicPillarVFE(nn.Module):
    """Fused dynamic pillarization + PFN + scatter to the BEV canvas."""

    def __init__(self, model_cfg, num_point_features, voxel_size, point_cloud_range, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        if not model_cfg.get("SORTED_SCAN", True):
            raise NotImplementedError("only the sorted-scan VFE path is ported")
        if model_cfg.get("COMPACT_CANVAS_CAP", None):
            raise NotImplementedError("COMPACT_CANVAS_CAP is not ported yet")
        self.voxel_size = tuple(voxel_size)
        self.point_cloud_range = tuple(point_cloud_range)
        self.grid_size = tuple(int(g) for g in grid_size)
        self.use_absolute_xyz = model_cfg.get("USE_ABSLOTE_XYZ", True)
        self.with_distance = model_cfg.get("WITH_DISTANCE", False)
        self.assume_sorted = bool(model_cfg.get("ASSUME_SORTED_POINTS", False))
        dt = torch.bfloat16 if model_cfg.get("MIXED_PRECISION", False) else None
        cin = num_point_features + (6 if self.use_absolute_xyz else 3) + int(self.with_distance)
        filters = [cin] + list(model_cfg["NUM_FILTERS"])
        self.pfn_layers = nn.ModuleList(
            PFNLayer(filters[i], filters[i + 1], i == len(filters) - 2, dtype=dt)
            for i in range(len(filters) - 1))
        self.num_bev_features = filters[-1]

    def forward(self, batch):
        points, pmask = batch["points"], batch["points_mask"]
        b, n, f = points.shape
        nx, ny, _ = self.grid_size
        hw = nx * ny
        vx, vy, vz = self.voxel_size
        x0, y0, z0 = self.point_cloud_range[:3]
        pt = points.dtype
        dev = points.device

        flat, in_range = point_voxel_ids(points[..., :3], self.point_cloud_range,
                                         self.voxel_size, self.grid_size)
        valid = pmask & in_range
        seg = torch.where(valid, flat, torch.full_like(flat, hw))  # trash run = hw
        if self.assume_sorted:
            sseg, spts, smask = seg, points, valid
        else:
            sseg, perm = torch.sort(seg, dim=1, stable=True)
            spts = torch.gather(points, 1, perm[..., None].expand(-1, -1, f))
            smask = torch.gather(valid, 1, perm)
        sseg = sseg.contiguous()
        ones = smask.to(pt)[..., None]
        sxyz = spts[..., :3]

        # cluster mean via one sum-broadcast over [x, y, z, 1], padded to 8
        stats_in = torch.cat([sxyz * ones, ones, torch.zeros((b, n, 4), dtype=pt, device=dev)],
                             dim=-1)
        stats = run_bcast(stats_in.contiguous(), sseg, "sum")
        cnt = torch.clamp(stats[..., 3:4], min=1.0)
        cluster_mean = stats[..., :3] / cnt

        cell_x = (sseg % nx).to(pt) * vx + (vx / 2 + x0)
        cell_y = torch.div(sseg, nx, rounding_mode="floor").to(pt) * vy + (vy / 2 + y0)
        cell_z = torch.full_like(cell_x, vz / 2 + z0)
        center = torch.stack([cell_x, cell_y, cell_z], dim=-1)

        feats = decorate_points(sxyz, spts[..., 3:], center, cluster_mean, self.use_absolute_xyz)
        if self.with_distance:
            feats = torch.cat([feats, torch.linalg.norm(sxyz, dim=-1, keepdim=True)], dim=-1)
        feats = feats * ones

        # global ids with stride hw + 1 keep one trash row per sample
        segg = (sseg.to(torch.int64) + torch.arange(b, device=dev)[:, None] * (hw + 1)).reshape(-1)

        def pool(x, last):
            if not last:
                xm = run_bcast(x.contiguous(), sseg, "max")
                return xm, xm
            c = x.shape[-1]
            # max is exact in f32, so the scatter runs there and casts back
            canvas = torch.full((b * (hw + 1), c), -math.inf, dtype=torch.float32, device=dev)
            canvas.scatter_reduce_(0, segg[:, None].expand(-1, c), x.reshape(b * n, c).float(),
                                   "amax", include_self=True)
            canvas = torch.where(torch.isfinite(canvas), canvas, torch.zeros_like(canvas))
            return canvas.to(x.dtype).reshape(b, hw + 1, c)[:, :hw], x

        pooled = None
        for layer in self.pfn_layers:
            pooled, feats = layer(feats, smask, lambda x, last=layer.last: pool(x, last))
        batch["spatial_features"] = pooled.reshape(b, ny, nx, pooled.shape[-1]).contiguous()
        return batch
