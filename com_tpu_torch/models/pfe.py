"""Point feature extraction: VoxelSetAbstraction, PV-RCNN's keypoints
(counterpart of ``com_tpu/models/pfe.py``; pcdet voxel_set_abstraction.py).

Keypoints sampled from the raw points (FPS, or PV-RCNN++'s sectorized
proposal-centric sampling, SPC) gather (a) the BEV map at their place,
bilinearly, (b) the raw points and (c) the 3D backbone's sparse volumes
(x_conv3, x_conv4) within a radius, each set of neighbours through a
max-pooled mini PointNet; the concatenation is fused by a linear layer to
``NUM_OUTPUT_FEATURES``.  Fixed keypoint and neighbour counts keep every
shape static; the grouping is ``ops/pointnet2.py``.

Names are pcdet's: ``pfe.SA_rawpoints.mlps.0.*``, ``pfe.SA_layers.{k}.
mlps.0.*`` (one a sparse source, in FEATURES_SOURCE order; Conv2d 1x1
weights (O, I, 1, 1)) and ``pfe.vsa_point_feature_fusion.{0,1}``.  The
norms are ``BatchNorm1d`` (pcdet's eps 1e-5 held as the JAX package's
1e-3), with statistics over the real neighbours (a block) or the valid
keypoints (the fusion).  Everything runs in f32: under MIXED_PRECISION the
BEV map and the sparse features arrive in bf16 and are widened first, as
flax's Dense promotes them against its f32 parameters.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import pointnet2 as pn2
from ..utils.registry import BACKBONES_3D
from .layers import BatchNorm, BatchNorm1d, Conv1x1


class PointNetBlock(nn.Module):
    """pcdet's StackSAModuleMSG at one scale: ``mlps.0`` = [Conv2d 1x1 (no
    bias), norm, ReLU] per width, then the max over the neighbours (a tie's
    gradient split evenly, as JAX's max; the padded slots repeat hit 0), an
    empty group zeroed.  The norms' statistics count the real neighbours."""

    def __init__(self, cin: int, mlps):
        super().__init__()
        layers = []
        for ch in mlps:
            layers += [Conv1x1(cin, ch, ndim=2), BatchNorm1d(ch), nn.ReLU()]
            cin = ch
        self.mlps = nn.ModuleList([nn.Sequential(*layers)])
        self.out_channels = cin

    def forward(self, grouped, empty, slot_valid):
        """grouped (..., K, C), empty (...), slot_valid (..., K) -> (..., C')."""
        x = grouped
        for layer in self.mlps[0]:
            x = layer(x, mask=slot_valid) if isinstance(layer, BatchNorm) else layer(x)
        x = x.amax(dim=-2)
        return x * (~empty).to(x.dtype)[..., None]


@BACKBONES_3D.register
class VoxelSetAbstraction(nn.Module):
    def __init__(self, model_cfg, input_channels: int, grid_size, voxel_size, point_cloud_range,
                 bev_channels: int = 0, multi_scale_channels=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.num_keypoints = int(model_cfg.get("NUM_KEYPOINTS", 2048))
        self.nsample = int(model_cfg.get("NSAMPLE", 16))
        self.sources = list(model_cfg.get("FEATURES_SOURCE",
                                          ["bev", "raw_points", "x_conv3", "x_conv4"]))
        self.sample_method = model_cfg.get("SAMPLE_METHOD", "FPS")
        spc = model_cfg.get("SPC_SAMPLING", {})
        self.num_sectors = int(spc.get("NUM_SECTORS", 6))
        self.roi_radius = float(spc.get("SAMPLE_RADIUS_WITH_ROI", 1.6))
        sa_cfg = model_cfg.get("SA_LAYER", {})
        c_in = 0
        if "bev" in self.sources:
            c_in += int(bev_channels)
        self.SA_rawpoints = None
        if "raw_points" in self.sources:
            raw = sa_cfg.get("raw_points", {})
            self.raw_radius = float(raw.get("RADIUS", [1.2])[0])
            self.SA_rawpoints = PointNetBlock(int(input_channels),
                                              list(raw.get("MLPS", [[16, 16]])[0]))
            c_in += self.SA_rawpoints.out_channels
        self.conv_sources = [s for s in self.sources if s.startswith("x_conv")]
        self.conv_radius, layers = [], []
        for src in self.conv_sources:
            stride = 2 ** (int(src[-1]) - 1)
            self.conv_radius.append(float(sa_cfg.get(src, {}).get("RADIUS", [stride * 0.8])[0]))
            layers.append(PointNetBlock(3 + int(multi_scale_channels[src]),
                                        list(sa_cfg.get(src, {}).get("MLPS", [[32, 32]])[0])))
            c_in += layers[-1].out_channels
        self.SA_layers = nn.ModuleList(layers)
        self.num_point_features = int(model_cfg.get("NUM_OUTPUT_FEATURES", 128))
        self.vsa_point_feature_fusion = nn.Sequential(
            nn.Linear(c_in, self.num_point_features, bias=False),
            BatchNorm1d(self.num_point_features), nn.ReLU())

    def sample_keypoints(self, points, pmask, rois=None):
        """(B, S, 3) keypoints and their validity: FPS over the valid points,
        or SPC (with RoIs, the points near one; then FPS a sector)."""
        xyz = points[..., :3]
        if self.sample_method == "SPC":
            m = pmask
            if rois is not None:
                roi_valid = torch.abs(rois[..., 3:6]).sum(dim=-1) > 0
                m = pn2.sample_points_with_roi(rois[..., :7], roi_valid, xyz, pmask,
                                               self.roi_radius)
            idx, kp_valid = pn2.sector_fps(xyz, m, self.num_keypoints, self.num_sectors)
        else:
            idx = pn2.farthest_point_sample(xyz, pmask, self.num_keypoints)
            kp_valid = torch.gather(pmask, 1, idx)
        return pn2.gather_points(xyz.contiguous(), idx), kp_valid

    def interpolate_bev(self, bev, stride, keypoints):
        """(B, H, W, C) map at the keypoints, bilinearly (the cell centres
        at +0.5), the corner cell clamped inside the map."""
        b, h, w, c = bev.shape
        vx, vy = self.voxel_size[0] * stride, self.voxel_size[1] * stride
        x0, y0 = self.point_cloud_range[0], self.point_cloud_range[1]
        fx = (keypoints[..., 0] - x0) / vx - 0.5
        fy = (keypoints[..., 1] - y0) / vy - 0.5
        x0i = torch.clamp(torch.floor(fx).to(torch.int64), 0, w - 2)
        y0i = torch.clamp(torch.floor(fy).to(torch.int64), 0, h - 2)
        ax = torch.clamp(fx - x0i, 0, 1)[..., None]
        ay = torch.clamp(fy - y0i, 0, 1)[..., None]
        flat = bev.reshape(b, h * w, c)
        f00, f01, f10, f11 = (pn2.gather_rows(flat, (y0i + dy) * w + x0i + dx)
                              for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)))
        return (f00 * (1 - ax) * (1 - ay) + f01 * ax * (1 - ay)
                + f10 * (1 - ax) * ay + f11 * ax * ay)

    def voxel_centers(self, coords, stride):
        """(B, V, 3) zyx cells at ``stride`` -> world xyz centres."""
        vx, vy, vz = (s * stride for s in self.voxel_size)
        x0, y0, z0 = self.point_cloud_range[:3]
        return torch.stack([(coords[..., 2].to(torch.float32) + 0.5) * vx + x0,
                            (coords[..., 1].to(torch.float32) + 0.5) * vy + y0,
                            (coords[..., 0].to(torch.float32) + 0.5) * vz + z0], dim=-1)

    def forward(self, batch):
        points = batch["points"].to(torch.float32)  # (B, N, F)
        pmask = batch["points_mask"].to(torch.bool)
        rois = batch.get("rois") if self.sample_method == "SPC" else None
        keypoints, kp_valid = self.sample_keypoints(points, pmask, rois)
        batch["point_coords"] = keypoints
        feats = []
        if "bev" in self.sources and "spatial_features" in batch:
            feats.append(self.interpolate_bev(batch["spatial_features"].to(torch.float32),
                                              int(batch.get("spatial_features_stride", 8)),
                                              keypoints))
        if self.SA_rawpoints is not None:
            grouped, _, empty, slot = pn2.query_and_group(
                self.raw_radius, self.nsample, points[..., :3].contiguous(), keypoints,
                points[..., 3:].contiguous(), valid=pmask)
            feats.append(self.SA_rawpoints(grouped, empty, slot))
        multi = batch.get("multi_scale_3d_features", {})
        for src, radius, block in zip(self.conv_sources, self.conv_radius, self.SA_layers):
            x, coords, valid, _ = multi[src]
            centers = self.voxel_centers(coords, 2 ** (int(src[-1]) - 1))
            grouped, _, empty, slot = pn2.query_and_group(
                radius, self.nsample, centers, keypoints, x.to(torch.float32), valid=valid)
            feats.append(block(grouped, empty, slot))
        point_features = torch.cat(feats, dim=-1)
        fused = point_features
        for layer in self.vsa_point_feature_fusion:
            fused = layer(fused, mask=kp_valid) if isinstance(layer, BatchNorm) else layer(fused)
        batch["point_features_before_fusion"] = point_features
        batch["point_features"] = fused  # (B, S, C)
        batch["point_valid"] = kp_valid
        return batch
