"""PointNet++ MSG backbone, PointRCNN's (counterpart of
``com_tpu/models/pointnet2_backbone.py``; pcdet pointnet2_backbone.py
PointNet2MSG): a set-abstraction pyramid (FPS, then per radius a ball
query, grouping and a max-pooled mini PointNet, the scales concatenated)
and feature propagation back to every point (the 3 nearest coarse points
interpolated by inverse squared distance, the skip features before them,
1x1 layers).  Fixed sample and neighbour counts keep every shape static;
the grouping is ``ops/pointnet2.py``.

Names are pcdet's: ``backbone_3d.SA_modules.{k}.mlps.{r}.{3j}`` (Conv2d
1x1 (O, I, 1, 1), one Sequential a radius) / ``.{3j + 1}`` (the norm) and
``backbone_3d.FP_modules.{i}.mlp.{3j}`` / ``.{3j + 1}``.  The norms are
``BatchNorm1d`` (pcdet's eps 1e-5 as a shifted running variance), their
statistics over the real neighbours (SA) or the valid points (FP).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import pointnet2 as pn2
from ..utils.registry import BACKBONES_3D
from .layers import run_masked
from .pfe import PointNetBlock, shared_mlp


class SAModuleMSG(PointNetBlock):
    """A set abstraction over ``npoint`` FPS samples, one scale a (radius,
    nsample, widths); ``npoint`` None groups all the points into one sample
    at the origin (pcdet's PointnetSAModule group-all: the raw xyz, not
    offsets, before the features).  ``forward(xyz (B, N, 3), feats (B, N,
    C) or None, valid (B, N))`` -> (new_xyz, new_feats, new_valid)."""

    def __init__(self, npoint, radii, nsamples, cin: int, mlps):
        super().__init__(cin, *mlps)
        self.npoint = npoint
        self.radii = [float(r) for r in radii]
        self.nsamples = [int(n) for n in nsamples]

    def forward(self, xyz, feats, valid):
        if self.npoint is None:
            b = xyz.shape[0]
            occupied = valid.any(dim=1)
            x = torch.cat([xyz, feats], dim=-1)
            pooled = self.pool(x, ~occupied, occupied[:, None].expand_as(valid))
            return xyz.new_zeros(b, 1, 3), pooled[:, None], occupied[:, None]
        idx = pn2.farthest_point_sample(xyz, valid, self.npoint)
        new_xyz = pn2.gather_points(xyz.contiguous(), idx)
        outs = []
        for s, (r, ns) in enumerate(zip(self.radii, self.nsamples)):
            grouped, _, empty, slot = pn2.query_and_group(r, ns, xyz, new_xyz, feats, valid=valid)
            outs.append(self.pool(grouped, empty, slot, scale=s))
        return new_xyz, torch.cat(outs, dim=-1), torch.gather(valid, 1, idx)


class FPModule(nn.Module):
    """Feature propagation: the coarse features interpolated at the fine
    points from their 3 nearest valid coarse points, the fine points' own
    features before them, then [Conv2d 1x1 (no bias), norm, ReLU] a width;
    invalid fine points zeroed."""

    def __init__(self, cin: int, mlp):
        super().__init__()
        self.mlp = shared_mlp(cin, mlp)

    def forward(self, xyz_fine, xyz_coarse, feats_fine, feats_coarse, valid_fine, valid_coarse):
        dist, idx = pn2.three_nn(xyz_fine, xyz_coarse, known_valid=valid_coarse)
        x = pn2.three_interpolate(feats_coarse, idx, dist)
        if feats_fine is not None:
            x = torch.cat([feats_fine, x], dim=-1)
        x = run_masked(self.mlp, x, valid_fine)
        return x * valid_fine.to(x.dtype)[..., None]


@BACKBONES_3D.register
class PointNet2MSG(nn.Module):
    """Reads "points" (B, N, F) (xyz first, F = ``input_channels``) and
    "points_mask"; writes "point_features" (B, N, FP_MLPS[0][-1]),
    "point_coords" (the xyz) and "point_valid" (the mask)."""

    def __init__(self, model_cfg, input_channels: int, grid_size=None, voxel_size=None,
                 point_cloud_range=None):
        super().__init__()
        sa = model_cfg["SA_CONFIG"]
        widths = [int(input_channels) - 3]  # each level's feature width
        mods = []
        for k, npoint in enumerate(sa["NPOINTS"]):
            mods.append(SAModuleMSG(int(npoint), sa["RADIUS"][k], sa["NSAMPLE"][k],
                                    3 + widths[-1], [list(m) for m in sa["MLPS"][k]]))
            widths.append(mods[-1].out_channels)
        self.SA_modules = nn.ModuleList(mods)
        fp_mlps = [list(m) for m in model_cfg["FP_MLPS"]]
        fps = [None] * len(fp_mlps)
        for i in range(len(fp_mlps) - 1, -1, -1):  # coarse to fine, as the forward
            fps[i] = FPModule(widths[i] + widths[i + 1], fp_mlps[i])
            widths[i] = fp_mlps[i][-1]
        self.FP_modules = nn.ModuleList(fps)
        self.num_point_features = widths[0]

    def forward(self, batch):
        points, valid = batch["points"], batch["points_mask"]
        xyz = points[..., :3]
        l_xyz, l_valid = [xyz], [valid]
        l_feats = [points[..., 3:] if points.shape[-1] > 3 else None]
        for sa in self.SA_modules:
            nx, nf, nv = sa(l_xyz[-1], l_feats[-1], l_valid[-1])
            l_xyz.append(nx)
            l_feats.append(nf)
            l_valid.append(nv)
        for i in range(len(self.FP_modules) - 1, -1, -1):
            l_feats[i] = self.FP_modules[i](l_xyz[i], l_xyz[i + 1], l_feats[i], l_feats[i + 1],
                                            l_valid[i], l_valid[i + 1])
        batch["point_features"] = l_feats[0]
        batch["point_coords"] = xyz
        batch["point_valid"] = valid
        return batch
