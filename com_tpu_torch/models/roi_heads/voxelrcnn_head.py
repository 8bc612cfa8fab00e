"""Voxel-RCNN head (counterpart of ``com_tpu/models/roi_heads/
voxelrcnn_head.py``; pcdet voxelrcnn_head.py): a GRID_SIZE^3 lattice in
each RoI, each grid point voxel-querying the 3D backbone's sparse volumes
(x_conv2/3/4 by default) at their own stride, the neighbours' features
with their offsets from the point pooled by a two-layer mini-PointNet, then
shared FCs and the class and box branches.

The pool is the JAX package's folded form (pcdet's ``mlps_in`` +
``mlps_pos`` pair folded into one biased ``pre`` layer): per neighbour
``pre`` + ReLU, masked to the real hits, the max over the neighbours, then
``out`` and ``out_bn`` (statistics over the non-empty balls) + ReLU on the
pooled point; an empty ball pools to zero, as in the JAX package (pcdet
feeds its norms' biases through there).  Layers ``roi_grid_pool_layers.
{i}.{pre,out,out_bn}``; ``utils.checkpoint.load_params_only`` folds a pcdet
state dict's pair and its eval-mode norms into them.  The FCs keep pcdet's names (``shared_fc_layer``,
``{cls,reg}_fc_layers``, ``{cls,reg}_pred_layer``), with dropout after
the shared blocks but the last, as the JAX head.  The head runs in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.sparse import batched_voxel_query
from ...utils.registry import ROI_HEADS
from ..layers import MaskedBatchNorm
from .fc import fc_stack, run_stack
from .pvrcnn_head import roi_grid_points

STRIDE_OF = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}


class GridPool(nn.Module):
    """One scale's pool: ``pre`` (3 + C -> mlps[0], biased), ``out``
    (mlps[0] -> mlps[1]) and ``out_bn``."""

    def __init__(self, cin: int, mlps):
        super().__init__()
        self.pre = nn.Linear(3 + cin, mlps[0])
        self.out = nn.Linear(mlps[0], mlps[1], bias=False)
        self.out_bn = MaskedBatchNorm(mlps[1])


def _flat_rows(idx, v):
    """(B, S, K) rows of each scene -> rows of the (B * V, ...) stacked scenes."""
    return idx + torch.arange(idx.shape[0], device=idx.device).view(-1, 1, 1) * v


def _gather_features(x, idx, hit):
    """x (B, V, C) at idx (B, S, K) -> (B, S, K, C), zero where ``hit`` is
    false.  An embedding lookup with the zero row as its padding index: the
    backward sorts the rows it adds into (no atomics), and the padding
    slots, most of them one row, add nothing.  The pooling masks those
    slots, so the values and gradients are those of reading slot 0 there."""
    b, v, c = x.shape
    table = torch.cat([x.reshape(b * v, c), x.new_zeros((1, c))])
    rows = torch.where(hit, _flat_rows(idx, v), b * v)
    return F.embedding(rows, table, padding_idx=b * v)


@ROI_HEADS.register
class VoxelRCNNHead(nn.Module):
    def __init__(self, model_cfg, num_class: int = 1, point_cloud_range=(0, -40, -3, 70.4, 40, 1),
                 voxel_size=(0.05, 0.05, 0.1), input_channels=None):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        pool_cfg = model_cfg["ROI_GRID_POOL"]
        self.grid = int(pool_cfg.get("GRID_SIZE", 6))
        self.sources = list(pool_cfg.get("FEATURES_SOURCE", ["x_conv2", "x_conv3", "x_conv4"]))
        layers, c_out = [], 0
        for src in self.sources:
            mlps = list(pool_cfg["POOL_LAYERS"][src].get("MLPS", [[32, 32]])[0])
            if not (pool_cfg.get("PRE_MLP", False) and len(mlps) == 2):
                raise NotImplementedError(
                    "VoxelRCNNHead's PointNetBlock pool (PRE_MLP off or MLPS of other than two "
                    "layers, com_tpu/models/pfe.py) is not ported yet")
            layers.append(GridPool(int(input_channels[src]), mlps))
            c_out += mlps[1]
        self.roi_grid_pool_layers = nn.ModuleList(layers)
        dp = float(model_cfg.get("DP_RATIO", 0.0))
        shared = list(model_cfg.get("SHARED_FC", [256, 256]))
        self.shared_fc_layer = fc_stack(self.grid ** 3 * c_out, shared, nn.Linear,
                                        lambda i: dp > 0 and i != len(shared) - 1, drop=dp)
        for name, out_ch in (("cls", num_class), ("reg", 7)):
            fcs = list(model_cfg.get(f"{name.upper()}_FC", [256, 256]))
            setattr(self, f"{name}_fc_layers",
                    fc_stack(shared[-1], fcs, nn.Linear,
                             lambda i, n=len(fcs): dp > 0 and i != n - 1))
            setattr(self, f"{name}_pred_layer", nn.Linear(fcs[-1] if fcs else shared[-1], out_ch))

    def _pool(self, layer, src, feats, coords, valid, sgrid, grid_pts):
        """One scale: (B, S, 3) world grid points -> (B, S, mlps[1])."""
        lcfg = self.model_cfg["ROI_GRID_POOL"]["POOL_LAYERS"][src]
        stride = STRIDE_OF[src]
        vx, vy, vz = self.voxel_size
        x0, y0, z0 = self.point_cloud_range[:3]
        qv = torch.stack([(grid_pts[..., 2] - z0) / (vz * stride),
                          (grid_pts[..., 1] - y0) / (vy * stride),
                          (grid_pts[..., 0] - x0) / (vx * stride)], dim=-1)
        idx, empty, slot = batched_voxel_query(
            qv, coords, valid, sgrid, max_range=int(lcfg.get("QUERY_RANGES", [[4, 4, 4]])[0][0]),
            nsample=int(lcfg.get("NSAMPLE", [16])[0]), cell_zyx=(vz * stride, vy * stride,
                                                                  vx * stride),
            radius_world=float(lcfg.get("POOL_RADIUS", [0.4])[0]))
        nf = _gather_features(feats, idx, slot)  # (B, S, K, C)
        centers = coords.reshape(-1, 3)[_flat_rows(idx, coords.shape[1])].to(feats.dtype)  # zyx
        cw = torch.stack([centers[..., 2] * (vx * stride) + vx * stride / 2 + x0,
                          centers[..., 1] * (vy * stride) + vy * stride / 2 + y0,
                          centers[..., 0] * (vz * stride) + vz * stride / 2 + z0], dim=-1)
        grouped = torch.cat([cw - grid_pts[:, :, None, :], nf], dim=-1)
        h = torch.relu(layer.pre(grouped))
        h = torch.where(slot[..., None], h, torch.zeros_like(h))  # pad slots (h >= 0)
        pooled = layer.out(h.max(dim=2).values)
        pooled = torch.relu(layer.out_bn(pooled, mask=~empty))
        return pooled * (~empty)[..., None].to(pooled.dtype)

    def forward(self, batch):
        rois = batch["rois"].detach()  # (B, R, 7)
        b, r = rois.shape[:2]
        grid_pts = roi_grid_points(rois, self.grid).reshape(b, r * self.grid ** 3, 3)
        multi = batch["multi_scale_3d_features"]
        pooled = [self._pool(layer, src, *multi[src], grid_pts)
                  for layer, src in zip(self.roi_grid_pool_layers, self.sources)]
        x = torch.cat(pooled, dim=-1).reshape(b, r, -1)
        gen = batch.get("rngs", {}).get("dropout")
        x = run_stack(self.shared_fc_layer, x, gen)
        batch["rcnn_cls"] = self.cls_pred_layer(run_stack(self.cls_fc_layers, x))[..., 0]
        batch["rcnn_reg"] = self.reg_pred_layer(run_stack(self.reg_fc_layers, x))
        return batch
