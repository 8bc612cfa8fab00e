"""Dense 3D -> BEV (counterpart of ``com_tpu/models/map_to_bev.py``):
``HeightCompression`` and CaDDN's ``Conv2DCollapse``."""
from __future__ import annotations

from torch import nn

from ..utils.registry import MAP_TO_BEV


@MAP_TO_BEV.register
class HeightCompression(nn.Module):
    """The sparse backbone's dense (B, D, H, W, C) output with z folded into
    channels (height_compression.py:10-26): (B, H, W, D*C), channel
    ``d*C + c``, as the JAX package folds it.  pcdet's ``view(N, C*D, H,
    W)`` orders them ``c*D + d``; both packages keep their own order, so a
    pcdet checkpoint's first BEV conv sees its input channels permuted
    (ROADMAP Queue 3)."""

    def __init__(self, model_cfg=None, in_channels=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_bev_features = in_channels  # the folding keeps the width

    def forward(self, batch):
        dense = batch["encoded_spconv_tensor"]
        b, d, h, w, c = dense.shape
        batch["spatial_features"] = dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)
        batch["spatial_features_stride"] = batch.get("encoded_spconv_tensor_stride", 8)
        return batch


MAP_TO_BEV.register_unported("PointPillarScatter", "hard-voxel pillar scatter")


@MAP_TO_BEV.register
class Conv2DCollapse(nn.Module):
    """CaDDN's learned height collapse (conv2d_collapse.py): the (B, Z, Y, X,
    C) volume with z folded into channels as ``HeightCompression`` folds it
    (``d*C + c``), then pcdet's BasicBlock2D ``block`` (a bias-free 1x1
    ``conv`` to NUM_BEV_FEATURES, ``bn``, ReLU)."""

    def __init__(self, model_cfg, in_channels: int):
        super().__init__()
        from .image_vfe import BasicBlock2D

        self.model_cfg = model_cfg
        self.num_bev_features = int(model_cfg.get("NUM_BEV_FEATURES", 256))
        self.block = BasicBlock2D(in_channels, self.num_bev_features)

    def forward(self, batch):
        dense = batch["encoded_spconv_tensor"]
        b, d, h, w, c = dense.shape
        batch["spatial_features"] = self.block(dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c))
        batch["spatial_features_stride"] = batch.get("encoded_spconv_tensor_stride", 8)
        return batch
