"""Detector composition (counterpart of ``com_tpu/models/detectors.py``).

A detector is the slot chain vfe -> backbone_3d -> map_to_bev (skipped when
the VFE wrote ``spatial_features``) -> backbone_2d -> dense_head over a
batch dict.  The slots are attributes named as in pcdet, so ``state_dict()``
keys read ``vfe.pfn_layers.0.linear.weight``, ``backbone_3d.conv2.0.0.weight``,
``backbone_2d.blocks.0.1.weight``, ``dense_head.shared_conv.0.weight``...
CenterPoint, PointPillar and SECONDNet are ported, for inference and
training (``net.train()`` puts the norms in batch-statistics mode; the head
returns raw predictions in both modes); the point and RoI stages come later.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.registry import (BACKBONES_2D, BACKBONES_3D, DENSE_HEADS, DETECTORS, MAP_TO_BEV,
                              VFES)
from . import backbone2d as _b2  # noqa: F401 (register)
from . import backbone3d as _b3  # noqa: F401
from . import dense_heads as _dh  # noqa: F401
from . import map_to_bev as _mb  # noqa: F401
from . import vfe as _vfe  # noqa: F401
from .backbone2d import Deconv
from .backbone3d import SparseConv3d
from .layers import BatchNorm, Conv2d


class DatasetMeta:
    """Static dataset facts the model needs (shapes, ranges, classes)."""

    def __init__(self, class_names, point_cloud_range, voxel_size, grid_size,
                 num_point_features):
        self.class_names = tuple(class_names)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.grid_size = tuple(int(v) for v in grid_size)
        self.num_point_features = int(num_point_features)


class Detector3D(nn.Module):
    """Generic slot-ordered detector."""

    def __init__(self, model_cfg, meta: DatasetMeta):
        super().__init__()
        self.model_cfg, self.meta = model_cfg, meta
        for slot in ("PFE", "POINT_HEAD", "ROI_HEAD"):
            if model_cfg.get(slot) is not None:
                raise NotImplementedError(f"{slot} is not ported yet")
        mixed = bool(model_cfg.get("MIXED_PRECISION", False))
        dt = torch.bfloat16 if mixed else None

        vfe_cfg = model_cfg["VFE"]
        if mixed and "MIXED_PRECISION" not in vfe_cfg:
            vfe_cfg = dict(vfe_cfg, MIXED_PRECISION=True)
        self.vfe = VFES.get(vfe_cfg["NAME"])(
            vfe_cfg, meta.num_point_features, meta.voxel_size, meta.point_cloud_range,
            meta.grid_size)
        # a VFE that scatters to the BEV canvas itself says how wide it is
        bev_ch = getattr(self.vfe, "num_bev_features", None)

        b3_cfg = model_cfg.get("BACKBONE_3D")
        self.backbone_3d = None
        if b3_cfg is not None:
            self.backbone_3d = BACKBONES_3D.get(b3_cfg["NAME"])(
                b3_cfg, self.vfe.num_point_features, meta.grid_size, meta.voxel_size,
                meta.point_cloud_range)
        self.map_to_bev = None
        if bev_ch is None:
            m2b_cfg = model_cfg["MAP_TO_BEV"]
            self.map_to_bev = MAP_TO_BEV.get(m2b_cfg["NAME"])(m2b_cfg)
            bev_ch = self.backbone_3d.num_bev_features

        b2_cfg = model_cfg.get("BACKBONE_2D")
        self.backbone_2d = None
        if b2_cfg is not None:
            self.backbone_2d = BACKBONES_2D.get(b2_cfg["NAME"])(b2_cfg, bev_ch, dtype=dt)
            bev_ch = self.backbone_2d.num_bev_features

        dh_cfg = model_cfg["DENSE_HEAD"]
        if mixed and "MIXED_PRECISION" not in dh_cfg:
            dh_cfg = dict(dh_cfg, MIXED_PRECISION=True)
        self.dense_head = DENSE_HEADS.get(dh_cfg["NAME"])(
            dh_cfg, bev_ch, len(meta.class_names), meta.class_names)

    def forward(self, batch):
        batch = self.vfe(batch)
        if self.backbone_3d is not None:
            batch = self.backbone_3d(batch)
        if self.map_to_bev is not None:
            batch = self.map_to_bev(batch)
        if self.backbone_2d is not None:
            batch = self.backbone_2d(batch)
        return self.dense_head(batch)


@DETECTORS.register
class CenterPoint(Detector3D):
    """CenterPoint (detectors/centerpoint.py) — COM's primary detector."""


@DETECTORS.register
class PointPillar(Detector3D):
    """PointPillars (detectors/pointpillar.py): its PointPillarScatter is the
    VFE's own scatter into the canvas, as for CenterPoint-Pillar."""


@DETECTORS.register
class SECONDNet(Detector3D):
    """SECOND (detectors/second_net.py): MeanVFE, the sparse 3D backbone,
    HeightCompression, the BEV backbone and an anchor head."""


def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight from ``generator`` (on the CPU, then copied to the
    net's device): convs, sparse convs and linears uniform in
    +-1/sqrt(fan_in) (PyTorch's default bound; a sparse conv's fan-in is
    taps x Cin), their biases the same, norms at identity, and the
    heatmap's final bias and the anchor head's class bias at their init
    values (the latter the prior -log((1 - 0.01) / 0.01), as flax's)."""
    from .dense_heads.anchor_head import CLS_BIAS_INIT, AnchorHeadSingle
    from .dense_heads.center_head import SeparateHead

    def draw(t, bound):
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))

    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (Conv2d, Deconv, nn.Linear)):
                w = mod.weight
                bound = 1.0 / math.sqrt(w.shape[0] if isinstance(mod, Deconv) else w[0].numel())
                draw(w, bound)
                if getattr(mod, "bias", None) is not None:
                    draw(mod.bias, bound)
            elif isinstance(mod, SparseConv3d):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())  # (kz, ky, kx, Cin)
                draw(mod.weight, bound)
                if mod.bias is not None:
                    draw(mod.bias, bound)
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        for mod in net.modules():
            if isinstance(mod, SeparateHead) and "hm" in mod.names:
                mod.hm[-1].bias.fill_(mod.init_bias)
            elif isinstance(mod, AnchorHeadSingle):
                mod.conv_cls.bias.fill_(CLS_BIAS_INIT)
    return net


def build_network(model_cfg, meta: DatasetMeta, device=None, seed: int = 0):
    """The detector named by ``model_cfg["NAME"]`` in eval mode on ``device``
    (CUDA unless the caller passes another), weights drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    net = DETECTORS.get(model_cfg["NAME"])(model_cfg, meta)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.to(dev).eval()
