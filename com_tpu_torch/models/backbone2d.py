"""BEV 2D backbone (counterpart of ``com_tpu/models/backbone2d.py``;
pcdet base_bev_backbone.py:6-112), NHWC throughout.

Stride blocks of (Conv + BN + ReLU) x (1 + layer_nums[i]), lateral deblocks,
channel concat.  Module names follow pcdet: ``blocks.{i}`` is a Sequential
whose index 0 is pcdet's ZeroPad2d slot (the convs pad themselves here), then
(conv, norm, relu) triples; ``deblocks.{i}`` is (deconv, norm, relu).  The
stride-1 3x3 convs run on kernel K2.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.registry import BACKBONES_2D
from .layers import BatchNorm, Conv2d


class Deconv(nn.Module):
    """Lateral upsampling over NHWC with pcdet's ConvTranspose2d weight
    (I, O, k, k): a 1x1 conv for stride 1, a transposed conv with kernel =
    stride otherwise."""

    def __init__(self, cin: int, cout: int, stride: int, dtype=None):
        super().__init__()
        self.stride, self.dtype = stride, dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, stride, stride))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x, w = x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt)
        if self.stride == 1:
            y = F.conv2d(x, w.transpose(0, 1))
        else:
            y = F.conv_transpose2d(x, w, stride=self.stride)
        return y.permute(0, 2, 3, 1).contiguous()


@BACKBONES_2D.register
class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels: int, dtype=None):
        super().__init__()
        layer_nums = list(model_cfg.get("LAYER_NUMS", []))
        strides = list(model_cfg.get("LAYER_STRIDES", []))
        filters = list(model_cfg.get("NUM_FILTERS", []))
        up_strides = list(model_cfg.get("UPSAMPLE_STRIDES", []))
        up_filters = list(model_cfg.get("NUM_UPSAMPLE_FILTERS", []))
        self.dtype = dtype
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        cin = input_channels
        for i, (ln, st, nf) in enumerate(zip(layer_nums, strides, filters)):
            layers = [nn.Identity()]
            for k in range(ln + 1):
                layers += [Conv2d(cin if k == 0 else nf, nf, 3, st if k == 0 else 1, dtype=dtype),
                           BatchNorm(nf, eps=1e-3), nn.ReLU()]
            self.blocks.append(nn.Sequential(*layers))
            if i < len(up_strides):
                us = up_strides[i]
                if us >= 1:
                    up = Deconv(nf, up_filters[i], int(us), dtype=dtype)
                else:  # a fractional stride is a downsampling conv
                    ds = int(round(1 / us))
                    up = Conv2d(nf, up_filters[i], ds, ds, dtype=dtype, padding=0)
                self.deblocks.append(nn.Sequential(up, BatchNorm(up_filters[i], eps=1e-3),
                                                   nn.ReLU()))
            cin = nf
        c_in = sum(up_filters[:len(layer_nums)]) if up_filters else cin
        if len(up_strides) > len(layer_nums):  # an extra deconv on the concat
            self.deblocks.append(nn.Sequential(
                Deconv(c_in, up_filters[-1], int(up_strides[-1]), dtype=dtype),
                BatchNorm(up_filters[-1], eps=1e-3), nn.ReLU()))
            c_in = up_filters[-1]
        self.num_bev_features = c_in

    def forward(self, batch):
        x = batch["spatial_features"]
        if self.dtype is not None:
            x = x.to(self.dtype)
        ups = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i < len(self.deblocks):
                ups.append(self.deblocks[i](x))
        if len(ups) > 1:
            x = torch.cat(ups, dim=-1)
        elif ups:
            x = ups[0]
        if len(self.deblocks) > len(self.blocks):
            x = self.deblocks[-1](x)
        batch["spatial_features_2d"] = x
        return batch
