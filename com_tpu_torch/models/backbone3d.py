"""Sparse 3D voxel backbones (counterpart of ``com_tpu/models/backbone3d.py``;
pcdet spconv_backbone.py:69-293) over the port's sparse engine
(``ops/sparse.py``).

Four stages at strides 1/2/4/8, then conv_out, a (3, 1, 1) conv of stride
(2, 1, 1) that compresses z; the output is the dense (B, D, H/8, W/8, C)
tensor HeightCompression folds.  The grid is spconv's, z padded by one;
conv4's strided conv pads (0, 1, 1).  Every stage's submanifold convs share
one rulebook, built once a stage.  Each stage keeps at most ``VOXEL_CAPS``
sites a scene (overflow dropped in key order).  The norms' statistics run
over the batch's valid voxels (eps 1e-3, flax momentum 0.99 = torch 0.01).
The backbone runs in f32 (MeanVFE's features are f32 under
MIXED_PRECISION).

``UNetV2`` (PartA2) adds a decoder back to the input sites: residual,
merge and inverse-conv blocks a stage (``ops/sparse.py``
``batched_inverse_conv3d``).

Parameter names and layouts follow pcdet with spconv 2.x:
``conv_input.{0,1}``, ``conv{1..4}.{j}.{0,1}`` (the residual variant's
blocks ``.conv{1,2}`` / ``.bn{1,2}``), ``conv_out.{0,1}``; UNetV2's
``conv_up_t{k}.conv{1,2}`` / ``.bn{1,2}``, ``conv_up_m{k}.{0,1}``,
``inv_conv{k}.{0,1}``, ``conv5.0.{0,1}``; sparse conv weights are (Cout,
kz, ky, kx, Cin).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import sparse as sp
from ..utils.registry import BACKBONES_3D
from .layers import MaskedBatchNorm


class SparseConv3d(nn.Module):
    """A sparse conv's weight (spconv 2.x layout (Cout, kz, ky, kx, Cin)) and
    optional bias; the rulebook is the caller's."""

    def __init__(self, cin: int, cout: int, kernel=3, bias: bool = False):
        super().__init__()
        self.kernel = sp._triple(kernel)
        self.weight = nn.Parameter(torch.empty(cout, *self.kernel, cin))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def taps(self) -> torch.Tensor:
        """(K3, Cin, Cout), taps in the row-major (dz, dy, dx) order."""
        w = self.weight
        return w.permute(1, 2, 3, 4, 0).reshape(-1, w.shape[-1], w.shape[0])

    def subm(self, x, valid, nidx):
        y = sp.batched_subm_conv3d(x, valid, nidx, self.taps())
        return y if self.bias is None else y + self.bias

    def strided(self, x, valid, nidx, back, out_valid):
        y = sp.batched_gather_conv3d(x, valid, nidx, back, out_valid, self.taps())
        return y if self.bias is None else y + self.bias


def _norm_act(norm, y, valid, relu=True):
    y = norm(y, valid)
    if relu:
        y = torch.relu(y)
    return y * valid[..., None].to(y.dtype)


class SparseConvBlock(nn.Sequential):
    """pcdet's post_act_block: sparse conv ``0``, norm ``1``, ReLU; outputs
    zero at invalid sites.  ``stride`` None is a submanifold conv."""

    def __init__(self, cin: int, cout: int, stride=None, kernel=3, pad=1):
        super().__init__(SparseConv3d(cin, cout, kernel), MaskedBatchNorm(cout, eps=1e-3))
        self.stride = None if stride is None else sp._triple(stride)
        self.kernel, self.pad = sp._triple(kernel), sp._triple(pad)

    def forward(self, x, valid, nidx):
        return _norm_act(self[1], self[0].subm(x, valid, nidx), valid)

    def strided(self, x, coords, valid, grid, out_cap):
        """The strided conv with its own rulebook: (out, coords, valid, grid)."""
        nidx, back, oc, ov, og = sp.batched_strided_rulebook(coords, valid, grid, out_cap,
                                                             self.stride, self.kernel, self.pad)
        return _norm_act(self[1], self[0].strided(x, valid, nidx, back, ov), ov), oc, ov, og


class SparseBasicBlock(nn.Module):
    """Residual pair of submanifold convs (spconv_backbone.py:30-67): conv1 +
    bn1 + relu, conv2 + bn2, add the identity, relu.  The backbone's convs
    carry a bias; UNetV2's decoder variant (spconv_unet.py:11-27) has none."""

    def __init__(self, channels: int, bias: bool = True):
        super().__init__()
        self.conv1 = SparseConv3d(channels, channels, bias=bias)
        self.bn1 = MaskedBatchNorm(channels, eps=1e-3)
        self.conv2 = SparseConv3d(channels, channels, bias=bias)
        self.bn2 = MaskedBatchNorm(channels, eps=1e-3)

    def forward(self, x, valid, nidx):
        y = _norm_act(self.bn1, self.conv1.subm(x, valid, nidx), valid)
        y = _norm_act(self.bn2, self.conv2.subm(y, valid, nidx), valid, relu=False)
        return torch.relu(y + x) * valid[..., None].to(y.dtype)


@BACKBONES_3D.register
class VoxelBackBone8x(nn.Module):
    """VoxelBackBone8x: stage bodies of single submanifold blocks, channels
    16/32/64/64 unless ``CHANNELS`` says otherwise, ``OUT_CHANNELS`` 128."""

    default_channels = (16, 32, 64, 64)  # spconv_backbone.py:85-110
    stage1_depth = 1  # conv1: one block; the residual variant has two

    def _stage_block(self, ch):
        return SparseConvBlock(ch, ch)

    def __init__(self, model_cfg, input_channels: int, grid_size, voxel_size=None,
                 point_cloud_range=None):
        super().__init__()
        self.model_cfg = model_cfg
        nx, ny, nz = (int(g) for g in grid_size)
        self.grid = (nz + 1, ny, nx)  # spconv's sparse_shape: z + 1
        ch = list(model_cfg.get("CHANNELS", self.default_channels))
        out_ch = int(model_cfg.get("OUT_CHANNELS", 128))
        self.last_pad = int(model_cfg.get("last_pad", 0))
        self.conv_input = SparseConvBlock(input_channels, ch[0])
        self.conv1 = nn.Sequential(*(self._stage_block(ch[0]) for _ in range(self.stage1_depth)))
        for s in (1, 2, 3):
            # conv4's strided conv pads (0, 1, 1): z shrinks by the kernel
            pad = (0, 1, 1) if s == 3 else 1
            setattr(self, f"conv{s + 1}", nn.Sequential(
                SparseConvBlock(ch[s - 1], ch[s], stride=2, pad=pad),
                self._stage_block(ch[s]), self._stage_block(ch[s])))
        self.conv_out = SparseConvBlock(ch[3], out_ch, stride=(2, 1, 1), kernel=(3, 1, 1),
                                        pad=self.last_pad)
        grid = self.grid
        for s in (2, 3, 4):
            blk = getattr(self, f"conv{s}")[0]
            grid = sp.downsampled_grid(grid, blk.stride, blk.kernel, blk.pad)
        self.out_grid = sp.downsampled_grid(grid, (2, 1, 1), (3, 1, 1), self.last_pad)
        self.num_bev_features = out_ch * self.out_grid[0]
        self.multi_scale_channels = {f"x_conv{s + 1}": ch[s] for s in range(4)}

    def forward(self, batch):
        x = batch["pillar_features"]  # (B, V, C) from MeanVFE
        coords = batch["voxel_coords"]  # (B, V, 3) zyx, -1 rows padding
        valid = coords[..., 0] >= 0
        v = x.shape[1]
        caps = self.model_cfg.get("VOXEL_CAPS", [v, v, max(v // 2, 1), max(v // 4, 1)])
        grid = self.grid
        multi = {}
        rb = sp.batched_subm_rulebook(coords, valid, grid)  # one rulebook a stage
        x = self.conv_input(x, valid, rb)
        for blk in self.conv1:
            x = blk(x, valid, rb)
        multi["x_conv1"] = (x, coords, valid, grid)
        for s in (1, 2, 3):
            stage = getattr(self, f"conv{s + 1}")
            x, coords, valid, grid = stage[0].strided(x, coords, valid, grid, int(caps[s]))
            rb = sp.batched_subm_rulebook(coords, valid, grid)
            for blk in stage[1:]:
                x = blk(x, valid, rb)
            multi[f"x_conv{s + 1}"] = (x, coords, valid, grid)
        x, coords, valid, grid = self.conv_out.strided(x, coords, valid, grid, int(caps[3]))
        batch["encoded_spconv_tensor"] = sp.batched_scatter_to_dense(x, coords, valid, grid)
        batch["encoded_spconv_tensor_stride"] = 8
        batch["multi_scale_3d_features"] = multi
        return batch


@BACKBONES_3D.register
class VoxelResBackBone8x(VoxelBackBone8x):
    """The residual variant (spconv_backbone.py:183-240): two
    SparseBasicBlocks a stage body, channels 16/32/64/128."""

    default_channels = (16, 32, 64, 128)
    stage1_depth = 2

    def _stage_block(self, ch):
        return SparseBasicBlock(ch)


def channel_reduction(x, out_channels: int):
    """(..., C1) -> (..., C2) by summing each group of C1 / C2 adjacent
    channels (spconv_unet.py:150-163)."""
    c1 = x.shape[-1]
    assert c1 % out_channels == 0
    return x.reshape(*x.shape[:-1], out_channels, c1 // out_channels).sum(-1)


class InverseConvBlock(SparseConvBlock):
    """pcdet's inverse post_act_block: SparseInverseConv3d ``0`` (stride 2,
    kernel 3, the downsampling conv's ``pad``), norm ``1``, ReLU, at the
    high-resolution sites."""

    def __init__(self, cin: int, cout: int, pad=1):
        super().__init__(cin, cout, stride=2, pad=pad)

    def inverse(self, x, coords, valid, grid, hi_coords, hi_valid):
        y = sp.batched_inverse_conv3d(x, coords, valid, self[0].taps(), hi_coords, hi_valid,
                                      grid, self.stride, self.kernel, self.pad)
        return _norm_act(self[1], y, hi_valid)


@BACKBONES_3D.register
class UNetV2(nn.Module):
    """PartA2's sparse U-Net (spconv_unet.py:89-212; the JAX package's
    ``UNetV2``): VoxelBackBone8x's encoder (its stage caps, conv4's (0, 1, 1)
    pad), with RETURN_ENCODED_TENSOR (default on) conv_out's dense (B, D,
    H/8, W/8, 128) tensor, then a decoder of UR blocks back to the input
    sites: at each stage a bias-free residual block over the lateral
    features (``conv_up_t{k}``), a conv over [bottom, lateral]
    (``conv_up_m{k}``) plus the channel-reduced concatenation, and an
    inverse conv to the stage above (``inv_conv{k}``, the downsampling
    conv's pad) or, at stage 1, ``conv5``.  Every conv at a stage's sites
    reads that stage's one rulebook.  Writes "point_features" (B, V,
    CHANNELS[0]), "point_coords" (the voxel centres) and "point_valid"."""

    def __init__(self, model_cfg, input_channels: int, grid_size, voxel_size=None,
                 point_cloud_range=None):
        super().__init__()
        self.model_cfg = model_cfg
        nx, ny, nz = (int(g) for g in grid_size)
        self.grid = (nz + 1, ny, nx)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        ch = [int(c) for c in model_cfg.get("CHANNELS", [16, 32, 64, 64])]
        self.conv_input = SparseConvBlock(input_channels, ch[0])
        self.conv1 = nn.Sequential(SparseConvBlock(ch[0], ch[0]))
        for s in (1, 2, 3):
            pad = (0, 1, 1) if s == 3 else 1
            setattr(self, f"conv{s + 1}", nn.Sequential(
                SparseConvBlock(ch[s - 1], ch[s], stride=2, pad=pad),
                SparseConvBlock(ch[s], ch[s]), SparseConvBlock(ch[s], ch[s])))
        self.encoded = bool(model_cfg.get("RETURN_ENCODED_TENSOR", True))
        grid = self.grid
        for s in (2, 3, 4):
            blk = getattr(self, f"conv{s}")[0]
            grid = sp.downsampled_grid(grid, blk.stride, blk.kernel, blk.pad)
        self.num_bev_features = None
        if self.encoded:
            last_pad = int(model_cfg.get("last_pad", 0))
            self.conv_out = SparseConvBlock(ch[3], 128, stride=(2, 1, 1), kernel=(3, 1, 1),
                                            pad=last_pad)
            self.out_grid = sp.downsampled_grid(grid, (2, 1, 1), (3, 1, 1), last_pad)
            self.num_bev_features = 128 * self.out_grid[0]
        for k in (4, 3, 2, 1):
            lat = ch[k - 1]
            setattr(self, f"conv_up_t{k}", SparseBasicBlock(lat, bias=False))
            setattr(self, f"conv_up_m{k}", SparseConvBlock(2 * lat, lat))
            if k > 1:
                setattr(self, f"inv_conv{k}", InverseConvBlock(
                    lat, ch[k - 2], pad=(0, 1, 1) if k == 4 else 1))
        self.conv5 = nn.Sequential(SparseConvBlock(ch[0], ch[0]))
        self.num_point_features = ch[0]

    def forward(self, batch):
        x = batch["pillar_features"]  # (B, V, C) from MeanVFE
        coords = batch["voxel_coords"]  # (B, V, 3) zyx, -1 rows padding
        valid = coords[..., 0] >= 0
        v = x.shape[1]
        caps = self.model_cfg.get("VOXEL_CAPS", [v, v, max(v // 2, 1), max(v // 4, 1)])
        grid = self.grid
        rb = sp.batched_subm_rulebook(coords, valid, grid)  # one rulebook a stage
        x = self.conv1[0](self.conv_input(x, valid, rb), valid, rb)
        stages = [(x, coords, valid, grid, rb)]
        for s in (1, 2, 3):
            stage = getattr(self, f"conv{s + 1}")
            x, coords, valid, grid = stage[0].strided(x, coords, valid, grid, int(caps[s]))
            rb = sp.batched_subm_rulebook(coords, valid, grid)
            for blk in stage[1:]:
                x = blk(x, valid, rb)
            stages.append((x, coords, valid, grid, rb))
        if self.encoded:
            xo, co, vo, go = self.conv_out.strided(x, coords, valid, grid, int(caps[3]))
            batch["encoded_spconv_tensor"] = sp.batched_scatter_to_dense(xo, co, vo, go)
            batch["encoded_spconv_tensor_stride"] = 8
        bottom = x
        for k in (4, 3, 2, 1):
            lat, lc, lv, lg, lrb = stages[k - 1]
            cat = torch.cat([bottom, getattr(self, f"conv_up_t{k}")(lat, lv, lrb)], dim=-1)
            x_m = getattr(self, f"conv_up_m{k}")(cat, lv, lrb)
            merged = x_m + channel_reduction(cat, x_m.shape[-1])
            if k > 1:
                _, hc, hv, _, _ = stages[k - 2]
                bottom = getattr(self, f"inv_conv{k}").inverse(merged, lc, lv, lg, hc, hv)
            else:
                bottom = self.conv5[0](merged, lv, lrb)
        _, c0, v0, _, _ = stages[0]
        vx, vy, vz = self.voxel_size
        pr = self.point_cloud_range
        c0 = c0.to(bottom.dtype)
        batch["point_features"] = bottom
        batch["point_coords"] = torch.stack([c0[..., 2] * vx + vx / 2 + pr[0],
                                             c0[..., 1] * vy + vy / 2 + pr[1],
                                             c0[..., 0] * vz + vz / 2 + pr[2]], dim=-1)
        batch["point_valid"] = v0
        return batch


BACKBONES_3D.register_unported("VoxelBackBone8xFocal", "focal sparse conv")


class SemSegEncoder(nn.Module):
    """The focal backbone's image encoder waits for VoxelBackBone8xFocal."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("SemSegEncoder (focal multimodal image encoder) is not "
                                  "ported yet")
