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

Parameter names and layouts follow pcdet with spconv 2.x:
``conv_input.{0,1}``, ``conv{1..4}.{j}.{0,1}`` (the residual variant's
blocks ``.conv{1,2}`` / ``.bn{1,2}``), ``conv_out.{0,1}``; sparse conv
weights are (Cout, kz, ky, kx, Cin).
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
    """Residual pair of biased submanifold convs (spconv_backbone.py:30-67):
    conv1 + bn1 + relu, conv2 + bn2, add the identity, relu."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SparseConv3d(channels, channels, bias=True)
        self.bn1 = MaskedBatchNorm(channels, eps=1e-3)
        self.conv2 = SparseConv3d(channels, channels, bias=True)
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


BACKBONES_3D.register_unported("VoxelBackBone8xFocal", "focal sparse conv")
BACKBONES_3D.register_unported("UNetV2", "PartA2's sparse U-Net, inverse convs")


class SemSegEncoder(nn.Module):
    """The focal backbone's image encoder waits for VoxelBackBone8xFocal."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("SemSegEncoder (focal multimodal image encoder) is not "
                                  "ported yet")
