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
from ..ops.boxes import points_in_rbbox
from ..parallel.sharding import global_sum
from ..utils.registry import BACKBONES_3D
from .layers import Conv2d, ConvBNReLU, MaskedBatchNorm


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


class SemSegEncoder(nn.Module):
    """The focal multimodal model's image encoder (the JAX package's compact
    stand-in for pcdet's pretrained DeepLabV3 'layer1' and its 1x1
    channel_reduce, trained with the model): two stride-2 ConvBNReLUs
    (32, 64), a stride-1 bias-free one (``body``, on kernel K2), a
    bias-free 1x1 to ``out_channels``; images (B, H, W, 3) -> (B, H/4,
    W/4, out_channels)."""

    def __init__(self, out_channels: int = 16):
        super().__init__()
        self.stem0 = ConvBNReLU(3, 32, 3, stride=2)
        self.stem1 = ConvBNReLU(32, 64, 3, stride=2)
        self.body = ConvBNReLU(64, 64, 3, stride=1)
        self.channel_reduce = Conv2d(64, out_channels, 1)

    def forward(self, images):
        return self.channel_reduce(self.body(self.stem1(self.stem0(images))))


def voxel_image_features(img_feats, coords, valid, stride, voxel_size, pc_range, l2c, c2i,
                         feat_ds, img_hw, noise_rot, noise_scale, flip_x, flip_y):
    """Each voxel's image features, bilinear at its centre's projection
    (focal_sparse_conv.construct_multimodal_features, the JAX package's
    ``voxel_image_features`` over a batch): the world augmentations undone
    first (scale, rotation, then the flips), zero off the true image extent
    ``img_hw``, behind the camera or at an invalid voxel.  img_feats (B, h,
    w, C); coords (B, V, 3) zyx at ``stride``; l2c (B, 4, 4), c2i (B, 3,
    4), img_hw (B, 2), the augmentations (B,) -> (B, V, C)."""
    vx, vy, vz = (float(v) for v in voxel_size)
    cf = coords.to(torch.float32)
    x = cf[..., 2] * (vx * stride) + pc_range[0]
    y = cf[..., 1] * (vy * stride) + pc_range[1]
    z = cf[..., 0] * (vz * stride) + pc_range[2]
    inv_scale = (1.0 / torch.clamp(noise_scale.to(torch.float32), min=1e-6))[:, None]
    x, y, z = x * inv_scale, y * inv_scale, z * inv_scale
    rot = -noise_rot.to(torch.float32)[:, None]
    c, s = torch.cos(rot), torch.sin(rot)
    x, y = x * c - y * s, x * s + y * c
    y = torch.where(flip_x.to(torch.bool)[:, None], -y, y)
    x = torch.where(flip_y.to(torch.bool)[:, None], -x, x)
    pts = torch.stack([x, y, z, torch.ones_like(x)], dim=-1)  # (B, V, 4)
    cam = (pts @ l2c.transpose(1, 2))[..., :3]
    img = torch.cat([cam, torch.ones_like(cam[..., :1])], dim=-1) @ c2i.transpose(1, 2)
    depth = img[..., 2]
    uv = img[..., :2] / torch.clamp(depth[..., None], min=1e-6)
    b, h, w, ch = img_feats.shape
    u, v = uv[..., 0] / feat_ds, uv[..., 1] / feat_ds
    hw = img_hw.to(torch.float32)
    h_lim = torch.clamp(hw[:, 0] / feat_ds, max=float(h))[:, None] - 1
    w_lim = torch.clamp(hw[:, 1] / feat_ds, max=float(w))[:, None] - 1
    inview = (depth > 0) & (u >= 0) & (u < w_lim) & (v >= 0) & (v < h_lim) & valid
    u = torch.clamp(u, 0, w - 1.001)
    v = torch.clamp(v, 0, h - 1.001)
    u0, v0 = torch.floor(u).to(torch.int64), torch.floor(v).to(torch.int64)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    flat = img_feats.reshape(b, h * w, ch)

    def at(vi, ui):
        return torch.gather(flat, 1, (vi * w + ui)[..., None].expand(-1, -1, ch))

    g = (at(v0, u0) * ((1 - fu) * (1 - fv)) + at(v0, u0 + 1) * (fu * (1 - fv))
         + at(v0 + 1, u0) * ((1 - fu) * fv) + at(v0 + 1, u0 + 1) * (fu * fv))
    return g * inview[..., None].to(g.dtype)


class FocalSparseConvBlock(nn.Module):
    """A focal sparse conv (focal_sparse_conv.py FocalSparseConv): the
    bias-free importance submanifold conv ``conv_imp`` (27 logits a voxel:
    26 offsets and the voxel's own), ``focal_split_and_spawn``, then the
    submanifold block ``conv_block`` (``.0`` conv, ``.1`` norm, ReLU) over the
    enlarged set.  With image features (``img_gather``) the importance conv
    reads them beside the voxel's, and the block's output adds the image
    features at the enlarged set (through the bias-free ``img_proj`` when
    the widths differ)."""

    def __init__(self, cin: int, cout: int, threshold: float = 0.5, spawn_cap: int = 1024,
                 img_channels: int = 0, mask_multi: bool = False):
        super().__init__()
        self.threshold, self.spawn_cap, self.mask_multi = threshold, spawn_cap, mask_multi
        self.conv_imp = SparseConv3d(cin + img_channels, 27)
        self.conv_block = SparseConvBlock(cin, cout)
        self.img_proj = (nn.Linear(img_channels, cout, bias=False)
                         if img_channels and img_channels != cout else None)

    def forward(self, x, coords, valid, grid, img_gather=None):
        imp_in = x if img_gather is None else torch.cat([img_gather(coords, valid), x], dim=-1)
        imps = self.conv_imp.subm(imp_in, valid, sp.batched_subm_rulebook(coords, valid, grid))
        x, coords, valid, own = sp.focal_split_and_spawn(x, coords, valid, imps, grid,
                                                         self.threshold, self.spawn_cap,
                                                         self.mask_multi)
        x = self.conv_block(x, valid, sp.batched_subm_rulebook(coords, valid, grid))
        if img_gather is not None:
            img = img_gather(coords, valid)
            if self.img_proj is not None:
                img = self.img_proj(img)
            x = x + img * valid[..., None].to(x.dtype)
        return x, coords, valid, own


@BACKBONES_3D.register
class VoxelBackBone8xFocal(VoxelBackBone8x):
    """VoxelBackBone8x with focal sparse convs (spconv_backbone_focal.py;
    the JAX package's ``VoxelBackBone8xFocal``): with ``USE_IMG`` and
    "images" in the batch, ``semseg`` (``SemSegEncoder``, IMG_CHANNELS) and
    the multimodal focal conv ``conv_focal_multimodal`` after conv1 at
    stride 1; for each stage s of FOCAL_STAGES a focal conv appended to
    ``conv{s+1}`` (threshold FOCAL_THRESHOLD, spawn cap SPAWN_CAP (default
    a quarter of the input slots, at least 64), divided by 2^s for s > 0,
    at least 64).  Each focal conv adds its cap to the stage's slots.  The
    stage caps default to [V, V/2, V/4, V/8].  Writes "focal_probs",
    "focal_coords", "focal_valid" and "focal_strides" (a list entry a focal
    conv: its voxels' own importance, their coords and validity, the
    stride) for ``focal_conv_loss``."""

    def __init__(self, model_cfg, input_channels: int, grid_size, voxel_size=None,
                 point_cloud_range=None):
        super().__init__(model_cfg, input_channels, grid_size, voxel_size, point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        ch = list(model_cfg.get("CHANNELS", self.default_channels))
        self.focal_stages = set(int(s) for s in model_cfg.get("FOCAL_STAGES", [0, 1]))
        self.threshold = float(model_cfg.get("FOCAL_THRESHOLD", 0.5))
        self.use_img = bool(model_cfg.get("USE_IMG", False))
        if self.use_img:
            cimg = int(model_cfg.get("IMG_CHANNELS", 16))
            self.semseg = SemSegEncoder(cimg)
            self.conv_focal_multimodal = FocalSparseConvBlock(ch[0], ch[0], self.threshold,
                                                              img_channels=cimg)
        for s in sorted(self.focal_stages):
            getattr(self, f"conv{s + 1}").append(FocalSparseConvBlock(ch[s], ch[s],
                                                                      self.threshold))

    def _image_gather(self, batch, img_feats):
        b = img_feats.shape[0]
        dev = img_feats.device
        zeros = torch.zeros((b,), device=dev)
        hw = batch.get("image_shape")
        if hw is None:
            hw = torch.tensor(batch["images"].shape[1:3], device=dev).expand(b, 2)
        pc_range = torch.tensor(self.point_cloud_range, device=dev)
        args = (self.voxel_size, pc_range, batch["trans_lidar_to_cam"],
                batch["trans_cam_to_img"], 4.0, hw, batch.get("noise_rot", zeros),
                batch.get("noise_scale", torch.ones((b,), device=dev)),
                batch.get("flip_x", zeros.bool()), batch.get("flip_y", zeros.bool()))
        return lambda c, v: voxel_image_features(img_feats, c, v, 1, *args)

    def forward(self, batch):
        x = batch["pillar_features"]
        coords = batch["voxel_coords"]
        valid = coords[..., 0] >= 0
        v = x.shape[1]
        caps = self.model_cfg.get("VOXEL_CAPS", [v, max(v // 2, 1), max(v // 4, 1),
                                                 max(v // 8, 1)])
        spawn = int(self.model_cfg.get("SPAWN_CAP", max(v // 4, 64)))
        grid = self.grid
        probs, pcoords, pvalid, strides, multi = [], [], [], [], {}

        def focal(block, x, coords, valid, cap, stride, img_gather=None):
            block.spawn_cap = cap
            x, coords, valid, own = block(x, coords, valid, grid, img_gather)
            probs.append(own)
            pcoords.append(coords[:, : own.shape[1]])
            pvalid.append(valid[:, : own.shape[1]])
            strides.append(stride)
            return x, coords, valid

        rb = sp.batched_subm_rulebook(coords, valid, grid)
        x = self.conv_input(x, valid, rb)
        for blk in self.conv1[:self.stage1_depth]:
            x = blk(x, valid, rb)
        if self.use_img and "images" in batch:
            img_feats = self.semseg(batch["images"])
            x, coords, valid = focal(self.conv_focal_multimodal, x, coords, valid, spawn, 1,
                                     self._image_gather(batch, img_feats))
        if 0 in self.focal_stages:
            x, coords, valid = focal(self.conv1[self.stage1_depth], x, coords, valid, spawn, 1)
        multi["x_conv1"] = (x, coords, valid, grid)
        for s in (1, 2, 3):
            stage = getattr(self, f"conv{s + 1}")
            x, coords, valid, grid = stage[0].strided(x, coords, valid, grid, int(caps[s]))
            rb = sp.batched_subm_rulebook(coords, valid, grid)
            for blk in stage[1:3]:
                x = blk(x, valid, rb)
            if s in self.focal_stages:
                x, coords, valid = focal(stage[3], x, coords, valid, max(spawn // 2 ** s, 64),
                                         2 ** s)
            multi[f"x_conv{s + 1}"] = (x, coords, valid, grid)
        x, coords, valid, grid = self.conv_out.strided(x, coords, valid, grid, int(caps[3]))
        batch["encoded_spconv_tensor"] = sp.batched_scatter_to_dense(x, coords, valid, grid)
        batch["encoded_spconv_tensor_stride"] = 8
        batch["multi_scale_3d_features"] = multi
        batch.update(focal_probs=probs, focal_coords=pcoords, focal_valid=pvalid,
                     focal_strides=strides)
        return batch


def focal_conv_loss(batch, voxel_size, point_cloud_range, gamma: float = 2.0):
    """The in-GT-box focal supervision of each focal conv's own importance
    (focal_sparse_conv.py:135-147 with FocalLoss): target 1 for a valid
    voxel whose centre lies in a GT box, the focal term over the valid
    voxels (whole batch's sum and count under a data mesh), summed over
    the focal convs."""
    gt = batch["gt_boxes"]
    gt_valid = (gt[..., -1] > 0)[:, None, :]
    vx, vy, vz = (float(s) for s in voxel_size)
    x0, y0, z0 = (float(s) for s in point_cloud_range[:3])
    total = 0.0
    for own, coords, valid, stride in zip(batch["focal_probs"], batch["focal_coords"],
                                          batch["focal_valid"], batch["focal_strides"]):
        cf = coords.to(torch.float32)
        centers = torch.stack([cf[..., 2] * vx * stride + x0, cf[..., 1] * vy * stride + y0,
                               cf[..., 0] * vz * stride + z0], dim=-1)
        tgt = ((points_in_rbbox(centers, gt[..., :7]) & gt_valid).any(dim=-1) & valid)
        p = torch.clamp(torch.where(tgt, own, 1 - own), 1e-7, 1 - 1e-7)
        per = -((1 - p) ** gamma) * torch.log(p)
        vm = valid.to(torch.float32)
        num, cnt = global_sum((per * vm).sum(), vm.sum())
        total = total + num / torch.clamp(cnt, min=1.0)
    return total
