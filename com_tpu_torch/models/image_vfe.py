"""CaDDN's camera VFE (counterpart of ``com_tpu/models/image_vfe.py``;
pcdet image_vfe.py with DepthFFN and FrustumToVoxel).

A depth-distribution network over the image (``DDN``: the JAX package's
compact dilated encoder in place of pcdet's DeepLabV3, the same interface)
gives features and D + 1 depth logits at 1/``DOWNSAMPLE_FACTOR`` of the
image; the frustum volume is the depth softmax (the beyond-range bin
dropped) times the features; each voxel centre of the grid goes through the
batch's calibration into the frustum's (depth bin, row, column) and is
sampled trilinearly with zero padding (``trilinear_sample``, explicit
gathers), a voxel off the true image extent or at a non-finite coordinate
reading the sentinel -2, so zero.  The volume is (B, Z, Y, X, C) for
``Conv2DCollapse``.  The DDN's convs (strided stem, dilated trunk, 1x1
heads) are library convs, as they are XLA convs in the JAX package.

Parameter names: ``vfe.ffn.ddn.{stem0,stem1}.{0,1}``, ``vfe.ffn.ddn.aspp.{i}
.{0,1}``, ``vfe.ffn.ddn.depth_logits``, ``vfe.ffn.channel_reduce.{conv,bn}``
(pcdet's DepthFFN names its 1x1 reduction so; the JAX DDN's ``feat_out``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sharding import global_sum
from ..utils.registry import VFES
from .layers import BatchNorm, ConvBNReLU

SAMPLE_CHUNK = 1 << 20  # voxels a trilinear gather takes at once (read at call time)


def bin_depths(depth_map, mode, depth_min, depth_max, num_bins, target=False):
    """Depth -> continuous bin index (transform_utils.bin_depths): UD
    uniform, LID linearly increasing, SID log; ``target`` floors it and puts
    an out-of-range or non-finite depth in the extra class ``num_bins``."""
    if mode == "UD":
        indices = (depth_map - depth_min) / ((depth_max - depth_min) / num_bins)
    elif mode == "LID":
        bin_size = 2 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        indices = -0.5 + 0.5 * torch.sqrt(
            torch.clamp(1 + 8 * (depth_map - depth_min) / bin_size, min=0.0))
    elif mode == "SID":
        indices = num_bins * (torch.log(1 + torch.clamp(depth_map, min=1e-6))
                              - math.log(1 + depth_min)) / (math.log(1 + depth_max)
                                                            - math.log(1 + depth_min))
    else:
        raise NotImplementedError(mode)
    if target:
        bad = (indices < 0) | (indices > num_bins) | ~torch.isfinite(indices)
        indices = torch.where(bad, torch.full_like(indices, float(num_bins)), indices)
        return torch.floor(indices).to(torch.int64)
    return indices


def project_to_image(points, proj):
    """(..., 3) camera points, (3, 4) or batched (B, 3, 4) projection ->
    ((..., 2) pixel coordinates, (...,) depth)."""
    hom = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    img = hom @ proj.transpose(-1, -2)
    depth = img[..., 2]
    return img[..., :2] / torch.clamp(depth[..., None], min=1e-6), depth


def trilinear_sample(volume, coords):
    """volume (D, H, W, C); coords (N, 3) (d, y, x) index-space floats ->
    (N, C): the eight corners read by explicit gathers, zero outside
    (``image_vfe.py`` ``trilinear_sample``, its summation order)."""
    d, h, w, c = volume.shape
    flat = volume.reshape(d * h * w, c)
    base = torch.floor(coords)
    frac = coords - base
    out = 0.0
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                zi, yi, xi = base[:, 0] + dz, base[:, 1] + dy, base[:, 2] + dx
                inside = (zi >= 0) & (zi < d) & (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                row = ((torch.clamp(zi, 0, d - 1).to(torch.int64) * h
                        + torch.clamp(yi, 0, h - 1).to(torch.int64)) * w
                       + torch.clamp(xi, 0, w - 1).to(torch.int64))
                wgt = ((frac[:, 0] if dz else 1 - frac[:, 0])
                       * (frac[:, 1] if dy else 1 - frac[:, 1])
                       * (frac[:, 2] if dx else 1 - frac[:, 2]))
                # index_select: its backward is one index_add (the indexing
                # operator's backward sorts its indices first)
                out = out + flat.index_select(0, row) * (wgt * inside)[:, None]
    return out


class DilatedConvBN(nn.Sequential):
    """A bias-free 3x3 conv of dilation ``rate`` (padding ``rate``, flax's
    "SAME") ``0``, norm ``1`` (eps 1e-3), ReLU; NHWC."""

    def __init__(self, cin: int, cout: int, rate: int):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=rate, dilation=rate, bias=False),
                         BatchNorm(cout, eps=1e-3))

    def forward(self, x):
        y = self[0](x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return torch.relu(self[1](y))


class BasicBlock2D(nn.Module):
    """pcdet's BasicBlock2D at kernel 1 without bias: ``conv``, ``bn`` (eps
    1e-3), ReLU, over NHWC."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.bn = BatchNorm(cout, eps=1e-3)

    def forward(self, x):
        y = F.linear(x, self.conv.weight.reshape(self.conv.weight.shape[:2]))
        return torch.relu(self.bn(y))


class DDN(nn.Module):
    """The compact depth-distribution network (ddn_deeplabv3's role): a
    stride-2 stem (two with ``downsample`` >= 4), three dilated 3x3 convs
    (rates 1, 2, 4) and the biased 1x1 ``depth_logits`` (D + 1); ``trunk``
    is what both heads read."""

    def __init__(self, num_bins: int, feat_channels: int = 64, downsample: int = 4):
        super().__init__()
        c = feat_channels
        self.stem0 = ConvBNReLU(3, c // 2, 3, stride=2)
        self.stem1 = ConvBNReLU(c // 2, c, 3, stride=2) if downsample >= 4 else None
        cin = c if self.stem1 is not None else c // 2
        self.aspp = nn.ModuleList(DilatedConvBN(cin if i == 0 else c, c, rate)
                                  for i, rate in enumerate((1, 2, 4)))
        self.depth_logits = nn.Conv2d(c, num_bins + 1, 1)

    def trunk(self, images):
        x = self.stem0(images)
        if self.stem1 is not None:
            x = self.stem1(x)
        for layer in self.aspp:
            x = layer(x)
        return x

    def logits(self, x):
        w = self.depth_logits.weight
        return F.linear(x, w.reshape(w.shape[:2]), self.depth_logits.bias)


class DepthFFN(nn.Module):
    def __init__(self, num_bins: int, channels: int, downsample: int):
        super().__init__()
        self.ddn = DDN(num_bins, channels, downsample)
        self.channel_reduce = BasicBlock2D(channels, channels)

    def forward(self, images):
        x = self.ddn.trunk(images)
        return self.channel_reduce(x), self.ddn.logits(x)


@VFES.register
class ImageVFE(nn.Module):
    """Camera -> voxel features.  Reads "images" (B, H, W, 3),
    "trans_lidar_to_cam" (B, 4, 4), "trans_cam_to_img" (B, 3, 4) and, if
    there, "image_shape" (B, 2) (the images' true extents before the
    collate's padding); writes "depth_logits" (B, H/ds, W/ds, D + 1) and
    "encoded_spconv_tensor" (B, Z, Y, X, C), stride 1.  The trilinear
    sampling runs ``SAMPLE_CHUNK`` voxels at a time."""

    def __init__(self, model_cfg, num_point_features=0, voxel_size=(0.16, 0.16, 0.16),
                 point_cloud_range=(2, -30.08, -3.0, 46.8, 30.08, 1.0), grid_size=(280, 376, 25)):
        super().__init__()
        self.model_cfg = model_cfg
        disc = model_cfg["FFN"]["DISCRETIZE"]
        self.disc = (str(disc["mode"]), float(disc["depth_min"]), float(disc["depth_max"]),
                     int(disc["num_bins"]))
        self.channels = int(model_cfg["FFN"].get("CHANNEL_REDUCE", {}).get("out_channels", 64))
        self.ds = int(model_cfg.get("DOWNSAMPLE_FACTOR", 4))
        self.ffn = DepthFFN(self.disc[3], self.channels, self.ds)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.grid_size = tuple(int(g) for g in grid_size)
        self.num_point_features = self.channels
        self.volume_channels = self.grid_size[2] * self.channels  # Z * C, Conv2DCollapse's input

    def grid_points(self, device):
        """(X, Y, Z, 3) lidar centres of the voxel grid (meshgrid "ij")."""
        axes = [(torch.arange(n, device=device, dtype=torch.float32) + 0.5) * v + o
                for n, v, o in zip(self.grid_size, self.voxel_size, self.point_cloud_range[:3])]
        return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)

    def frustum_coords(self, l2c, c2i, ishape):
        """(X*Y*Z, 3) (bin, row, column) of one scene's voxel centres in its
        frustum, -2 off the image or where not finite."""
        grid = self.grid_points(l2c.device).reshape(-1, 3)
        cam = torch.cat([grid, torch.ones_like(grid[:, :1])], dim=-1) @ l2c.t()
        uv, depth = project_to_image(cam[:, :3], c2i)
        mode, dmin, dmax, bins = self.disc
        dbin = bin_depths(depth, mode, dmin, dmax, bins)
        coords = torch.stack([dbin, uv[:, 1] / self.ds, uv[:, 0] / self.ds], dim=-1)
        coords = torch.where(torch.isfinite(coords), coords, torch.full_like(coords, -2.0))
        ishape = ishape.to(uv.dtype)
        in_img = (uv[:, 0] >= 0) & (uv[:, 0] < ishape[1]) & (uv[:, 1] >= 0) & (uv[:, 1] < ishape[0])
        return torch.where(in_img[:, None], coords, torch.full_like(coords, -2.0))

    def forward(self, batch):
        images = batch["images"]
        feats, logits = self.ffn(images)
        batch["depth_logits"] = logits
        bins = self.disc[3]
        probs = torch.softmax(logits, dim=-1)[..., :bins]
        frustum = probs[..., :, None] * feats[..., None, :]  # (B, h, w, D, C)
        b = images.shape[0]
        ishape = batch.get("image_shape")
        if ishape is None:
            ishape = torch.tensor(images.shape[1:3], device=images.device).expand(b, 2)
        nx, ny, nz = self.grid_size
        out = []
        for i in range(b):
            vol = frustum[i].permute(2, 0, 1, 3)  # (D, h, w, C)
            coords = self.frustum_coords(batch["trans_lidar_to_cam"][i],
                                         batch["trans_cam_to_img"][i], ishape[i])
            vox = torch.cat([trilinear_sample(vol, coords[s:s + SAMPLE_CHUNK])
                             for s in range(0, coords.shape[0], SAMPLE_CHUNK)])
            out.append(vox.reshape(nx, ny, nz, -1).permute(2, 1, 0, 3))  # (Z, Y, X, C)
        batch["encoded_spconv_tensor"] = torch.stack(out)
        batch["encoded_spconv_tensor_stride"] = 1
        return batch


def ddn_loss(batch, model_cfg):
    """The depth-distribution focal loss with foreground / background
    balancing (ddn_loss.py, balancer.py): the target bin of each
    ``DOWNSAMPLE_FACTOR``-th pixel's depth, focal (alpha, gamma) on the
    log-softmax, weighted ``fg_weight`` inside any 2D GT box (x2 > x1) and
    ``bg_weight`` elsewhere, summed over the pixels of the whole batch
    (under a data mesh too) and times ``weight``."""
    args = model_cfg["FFN"]["LOSS"]["ARGS"]
    disc = model_cfg["FFN"]["DISCRETIZE"]
    ds = int(model_cfg.get("DOWNSAMPLE_FACTOR", 4))
    num_bins = int(disc["num_bins"])
    alpha, gamma = float(args.get("alpha", 0.25)), float(args.get("gamma", 2.0))
    fg_w, bg_w = float(args.get("fg_weight", 13)), float(args.get("bg_weight", 1))
    weight = float(args.get("weight", 3.0))
    logits = batch["depth_logits"]
    b, h, w, _ = logits.shape
    dm = batch["depth_maps"][:, : h * ds: ds, : w * ds: ds]
    target = bin_depths(dm, disc["mode"], float(disc["depth_min"]), float(disc["depth_max"]),
                        num_bins, target=True)
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    focal = -alpha * (1 - p) ** gamma * logp
    per_px = torch.gather(focal, -1, target[..., None])[..., 0]
    fg = torch.zeros((b, h, w), dtype=torch.bool, device=logits.device)
    if "gt_boxes2d" in batch:
        boxes = batch["gt_boxes2d"] / ds  # (B, N, 4) u1 v1 u2 v2
        uu = torch.arange(w, device=logits.device)[None, None, :, None]
        vv = torch.arange(h, device=logits.device)[None, :, None, None]
        valid = (boxes[..., 2] > boxes[..., 0])[:, None, None, :]
        fg = ((uu >= boxes[:, None, None, :, 0]) & (uu <= boxes[:, None, None, :, 2])
              & (vv >= boxes[:, None, None, :, 1]) & (vv <= boxes[:, None, None, :, 3])
              & valid).any(dim=-1)
    bal = torch.where(fg, torch.full_like(per_px, fg_w), torch.full_like(per_px, bg_w))
    total, num_px = global_sum((per_px * bal).sum(), float(h * w * b))
    return total / num_px * weight
