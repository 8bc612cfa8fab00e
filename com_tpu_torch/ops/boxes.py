"""Box geometry and the box coders (counterpart of ``com_tpu/ops/boxes.py``,
the parts the ported paths need): the anchor coder ``ResidualCoder`` and
PointRCNN's per-point ``PointResidualCoder``."""
from __future__ import annotations

import math

import torch


def boxes_to_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) [x y z dx dy dz heading] -> (..., 4, 2) BEV corners (ccw)."""
    x, y = boxes[..., 0], boxes[..., 1]
    dx, dy = boxes[..., 3], boxes[..., 4]
    yaw = boxes[..., 6]
    tx = torch.stack([dx / 2, -dx / 2, -dx / 2, dx / 2], dim=-1)
    ty = torch.stack([dy / 2, dy / 2, -dy / 2, -dy / 2], dim=-1)
    cos, sin = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    cx = tx * cos - ty * sin + x[..., None]
    cy = tx * sin + ty * cos + y[..., None]
    return torch.stack([cx, cy], dim=-1)


def boxes_to_corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 8, 3) corners: the BEV corners at z - dz/2, then at
    z + dz/2."""
    bev = boxes_to_corners_bev(boxes)
    half = boxes[..., 5] / 2
    lo = torch.cat([bev, (boxes[..., 2] - half)[..., None, None].expand(*bev.shape[:-1], 1)], -1)
    hi = torch.cat([bev, (boxes[..., 2] + half)[..., None, None].expand(*bev.shape[:-1], 1)], -1)
    return torch.cat([lo, hi], dim=-2)


def points_in_rbbox(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(..., N, 3+) points x (..., M, 7) boxes -> (..., N, M) bool: the point
    inside the rotated box (edges included)."""
    px = points[..., :, None, 0] - boxes[..., None, :, 0]
    py = points[..., :, None, 1] - boxes[..., None, :, 1]
    cos = torch.cos(-boxes[..., 6])[..., None, :]
    sin = torch.sin(-boxes[..., 6])[..., None, :]
    lx = px * cos - py * sin
    ly = px * sin + py * cos
    pz = points[..., :, None, 2] - boxes[..., None, :, 2]
    return ((torch.abs(lx) <= boxes[..., None, :, 3] / 2)
            & (torch.abs(ly) <= boxes[..., None, :, 4] / 2)
            & (torch.abs(pz) <= boxes[..., None, :, 5] / 2))


def enlarge_box3d(boxes: torch.Tensor, extra_width=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """(..., 7+) boxes with dx, dy, dz grown by ``extra_width``
    (box_utils.enlarge_box3d)."""
    extra = torch.as_tensor(extra_width, dtype=boxes.dtype, device=boxes.device)
    return torch.cat([boxes[..., :3], boxes[..., 3:6] + extra, boxes[..., 6:]], dim=-1)


def corner_loss(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor) -> torch.Tensor:
    """Corner alignment loss (loss_utils.get_corner_loss_lidar): the mean
    distance of the 8 corners, the smaller of the GT's and of the GT turned
    half a turn, through a Huber of delta 1.  (..., 7) x (..., 7) -> (...)."""
    pc = boxes_to_corners_3d(pred_boxes)
    gc = boxes_to_corners_3d(gt_boxes)
    gcf = boxes_to_corners_3d(torch.cat([gt_boxes[..., :6], gt_boxes[..., 6:7] + math.pi], -1))
    d = torch.minimum(torch.sqrt(((pc - gc) ** 2).sum(-1) + 1e-8).mean(-1),
                      torch.sqrt(((pc - gcf) ** 2).sum(-1) + 1e-8).mean(-1))
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


class ResidualCoder:
    """SECOND's residual anchor box coder (counterpart of
    ``com_tpu/ops/boxes.py`` ``ResidualCoder``; pcdet box_coder_utils.py):
    centers relative to the anchor's BEV diagonal, sizes as log ratios, the
    heading as a difference or as (cos, sin) differences, and any extra
    columns (velocities of ``code_size`` 9) as differences."""

    def __init__(self, code_size: int = 7, encode_angle_by_sincos: bool = False):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        xa, ya, za, dxa, dya, dza, ra = (anchors[..., i] for i in range(7))
        xg, yg, zg, dxg, dyg, dzg, rg = (boxes[..., i] for i in range(7))
        dxa, dya, dza, dxg, dyg, dzg = (torch.clamp(t, min=1e-5)
                                        for t in (dxa, dya, dza, dxg, dyg, dzg))
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        parts = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza, torch.log(dxg / dxa),
                 torch.log(dyg / dya), torch.log(dzg / dza)]
        if self.encode_angle_by_sincos:
            parts += [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            parts.append(rg - ra)
        parts += [boxes[..., i] - anchors[..., i] for i in range(7, boxes.shape[-1])]
        return torch.stack(torch.broadcast_tensors(*parts), dim=-1)

    def decode(self, encodings: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
        xa, ya, za, dxa, dya, dza, ra = (anchors[..., i] for i in range(7))
        n_angle = 2 if self.encode_angle_by_sincos else 1
        xt, yt, zt, dxt, dyt, dzt = (encodings[..., i] for i in range(6))
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        parts = [xt * diag + xa, yt * diag + ya, zt * dza + za, torch.exp(dxt) * dxa,
                 torch.exp(dyt) * dya, torch.exp(dzt) * dza]
        if self.encode_angle_by_sincos:
            parts.append(torch.atan2(encodings[..., 7] + torch.sin(ra),
                                     encodings[..., 6] + torch.cos(ra)))
        else:
            parts.append(encodings[..., 6] + ra)
        n_extra = encodings.shape[-1] - 6 - n_angle
        parts += [encodings[..., 6 + n_angle + i] + anchors[..., 7 + i] for i in range(n_extra)]
        return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


MEAN_SIZE = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]  # the JAX coder's default


class PointResidualCoder:
    """PointRCNN's point-based box coder (box_coder_utils.PointResidualCoder):
    a box relative to a point, 8 wide: the center offset over the class's
    mean BEV diagonal (z over its mean height), the sizes as log ratios to
    the class's mean size, the heading as (cos, sin).  Without
    ``use_mean_size`` the offsets are plain and the sizes plain logs.
    Classes are 1-based."""

    def __init__(self, code_size: int = 8, use_mean_size: bool = True, mean_size=None):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        self.mean_size = torch.tensor(MEAN_SIZE if mean_size is None else mean_size,
                                      dtype=torch.float32)

    def _means(self, classes):
        m = self.mean_size.to(classes.device)[classes.long() - 1]
        return m[..., 0], m[..., 1], m[..., 2]

    def encode(self, boxes, points, gt_classes):
        xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
        dxg, dyg, dzg = (torch.clamp(boxes[..., i], min=1e-5) for i in (3, 4, 5))
        rg = boxes[..., 6]
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        if self.use_mean_size:
            dxa, dya, dza = self._means(gt_classes)
            diag = torch.sqrt(dxa ** 2 + dya ** 2)
            parts = [(xg - xa) / diag, (yg - ya) / diag, (zg - za) / dza,
                     torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)]
        else:
            parts = [xg - xa, yg - ya, zg - za, torch.log(dxg), torch.log(dyg), torch.log(dzg)]
        return torch.stack(parts + [torch.cos(rg), torch.sin(rg)], dim=-1)

    def decode(self, encodings, points, pred_classes):
        xt, yt, zt, dxt, dyt, dzt, cost, sint = (encodings[..., i] for i in range(8))
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        if self.use_mean_size:
            dxa, dya, dza = self._means(pred_classes)
            diag = torch.sqrt(dxa ** 2 + dya ** 2)
            parts = [xt * diag + xa, yt * diag + ya, zt * dza + za, torch.exp(dxt) * dxa,
                     torch.exp(dyt) * dya, torch.exp(dzt) * dza]
        else:
            parts = [xt + xa, yt + ya, zt + za, torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)]
        return torch.stack(parts + [torch.atan2(sint, cost)], dim=-1)
