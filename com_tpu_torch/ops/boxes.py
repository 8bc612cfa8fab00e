"""Box geometry and the anchor box coder (counterpart of
``com_tpu/ops/boxes.py``, the parts the ported paths need)."""
from __future__ import annotations

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
