"""Box geometry (counterpart of ``com_tpu/ops/boxes.py``, the part the
serving path needs)."""
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
