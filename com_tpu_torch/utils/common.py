"""Host geometry helpers in numpy (the port's copy of
``rotate_points_along_z`` and ``limit_period`` from
``com_tpu/utils/common.py``)."""
from __future__ import annotations

import numpy as np


def rotate_points_along_z(points: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotate (B, N, 3+C) points by per-batch yaw angles."""
    cosa, sina = np.cos(angle), np.sin(angle)
    zeros, ones = np.zeros_like(angle), np.ones_like(angle)
    rot = np.stack(
        [cosa, sina, zeros, -sina, cosa, zeros, zeros, zeros, ones], axis=1
    ).reshape(-1, 3, 3)
    pts = points[..., :3] @ rot
    return np.concatenate([pts, points[..., 3:]], axis=-1)


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period
