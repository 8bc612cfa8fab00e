"""Anchor generation (the port's copy of
``com_tpu/models/dense_heads/anchor_generator.py``; pcdet
target_assigner/anchor_generator.py:1-79).

Dense per-class anchor grids: for each class config, anchors of every
(size, rotation) at every feature-map cell, centered at the configured z.
Numpy on the host, computed once a model (they are static for a grid).
"""
from __future__ import annotations

import numpy as np


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range, anchor_ndim=7):
    """Returns (list of (H, W, num_z, num_size, num_rot, 7) arrays, counts)."""
    all_anchors, num_anchors_per_location = [], []
    for cfg in anchor_generator_cfg:
        sizes = np.asarray(cfg["anchor_sizes"], np.float32)  # (S, 3)
        rotations = np.asarray(cfg["anchor_rotations"], np.float32)  # (R,)
        heights = np.asarray(cfg["anchor_bottom_heights"], np.float32)  # (Z,)
        align = cfg.get("align_center", False)
        stride = cfg.get("feature_map_stride", 1)

        nx = int(grid_size[0] // stride)
        ny = int(grid_size[1] // stride)
        if align:
            x_stride = (point_cloud_range[3] - point_cloud_range[0]) / nx
            y_stride = (point_cloud_range[4] - point_cloud_range[1]) / ny
            x_offset, y_offset = x_stride / 2, y_stride / 2
        else:
            x_stride = (point_cloud_range[3] - point_cloud_range[0]) / (nx - 1)
            y_stride = (point_cloud_range[4] - point_cloud_range[1]) / (ny - 1)
            x_offset, y_offset = 0.0, 0.0

        xs = np.arange(nx, dtype=np.float32) * x_stride + point_cloud_range[0] + x_offset
        ys = np.arange(ny, dtype=np.float32) * y_stride + point_cloud_range[1] + y_offset

        # (H, W, Z, S, R, 7): H indexes y, W indexes x
        gx, gy = np.meshgrid(xs, ys)
        s, r, z = len(sizes), len(rotations), len(heights)
        anchors = np.zeros((ny, nx, z, s, r, anchor_ndim), np.float32)
        anchors[..., 0] = gx[:, :, None, None, None]
        anchors[..., 1] = gy[:, :, None, None, None]
        anchors[..., 2] = heights[None, None, :, None, None]
        anchors[..., 3:6] = sizes[None, None, None, :, None, :]
        anchors[..., 2] += anchors[..., 5] / 2  # bottom height -> center z
        anchors[..., 6] = rotations[None, None, None, None, :]
        all_anchors.append(anchors)
        num_anchors_per_location.append(z * s * r)
    return all_anchors, num_anchors_per_location
