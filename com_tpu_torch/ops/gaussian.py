"""Gaussian heatmap targets and COM mask stamping, batched, fixed shapes.

Counterpart of ``com_tpu/ops/gaussian.py`` (pcdet centernet_utils.py:46-131
``gaussian_radius``, ``draw_gaussian_to_heatmap``, ``draw_mask_to_heatmap``).
Every object stamps a (2r+1)^2 window with r <= ``MAX_STAMP_RADIUS``.  The
batched entry points go through ``ops.stamp.stamp_windows`` (kernel K3 on a
CUDA tensor); ``draw_gaussians`` and ``stamp_squares_last_wins`` are the
plain versions, a table gather and a scatter-max as in the JAX package.
Canvases are (B, C, H, W) f32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# Gaussian radii are integers >= MIN_RADIUS and are clipped to this; at the
# Waymo pillar size (0.32 m) vehicle radii are 4-6 cells.
MAX_STAMP_RADIUS = 16


def gaussian_radius(height, width, min_overlap=0.5):
    """CornerNet gaussian radius from box height/width in feature-map cells
    (centernet_utils.py:46-72), including CornerNet's quirk of dividing
    cases 2 and 3 by 2 rather than 2a."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 4 * a2 * c2, min=0.0))) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


@functools.lru_cache(maxsize=4)
def _gaussian_table(max_radius: int) -> np.ndarray:
    """(R+1, K, K) f32 table, K = 2R+1: table[r, dy+R, dx+R] =
    exp(-(dx^2+dy^2) / (2 sigma^2)), sigma = (2r+1)/6, zero outside the
    (2r+1)^2 window; built in f64 (centernet_utils.py:76-82)."""
    R = max_radius
    coords = np.arange(-R, R + 1, dtype=np.float64)
    dy, dx = coords[:, None], coords[None, :]
    table = np.zeros((R + 1, 2 * R + 1, 2 * R + 1), dtype=np.float32)
    for r in range(R + 1):
        sigma = (2 * r + 1) / 6.0
        g = np.exp(-(dx * dx + dy * dy) / (2 * sigma * sigma))
        outside = (np.abs(dy) > r) | (np.abs(dx) > r)
        table[r] = np.where(outside, 0.0, g).astype(np.float32)
    return table


def _window_indices(centers_int, class_ids, num_classes, fmap_h, fmap_w, max_radius):
    """(B, N, K, K) int64 indices into a per-sample flat (C*H*W + 1) canvas;
    cells outside the map go to the trailing trash slot."""
    R = max_radius
    offs = torch.arange(-R, R + 1, dtype=torch.int64, device=centers_int.device)
    ys = centers_int[..., 1].long()[..., None, None] + offs[:, None]
    xs = centers_int[..., 0].long()[..., None, None] + offs[None, :]
    inb = (ys >= 0) & (ys < fmap_h) & (xs >= 0) & (xs < fmap_w)
    flat = class_ids.long()[..., None, None] * (fmap_h * fmap_w) + ys * fmap_w + xs
    return torch.where(inb, flat, torch.full_like(flat, num_classes * fmap_h * fmap_w))


def _scatter_max(idx, vals, size, fill):
    """(B, size) canvas at ``fill``, then a scatter-max of vals at idx per
    sample; the trash slot (the last) is dropped."""
    b = idx.shape[0]
    canvas = torch.full((b, size + 1), fill, dtype=vals.dtype, device=vals.device)
    canvas.scatter_reduce_(1, idx.reshape(b, -1), vals.reshape(b, -1), "amax", include_self=True)
    return canvas[:, :-1]


def draw_gaussians(centers_int, radii, class_ids, valid, num_classes, fmap_h, fmap_w,
                   max_radius=MAX_STAMP_RADIUS, fill=0.0):
    """Plain version of gauss stamping: (B, C, H, W) = max over objects of
    table gaussians (over ``fill``), batched over the leading axis.  Only
    the (2r+1)^2 window of each object is stamped, as in ``_stamp_pallas``
    (the table's zeros around it would lift a negative fill)."""
    table = torch.from_numpy(_gaussian_table(max_radius)).to(centers_int.device)
    r = torch.clamp(radii.long(), 0, max_radius)
    vals = table[r]
    size = num_classes * fmap_h * fmap_w
    idx = _window_indices(centers_int, class_ids, num_classes, fmap_h, fmap_w, max_radius)
    offs = torch.arange(-max_radius, max_radius + 1, device=radii.device).abs()
    inside = ((offs[:, None] <= r[..., None, None]) & (offs[None, :] <= r[..., None, None])
              & valid[..., None, None])
    idx = torch.where(inside, idx, torch.full_like(idx, size))
    canvas = _scatter_max(idx, vals, size, fill)
    return canvas.reshape(-1, num_classes, fmap_h, fmap_w)


def stamp_squares_last_wins(centers_int, radii, class_ids, values, valid, num_classes, fmap_h,
                            fmap_w, fill=1.0, max_radius=MAX_STAMP_RADIUS):
    """Plain version of last-wins stamping (draw_mask_to_heatmap semantics,
    centernet_utils.py:109-131): each valid object overwrites its whole
    square with its value, the highest object index winning on overlap; a
    scatter-max of (index + 1) finds the winner per cell, then a gather."""
    b, n = radii.shape
    R = max_radius
    r = torch.clamp(radii.long(), 0, R)
    offs = torch.arange(-R, R + 1, device=radii.device).abs()
    in_patch = ((offs[:, None] <= r[..., None, None]) & (offs[None, :] <= r[..., None, None])
                & valid[..., None, None])
    size = num_classes * fmap_h * fmap_w
    idx = _window_indices(centers_int, class_ids, num_classes, fmap_h, fmap_w, R)
    idx = torch.where(in_patch, idx, torch.full_like(idx, size))
    rank = torch.arange(1, n + 1, dtype=torch.int64, device=radii.device)
    rank = rank[None, :, None, None].expand(b, n, 2 * R + 1, 2 * R + 1)
    winner = _scatter_max(idx, rank, size, 0)
    padded = torch.cat([torch.ones((b, 1), dtype=torch.float32, device=values.device),
                        values.float()], dim=1)
    out = torch.where(winner > 0, torch.gather(padded, 1, winner),
                      torch.full((), fill, dtype=torch.float32, device=values.device))
    return out.reshape(b, num_classes, fmap_h, fmap_w)


def draw_gaussians_batched(centers_int, radii, class_ids, valid, num_classes, fmap_h, fmap_w,
                           max_radius=MAX_STAMP_RADIUS):
    """(B, num_classes, H, W) heatmap targets: the max over objects of their
    gaussians, 0 elsewhere (K3 in gauss mode)."""
    from .stamp import stamp_windows

    return stamp_windows(centers_int, radii, class_ids, None, valid, num_classes, fmap_h, fmap_w,
                         "gauss", fill=0.0, max_radius=max_radius)


def stamp_squares_batched(centers_int, radii, class_ids, values, valid, num_classes, fmap_h,
                          fmap_w, fill=1.0, max_radius=MAX_STAMP_RADIUS):
    """(B, num_classes, H, W): per-object constant squares over ``fill``, the
    highest object index winning on overlap (K3 in last_wins mode)."""
    from .stamp import stamp_windows

    return stamp_windows(centers_int, radii, class_ids, values, valid, num_classes, fmap_h,
                         fmap_w, "last_wins", fill=fill, max_radius=max_radius)
