"""Voxelization (counterpart of ``com_tpu/ops/voxelize.py``): the host
grid size and hard voxelizer in numpy, and the device's point -> pillar ids.

``voxelize_points`` is the numpy oracle of the native voxelizer
(``ops.host_native.voxelize_native``), which the data processor runs.
"""
from __future__ import annotations

import numpy as np
import torch


def grid_size_from_range(pc_range, voxel_size) -> np.ndarray:
    pc_range = np.asarray(pc_range, dtype=np.float64)
    voxel_size = np.asarray(voxel_size, dtype=np.float64)
    grid = (pc_range[3:6] - pc_range[0:3]) / voxel_size
    return np.round(grid).astype(np.int64)  # (nx, ny, nz)


def voxelize_points(points: np.ndarray, pc_range, voxel_size, max_points_per_voxel: int,
                    max_voxels: int):
    """Hard voxelization in numpy: voxels in the order their first point
    arrives, at most ``max_points_per_voxel`` points each (the first ones),
    at most ``max_voxels`` voxels; cells ``floor((p - min) / size)`` in f32.

    Returns voxels (V, T, F) f32 zero-padded, coords (V, 3) int32 in zyx
    order, num_points (V,) int32, trimmed to the V voxels found.
    """
    pc_range = np.asarray(pc_range, dtype=np.float32)
    voxel_size = np.asarray(voxel_size, dtype=np.float32)
    nx, ny, nz = (int(g) for g in grid_size_from_range(pc_range, voxel_size))

    coords_f = (points[:, :3] - pc_range[:3]) / voxel_size
    # floor, not int-cast: truncation would map below-range points (cell
    # coords in (-1, 0)) onto edge cells instead of rejecting them
    vx = np.floor(coords_f[:, 0]).astype(np.int64)
    vy = np.floor(coords_f[:, 1]).astype(np.int64)
    vz = np.floor(coords_f[:, 2]).astype(np.int64)
    in_range = (vx >= 0) & (vx < nx) & (vy >= 0) & (vy < ny) & (vz >= 0) & (vz < nz)
    pts = points[in_range]
    flat = (vz[in_range] * ny + vy[in_range]) * nx + vx[in_range]

    # first-occurrence unique keeps the arrival order of voxels
    uniq, first_idx, inv = np.unique(flat, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank_of_uniq = np.empty_like(order)
    rank_of_uniq[order] = np.arange(len(order))
    voxel_id = rank_of_uniq[inv]  # per-point voxel slot in arrival order

    num_voxels = min(len(uniq), max_voxels)
    keep_pt = voxel_id < num_voxels

    # per-point slot within its voxel (arrival order), capped at T
    sort_by_voxel = np.argsort(voxel_id, kind="stable")
    sorted_vid = voxel_id[sort_by_voxel]
    counts = np.bincount(sorted_vid, minlength=len(uniq))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_sorted = np.arange(len(sorted_vid)) - starts[sorted_vid]
    slot = np.empty_like(slot_sorted)
    slot[sort_by_voxel] = slot_sorted

    sel = keep_pt & (slot < max_points_per_voxel)
    voxels = np.zeros((num_voxels, max_points_per_voxel, points.shape[1]), np.float32)
    voxels[voxel_id[sel], slot[sel]] = pts[sel]
    num_points = np.minimum(counts[:num_voxels], max_points_per_voxel).astype(np.int32)
    uniq_in_order = uniq[order][:num_voxels]
    czyx = np.stack([uniq_in_order // (nx * ny), (uniq_in_order // nx) % ny,
                     uniq_in_order % nx], axis=1).astype(np.int32)
    return voxels, czyx, num_points


def point_voxel_ids(points_xyz: torch.Tensor, pc_range, voxel_size, grid_size):
    """Per-point flat BEV pillar id.

    Computed in the points' dtype (f32) exactly as the JAX package does,
    ``floor((p - min) / size)`` on all three axes: the host presort uses the
    same formula, and any other rounding would put borderline points in
    another pillar than the one they were sorted into.

    Args:
        points_xyz: (..., 3).
        grid_size: (nx, ny, nz) ints.
    Returns:
        flat_id: (...,) int32 = iy * nx + ix, or nx * ny out of range.
        in_range: (...,) bool.
    """
    nx, ny, nz = int(grid_size[0]), int(grid_size[1]), int(grid_size[2])
    lo = torch.as_tensor(list(pc_range)[:3], dtype=points_xyz.dtype, device=points_xyz.device)
    size = torch.as_tensor(list(voxel_size), dtype=points_xyz.dtype, device=points_xyz.device)
    vi = torch.floor((points_xyz - lo) / size).to(torch.int32)
    in_range = ((vi[..., 0] >= 0) & (vi[..., 0] < nx) & (vi[..., 1] >= 0) & (vi[..., 1] < ny)
                & (vi[..., 2] >= 0) & (vi[..., 2] < nz))
    flat = vi[..., 1] * nx + vi[..., 0]
    return torch.where(in_range, flat, torch.full_like(flat, nx * ny)), in_range
