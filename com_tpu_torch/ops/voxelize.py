"""Point -> pillar ids (counterpart of ``com_tpu/ops/voxelize.py``:
``point_voxel_ids`` only)."""
from __future__ import annotations

import torch


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
