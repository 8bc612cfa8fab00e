"""RoI point pooling (counterpart of ``com_tpu/ops/roiaware.py``;
pcdet's roipoint_pool3d and roiaware_pool3d CUDA ops): the member points
of each RoI in its canonical frame (``roipoint_pool3d``, PointRCNN), or
pooled into a grid of its box (``roiaware_pool3d``, PartA2).

The JAX package takes a RoI's members with ``lax.top_k`` over a 0/1 key,
which puts the members first in index order (ties to the lower index);
``torch.topk`` promises no order among ties.  Here the members are ranked
by their running count, as ``pointnet2.ball_query`` ranks its hits: the
k-th member is where the count first reaches k.  The (B, R, N) membership
is built in blocks of RoIs of at most ``QUERY_BLOCK`` (RoIs x points)
entries.  Plain PyTorch on either device: the JAX package has no Pallas
kernel for it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .pointnet2 import QUERY_BLOCK, gather_rows, row_blocks


def to_local(points: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
    """(B, R, K, 3) points of each RoI, (B, R, 7) RoIs -> (B, R, K, 3) in
    the RoI's frame: shifted to its centre, turned by minus its heading."""
    shifted = points - rois[:, :, None, 0:3]
    c = torch.cos(-rois[..., 6])[..., None]
    s = torch.sin(-rois[..., 6])[..., None]
    lx = shifted[..., 0] * c - shifted[..., 1] * s
    ly = shifted[..., 0] * s + shifted[..., 1] * c
    return torch.stack([lx, ly, shifted[..., 2]], dim=-1)


def points_in_roi_local(points: torch.Tensor, rois: torch.Tensor):
    """(B, N, 3) points, (B, R, 7) RoIs -> (local (B, R, N, 3), inside (B, R,
    N)): the canonical-frame coordinates and membership, edges included."""
    local = to_local(points[:, None, :, :3].expand(-1, rois.shape[1], -1, -1), rois)
    return local, (torch.abs(local) <= rois[:, :, None, 3:6] / 2).all(dim=-1)


def first_members(points, valid, rois, k: int, block: int = QUERY_BLOCK):
    """(B, R, k) indices of the first ``k`` points of each RoI in index
    order, N where a RoI has fewer: the k-th member is where the running
    count of ``valid`` members first reaches k, found in blocks of RoIs."""
    b, n = points.shape[:2]
    r = rois.shape[1]
    want = torch.arange(1, k + 1, dtype=torch.int32, device=points.device)
    pos = torch.empty((b, r, k), dtype=torch.int64, device=points.device)
    for sl in row_blocks(r, b * n, block):
        _, inside = points_in_roi_local(points, rois[:, sl])
        inside &= valid[:, None, :]
        count = inside.cumsum(dim=-1, dtype=torch.int32)
        pos[:, sl] = torch.searchsorted(count, want.expand(b, count.shape[1], k).contiguous())
    return pos


def roipoint_pool3d(points, feats, valid, rois, num_sampled_points: int = 512,
                    block: int = QUERY_BLOCK):
    """Per RoI, the first ``num_sampled_points`` valid member points in index
    order as [local xyz | feats], the slots past the last member zero (the
    JAX package's padding; pcdet repeats the sampled points instead), and
    whether the RoI has no member.  points (B, N, 3), feats (B, N, C), valid
    (B, N), rois (B, R, 7) -> (pooled (B, R, K, 3 + C), empty (B, R)).
    Fewer than K points are zero-padded to K first, as the JAX op does.  A
    missed slot gathers the first member (row 0 for an empty RoI) before
    it is zeroed, as JAX's ``top_k`` fill."""
    k = int(num_sampled_points)
    n = points.shape[1]
    if n < k:  # keep the (R, K, C) contract
        pad = k - n
        points = F.pad(points, (0, 0, 0, pad))
        feats = F.pad(feats, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
        n = k
    pos = first_members(points, valid, rois, k, block)
    hit = pos < n
    first = torch.where(hit[..., :1], pos[..., :1], torch.zeros_like(pos[..., :1]))
    idx = torch.where(hit, pos, first)
    local = to_local(gather_rows(points.contiguous(), idx), rois)
    out = torch.cat([local, gather_rows(feats, idx)], dim=-1)
    return out * hit.to(out.dtype)[..., None], ~hit.any(dim=-1)


def roiaware_pool3d(points, feats, valid, rois, out_size: int = 12, max_pts: int = 128,
                    method: str = "max", block: int = QUERY_BLOCK):
    """RoI-aware pooling (pcdet's roiaware_pool3d; the JAX package's
    ``roiaware_pool3d``): each RoI's first ``max_pts`` valid member points
    in index order (none for a RoI with a size <= 0), binned into an
    out_size^3 grid of its canonical box (x, y, z cell order, clamped to
    the grid), reduced a cell by ``max`` (a cell of negative members stays
    negative) or ``avg`` (the sum over the cell's members).  Empty cells
    are 0.  points (B, N, 3), feats (B, N, C), valid (B, N), rois (B, R, 7)
    -> (B, R, S, S, S, C)."""
    s = int(out_size)
    s3 = s ** 3
    b, n, c = feats.shape
    r = rois.shape[1]
    k = min(int(max_pts), n)
    sized = (rois[..., 3:6] > 0).all(dim=-1)  # (B, R)
    pos = first_members(points, valid, rois, k, block)
    hit = (pos < n) & sized[..., None]
    idx = torch.where(hit, pos, torch.zeros_like(pos))
    local = to_local(gather_rows(points[..., :3].contiguous(), idx), rois)  # (B, R, K, 3)
    pf = gather_rows(feats, idx) * hit[..., None].to(feats.dtype)
    dims = rois[:, :, None, 3:6]
    cell = torch.floor((local + dims / 2) / torch.clamp(dims, min=1e-6) * s).to(torch.int64)
    cell = torch.clamp(cell, 0, s - 1)
    flat = (cell[..., 0] * s + cell[..., 1]) * s + cell[..., 2]
    roi_base = torch.arange(b * r, device=feats.device).view(b, r, 1) * (s3 + 1)
    seg = (roi_base + torch.where(hit, flat, s3)).reshape(-1)  # slot s3 of a RoI: no member
    src = pf.reshape(-1, c)
    if method == "max":
        pooled = feats.new_full((b * r * (s3 + 1), c), -math.inf).scatter_reduce(
            0, seg[:, None].expand(-1, c), src, "amax", include_self=True)
        pooled = torch.where(torch.isfinite(pooled), pooled, torch.zeros_like(pooled))
    elif method == "avg":
        pooled = feats.new_zeros((b * r * (s3 + 1), c)).index_add(0, seg, src)
        cnt = feats.new_zeros((b * r * (s3 + 1),)).index_add(
            0, seg, hit.reshape(-1).to(feats.dtype))
        pooled = pooled / torch.clamp(cnt, min=1.0)[:, None]
    else:
        raise ValueError(f"roiaware_pool3d: method {method!r} is neither 'max' nor 'avg'")
    return pooled.view(b, r, s3 + 1, c)[:, :, :s3].reshape(b, r, s, s, s, c)
