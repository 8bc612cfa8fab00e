"""RoI point pooling (counterpart of ``com_tpu/ops/roiaware.py``'s
``points_in_roi_local`` and ``roipoint_pool3d``; pcdet's roipoint_pool3d
CUDA op): the member points of each RoI in its canonical frame.

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
    b, n = points.shape[:2]
    if n < k:  # keep the (R, K, C) contract
        pad = k - n
        points = F.pad(points, (0, 0, 0, pad))
        feats = F.pad(feats, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
        n = k
    r = rois.shape[1]
    want = torch.arange(1, k + 1, dtype=torch.int32, device=points.device)
    pos = torch.empty((b, r, k), dtype=torch.int64, device=points.device)
    for sl in row_blocks(r, b * n, block):
        _, inside = points_in_roi_local(points, rois[:, sl])
        inside &= valid[:, None, :]
        count = inside.cumsum(dim=-1, dtype=torch.int32)
        # the k-th member is where the running count first reaches k (N: none)
        pos[:, sl] = torch.searchsorted(count, want.expand(b, count.shape[1], k).contiguous())
    hit = pos < n
    first = torch.where(hit[..., :1], pos[..., :1], torch.zeros_like(pos[..., :1]))
    idx = torch.where(hit, pos, first)
    local = to_local(gather_rows(points.contiguous(), idx), rois)
    out = torch.cat([local, gather_rows(feats, idx)], dim=-1)
    return out * hit.to(out.dtype)[..., None], ~hit.any(dim=-1)
