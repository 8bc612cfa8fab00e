"""PointNet++ primitives with fixed shapes (counterpart of
``com_tpu/ops/pointnet2.py``; pcdet's pointnet2_batch / pointnet2_stack
CUDA ops: ball query, farthest point sampling, grouping, gathering, three
nearest neighbours and interpolation, vector pooling).

The JAX package writes each function for one scene and vmaps it; here the
batch axis is written out: points are (B, N, 3), queries (B, S, 3), masks
(B, N).  Indices are int64.  The semantics are the JAX package's, to the
index:

- distances are the broadcast-subtract form with the x, y and z terms
  added in that order (``dx*dx + dy*dy + dz*dz``), never the |a|^2 +
  |b|^2 - 2ab product, whose f32 cancellation flips borderline radius
  tests; the terms are separate element-wise ops, so the card and the
  CPU round alike;
- ``ball_query`` takes the first ``nsample`` in-radius points in index
  order, repeats the first hit into the empty slots, gives an empty ball
  all zeros and ``empty`` True, and marks the real hits in ``slot_valid``;
- FPS starts from the first valid point, takes the first index on ties
  and never picks an invalid point;
- the three nearest neighbours are the three smallest distances, ties to
  the lower index (``lax.top_k``'s order).

The JAX package sorts a dense (queries x points) key matrix to rank the
hits.  At full width that matrix does not fit (4 scenes x 4,096 keypoints
x 131,072 points), so ``ball_query`` works on blocks of query rows of at
most ``QUERY_BLOCK`` (rows x points) entries, and ranks the hits by their
running count: the k-th hit of a row is where the count of hits first
reaches k.  The result does not depend on the block size.

These are plain PyTorch on either device: the JAX package has no Pallas
kernel for them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BIG = 1e10
QUERY_BLOCK = 1 << 25  # (query rows x points) entries a block of ball_query


def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances."""
    dx = a[..., :, None, 0] - b[..., None, :, 0]
    dy = a[..., :, None, 1] - b[..., None, :, 1]
    dz = a[..., :, None, 2] - b[..., None, :, 2]
    return dx * dx + dy * dy + dz * dz


def row_blocks(rows: int, per_row: int, budget: int = QUERY_BLOCK):
    """Slices of ``rows`` rows, each holding at most ``budget`` entries of
    ``per_row`` (at least one row a block)."""
    step = max(1, budget // max(per_row, 1))
    return [slice(s, min(s + step, rows)) for s in range(0, rows, step)]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, N, C) at idx (B, ...) -> (B, ..., C).  An embedding lookup
    over the stacked scenes: its backward sorts the rows it adds into, so
    the gradient's sums are in a fixed order on the card."""
    b, n, c = table.shape
    offs = (torch.arange(b, device=idx.device) * n).view(b, *([1] * (idx.dim() - 1)))
    return F.embedding(idx + offs, table.reshape(b * n, c))


def farthest_point_sample(xyz: torch.Tensor, valid: torch.Tensor,
                          num_samples: int) -> torch.Tensor:
    """(B, N, 3), (B, N) -> (B, num_samples) indices of iterative FPS."""
    x, y, z = (xyz[..., i].contiguous() for i in range(3))
    big = torch.tensor(BIG, dtype=xyz.dtype, device=xyz.device)
    # the running distance to the chosen set; an invalid point stays at
    # -BIG (the JAX package also masks each new distance to -BIG: the
    # minimum with -BIG gives the same)
    dist = torch.where(valid, big, -big)
    cur = valid.to(torch.uint8).argmax(dim=-1)  # the first valid point
    rows = torch.arange(xyz.shape[0], device=xyz.device)
    chosen = [cur]
    for _ in range(1, num_samples):
        dx = x - x[rows, cur][:, None]
        dy = y - y[rows, cur][:, None]
        dz = z - z[rows, cur][:, None]
        dist = torch.minimum(dist, dx * dx + dy * dy + dz * dz)
        cur = dist.argmax(dim=-1)
        chosen.append(cur)
    return torch.stack(chosen, dim=-1)


def sector_fps(xyz: torch.Tensor, valid: torch.Tensor, num_sampled_points: int,
               num_sectors: int):
    """FPS in each of ``num_sectors`` azimuth sectors, an equal share each
    (the first sector takes the remainder too), the sectors' samples
    concatenated in sector order; a sample of an empty sector is invalid.
    Returns (idx (B, num), valid (B, num)).  The sectors run as one batch of
    FPS: its first n picks do not depend on how many follow."""
    b = xyz.shape[0]
    share = num_sampled_points // num_sectors
    rem = num_sampled_points - share * num_sectors
    angles = torch.atan2(xyz[..., 1], xyz[..., 0]) + math.pi
    sector = torch.clamp(torch.floor(angles / (2 * math.pi / num_sectors)), 0,
                         num_sectors - 1).to(torch.int64)
    masks = valid[:, None, :] & (sector[:, None, :] == torch.arange(
        num_sectors, device=xyz.device)[None, :, None])  # (B, sectors, N)
    idx = farthest_point_sample(xyz.repeat_interleave(num_sectors, dim=0),
                                masks.reshape(b * num_sectors, -1), share + rem)
    idx = idx.reshape(b, num_sectors, -1)
    ok = torch.gather(masks, 2, idx) & masks.any(dim=-1, keepdim=True)
    take = [share + (rem if k == 0 else 0) for k in range(num_sectors)]
    return (torch.cat([idx[:, k, :n] for k, n in enumerate(take)], dim=1),
            torch.cat([ok[:, k, :n] for k, n in enumerate(take)], dim=1))


def sample_points_with_roi(rois, roi_valid, xyz, valid, sample_radius_with_roi: float):
    """(B, N) mask of the valid points within (half the RoI's diagonal +
    the margin) of any valid RoI's centre."""
    h = rois[..., 3:6] / 2
    roi_r = torch.sqrt(h[..., 0] * h[..., 0] + h[..., 1] * h[..., 1] + h[..., 2] * h[..., 2])
    r2 = (roi_r + sample_radius_with_roi) ** 2
    out = torch.empty_like(valid)
    n = xyz.shape[1]
    for sl in row_blocks(n, xyz.shape[0] * rois.shape[1]):
        d2 = square_distance(xyz[:, sl], rois[..., :3])  # (B, rows, R)
        near = (d2 < r2[:, None, :]) & roi_valid[:, None, :]
        out[:, sl] = near.any(dim=-1) & valid[:, sl]
    return out


def ball_query(radius: float, nsample: int, xyz, new_xyz, valid=None,
               block: int = QUERY_BLOCK):
    """(B, S, nsample) indices of the first ``nsample`` points within
    ``radius`` of each query, in index order.  Returns (idx, empty (B, S),
    slot_valid (B, S, nsample)): the slots past the last hit repeat the
    first hit, an empty ball's are 0; ``slot_valid`` marks the real hits
    (the repeated slots would skew a mean or an interpolation)."""
    b, n = xyz.shape[:2]
    s = new_xyz.shape[1]
    r2 = radius * radius
    want = torch.arange(1, nsample + 1, dtype=torch.int32, device=xyz.device)
    pos = torch.empty((b, s, nsample), dtype=torch.int64, device=xyz.device)
    for sl in row_blocks(s, b * n, block):
        hit = square_distance(new_xyz[:, sl], xyz) < r2  # (B, rows, N)
        if valid is not None:
            hit &= valid[:, None, :]
        count = hit.cumsum(dim=-1, dtype=torch.int32)
        # the k-th hit is where the running count first reaches k (N: none)
        pos[:, sl] = torch.searchsorted(count, want.expand(*hit.shape[:2], nsample).contiguous())
    slot_valid = pos < n
    empty = ~slot_valid[..., 0]
    idx = torch.where(slot_valid, pos, pos[..., :1])
    idx = torch.where(empty[..., None], torch.zeros_like(idx), idx)
    return idx, empty, slot_valid


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) gathered by (B, S, K) -> (B, S, K, C)."""
    return gather_rows(features, idx)


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) gathered by (B, S) -> (B, S, C)."""
    return gather_rows(features, idx)


def smallest3(d2: torch.Tensor):
    """The three smallest entries of the last axis and their indices, in
    ascending order, ties to the lower index (``argmin`` takes the first)."""
    d2 = d2.clone()
    vals, idxs = [], []
    for _ in range(3):
        i = d2.argmin(dim=-1, keepdim=True)
        vals.append(torch.gather(d2, -1, i))
        idxs.append(i)
        d2.scatter_(-1, i, math.inf)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def three_nn(unknown: torch.Tensor, known: torch.Tensor, known_valid=None):
    """The 3 nearest valid known points of each unknown point: (dist (B, N,
    3), idx (B, N, 3))."""
    d2 = square_distance(unknown, known)
    if known_valid is not None:
        d2 = torch.where(known_valid[:, None, :], d2, torch.full_like(d2, BIG))
    d, idx = smallest3(d2)
    return torch.sqrt(torch.clamp(d, min=0.0)), idx


def _interpolate(f, w):
    """(..., 3, C) features, (..., 3) weights -> (..., C), summed in order."""
    return f[..., 0, :] * w[..., 0:1] + f[..., 1, :] * w[..., 1:2] + f[..., 2, :] * w[..., 2:3]


def _normalised(w):
    return w / (w[..., 0:1] + w[..., 1:2] + w[..., 2:3])


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, dist: torch.Tensor):
    """Inverse-squared-distance weighted interpolation: features (B, M, C),
    idx (B, N, 3), dist (B, N, 3) -> (B, N, C)."""
    w = _normalised(1.0 / torch.clamp(dist * dist, min=1e-8))
    return _interpolate(gather_rows(features, idx), w)


def query_and_group(radius: float, nsample: int, xyz, new_xyz, features, valid=None,
                    use_xyz: bool = True, block: int = QUERY_BLOCK):
    """Ball query, then each neighbour's offset from its query and, with
    ``features``, its features after it (``use_xyz``) or alone.  Returns
    (grouped (B, S, nsample, 3 + C) with empty groups zeroed, idx, empty,
    slot_valid)."""
    idx, empty, slot_valid = ball_query(radius, nsample, xyz, new_xyz, valid, block=block)
    out = gather_rows(xyz, idx) - new_xyz[..., None, :]
    if features is not None:
        grouped = gather_rows(features, idx)
        out = torch.cat([out, grouped], dim=-1) if use_xyz else grouped
    return out * (~empty).to(out.dtype)[..., None, None], idx, empty, slot_valid


def vector_pool_features(xyz, feats, valid, new_xyz, num_local_voxel, max_neighbor_distance,
                         nsample: int, aggregation: str = "local_interpolation",
                         block: int = QUERY_BLOCK):
    """PV-RCNN++'s vector pool: each query's (2d)^3 cube split into nx x ny x
    nz sub-voxels, each given the mean of its real neighbours
    ("voxel_avg_pool", relative xyz and features) or the 3-NN
    inverse-distance interpolation of the neighbours' features at its
    centre ("local_interpolation", the centre's relative xyz first).
    Returns ((B, S, V3 * (3 + C)) zeroed for empty queries, empty (B, S)).
    Works on blocks of query rows (the neighbours' interpolation stacks are
    (rows, V3, 3, C))."""
    nxv, nyv, nzv = (int(v) for v in num_local_voxel)
    v3 = nxv * nyv * nzv
    b, s = new_xyz.shape[:2]
    c = feats.shape[-1]
    idx, empty, hit = ball_query(float(max_neighbor_distance), nsample, xyz, new_xyz, valid,
                                 block=block)
    outs = [_vector_pool_rows(xyz, feats, new_xyz[:, sl], idx[:, sl], empty[:, sl],
                              hit[:, sl], (nxv, nyv, nzv), float(max_neighbor_distance),
                              aggregation)
            for sl in row_blocks(s, b * v3 * max(nsample, 3 * (c + 3)), block)]
    return torch.cat(outs, dim=1), empty


def _vector_pool_rows(xyz, feats, new_xyz, idx, empty, hit, nv, d, aggregation):
    nxv, nyv, nzv = nv
    v3 = nxv * nyv * nzv
    b, s, k = idx.shape
    dt, dev = xyz.dtype, xyz.device
    rel = gather_rows(xyz, idx) - new_xyz[..., None, :]  # (B, S, K, 3)

    def centers_1d(n):
        return (torch.arange(n, dtype=dt, device=dev) + 0.5) / n * (2 * d) - d

    grid = torch.stack(torch.meshgrid(centers_1d(nxv), centers_1d(nyv), centers_1d(nzv),
                                      indexing="ij"), dim=-1).reshape(v3, 3)
    if aggregation == "voxel_avg_pool":
        nf = gather_rows(feats, idx)
        cell = torch.floor((rel + d) / (2 * d) * torch.tensor([nxv, nyv, nzv], dtype=dt,
                                                              device=dev))
        cell = torch.minimum(torch.clamp(cell, min=0), torch.tensor(
            [nxv - 1, nyv - 1, nzv - 1], dtype=dt, device=dev)).to(torch.int64)
        flat = (cell[..., 0] * nyv + cell[..., 1]) * nzv + cell[..., 2]
        flat = torch.where(hit, flat, torch.full_like(flat, v3))
        member = (flat[..., None] == torch.arange(v3, device=dev)).to(dt)  # (B, S, K, V3)
        payload = torch.cat([rel, nf], dim=-1)
        ssum = torch.einsum("bskv,bskc->bsvc", member, payload)
        cnt = member.sum(dim=2)[..., None]
        pooled = ssum / torch.clamp(cnt, min=1.0)
    else:
        dx = grid[:, None, 0] - rel[..., None, :, 0]  # (B, S, V3, K)
        dy = grid[:, None, 1] - rel[..., None, :, 1]
        dz = grid[:, None, 2] - rel[..., None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        d2 = torch.where(hit[:, :, None, :], d2, torch.full_like(d2, BIG))
        nn_d2, nn_k = smallest3(d2)  # (B, S, V3, 3)
        w = _normalised(1.0 / torch.clamp(nn_d2, min=1e-8))
        nn_rows = torch.gather(idx, 2, nn_k.reshape(b, s, v3 * 3))  # the neighbours' points
        nn_feat = gather_rows(feats, nn_rows).reshape(b, s, v3, 3, -1)
        interp = _interpolate(nn_feat, w)
        interp = interp * hit.any(dim=-1).to(interp.dtype)[..., None, None]
        pooled = torch.cat([grid.expand(b, s, v3, 3), interp], dim=-1)
    pooled = pooled * (~empty).to(pooled.dtype)[..., None, None]
    return pooled.reshape(b, s, -1)
