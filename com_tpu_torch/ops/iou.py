"""Rotated and axis-aligned BEV IoU in plain PyTorch (counterpart of
``com_tpu/ops/iou.py``; XLA there, library ops here).

The branch-free formulation of the JAX package, with leading batch
dimensions: 24 candidate vertices per box pair (16 edge crossings, 4 corners
of A inside B, 4 of B inside A), a stable angular sort around their masked
centroid, and a masked shoelace area.  Inputs (..., N, 7) and (..., M, 7)
give (..., N, M).
"""
from __future__ import annotations

import math

import torch

from .boxes import boxes_to_corners_bev


def _inside(pts, c1, c2):
    """pts (..., P, 2) against the convex polygon with edges c1 -> c2
    (..., E, 2): inside iff every signed edge distance has one sign, with a
    metric tolerance of 0.1 mm."""
    d = c2 - c1
    elen = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)[..., None, :]
    rel = pts[..., :, None, :] - c1[..., None, :, :]
    crs = d[..., None, :, 0] * rel[..., 1] - d[..., None, :, 1] * rel[..., 0]
    dist = crs / torch.clamp(elen, min=1e-6)
    tol = 1e-4
    return (dist >= -tol).all(dim=-1) | (dist <= tol).all(dim=-1)


def _pairwise_intersection_area(ca, cb):
    """(..., N, 4, 2) x (..., M, 4, 2) -> (..., N, M) convex intersection areas."""
    n, m = ca.shape[-3], cb.shape[-3]
    lead = torch.broadcast_shapes(ca.shape[:-3], cb.shape[:-3])
    a1 = ca.unsqueeze(-3)  # (..., N, 1, 4, 2)
    a2 = torch.roll(ca, -1, dims=-2).unsqueeze(-3)
    b1 = cb.unsqueeze(-4)  # (..., 1, M, 4, 2)
    b2 = torch.roll(cb, -1, dims=-2).unsqueeze(-4)
    # (..., N, M, 4, 4, 2): a-edge index on axis -3, b-edge index on axis -2
    p = a1.unsqueeze(-2)
    r = (a2 - a1).unsqueeze(-2)
    q = b1.unsqueeze(-3)
    s = (b2 - b1).unsqueeze(-3)
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qmp = q - p
    t_num = qmp[..., 0] * s[..., 1] - qmp[..., 1] * s[..., 0]
    u_num = qmp[..., 0] * r[..., 1] - qmp[..., 1] * r[..., 0]
    small = torch.abs(rxs) < 1e-10
    denom = torch.where(small, torch.full_like(rxs, 1e-10), rxs)
    t = t_num / denom
    u = u_num / denom
    cross_ok = (torch.abs(rxs) > 1e-10) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    cross_pt = (p + t[..., None] * r).reshape(*lead, n, m, 16, 2)
    cross_ok = cross_ok.reshape(*lead, n, m, 16)

    shape = (*lead, n, m, 4, 2)
    a_pts, b_pts = a1.expand(shape), b1.expand(shape)
    a_in_b = _inside(a_pts, b1.expand(shape), b2.expand(shape))
    b_in_a = _inside(b_pts, a1.expand(shape), a2.expand(shape))

    pts = torch.cat([cross_pt, a_pts, b_pts], dim=-2)  # (..., N, M, 24, 2)
    ok = torch.cat([cross_ok, a_in_b, b_in_a], dim=-1)  # (..., N, M, 24)

    cnt = ok.sum(dim=-1)
    okf = ok[..., None].to(pts.dtype)
    centroid = (pts * okf).sum(dim=-2) / torch.clamp(cnt, min=1)[..., None].to(pts.dtype)
    ang = torch.atan2(pts[..., 1] - centroid[..., None, 1], pts[..., 0] - centroid[..., None, 0])
    ang = torch.where(ok, ang, torch.full_like(ang, 1e4))  # invalid points sort last
    order = torch.argsort(ang, dim=-1, stable=True)
    sorted_pts = torch.take_along_dim(pts, order[..., None], dim=-2)
    sorted_ok = torch.take_along_dim(ok, order, dim=-1)

    # masked shoelace over the first cnt vertices, closing back to vertex 0
    idx = torch.arange(pts.shape[-2], device=pts.device)
    nxt = torch.where(idx + 1 < cnt[..., None], idx + 1, torch.zeros_like(idx))
    nxt_pts = torch.take_along_dim(sorted_pts, nxt[..., None], dim=-2)
    crossz = sorted_pts[..., 0] * nxt_pts[..., 1] - sorted_pts[..., 1] * nxt_pts[..., 0]
    crossz = torch.where(sorted_ok, crossz, torch.zeros_like(crossz))
    area = 0.5 * torch.abs(crossz.sum(dim=-1))
    return torch.where(cnt >= 3, area, torch.zeros_like(area))


def _clamped_inter(boxes_a, boxes_b):
    """Intersections clamped to min(area_a, area_b): also neutralizes the
    zero-size (padded) box that passes every half-plane test."""
    inter = _pairwise_intersection_area(boxes_to_corners_bev(boxes_a[..., :7]),
                                        boxes_to_corners_bev(boxes_b[..., :7]))
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return torch.minimum(inter, torch.minimum(area_a, area_b)), area_a, area_b


def boxes_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU (..., N, 7) x (..., M, 7) -> (..., N, M)."""
    inter, area_a, area_b = _clamped_inter(boxes_a, boxes_b)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def boxes_overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Rotated BEV intersection areas (..., N, 7) x (..., M, 7) -> (..., N, M)."""
    return _clamped_inter(boxes_a, boxes_b)[0]


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Rotated 3D IoU (..., N, 7) x (..., M, 7) -> (..., N, M): the BEV
    intersection times the z overlap, over the union of the volumes."""
    inter_bev = boxes_overlap_bev(boxes_a, boxes_b)
    za1 = (boxes_a[..., 2] - boxes_a[..., 5] / 2)[..., :, None]
    za2 = (boxes_a[..., 2] + boxes_a[..., 5] / 2)[..., :, None]
    zb1 = (boxes_b[..., 2] - boxes_b[..., 5] / 2)[..., None, :]
    zb2 = (boxes_b[..., 2] + boxes_b[..., 5] / 2)[..., None, :]
    z_overlap = torch.clamp(torch.minimum(za2, zb2) - torch.maximum(za1, zb1), min=0.0)
    inter = inter_bev * z_overlap
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return inter / torch.clamp(vol_a + vol_b - inter, min=1e-6)


def _nearest_aligned_dims(boxes):
    """(dx, dy), swapped where the heading is nearer to +-90 degrees."""
    rot = boxes[..., 6] - torch.floor(boxes[..., 6] / math.pi + 0.5) * math.pi
    swap = torch.abs(rot) >= (math.pi / 4)
    return torch.where(swap[..., None], boxes[..., [4, 3]], boxes[..., [3, 4]])


def boxes_iou_aligned_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Nearest-axis-aligned BEV IoU (..., N, 7) x (..., M, 7) -> (..., N, M)."""
    half_a = _nearest_aligned_dims(boxes_a) / 2
    half_b = _nearest_aligned_dims(boxes_b) / 2
    a_min, a_max = boxes_a[..., 0:2] - half_a, boxes_a[..., 0:2] + half_a
    b_min, b_max = boxes_b[..., 0:2] - half_b, boxes_b[..., 0:2] + half_b
    lt = torch.maximum(a_min[..., :, None, :], b_min[..., None, :, :])
    rb = torch.minimum(a_max[..., :, None, :], b_max[..., None, :, :])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)
