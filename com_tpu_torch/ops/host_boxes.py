"""Box geometry of the host input pipeline, in numpy (the port's copy of the
numpy side of ``com_tpu/ops/boxes.py`` and of ``boxes_iou_bev`` in
``com_tpu/ops/iou.py``).

Corner extraction, point-in-rotated-box tests, box enlarging, the range
filter for boxes, the point carve-out of GT-paste and the rotated BEV IoU.
``remove_points_in_boxes3d`` runs on the native library
(``ops.host_native``); ``points_in_rbbox`` and ``boxes_iou_bev`` here are the
numpy versions the tests hold that library against.  The port's
``ops/boxes.py`` and ``ops/iou.py`` are the torch code of the device paths.
"""
from __future__ import annotations

import numpy as np


def boxes_to_corners_bev(boxes):
    """(N, 7) [x y z dx dy dz heading] -> (N, 4, 2) BEV corners (ccw)."""
    x, y = boxes[..., 0], boxes[..., 1]
    dx, dy = boxes[..., 3], boxes[..., 4]
    yaw = boxes[..., 6]
    tx = np.stack([dx / 2, -dx / 2, -dx / 2, dx / 2], axis=-1)
    ty = np.stack([dy / 2, dy / 2, -dy / 2, -dy / 2], axis=-1)
    cos, sin = np.cos(yaw)[..., None], np.sin(yaw)[..., None]
    cx = tx * cos - ty * sin + x[..., None]
    cy = tx * sin + ty * cos + y[..., None]
    return np.stack([cx, cy], axis=-1)


def boxes_to_corners_3d(boxes):
    """(N, 7) -> (N, 8, 3) corners; z from center-z +/- dz/2."""
    bev = boxes_to_corners_bev(boxes)  # (N, 4, 2)
    z = boxes[..., 2]
    dz = boxes[..., 5]
    z_lo = (z - dz / 2)[..., None]
    z_hi = (z + dz / 2)[..., None]
    lo = np.concatenate([bev, np.broadcast_to(z_lo[..., None], bev.shape[:-1] + (1,))], axis=-1)
    hi = np.concatenate([bev, np.broadcast_to(z_hi[..., None], bev.shape[:-1] + (1,))], axis=-1)
    return np.concatenate([lo, hi], axis=-2)


def points_in_rbbox(points, boxes):
    """(N, 3+) points x (M, 7) boxes -> (N, M) bool containment mask, by a
    rotation into each box's frame."""
    px = points[:, 0][:, None] - boxes[None, :, 0]
    py = points[:, 1][:, None] - boxes[None, :, 1]
    cos = np.cos(-boxes[:, 6])[None, :]
    sin = np.sin(-boxes[:, 6])[None, :]
    lx = px * cos - py * sin
    ly = px * sin + py * cos
    in_xy = (np.abs(lx) <= boxes[None, :, 3] / 2) & (np.abs(ly) <= boxes[None, :, 4] / 2)
    pz = points[:, 2][:, None] - boxes[None, :, 2]
    return in_xy & (np.abs(pz) <= boxes[None, :, 5] / 2)


def enlarge_box3d(boxes, extra_width=(0.0, 0.0, 0.0)):
    """Grow dx/dy/dz by extra widths (box_utils.enlarge_box3d parity)."""
    return np.concatenate(
        [boxes[:, :3], boxes[:, 3:6] + np.asarray(extra_width, dtype=boxes.dtype)[None, :],
         boxes[:, 6:]], axis=1)


def remove_points_in_boxes3d(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """The points outside every box (box_utils.remove_points_in_boxes3d), by
    the native ``points_in_rbbox``."""
    from .host_native import points_in_rbbox_native

    if len(boxes) == 0 or len(points) == 0:
        return points
    return points[~points_in_rbbox_native(points, boxes[:, :7]).any(axis=1)]


def mask_boxes_outside_range(boxes, limit_range, min_num_corners=1):
    """Keep boxes with >= min_num_corners BEV corners inside the range."""
    corners = boxes_to_corners_bev(boxes[:, :7])  # (N, 4, 2)
    lo = np.asarray(limit_range[:2])
    hi = np.asarray(limit_range[3:5])
    inside = ((corners >= lo) & (corners <= hi)).all(axis=-1)  # (N, 4)
    return inside.sum(axis=-1) >= min_num_corners


def _pairwise_intersection_area(corners_a, corners_b):
    """(N,4,2) x (M,4,2) -> (N,M) convex intersection areas: the 16
    edge-pair crossings and the corners of each box inside the other (24
    masked candidates), sorted by angle around their centroid, shoelace."""
    n, m = corners_a.shape[0], corners_b.shape[0]
    a1 = corners_a[:, None]  # (N,1,4,2)
    a2 = np.roll(corners_a, -1, axis=1)[:, None]
    b1 = corners_b[None, :]  # (1,M,4,2)
    b2 = np.roll(corners_b, -1, axis=1)[None, :]
    # broadcast to (N,M,4,4,2): a-edge index axis=2, b-edge index axis=3
    p = a1[:, :, :, None, :]
    r = (a2 - a1)[:, :, :, None, :]
    q = b1[:, :, None, :, :]
    s = (b2 - b1)[:, :, None, :, :]
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]  # (N,M,4,4)
    qmp = q - p
    t_num = qmp[..., 0] * s[..., 1] - qmp[..., 1] * s[..., 0]
    u_num = qmp[..., 0] * r[..., 1] - qmp[..., 1] * r[..., 0]
    denom = np.where(np.abs(rxs) < 1e-10, 1e-10, rxs)
    t = t_num / denom
    u = u_num / denom
    cross_ok = (np.abs(rxs) > 1e-10) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    cross_pt = (p + t[..., None] * r).reshape(n, m, 16, 2)
    cross_ok = cross_ok.reshape(n, m, 16)

    def _inside(pts, poly_c1, poly_c2):
        # a point is inside a convex polygon iff its signed distances to all
        # edge lines share a sign; a metric tolerance (0.1 mm) keeps a box's
        # own corners inside under f32 rounding
        d = poly_c2 - poly_c1  # (N,M,4,2)
        elen = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)[:, :, None, :]
        rel = pts[:, :, :, None, :] - poly_c1[:, :, None, :, :]  # (N,M,P,E,2)
        crs = d[:, :, None, :, 0] * rel[..., 1] - d[:, :, None, :, 1] * rel[..., 0]
        dist = crs / np.clip(elen, 1e-6, None)
        tol = 1e-4
        return (dist >= -tol).all(axis=-1) | (dist <= tol).all(axis=-1)

    a_pts = np.broadcast_to(a1, (n, m, 4, 2))
    b_pts = np.broadcast_to(b1, (n, m, 4, 2))
    a_in_b = _inside(a_pts, np.broadcast_to(b1, (n, m, 4, 2)), np.broadcast_to(b2, (n, m, 4, 2)))
    b_in_a = _inside(b_pts, np.broadcast_to(a1, (n, m, 4, 2)), np.broadcast_to(a2, (n, m, 4, 2)))

    pts = np.concatenate([cross_pt, a_pts, b_pts], axis=2)  # (N,M,24,2)
    ok = np.concatenate([cross_ok, a_in_b, b_in_a], axis=2)  # (N,M,24)

    cnt = ok.sum(axis=-1)  # (N,M)
    okf = ok[..., None].astype(pts.dtype)
    centroid = (pts * okf).sum(axis=2) / np.clip(cnt, 1, None)[..., None]
    ang = np.arctan2(pts[..., 1] - centroid[..., None, 1], pts[..., 0] - centroid[..., None, 0])
    ang = np.where(ok, ang, 1e4)  # invalid points sort last
    order = np.argsort(ang, axis=-1)
    sorted_pts = np.take_along_axis(pts, order[..., None], axis=2)
    sorted_ok = np.take_along_axis(ok, order, axis=2)

    # masked shoelace: the successor of the last valid vertex is vertex 0
    idx = np.arange(sorted_pts.shape[2])
    nxt = np.where((idx[None, None, :] + 1) < cnt[..., None], idx[None, None, :] + 1, 0)
    nxt_pts = np.take_along_axis(sorted_pts, nxt[..., None], axis=2)
    crossz = sorted_pts[..., 0] * nxt_pts[..., 1] - sorted_pts[..., 1] * nxt_pts[..., 0]
    crossz = np.where(sorted_ok, crossz, 0.0)
    area = 0.5 * np.abs(crossz.sum(axis=-1))
    return np.where(cnt >= 3, area, 0.0)


def boxes_iou_bev(boxes_a, boxes_b):
    """Rotated BEV IoU (N,7) x (M,7) -> (N,M), the intersection clamped to
    the smaller box's area (a zero-size box passes every half-plane test)."""
    inter = _pairwise_intersection_area(boxes_to_corners_bev(boxes_a[:, :7]),
                                        boxes_to_corners_bev(boxes_b[:, :7]))
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    inter = np.minimum(inter, np.minimum(area_a, area_b))
    return inter / np.clip(area_a + area_b - inter, 1e-6, None)
