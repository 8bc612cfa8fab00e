"""World augmentations of the host pipeline, in numpy (the port's copy of the
global transforms of ``com_tpu/data/augmentor/transforms.py``; role of
pcdet/datasets/augmentor/augmentor_utils.py).

Flip along x or y, rotation, scaling and translation of the whole scene;
the per-object (local) rotation, scaling and translation; frustum dropout
of each object or of the scene, per-object sparsify; and SE-SSD's face
pyramid dropout, sparsify and swap (the pyramid chain threaded through the
three).  Each takes and returns (gt_boxes, points[, pyramids]), may edit
them in place, and draws from the caller's numpy RNG stream in the
reference's order, so runs are deterministic per seed.
"""
from __future__ import annotations

import math

import numpy as np

from ...utils.common import rotate_points_along_z


def random_flip_along_x(gt_boxes, points, rng=np.random, return_param=False):
    # choice() (not random()) so the consumed RNG stream matches the
    # reference bit-for-bit under SEED_PARITY (augmentor_utils.py:16)
    enable = bool(rng.choice([False, True], replace=False, p=[0.5, 0.5]))
    if enable:
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    if return_param:
        return gt_boxes, points, enable
    return gt_boxes, points


def random_flip_along_y(gt_boxes, points, rng=np.random, return_param=False):
    enable = bool(rng.choice([False, True], replace=False, p=[0.5, 0.5]))
    if enable:
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    if return_param:
        return gt_boxes, points, enable
    return gt_boxes, points


def global_rotation(gt_boxes, points, rot_range, rng=np.random, return_param=False):
    angle = rng.uniform(rot_range[0], rot_range[1])
    points[:, :3] = rotate_points_along_z(points[None, :, :3], np.array([angle]))[0]
    gt_boxes[:, :3] = rotate_points_along_z(gt_boxes[None, :, :3], np.array([angle]))[0]
    gt_boxes[:, 6] += angle
    if gt_boxes.shape[1] > 7:
        vel = np.concatenate(
            [gt_boxes[:, 7:9], np.zeros((len(gt_boxes), 1), gt_boxes.dtype)], axis=1
        )
        gt_boxes[:, 7:9] = rotate_points_along_z(vel[None], np.array([angle]))[0][:, :2]
    if return_param:
        return gt_boxes, points, angle
    return gt_boxes, points


def global_scaling(gt_boxes, points, scale_range, rng=np.random, return_param=False):
    if scale_range[1] - scale_range[0] < 1e-3:
        return (gt_boxes, points, 1.0) if return_param else (gt_boxes, points)
    scale = rng.uniform(scale_range[0], scale_range[1])
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    if gt_boxes.shape[1] > 7:
        gt_boxes[:, 7:9] *= scale
    if return_param:
        return gt_boxes, points, scale
    return gt_boxes, points


def global_translation(gt_boxes, points, noise_std, rng=np.random):
    noise = rng.normal(0, noise_std, 3)
    points[:, :3] += noise
    gt_boxes[:, :3] += noise
    return gt_boxes, points


def _points_in_box_margin(points, box, margin=0.1):
    """The reference's get_points_in_box (augmentor_utils.py:449-466):
    membership in the box's own axes with a 0.1 m xy margin and inclusive
    z; the local augmentations depend on this boundary."""
    shift = points[:, :3] - box[:3]
    cosa, sina = math.cos(-box[6]), math.sin(-box[6])
    lx = shift[:, 0] * cosa - shift[:, 1] * sina
    ly = shift[:, 0] * sina + shift[:, 1] * cosa
    return ((np.abs(shift[:, 2]) <= box[5] / 2.0)
            & (np.abs(lx) <= box[3] / 2.0 + margin)
            & (np.abs(ly) <= box[4] / 2.0 + margin))


def random_local_rotation(gt_boxes, points, rot_range, rng=np.random):
    """Rotate each object (its box + points) around its own center."""
    for i in range(len(gt_boxes)):
        angle = rng.uniform(rot_range[0], rot_range[1])
        mask = _points_in_box_margin(points, gt_boxes[i])
        ctr = gt_boxes[i, :3].copy()
        pts = points[mask]
        pts[:, :3] -= ctr
        pts[:, :3] = rotate_points_along_z(pts[None, :, :3], np.array([angle]))[0]
        pts[:, :3] += ctr
        points[mask] = pts
        gt_boxes[i, 6] += angle
    return gt_boxes, points


def random_local_scaling(gt_boxes, points, scale_range, rng=np.random):
    # a degenerate range draws nothing (local_scaling's early return), so
    # the shared RNG stream stays in step with the reference
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    for i in range(len(gt_boxes)):
        scale = rng.uniform(scale_range[0], scale_range[1])
        mask = _points_in_box_margin(points, gt_boxes[i])
        ctr = gt_boxes[i, :3].copy()
        points[mask, :3] = (points[mask, :3] - ctr) * scale + ctr
        gt_boxes[i, 3:6] *= scale
    return gt_boxes, points


def random_local_frustum_dropout(gt_boxes, points, intensity_range, direction,
                                 rng=np.random):
    """Drop points in a random frustum slice of each box
    (augmentor_utils local_frustum_dropout_* role)."""
    for i in range(len(gt_boxes)):
        x, y, z, dx, dy, dz = gt_boxes[i, :6]
        intensity = rng.uniform(intensity_range[0], intensity_range[1])
        if direction == "top":
            thresh = z + dz / 2 - intensity * dz
            keep = ~(
                _points_in_box_margin(points, gt_boxes[i])
                & (points[:, 2] >= thresh)
            )
        elif direction == "bottom":
            thresh = z - dz / 2 + intensity * dz
            keep = ~(
                _points_in_box_margin(points, gt_boxes[i])
                & (points[:, 2] <= thresh)
            )
        elif direction == "left":
            thresh = y + dy / 2 - intensity * dy
            keep = ~(
                _points_in_box_margin(points, gt_boxes[i])
                & (points[:, 1] >= thresh)
            )
        else:  # right
            thresh = y - dy / 2 + intensity * dy
            keep = ~(
                _points_in_box_margin(points, gt_boxes[i])
                & (points[:, 1] <= thresh)
            )
        points = points[keep]
    return gt_boxes, points


def random_world_frustum_dropout(gt_boxes, points, intensity_range,
                                 directions, rng=np.random):
    """Scene-level frustum dropout (augmentor_utils.py:219-286
    global_frustum_dropout_{top,bottom,left,right}): slice off a random
    fraction of the scene's z or y extent, dropping points AND boxes."""
    for d in directions:
        intensity = rng.uniform(intensity_range[0], intensity_range[1])
        axis = 2 if d in ("top", "bottom") else 1
        lo, hi = points[:, axis].min(), points[:, axis].max()
        if d in ("top", "left"):
            thr = hi - intensity * (hi - lo)
            keep_p = points[:, axis] < thr
            keep_b = gt_boxes[:, axis] < thr
        else:
            thr = lo + intensity * (hi - lo)
            keep_p = points[:, axis] > thr
            keep_b = gt_boxes[:, axis] > thr
        points = points[keep_p]
        gt_boxes = gt_boxes[keep_b]
    return gt_boxes, points


def random_local_sparsify(gt_boxes, points, drop_prob, rng=np.random):
    """Randomly drop a fraction of each object's points
    (local pyramid sparsify role)."""
    for i in range(len(gt_boxes)):
        inside = _points_in_box_margin(points, gt_boxes[i])
        idx = np.where(inside)[0]
        if len(idx) == 0:
            continue
        drop = idx[rng.rand(len(idx)) < drop_prob]
        keep = np.ones(len(points), bool)
        keep[drop] = False
        points = points[keep]
    return gt_boxes, points


def random_local_translation(gt_boxes, points, offset_range, axes, rng=np.random):
    """AXIS-major like the reference (random_local_translation_along_x over
    every box, then along_y): the RNG draws and the box-membership masks
    are both per (axis, box), keeping the seed-parity stream bit-exact."""
    for ax in axes:
        j = {"x": 0, "y": 1, "z": 2}[ax]
        for i in range(len(gt_boxes)):
            d = rng.uniform(offset_range[0], offset_range[1])
            mask = _points_in_box_margin(points, gt_boxes[i])
            points[mask, j] += d
            gt_boxes[i, j] += d
    return gt_boxes, points


def _pyramid_ratios(points, pyr):
    """Barycentric-ish coordinates of points in a face pyramid
    (local_pyramid_swap get_points_ratio): alphas/betas span the base,
    gamma runs base->apex; all in [0, 1] inside the pyramid."""
    apex, c0, c1, c2, c3 = pyr
    base_center = (c0 + c1 + c2 + c3) / 4.0
    v0 = c1 - c0
    v1 = c3 - c0
    v2 = apex - base_center
    a = ((points[:, :3] - c0) @ v0) / max((v0**2).sum(), 1e-9)
    b = ((points[:, :3] - c0) @ v1) / max((v1**2).sum(), 1e-9)
    g = ((points[:, :3] - base_center) @ v2) / max((v2**2).sum(), 1e-9)
    return a, b, g


def _points_from_ratios(a, b, g, pyr):
    apex, c0, c1, c2, c3 = pyr
    base_center = (c0 + c1 + c2 + c3) / 4.0
    v0 = c1 - c0
    v1 = c3 - c0
    v2 = apex - base_center
    return c0 + a[:, None] * v0 + b[:, None] * v1 + g[:, None] * v2


def _ref_face_pyramids(gt_boxes):
    """(N, 7+) boxes -> (N, 6, 5, 3) face pyramids (apex at the center, then
    the face's 4 corners) in the reference's corner template and face order
    (box_utils.boxes_to_corners_3d, get_pyramids, augmentor_utils.py:469-492),
    so that a face index lines up with the reference's randint draws."""
    n = len(gt_boxes)
    if n == 0:
        return np.zeros((0, 6, 5, 3), np.float32)
    template = np.array([
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ], np.float64) / 2
    local = gt_boxes[:, None, 3:6] * template[None]
    c, s = np.cos(gt_boxes[:, 6]), np.sin(gt_boxes[:, 6])
    rx = local[..., 0] * c[:, None] - local[..., 1] * s[:, None]
    ry = local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    corners = np.stack([rx, ry, local[..., 2]], -1) + gt_boxes[:, None, :3]
    orders = [(0, 1, 5, 4), (4, 5, 6, 7), (7, 6, 2, 3),
              (3, 2, 1, 0), (1, 2, 6, 5), (0, 4, 7, 3)]
    pyr = np.zeros((n, 6, 5, 3))
    for fi, f in enumerate(orders):
        pyr[:, fi, 0] = gt_boxes[:, :3]
        for k in range(4):
            pyr[:, fi, k + 1] = corners[:, f[k]]
    return pyr


def _points_in_hulls(points, pyramids):
    """(M, 3+) x (K, 5, 3) -> (M, K) bool via convex-hull membership
    (box_utils.in_hull / points_in_pyramids_mask role)."""
    from scipy.spatial import Delaunay

    flags = np.zeros((len(points), len(pyramids)), bool)
    for i, pyr in enumerate(pyramids):
        try:
            hull = Delaunay(pyr)
            flags[:, i] = hull.find_simplex(points[:, :3]) >= 0
        except Exception:
            pass
    return flags


def local_pyramid_dropout(gt_boxes, points, dropout_prob, pyramids=None,
                          rng=np.random):
    """Drop every point of one random face pyramid per selected box
    (augmentor_utils.local_pyramid_dropout:510-524, identical RNG order);
    dropped boxes' pyramids leave the chain."""
    if pyramids is None:
        pyramids = _ref_face_pyramids(gt_boxes)
    face = rng.randint(0, 6, (len(pyramids),))
    chosen = rng.uniform(0, 1, (len(pyramids),)) <= dropout_prob
    if chosen.sum() != 0:
        sel = pyramids[chosen, face[chosen]]
        hit = _points_in_hulls(points, sel)
        points = points[~hit.any(-1)]
    pyramids = pyramids[~chosen]
    return gt_boxes, points, pyramids


def local_pyramid_sparsify(gt_boxes, points, prob, max_num_pts,
                           pyramids=None, rng=np.random):
    """Subsample one random face pyramid per selected box down to
    max_num_pts points (augmentor_utils.local_pyramid_sparsify:526-557,
    identical RNG order)."""
    if pyramids is None:
        pyramids = _ref_face_pyramids(gt_boxes)
    if len(pyramids) > 0:
        face = rng.randint(0, 6, (len(pyramids),))
        chosen = rng.uniform(0, 1, (len(pyramids),)) <= prob
        sel = pyramids[chosen, face[chosen]]
        hit = _points_in_hulls(points, sel)
        dense = hit.sum(0) > max_num_pts
        if dense.sum() > 0:
            masks = hit[:, dense]
            remain = points[~masks.any(-1)]
            kept = []
            for i in range(masks.shape[1]):
                grp = points[masks[:, i]]
                pick = rng.choice(grp.shape[0], size=max_num_pts,
                                  replace=False)
                kept.append(grp[pick])
            points = np.concatenate([remain] + kept, axis=0)
        pyramids = pyramids[~chosen]
    return gt_boxes, points, pyramids


def local_pyramid_swap(gt_boxes, points, prob, max_num_pts, pyramids=None,
                       rng=np.random):
    """Swap the points of one face pyramid between two objects, remapping
    through the pyramid-relative coordinates and rescaling intensities
    (augmentor_utils.local_pyramid_swap:560-658, identical RNG order).

    ``pyramids`` is the chain carried through dropout -> sparsify (boxes whose
    pyramids were consumed there leave the swap pool), exactly like the
    reference dispatch (data_augmentor.py:253-272).
    """
    if pyramids is None:
        pyramids = _ref_face_pyramids(gt_boxes)
    P = pyramids.shape[0]
    swap_mask = rng.uniform(0, 1, (P,)) <= prob
    if swap_mask.sum() == 0:
        return gt_boxes, points

    flat = pyramids.reshape(-1, 5, 3)
    point_masks = _points_in_hulls(points, flat)
    counts = point_masks.sum(0).reshape(P, 6)
    # ignore dropped-out or highly occluded pyramids
    non_zero = counts > max_num_pts
    selected = non_zero * swap_mask[:, None]
    if selected.sum() == 0:
        return gt_boxes, points

    index_i, index_j = np.nonzero(selected)
    # one face per swapping box, drawn among its eligible faces (the
    # reference draws rng.choice even for boxes that end up contributing
    # nothing; the same order keeps the stream in step)
    sel_face = [int(rng.choice(index_j[index_i == i]))
                if e and (index_i == i).any() else 0
                for i, e in enumerate(swap_mask)]
    sel_mask = (selected * np.eye(6, dtype=np.int64)[sel_face]) == 1
    to_swap = pyramids[sel_mask]

    index_i, index_j = np.nonzero(sel_mask)
    non_zero[sel_mask] = False
    partner_i = np.array([
        int(rng.choice(np.where(non_zero[:, j])[0]))
        if np.where(non_zero[:, j])[0].shape[0] > 0 else index_i[k]
        for k, j in enumerate(index_j.tolist())])
    swapped = pyramids[partner_i.astype(np.int32), index_j.astype(np.int32)]

    swap_pyramids = np.concatenate([to_swap, swapped], axis=0)
    swap_point_masks = _points_in_hulls(points, swap_pyramids)
    remain = points[~swap_point_masks.any(-1)]

    parts = []
    k = to_swap.shape[0]
    for i in range(k):
        pi = points[swap_point_masks[:, i]]
        pj = points[swap_point_masks[:, i + k]]
        # intensity (last feature column, like the reference's points[:, -1:])
        ri = (pi[:, -1:] - pi[:, -1:].min()) / np.clip(
            pi[:, -1:].max() - pi[:, -1:].min(), 1e-6, 1)
        rj = (pj[:, -1:] - pj[:, -1:].min()) / np.clip(
            pj[:, -1:].max() - pj[:, -1:].min(), 1e-6, 1)
        ai, bi, gi = _pyramid_ratios(pi, to_swap[i])
        aj, bj, gj = _pyramid_ratios(pj, swapped[i])
        new_i = _points_from_ratios(aj, bj, gj, to_swap[i])
        new_j = _points_from_ratios(ai, bi, gi, swapped[i])
        int_i = rj * (pi[:, -1:].max() - pi[:, -1:].min()) + pi[:, -1:].min()
        int_j = ri * (pj[:, -1:].max() - pj[:, -1:].min()) + pj[:, -1:].min()
        # middle feature columns (e.g. Waymo elongation) ride with the source
        # points; the reference is KITTI-only (xyz+intensity) where this is
        # a no-op
        parts.append(np.concatenate([new_i, pj[:, 3:-1], int_i], axis=1))
        parts.append(np.concatenate([new_j, pi[:, 3:-1], int_j], axis=1))

    parts = np.concatenate(parts, axis=0)
    points = np.concatenate([remain, parts], axis=0)
    return gt_boxes, points.astype(np.float32)
