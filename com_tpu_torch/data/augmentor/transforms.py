"""World augmentations of the host pipeline, in numpy (the port's copy of the
global transforms of ``com_tpu/data/augmentor/transforms.py``; role of
pcdet/datasets/augmentor/augmentor_utils.py).

Flip along x or y, rotation, scaling and translation of the whole scene.
Each takes and returns (gt_boxes, points), edits them in place, and draws
from the caller's numpy RNG stream so runs are deterministic per seed.  The
per-object (local), frustum and pyramid transforms are not ported yet.
"""
from __future__ import annotations

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
