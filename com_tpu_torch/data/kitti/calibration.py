"""KITTI calibration and the camera <-> lidar box transforms, numpy on the
host (the port's copy of ``com_tpu/data/kitti/calibration.py``; role of
pcdet/utils/calibration_kitti.py and the camera-frame conversions of
pcdet/utils/box_utils.py).
"""
from __future__ import annotations

import numpy as np


class Calibration:
    def __init__(self, calib_file):
        if isinstance(calib_file, dict):
            calib = calib_file
        else:
            calib = {}
            with open(calib_file) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    key, value = line.split(":", 1)
                    calib[key.strip()] = np.array([float(x) for x in value.split()],
                                                  np.float64)
        self.P2 = calib["P2"].reshape(3, 4)
        self.R0 = calib["R0_rect"].reshape(3, 3)
        self.V2C = calib["Tr_velo_to_cam"].reshape(3, 4)

    def rect_to_lidar(self, pts_rect):
        """(N, 3) rect camera -> lidar."""
        pts_ref = pts_rect @ np.linalg.inv(self.R0).T
        pts_hom = np.concatenate([pts_ref, np.ones((len(pts_ref), 1))], axis=1)
        v2c_hom = np.concatenate(
            [self.V2C, np.array([[0, 0, 0, 1.0]])], axis=0
        )
        return (pts_hom @ np.linalg.inv(v2c_hom).T)[:, :3]

    def lidar_to_rect(self, pts_lidar):
        pts_hom = np.concatenate([pts_lidar, np.ones((len(pts_lidar), 1))], axis=1)
        return (pts_hom @ self.V2C.T) @ self.R0.T

    def rect_to_img(self, pts_rect):
        # reference quirks preserved exactly (calibration_kitti.py:75-84):
        # the projective divide uses the input rect z (not the homogeneous
        # w), and the returned depth removes P2's z-offset
        pts_hom = np.concatenate([pts_rect, np.ones((len(pts_rect), 1))], axis=1)
        pts_2d = pts_hom @ self.P2.T
        pts_img = pts_2d[:, :2] / pts_hom[:, 2:3]
        depth = pts_2d[:, 2] - self.P2.T[3, 2]
        return pts_img, depth

    def lidar_to_img(self, pts_lidar):
        """(N, 3) lidar -> ((N, 2) pixel coords, (N,) rect depth)
        (calibration_kitti.py lidar_to_img role)."""
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        """Pixel coords + rect depth -> (N, 3) rect points
        (calibration_kitti.py:95-105; tx/ty fold in P2's baseline offset)."""
        cu, cv = self.P2[0, 2], self.P2[1, 2]
        fu, fv = self.P2[0, 0], self.P2[1, 1]
        tx, ty = self.P2[0, 3] / (-fu), self.P2[1, 3] / (-fv)
        x = (np.asarray(u) - cu) * depth_rect / fu + tx
        y = (np.asarray(v) - cv) * depth_rect / fv + ty
        return np.stack([x, y, np.asarray(depth_rect)], axis=1)


def boxes3d_kitti_camera_to_lidar(boxes_camera, calib: Calibration):
    """(N, 7) [x y z l h w ry] camera -> (N, 7) [x y z dx dy dz heading] lidar."""
    xyz_cam = boxes_camera[:, 0:3]
    l, h, w = boxes_camera[:, 3:4], boxes_camera[:, 4:5], boxes_camera[:, 5:6]
    r = boxes_camera[:, 6:7]
    xyz = calib.rect_to_lidar(xyz_cam)
    xyz[:, 2] += h[:, 0] / 2  # camera anchors box bottom, lidar anchors center
    heading = -(np.pi / 2 + r)
    return np.concatenate([xyz, l, w, h, heading], axis=1)


def boxes3d_lidar_to_kitti_camera(boxes_lidar, calib: Calibration):
    xyz = boxes_lidar[:, 0:3].copy()
    dx, dy, dz = boxes_lidar[:, 3:4], boxes_lidar[:, 4:5], boxes_lidar[:, 5:6]
    heading = boxes_lidar[:, 6:7]
    xyz[:, 2] -= dz[:, 0] / 2
    xyz_cam = calib.lidar_to_rect(xyz)
    r = -heading - np.pi / 2
    return np.concatenate([xyz_cam, dx, dz, dy, r], axis=1)  # l h w


def boxes3d_to_corners3d_kitti_camera(boxes3d, bottom_center=True):
    """(N, 7) [x y z l h w ry] camera boxes -> (N, 8, 3) corners
    (box_utils.boxes3d_to_corners3d_kitti_camera:222-266 corner ordering:
    4 bottom corners 0-3, 4 top corners 4-7, ry about the camera y axis)."""
    n = boxes3d.shape[0]
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    sx = np.array([0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5])
    sz = np.array([0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5])
    x_c = l[:, None] * sx[None]
    z_c = w[:, None] * sz[None]
    if bottom_center:
        y_c = np.zeros((n, 8))
        y_c[:, 4:] = -h[:, None]
    else:
        y_c = h[:, None] * np.array([0.5] * 4 + [-0.5] * 4)[None]
    ry = boxes3d[:, 6]
    c, s = np.cos(ry), np.sin(ry)
    x = c[:, None] * x_c + s[:, None] * z_c
    z = -s[:, None] * x_c + c[:, None] * z_c
    corners = np.stack([x, y_c, z], axis=2)
    return corners + boxes3d[:, None, 0:3]


def corners_rect_to_camera(corners):
    """(8, 3) rect corners -> (7,) [x y z l h w ry] camera box
    (box_utils.corners_rect_to_camera:55-90: edge-group-averaged dims/yaw,
    center = all-corner mean lifted by h/2 to the bottom anchor)."""
    height_group = [(0, 4), (1, 5), (2, 6), (3, 7)]
    width_group = [(0, 1), (2, 3), (4, 5), (6, 7)]
    length_group = [(0, 3), (1, 2), (4, 7), (5, 6)]
    height = np.mean([np.linalg.norm(corners[a] - corners[b])
                      for a, b in height_group])
    width = np.mean([np.linalg.norm(corners[a] - corners[b])
                     for a, b in width_group])
    length = np.mean([np.linalg.norm(corners[a] - corners[b])
                      for a, b in length_group])
    vector = np.zeros(2)
    for a, b in length_group:
        d = corners[a] - corners[b]
        vector[0] += d[0]
        vector[1] += d[2]
    rotation_y = -np.arctan2(vector[1], vector[0])
    # all-corner mean lifted by h/2 back to the bottom anchor (:86-88)
    center_point = corners.mean(axis=0)
    center_point[1] += height / 2
    return np.concatenate(
        [center_point, [length, height, width, rotation_y]])


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None):
    """(N, 7) camera boxes -> (N, 4) [x1 y1 x2 y2] pixel boxes
    (box_utils.boxes3d_kitti_camera_to_imageboxes:268-288)."""
    corners = boxes3d_to_corners3d_kitti_camera(boxes3d)
    pts_img, _ = calib.rect_to_img(corners.reshape(-1, 3))
    ci = pts_img.reshape(-1, 8, 2)
    boxes2d = np.concatenate([ci.min(axis=1), ci.max(axis=1)], axis=1)
    if image_shape is not None:
        boxes2d[:, 0] = np.clip(boxes2d[:, 0], 0, image_shape[1] - 1)
        boxes2d[:, 1] = np.clip(boxes2d[:, 1], 0, image_shape[0] - 1)
        boxes2d[:, 2] = np.clip(boxes2d[:, 2], 0, image_shape[1] - 1)
        boxes2d[:, 3] = np.clip(boxes2d[:, 3], 0, image_shape[0] - 1)
    return boxes2d


def pairwise_iou_2d(boxes1, boxes2):
    """(N, 4) x (M, 4) [x1 y1 x2 y2] -> (N, M) IoU
    (box_utils.pairwise_iou role, numpy)."""
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)))
    a1 = np.clip(boxes1[:, 2] - boxes1[:, 0], 0, None) * np.clip(
        boxes1[:, 3] - boxes1[:, 1], 0, None)
    a2 = np.clip(boxes2[:, 2] - boxes2[:, 0], 0, None) * np.clip(
        boxes2[:, 3] - boxes2[:, 1], 0, None)
    wh = np.clip(
        np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
        - np.maximum(boxes1[:, None, :2], boxes2[None, :, :2]), 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[:, None] + a2[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def calib_to_matricies(calib: Calibration):
    """Calibration -> (trans_lidar_to_cam (4, 4), trans_cam_to_img (3, 4)),
    f32 (kitti_utils.calib_to_matricies role): lidar->rect folds R0 into
    V2C; cam->img is P2."""
    v2c = np.concatenate([calib.V2C, [[0, 0, 0, 1.0]]], axis=0)
    r0 = np.eye(4)
    r0[:3, :3] = calib.R0
    return (r0 @ v2c).astype(np.float32), calib.P2.astype(np.float32)
