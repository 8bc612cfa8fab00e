"""Offline COM difficulty annotator: ``occupancy_ratio`` and ``facade_type``
(the port's copy of ``com_tpu/data/annotator.py``; the reference's
tools/demo_db.py:380-579, process_vehicle_anno / process_ped_anno /
process_cyc_anno / determine_facade_type).

It annotates GT-database entries (``annotate_db_infos``, the step between
``create_groundtruth_database`` and COM training) and a frame's annos
(``annotate_frame_annos``, the role of the reference's ``*_short.pkl``
production) with the heuristics the COM2 sampler and COMLoss group by.
Points go once into the box's own frame and are binned with a floor
division: the reference's partition of the box into rotated cells.

* Vehicle: 3 (length) x 2 (width) x 2 (height) = 12 cells, a cell occupied
  when it holds more than 1 point; ratio = occupied / 12.
* Pedestrian: 5 height slabs, occupied when they hold any point; the array
  is padded with 7 zeros, so the ratio is over 12 (the samplers rescale it
  by 12/5).
* Cyclist: 5 length slabs, padded the same way.
* facade_type (Vehicle): the heading against the viewing angle, theta =
  wrap(yaw - atan2(cy, cx)) in degrees, tolerance dt: 0 front
  (|theta - 180| < dt), 1 back (near 0 / 360), 2 side (near 90 / 270), 3 two
  facades; -1 for any other class.

Everything is float64 numpy on the host.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops.host_boxes import points_in_rbbox_by_box


def _local_frame(points_xyz, box):
    """Points in the box's frame, origin at its centre."""
    p = points_xyz - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    x = p[:, 0] * c - p[:, 1] * s
    y = p[:, 0] * s + p[:, 1] * c
    return np.stack([x, y, p[:, 2]], axis=1)


def _cell_counts(points_xyz, box, splits):
    """Points a cell of the box's (sx, sy, sz) partition, flattened x fastest."""
    sx, sy, sz = splits
    local = _local_frame(points_xyz, box)
    half = box[3:6] / 2.0
    local = local[(np.abs(local) <= half + 1e-6).all(axis=1)]
    if len(local) == 0:
        return np.zeros(sx * sy * sz, np.int64)
    fx = np.clip(((local[:, 0] + half[0]) / box[3] * sx).astype(np.int64), 0, sx - 1)
    fy = np.clip(((local[:, 1] + half[1]) / box[4] * sy).astype(np.int64), 0, sy - 1)
    fz = np.clip(((local[:, 2] + half[2]) / box[5] * sz).astype(np.int64), 0, sz - 1)
    return np.bincount((fz * sy + fy) * sx + fx, minlength=sx * sy * sz)


def occupancy_ratio(points_xyz: np.ndarray, box: np.ndarray, class_name: str) -> float:
    """The share of the box's 12 cells (or of 5 slabs padded to 12) that
    its points occupy; any class other than the three is split as a
    Vehicle."""
    slabs = {"Pedestrian": (1, 1, 5), "Cyclist": (5, 1, 1)}.get(class_name)
    if slabs is None:
        return float((_cell_counts(points_xyz, box, (3, 2, 2)) > 1).sum() / 12.0)
    counts = np.concatenate([_cell_counts(points_xyz, box, slabs), np.zeros(7, np.int64)])
    return float((counts > 0).sum() / 12.0)


def facade_type(box: np.ndarray, class_name: str, dt: float = 10.0):
    """(type, theta in degrees); (-1, 0.0) for any class but Vehicle."""
    if class_name != "Vehicle":
        return -1, 0.0
    theta = (box[6] - np.arctan2(box[1], box[0])) % (2 * np.pi) / np.pi * 180.0
    if abs(theta - 180) < dt:
        return 0, theta
    if abs(theta) < dt or abs(theta - 360) < dt:
        return 1, theta
    if abs(theta - 90) < dt or abs(theta - 270) < dt:
        return 2, theta
    return 3, theta


def annotate_db_infos(db_infos: dict, root_path=None, dt: float = 10.0,
                      num_point_features: int = 5) -> dict:
    """Annotate every GT-database entry in place with ``occupancy_ratio``,
    ``facade_type`` and ``facade_angle``.  An entry's points are its
    ``"points"`` or its ``.bin`` file (under ``root_path``), whose points
    are box-relative."""
    for class_name, infos in db_infos.items():
        for info in infos:
            box = np.asarray(info["box3d_lidar"], np.float64)
            if "points" in info:
                pts = info["points"][:, :3].astype(np.float64)
            else:
                p = Path(root_path) / info["path"] if root_path else Path(info["path"])
                pts = np.fromfile(str(p), dtype=np.float32).reshape(
                    -1, num_point_features)[:, :3].astype(np.float64)
                pts += box[None, :3]
            info["occupancy_ratio"] = occupancy_ratio(pts, box, class_name)
            info["facade_type"], info["facade_angle"] = facade_type(box, class_name, dt)
    return db_infos


def annotate_frame_annos(annos: dict, points: np.ndarray, dt: float = 10.0) -> dict:
    """Annotate a frame's annos in place from the frame's own points:
    ``occupancy_ratio`` (float32) and ``facade_type`` (int64) an object
    (the points in a box by ``points_in_rbbox``, run a box at a time on the
    points near it)."""
    boxes = annos["gt_boxes_lidar"][:, :7]
    names = annos["name"]
    inbox = points_in_rbbox_by_box(points[:, :3], boxes)
    occ = np.zeros(len(names), np.float32)
    fac = np.zeros(len(names), np.int64)
    for i, name in enumerate(names):
        box = boxes[i].astype(np.float64)
        occ[i] = occupancy_ratio(points[inbox[:, i], :3].astype(np.float64), box, name)
        fac[i], _ = facade_type(box, name, dt)
    annos["occupancy_ratio"] = occ
    annos["facade_type"] = fac
    return annos
