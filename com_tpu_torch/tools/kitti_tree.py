"""Write a KITTI-format tree from a seed, for the KITTI configs' own
DATA_CONFIG when no KITTI download is at hand (tests, the card smoke run).

    python -m com_tpu_torch.tools.kitti_tree --out DIR [--seed 0] [--train 16]
        [--val 8] [--points 120000] [--images] [--custom]

The KITTI layout (pcdet's, as ``KittiDataset`` and the GT sampler read it):
``training/{velodyne,calib,label_2,planes}``, ``ImageSets/{train,val}.txt``,
``gt_database/<frame>_<class>_<k>.bin`` (an object's points, box-relative
xyz + intensity, f32) and ``kitti_dbinfos_train.pkl`` ({class: [info]},
pcdet's keys) over the train frames.  Each scan is a full 360 degree
sweep: ground on the frame's road plane (``planes/``, rect frame), clutter,
and 10-15 labelled Cars, Pedestrians and Cyclists in the camera's view
(at least 4 / 3 / 3 a frame, each with 24 or more points), plus one
DontCare row.  The calibration is KITTI's frame 000000.  ``--images``
also writes ``training/image_2/<id>.png`` at KITTI's 375 x 1242 (RGB,
drawn from the seed apart from the scans, so that a tree with images
holds the same scans and labels as one without): sky over road with
noise, and each object's image box filled far to near in its class's
colour with a texture.  ``--custom``
writes the custom dataset's layout instead: ``points/<id>.npy``,
``labels/<id>.txt`` (``x y z dx dy dz heading class`` in the lidar frame,
classes Vehicle / Pedestrian / Cyclist) and the split files.
"""
from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from ..data.kitti.calibration import (Calibration, boxes3d_kitti_camera_to_imageboxes,
                                      boxes3d_kitti_camera_to_lidar,
                                      boxes3d_lidar_to_kitti_camera)
from ..data.kitti.kitti_dataset import parse_label_file
from ..data.kitti.png import write_png
from ..ops.host_boxes import enlarge_box3d, points_in_rbbox

# KITTI training frame 000000's calibration
CALIB = {
    "P2": [7.215377e+02, 0.0, 6.095593e+02, 4.485728e+01, 0.0, 7.215377e+02, 1.728540e+02,
           2.163791e-01, 0.0, 0.0, 1.0, 2.745884e-03],
    "R0_rect": [9.999239e-01, 9.837760e-03, -7.445048e-03, -9.869795e-03, 9.999421e-01,
                -4.278459e-03, 7.402527e-03, 4.351614e-03, 9.999631e-01],
    "Tr_velo_to_cam": [7.533745e-03, -9.999714e-01, -6.166020e-04, -4.069766e-03,
                       1.480249e-02, 7.280733e-04, -9.998902e-01, -7.631618e-02,
                       9.998621e-01, 7.523790e-03, 1.480755e-02, -2.717806e-01],
}
PLANE = np.array([-7.051729e-03, -9.997791e-01, -1.980151e-02, 1.680367e+00])
IMAGE_SHAPE = (375, 1242)
CLASSES = ("Car", "Pedestrian", "Cyclist")
SIZES = np.array([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]])  # dx dy dz
MIN_A_FRAME = (4, 3, 3)
CUSTOM_NAMES = {"Car": "Vehicle", "Pedestrian": "Pedestrian", "Cyclist": "Cyclist"}


def calibration() -> Calibration:
    return Calibration({k: np.asarray(v, np.float64) for k, v in CALIB.items()})


def road_z(calib: Calibration, plane, xy: np.ndarray) -> np.ndarray:
    """The lidar z of the rect-frame road plane under lidar points (N, 2)."""
    pts = np.concatenate([xy, np.zeros((len(xy), 1))], axis=1)
    rect = calib.lidar_to_rect(pts)
    a, b, c, d = plane
    rect[:, 1] = (-d - a * rect[:, 0] - c * rect[:, 2]) / b
    return calib.rect_to_lidar(rect)[:, 2]


def place_objects(rng, calib, plane, count):
    """(count, 7) lidar boxes on the road in the camera's view, not
    touching in BEV, and their class indices (at least MIN_A_FRAME of each)."""
    cls = np.concatenate([np.full(n, i) for i, n in enumerate(MIN_A_FRAME)])
    cls = np.concatenate([cls, rng.randint(0, 3, count - len(cls))])
    boxes = []
    for c in cls:
        while True:
            x = rng.uniform(6.0, 55.0)
            y = rng.uniform(-0.55, 0.55) * x
            dims = SIZES[c] * rng.uniform(0.9, 1.1, 3)
            if abs(y) < 30.0 and all(np.hypot(x - b[0], y - b[1]) > 5.0 for b in boxes):
                break
        z = road_z(calib, plane, np.array([[x, y]]))[0] + dims[2] / 2
        boxes.append([x, y, z, *dims, rng.uniform(-np.pi, np.pi)])
    return np.asarray(boxes), cls


def object_points(rng, box, count):
    """``count`` points inside a lidar box (a 2 % shell kept clear)."""
    local = rng.uniform(-0.49, 0.49, (count, 3)) * box[3:6]
    c, s = np.cos(box[6]), np.sin(box[6])
    xyz = np.stack([local[:, 0] * c - local[:, 1] * s, local[:, 0] * s + local[:, 1] * c,
                    local[:, 2]], axis=1) + box[:3]
    return np.concatenate([xyz, rng.uniform(0.0, 1.0, (count, 1))], axis=1)


def make_scan(rng, calib, plane, boxes, num_points):
    """A 360 degree scan of ``num_points`` (x y z intensity) f32: each
    object's points (24 + 3000 / distance), then ground on the plane (85 %)
    and clutter up to 3 m above it, none within 0.3 m of an object's box."""
    objs = [object_points(rng, b, int(24 + 3000.0 / np.hypot(b[0], b[1]))) for b in boxes]
    rest = num_points - sum(len(o) for o in objs)
    draw = int(rest * 1.2) + 64  # the boxes take far less than a sixth of the sweep
    az = rng.uniform(-np.pi, np.pi, draw)
    r = 2.5 + 77.5 * rng.uniform(0.0, 1.0, draw) ** 2
    xy = np.stack([r * np.cos(az), r * np.sin(az)], axis=1)
    z = road_z(calib, plane, xy) + np.where(rng.uniform(size=draw) < 0.85,
                                            rng.normal(0.0, 0.03, draw),
                                            rng.uniform(0.2, 3.0, draw))
    bg = np.concatenate([xy, z[:, None], rng.uniform(0.0, 1.0, (draw, 1))], axis=1)
    if len(boxes):
        bg = bg[~points_in_rbbox(bg, enlarge_box3d(boxes, (0.6, 0.6, 0.6))).any(axis=1)]
    if len(bg) < rest:
        raise ValueError(f"{len(bg)} background points left of {rest}")
    return np.concatenate(objs + [bg[:rest]]).astype(np.float32)


def label_lines(rng, calib, boxes, cls):
    """label_2 rows (type trunc occ alpha x1 y1 x2 y2 h w l x y z ry) and a DontCare."""
    cam = boxes3d_lidar_to_kitti_camera(boxes, calib)
    box2d = boxes3d_kitti_camera_to_imageboxes(cam, calib, IMAGE_SHAPE)
    lines = []
    for k in range(len(boxes)):
        x, y, z, l, h, w, ry = cam[k]
        alpha = ry - np.arctan2(x, z)
        occ = rng.randint(0, 3)
        lines.append(f"{CLASSES[cls[k]]} 0.00 {occ} {alpha:.2f} "
                     + " ".join(f"{v:.2f}" for v in box2d[k])
                     + f" {h:.2f} {w:.2f} {l:.2f} {x:.2f} {y:.2f} {z:.2f} {ry:.2f}")
    lines.append("DontCare -1 -1 -10 500.00 170.00 540.00 190.00 -1 -1 -1 -1000 -1000 -1000 -10")
    return lines


COLOURS = np.array([[200, 40, 40], [40, 180, 60], [50, 80, 220]], np.float32)  # a class each


def draw_image(rng, boxes2d, cls, depth):
    """A (375, 1242, 3) uint8 camera image: a sky-to-road gradient with
    noise, then each object's image box, far to near, filled with its
    class's colour shaded by distance and textured."""
    h, w = IMAGE_SHAPE
    rows = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    img = (np.array([150, 180, 220], np.float32) * (1 - rows)
           + np.array([90, 90, 95], np.float32) * rows)
    img = img + rng.normal(0.0, 8.0, (h, w, 3)).astype(np.float32)
    for k in np.argsort(-depth):
        x1, y1, x2, y2 = (int(v) for v in boxes2d[k])
        x1, y1, x2, y2 = max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)
        if x2 <= x1 or y2 <= y1:
            continue
        shade = np.clip(1.2 - depth[k] / 80.0, 0.4, 1.2)
        img[y1:y2, x1:x2] = (COLOURS[cls[k]] * shade
                             + rng.normal(0.0, 12.0, (y2 - y1, x2 - x1, 3)).astype(np.float32))
    return np.clip(img, 0, 255).astype(np.uint8)


def difficulty(height, occluded, truncated):
    """KITTI's level (0 easy, 1 moderate, 2 hard, -1 none) of a label."""
    for level, (min_h, max_occ, max_trunc) in enumerate(((40, 0, 0.15), (25, 1, 0.30),
                                                        (25, 2, 0.50))):
        if height >= min_h and occluded <= max_occ and truncated <= max_trunc:
            return level
    return -1


def write_kitti_tree(root, seed=0, num_train=16, num_val=8, num_points=120000,
                     objects=(10, 15), images=False):
    """Write the tree under ``root``; returns {"train": ids, "val": ids,
    "db": {class: count}}.  Frames are drawn from ``seed`` in order; with
    ``images`` each frame's PNG from its own stream (``draw_image``)."""
    root = Path(root)
    split = root / "training"
    for sub in ("velodyne", "calib", "label_2", "planes") + (("image_2",) if images else ()):
        (split / sub).mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    (root / "gt_database").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    calib = calibration()
    ids = [f"{i:06d}" for i in range(num_train + num_val)]
    db = {c: [] for c in CLASSES}
    calib_text = "".join(f"{k}: " + " ".join(f"{v:.12e}" for v in CALIB[k]) + "\n"
                         for k in ("P2", "R0_rect", "Tr_velo_to_cam"))
    for n, idx in enumerate(ids):
        plane = PLANE + np.concatenate([rng.normal(0.0, 1e-3, 3), rng.normal(0.0, 0.02, 1)])
        boxes, cls = place_objects(rng, calib, plane, rng.randint(objects[0], objects[1] + 1))
        scan = make_scan(rng, calib, plane, boxes, num_points)
        scan.tofile(split / "velodyne" / f"{idx}.bin")
        (split / "calib" / f"{idx}.txt").write_text(calib_text)
        (split / "planes" / f"{idx}.txt").write_text(
            "# Plane\nWidth 4\nHeight 1\n" + " ".join(f"{v:.6e}" for v in plane) + "\n")
        (split / "label_2" / f"{idx}.txt").write_text(
            "\n".join(label_lines(rng, calib, boxes, cls)) + "\n")
        if images:
            cam = boxes3d_lidar_to_kitti_camera(boxes, calib)
            write_png(split / "image_2" / f"{idx}.png", draw_image(
                np.random.RandomState((seed * 1_000_003 + n) % 2 ** 32),
                boxes3d_kitti_camera_to_imageboxes(cam, calib, IMAGE_SHAPE), cls, cam[:, 2]))
        if n >= num_train:
            continue
        # the database from the labels as written (the GT the dataset reads)
        label = parse_label_file(split / "label_2" / f"{idx}.txt")
        gt = boxes3d_kitti_camera_to_lidar(np.concatenate(
            [label["loc"], label["dims_lhw"], label["rotation_y"][:, None]], axis=1), calib)
        inside = points_in_rbbox(scan, gt)
        for k, name in enumerate(label["name"]):
            pts = scan[inside[:, k]].copy()
            pts[:, :3] -= gt[k, :3].astype(np.float32)
            rel = f"gt_database/{idx}_{name}_{k}.bin"
            pts.tofile(root / rel)
            bbox = label["bbox"][k]
            db[name].append({
                "name": str(name), "path": rel, "image_idx": idx, "gt_idx": k,
                "box3d_lidar": gt[k].astype(np.float32), "num_points_in_gt": len(pts),
                "difficulty": difficulty(bbox[3] - bbox[1], label["occluded"][k],
                                         label["truncated"][k]),
                "bbox": bbox, "score": -1.0})
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids[:num_train]) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(ids[num_train:]) + "\n")
    with open(root / "kitti_dbinfos_train.pkl", "wb") as f:
        pickle.dump(db, f)
    return {"train": ids[:num_train], "val": ids[num_train:],
            "db": {c: len(v) for c, v in db.items()}}


def write_custom_tree(root, seed=0, num_train=2, num_val=2, num_points=120000,
                      objects=(10, 15)):
    """The custom dataset's layout over the same scenes: ``points/<id>.npy``,
    ``labels/<id>.txt`` in the lidar frame (Car named Vehicle) and the
    split files.  Returns {"train": ids, "val": ids}."""
    root = Path(root)
    (root / "points").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    calib = calibration()
    ids = [f"{i:06d}" for i in range(num_train + num_val)]
    for idx in ids:
        boxes, cls = place_objects(rng, calib, PLANE, rng.randint(objects[0], objects[1] + 1))
        np.save(root / "points" / f"{idx}.npy", make_scan(rng, calib, PLANE, boxes, num_points))
        (root / "labels" / f"{idx}.txt").write_text("".join(
            " ".join(f"{v:.4f}" for v in b) + f" {CUSTOM_NAMES[CLASSES[c]]}\n"
            for b, c in zip(boxes, cls)))
    (root / "ImageSets" / "train.txt").write_text("\n".join(ids[:num_train]) + "\n")
    (root / "ImageSets" / "val.txt").write_text("\n".join(ids[num_train:]) + "\n")
    return {"train": ids[:num_train], "val": ids[num_train:]}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--train", type=int, default=16)
    parser.add_argument("--val", type=int, default=8)
    parser.add_argument("--points", type=int, default=120000)
    parser.add_argument("--images", action="store_true")
    parser.add_argument("--custom", action="store_true")
    args = parser.parse_args(argv)
    if args.custom:
        out = write_custom_tree(args.out, args.seed, args.train, args.val, args.points)
    else:
        out = write_kitti_tree(args.out, args.seed, args.train, args.val, args.points,
                               images=args.images)
    print(out)
    return out


if __name__ == "__main__":
    main()
