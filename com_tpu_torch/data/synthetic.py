"""Synthetic LiDAR dataset: procedurally generated scenes with objects (the
port's copy of ``com_tpu/data/synthetic.py``).

For tests, benchmarks and training runs without Waymo data.  Scenes hold a
ground plane of clutter and boxes with points inside them, and the dataset
builds an in-memory GT database, so the whole COMAug path (clustering,
curriculum sampling, paste) runs without files, and ``evaluation`` scores
detections against the scenes' GT.  Both packages make the same scenes and
database from the same seed.
"""
from __future__ import annotations

import numpy as np

from ..ops.host_boxes import boxes_iou_bev
from ..utils.registry import DATASETS
from .dataset import DatasetTemplate

_CLASS_DIMS = {
    "Vehicle": ([4.7, 2.1, 1.7], 0.4),
    "Pedestrian": ([0.9, 0.86, 1.7], 0.1),
    "Cyclist": ([1.8, 0.8, 1.7], 0.15),
}


def make_scene(rng, class_names, num_objects=12, num_bg_points=16000,
               pc_range=(-74.88, -74.88, -2, 74.88, 74.88, 4.0),
               points_per_obj=(20, 300), num_features=5):
    lo, hi = np.asarray(pc_range[:3]), np.asarray(pc_range[3:])
    margin = 6.0
    n_obj = rng.randint(max(1, num_objects // 2), num_objects + 1)
    names, boxes, obj_points, npgt = [], [], [], []
    for _ in range(n_obj):
        name = class_names[rng.randint(len(class_names))]
        dims, jitter = _CLASS_DIMS.get(name, ([2.0, 2.0, 2.0], 0.2))
        dxyz = np.asarray(dims) * rng.uniform(1 - jitter, 1 + jitter, 3)
        ctr = rng.uniform(lo[:2] + margin, hi[:2] - margin)
        z = rng.uniform(-0.5, 0.5) + dxyz[2] / 2 - 1.0
        yaw = rng.uniform(-np.pi, np.pi)
        box = np.array([ctr[0], ctr[1], z, dxyz[0], dxyz[1], dxyz[2], yaw], np.float32)
        # surface-ish points in box frame
        n_pts = rng.randint(*points_per_obj)
        local = rng.uniform(-0.5, 0.5, (n_pts, 3)) * dxyz
        c, s = np.cos(yaw), np.sin(yaw)
        world = np.stack(
            [local[:, 0] * c - local[:, 1] * s + ctr[0],
             local[:, 0] * s + local[:, 1] * c + ctr[1],
             local[:, 2] + z],
            axis=1,
        )
        extra = rng.rand(n_pts, num_features - 3).astype(np.float32)
        obj_points.append(np.concatenate([world.astype(np.float32), extra], axis=1))
        names.append(name)
        boxes.append(box)
        npgt.append(n_pts)

    bg_xy = rng.uniform(lo[:2], hi[:2], (num_bg_points, 2))
    bg_z = rng.normal(-1.0, 0.15, (num_bg_points, 1))  # ground plane
    bg_extra = rng.rand(num_bg_points, num_features - 3)
    bg = np.concatenate([bg_xy, bg_z, bg_extra], axis=1).astype(np.float32)

    points = np.concatenate([bg] + obj_points, axis=0)
    return {
        "points": points,
        "gt_boxes": np.stack(boxes) if boxes else np.zeros((0, 7), np.float32),
        "gt_names": np.array(names),
        "num_points_in_gt": np.asarray(npgt, np.float32),
        "true_object": np.ones(len(boxes), np.float32),
        "occupancy_ratio": rng.uniform(0.1, 0.9, len(boxes)).astype(np.float32),
        "facade_type": rng.randint(0, 4, len(boxes)).astype(np.float32),
    }


def make_synthetic_db_infos(rng, class_names, per_class=64, num_features=5):
    """In-memory GT database (points embedded, no files)."""
    infos = {c: [] for c in class_names}
    for c in class_names:
        dims, jitter = _CLASS_DIMS.get(c, ([2.0, 2.0, 2.0], 0.2))
        for _ in range(per_class):
            dxyz = np.asarray(dims) * rng.uniform(1 - jitter, 1 + jitter, 3)
            ctr = rng.uniform(-60, 60, 2)
            z = rng.uniform(-0.5, 0.5) + dxyz[2] / 2 - 1.0
            yaw = rng.uniform(-np.pi, np.pi)
            box = np.array([ctr[0], ctr[1], z, *dxyz, yaw], np.float32)
            n_pts = rng.randint(8, 200)
            local = rng.uniform(-0.5, 0.5, (n_pts, 3)) * dxyz
            cth, sth = np.cos(yaw), np.sin(yaw)
            world = np.stack(
                [local[:, 0] * cth - local[:, 1] * sth + ctr[0],
                 local[:, 0] * sth + local[:, 1] * cth + ctr[1],
                 local[:, 2] + z], axis=1)
            extra = rng.rand(n_pts, num_features - 3)
            pts = np.concatenate([world, extra], axis=1).astype(np.float32)
            infos[c].append({
                "name": c,
                "box3d_lidar": box,
                "num_points_in_gt": n_pts,
                "difficulty": 0,
                "occupancy_ratio": float(rng.uniform(0.05, 0.95)),
                "facade_type": int(rng.randint(0, 4)),
                "points": pts,  # embedded; sampler skips file IO
            })
    return infos


@DATASETS.register
class SyntheticDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, db_infos=None, seed=None):
        n_scenes = int(dataset_cfg.get("NUM_SCENES", 64))
        scene_seed = int(dataset_cfg.get("SCENE_SEED", 123))
        gen = np.random.RandomState(scene_seed)
        self._scenes = [
            make_scene(
                gen,
                class_names,
                num_objects=int(dataset_cfg.get("NUM_OBJECTS", 12)),
                num_bg_points=int(dataset_cfg.get("NUM_BG_POINTS", 16000)),
                pc_range=dataset_cfg["POINT_CLOUD_RANGE"],
            )
            for _ in range(n_scenes)
        ]
        if db_infos is None and training and dataset_cfg.get("DATA_AUGMENTOR"):
            has_gt_sampling = any(
                c["NAME"] == "gt_sampling"
                for c in dataset_cfg["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"]
            )
            if has_gt_sampling:
                db_infos = make_synthetic_db_infos(gen, class_names)
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         db_infos=db_infos, seed=seed)

    def __len__(self):
        return len(self._scenes)

    def __getitem__(self, index):
        self._reseed_for_item(index)
        scene = self._scenes[index]
        data = {k: np.copy(v) for k, v in scene.items()}
        data["frame_id"] = index
        return self.prepare_data(data)

    def evaluation(self, det_annos, class_names, **kwargs):
        """Recall and precision at BEV IoU 0.5 against each frame's scene GT
        (the smoke-eval oracle of ``com_tpu``)."""
        tp = fp = fn = 0
        for annos in det_annos:
            gt = self._scenes[annos["frame_id"]]["gt_boxes"]
            pred = annos["boxes_lidar"]
            if len(pred) == 0:
                fn += len(gt)
                continue
            if len(gt) == 0:
                fp += len(pred)
                continue
            iou = boxes_iou_bev(pred[:, :7], gt[:, :7])
            matched = iou.max(axis=1) > 0.5
            tp += int(matched.sum())
            fp += int((~matched).sum())
            fn += int((iou.max(axis=0) <= 0.5).sum())
        rec = tp / max(tp + fn, 1)
        prec = tp / max(tp + fp, 1)
        return f"recall@0.5={rec:.3f} precision@0.5={prec:.3f}", {"recall": rec, "precision": prec}
