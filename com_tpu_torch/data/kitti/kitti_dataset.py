"""KITTI dataset (the port's copy of ``com_tpu/data/kitti/kitti_dataset.py``;
pcdet/datasets/kitti/kitti_dataset.py role).

Reads a KITTI tree: ``{training,testing}/velodyne/*.bin`` (x y z
intensity, f32), ``label_2/*.txt`` (camera-frame boxes, converted to lidar
boxes), ``calib/*.txt`` and ``planes/*.txt`` (the road plane, for
``USE_ROAD_PLANE`` in GT sampling); the frames of a split from
``ImageSets/<split>.txt``, else every velodyne file.  The COM side arrays
are optional, so KITTI trains with their defaults (true_object 1,
occupancy and facade 0).

Kept from ``com_tpu`` as it is: ``FOV_POINTS_ONLY`` is read by no code, so
the whole 360 degree scan goes on (the collate subsamples it to
``MAX_POINTS_PER_SCENE``); ``calib`` joins the item only when
``GET_ITEM_LIST`` asks for more than ``points``, so the GT sampler lifts
pasted boxes onto the road plane without it (``database_sampler.py``
``put_boxes_on_road_planes``).  ``GET_ITEM_LIST`` may ask for the image
items: ``images`` (``image_2/<id>.png`` as float32 in [0, 1], read by the
port's own PNG decoder, ``png.py``), ``calib_matricies``
(``trans_lidar_to_cam`` (4, 4) and ``trans_cam_to_img`` (3, 4)) and
``gt_boxes2d`` (the labels' image boxes).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ...utils.registry import DATASETS
from ..dataset import DatasetTemplate
from .calibration import (Calibration, boxes3d_kitti_camera_to_imageboxes,
                          boxes3d_kitti_camera_to_lidar, boxes3d_lidar_to_kitti_camera,
                          calib_to_matricies)
from .png import read_png


def parse_label_file(path):
    """A ``label_2`` file as arrays; DontCare rows dropped (they matter only
    for the 2D-box metric's FP subtraction, which the BEV/3D evaluator
    never computes)."""
    names, trunc, occ, alpha, bbox, dims, locs, ry = [], [], [], [], [], [], [], []
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        p = line.strip().split(" ")
        if len(p) < 15 or p[0] == "DontCare":
            continue
        names.append(p[0])
        trunc.append(float(p[1]))
        occ.append(float(p[2]))
        alpha.append(float(p[3]))
        bbox.append([float(x) for x in p[4:8]])
        dims.append([float(p[10]), float(p[8]), float(p[9])])  # l, h, w
        locs.append([float(x) for x in p[11:14]])
        ry.append(float(p[14]))
    return {
        "name": np.array(names),
        "truncated": np.array(trunc, np.float32),
        "occluded": np.array(occ, np.float32),
        "alpha": np.array(alpha, np.float32),
        "bbox": np.array(bbox, np.float32).reshape(-1, 4),
        "dims_lhw": np.array(dims, np.float32).reshape(-1, 3),
        "loc": np.array(locs, np.float32).reshape(-1, 3),
        "rotation_y": np.array(ry, np.float32),
    }


@DATASETS.register
class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, db_infos=None, seed=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         db_infos=db_infos, seed=seed)
        self.split = dataset_cfg.get("DATA_SPLIT", {}).get("train" if training else "test",
                                                            "train")
        root = Path(self.root_path)
        self.root_split = root / ("training" if self.split != "test" else "testing")
        split_file = root / "ImageSets" / f"{self.split}.txt"
        self.sample_ids = (
            [x.strip() for x in split_file.read_text().splitlines(keepends=True)]
            if split_file.exists()
            else sorted(p.stem for p in (self.root_split / "velodyne").glob("*.bin")))
        self._gt_cache = {}

    def __len__(self):
        return len(self.sample_ids)

    def get_lidar(self, idx):
        return np.fromfile(str(self.root_split / "velodyne" / f"{idx}.bin"),
                           np.float32).reshape(-1, 4)

    def get_calib(self, idx):
        return Calibration(str(self.root_split / "calib" / f"{idx}.txt"))

    def get_image(self, idx):
        """The camera image as float32 in [0, 1] (kitti_dataset.get_image)."""
        return read_png(self.root_split / "image_2" / f"{idx}.png").astype(np.float32) / 255.0

    def get_road_plane(self, idx):
        """The rect-frame road plane (a, b, c, d), normalised, b made
        negative (y up); None without a plane file."""
        p = self.root_split / "planes" / f"{idx}.txt"
        if not p.exists():
            return None
        plane = np.asarray([float(x) for x in p.read_text().splitlines()[3].split()])
        if plane[1] > 0:
            plane = -plane
        return plane / np.linalg.norm(plane[:3])

    def get_label(self, idx):
        return parse_label_file(str(self.root_split / "label_2" / f"{idx}.txt"))

    def frame_gt_annos(self, idx):
        """A frame's GT in the ``kitti_eval`` schema (cached)."""
        if idx not in self._gt_cache:
            label = self.get_label(idx)
            cam_boxes = np.concatenate(
                [label["loc"], label["dims_lhw"], label["rotation_y"][:, None]], axis=1)
            lidar = (boxes3d_kitti_camera_to_lidar(cam_boxes, self.get_calib(idx))
                     if len(cam_boxes) else np.zeros((0, 7), np.float32))
            self._gt_cache[idx] = {
                "name": label["name"],
                "truncated": label["truncated"],
                "occluded": label["occluded"],
                "bbox_height": (label["bbox"][:, 3] - label["bbox"][:, 1]
                                if len(label["bbox"]) else np.zeros(0)),
                "gt_boxes_lidar": lidar.astype(np.float32),
            }
        return self._gt_cache[idx]

    def __getitem__(self, index):
        self._reseed_for_item(index)
        idx = self.sample_ids[index]
        data = {"points": self.get_lidar(idx), "frame_id": idx}
        labelled = (self.root_split / "label_2" / f"{idx}.txt").exists()
        if labelled:
            gt = self.frame_gt_annos(idx)
            data["gt_names"] = gt["name"]
            data["gt_boxes"] = gt["gt_boxes_lidar"][:, :7]
        items = self.dataset_cfg.get("GET_ITEM_LIST", ["points"])
        if set(items) - {"points"}:
            calib = data["calib"] = self.get_calib(idx)
            if "images" in items:
                data["images"] = self.get_image(idx)
            if "calib_matricies" in items:
                data["trans_lidar_to_cam"], data["trans_cam_to_img"] = calib_to_matricies(calib)
            if "gt_boxes2d" in items and labelled:
                data["gt_boxes2d"] = self.get_label(idx)["bbox"]
        # the plane is read whatever GET_ITEM_LIST says, as the reference does
        plane = self.get_road_plane(idx)
        if plane is not None:
            data["road_plane"] = plane
        return self.prepare_data(data)

    def evaluation(self, det_annos, class_names, **kwargs):
        """KITTI AP (R40, BEV and 3D) of ``det_annos`` against the frames'
        labels; each frame's detections are projected to image boxes first,
        for the evaluator's 2D-height gate (a frame without calib keeps its
        detections valid)."""
        from .kitti_eval import kitti_evaluation

        gt_annos = [self.frame_gt_annos(a["frame_id"]) for a in det_annos]
        for a in det_annos:
            if "bbox" in a or not len(a.get("boxes_lidar", [])):
                continue
            try:
                calib = self.get_calib(a["frame_id"])
            except FileNotFoundError:
                continue
            cam = boxes3d_lidar_to_kitti_camera(np.asarray(a["boxes_lidar"])[:, :7], calib)
            a["bbox"] = boxes3d_kitti_camera_to_imageboxes(cam, calib)
        return kitti_evaluation(det_annos, gt_annos, class_names)
