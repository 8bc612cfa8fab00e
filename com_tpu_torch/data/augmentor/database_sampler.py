"""GT-database paste augmentation and the COM curriculum samplers (the port's
copy of ``com_tpu/data/augmentor/database_sampler.py``), host numpy.

* ``DataBaseSampler``: OpenPCDet GT-Aug (database_sampler.py:16-554):
  class-balanced round-robin sampling from a GT database, BEV-IoU collision
  rejection, carve-out and paste of object points, carrying the COM side
  arrays.
* ``DataBaseSamplerV2``: 3-way density grouping with an equal-share draw
  (database_sampler_v2.py:137-210); pasted objects are tagged
  ``true_object=2``.
* ``DataBaseSamplerCOM1/COM2``: the curriculum samplers
  (database_sampler_curriculum.py:17-278).  The database is clustered into
  difficulty groups (Vehicle 3x2x4x4 = 96, Pedestrian/Cyclist 3x5 = 15);
  COM2 draws groups from a Gaussian over per-group *confidences* fed back
  from the device each epoch, with pacing k = epoch * M3[class], variance
  S3[class], ANTI (easy -> hard), BACK (restart at epoch 26) and STOP
  (fade-out).

``epoch`` and ``confidence_groups`` are the host half of the device -> host
curriculum feedback: ``train.loop.train_model`` sets the confidences at each
epoch's end through ``DatasetTemplate.set_confidence_groups``.  The round-
robin ``pointer``/``indices`` of ``sample_groups`` are shared by every
loader worker thread, as in ``com_tpu``, so with several workers the draws
depend on thread timing.  ``USE_ROAD_PLANE`` lifts the pasted boxes and
their points onto the frame's road plane (``put_boxes_on_road_planes``).
``IMG_AUG_TYPE: kitti`` adds the KITTI image copy-paste
(database_sampler.py:180-374) on an item with ``images`` and ``calib``:
the sampled boxes lifted to the road, projected, and dropped where their
2D IoU with the scene's boxes or each other reaches ``IMG_AUG_IOU_THRESH``;
each survivor's points and box moved through its donor frame's calibration
into this one, its donor crop pasted far to near, and the scene's points
that a pasted crop now hides removed.  The donor's calib and image come
from the info (``calib``, ``image``) or the tree (``training/calib``,
``training/image_2``, by ``image_idx``; ``bbox`` is its image box).
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ...ops.host_boxes import boxes_to_corners_3d, enlarge_box3d, remove_points_in_boxes3d
from ...ops.host_native import boxes_iou_bev_native
from ..kitti.calibration import (Calibration, boxes3d_kitti_camera_to_imageboxes,
                                 boxes3d_kitti_camera_to_lidar, boxes3d_lidar_to_kitti_camera,
                                 corners_rect_to_camera, pairwise_iou_2d)
from ..kitti.png import read_png
from ..processor import GT_SIDE_KEYS


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None,
                 db_infos=None, rng=None):
        self.root_path = Path(root_path) if root_path is not None else None
        self.sampler_cfg = sampler_cfg
        self.class_names = list(class_names)
        self.logger = logger
        self.rng = rng if rng is not None else np.random
        self.epoch = 0
        self.confidence_groups = None

        self.db_infos = {c: [] for c in class_names}
        if db_infos is not None:
            for c in class_names:
                self.db_infos[c] = list(db_infos.get(c, []))
        else:
            for db_info_path in sampler_cfg.get("DB_INFO_PATH", []):
                with open(self.root_path / db_info_path, "rb") as f:
                    infos = pickle.load(f)
                for c in class_names:
                    self.db_infos[c].extend(infos.get(c, []))

        for func_name, val in sampler_cfg.get("PREPARE", {}).items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.limit_whole_scene = sampler_cfg.get("LIMIT_WHOLE_SCENE", False)
        self.img_aug_type = sampler_cfg.get("IMG_AUG_TYPE", None)
        self.img_aug_iou_thresh = float(sampler_cfg.get("IMG_AUG_IOU_THRESH", 0.5))
        self.sample_class_num = {}
        self.sample_groups = {}
        for x in sampler_cfg["SAMPLE_GROUPS"]:
            class_name, sample_num = x.split(":")
            if class_name not in class_names:
                continue
            self.sample_class_num[class_name] = int(sample_num)
            self.sample_groups[class_name] = self.make_sample_group(class_name, int(sample_num))

    # --- database filtering (PREPARE) ---
    def filter_by_difficulty(self, db_infos, removed_difficulty):
        return {key: [i for i in infos if i.get("difficulty", 0) not in removed_difficulty]
                for key, infos in db_infos.items()}

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for spec in min_gt_points_list:
            name, min_num = spec.split(":")
            min_num = int(min_num)
            if min_num > 0 and name in db_infos:
                db_infos[name] = [i for i in db_infos[name] if i["num_points_in_gt"] >= min_num]
        return db_infos

    # --- sampling ---
    def make_sample_group(self, class_name, sample_num):
        return {"sample_num": sample_num, "pointer": len(self.db_infos[class_name]),
                "indices": np.arange(len(self.db_infos[class_name]))}

    def sample_with_fixed_number(self, class_name, sample_group):
        """Round-robin pointer sampling with a reshuffle when the pointer has
        run past the database (database_sampler.py:138-157): the draw before
        a reshuffle may be shorter than sample_num, and each reshuffle is one
        ``permutation`` call."""
        sample_num = int(sample_group["sample_num"])
        pointer, indices = sample_group["pointer"], sample_group["indices"]
        infos = self.db_infos[class_name]
        if len(infos) == 0:
            return []
        if pointer >= len(infos):
            indices = self.rng.permutation(len(infos))
            pointer = 0
        sampled = [infos[i] for i in indices[pointer: pointer + sample_num]]
        sample_group["pointer"] = pointer + sample_num
        sample_group["indices"] = indices
        return sampled

    # --- scene assembly ---
    def _load_obj_points(self, info):
        """An object's points from its database file (box-relative xyz,
        f32 or f64 rows of NUM_POINT_FEATURES), moved to the box."""
        path = self.root_path / info["path"]
        num_features = int(self.sampler_cfg.get("NUM_POINT_FEATURES", 5))
        pts = np.fromfile(str(path), dtype=np.float32).reshape(-1, num_features)
        if pts.shape[0] != info["num_points_in_gt"]:
            pts = np.fromfile(str(path), dtype=np.float64).reshape(-1, num_features)
        pts = pts.astype(np.float32)
        pts[:, :3] += info["box3d_lidar"][:3].astype(np.float32)
        return pts

    @staticmethod
    def put_boxes_on_road_planes(gt_boxes, road_plane, calib=None):
        """Drop boxes onto the road plane (database_sampler.py:161-178).
        With a KITTI ``calib`` the plane (a, b, c, d) is in the rect camera
        frame; without one it is read as a lidar-frame plane a x + b y + c z
        + d = 0, as ``com_tpu`` does for an item without calib (a KITTI
        plane read so moves a box tens of metres off the road).  Returns
        (boxes, mv_height): the new boxes and how far each moved down."""
        boxes = gt_boxes.copy()
        a, b, c, d = road_plane
        if calib is not None:
            center_cam = calib.lidar_to_rect(boxes[:, 0:3])
            center_cam[:, 1] = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
            road_z = calib.rect_to_lidar(center_cam)[:, 2]
        else:
            road_z = (-d - a * boxes[:, 0] - b * boxes[:, 1]) / c
        mv_height = boxes[:, 2] - boxes[:, 5] / 2 - road_z
        boxes[:, 2] -= mv_height
        return boxes, mv_height

    # ---- the KITTI image copy-paste (IMG_AUG_TYPE: kitti) ----

    def _donor_calib_and_image(self, info):
        """The donor frame's calibration and image (0-255 floats): from the
        info when it carries them, else ``training/calib`` and
        ``training/image_2`` by ``image_idx`` (collect_image_crops_kitti)."""
        if isinstance(info.get("calib"), Calibration):
            calib = info["calib"]
        elif "calib" in info:
            calib = Calibration(info["calib"])
        else:
            calib = Calibration(str(self.root_path / "training" / "calib"
                                    / f"{int(info['image_idx']):06d}.txt"))
        if "image" in info:
            image = np.asarray(info["image"], np.float32)
        else:
            image = read_png(self.root_path / "training" / "image_2"
                             / f"{int(info['image_idx']):06d}.png").astype(np.float32)
        return calib, image

    def _sample_boxes_2d_kitti(self, data_dict, sampled_boxes):
        """Road-plane lift, projection and the 2D-IoU prefilter against the
        scene's boxes and the other samples (sample_gt_boxes_2d_kitti):
        (boxes, boxes2d, mv_height or None, keep)."""
        mv_height = None
        if self.sampler_cfg.get("USE_ROAD_PLANE", False) and "road_plane" in data_dict:
            sampled_boxes, mv_height = self.put_boxes_on_road_planes(
                sampled_boxes, data_dict["road_plane"], data_dict.get("calib"))
        calib = data_dict["calib"]
        cam = boxes3d_lidar_to_kitti_camera(sampled_boxes[:, :7], calib)
        boxes2d = boxes3d_kitti_camera_to_imageboxes(cam, calib, data_dict["images"].shape[:2])
        iou1 = pairwise_iou_2d(boxes2d, data_dict.get("gt_boxes2d", np.zeros((0, 4))))
        iou2 = pairwise_iou_2d(boxes2d, boxes2d)
        np.fill_diagonal(iou2, 0)
        m1 = iou1.max(axis=1) if iou1.shape[1] else iou2.max(axis=1)
        keep = (m1 < self.img_aug_iou_thresh) & (iou2.max(axis=1) < self.img_aug_iou_thresh)
        return sampled_boxes, boxes2d, mv_height, keep

    def _collect_image_crop_kitti(self, info, data_dict, obj_points, box3d, box2d):
        """The donor's points and box carried through its calibration into
        this frame's, and its image cropped around its donor box at the new
        box's size (clipped; on a clip the new box shrinks to the crop)
        (collect_image_crops_kitti, 'point_refine').  Returns (new box2d
        int, crop in [0, 1], points, box3d)."""
        calib = data_dict["calib"]
        donor_calib, donor_image = self._donor_calib_and_image(info)
        pts_2d, depth = donor_calib.lidar_to_img(obj_points[:, :3])
        obj_points = obj_points.copy()
        obj_points[:, :3] = calib.rect_to_lidar(calib.img_to_rect(pts_2d[:, 0], pts_2d[:, 1],
                                                                  depth))
        corners = boxes_to_corners_3d(box3d[None, :7])[0]
        c2d, cd = donor_calib.lidar_to_img(corners)
        cam_box = corners_rect_to_camera(calib.img_to_rect(c2d[:, 0], c2d[:, 1], cd))[None]
        box3d = np.concatenate([boxes3d_kitti_camera_to_lidar(cam_box, calib)[0], box3d[7:]])
        box2d = boxes3d_kitti_camera_to_imageboxes(cam_box, calib,
                                                   data_dict["images"].shape[:2])[0]
        new_box = box2d.astype(np.int64)
        raw_center = np.asarray(info["bbox"], np.float64).reshape(2, 2).mean(0)
        new_shape = np.array([new_box[2] - new_box[0], new_box[3] - new_box[1]])
        raw_box = np.concatenate([raw_center - new_shape / 2,
                                  raw_center + new_shape / 2]).astype(np.int64)
        raw_box[0::2] = np.clip(raw_box[0::2], 0, donor_image.shape[1])
        raw_box[1::2] = np.clip(raw_box[1::2], 0, donor_image.shape[0])
        if (raw_box[2] - raw_box[0]) != new_shape[0] or (raw_box[3] - raw_box[1]) != new_shape[1]:
            new_center = new_box.reshape(2, 2).mean(0)
            new_shape = np.array([raw_box[2] - raw_box[0], raw_box[3] - raw_box[1]])
            new_box = np.concatenate([new_center - new_shape / 2,
                                      new_center + new_shape / 2]).astype(np.int64)
        crop = donor_image[raw_box[1]:raw_box[3], raw_box[0]:raw_box[2]] / 255.0
        return new_box, crop, obj_points, box3d

    def _paste_crops_to_image_kitti(self, data_dict, crops, gt_number, point_idxes):
        """Paste the crops far to near and keep a point where it projects
        onto its own pasted object, onto an original box's region still
        owned by an original box, or onto untouched background
        (copy_paste_to_image_kitti, by depth, 'annotation').  Returns
        (data_dict, keep)."""
        image = data_dict["images"]
        boxes2d = np.asarray(data_dict["gt_boxes2d"], np.int64)
        paste_order = data_dict["gt_boxes"][:, 0].argsort()[::-1]  # far first
        paste_mask = -255 * np.ones(image.shape[:2], np.int64)
        fg_mask = np.zeros(image.shape[:2], np.int64)
        pts_2d, _ = data_dict["calib"].lidar_to_img(data_dict["points"][:, :3])
        pts_2d[:, 0] = np.clip(pts_2d[:, 0], 0, image.shape[1] - 1)
        pts_2d[:, 1] = np.clip(pts_2d[:, 1], 0, image.shape[0] - 1)
        pts_2d = pts_2d.astype(np.int64)
        h_img, w_img = image.shape[:2]
        for o in paste_order:
            x1, y1, x2, y2 = boxes2d[o]
            # the region clipped to the image, the crop to the region (the
            # centre +- half-size truncation can leave them a pixel apart)
            x1c, y1c = max(int(x1), 0), max(int(y1), 0)
            x2c, y2c = min(int(x2), w_img), min(int(y2), h_img)
            crop = crops[o][y1c - y1:, x1c - x1:]
            rh, rw = min(y2c - y1c, crop.shape[0]), min(x2c - x1c, crop.shape[1])
            if rh <= 0 or rw <= 0:
                continue
            image[y1c:y1c + rh, x1c:x1c + rw] = crop[:rh, :rw]
            paste_mask[y1c:y1c + rh, x1c:x1c + rw] = o
            if o < gt_number:
                fg_mask[y1c:y1c + rh, x1c:x1c + rw] = 1
        data_dict["images"] = image
        new_mask = paste_mask[pts_2d[:, 1], pts_2d[:, 0]] == (point_idxes + gt_number)
        raw_fg = (fg_mask == 1) & (paste_mask >= 0) & (paste_mask < gt_number)
        raw_bg = (fg_mask == 0) & (paste_mask < 0)
        keep = new_mask | raw_fg[pts_2d[:, 1], pts_2d[:, 0]] | raw_bg[pts_2d[:, 1], pts_2d[:, 0]]
        data_dict["points"] = data_dict["points"][keep]
        data_dict["points_2d"] = pts_2d[keep]
        return data_dict, keep

    def add_sampled_boxes_to_scene(self, data_dict, sampled_boxes, sampled_infos):
        gt_mask = data_dict["gt_boxes_mask"]
        gt_boxes = data_dict["gt_boxes"][gt_mask]
        gt_names = data_dict["gt_names"][gt_mask]
        side = {k: data_dict[k][gt_mask] for k in GT_SIDE_KEYS if k in data_dict}

        img_aug = (self.img_aug_type == "kitti" and "images" in data_dict
                   and data_dict.get("calib") is not None)
        mv_height = None
        if img_aug:
            sampled_boxes, sampled_boxes2d, mv_height, keep2d = self._sample_boxes_2d_kitti(
                data_dict, sampled_boxes)
            sampled_boxes, sampled_boxes2d = sampled_boxes[keep2d], sampled_boxes2d[keep2d]
            if mv_height is not None:
                mv_height = mv_height[keep2d]
            sampled_infos = [info for info, k in zip(sampled_infos, keep2d) if k]
        elif self.sampler_cfg.get("USE_ROAD_PLANE", False) and "road_plane" in data_dict:
            sampled_boxes, mv_height = self.put_boxes_on_road_planes(
                sampled_boxes, data_dict["road_plane"], data_dict.get("calib"))

        points = data_dict["points"]
        obj_points = [info.get("points", None) if "points" in info else self._load_obj_points(info)
                      for info in sampled_infos]
        if mv_height is not None:  # each object's points go down with its box
            for i, p in enumerate(obj_points):
                if p is not None:
                    p = p.copy()
                    p[:, 2] -= mv_height[i]
                    obj_points[i] = p
        crops, crop_boxes2d, obj_idx_list = [], [], []
        if img_aug:
            # point-less entries leave every parallel array first, so that the
            # paste indices stay aligned with the boxes and infos
            has_pts = np.array([p is not None for p in obj_points], bool)
            if not has_pts.all():
                obj_points = [p for p in obj_points if p is not None]
                sampled_boxes, sampled_boxes2d = sampled_boxes[has_pts], sampled_boxes2d[has_pts]
                sampled_infos = [info for info, k in zip(sampled_infos, has_pts) if k]
            for i, p in enumerate(obj_points):
                nb, crop, p, b3d = self._collect_image_crop_kitti(
                    sampled_infos[i], data_dict, p, sampled_boxes[i], sampled_boxes2d[i])
                obj_points[i] = p
                sampled_boxes[i] = b3d[: sampled_boxes.shape[1]]
                crops.append(crop)
                crop_boxes2d.append(nb)
                obj_idx_list.append(np.full(len(p), len(crops) - 1, np.int64))
        obj_points = [p for p in obj_points if p is not None]
        obj_points = (np.concatenate(obj_points, axis=0) if obj_points
                      else np.zeros((0, points.shape[1]), np.float32))

        gt_number = len(gt_boxes)
        gt_crops2d, gt_boxes2d_int = [], np.zeros((0, 4), np.int64)
        if img_aug:
            # the scene's own boxes' crops, copied from the image before the paste
            gt_boxes2d_int = np.asarray(data_dict.get("gt_boxes2d", np.zeros((0, 4)))
                                        )[gt_mask].astype(np.int64)
            gt_crops2d = [data_dict["images"][b[1]:b[3], b[0]:b[2]].copy()
                          for b in gt_boxes2d_int]

        big = enlarge_box3d(sampled_boxes[:, :7],
                            self.sampler_cfg.get("REMOVE_EXTRA_WIDTH", [0.0, 0.0, 0.0]))
        points = remove_points_in_boxes3d(points, big)
        points = np.concatenate([obj_points[:, : points.shape[1]], points], axis=0)
        data_dict["points"] = points
        data_dict["gt_boxes"] = np.concatenate(
            [gt_boxes, sampled_boxes[:, : gt_boxes.shape[1]]], axis=0)
        data_dict["gt_names"] = np.concatenate(
            [gt_names, np.array([i["name"] for i in sampled_infos])])
        if img_aug:
            # the pasted objects' points lead the concatenation; the scene's get -1
            obj_idx = np.concatenate(obj_idx_list) if obj_idx_list else np.zeros(0, np.int64)
            point_idxes = -np.ones(len(points), np.int64)
            point_idxes[: len(obj_idx)] = obj_idx
            data_dict["gt_boxes2d"] = np.concatenate([
                gt_boxes2d_int.astype(np.float32),
                np.asarray(crop_boxes2d, np.float32).reshape(-1, 4)])
            data_dict, _ = self._paste_crops_to_image_kitti(data_dict, gt_crops2d + crops,
                                                            gt_number, point_idxes)
            data_dict.pop("road_plane", None)
        n_s = len(sampled_infos)
        defaults = {
            "num_points_in_gt": np.array([i["num_points_in_gt"] for i in sampled_infos],
                                         np.float32),
            # pasted objects are tagged 2 (database_sampler_v2.py:517)
            "true_object": np.full(n_s, 2, np.float32),
            "occupancy_ratio": np.array([i.get("occupancy_ratio", 0.0) for i in sampled_infos],
                                        np.float32),
            "facade_type": np.array([i.get("facade_type", 0) for i in sampled_infos],
                                    np.float32),
        }
        for k, arr in side.items():
            data_dict[k] = np.concatenate([arr, defaults[k]])
        return data_dict

    def _sample_for_class(self, class_name, sample_group):
        return self.sample_with_fixed_number(class_name, sample_group)

    def __call__(self, data_dict):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"].astype(str)
        existed = gt_boxes
        total_sampled = []
        for class_name, sample_group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = int(np.sum(class_name == gt_names))
                sample_group["sample_num"] = self.sample_class_num[class_name] - num_gt
            if int(sample_group["sample_num"]) <= 0:
                continue
            sampled = self._sample_for_class(class_name, sample_group)
            if not sampled:
                continue
            boxes = np.stack([x["box3d_lidar"] for x in sampled]).astype(np.float32)
            iou1 = boxes_iou_bev_native(boxes[:, :7], existed[:, :7]) if len(existed) else None
            iou2 = boxes_iou_bev_native(boxes[:, :7], boxes[:, :7])
            np.fill_diagonal(iou2, 0)
            max1 = iou1.max(axis=1) if iou1 is not None and iou1.shape[1] else iou2.max(axis=1)
            keep_idx = np.where((max1 + iou2.max(axis=1)) == 0)[0]
            existed = np.concatenate([existed, boxes[keep_idx][:, : existed.shape[1]]], axis=0)
            total_sampled.extend(sampled[i] for i in keep_idx)

        if total_sampled:
            data_dict = self.add_sampled_boxes_to_scene(data_dict, existed[len(gt_boxes):],
                                                        total_sampled)
        data_dict.pop("gt_boxes_mask", None)
        return data_dict


def split_difficulty_groups(db_infos, class_name):
    """Cluster a class's database into COM difficulty groups
    (database_sampler_curriculum.py:34-106): Vehicle = 3 distance x 2 length
    x 4 facade x 4 occupancy = 96 groups; Pedestrian/Cyclist = 3 distance x 5
    occupancy = 15, their occupancies scaled by 12/5 before thresholding.
    Objects beyond 75 m fall in no group.  Returns one index array a group.
    """
    infos = db_infos[class_name]
    if len(infos) == 0:
        n = 96 if class_name == "Vehicle" else 15
        return [np.zeros(0, np.int64) for _ in range(n)]
    box = np.stack([i["box3d_lidar"] for i in infos])
    dist = np.sqrt(box[:, 0] ** 2 + box[:, 1] ** 2)
    length = box[:, 3]
    occ = np.array([i.get("occupancy_ratio", 0.0) for i in infos], np.float64)
    facade = np.array([i.get("facade_type", 0) for i in infos], np.int64)
    if class_name in ("Pedestrian", "Cyclist"):
        occ = occ * 12.0 / 5.0

    dist_bins = [(dist <= 30), (dist > 30) & (dist <= 50), (dist > 50) & (dist <= 75)]
    groups = []
    if class_name == "Vehicle":
        length_bins = [(length <= 6), (length > 6)]
        facade_bins = [(facade == 3), (facade == 2), (facade == 1), (facade == 0)]
        occ_bins = [(occ > 0.7), (occ > 0.5) & (occ <= 0.7),
                    (occ > 0.25) & (occ <= 0.5), (occ <= 0.25)]
        for d in dist_bins:
            for le in length_bins:
                for f in facade_bins:
                    for o in occ_bins:
                        groups.append(np.where(d & le & f & o)[0])
    else:
        occ_bins = [(occ > 0.81), (occ > 0.61) & (occ <= 0.81),
                    (occ > 0.41) & (occ <= 0.61), (occ > 0.21) & (occ <= 0.41),
                    (occ <= 0.21)]
        for d in dist_bins:
            for o in occ_bins:
                groups.append(np.where(d & o)[0])
    return groups


def split_density_groups(db_infos, class_name):
    """The V2 3-way split (database_sampler_v2.py:137-178): three distance
    bands (<= 30 / 30-50 / > 50 m); within each band, only objects whose
    point density (num_points_in_gt / box volume) exceeds the band's
    1/3-quantile."""
    infos = db_infos[class_name]
    if len(infos) == 0:
        return [np.zeros(0, np.int64) for _ in range(3)]
    box = np.stack([i["box3d_lidar"] for i in infos])
    dist = np.sqrt(box[:, 0] ** 2 + box[:, 1] ** 2)
    npts = np.array([i["num_points_in_gt"] for i in infos], np.float64)
    volume = box[:, 3] * box[:, 4] * box[:, 5]
    density = npts / np.clip(volume, 1e-6, None)

    groups = []
    for band in [(dist <= 30), (dist > 30) & (dist <= 50), (dist > 50)]:
        band_density = density[band]
        if len(band_density) == 0:
            groups.append(np.zeros(0, np.int64))
            continue
        threshold = np.sort(band_density)[int(len(band_density) * 1 / 3)]
        groups.append(np.where(band & (density > threshold))[0])
    return groups


class DataBaseSamplerV2(DataBaseSampler):
    """Density-filtered 3-group GT-Aug with an equal-share round-robin draw
    (database_sampler_v2.py:137-210)."""

    def make_sample_group(self, class_name, sample_num):
        indices_list = self.split_groups(class_name)
        return {"sample_num": sample_num, "pointer": [len(g) for g in indices_list],
                "indices": indices_list}

    def split_groups(self, class_name):
        return split_density_groups(self.db_infos, class_name)

    def _sample_for_class(self, class_name, sample_group):
        """int(total / num_groups) + 1 from each group: a contiguous pointer
        slice, permuted on wrap (database_sampler_v2.py:183-211)."""
        total_num = int(sample_group["sample_num"])
        num_groups = len(sample_group["indices"])
        per_group = int(total_num / num_groups) + 1
        sampled = []
        for g in range(num_groups):
            pointer = sample_group["pointer"][g]
            indices = sample_group["indices"][g]
            if len(indices) == 0:
                continue
            if pointer >= len(indices):
                indices = self.rng.permutation(indices)
                pointer = 0
            sampled.extend(self.db_infos[class_name][i]
                           for i in indices[pointer: pointer + per_group])
            sample_group["pointer"][g] = pointer + per_group
            sample_group["indices"][g] = indices
        return sampled


class DataBaseSamplerCOM1(DataBaseSamplerV2):
    """COM1: the 96/15 difficulty groups, a group-size-proportional draw one
    object at a time (database_sampler_curriculum.py:34-150; no confidence
    feedback)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cfg = self.sampler_cfg
        self.s3 = list(cfg.get("S3", [0.1, 0.1, 0.1]))
        self.m3 = list(cfg.get("M3", [1.5, 0.3, 0.3]))
        self.anti = bool(cfg.get("ANTI", False))
        self.back = bool(cfg.get("BACK", False))
        self.stop = cfg.get("STOP", None)
        self.ave_epoch = int(cfg.get("AVE", 100))

    def split_groups(self, class_name):
        return split_difficulty_groups(self.db_infos, class_name)

    def group_probability(self, class_name, sample_group):
        sizes = np.array([len(g) for g in sample_group["indices"]], np.float64)
        total = sizes.sum()
        if total == 0:
            return None
        return sizes / total

    def _sample_for_class(self, class_name, sample_group):
        total_num = int(sample_group["sample_num"])
        prob = self.group_probability(class_name, sample_group)
        if prob is None:
            return []
        group_ids = self.rng.choice(len(prob), total_num, p=prob, replace=True)
        sampled = []
        for g in group_ids:
            pointer = sample_group["pointer"][g]
            indices = sample_group["indices"][g]
            if len(indices) == 0:
                continue
            if pointer >= len(indices):
                indices = self.rng.permutation(indices)
                pointer = 0
            sampled.append(self.db_infos[class_name][indices[pointer]])
            sample_group["pointer"][g] = pointer + 1
            sample_group["indices"][g] = indices
        return sampled


class DataBaseSamplerCOM2(DataBaseSamplerCOM1):
    """COM2: curriculum sampling by a Gaussian over the groups' confidences
    (database_sampler_curriculum.py:151-278)."""

    CLASS_SLOT = {"Vehicle": 0, "Pedestrian": 1, "Cyclist": 2}

    def pacing(self, class_name, group_num):
        """(k, u): the pacing index ``int(epoch * M3)`` (from epoch 26 with
        BACK), capped at the last group, and the Gaussian's centre, the k-th
        smallest confidence of the class with ANTI, else the k-th largest."""
        conf = np.asarray(self.confidence_groups)
        # confidence rows follow the ACTIVE class_names order (the loss
        # accumulates by global class id)
        active = getattr(self, "class_names", None) or list(self.CLASS_SLOT)
        slot = active.index(class_name) if class_name in active else 0
        confidence = conf[min(slot, conf.shape[0] - 1)][:group_num]
        # M3/S3 stay indexed by the fixed taxonomy slot (reference :209)
        ci = self.CLASS_SLOT.get(class_name, 0)
        if self.back and self.epoch > 26:
            k = min(int((self.epoch - 26) * self.m3[ci]), group_num - 1)
        else:
            k = min(int(self.epoch * self.m3[ci]), group_num - 1)
        srt = np.sort(confidence)
        return k, (srt[k] if self.anti else srt[::-1][k]), confidence

    def group_probability(self, class_name, sample_group):
        sizes = np.array([len(g) for g in sample_group["indices"]], np.float64)
        total = sizes.sum()
        if total == 0:
            return None
        norm = sizes / total
        if self.confidence_groups is None or self.epoch > self.ave_epoch:
            return norm / norm.sum()
        _, u, confidence = self.pacing(class_name, len(sizes))
        sigma = np.sqrt(self.s3[self.CLASS_SLOT.get(class_name, 0)])
        pdf = np.exp(-((confidence - u) ** 2) / (2 * sigma**2)) / (np.sqrt(2 * np.pi) * sigma)
        weighted = pdf * norm
        if weighted.sum() <= 0:
            return norm / norm.sum()
        return weighted / weighted.sum()

    def _sample_for_class(self, class_name, sample_group):
        if self.stop is not None and self.epoch >= int(self.stop):
            # GT-Aug fades out, but only after the group draw, as the
            # reference returns (database_sampler_curriculum.py:255-260), so
            # the RNG stream stays aligned
            prob = self.group_probability(class_name, sample_group)
            if prob is not None:
                self.rng.choice(len(prob), int(sample_group["sample_num"]), p=prob, replace=True)
            return []
        return super()._sample_for_class(class_name, sample_group)


def build_gt_sampler(root_path, sampler_cfg, class_names, logger=None, db_infos=None, rng=None):
    """The reference's dispatch (data_augmentor.py:27-54): USE_CURRICULUM_AUG
    with COM -> COM2, with V2 -> V2, else COM1; without it the base sampler."""
    kw = dict(root_path=root_path, sampler_cfg=sampler_cfg, class_names=class_names,
              logger=logger, db_infos=db_infos, rng=rng)
    if sampler_cfg.get("USE_CURRICULUM_AUG", False):
        if sampler_cfg.get("COM", False):
            return DataBaseSamplerCOM2(**kw)
        if sampler_cfg.get("V2", False):
            return DataBaseSamplerV2(**kw)
        return DataBaseSamplerCOM1(**kw)
    return DataBaseSampler(**kw)
