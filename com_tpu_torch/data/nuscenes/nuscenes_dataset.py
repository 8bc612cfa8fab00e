"""nuScenes dataset (the port's copy of
``com_tpu/data/nuscenes/nuscenes_dataset.py``; pcdet
datasets/nuscenes/nuscenes_dataset.py role), host numpy.

Info-pkl driven: ``DATA_PATH/VERSION`` is the root, ``INFO_PATH`` names the
pkls of each mode.  An item fuses the key frame with ``MAX_SWEEPS - 1``
sweeps drawn at random from its info (ego points within 1 m removed from the
sweeps only, each moved into the key frame by its ``transform_matrix``,
its ``time_lag`` the fifth column), keeps GT with ``FILTER_MIN_POINTS_IN_GT``
lidar points or more, zeroes NaN velocities with
``SET_NAN_VELOCITY_TO_ZEROS`` and drops the velocity columns with
``PRED_VELOCITY: False``.  ``BALANCED_RESAMPLING`` (CBGS) duplicates the
training infos class by class, drawn from ``self.rng`` at construction.

Kept from ``com_tpu`` as it is: an item is never reseeded (no
``_reseed_for_item``), so the sweep choice and every augmentation draw
follow the calling thread's stream and an item depends on the order of the
calls before it.  ``evaluation`` tries the official path (the devkit is
imported there; the devkit call itself is declared unimplemented) and
falls back to KITTI-style AP on ImportError or NotImplementedError.
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ...utils.registry import DATASETS
from ..dataset import DatasetTemplate


@DATASETS.register
class NuScenesDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, db_infos=None, seed=None, infos=None):
        if root_path is None and dataset_cfg.get("DATA_PATH"):
            root_path = Path(dataset_cfg["DATA_PATH"]) / dataset_cfg.get(
                "VERSION", "v1.0-trainval")
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         db_infos=db_infos, seed=seed)
        self.infos = list(infos) if infos is not None else []
        if infos is None:
            self.include_nuscenes_data("train" if training else "test")
        if training and dataset_cfg.get("BALANCED_RESAMPLING", False):
            self.infos = self.balanced_infos_resampling(self.infos)

    def include_nuscenes_data(self, mode):
        for info_path in self.dataset_cfg.get("INFO_PATH", {}).get(mode, []):
            p = Path(self.root_path) / info_path
            if not p.exists():
                continue
            with open(p, "rb") as f:
                self.infos.extend(pickle.load(f))

    def balanced_infos_resampling(self, infos):
        """Class-balanced duplication (CBGS, nuscenes_dataset.py:39-74)."""
        if not self.class_names:
            return infos
        cls_infos = {name: [] for name in self.class_names}
        for info in infos:
            for name in set(info["gt_names"]):
                if name in self.class_names:
                    cls_infos[name].append(info)
        total = sum(len(v) for v in cls_infos.values())
        if total == 0:
            return infos
        frac = 1.0 / len(self.class_names)
        sampled = []
        for name, ci in cls_infos.items():
            if not ci:
                continue
            ratio = frac / (len(ci) / total)
            sampled += list(self.rng.choice(ci, int(len(ci) * ratio)))
        return sampled or infos

    @staticmethod
    def remove_ego_points(points, center_radius=1.0):
        mask = ~((np.abs(points[:, 0]) < center_radius)
                 & (np.abs(points[:, 1]) < center_radius))
        return points[mask]

    def get_sweep(self, sweep_info):
        lidar_path = Path(self.root_path) / sweep_info["lidar_path"]
        pts = np.fromfile(str(lidar_path), np.float32).reshape(-1, 5)[:, :4]
        pts = self.remove_ego_points(pts).T
        if sweep_info.get("transform_matrix") is not None:
            n = pts.shape[1]
            pts[:3] = sweep_info["transform_matrix"].dot(
                np.vstack((pts[:3], np.ones(n))))[:3]
        times = sweep_info["time_lag"] * np.ones((1, pts.shape[1]))
        return pts.T, times.T

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        info = self.infos[index]
        lidar_path = Path(self.root_path) / info["lidar_path"]
        points = np.fromfile(str(lidar_path), np.float32).reshape(-1, 5)[:, :4]
        sweep_points = [points]
        sweep_times = [np.zeros((points.shape[0], 1))]
        n_sw = len(info.get("sweeps", []))
        for k in self.rng.choice(n_sw, min(max_sweeps - 1, n_sw),
                                 replace=False):
            p, t = self.get_sweep(info["sweeps"][k])
            sweep_points.append(p)
            sweep_times.append(t)
        points = np.concatenate(sweep_points)
        times = np.concatenate(sweep_times).astype(points.dtype)
        return np.concatenate((points, times), axis=1)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        points = self.get_lidar_with_sweeps(
            index, max_sweeps=int(self.dataset_cfg.get("MAX_SWEEPS", 1)))
        input_dict = {
            "points": points,
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info.get("token")},
        }
        if "gt_boxes" in info:
            min_pts = self.dataset_cfg.get("FILTER_MIN_POINTS_IN_GT", False)
            if min_pts:
                mask = info["num_lidar_pts"] > int(min_pts) - 1
            else:
                mask = np.ones(len(info["gt_boxes"]), bool)
            input_dict["gt_names"] = np.asarray(info["gt_names"])[mask]
            input_dict["gt_boxes"] = np.asarray(info["gt_boxes"])[mask]

        data_dict = self.prepare_data(input_dict)

        if self.dataset_cfg.get("SET_NAN_VELOCITY_TO_ZEROS", False):
            gt = data_dict.get("gt_boxes")
            if gt is not None:
                gt[np.isnan(gt)] = 0
                data_dict["gt_boxes"] = gt
        if not self.dataset_cfg.get("PRED_VELOCITY", True) and \
                "gt_boxes" in data_dict and data_dict["gt_boxes"].shape[-1] > 8:
            data_dict["gt_boxes"] = data_dict["gt_boxes"][
                :, [0, 1, 2, 3, 4, 5, 6, -1]]
        return data_dict

    def evaluation(self, det_annos, class_names, **kwargs):
        """Official nuScenes eval when the devkit is importable, else the
        kitti-style AP fallback (nuscenes_dataset.py:153-207 role)."""
        try:
            return self._nuscenes_official_eval(det_annos, class_names, **kwargs)
        except (ImportError, NotImplementedError):
            # NotImplementedError: the official path assembles the devkit
            # inputs but the final NuScenesEval invocation is declared
            # unimplemented — the fallback must engage either way
            from ..kitti.kitti_eval import kitti_evaluation

            gt_annos = [copy.deepcopy(info.get("annos", {
                "gt_boxes_lidar": np.asarray(
                    info.get("gt_boxes", np.zeros((0, 7))))[:, :7],
                "name": np.asarray(info.get("gt_names", [])),
                "difficulty": np.zeros(len(info.get("gt_names", [])), np.int64),
            })) for info in self.infos]
            return kitti_evaluation(det_annos, gt_annos, class_names)

    def _nuscenes_official_eval(self, det_annos, class_names, **kwargs):
        from nuscenes.nuscenes import NuScenes  # the devkit, imported only here
        from . import nuscenes_utils

        nusc = NuScenes(version=self.dataset_cfg["VERSION"],
                        dataroot=str(self.root_path), verbose=True)
        nuscenes_utils.transform_det_annos_to_nusc_annos(det_annos, nusc)
        raise NotImplementedError(
            "official nuScenes evaluation requires running the devkit "
            "NuScenesEval on the serialized results; see nuscenes_utils"
        )
