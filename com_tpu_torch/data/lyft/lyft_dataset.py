"""Lyft Level-5 dataset (the port's copy of
``com_tpu/data/lyft/lyft_dataset.py``; pcdet datasets/lyft/lyft_dataset.py
role), host numpy.

Info-pkl driven with the nuScenes schema (the Lyft devkit shares it), the
root ``DATA_PATH``.  An item fuses the key frame with the first
``MAX_SWEEPS - 1`` sweeps of its info in order (no random choice and no
ego-point removal, unlike nuScenes), each moved by its
``transform_matrix``, ``time_lag`` the fifth column.  ``evaluation`` with
``eval_metric == "kitti"`` gives KITTI-style AP, with anything else the
Lyft mAP (``lyft_eval``) over ``EVAL_LYFT_IOU_LIST``, devkit-free.  Kept
from ``com_tpu``: an item is never reseeded (as ``NuScenesDataset``).
"""
from __future__ import annotations

import copy
import pickle
from pathlib import Path

import numpy as np

from ...utils.registry import DATASETS
from ..dataset import DatasetTemplate


@DATASETS.register
class LyftDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, db_infos=None, seed=None, infos=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         db_infos=db_infos, seed=seed)
        self.infos = list(infos) if infos is not None else []
        if infos is None:
            mode = "train" if training else "test"
            for info_path in dataset_cfg.get("INFO_PATH", {}).get(mode, []):
                p = Path(self.root_path) / info_path
                if p.exists():
                    with open(p, "rb") as f:
                        self.infos.extend(pickle.load(f))

    def get_lidar_with_sweeps(self, index, max_sweeps=1):
        info = self.infos[index]
        lidar_path = Path(self.root_path) / info["lidar_path"]
        # Lyft lidar is (N, 5) float32 like nuScenes
        points = np.fromfile(str(lidar_path), np.float32).reshape(-1, 5)[:, :4]
        sweep_points = [points]
        sweep_times = [np.zeros((points.shape[0], 1))]
        for sweep in info.get("sweeps", [])[: max_sweeps - 1]:
            pts = np.fromfile(str(Path(self.root_path) / sweep["lidar_path"]),
                              np.float32).reshape(-1, 5)[:, :4]
            if sweep.get("transform_matrix") is not None:
                n = pts.shape[0]
                pts[:, :3] = sweep["transform_matrix"].dot(
                    np.vstack((pts[:, :3].T, np.ones(n))))[:3].T
            sweep_points.append(pts)
            sweep_times.append(sweep["time_lag"] * np.ones((pts.shape[0], 1)))
        points = np.concatenate(sweep_points)
        times = np.concatenate(sweep_times).astype(points.dtype)
        return np.concatenate((points, times), axis=1)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        points = self.get_lidar_with_sweeps(
            index, int(self.dataset_cfg.get("MAX_SWEEPS", 1)))
        input_dict = {
            "points": points,
            "frame_id": Path(info["lidar_path"]).stem,
            "metadata": {"token": info.get("token")},
        }
        if "gt_boxes" in info:
            input_dict["gt_names"] = np.asarray(info["gt_names"])
            input_dict["gt_boxes"] = np.asarray(info["gt_boxes"])
        return self.prepare_data(input_dict)

    def evaluation(self, det_annos, class_names, **kwargs):
        """Eval dispatch (reference lyft_dataset.py:134-149): 'lyft' runs the
        official mAP loop (devkit-free here — IoU is invariant under the
        lidar->global rigid transform, so lidar-frame eval matches the
        reference's global-frame numbers), 'kitti' the KITTI-style AP."""
        if (kwargs.get("eval_metric") or "lyft") == "kitti":
            from ..kitti.kitti_eval import kitti_evaluation

            gt_annos = [{
                "gt_boxes_lidar": np.asarray(
                    info.get("gt_boxes", np.zeros((0, 7))))[:, :7],
                "name": np.asarray(info.get("gt_names", [])),
                "difficulty": np.zeros(len(info.get("gt_names", [])), np.int64),
            } for info in self.infos]
            return kitti_evaluation(det_annos, gt_annos, class_names)
        return self.lyft_eval(
            det_annos, class_names,
            iou_thresholds=list(
                self.dataset_cfg.get("EVAL_LYFT_IOU_LIST", [0.5])))

    def lyft_eval(self, det_annos, class_names, iou_thresholds=(0.5,)):
        """Official Lyft mAP (reference lyft_dataset.py:145-149 +
        lyft_mAP_eval), matched by sample token against the info gt."""
        from .lyft_eval import format_lyft_results, get_average_precisions

        # key by sample token AND lidar-file stem so det_annos that carry
        # only frame_id (eval_model's output) still match their gt frame
        gt_by_token = {}
        for info in self.infos:
            gt_by_token[info.get("token")] = info
            if info.get("lidar_path"):
                gt_by_token.setdefault(Path(info["lidar_path"]).stem, info)
        gt_boxes, pred_boxes = [], []
        seen_tokens = set()
        for anno in det_annos:
            # dict.get's default only covers a MISSING key — metadata with
            # token=None must still fall back to frame_id or every frame
            # keys to None and scores against one frame's GT
            token = anno.get("metadata", {}).get("token") or anno.get("frame_id")
            if token in seen_tokens:
                # wrap-padded multi-process eval repeats trailing samples;
                # double-counting a frame's GT inflates the recall
                # denominator and lets two predictions claim one object
                continue
            seen_tokens.add(token)
            boxes = np.asarray(anno["boxes_lidar"])
            for i in range(len(boxes)):
                pred_boxes.append({
                    "sample_token": token,
                    "box": boxes[i, :7].astype(np.float64),
                    "name": str(np.asarray(anno["name"])[i]),
                    "score": float(np.asarray(anno["score"])[i]),
                })
            info = gt_by_token.get(token)
            if info is None:
                continue
            g = np.asarray(info.get("gt_boxes", np.zeros((0, 7))))
            names = np.asarray(info.get("gt_names", []))
            for i in range(len(g)):
                gt_boxes.append({
                    "sample_token": token,
                    "box": g[i, :7].astype(np.float64),
                    "name": str(names[i]),
                })
        aps = get_average_precisions(
            gt_boxes, pred_boxes, class_names, list(iou_thresholds))
        return format_lyft_results(
            aps, class_names, list(iou_thresholds),
            version=self.dataset_cfg.get("VERSION", "trainval"))
