"""Pandaset dataset (the port's copy of
``com_tpu/data/pandaset/pandaset_dataset.py``; pcdet
datasets/pandaset/pandaset_dataset.py role), host numpy.

Two info schemas:
  * the devkit layout (what ``create_pandaset_infos`` writes):
    {sequence, frame_idx, lidar_path (a pandas .pkl.gz), cuboids_path}; the
    frame is read and moved world -> ego -> normative at load time by
    ``pandaset_utils`` (pandas only, no ``pandaset`` package);
  * pre-extracted: {lidar_path (a .npy or pickle of (N, 4+) normative
    points), gt_boxes, gt_names}, which needs no pandas.
``generate_prediction_dicts`` moves normative predictions back to world
cuboids (and writes pandas frames when given an ``output_path``);
``evaluation`` gives KITTI-style AP when the infos carry GT, else
``("", {})``.  Kept from ``com_tpu``: an item is never reseeded.
"""
from __future__ import annotations

import copy
import os
import pickle
from pathlib import Path

import numpy as np

from ...utils.registry import DATASETS
from ..dataset import DatasetTemplate
from . import pandaset_utils as pu


@DATASETS.register
class PandasetDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, db_infos=None, seed=None, infos=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         db_infos=db_infos, seed=seed)
        self.split = dataset_cfg.get("DATA_SPLIT", {}).get(self.mode, "train")
        self.sequences = dataset_cfg.get("SEQUENCES", {}).get(self.split, [])
        self._pose_cache = {}
        self.infos = list(infos) if infos is not None else []
        if infos is None:
            self.include_pandaset_infos(self.mode)

    def include_pandaset_infos(self, mode):
        for info_path in self.dataset_cfg.get("INFO_PATH", {}).get(mode, []):
            p = Path(self.root_path) / info_path
            if p.exists():
                with open(p, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if self.logger is not None:
            self.logger.info(
                f"Total samples for PandaSet dataset ({mode}): "
                f"{len(self.infos)}")

    def set_split(self, split):
        """Reference set_split(:93-95): re-point at a split's sequences."""
        self.split = split
        self.sequences = self.dataset_cfg.get("SEQUENCES", {}).get(split, [])

    def get_infos(self):
        """Enumerate frame paths for self.sequences (ref get_infos)."""
        infos = []
        for seq in self.sequences:
            infos.extend(pu.get_sequence_infos(self.root_path, seq))
        return infos

    def _pose_for(self, info):
        seq = info["sequence"]
        if seq not in self._pose_cache:
            self._pose_cache[seq] = pu.load_poses(
                Path(self.root_path) / "dataset" / seq)
        return self._pose_cache[seq][info["frame_idx"]]

    def get_lidar(self, info):
        if "cuboids_path" in info:  # devkit layout
            pose = self._pose_for(info)
            return pu.read_frame_points(
                Path(self.root_path) / info["lidar_path"], pose,
                self.dataset_cfg.get("LIDAR_DEVICE", 0))
        p = Path(self.root_path) / info["lidar_path"]
        if p.suffix == ".npy":
            pts = np.load(str(p))
        else:
            with open(p, "rb") as f:
                pts = pickle.load(f)
            pts = np.asarray(pts, np.float32)
        return pts.astype(np.float32)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index):
        info = copy.deepcopy(self.infos[index])
        input_dict = {
            "points": self.get_lidar(info),
            "frame_id": info.get(
                "frame_id", f"{info.get('sequence', '')}"
                            f"_{info.get('frame_idx', index)}"),
        }
        if "cuboids_path" in info:  # devkit layout (ref __getitem__ :101-135)
            pose = self._pose_for(info)
            boxes, names, zrot = pu.read_frame_cuboids(
                Path(self.root_path) / info["cuboids_path"], pose,
                self.dataset_cfg.get("TRAINING_CATEGORIES", {}),
                self.dataset_cfg.get("LIDAR_DEVICE", 0))
            input_dict.update(
                gt_names=names, gt_boxes=boxes,
                sequence=int(info["sequence"]),
                frame_idx=int(info["frame_idx"]),
                zrot_world_to_ego=np.float32(zrot),
                pose=pu.pose_dict_to_numpy(pose).astype(np.float32),
            )
        elif "gt_boxes" in info:
            input_dict["gt_names"] = np.asarray(info["gt_names"])
            input_dict["gt_boxes"] = np.asarray(info["gt_boxes"])
        return self.prepare_data(input_dict)

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Normative preds -> world-frame cuboid rows (ref :259-356).

        Writes <seq>/predictions/cuboids/<frame>.pkl.gz DataFrames when
        output_path is given; returns per-frame dicts either way.
        """
        annos = []
        for index, box_dict in enumerate(pred_dicts):
            boxes = np.asarray(box_dict["pred_boxes"]).reshape(-1, 7)
            scores = np.asarray(box_dict["pred_scores"]).reshape(-1)
            labels = np.asarray(box_dict["pred_labels"]).reshape(-1)
            zrot = float(np.asarray(batch_dict["zrot_world_to_ego"])[index])
            pose_np = np.asarray(batch_dict["pose"])[index]
            pose = pu.pose_numpy_to_dict(pose_np)
            names = np.array(class_names)[
                np.clip(labels - 1, 0, len(class_names) - 1)]

            fields = pu.normative_boxes_to_world(boxes, pose, zrot)
            fields["label"] = names
            fields["score"] = scores
            frame_idx = int(np.asarray(batch_dict["frame_idx"])[index])
            seq_idx = int(np.asarray(batch_dict["sequence"])[index])
            anno = {
                "preds": fields,
                "name": names.tolist(),
                "frame_idx": frame_idx,
                "sequence": str(seq_idx).zfill(3),
            }
            if output_path is not None:
                import pandas as pd

                out = (Path(output_path) / str(seq_idx).zfill(3) /
                       "predictions" / "cuboids" /
                       f"{str(frame_idx).zfill(2)}.pkl.gz")
                os.makedirs(out.parent, exist_ok=True)
                pd.DataFrame(fields).to_pickle(out)
            annos.append(anno)
        return annos

    def create_groundtruth_database(self, info_path=None, used_classes=None,
                                    split="train"):
        return pu.create_groundtruth_database(
            self.dataset_cfg, self.root_path,
            info_path or Path(self.root_path) /
            f"pandaset_infos_{split}.pkl", split=split)

    def evaluation(self, det_annos, class_names, **kwargs):
        """The reference returns an empty eval ('no official one', :439-446);
        we substitute the KITTI-style AP over normative boxes when the infos
        carry gt (pre-extracted schema), else the reference's empty result."""
        if not self.infos or "gt_boxes" not in self.infos[0]:
            return "", {}
        from ..kitti.kitti_eval import kitti_evaluation

        gt_annos = [{
            "gt_boxes_lidar": np.asarray(
                info.get("gt_boxes", np.zeros((0, 7))))[:, :7],
            "name": np.asarray(info.get("gt_names", [])),
            "difficulty": np.zeros(len(info.get("gt_names", [])), np.int64),
        } for info in self.infos]
        return kitti_evaluation(det_annos, gt_annos, class_names)
