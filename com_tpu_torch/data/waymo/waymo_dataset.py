"""Waymo dataset: per-sequence pkl infos and per-frame npy lidar (the port's
copy of the reader in ``com_tpu/data/waymo/waymo_dataset.py``; pcdet
waymo_dataset.py).

The reference's on-disk layout: ``<processed_tag>/<sequence>/<sequence>.pkl``
info files listing frames, ``%04d.npy`` lidar arrays [x y z intensity
elongation NLZ], GT boxes with speed, optional COM side annotations
(occupancy_ratio / facade_type) in the annos.  Frames are read with the
intensity squashed by tanh and the no-label-zone points dropped; multi-frame
configs fuse past sweeps by pose.  Evaluation and the GT-database builder
are not ported yet, nor the tfrecord conversion (``waymo_utils.py``, which
needs the waymo-open-dataset package).
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ...utils.registry import DATASETS
from ..dataset import DatasetTemplate


@DATASETS.register
class WaymoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, db_infos=None, seed=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         db_infos=db_infos, seed=seed)
        self.data_path = Path(self.root_path) / dataset_cfg.get(
            "PROCESSED_DATA_TAG", "waymo_processed_data_v0_5_0"
        )
        self.split = dataset_cfg["DATA_SPLIT"]["train" if training else "test"]
        split_file = Path(self.root_path) / "ImageSets" / f"{self.split}.txt"
        self.sample_sequence_list = (
            [x.strip().replace(".tfrecord", "") for x in split_file.read_text().splitlines()]
            if split_file.exists() else [])
        self.infos = []
        self.include_waymo_data()

    def include_waymo_data(self):
        interval = int(
            self.dataset_cfg.get("SAMPLED_INTERVAL", {}).get(
                "train" if self.training else "test", 1
            )
        )
        # training reads the COM-annotated "_short" variant when present
        # (waymo_dataset.py:70)
        suffixes = ["_short.pkl", ".pkl"] if self.training else [".pkl"]
        for seq in self.sample_sequence_list:
            info_path = None
            for suf in suffixes:
                p = self.data_path / seq / f"{seq}{suf}"
                if p.exists():
                    info_path = p
                    break
            if info_path is None:
                continue
            with open(info_path, "rb") as f:
                infos = pickle.load(f)
            self.infos.extend(infos)
        # full-rate (pre-subsample) sequence index: multi-frame fusion looks
        # up offsets -1..-k, which interval subsampling would almost never
        # keep (the reference holds a full seq_name_to_infos for this)
        self._full_infos = self.infos
        self.infos = self.infos[::interval] if interval > 1 else self.infos
        if self.logger:
            self.logger.info("WaymoDataset %s: %d frames", self.split, len(self.infos))

    def __len__(self):
        return len(self.infos)

    def get_lidar(self, sequence_name, sample_idx):
        path = self.data_path / sequence_name / f"{sample_idx:04d}.npy"
        points_all = np.load(path)  # (N, 6): x y z intensity elongation NLZ
        nlz = points_all[:, 5]
        points = points_all[:, :5]
        points[:, 3] = np.tanh(points[:, 3])  # intensity squash (:203-211)
        if self.dataset_cfg.get("DISABLE_NLZ_FLAG_ON_POINTS", True):
            points = points[nlz == -1]
        return points.astype(np.float32)

    def get_sequence_data(self, info, points, seq, sample_idx, sequence_cfg):
        """Multi-frame fusion: past sweeps re-projected into the current frame
        via pose matrices, with a per-point relative-timestamp feature
        (waymo_dataset.py:253-339 role)."""
        lo, hi = sequence_cfg["SAMPLE_OFFSET"]
        pose_cur = np.asarray(info["pose"], np.float64).reshape(4, 4)
        pose_cur_inv = np.linalg.inv(pose_cur)
        all_points = [np.concatenate(
            [points, np.zeros((len(points), 1), np.float32)], axis=1)]
        idx_by_sample = getattr(self, "_seq_index", None)
        if idx_by_sample is None:
            # built over the FULL-rate infos: with SAMPLED_INTERVAL > 1 the
            # -1..-k neighbors are not in self.infos and fusion would
            # silently degrade to single-frame at train time only
            self._seq_index = {}
            src = getattr(self, "_full_infos", self.infos)
            for i, inf in enumerate(src):
                pc = inf["point_cloud"]
                self._seq_index[(pc["lidar_sequence"], pc["sample_idx"])] = i
            idx_by_sample = self._seq_index
        src_infos = getattr(self, "_full_infos", self.infos)
        for off in range(int(lo), int(hi)):
            past_idx = idx_by_sample.get((seq, sample_idx + off))
            if past_idx is None:
                continue
            past_info = src_infos[past_idx]
            past_pts = self.get_lidar(seq, sample_idx + off)
            pose_past = np.asarray(past_info["pose"], np.float64).reshape(4, 4)
            rel = pose_cur_inv @ pose_past
            hom = np.concatenate(
                [past_pts[:, :3], np.ones((len(past_pts), 1))], axis=1
            )
            xyz = (hom @ rel.T)[:, :3].astype(np.float32)
            # POSITIVE time lag 0.1 * (cur - past) like the reference
            # (waymo_dataset.py:253-339) — mppnet crops past frame i by
            # t == +0.1*i, so a negative tag would empty every past crop
            ts = np.full((len(past_pts), 1), -0.1 * off, np.float32)
            all_points.append(
                np.concatenate([xyz, past_pts[:, 3:], ts], axis=1)
            )
        return np.concatenate(all_points, axis=0)

    def __getitem__(self, index):
        self._reseed_for_item(index)
        info = self.infos[index]
        pc_info = info["point_cloud"]
        seq, sample_idx = pc_info["lidar_sequence"], pc_info["sample_idx"]
        points = self.get_lidar(seq, sample_idx)
        seq_cfg = self.dataset_cfg.get("SEQUENCE_CONFIG")
        if seq_cfg and seq_cfg.get("ENABLED", False) and "pose" in info:
            points = self.get_sequence_data(info, points, seq, sample_idx, seq_cfg)

        data = {"points": points, "frame_id": info.get("frame_id", f"{seq}_{sample_idx}")}
        if "annos" in info:
            annos = info["annos"]
            keep = annos["name"] != "unknown"
            data["gt_names"] = annos["name"][keep]
            gtb = np.asarray(annos["gt_boxes_lidar"])[keep].astype(np.float32)
            # TRAIN_WITH_SPEED keeps the vx/vy columns (cols 7:9 from
            # waymo_utils) for velocity-regressing heads; the augmentor
            # rotates them and target_assign emits vel residuals
            if not self.dataset_cfg.get("TRAIN_WITH_SPEED", False):
                gtb = gtb[:, :7]
            data["gt_boxes"] = gtb
            npgt = annos.get("num_points_in_gt")
            if npgt is not None:
                data["num_points_in_gt"] = npgt[keep].astype(np.float32)
            # COM side annotations from the offline annotator (if present)
            for key in ("occupancy_ratio", "facade_type"):
                if key in annos:
                    data[key] = np.asarray(annos[key])[keep].astype(np.float32)
            data["true_object"] = np.ones(int(keep.sum()), np.float32)
            if self.dataset_cfg.get("FILTER_EMPTY_BOXES_FOR_TRAIN", True) and self.training:
                if "num_points_in_gt" in data:
                    ne = data["num_points_in_gt"] > 0
                    for k in ("gt_names", "gt_boxes", "num_points_in_gt",
                              "true_object", "occupancy_ratio", "facade_type"):
                        if k in data:
                            data[k] = data[k][ne]
        return self.prepare_data(data)
