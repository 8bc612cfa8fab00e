"""Custom dataset (the port's copy of ``com_tpu/data/custom/custom_dataset.py``;
pcdet/datasets/custom/custom_dataset.py role): the user's point clouds as
``points/<id>.npy`` and plain-text labels ``labels/<id>.txt`` (``x y z dx dy
dz heading class_name`` a line, lidar frame), the frames of a split from
``ImageSets/<split>.txt``, else every ``.npy``.  ``evaluation`` is KITTI
AP (``kitti/kitti_eval.py``) with every GT at difficulty 0 and no 2D gate.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ...utils.registry import DATASETS
from ..dataset import DatasetTemplate


@DATASETS.register
class CustomDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, root_path=None,
                 logger=None, db_infos=None, seed=None):
        super().__init__(dataset_cfg, class_names, training, root_path, logger,
                         db_infos=db_infos, seed=seed)
        root = Path(self.root_path)
        split = dataset_cfg.get("DATA_SPLIT", {}).get("train" if training else "test", "train")
        split_file = root / "ImageSets" / f"{split}.txt"
        self.sample_ids = (
            [x.strip() for x in split_file.read_text().splitlines(keepends=True)]
            if split_file.exists()
            else sorted(p.stem for p in (root / "points").glob("*.npy")))

    def __len__(self):
        return len(self.sample_ids)

    def get_lidar(self, idx):
        return np.load(str(Path(self.root_path) / "points" / f"{idx}.npy"))

    def get_label(self, idx):
        """(boxes (N, 7) f32, names (N,)); lines with fewer than 8 fields
        are skipped, a missing file is an empty frame."""
        p = Path(self.root_path) / "labels" / f"{idx}.txt"
        boxes, names = [], []
        if p.exists():
            for line in p.read_text().splitlines():
                parts = line.strip().split()
                if len(parts) < 8:
                    continue
                boxes.append([float(v) for v in parts[:7]])
                names.append(parts[7])
        return np.asarray(boxes, np.float32).reshape(-1, 7), np.asarray(names)

    def __getitem__(self, index):
        # no per-item reseed, as in com_tpu: the dataset's RNG runs on
        idx = self.sample_ids[index]
        boxes, names = self.get_label(idx)
        return self.prepare_data({"points": self.get_lidar(idx).astype(np.float32),
                                  "frame_id": idx, "gt_boxes": boxes, "gt_names": names})

    def evaluation(self, det_annos, class_names, **kwargs):
        from ..kitti.kitti_eval import kitti_evaluation

        gt_annos = []
        for idx in self.sample_ids:
            boxes, names = self.get_label(idx)
            gt_annos.append({"gt_boxes_lidar": boxes, "name": names,
                             "difficulty": np.zeros(len(names), np.int64)})
        return kitti_evaluation(det_annos, gt_annos, class_names)
