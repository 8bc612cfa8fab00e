"""DemoDataset: a folder (or one file) of .bin / .npy point clouds (the
port's copy of ``com_tpu/data/demo_dataset.py``; reference
tools/demo.py:24-60)."""
from __future__ import annotations

import glob
from pathlib import Path

import numpy as np

from ..utils.registry import DATASETS
from .dataset import DatasetTemplate


@DATASETS.register
class DemoDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=False, root_path=None,
                 logger=None, ext=".bin", **kwargs):
        super().__init__(dataset_cfg, class_names, training=False, root_path=root_path,
                         logger=logger)
        self.ext = ext
        root = Path(root_path)
        if root.is_dir():
            self.sample_file_list = sorted(glob.glob(str(root / f"*{ext}")))
        else:
            self.sample_file_list = [str(root)]

    def __len__(self):
        return len(self.sample_file_list)

    def __getitem__(self, index):
        path = self.sample_file_list[index]
        if self.ext == ".bin":
            points = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
            # pad to the configured feature count (e.g. Waymo's 5-feature models)
            want = self.point_feature_encoder.num_point_features
            if points.shape[1] < want:
                pad = np.zeros((len(points), want - points.shape[1]), np.float32)
                points = np.concatenate([points, pad], axis=1)
        elif self.ext == ".npy":
            points = np.load(path).astype(np.float32)
        else:
            raise NotImplementedError(self.ext)
        return self.prepare_data({"points": points, "frame_id": index})
