"""The data processor queue (the port's copy of ``com_tpu/data/processor.py``;
pcdet data_processor.py:15-221 parity).

A config-driven list of named steps over one scene.  The COM side arrays
(num_points_in_gt / true_object / occupancy_ratio / facade_type) stay aligned
through every box filter, and are optional per dataset.
"""
from __future__ import annotations

import numpy as np

from ..ops.host_boxes import mask_boxes_outside_range
from ..ops.host_native import voxelize_native
from ..ops.voxelize import grid_size_from_range

GT_SIDE_KEYS = ("num_points_in_gt", "true_object", "occupancy_ratio", "facade_type")


def filter_gt_arrays(data_dict, keep_mask):
    data_dict["gt_boxes"] = data_dict["gt_boxes"][keep_mask]
    if "gt_names" in data_dict:
        data_dict["gt_names"] = data_dict["gt_names"][keep_mask]
    for k in GT_SIDE_KEYS:
        if k in data_dict:
            data_dict[k] = data_dict[k][keep_mask]
    return data_dict


def pipeline_presorts_points(data_cfg, voxel_size) -> bool:
    """True iff the DATA_PROCESSOR list guarantees that points reach the
    model sorted by flat BEV pillar id at the model's pillar size:
    ``sort_points_by_bev_pillar`` (with a matching XY voxel size, or none)
    appears and no later step reorders points.  Callers then set the VFE's
    ``ASSUME_SORTED_POINTS``, which removes its device sort."""
    procs = list(getattr(data_cfg, "DATA_PROCESSOR", None) or [])
    sorted_ok = False
    for p in procs:
        name = p["NAME"]
        if name == "sort_points_by_bev_pillar":
            vs = p.get("VOXEL_SIZE", None)
            sorted_ok = vs is None or (abs(float(vs[0]) - float(voxel_size[0])) < 1e-6
                                       and abs(float(vs[1]) - float(voxel_size[1])) < 1e-6)
        elif name in ("shuffle_points", "sample_points"):
            sorted_ok = False
    return sorted_ok


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training, num_point_features,
                 rng=None):
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.rng = rng if rng is not None else np.random
        self.mode = "train" if training else "test"
        self.grid_size = None
        self.voxel_size = None
        self.queue = []
        self.max_voxels = None
        for cur_cfg in processor_configs:
            if cur_cfg["NAME"] == "transform_points_to_voxels":
                self.voxel_size = np.asarray(cur_cfg["VOXEL_SIZE"], np.float32)
                self.grid_size = grid_size_from_range(self.point_cloud_range, self.voxel_size)
                self.max_voxels = int(cur_cfg["MAX_NUMBER_OF_VOXELS"][self.mode])
            self.queue.append((getattr(self, cur_cfg["NAME"]), cur_cfg))

    def mask_points_and_boxes_outside_range(self, data_dict, cfg):
        points = data_dict["points"]
        pr = self.point_cloud_range
        m = ((points[:, 0] >= pr[0]) & (points[:, 0] <= pr[3])
             & (points[:, 1] >= pr[1]) & (points[:, 1] <= pr[4]))
        data_dict["points"] = points[m]
        if (data_dict.get("gt_boxes", None) is not None and len(data_dict["gt_boxes"])
                and cfg.get("REMOVE_OUTSIDE_BOXES", False) and self.training):
            if cfg.get("USE_CENTER_TO_FILTER", True):
                # the reference's default: the center inside all 3 axes
                b = np.asarray(data_dict["gt_boxes"])[:, :3]
                keep = ((b >= pr[0:3]) & (b <= pr[3:6])).all(axis=-1)
            else:
                keep = mask_boxes_outside_range(data_dict["gt_boxes"], pr,
                                                min_num_corners=cfg.get("min_num_corners", 1))
            filter_gt_arrays(data_dict, keep)
        return data_dict

    def shuffle_points(self, data_dict, cfg):
        if cfg["SHUFFLE_ENABLED"][self.mode]:
            idx = self.rng.permutation(data_dict["points"].shape[0])
            data_dict["points"] = data_dict["points"][idx]
        return data_dict

    def sort_points_by_bev_pillar(self, data_dict, cfg):
        """Stable sort by flat BEV pillar id, out-of-range points last, so the
        VFE can skip its device sort.  The pillar formula is the device's
        ``ops.voxelize.point_voxel_ids``, f32 ``floor((p - min) / size)`` on
        all three axes: a point that rounds into another pillar there would
        break the order that ``ASSUME_SORTED_POINTS`` trusts."""
        vs = np.asarray(cfg.get("VOXEL_SIZE", self.voxel_size), np.float32)
        pr = self.point_cloud_range
        nx = int(round(float(pr[3] - pr[0]) / float(vs[0])))
        ny = int(round(float(pr[4] - pr[1]) / float(vs[1])))
        nz = max(1, int(round(float(pr[5] - pr[2]) / float(vs[2]))))
        p = data_dict["points"].astype(np.float32)
        vi = np.floor((p[:, :3] - pr[None, 0:3].astype(np.float32)) / vs[None, :]).astype(np.int64)
        in_range = ((vi[:, 0] >= 0) & (vi[:, 0] < nx) & (vi[:, 1] >= 0) & (vi[:, 1] < ny)
                    & (vi[:, 2] >= 0) & (vi[:, 2] < nz))
        flat = np.where(in_range, vi[:, 1] * nx + vi[:, 0], nx * ny)
        data_dict["points"] = data_dict["points"][np.argsort(flat, kind="stable")]
        return data_dict

    def transform_points_to_voxels(self, data_dict, cfg):
        voxels, coords, num_points = voxelize_native(
            data_dict["points"], self.point_cloud_range, self.voxel_size,
            cfg["MAX_POINTS_PER_VOXEL"], cfg["MAX_NUMBER_OF_VOXELS"][self.mode])
        data_dict["voxels"] = voxels
        data_dict["voxel_coords"] = coords
        data_dict["voxel_num_points"] = num_points
        return data_dict

    def sample_points(self, data_dict, cfg):
        num = cfg["NUM_POINTS"][self.mode]
        points = data_dict["points"]
        if num == -1 or len(points) == 0:
            return data_dict
        if num < len(points):
            depth = np.linalg.norm(points[:, :3], axis=1)
            far = np.where(depth >= 40.0)[0]
            near = np.where(depth < 40.0)[0]
            if num > len(far):
                near_keep = self.rng.choice(near, num - len(far), replace=False)
                choice = np.concatenate([near_keep, far])
            else:
                choice = self.rng.choice(np.arange(len(points)), num, replace=False)
            self.rng.shuffle(choice)
        else:
            choice = np.arange(len(points))
            deficit = num - len(points)
            # without replacement, as the reference (data_processor.py:181),
            # unless the deficit exceeds the point count
            extra = self.rng.choice(choice, deficit, replace=deficit > len(points))
            choice = np.concatenate([choice, extra])
            self.rng.shuffle(choice)
        data_dict["points"] = points[choice]
        return data_dict

    def forward(self, data_dict):
        for fn, cfg in self.queue:
            data_dict = fn(data_dict, cfg)
        return data_dict
