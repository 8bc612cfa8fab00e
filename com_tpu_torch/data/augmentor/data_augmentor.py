"""The augmentation queue (the port's copy of
``com_tpu/data/augmentor/data_augmentor.py``; pcdet data_augmentor.py:9-307
parity).

Builds a list of augmentation callables from the config: ``gt_sampling``
dispatches to the COM samplers through ``build_gt_sampler``; the world,
local, frustum and pyramid transforms (``transforms.py``) keep the COM side
arrays aligned (they are per-box and unchanged by the geometry).
"""
from __future__ import annotations

import numpy as np

from . import transforms
from .database_sampler import build_gt_sampler

NOT_PORTED = ()  # every augmentation of com_tpu's DataAugmentor is ported


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None,
                 db_infos=None, rng=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.rng = rng if rng is not None else np.random

        self.data_augmentor_queue = []
        if isinstance(augmentor_configs, list):
            aug_list, disable = augmentor_configs, set()
        else:
            aug_list = augmentor_configs["AUG_CONFIG_LIST"]
            disable = set(augmentor_configs.get("DISABLE_AUG_LIST", []))
        for cur_cfg in aug_list:
            name = cur_cfg["NAME"]
            if name in disable:
                continue
            self.data_augmentor_queue.append(getattr(self, name)(config=cur_cfg,
                                                                 db_infos=db_infos))

    # each builder returns a callable(data_dict) -> data_dict
    def gt_sampling(self, config=None, db_infos=None):
        return build_gt_sampler(self.root_path, config, self.class_names, self.logger,
                                db_infos=db_infos, rng=self.rng)

    def random_world_flip(self, config=None, **_):
        def fn(data_dict):
            gt, pts = data_dict["gt_boxes"], data_dict["points"]
            for axis in config["ALONG_AXIS_LIST"]:
                flip = getattr(transforms, f"random_flip_along_{axis}")
                gt, pts, enable = flip(gt, pts, rng=self.rng, return_param=True)
                # recorded for camera-projection reversal in image-fusion models
                data_dict[f"flip_{axis}"] = enable
            data_dict["gt_boxes"], data_dict["points"] = gt, pts
            return data_dict

        return fn

    def random_world_rotation(self, config=None, **_):
        def fn(data_dict):
            rot_range = config["WORLD_ROT_ANGLE"]
            if not isinstance(rot_range, (list, tuple)):
                rot_range = [-rot_range, rot_range]  # reference scalar form
            gt, pts, angle = transforms.global_rotation(
                data_dict["gt_boxes"], data_dict["points"], rot_range, rng=self.rng,
                return_param=True)
            data_dict["noise_rot"] = angle
            data_dict["gt_boxes"], data_dict["points"] = gt, pts
            return data_dict

        return fn

    def random_world_scaling(self, config=None, **_):
        def fn(data_dict):
            gt, pts, scale = transforms.global_scaling(
                data_dict["gt_boxes"], data_dict["points"], config["WORLD_SCALE_RANGE"],
                rng=self.rng, return_param=True)
            data_dict["noise_scale"] = scale
            data_dict["gt_boxes"], data_dict["points"] = gt, pts
            return data_dict

        return fn

    def random_world_translation(self, config=None, **_):
        def fn(data_dict):
            std = config.get("NOISE_TRANSLATE_STD", 0)
            if np.all(np.asarray(std) <= 0):
                return data_dict
            gt, pts = transforms.global_translation(data_dict["gt_boxes"], data_dict["points"],
                                                    std, rng=self.rng)
            data_dict["gt_boxes"], data_dict["points"] = gt, pts
            return data_dict

        return fn

    def random_local_rotation(self, config=None, **_):
        def fn(data_dict):
            rot_range = config["LOCAL_ROT_ANGLE"]
            if not isinstance(rot_range, (list, tuple)):
                rot_range = [-rot_range, rot_range]  # reference scalar form
            data_dict["gt_boxes"], data_dict["points"] = transforms.random_local_rotation(
                data_dict["gt_boxes"], data_dict["points"], rot_range, rng=self.rng)
            return data_dict

        return fn

    def random_local_scaling(self, config=None, **_):
        def fn(data_dict):
            data_dict["gt_boxes"], data_dict["points"] = transforms.random_local_scaling(
                data_dict["gt_boxes"], data_dict["points"], config["LOCAL_SCALE_RANGE"],
                rng=self.rng)
            return data_dict

        return fn

    def random_local_translation(self, config=None, **_):
        def fn(data_dict):
            data_dict["gt_boxes"], data_dict["points"] = transforms.random_local_translation(
                data_dict["gt_boxes"], data_dict["points"], config["LOCAL_TRANSLATION_RANGE"],
                config.get("ALONG_AXIS_LIST", ["x", "y"]), rng=self.rng)
            return data_dict

        return fn

    def random_world_frustum_dropout(self, config=None, **_):
        def fn(data_dict):
            data_dict["gt_boxes"], data_dict["points"] = transforms.random_world_frustum_dropout(
                data_dict["gt_boxes"], data_dict["points"], config["INTENSITY_RANGE"],
                config.get("DIRECTION", ["top"]), rng=self.rng)
            return data_dict

        return fn

    def random_local_frustum_dropout(self, config=None, **_):
        def fn(data_dict):
            for direction in config.get("DIRECTION", ["top", "bottom", "left", "right"]):
                data_dict["gt_boxes"], data_dict["points"] = (
                    transforms.random_local_frustum_dropout(
                        data_dict["gt_boxes"], data_dict["points"],
                        config.get("INTENSITY_RANGE", [0.0, 0.2]), direction, rng=self.rng))
            return data_dict

        return fn

    def random_local_sparsify(self, config=None, **_):
        def fn(data_dict):
            data_dict["gt_boxes"], data_dict["points"] = transforms.random_local_sparsify(
                data_dict["gt_boxes"], data_dict["points"], config.get("DROP_PROB", 0.2),
                rng=self.rng)
            return data_dict

        return fn

    def random_local_pyramid_aug(self, config=None, **_):
        """SE-SSD's pyramid augmentations (data_augmentor.py:253-272): face
        pyramid dropout -> sparsify -> swap between objects, the pyramid
        chain threaded through the three (boxes dropped or sparsified leave
        the swap pool)."""
        def fn(data_dict):
            gt, pts = data_dict["gt_boxes"], data_dict["points"]
            gt, pts, pyramids = transforms.local_pyramid_dropout(
                gt, pts, config.get("DROP_PROB", 0.25), rng=self.rng)
            gt, pts, pyramids = transforms.local_pyramid_sparsify(
                gt, pts, config.get("SPARSIFY_PROB", 0.05), config.get("SPARSIFY_MAX_NUM", 50),
                pyramids, rng=self.rng)
            data_dict["gt_boxes"], data_dict["points"] = transforms.local_pyramid_swap(
                gt, pts, config.get("SWAP_PROB", 0.1), config.get("SWAP_MAX_NUM", 50), pyramids,
                rng=self.rng)
            return data_dict

        return fn

    @property
    def gt_sampler(self):
        """The gt_sampling step if present (for the curriculum feedback)."""
        for fn in self.data_augmentor_queue:
            if hasattr(fn, "sample_groups"):
                return fn
        return None

    def forward(self, data_dict):
        for fn in self.data_augmentor_queue:
            data_dict = fn(data_dict)
        # heading to [-pi, pi), as the reference's epilogue does
        if "gt_boxes" in data_dict and len(data_dict["gt_boxes"]):
            h = data_dict["gt_boxes"][:, 6]
            data_dict["gt_boxes"][:, 6] = h - np.floor(h / (2 * np.pi) + 0.5) * 2 * np.pi
        return data_dict
