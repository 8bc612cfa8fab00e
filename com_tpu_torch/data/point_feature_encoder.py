"""Point feature selection (the port's copy of
``com_tpu/data/point_feature_encoder.py``; pcdet point_feature_encoder.py:4-57
parity)."""
from __future__ import annotations


class PointFeatureEncoder:
    def __init__(self, config):
        self.config = config
        self.used_feature_list = list(config["used_feature_list"])
        self.src_feature_list = list(config["src_feature_list"])
        if self.used_feature_list[:3] != ["x", "y", "z"]:
            raise ValueError("used_feature_list must start with x, y, z")

    @property
    def num_point_features(self):
        return len(self.used_feature_list)

    def forward(self, data_dict):
        keep = [0, 1, 2] + [self.src_feature_list.index(f) for f in self.used_feature_list[3:]]
        data_dict["points"] = data_dict["points"][:, keep]
        data_dict["use_lead_xyz"] = True
        return data_dict
