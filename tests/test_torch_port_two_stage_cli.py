"""Voxel-RCNN narrowed (``tests/torch_port_two_stage_setup.py``, dropout
0.3 on) through the port's train CLI (1 epoch of 2 steps, the RoI losses
on) and its test CLI on the checkpoint, over the synthetic dataset's
scenes (4 of 1,500 ground points, COM GT-paste, the class renamed Vehicle
as the synthetic scenes name it) hard-voxelized by the port's native
voxelizer at the 64 x 64 x 40 grid, as ``test_torch_port_voxel_train.py``
drives the voxel config."""
from pathlib import Path

import numpy as np
import torch

from com_tpu_torch.utils.config import cfg_from_yaml_file
from test_torch_port_voxel_train import _plain
from torch_port_two_stage_setup import small_cfg

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def test_voxel_rcnn_through_train_and_test_clis(tmp_path):
    import yaml

    from com_tpu_torch.tools import test, train

    model = small_cfg("voxel_rcnn", dp_ratio=0.3)
    model.MODEL.DENSE_HEAD.ANCHOR_GENERATOR_CONFIG[0]["class_name"] = "Vehicle"
    data = cfg_from_yaml_file(str(REPO / "configs/synthetic_models/centerpoint_synth_com.yaml"))
    d = _plain(data.DATA_CONFIG)
    d.update(NUM_SCENES=4, NUM_OBJECTS=6, NUM_BG_POINTS=1500, MAX_POINTS_PER_SCENE=6144,
             MAX_GT_OBJECTS=16, POINT_CLOUD_RANGE=[-16.0, -16.0, -2.0, 16.0, 16.0, 2.0])
    sampling = d["DATA_AUGMENTOR"]["AUG_CONFIG_LIST"][0]
    sampling["PREPARE"]["filter_by_min_points"] = ["Vehicle:5"]
    sampling["SAMPLE_GROUPS"] = ["Vehicle:10"]
    d["DATA_PROCESSOR"] = _plain(model.DATA_CONFIG.DATA_PROCESSOR)
    d["DATA_PROCESSOR"][2].update(VOXEL_SIZE=[0.5, 0.5, 0.1],
                                  MAX_NUMBER_OF_VOXELS={"train": 2048, "test": 2048})
    path = tmp_path / "voxel_rcnn.yaml"
    path.write_text(yaml.safe_dump({"CLASS_NAMES": ["Vehicle"], "DATA_CONFIG": d,
                                    "MODEL": _plain(model.MODEL),
                                    "OPTIMIZATION": _plain(model.OPTIMIZATION)}))
    base = ["--cfg_file", str(path), "--device", "cpu", "--workers", "1", "--output_dir",
            str(tmp_path / "out")]
    seen = []
    first = train.main(base + ["--epochs", "1", "--batch_size", "2", "--seed", "3"],
                       metric_hook=lambda epoch, it, m: seen.append(
                           {k: float(v.sum()) for k, v in m.items()}))
    assert first["iterations"] == 2 and len(seen) == 2
    for m in seen:
        assert {"rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner"} <= set(m)
        assert all(np.isfinite(v) for v in m.values())
    head = first["state"].net.roi_head
    assert all(torch.isfinite(p).all() for p in head.parameters())
    ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
    (res,) = test.main(base + ["--ckpt", str(ckpt), "--batch_size", "2"])
    assert len(res["det_annos"]) == 4
    for a in res["det_annos"]:
        assert np.isfinite(a["boxes_lidar"]).all() and (np.diff(a["score"]) <= 0).all()
        assert len(a["score"]) <= 100 and set(a["pred_labels"]) <= {1}
