"""The KITTI configs through the port's train and test CLIs on the CPU,
from a KITTI tree written from a seed (``torch_port_kitti_setup``) and
their own DATA_CONFIG: ``kitti_models/pointpillar.yaml`` (1 epoch of 2
steps, then the test CLI on the val split with KITTI AP, held to
``com_tpu``'s evaluation of the same detections) and
``custom_models/second.yaml`` through the test CLI on a custom tree.  The
grids are cut (pillars of 0.32 m over 40.96 m, the custom SECOND narrowed)
so that a CPU step stays short; ``DATA_PATH`` comes through ``--set``.
"""
import numpy as np
import torch
import yaml

from com_tpu.data.kitti.kitti_dataset import KittiDataset as JaxKitti
from com_tpu.utils import config as jax_config
from com_tpu_torch.models.detectors import build_network
from com_tpu_torch.tools import test, train
from com_tpu_torch.tools.train import dataset_meta
from com_tpu_torch.data import build_dataloader
from com_tpu_torch.utils.config import cfg_from_yaml_file
from test_torch_port_voxel_train import _plain
from torch_port_kitti_setup import REPO, small_custom_tree, small_tree

torch.set_num_threads(2)

PP = "configs/kitti_models/pointpillar.yaml"
CUSTOM_SECOND = "configs/custom_models/second.yaml"


def write_cfg(path, cfg):
    path.write_text(yaml.safe_dump({k: _plain(cfg[k]) for k in ("CLASS_NAMES", "DATA_CONFIG",
                                                                  "MODEL", "OPTIMIZATION")}))
    return path


def test_pointpillar_through_train_and_test_clis(tmp_path):
    ids = small_tree(tmp_path / "kitti")
    cfg = cfg_from_yaml_file(str(REPO / PP))
    dc = cfg.DATA_CONFIG
    # 128 x 128 pillars of 0.32 m: the frames' objects stay in range under
    # the world rotation (a tiny range can leave a training item without GT
    # on every retry, as in com_tpu)
    dc.POINT_CLOUD_RANGE = [0.0, -20.48, -3.0, 40.96, 20.48, 1.0]
    dc.MAX_POINTS_PER_SCENE = 4096
    dc.DATA_PROCESSOR[2].update(VOXEL_SIZE=[0.32, 0.32, 4.0],
                                MAX_NUMBER_OF_VOXELS={"train": 2048, "test": 2048})
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 512
    yaml_path = write_cfg(tmp_path / "pointpillar_small.yaml", cfg)
    base = ["--cfg_file", str(yaml_path), "--device", "cpu", "--workers", "1", "--output_dir",
            str(tmp_path / "out"), "--batch_size", "2"]
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tmp_path / "kitti")]
    first = train.main(base + ["--epochs", "1", "--seed", "3"] + data)
    assert first["iterations"] == len(ids["train"]) // 2 == 2
    assert all(torch.isfinite(p).all() for p in first["state"].net.parameters())
    ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
    (res,) = test.main(base + ["--ckpt", str(ckpt)] + data)
    annos = res["det_annos"]
    assert [a["frame_id"] for a in annos] == ids["val"]
    assert res["result_str"].splitlines()[0].startswith("Car AP_bev R40 easy/mod/hard")
    assert set(res["result"]) == {f"{c}_{m}" for c in ("Car", "Pedestrian", "Cyclist")
                                  for m in ("bev", "3d")}
    for a in annos:
        assert np.isfinite(a["boxes_lidar"]).all() and (np.diff(a["score"]) <= 0).all()
    # com_tpu's KittiDataset evaluates the same detections to the same AP
    jcfg = jax_config.cfg_from_yaml_file(str(yaml_path), jax_config.CfgNode())
    jcfg.DATA_CONFIG.DATA_PATH = str(tmp_path / "kitti")
    jds = JaxKitti(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=False)
    _, want = jds.evaluation([{k: v for k, v in a.items() if k != "bbox"} for a in annos],
                             list(jcfg.CLASS_NAMES))
    for k, v in want.items():
        np.testing.assert_allclose(res["result"][k], v, rtol=0, atol=1e-6, err_msg=k)


def test_custom_second_through_the_test_cli(tmp_path):
    """SECOND on the custom dataset (Vehicle / Pedestrian / Cyclist), its
    seeded weights saved as a checkpoint with the class bias raised (so
    that detections pass SCORE_THRESH), through the test CLI: detections on
    every val frame and the KITTI AP table of the custom evaluation."""
    ids = small_custom_tree(tmp_path / "custom")
    cfg = cfg_from_yaml_file(str(REPO / CUSTOM_SECOND))
    dc = cfg.DATA_CONFIG
    dc.POINT_CLOUD_RANGE = [-16.0, -16.0, -2.0, 16.0, 16.0, 4.0]  # 64 x 64 x 40 at 0.5 x 0.5 x 0.15
    dc.MAX_POINTS_PER_SCENE = 4096
    dc.DATA_PROCESSOR[2].update(VOXEL_SIZE=[0.5, 0.5, 0.15],
                                MAX_NUMBER_OF_VOXELS={"train": 2048, "test": 2048})
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    m.BACKBONE_3D.update(CHANNELS=[8, 16, 16, 32], OUT_CHANNELS=32,
                         VOXEL_CAPS=[2048, 1024, 512, 256])
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], NUM_FILTERS=[32, 64], NUM_UPSAMPLE_FILTERS=[32, 32])
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    dc.DATA_PATH = str(tmp_path / "custom")
    yaml_path = write_cfg(tmp_path / "custom_second_small.yaml", cfg)
    dataset, _ = build_dataloader(dc, list(cfg.CLASS_NAMES), 2, training=False, workers=1)
    net = build_network(m, dataset_meta(cfg, dataset), device="cpu", seed=5)
    with torch.no_grad():
        net.dense_head.conv_cls.bias.add_(4.0)
        net.dense_head.conv_box.weight.mul_(0.02)
    torch.save({"model_state": net.state_dict()}, tmp_path / "seeded.pth")
    (res,) = test.main(["--cfg_file", str(yaml_path), "--device", "cpu", "--workers", "1",
                        "--output_dir", str(tmp_path / "out"), "--batch_size", "2",
                        "--ckpt", str(tmp_path / "seeded.pth")])
    annos = res["det_annos"]
    assert [a["frame_id"] for a in annos] == ids["val"]
    assert all(len(a["score"]) > 0 and set(a["name"]) <= set(cfg.CLASS_NAMES) for a in annos)
    assert "Vehicle AP_bev R40" in res["result_str"] and len(res["result"]) == 6
