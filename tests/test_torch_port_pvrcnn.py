"""The PV-RCNN family against the JAX package on the CPU, in eval (setup:
``tests/torch_port_pvrcnn_setup.py``): each module fed the JAX forward's
own inputs to it (``VoxelSetAbstraction`` with FPS and with SPC,
``PointHeadSimple``, ``PVRCNNHead``, ``PVRCNNPlusPlusHead``), the whole
PVRCNN and PVRCNNPlusPlus forwards and eval steps; the PVRCNN state_dict
through the JAX package's pcdet importer; every shipped PV-RCNN config
built at its own grid and width; ``kitti_models/pv_rcnn.yaml`` through the
train and test CLIs over a small KITTI tree.  Keypoints and their validity
exactly, features and detections to 1e-4 (f32).
"""
import copy

import jax
import numpy as np
import pytest
import torch
import yaml

from com_tpu.utils.torch_import import import_torch_state_dict
from com_tpu_torch.tools import test, train
from com_tpu_torch.train.step import model_input_keys
from com_tpu_torch.utils.config import cfg_from_yaml_file
from test_torch_port_two_stage_model import check_eval
from test_torch_port_voxel_train import _plain
from torch_port_kitti_setup import REPO, small_tree
from torch_port_pvrcnn_setup import INPUT_KEYS, setup

torch.set_num_threads(2)
ATOL = 1e-4
CONFIGS = ["configs/kitti_models/pv_rcnn.yaml", "configs/custom_models/pv_rcnn.yaml",
           "configs/waymo_models/pv_rcnn.yaml", "configs/waymo_models/pv_rcnn_plusplus.yaml",
           "configs/waymo_models/pv_rcnn_plusplus_resnet.yaml",
           "configs/waymo_models/pv_rcnn_plusplus_resnet_2frames.yaml"]


def run(which, seed, dp_ratio=0.0):
    """The setup, the JAX eval forward's outputs (numpy) and the port's."""
    s = setup(which, seed, dp_ratio)
    cfg, _, _, jnet, variables, net, host = s
    jin = {k: host[k] for k in INPUT_KEYS}
    jout = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(variables, jin)
    jout = jax.tree_util.tree_map(np.asarray, jout)
    with torch.no_grad():
        out = net({k: torch.from_numpy(host[k]) for k in INPUT_KEYS})
    return s, jout, out


@pytest.fixture(scope="module")
def pvrcnn():
    return run("pvrcnn", seed=41, dp_ratio=0.3)  # eval: dropout off


@pytest.fixture(scope="module")
def pvrcnn_plusplus():
    return run("pvrcnn_plusplus", seed=42)


def t(a):
    return torch.from_numpy(np.array(a))


def jax_inputs(jout, keys):
    """The JAX forward's values of ``keys`` as the port's batch."""
    batch = {}
    for k in keys:
        v = jout[k]
        if k == "multi_scale_3d_features":
            batch[k] = {src: (t(x), t(c), t(m), tuple(int(g) for g in grid))
                        for src, (x, c, m, grid) in v.items()}
        else:
            batch[k] = t(v)
    return batch


def check_close(got, want, keys):
    for k in keys:
        g, w = got[k].numpy(), want[k]
        if g.dtype == bool or k == "point_coords":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=ATOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("which", ["pvrcnn", "pvrcnn_plusplus"])
def test_voxel_set_abstraction_matches_jax(which, request):
    """FPS (PV-RCNN) or SPC over 4 sectors around the RoIs (PV-RCNN++): the
    same keypoints; their BEV, raw-point and x_conv3 / x_conv4 features and
    the fusion."""
    (_, _, _, _, _, net, host), jout, _ = request.getfixturevalue(which)
    assert net.pfe.sample_method == ("SPC" if which == "pvrcnn_plusplus" else "FPS")
    batch = jax_inputs(jout, ["spatial_features", "multi_scale_3d_features"]
                       + (["rois"] if which == "pvrcnn_plusplus" else []))
    batch.update(points=t(host["points"]), points_mask=t(host["points_mask"]),
                 spatial_features_stride=8)
    with torch.no_grad():
        got = net.pfe(batch)
    assert int(got["point_valid"].sum()) > 0
    check_close(got, jout, ["point_coords", "point_valid", "point_features_before_fusion",
                            "point_features"])


def test_point_head_simple_matches_jax(pvrcnn):
    (_, _, _, _, _, net, _), jout, _ = pvrcnn
    with torch.no_grad():
        got = net.point_head(jax_inputs(jout, ["point_features", "point_valid"]))
    check_close(got, jout, ["point_cls_scores_raw"])


@pytest.mark.parametrize("which", ["pvrcnn", "pvrcnn_plusplus"])
def test_roi_head_matches_jax(which, request):
    """``PVRCNNHead`` (ball query + PointNet over the keypoints at a 3^3 grid)
    or ``PVRCNNPlusPlusHead`` (two vector-pool groups, local interpolation)
    on the JAX forward's RoIs and keypoints."""
    (_, _, _, _, _, net, _), jout, _ = request.getfixturevalue(which)
    assert type(net.roi_head).__name__ == ("PVRCNNPlusPlusHead" if which == "pvrcnn_plusplus"
                                           else "PVRCNNHead")
    with torch.no_grad():
        got = net.roi_head(jax_inputs(jout, ["rois", "point_coords", "point_features",
                                             "point_valid"]))
    check_close(got, jout, ["rcnn_cls", "rcnn_reg"])


@pytest.mark.parametrize("which", ["pvrcnn", "pvrcnn_plusplus"])
def test_whole_forward_and_eval_step_match_jax(which, request):
    """The whole forward (keypoints, RoIs, the RCNN outputs) and the eval
    step's detections."""
    s, jout, out = request.getfixturevalue(which)
    assert type(s[5]).__name__ == ("PVRCNNPlusPlus" if which == "pvrcnn_plusplus" else "PVRCNN")
    assert {"points", "points_mask"} <= model_input_keys(s[0].MODEL)
    check_close(out, jout, ["point_coords", "point_valid", "point_features",
                            "point_cls_scores_raw", "rois", "roi_valid", "rcnn_cls", "rcnn_reg"])
    check_eval(*s, min_valid=8)


def test_pvrcnn_state_dict_round_trip_through_jax_importer(pvrcnn):
    """port state_dict -> the JAX package's pcdet importer -> the flax
    variables the bridge started from: every key loaded (pcdet's names:
    ``pfe.SA_rawpoints.mlps.0.0.weight`` (O, I, 1, 1), the fusion, the
    point head, ``roi_head.roi_grid_pool_layer``, the Conv1d FCs with
    their dropout slots), none unused; the norms pcdet built with eps 1e-5
    read back through the importer's compensation."""
    (cfg, _, _, _, variables, net, _), _, _ = pvrcnn
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    assert sd["pfe.SA_rawpoints.mlps.0.0.weight"].shape == (8, 5, 1, 1)
    assert sd["roi_head.cls_layers.4.weight"].shape == (1, 16, 1)  # past the dropout slot
    assert sd["roi_head.shared_fc_layer.4.weight"].shape == (32, 32, 1)
    assert sd["point_head.cls_layers.3.bias"].shape == (1,)
    new_vars, report = import_torch_state_dict(sd, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    assert not report["mismatch"] and not report["missing"] and not report["unused"], report
    flat_new = dict(jax.tree_util.tree_leaves_with_path(new_vars))
    shifted = ("VoxelSetAbstraction_0", "point_head", "PVRCNNHead_0")
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        keys = [getattr(p, "key", None) for p in path]
        if keys[-1] == "var" and keys[1] in shifted:
            np.testing.assert_allclose(np.asarray(flat_new[path]), np.asarray(leaf), rtol=0,
                                       atol=1e-6, err_msg=str(keys))
        else:
            np.testing.assert_array_equal(np.asarray(flat_new[path]), np.asarray(leaf),
                                          err_msg=str(keys))


@pytest.mark.parametrize("config", CONFIGS)
def test_shipped_configs_build(config):
    """Each shipped PV-RCNN config builds at its own grid and width, the
    slots under pcdet's names."""
    from com_tpu_torch.models.detectors import DatasetMeta, build_network
    from com_tpu_torch.ops.voxelize import grid_size_from_range

    cfg = cfg_from_yaml_file(str(REPO / config))
    proc = next(p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
                if p.NAME == "transform_points_to_voxels")
    pr = list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    meta = DatasetMeta(cfg.CLASS_NAMES, pr, list(proc.VOXEL_SIZE),
                       grid_size_from_range(pr, proc.VOXEL_SIZE),
                       len(cfg.DATA_CONFIG.POINT_FEATURE_ENCODING.used_feature_list))
    net = build_network(cfg.MODEL, meta, device="cpu")
    assert type(net).__name__ == cfg.MODEL.NAME
    assert net.pfe.num_keypoints == cfg.MODEL.PFE.NUM_KEYPOINTS
    keys = net.state_dict()
    assert "pfe.vsa_point_feature_fusion.0.weight" in keys
    assert "point_head.cls_layers.0.weight" in keys
    assert any(k.startswith("roi_head.") for k in keys)


def test_pv_rcnn_yaml_through_train_and_test_clis(tmp_path):
    """``kitti_models/pv_rcnn.yaml`` on a KITTI tree: 1 epoch of 2 steps
    through the train CLI (every loss term finite), then the test CLI on the
    val split with KITTI AP.  Cut so that a CPU step stays short: 40.96 m
    of range at 0.32 x 0.32 x 0.1 m voxels (a 128 x 128 x 40 grid), the
    backbones and heads narrowed, 256 keypoints, 4,096 points a scene, 128
    proposals, 512 candidates to the final NMS."""
    terms = {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rcnn_loss_cls", "rcnn_loss_reg",
             "point_loss_cls"}
    ids = small_tree(tmp_path / "kitti")
    cfg = cfg_from_yaml_file(str(REPO / "configs/kitti_models/pv_rcnn.yaml"))
    dc = cfg.DATA_CONFIG
    dc.POINT_CLOUD_RANGE = [0.0, -20.48, -3.0, 40.96, 20.48, 1.0]
    dc.MAX_POINTS_PER_SCENE = 4096
    dc.DATA_PROCESSOR[2].update(VOXEL_SIZE=[0.32, 0.32, 0.1],
                                MAX_NUMBER_OF_VOXELS={"train": 4096, "test": 4096})
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    m.BACKBONE_3D.update(CHANNELS=[8, 16, 16, 32], OUT_CHANNELS=32,
                         VOXEL_CAPS=[4096, 2048, 1024, 512])
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 64
    m.PFE.update(NUM_KEYPOINTS=256, NUM_OUTPUT_FEATURES=32)
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], NUM_FILTERS=[32, 64], NUM_UPSAMPLE_FILTERS=[32, 32])
    m.POINT_HEAD.CLS_FC = [16]
    m.ROI_HEAD.update(SHARED_FC=[32, 32])
    m.ROI_HEAD.ROI_GRID_POOL.update(GRID_SIZE=3, MLPS=[[16, 16]])
    m.ROI_HEAD.NMS_CONFIG.update(TRAIN_PRE=128, TEST_PRE=128, TEST_POST=32)
    m.ROI_HEAD.TARGET_CONFIG.ROI_PER_IMAGE = 32
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 512
    yaml_path = tmp_path / "pv_rcnn_small.yaml"
    yaml_path.write_text(yaml.safe_dump({k: _plain(cfg[k]) for k in (
        "CLASS_NAMES", "DATA_CONFIG", "MODEL", "OPTIMIZATION")}))
    base = ["--cfg_file", str(yaml_path), "--device", "cpu", "--workers", "1", "--output_dir",
            str(tmp_path / "out"), "--batch_size", "2"]
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tmp_path / "kitti")]
    losses = []
    first = train.main(base + ["--epochs", "1", "--seed", "3"] + data,
                       metric_hook=lambda epoch, it, metrics: losses.append(
                           {k: float(v) for k, v in metrics.items() if k in terms}))
    assert first["iterations"] == len(ids["train"]) // 2 == 2
    assert len(losses) == 2 and all(set(x) == terms for x in losses)
    assert all(np.isfinite(list(x.values())).all() for x in losses)
    assert all(torch.isfinite(p).all() for p in first["state"].net.parameters())
    ckpt = first["ckpt_dir"] / "checkpoint_epoch_1.pth"
    (res,) = test.main(base + ["--ckpt", str(ckpt)] + data)
    annos = res["det_annos"]
    assert [a["frame_id"] for a in annos] == ids["val"]
    assert res["result_str"].splitlines()[0].startswith("Car AP_bev R40 easy/mod/hard")
    assert all(np.isfinite(a["boxes_lidar"]).all() and len(a["score"]) <= 100 for a in annos)


def test_eval_forward_leaves_inputs_unchanged(pvrcnn):
    """The forward adds keys to its batch dict and changes no input."""
    (cfg, _, _, _, _, net, host), _, _ = pvrcnn
    inputs = {k: torch.from_numpy(copy.deepcopy(host[k])) for k in INPUT_KEYS}
    before = {k: v.clone() for k, v in inputs.items()}
    with torch.no_grad():
        net(dict(inputs))
    for k, v in before.items():
        assert torch.equal(inputs[k], v), k
