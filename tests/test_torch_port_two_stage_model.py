"""The port's two-stage detectors against the JAX package on the CPU:
Voxel-RCNN's and SECOND-IoU's eval steps (every SECOND-IoU SCORE_TYPE),
the top-k proposals taken without NMS (TRAIN_PRE / TEST_PRE),
the Voxel-RCNN state_dict through the JAX package's pcdet importer, and the
two-stage names and options that raise.  Setup and narrowing:
``tests/torch_port_two_stage_setup.py``.  Detections are held to 1e-4
(f32), the valid slots exactly.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu.utils.torch_import import import_torch_state_dict
from com_tpu_torch.models.dense_heads.anchor_head import decode_anchor_boxes
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.parallel import sharding
from com_tpu_torch.parallel.mesh import DataMesh
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import (conf_shape_for, curriculum_kwargs, make_train_step,
                                      model_input_keys, step_generators)
from com_tpu_torch.utils.registry import DETECTORS
from test_torch_port_slice import _match
from torch_port_two_stage_setup import setup, small_cfg

torch.set_num_threads(2)
ATOL = 1e-4


@pytest.fixture(scope="module")
def voxel_rcnn():
    return setup("voxel_rcnn", seed=21, dp_ratio=0.3)  # eval: dropout off


@pytest.fixture(scope="module")
def second_iou():
    return setup("second_iou", seed=22)


def check_eval(cfg, jmeta, pmeta, jnet, variables, net, host, min_valid=10):
    names = list(cfg.CLASS_NAMES)
    jb, js, jl, jv = (np.asarray(o) for o in jax.jit(
        jax_make_eval_step(jnet, cfg.MODEL, names, jmeta))(variables, host))
    boxes, scores, labels, valid = (t.numpy() for t in make_eval_step(
        net, cfg.MODEL, names, pmeta, device="cpu")(host))
    assert boxes.shape == jb.shape and labels.dtype == np.int32
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() >= min_valid
    for i in range(2):
        rows = lambda b, s, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        worst, one_to_one = _match(rows(boxes, scores, labels, valid), rows(jb, js, jl, jv))
        assert worst <= ATOL and one_to_one, (i, worst)
    return valid


def test_voxel_rcnn_eval_step_matches_jax(voxel_rcnn):
    cfg, *_, net, _ = voxel_rcnn
    assert type(net).__name__ == "VoxelRCNN"
    check_eval(*voxel_rcnn)


@pytest.mark.parametrize("score_type", ["iou", "cls", "weighted_iou_cls", "num_pts_iou_cls",
                                        "score_by_class"])
def test_second_iou_eval_step_matches_jax(second_iou, score_type):
    cfg, jmeta, pmeta, jnet, variables, net, host = second_iou
    post = cfg.MODEL.POST_PROCESSING.NMS_CONFIG
    post.SCORE_TYPE = score_type
    post.SCORE_WEIGHTS = {"iou": 0.3, "cls": 0.7}
    post.SCORE_THRESH = {"cls": 2.0, "iou": 40.0}
    post.SCORE_BY_CLASS = {"Car": "iou", "Pedestrian": "cls", "Cyclist": "cls"}
    try:
        assert ({"points", "points_mask"} <= model_input_keys(cfg.MODEL)) == (
            score_type == "num_pts_iou_cls")
        check_eval(*second_iou, min_valid=4)
    finally:
        for k in ("SCORE_TYPE", "SCORE_WEIGHTS", "SCORE_THRESH", "SCORE_BY_CLASS"):
            post.pop(k)


def test_top_k_proposals_without_nms_match_jax(voxel_rcnn):
    """An RoI ``NMS_CONFIG`` without NMS_THRESH takes the top TEST_PRE /
    TRAIN_PRE decoded anchors as proposals, no NMS
    (``TwoStageDetector._proposals``; no shipped config selects it): the
    eval step equals JAX's at TEST_PRE 64; in training the proposals are the
    top TRAIN_PRE 48 scores, ties to the lower index, as ``lax.top_k``."""
    cfg, jmeta, pmeta, jnet, variables, net, host = voxel_rcnn
    roi = cfg.MODEL.ROI_HEAD
    saved = roi.NMS_CONFIG
    roi.NMS_CONFIG = {"TRAIN": {"TRAIN_PRE": 48}, "TEST": {"TEST_PRE": 64}}
    try:
        valid = check_eval(*voxel_rcnn)
        assert valid.sum(1).max() <= 100
        inputs = {k: torch.from_numpy(np.array(host[k]))
                  for k in model_input_keys(cfg.MODEL)}
        train_net = copy.deepcopy(net).train()  # batch statistics: the fixture's net stays
        with torch.no_grad():
            out = super(type(train_net), train_net).forward(dict(inputs))
            rois, roi_scores, roi_labels, roi_valid = train_net._proposals(out)
    finally:
        roi.NMS_CONFIG = saved
    assert rois.shape == (2, 48, 7) and bool(roi_valid.all())
    head_cfg = cfg.MODEL.DENSE_HEAD
    boxes, scores, labels = decode_anchor_boxes(
        out, train_net.anchors, len(cfg.CLASS_NAMES), train_net.box_coder,
        dir_cfg=head_cfg if head_cfg.get("USE_DIRECTION_CLASSIFIER") else None)
    top, idx = jax.lax.top_k(jnp.asarray(scores.numpy()), 48)
    np.testing.assert_array_equal(roi_scores.numpy(), np.asarray(top))
    idx = torch.from_numpy(np.asarray(idx).astype(np.int64))
    np.testing.assert_array_equal(rois.numpy(), torch.gather(
        boxes, 1, idx[..., None].expand(-1, -1, 7)).numpy())
    np.testing.assert_array_equal(roi_labels.numpy(), torch.gather(labels, 1, idx).numpy())


def test_voxel_rcnn_state_dict_round_trip_through_jax_importer(voxel_rcnn):
    """port state_dict -> the JAX package's pcdet importer -> the flax
    variables the bridge started from: the FC layers under pcdet's names
    (the norms' running_var read back through the importer's eps
    compensation), the first stage exactly.  The pool layers keep
    ``com_tpu``'s folded form, which the importer's fold does not read
    (it wants pcdet's mlps_in / mlps_pos pair)."""
    cfg, _, _, _, variables, net, _ = voxel_rcnn
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    assert sd["roi_head.shared_fc_layer.4.weight"].shape == (32, 32)  # past the dropout slot
    assert sd["roi_head.cls_pred_layer.weight"].shape == (1, 32)
    new_vars, report = import_torch_state_dict(sd, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    pool = sorted(k for k in sd if ".roi_grid_pool_layers." in k
                  and not k.endswith("num_batches_tracked"))
    assert not report["mismatch"], report["mismatch"]
    assert sorted(report["unused"]) == pool
    assert all(".roi_grid_pool_layers." in k for k in report["missing"])
    loaded = [k for k in report["loaded"] if k.startswith("roi_head.")]
    assert len(loaded) == len([k for k in sd if k.startswith("roi_head.")
                               and ".roi_grid_pool_layers." not in k
                               and not k.endswith("num_batches_tracked")])
    flat_new = dict(jax.tree_util.tree_leaves_with_path(new_vars))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        keys = [getattr(p, "key", None) for p in path]
        if any(str(k).startswith(("pre_", "out_")) for k in keys):
            continue
        if keys[-1] == "var" and keys[1] == "roi_head":
            np.testing.assert_allclose(np.asarray(flat_new[path]), np.asarray(leaf), rtol=0,
                                       atol=1e-6, err_msg=str(keys))
        else:
            np.testing.assert_array_equal(np.asarray(flat_new[path]), np.asarray(leaf),
                                          err_msg=str(keys))


def test_second_iou_head_keeps_pcdet_layout(second_iou):
    """SECONDHead's FCs as pcdet's Conv1d (O, I, 1), the dropout slot of
    make_fc_layers after the first IoU block, the output last."""
    *_, net, _ = second_iou
    sd = net.state_dict()
    assert sd["roi_head.shared_fc_layer.0.weight"].shape == (32, 9 * 64, 1)
    assert sd["roi_head.iou_layers.4.weight"].shape == (32, 32, 1)
    assert sd["roi_head.iou_layers.7.weight"].shape == (1, 32, 1)
    assert sd["roi_head.iou_layers.7.bias"].shape == (1,)


@pytest.mark.parametrize("name", ["PVRCNN", "PVRCNNPlusPlus", "PartA2Net", "PointRCNN",
                                  "MPPNet", "MPPNetE2E"])
def test_unported_two_stage_detectors_raise_by_name(name):
    """The unported detectors raise by name; PV-RCNN, PV-RCNN++, PartA2,
    PointRCNN, MPPNet and MPPNetE2E, ported, build (``tests/torch_port_pvrcnn_setup.py``'s,
    ``tests/test_parta2.py``'s and ``tests/test_pointrcnn.py``'s small
    configs; MPPNet and MPPNetE2E their YAMLs at their own Waymo grid)."""
    if name == "MPPNet":
        from com_tpu_torch.utils.config import cfg_from_yaml_file

        cfg = cfg_from_yaml_file("configs/waymo_models/mppnet_4frames.yaml")
        meta = DatasetMeta(cfg.CLASS_NAMES, (-75.2, -75.2, -2, 75.2, 75.2, 4),
                           (0.1, 0.1, 0.15), (1504, 1504, 40), 6)
        net = DETECTORS.get(name)(cfg.MODEL, meta)
        assert type(net).__name__ == name and type(net.roi_head).__name__ == "MPPNetHead"
        assert len(net.roi_head.bbox_embed) == 4
        return
    if name == "MPPNetE2E":
        from com_tpu_torch.utils.config import cfg_from_yaml_file

        cfg = cfg_from_yaml_file(
            "configs/waymo_models/mppnet_e2e_memorybank_inference.yaml")
        meta = DatasetMeta(cfg.CLASS_NAMES, (-74.88, -74.88, -2, 74.88, 74.88, 4),
                           (0.1, 0.1, 0.15), (1498, 1498, 40), 6)
        net = DETECTORS.get(name)(cfg.MODEL, meta)
        assert type(net).__name__ == name and type(net.roi_head).__name__ == "MPPNetHeadE2E"
        assert not hasattr(net.roi_head, "bbox_embed")
        return
    if name == "PartA2Net":
        from test_parta2 import CLASS_NAMES, parta2_cfg

        meta = DatasetMeta(CLASS_NAMES, (-16, -16, -2.4, 16, 16, 2.4), (0.5, 0.5, 0.2),
                           (64, 64, 24), 5)
        net = DETECTORS.get(name)(parta2_cfg(), meta)
        assert type(net).__name__ == name and net.point_head is not None
        return
    if name == "PointRCNN":
        from test_pointrcnn import CLASS_NAMES, pointrcnn_cfg

        meta = DatasetMeta(CLASS_NAMES, (-10, -10, -2, 10, 10, 4), (0.1, 0.1, 6), (200, 200, 1),
                           5)
        net = DETECTORS.get(name)(dict(pointrcnn_cfg()), meta)
        assert type(net).__name__ == name and net.roi_head is not None
        return
    if name.startswith("PVRCNN"):
        from torch_port_pvrcnn_setup import CLASS_NAMES, GRID, small_cfg

        which = "pvrcnn_plusplus" if name == "PVRCNNPlusPlus" else "pvrcnn"
        meta = DatasetMeta(CLASS_NAMES, (-16, -16, -2, 16, 16, 2), (0.5, 0.5, 0.1), GRID, 5)
        net = DETECTORS.get(name)(small_cfg(which), meta)
        assert type(net).__name__ == name and net.pfe is not None
        return
    with pytest.raises(NotImplementedError, match=name):
        DETECTORS.get(name)({}, None)


def test_unported_two_stage_options_raise_by_name(voxel_rcnn):
    cfg, _, pmeta, _, _, net, host = voxel_rcnn
    names = list(cfg.CLASS_NAMES)
    # a CenterHead RPN (decode_center_proposals, ported): the composition
    # builds without anchors and proposes the top 512 candidates through K4's
    # proposal layer, TEST's NMS_POST_MAXSIZE RoIs a scene
    from com_tpu_torch.utils.config import cfg_from_yaml_file

    centerhead = small_cfg("voxel_rcnn")
    head = cfg_from_yaml_file(
        "configs/waymo_models/voxel_rcnn_with_centerhead_dyn_voxel.yaml").MODEL.DENSE_HEAD
    head.update(SHARED_CONV_CHANNEL=16, CLASS_NAMES_EACH_HEAD=[names])
    centerhead.MODEL.DENSE_HEAD = head
    center_net = build_network(centerhead.MODEL, pmeta, device="cpu")
    assert not center_net.anchor_rpn and not hasattr(center_net, "anchors")
    with torch.no_grad():
        out = center_net({k: torch.as_tensor(np.array(host[k]))
                          for k in model_input_keys(centerhead.MODEL)})
    assert out["rois"].shape == (2, 32, 7) and out["roi_valid"].any()
    pointnet = small_cfg("voxel_rcnn")
    pointnet.MODEL.ROI_HEAD.ROI_GRID_POOL.PRE_MLP = False
    with pytest.raises(NotImplementedError, match="PointNetBlock"):
        build_network(pointnet.MODEL, pmeta, device="cpu")
    other = small_cfg("voxel_rcnn")
    other.MODEL.ROI_HEAD.NAME = "MPPNetHead"
    with pytest.raises(NotImplementedError, match="MPPNetHead"):
        make_train_step(net, other.MODEL, names, pmeta, None, None, device="cpu")
    with pytest.raises(NotImplementedError, match="SCORE_TYPE"):
        score = small_cfg("second_iou")
        score.MODEL.POST_PROCESSING.NMS_CONFIG.SCORE_TYPE = "max"
        make_eval_step(net, score.MODEL, names, pmeta, device="cpu")


def test_two_stage_training_under_a_data_mesh_raises(voxel_rcnn):
    """Two-stage training under a data mesh of world 2, which raised until
    the RoI and point-head losses' normalisers went global: the step runs.
    A mesh of world 2 without a process group issues no collective, so its
    loss (seeded RoI sampling, dropout 0.3) is the single process's
    bitwise; the two-rank gloo run against
    ``com_tpu``'s 2-device mesh step is ``test_torch_port_two_stage_mesh.py``."""
    cfg, _, pmeta, _, _, net, host = voxel_rcnn
    net = copy.deepcopy(net)
    start = copy.deepcopy(net.state_dict())
    names = list(cfg.CLASS_NAMES)
    opt = torch.optim.SGD(net.parameters(), lr=0.0)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    plain, _, _, tb = step.loss_fn(state, host, 0, rngs=step_generators(5, 0, "cpu"))
    net.load_state_dict(start)
    sharding.activate(DataMesh(0, 2, torch.device("cpu")))
    try:
        meshed, _, _, mtb = step.loss_fn(state, host, 0, rngs=step_generators(5, 0, "cpu"))
    finally:
        sharding.activate(None)
    assert torch.equal(plain, meshed) and set(tb) == set(mtb)
    assert {"rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner"} <= set(tb)
    assert isinstance(pmeta, DatasetMeta)