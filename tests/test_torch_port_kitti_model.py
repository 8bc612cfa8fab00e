"""The port's ``AnchorHeadMulti`` and ``configs/kitti_models/
second_multihead.yaml`` against the JAX package on the CPU.

The head alone, with the flax variables carried by the weight bridge, f32
to 1e-4 in eval and train mode (outputs and batch statistics):
``tests/test_anchor_multi_atss.py``'s grouped config (two heads, one of two
classes, SEPARATE_REG_CONFIG with a middle conv) and second_multihead's
head (three one-class heads).  SECOND-multihead over
``test_torch_port_voxel_model.py``'s scenes at its 64 x 64 x 40 grid,
narrowed (the 3D backbone, a one-layer BEV backbone, a 16-wide shared
conv): detections to 1e-4 (each head's class bias +4, box kernel x0.02, as
the anchor eval tests do) and one train step's loss, gradients and batch
statistics as ``test_torch_port_anchor_train.py`` holds path E's.  Also
``nuscenes_models/cbgs_second_multihead.yaml`` at a small grid with z = 1,
held alike in both packages (the config is frozen: recorded, not repaired).
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
from com_tpu.losses.curriculum import CurriculumState as JaxCurriculumState
from com_tpu.models.dense_heads.anchor_head import AnchorHeadMulti as JaxMulti
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu.train.step import compute_anchor_loss as jax_compute_anchor_loss
from com_tpu.utils.config import cfg_from_yaml_file
from com_tpu_torch.models.dense_heads.anchor_head import AnchorHeadMulti
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, curriculum_kwargs, make_train_step
from com_tpu_torch.utils.jax_weights import (curriculum_state_from_jax, load_jax_variables,
                                             params_from_jax, state_dict_from_jax)
from test_torch_port_slice import _match
from test_torch_port_voxel_model import VOXEL_KEYS, jax_variables, metas, narrow, scenes

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
MULTIHEAD = "configs/kitti_models/second_multihead.yaml"
CBGS = "configs/nuscenes_models/cbgs_second_multihead.yaml"
ATOL = 1e-4
GROUPED_NAMES = ("car", "truck", "pedestrian")
GROUPED = {  # tests/test_anchor_multi_atss.py's
    "NAME": "AnchorHeadMulti", "SHARED_CONV_NUM_FILTER": 16,
    "ANCHOR_GENERATOR_CONFIG": [
        {"class_name": n, "anchor_sizes": [s], "anchor_rotations": [0, 1.57],
         "anchor_bottom_heights": [h], "align_center": False, "feature_map_stride": 8,
         "matched_threshold": 0.6, "unmatched_threshold": 0.45}
        for n, s, h in (("car", [4.6, 2.0, 1.7], -1.0), ("truck", [7.0, 2.5, 2.8], -0.6),
                        ("pedestrian", [0.8, 0.7, 1.7], -1.0))],
    "RPN_HEAD_CFGS": [{"HEAD_CLS_NAME": ["car"]}, {"HEAD_CLS_NAME": ["truck", "pedestrian"]}],
    "SEPARATE_REG_CONFIG": {"NUM_MIDDLE_CONV": 1, "NUM_MIDDLE_FILTER": 16,
                            "REG_LIST": ["reg:2", "height:1", "size:3", "angle:1"]},
    "USE_DIRECTION_CLASSIFIER": True, "NUM_DIR_BINS": 2,
}
OUT_KEYS = ("cls_preds_raw", "box_preds_raw", "dir_cls_preds_raw")


def head_pair(cfg, names, cin, seed):
    """The flax head's variables (perturbed) and the port's head with them."""
    x = np.random.RandomState(seed).rand(2, 8, 8, cin).astype(np.float32)
    jhead = JaxMulti(model_cfg=cfg, input_channels=cin, num_class=len(names),
                     class_names=tuple(names))
    v = jhead.init(jax.random.PRNGKey(seed), {"spatial_features_2d": jnp.asarray(x)},
                   train=False)
    v = common.perturb(jax.tree_util.tree_map(np.asarray, dict(v)), seed=seed)
    head = AnchorHeadMulti(cfg, cin, len(names), names)
    sd = state_dict_from_jax({coll: {"AnchorHeadMulti_0": tree} for coll, tree in v.items()},
                             {"VFE": {"NAME": "MeanVFE"}, "DENSE_HEAD": cfg}, names)
    missing, unexpected = head.load_state_dict(
        {k[len("dense_head."):]: torch.from_numpy(a) for k, a in sd.items()}, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return jhead, v, head, x


def grouped_cfg():
    return copy.deepcopy(GROUPED), list(GROUPED_NAMES), 16


def multihead_cfg():
    cfg = cfg_from_yaml_file(str(REPO / MULTIHEAD))
    return dict(cfg.MODEL.DENSE_HEAD), list(cfg.CLASS_NAMES), 32


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("which", ["grouped", "second_multihead"])
def test_anchor_head_multi_matches_flax(which, train):
    cfg, names, cin = grouped_cfg() if which == "grouped" else multihead_cfg()
    jhead, v, head, x = head_pair(cfg, names, cin, seed=3)
    batch = {"spatial_features_2d": jnp.asarray(x)}
    if train:
        want, mut = jhead.apply(v, batch, train=True, mutable=["batch_stats"])
        head.train()
    else:
        want = jhead.apply(v, batch, train=False)
        head.eval()
    got = head({"spatial_features_2d": torch.from_numpy(x)})
    for k in OUT_KEYS:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=ATOL,
                                   atol=ATOL, err_msg=k)
    cls = got["cls_preds_raw"].detach().reshape(2, 64, -1, len(names)).numpy()
    assert (cls[..., 0:2, 1:] == -20.0).all() and (cls[..., 0:2, 0] != -20.0).all()
    if train:
        sd = state_dict_from_jax(
            {"params": {"AnchorHeadMulti_0": v["params"]},
             "batch_stats": {"AnchorHeadMulti_0": mut["batch_stats"]}},
            {"VFE": {"NAME": "MeanVFE"}, "DENSE_HEAD": cfg}, names)
        own = head.state_dict()
        for k, want_stat in sd.items():
            if "running" in k:
                np.testing.assert_allclose(own[k[len("dense_head."):]].numpy(), want_stat,
                                           rtol=1e-5, atol=1e-5, err_msg=k)


def test_anchor_head_multi_names_and_bf16_input():
    """pcdet's names where they exist (``shared_conv``, ``rpn_heads.{i}.
    conv_cls/conv_box/conv_dir_cls``); a bf16 map (mixed precision) runs the
    shared conv in bf16 and gives f32 predictions, as flax promotes."""
    cfg, names, cin = multihead_cfg()
    head = AnchorHeadMulti(cfg, cin, len(names), names)
    keys = set(head.state_dict())
    for i in range(3):
        assert {f"rpn_heads.{i}.conv_cls.weight", f"rpn_heads.{i}.conv_box.weight",
                f"rpn_heads.{i}.conv_dir_cls.bias"} <= keys
    assert "shared_conv.0.weight" in keys and "shared_conv.1.running_var" in keys
    out = head.eval()({"spatial_features_2d": torch.rand(1, 4, 4, cin, dtype=torch.bfloat16)})
    assert all(out[k].dtype == torch.float32 for k in OUT_KEYS)
    assert out["cls_preds_raw"].shape == (1, 4, 4, 6 * 3)
    grouped, gnames, gcin = grouped_cfg()
    keys = set(AnchorHeadMulti(grouped, gcin, 3, gnames).state_dict())
    assert {"rpn_heads.1.conv_mid.0.0.weight", "rpn_heads.1.conv_box.conv_size.bias"} <= keys


def multihead_model_cfg():
    cfg = narrow(cfg_from_yaml_file(str(REPO / MULTIHEAD)))
    cfg.MODEL.DENSE_HEAD.SHARED_CONV_NUM_FILTER = 16
    cfg.MODEL.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    return cfg


@pytest.fixture(scope="module")
def multihead_setup():
    host, pc_range, vsize = scenes(seed=13)
    cfg = multihead_model_cfg()
    jmeta, pmeta = metas(cfg, pc_range, vsize)
    jnet = jax_build_network(cfg.MODEL, jmeta)
    variables = jax_variables(jnet, host, seed=14)
    head = variables["params"]["AnchorHeadMulti_0"]
    for i in range(3):
        head[f"h{i}_cls"]["bias"] = head[f"h{i}_cls"]["bias"] + np.float32(4.0)
        head[f"h{i}_box"]["kernel"] = head[f"h{i}_box"]["kernel"] * np.float32(0.02)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, list(cfg.CLASS_NAMES))
    return cfg, jmeta, pmeta, jnet, variables, net, host


def test_second_multihead_eval_step_matches_jax(multihead_setup):
    """The whole model's detections, three-class NMS (MULTI_CLASSES_NMS)."""
    cfg, jmeta, pmeta, jnet, variables, net, host = multihead_setup
    names = list(cfg.CLASS_NAMES)
    assert type(net).__name__ == "SECONDNet" and isinstance(net.dense_head, AnchorHeadMulti)
    assert cfg.MODEL.POST_PROCESSING.NMS_CONFIG.MULTI_CLASSES_NMS
    jb, js, jl, jv = (np.asarray(o) for o in jax.jit(
        jax_make_eval_step(jnet, cfg.MODEL, names, jmeta))(variables, host))
    boxes, scores, labels, valid = (t.numpy() for t in make_eval_step(
        net, cfg.MODEL, names, pmeta, device="cpu")(host))
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 10 and len(np.unique(labels[valid])) == 3
    for i in range(2):
        rows = lambda b, s, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        worst, one_to_one = _match(rows(boxes, scores, labels, valid), rows(jb, js, jl, jv))
        assert worst <= ATOL and one_to_one, (i, worst)


@pytest.fixture(scope="module")
def multihead_step(multihead_setup):
    """One train step of both packages from the same (perturbed) start."""
    cfg, jmeta, pmeta, jnet, variables, _, host = multihead_setup
    names = list(cfg.CLASS_NAMES)
    jcur = (JaxCurriculumState.create(),)

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"])
        loss, new_cur, aux, tb = jax_compute_anchor_loss(out, cfg.MODEL, names, jmeta, jcur, 0)
        return loss, (mut["batch_stats"], tb)

    (jloss, (jbs, jtb)), jgrads = common.jax_value_and_grad(loss_fn, variables, host)
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, names)
    start = copy.deepcopy(net.state_dict())
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, common.TOTAL_STEPS, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    state.curriculum = curriculum_state_from_jax(jcur)
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    loss, _, _, tb = step.loss_fn(state, host, 0)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in net.named_parameters()}
    stats = {k: v.numpy().copy() for k, v in net.state_dict().items() if "running" in k}
    net.load_state_dict(start)
    net.zero_grad(set_to_none=True)
    state, metrics = step(state, host, 0)
    return dict(
        jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
        jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
        jax_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL, names).items()
            if "running" in k},
        loss=float(loss.detach()), tb={k: float(v.detach()) for k, v in tb.items()},
        grads=grads, stats=stats, metrics=metrics)


def test_second_multihead_train_step_loss_matches_jax(multihead_step):
    r = multihead_step
    assert set(r["tb"]) == set(r["jax_tb"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir"}
    assert abs(r["loss"] - r["jax_loss"]) <= 1e-5 * abs(r["jax_loss"])
    for k, v in r["jax_tb"].items():
        assert abs(r["tb"][k] - v) <= 1e-5 * max(abs(v), 1e-6), k
    assert abs(float(r["metrics"]["loss"]) - r["jax_loss"]) <= 1e-5 * abs(r["jax_loss"])


def test_second_multihead_train_step_gradients_match_jax(multihead_step):
    common.check_grads(multihead_step)
    assert any(k.startswith("dense_head.rpn_heads.2.") for k in multihead_step["grads"])
    for k, want in multihead_step["jax_stats"].items():
        np.testing.assert_allclose(multihead_step["stats"][k], want, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_second_multihead_builds_at_its_grid():
    """``build_network`` on the YAML's own KITTI grid (1408 x 1600 x 40)."""
    cfg = cfg_from_yaml_file(str(REPO / MULTIHEAD))
    meta = DatasetMeta(cfg.CLASS_NAMES, cfg.DATA_CONFIG.POINT_CLOUD_RANGE, (0.05, 0.05, 0.1),
                       (1408, 1600, 40), 4)
    net = build_network(cfg.MODEL, meta, device="cpu")
    assert len(net.dense_head.rpn_heads) == 3
    assert net.dense_head.rpn_heads[0].conv_cls.weight.shape == (2, 64, 1, 1)


def test_cbgs_second_multihead_fails_alike():
    """``nuscenes_models/cbgs_second_multihead.yaml`` sets no DATA_PROCESSOR
    and takes the nuScenes dataset config's pillar voxels (0.2 x 0.2 x 8 m,
    so z = 1).  At a small grid with z = 1 neither package builds it: the
    port's ``VoxelResBackBone8x`` computes an output depth of -1 and the BEV
    backbone's first conv asks for -128 input channels; flax builds
    lazily, and the JAX init fails on a negative size in the same 3D
    stack.  ``AnchorHeadMulti`` is never reached.  Recorded, not repaired
    (``configs/`` is frozen)."""
    cfg = cfg_from_yaml_file(str(REPO / CBGS))
    names = list(cfg.CLASS_NAMES)
    vsize = (0.2, 0.2, 8.0)
    pc_range = (-6.4, -6.4, -5.0, 6.4, 6.4, 3.0)
    grid = (64, 64, 1)
    assert list(cfg.DATA_CONFIG.DATA_PROCESSOR[-1]["VOXEL_SIZE"]) == list(vsize)
    assert cfg.MODEL.DENSE_HEAD.NAME == "AnchorHeadMulti"
    with pytest.raises(RuntimeError, match="negative dimension -128"):
        build_network(cfg.MODEL, DatasetMeta(names, pc_range, vsize, grid, 5), device="cpu")
    jnet = jax_build_network(cfg.MODEL, JaxMeta(names, pc_range, vsize, grid, 5))
    host, _, _ = scenes(seed=15)
    host = {k: np.array(host[k]) for k in VOXEL_KEYS}
    host["voxel_coords"][..., 0] = np.minimum(host["voxel_coords"][..., 0], 0)  # z = 1
    with pytest.raises(TypeError, match="nonnegative"):
        jax.eval_shape(lambda b: jnet.init(jax.random.PRNGKey(0), b, train=False),
                       {k: jnp.asarray(host[k]) for k in VOXEL_KEYS})
