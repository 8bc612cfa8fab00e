"""The image models against ``com_tpu`` on the CPU: CaDDN (``ImageVFE``,
``Conv2DCollapse``) at ``tests/test_caddn.py``'s size and the focal
multimodal backbone (``VoxelBackBone8xFocal`` with ``USE_IMG``, focal convs
at stages 0 and 1) at ``tests/test_focal_multimodal.py``'s, both at batch
2 with perturbed JAX weights carried over by the weight bridge.

Tolerances: ``focal_split_and_spawn`` exact in its voxels, slots and
validity (random and tied scores), its features and the own importance
1e-6; the depth bins exact, projections and samples 1e-5; forward outputs
and eval steps 1e-4; a train step's loss and terms 1e-5 relative and its
gradients and batch statistics as the slice tests'
(``test_torch_port_train_common``), or four times the JAX step's own
difference with the scenes swapped where larger (``check_step``).  The 49-config census and the CLIs of
``CaDDN.yaml`` (its DATA_CONFIG has no images, so both packages fail alike)
are in ``test_torch_port_centerhead_rpn.py`` and here.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_caddn as jcaddn
import test_torch_port_train_common as common
from com_tpu.losses.curriculum import CurriculumState as JaxCurriculumState
from com_tpu.models.backbone3d import focal_conv_loss as jax_focal_conv_loss
from com_tpu.models.backbone3d import voxel_image_features as jax_voxel_image_features
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.models.image_vfe import bin_depths as jax_bin_depths
from com_tpu.models.image_vfe import ddn_loss as jax_ddn_loss
from com_tpu.models.image_vfe import project_to_image as jax_project_to_image
from com_tpu.models.image_vfe import trilinear_sample as jax_trilinear_sample
from com_tpu.ops.sparse import focal_split_and_spawn as jax_focal_split_and_spawn
from com_tpu.ops.voxelize import voxelize_points
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu.train.step import compute_anchor_loss as jax_compute_anchor_loss
from com_tpu.utils.config import CfgNode
from com_tpu_torch.models.backbone3d import focal_conv_loss, voxel_image_features
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.models.image_vfe import (bin_depths, ddn_loss, project_to_image,
                                            trilinear_sample)
from com_tpu_torch.ops.sparse import focal_split_and_spawn
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, curriculum_kwargs, make_train_step
from com_tpu_torch.utils.jax_weights import (curriculum_state_from_jax, load_jax_variables,
                                             params_from_jax, state_dict_from_jax)

torch.set_num_threads(2)
ATOL = 1e-4
POST = {"RECALL_THRESH_LIST": [0.3, 0.5, 0.7], "SCORE_THRESH": 0.1, "OUTPUT_RAW_SCORE": False,
        "EVAL_METRIC": "kitti", "NMS_CONFIG": {"MULTI_CLASSES_NMS": False, "NMS_TYPE": "nms_gpu",
                                               "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 256,
                                               "NMS_POST_MAXSIZE": 50}}
OPT = CfgNode({"OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.01, "MOMENTUM": 0.9,
               "MOMS": [0.95, 0.85], "PCT_START": 0.4, "DIV_FACTOR": 10,
               "DECAY_STEP_LIST": [35, 45], "LR_DECAY": 0.1, "LR_CLIP": 1e-7,
               "LR_WARMUP": False, "WARMUP_EPOCH": 1, "GRAD_NORM_CLIP": 10})


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- the functions ----

def test_bin_depths_and_projection_match_jax():
    rng = np.random.RandomState(0)
    d = np.concatenate([rng.uniform(-2, 60, 500), [2.0, 46.8, np.inf, np.nan]]).astype(np.float32)
    for mode in ("UD", "LID", "SID"):
        np.testing.assert_array_equal(
            bin_depths(_t(d), mode, 2.0, 46.8, 80, target=True).numpy(),
            np.asarray(jax_bin_depths(jnp.asarray(d), mode, 2.0, 46.8, 80, target=True)))
        fin = np.isfinite(d) & (d > 0)
        np.testing.assert_allclose(bin_depths(_t(d[fin]), mode, 2.0, 46.8, 80).numpy(),
                                   np.asarray(jax_bin_depths(jnp.asarray(d[fin]), mode, 2.0,
                                                             46.8, 80)), rtol=1e-5, atol=1e-5)
    pts = rng.uniform(-10, 40, (64, 3)).astype(np.float32)
    proj = rng.randn(3, 4).astype(np.float32)
    for a, b in zip(project_to_image(_t(pts), _t(proj)),
                    jax_project_to_image(jnp.asarray(pts), jnp.asarray(proj))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


def test_trilinear_sample_matches_jax():
    """Inside, on the edges, outside and at the -2 sentinel: zero padding."""
    rng = np.random.RandomState(1)
    vol = rng.randn(5, 7, 9, 3).astype(np.float32)
    coords = np.concatenate([rng.uniform(-1.5, [5.5, 7.5, 9.5], (300, 3)),
                             [[-2.0, -2.0, -2.0], [0, 0, 0], [4, 6, 8], [4.5, 6.5, 8.5]]])
    coords = coords.astype(np.float32)
    np.testing.assert_allclose(trilinear_sample(_t(vol), _t(coords)).numpy(),
                               np.asarray(jax_trilinear_sample(jnp.asarray(vol),
                                                               jnp.asarray(coords))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "ties", "mask_multi"])
def test_focal_split_and_spawn_matches_jax(case):
    """The same voxels in the same slots: the spawn dedup (highest score a
    cell; equal scores, the lower parent row) and the cap (equal scores,
    the lower cell key).  "ties" rounds the logits so that most scores tie."""
    rng = np.random.RandomState({"random": 2, "ties": 3, "mask_multi": 4}[case])
    grid, b, v, c = (6, 8, 8), 2, 48, 5
    coords = np.stack([rng.randint(0, g, (b, v)) for g in grid], -1).astype(np.int32)
    valid = np.zeros((b, v), bool)
    for i in range(b):
        valid[i, np.unique(coords[i] @ np.array([64, 8, 1]), return_index=True)[1]] = True
    valid[:, -4:] = False
    feats = rng.randn(b, v, c).astype(np.float32)
    imps = (rng.randn(b, v, 27) * 2).astype(np.float32)
    if case == "ties":
        imps = np.round(imps).astype(np.float32)
    mm = case == "mask_multi"
    for cap in (10, 40):
        want = jax.vmap(lambda f, co, va, im: jax_focal_split_and_spawn(
            f, co, va, im, grid, 0.5, cap, mm))(feats, coords, valid, imps)
        got = focal_split_and_spawn(_t(feats), _t(coords), _t(valid), _t(imps), grid, 0.5, cap,
                                    mm)
        (wf, wc, wv, wo), (gf, gc, gv, go) = (np.asarray(x) for x in want), got
        assert gv.numpy()[:, v:].sum() > 0
        np.testing.assert_array_equal(gc.numpy(), wc)
        np.testing.assert_array_equal(gv.numpy(), wv)
        np.testing.assert_allclose(gf.numpy(), wf, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(go.numpy(), wo, rtol=1e-6, atol=1e-6)


def test_voxel_image_features_match_jax():
    """Each scene's own calibration, true image extent (less than the padded
    feature map) and world augmentations (rotation, scale, flips)."""
    rng = np.random.RandomState(5)
    b, v, h, w, ch = 3, 200, 24, 40, 6
    feats = rng.randn(b, h, w, ch).astype(np.float32)
    coords = np.stack([rng.randint(0, 40, (b, v)), rng.randint(0, 80, (b, v)),
                       rng.randint(0, 80, (b, v))], -1).astype(np.int32)
    valid = rng.rand(b, v) > 0.1
    l2c = np.zeros((b, 4, 4), np.float32)
    l2c[:, 0, 1], l2c[:, 1, 2], l2c[:, 2, 0], l2c[:, 3, 3] = -1, -1, 1, 1
    l2c[:, :3, 3] = rng.uniform(-0.2, 0.2, (b, 3))
    c2i = np.zeros((b, 3, 4), np.float32)
    c2i[:, 0, 0] = c2i[:, 1, 1] = 30.0
    c2i[:, 0, 2], c2i[:, 1, 2], c2i[:, 2, 2] = 80.0, 48.0, 1.0
    hw = np.array([[96, 160], [90, 150], [80, 160]], np.int32)
    rot = np.array([0.0, 0.3, -0.5], np.float32)
    scale = np.array([1.0, 1.05, 0.95], np.float32)
    fx, fy = np.array([False, True, False]), np.array([False, False, True])
    pc = np.array([0.0, -20.0, -2.0, 40.0, 20.0, 2.0], np.float32)
    want = jax.vmap(lambda f, c_, va, a, bb, s, r, sc, x, y: jax_voxel_image_features(
        f, c_, va, (41, 80, 80), 1, (0.5, 0.5, 0.1), jnp.asarray(pc), a, bb, 4.0, s, r, sc, x, y))(
        feats, coords, valid, l2c, c2i, hw, rot, scale, fx, fy)
    got = voxel_image_features(_t(feats), _t(coords), _t(valid), 1, (0.5, 0.5, 0.1), _t(pc),
                               _t(l2c), _t(c2i), 4.0, _t(hw), _t(rot), _t(scale), _t(fx), _t(fy))
    assert (np.abs(np.asarray(want)).sum(-1) > 0).sum() > 100
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---- CaDDN ----

def caddn_setup():
    cfg = CfgNode({"CLASS_NAMES": list(jcaddn.CLASS_NAMES), "MODEL": jcaddn.caddn_cfg(),
                   "OPTIMIZATION": OPT})
    cfg.MODEL.POST_PROCESSING = CfgNode(copy.deepcopy(POST))
    host = {k: np.array(v) for k, v in jcaddn.make_batch(np.random.RandomState(0), b=2).items()}
    host["gt_boxes"][1, 1] = [12.0, -2.0, -0.4, 4.0, 1.8, 1.6, -0.5, 1]
    host["gt_boxes2d"][1, 1] = [5, 8, 40, 30]
    args = (list(cfg.CLASS_NAMES), [2.0, -8.0, -2.0, 18.0, 8.0, 2.0], [0.5, 0.5, 0.25],
            (32, 32, 16), 0)
    return cfg, host, JaxMeta(*args), DatasetMeta(*args)


def bridged(cfg, jmeta, pmeta, host, input_keys, seed):
    names = list(cfg.CLASS_NAMES)
    jnet = jax_build_network(cfg.MODEL, jmeta)
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), {k: host[k] for k in input_keys}, train=False)
    variables = common.perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed=seed)
    head = next(k for k in variables["params"] if k.startswith("AnchorHeadSingle"))
    variables["params"][head]["conv_cls"]["bias"] = variables["params"][head]["conv_cls"][
        "bias"] + 4.0
    variables["params"][head]["conv_box"]["kernel"] *= 0.02
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, names)
    return jnet, variables, net


def swapped(host):
    """The batch with its two scenes in the other order (the same math)."""
    return {k: (np.asarray(v)[::-1].copy() if np.ndim(v) and len(v) == 2 else v)
            for k, v in host.items()}


def step_tolerance_ratio(grads, want):
    """The worst |grads - want| over ``check_grads``' step tolerance (rtol
    1e-4, atol 1e-6 of the tensor's max |g| + 1e-5 of the net's)."""
    gmax = max(np.abs(v).max() for v in want.values())
    return max(float((np.abs(grads[k] - w) / (1e-4 * np.abs(w) + 1e-6 * np.abs(w).max()
                                               + 1e-5 * gmax)).max()) for k, w in want.items())


def check_step(r):
    """The slice tests' tolerances (loss and terms 1e-5 relative, gradients
    ``check_grads``', statistics 1e-5), or four times the JAX step's own
    difference with its two scenes swapped where that is larger: the image
    trunk's training-mode norms over [0, 1] images (mean large against the
    spread) amplify the f32 rounding of its convs to ~2e-5 relative at the
    depth logits in either package, and the swap reorders only the batch's
    sums."""
    own = abs(r["swapped_loss"] - r["jax_loss"])
    assert abs(r["loss"] - r["jax_loss"]) <= max(1e-5 * abs(r["jax_loss"]), 4 * own)
    assert set(r["tb"]) == set(r["jax_tb"])
    for k, v in r["jax_tb"].items():
        own = abs(r["swapped_tb"][k] - v)
        assert abs(r["tb"][k] - v) <= max(1e-5 * max(abs(v), 1e-6), 4 * own), k
    assert set(r["grads"]) == set(r["jax_grads"])
    own = step_tolerance_ratio(r["swapped_grads"], r["jax_grads"])
    assert step_tolerance_ratio(r["grads"], r["jax_grads"]) <= max(1.0, 4 * own), own
    for k, want in r["jax_stats"].items():
        own = np.abs(r["swapped_stats"][k] - want).max()
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=max(1e-5, 4 * own),
                                   err_msg=k)


def step_pair(cfg, jmeta, pmeta, jnet, variables, net, host, extra_loss):
    """The JAX loss (anchor loss + ``extra_loss(out)``) and its gradients,
    also on the scenes swapped, against the port's ``loss_fn`` and
    backward, from the same weights."""
    names = list(cfg.CLASS_NAMES)
    jcur = (JaxCurriculumState.create(),)

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"])
        loss, _, _, tb = jax_compute_anchor_loss(out, cfg.MODEL, names, jmeta, jcur, 0)
        name, extra = extra_loss(out)
        tb[name] = extra
        return loss + extra, (mut["batch_stats"], tb)

    ((jloss, (jbs, jtb)), jgrads), ((sloss, (sbs, stb)), sgrads) = (
        common.jax_value_and_grad_many(loss_fn, variables, [host, swapped(host)]))
    net = copy.deepcopy(net)
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    state.curriculum = curriculum_state_from_jax(jcur)
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    loss, _, _, tb = step.loss_fn(state, host, 0)
    loss.backward()
    return dict(
        jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
        jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
        jax_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL, names).items()
            if "running" in k},
        swapped_loss=float(sloss), swapped_tb={k: float(v) for k, v in stb.items()},
        swapped_grads=params_from_jax(sgrads, cfg.MODEL, names),
        swapped_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": sbs}, cfg.MODEL, names).items()
            if "running" in k},
        loss=float(loss.detach()), tb={k: float(v.detach()) for k, v in tb.items()},
        metrics={"loss": float(loss.detach())},
        grads={k: q.grad.numpy().copy() for k, q in net.named_parameters()},
        stats={k: v.numpy().copy() for k, v in net.state_dict().items() if "running" in k},
        step=make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu"), state=state)


@pytest.fixture(scope="module")
def caddn():
    cfg, host, jmeta, pmeta = caddn_setup()
    keys = ("images", "trans_lidar_to_cam", "trans_cam_to_img")
    jnet, variables, net = bridged(cfg, jmeta, pmeta, host, keys, seed=11)
    names = list(cfg.CLASS_NAMES)
    jax_eval = [np.asarray(o) for o in jax.jit(jax_make_eval_step(jnet, cfg.MODEL, names, jmeta))(
        variables, {k: host[k] for k in keys})]
    pair = step_pair(cfg, jmeta, pmeta, jnet, variables, net, host,
                     lambda out: ("ddn_loss", jax_ddn_loss(out | {"depth_maps": host["depth_maps"],
                                                                  "gt_boxes2d": host["gt_boxes2d"]},
                                                           cfg.MODEL.VFE)))
    return dict(cfg=cfg, host=host, jnet=jnet, variables=variables, net=net, pmeta=pmeta,
                jax_eval=jax_eval, pair=pair, keys=keys)


def test_caddn_forward_matches_jax(caddn):
    """ImageVFE's depth logits and voxel volume, Conv2DCollapse's BEV map and
    the anchor head's raw outputs in eval mode."""
    host, keys = caddn["host"], caddn["keys"]
    with torch.no_grad():
        mine = caddn["net"]({k: _t(host[k]) for k in keys})
    ref = jax.jit(lambda v, b: caddn["jnet"].apply(v, b, train=False))(
        caddn["variables"], {k: host[k] for k in keys})
    assert mine["encoded_spconv_tensor"].shape == (2, 16, 32, 32, 16)
    assert np.abs(np.asarray(ref["encoded_spconv_tensor"])).max() > 1e-3
    for key in ("depth_logits", "encoded_spconv_tensor", "spatial_features", "cls_preds_raw",
                "box_preds_raw", "dir_cls_preds_raw"):
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(ref[key]), rtol=1e-4,
                                   atol=ATOL, err_msg=key)


def test_caddn_eval_step_matches_jax(caddn):
    step = make_eval_step(caddn["net"], caddn["cfg"].MODEL, list(caddn["cfg"].CLASS_NAMES),
                          caddn["pmeta"], device="cpu")
    boxes, scores, labels, valid = (x.numpy() for x in step(caddn["host"]))
    jb, js, jlab, jv = caddn["jax_eval"]
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 0
    np.testing.assert_allclose(boxes[valid], jb[jv], rtol=0, atol=ATOL)
    np.testing.assert_allclose(scores[valid], js[jv], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(labels[valid], jlab[jv])


def test_ddn_loss_matches_jax(caddn):
    host = caddn["host"]
    rng = np.random.RandomState(7)
    logits = rng.randn(2, 16, 24, 17).astype(np.float32)
    batch = {"depth_logits": logits, "depth_maps": host["depth_maps"],
             "gt_boxes2d": host["gt_boxes2d"]}
    cfg = caddn["cfg"].MODEL.VFE
    want = float(jax_ddn_loss({k: jnp.asarray(v) for k, v in batch.items()}, cfg))
    got = float(ddn_loss({k: _t(v) for k, v in batch.items()}, cfg))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_caddn_train_step_matches_jax(caddn):
    """The loss and its terms (rpn_* and ddn_loss), every gradient (the DDN's
    too) and the batch statistics; then the whole step is finite."""
    r = caddn["pair"]
    assert set(r["tb"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "ddn_loss"}
    assert any(k.startswith("vfe.ffn.ddn.") for k in r["grads"])
    check_step(r)
    _, metrics = r["step"](r["state"], caddn["host"], 0)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["ddn_loss"]) > 0


# ---- the focal multimodal backbone ----

def focal_setup():
    """``test_focal_multimodal.py``'s SECONDNet with the focal backbone, here
    with focal convs at stages 0 and 1 besides the multimodal one, over two
    scenes with their own calibration and augmentations."""
    import test_focal_multimodal as jfocal
    from com_tpu.data.kitti.calibration import calib_to_matricies

    rng = np.random.RandomState(0)
    pc_range, vsize = [0, -16, -2.0, 32, 16, 2.0], [0.5, 0.5, 0.1]
    scenes = []
    for _ in range(2):
        pts = np.concatenate([rng.uniform(1, 30, (2000, 1)), rng.uniform(-14, 14, (2000, 1)),
                              rng.uniform(-1.4, 1.4, (2000, 1)), rng.rand(2000, 1)],
                             axis=1).astype(np.float32)
        scenes.append([np.asarray(a) for a in voxelize_points(pts, pc_range, vsize, 5, 1024,
                                                              pad_to_max=True)])
    l2c, c2i = calib_to_matricies(jfocal._calib())
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, :2, 0] = [10, 20]
    gt[:, :2, 3:6] = [4.7, 2.1, 1.7]
    gt[:, :2, 7] = 1
    gt[1, :2, 1] = [3.0, -4.0]
    host = {"voxels": np.stack([s[0] for s in scenes]),
            "voxel_coords": np.stack([s[1] for s in scenes]),
            "voxel_num_points": np.stack([s[2] for s in scenes]), "gt_boxes": gt,
            "images": rng.rand(2, 96, 160, 3).astype(np.float32),
            "image_shape": np.array([[96, 160], [90, 150]], np.int32),
            "trans_lidar_to_cam": np.stack([l2c, l2c]).astype(np.float32),
            "trans_cam_to_img": np.stack([c2i, c2i]).astype(np.float32),
            "noise_rot": np.array([0.0, 0.1], np.float32),
            "noise_scale": np.array([1.0, 1.02], np.float32),
            "flip_x": np.array([False, True]), "flip_y": np.array([False, False])}
    model = CfgNode({
        "NAME": "SECONDNet", "VFE": {"NAME": "MeanVFE"},
        "BACKBONE_3D": {"NAME": "VoxelBackBone8xFocal", "USE_IMG": True, "IMG_CHANNELS": 8,
                        "CHANNELS": [8, 16, 32, 32], "VOXEL_CAPS": [1024, 512, 256, 128],
                        "FOCAL_STAGES": [0, 1], "FOCAL_THRESHOLD": 0.5, "SPAWN_CAP": 256},
        "MAP_TO_BEV": {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 32},
        "BACKBONE_2D": {"NAME": "BaseBEVBackbone", "LAYER_NUMS": [1], "LAYER_STRIDES": [1],
                        "NUM_FILTERS": [32], "UPSAMPLE_STRIDES": [1],
                        "NUM_UPSAMPLE_FILTERS": [32]},
        "DENSE_HEAD": {
            "NAME": "AnchorHeadSingle", "USE_DIRECTION_CLASSIFIER": True,
            "DIR_OFFSET": 0.78539, "NUM_DIR_BINS": 2,
            "ANCHOR_GENERATOR_CONFIG": [
                {"class_name": "Car", "anchor_sizes": [[4.7, 2.1, 1.7]],
                 "anchor_rotations": [0, 1.57], "anchor_bottom_heights": [0],
                 "align_center": False, "feature_map_stride": 8,
                 "matched_threshold": 0.55, "unmatched_threshold": 0.4}],
            "LOSS_CONFIG": {"LOSS_WEIGHTS": {"cls_weight": 1.0, "loc_weight": 2.0,
                                             "dir_weight": 0.2, "code_weights": [1.0] * 7}}},
        "POST_PROCESSING": copy.deepcopy(POST)})
    cfg = CfgNode({"CLASS_NAMES": ["Car"], "MODEL": model, "OPTIMIZATION": OPT})
    args = (["Car"], pc_range, vsize, (64, 64, 40), 4)
    return cfg, host, JaxMeta(*args), DatasetMeta(*args)


@pytest.fixture(scope="module")
def focal():
    cfg, host, jmeta, pmeta = focal_setup()
    keys = ("voxels", "voxel_coords", "voxel_num_points", "images", "image_shape",
            "trans_lidar_to_cam", "trans_cam_to_img", "noise_rot", "noise_scale", "flip_x",
            "flip_y")
    jnet, variables, net = bridged(cfg, jmeta, pmeta, host, keys, seed=12)
    names = list(cfg.CLASS_NAMES)
    jax_eval = [np.asarray(o) for o in jax.jit(jax_make_eval_step(jnet, cfg.MODEL, names, jmeta))(
        variables, {k: host[k] for k in keys})]
    pair = step_pair(cfg, jmeta, pmeta, jnet, variables, net, host, lambda out: (
        "loss_box_of_pts", jax_focal_conv_loss(out, jmeta.voxel_size, jmeta.point_cloud_range)))
    return dict(cfg=cfg, host=host, jnet=jnet, variables=variables, net=net, jmeta=jmeta,
                pmeta=pmeta, jax_eval=jax_eval, pair=pair, keys=keys)


def test_focal_backbone_forward_matches_jax(focal):
    """The focal convs' enlarged voxel sets (coords exact), own importance,
    the dense volume and the head's raw outputs; the focal loss."""
    host, keys = focal["host"], focal["keys"]
    with torch.no_grad():
        mine = focal["net"]({k: _t(host[k]) for k in keys} | {"gt_boxes": _t(host["gt_boxes"])})
    ref = jax.jit(lambda v, b: focal["jnet"].apply(v, b, train=False))(
        focal["variables"], {k: host[k] for k in keys})
    assert mine["focal_strides"] == [int(s) for s in ref["focal_strides"]] == [1, 1, 2]
    for a, b, va in zip(mine["focal_coords"], ref["focal_coords"], ref["focal_valid"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b, va in zip(mine["focal_probs"], ref["focal_probs"], ref["focal_valid"]):
        va = np.asarray(va)
        np.testing.assert_allclose(a.numpy()[va], np.asarray(b)[va], rtol=1e-5, atol=1e-5)
    c1, r1 = mine["multi_scale_3d_features"]["x_conv2"], ref["multi_scale_3d_features"]["x_conv2"]
    np.testing.assert_array_equal(c1[2].numpy(), np.asarray(r1[2]))  # spawned at stage 1 too
    assert c1[2].numpy()[:, 512:].sum() > 0
    for key in ("encoded_spconv_tensor", "cls_preds_raw", "box_preds_raw"):
        np.testing.assert_allclose(mine[key].numpy(), np.asarray(ref[key]), rtol=1e-4,
                                   atol=ATOL, err_msg=key)
    want = float(jax_focal_conv_loss(dict(ref) | {"gt_boxes": host["gt_boxes"],
                                                  "focal_strides": [1, 1, 2]},
                                     focal["jmeta"].voxel_size, focal["jmeta"].point_cloud_range))
    got = float(focal_conv_loss(mine, focal["pmeta"].voxel_size, focal["pmeta"].point_cloud_range))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_focal_eval_step_matches_jax(focal):
    step = make_eval_step(focal["net"], focal["cfg"].MODEL, ["Car"], focal["pmeta"], device="cpu")
    boxes, scores, labels, valid = (x.numpy() for x in step(focal["host"]))
    jb, js, jlab, jv = focal["jax_eval"]
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 0
    np.testing.assert_allclose(boxes[valid], jb[jv], rtol=0, atol=ATOL)
    np.testing.assert_allclose(scores[valid], js[jv], rtol=0, atol=ATOL)


def test_focal_train_step_matches_jax(focal):
    """The loss and its terms (rpn_* and loss_box_of_pts), every gradient
    (the image encoder's through the gathered features) and the batch
    statistics; then the whole step moves the image encoder."""
    r = focal["pair"]
    assert set(r["tb"]) == {"rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "loss_box_of_pts"}
    assert np.abs(r["grads"]["backbone_3d.semseg.body.0.weight"]).max() > 0
    check_step(r)
    net = r["state"].net
    before = net.backbone_3d.semseg.body[0].weight.detach().clone()
    _, metrics = r["step"](r["state"], focal["host"], 0)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(before, net.backbone_3d.semseg.body[0].weight)
