"""The CenterHead RPN's two-stage detectors against the JAX package on the
CPU (setup: ``tests/torch_port_centerhead_setup.py``): ``DynamicMeanVFE``
(voxel coordinates exactly, means to 1e-6, one scene past the cap, where
both packages drop the highest-z voxels); ``decode_center_proposals``
(indices, labels and validity exactly, values to 1 ulp-sized 1e-6, the
ValueError on a head's class that the dataset lacks); the eval steps of
``voxel_rcnn_with_centerhead_dyn_voxel.yaml`` and
``pv_rcnn_with_centerhead_rpn.yaml`` narrowed (the proposals, the RCNN
outputs and the detections to 1e-4); one Voxel-RCNN train step
(deterministic RoI sampling, GT on the model's own proposals): the loss
and its terms (``hm_loss_head_0``, ``loc_loss_head_0``, ``rcnn_loss_*``)
to 1e-5, every gradient to the train-step tests' tolerances, the running
statistics to 1e-5; every shipped config built at its own grid (44 of
49; 4 raise NotImplementedError by name and 1 a RuntimeError).  One JAX
jit of a whole forward a model, one of the train step's loss and gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from com_tpu.losses.curriculum import CurriculumState as JaxCurriculumState
from com_tpu.models.detectors import decode_center_proposals as jax_decode_center_proposals
from com_tpu.models.vfe import DynamicMeanVFE as JaxDynamicMeanVFE
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu.train.step import compute_centerpoint_loss as jax_compute_centerpoint_loss
from com_tpu.train.step import compute_roi_loss as jax_compute_roi_loss
from com_tpu_torch.models.dense_heads.center_head import decode_center_proposals
from com_tpu_torch.models.detectors import DatasetMeta
from com_tpu_torch.models.vfe import DynamicMeanVFE
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, curriculum_kwargs, make_train_step
from com_tpu_torch.utils.jax_weights import (curriculum_state_from_jax, params_from_jax,
                                             state_dict_from_jax)
from test_torch_port_parta2 import Replay
from test_torch_port_parta2_train import step_tolerance_ratio
from test_torch_port_slice import _match
from torch_port_centerhead_setup import (GRID, INPUT_KEYS, PC_RANGE, REPO, VOXEL,
                                         proposal_gt, scene_points, setup)

torch.set_num_threads(2)
ATOL = 1e-4
NAMES = ("Vehicle", "Pedestrian", "Cyclist")


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("cap", [4096, 1024])
def test_dynamic_mean_vfe_matches_jax(cap):
    """Two scenes of 3,000 points with every tenth masked and a few out of
    the range: the (B, cap, 3) zyx coordinates bit for bit, -1 in the empty
    slots; the means to 1e-6.  At 1,024 slots (~2,650 voxels a scene) both
    packages keep the cap's lowest z-major keys: the highest-z voxels are
    dropped, and their points with them (the JAX package's behaviour,
    kept)."""
    rng = np.random.RandomState(7)
    pts = scene_points(rng)
    pts[:, :20, 0] += 7.0  # out of the range in x
    mask = np.ones(pts.shape[:2], bool)
    mask[:, ::10] = False
    cfg = {"MAX_VOXELS": cap}
    jvfe = JaxDynamicMeanVFE(model_cfg=cfg, num_point_features=5, voxel_size=VOXEL,
                             point_cloud_range=PC_RANGE, grid_size=GRID)
    want = jax.jit(lambda b: jvfe.apply({}, b))({"points": jnp.asarray(pts),
                                                 "points_mask": jnp.asarray(mask)})
    vfe = DynamicMeanVFE(cfg, 5, VOXEL, PC_RANGE, GRID)
    got = vfe({"points": t(pts), "points_mask": t(mask)})
    coords, jcoords = got["voxel_coords"].numpy(), np.asarray(want["voxel_coords"])
    assert coords.dtype == np.int32 and coords.shape == (2, cap, 3)
    np.testing.assert_array_equal(coords, jcoords)
    np.testing.assert_allclose(got["pillar_features"].numpy(), np.asarray(want["pillar_features"]),
                               rtol=1e-6, atol=1e-6)
    cell = np.floor((pts[..., :3] - np.array(PC_RANGE[:3], np.float32))
                    / np.array(VOXEL, np.float32)).astype(np.int64)
    inb = mask & (cell >= 0).all(-1) & (cell < np.array(GRID)).all(-1)
    for i in range(2):
        c = cell[i][inb[i]]
        keys = np.unique((c[:, 2] * GRID[1] + c[:, 1]) * GRID[0] + c[:, 0])
        kept = coords[i][coords[i, :, 0] >= 0]
        assert len(kept) == min(cap, len(keys))
        got_keys = (kept[:, 0].astype(np.int64) * GRID[1] + kept[:, 1]) * GRID[0] + kept[:, 2]
        np.testing.assert_array_equal(got_keys, keys[:cap])  # the lowest keys, in order
        if cap < len(keys):  # past the cap: the top z planes hold no voxel
            assert kept[:, 0].max() < c[:, 2].max()
            assert (len(keys) - cap) > 1000


def test_decode_center_proposals_matches_jax():
    """Two heads ([Vehicle], [Pedestrian, Cyclist]) with a velocity branch
    on an 8 x 8 map, top 100 a head: the labels, the validity (scores over
    0.1) and every score multiplied by its validity equal, boxes to 1e-6
    (exp and atan2 round alike on the CPU here); a head naming a class the
    dataset lacks raises ValueError in both packages."""
    rng = np.random.RandomState(3)
    order = ["center", "center_z", "dim", "rot", "vel"]
    widths = {"center": 2, "center_z": 1, "dim": 3, "rot": 2, "vel": 2}
    preds = []
    for c in (1, 2):
        d = {k: rng.randn(2, 8, 8, w).astype(np.float32) for k, w in widths.items()}
        d["hm"] = (rng.randn(2, 8, 8, c) * 2 - 2).astype(np.float32)
        preds.append(d)
    dh = {"TARGET_ASSIGNER_CONFIG": {"FEATURE_MAP_STRIDE": 8},
          "CLASS_NAMES_EACH_HEAD": [["Vehicle"], ["Pedestrian", "Cyclist"]],
          "SEPARATE_HEAD_CFG": {"HEAD_ORDER": order}}
    meta = DatasetMeta(NAMES, PC_RANGE, VOXEL, GRID, 5)
    want = jax.jit(lambda p: jax_decode_center_proposals({"pred_dicts": p}, dh, meta, k=100))(
        [{k: jnp.asarray(v) for k, v in d.items()} for d in preds])
    got = decode_center_proposals({"pred_dicts": [{k: t(v) for k, v in d.items()}
                                                  for d in preds]}, dh, meta, k=100)
    boxes, scores, labels, valid = (g.numpy() for g in got)
    assert boxes.shape == (2, 164, 9)  # 64 cells + 100 of 128
    np.testing.assert_array_equal(labels, np.asarray(want[2]))
    np.testing.assert_array_equal(valid, np.asarray(want[3]))
    assert 0 < valid.sum() < valid.size
    np.testing.assert_array_equal(scores == 0, ~valid)
    np.testing.assert_allclose(scores, np.asarray(want[1]), rtol=1e-6, atol=0)
    np.testing.assert_allclose(boxes, np.asarray(want[0]), rtol=1e-6, atol=1e-6)
    bad = dict(dh, CLASS_NAMES_EACH_HEAD=[["Vehicle"], ["Pedestrian", "Truck"]])
    with pytest.raises(ValueError, match="Truck"):
        jax_decode_center_proposals({"pred_dicts": preds}, bad, meta)
    with pytest.raises(ValueError, match="Truck"):
        decode_center_proposals({"pred_dicts": [{k: t(v) for k, v in d.items()}
                                                for d in preds]}, bad, meta)


@pytest.fixture(scope="module", params=["voxel_rcnn", "pv_rcnn"])
def evaluated(request):
    """The setup, the JAX eval forward's outputs and its eval step's
    detections of them, the port's eval forward."""
    which = request.param
    s = setup(which)
    cfg, jmeta, _, jnet, variables, net, host = s
    keys = INPUT_KEYS[which]
    jout = jax.jit(lambda v, b: jnet.apply(v, b, train=False))(
        variables, {k: host[k] for k in keys})
    jdet = jax.jit(lambda o: jax_make_eval_step(Replay(o), cfg.MODEL, list(cfg.CLASS_NAMES),
                                                jmeta)(None, {}))(jout)
    jout = jax.tree_util.tree_map(np.asarray, jout)
    with torch.no_grad():
        out = net({k: t(host[k]) for k in keys})
    return which, s, jout, [np.asarray(d) for d in jdet], out


def test_centerhead_rpn_eval_step_matches_jax(evaluated):
    """The proposals (K4's proposal layer over the 192 decoded candidates a
    scene for Voxel-RCNN, the top 192 and then TEST_POST 32 for PV-RCNN),
    the RoIs' labels and validity exactly, their boxes and scores, the RCNN
    class and box outputs and the eval step's detections (paired nearest,
    one to one) to 1e-4."""
    which, (cfg, _, pmeta, _, _, net, host), jout, jdet, out = evaluated
    assert out["pred_dicts"][0]["hm"].shape == (2, 8, 8, 3)
    assert out["rois"].shape == (2, 32, 7) and bool(out["roi_valid"].all())
    for k in ("roi_labels", "roi_valid"):
        np.testing.assert_array_equal(out[k].numpy(), jout[k], err_msg=k)
    for k in ("rois", "roi_scores", "rcnn_cls", "rcnn_reg"):
        np.testing.assert_allclose(out[k].numpy(), jout[k], rtol=ATOL, atol=ATOL, err_msg=k)
    assert float(out["rcnn_reg"].abs().max()) > 0.05
    step = make_eval_step(net, cfg.MODEL, list(cfg.CLASS_NAMES), pmeta, device="cpu")
    boxes, scores, labels, valid = (g.numpy() for g in step(host))
    jb, js, jl, jv = jdet
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 4
    for i in range(2):
        rows = lambda b, s, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        worst, one_to_one = _match(rows(boxes, scores, labels, valid), rows(jb, js, jl, jv))
        assert worst <= ATOL and one_to_one


SWAP = [1, 0]  # the scenes in the other order: the same step in other f32 sums
TERMS = {"hm_loss_head_0", "loc_loss_head_0", "confidence_head_0", "rcnn_loss_cls",
         "rcnn_loss_reg", "rcnn_loss_corner"}


@pytest.fixture(scope="module")
def pair():
    """Voxel-RCNN's loss and gradients in both packages (the CenterPoint
    loss, then the RoI losses, as the JAX step adds them), and the JAX step
    once more with the scenes swapped."""
    cfg, jmeta, pmeta, jnet, variables, net, host = setup("voxel_rcnn", seed=53)
    keys = INPUT_KEYS["voxel_rcnn"]
    host = proposal_gt(net, host, keys)
    names = list(cfg.CLASS_NAMES)
    jcur = (JaxCurriculumState.create(),)

    def loss_fn(params, batch_stats, batch):
        out, mut = jnet.apply({"params": params, "batch_stats": batch_stats}, dict(batch),
                              train=True, mutable=["batch_stats"])
        loss, _, _, tb = jax_compute_centerpoint_loss(out, cfg.MODEL, names, jmeta, jcur, 0,
                                                      (8, 8))
        roi_loss, roi_tb = jax_compute_roi_loss(out, cfg.MODEL)
        tb.update(roi_tb)
        return loss + roi_loss, (mut["batch_stats"], tb, out["roi_targets"].reg_valid)

    step_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    batch = {k: host[k] for k in keys + ("gt_boxes", "num_points_in_gt")}
    (jloss, (jbs, jtb, jfg)), jgrads = step_fn(variables["params"], variables["batch_stats"],
                                               batch)
    (_, (_, stb, _)), sgrads = step_fn(variables["params"], variables["batch_stats"],
                                       {k: v[SWAP] for k, v in batch.items()})
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    state.curriculum = curriculum_state_from_jax(jcur)
    step = make_train_step(net, cfg.MODEL, names, pmeta, opt, None, device="cpu")
    loss, _, _, tb = step.loss_fn(state, host, 0)
    loss.backward()
    return dict(
        jax_loss=float(jloss), jax_tb={k: float(v) for k, v in jtb.items()},
        swapped_tb={k: float(v) for k, v in stb.items()}, jax_fg=np.asarray(jfg),
        jax_grads=params_from_jax(jgrads, cfg.MODEL, names),
        swapped_grads=params_from_jax(sgrads, cfg.MODEL, names),
        jax_stats={k: v for k, v in state_dict_from_jax(
            {"params": variables["params"], "batch_stats": jbs}, cfg.MODEL, names).items()
            if "running" in k},
        loss=float(loss.detach()), tb={k: float(v.detach()) for k, v in tb.items()},
        grads={k: q.grad.numpy().copy() for k, q in net.named_parameters()},
        stats={k: v.numpy().copy() for k, v in net.state_dict().items() if "running" in k})


def test_voxel_rcnn_centerhead_train_step_matches_jax(pair):
    """The loss and every term to 1e-5 (or four times the JAX step's own
    difference with its scenes swapped, where that is larger: the RoI
    head's train-mode norms over 32 rows amplify rounding, as in
    ``test_torch_port_parta2_train.py``), foreground RoIs sampled; every
    gradient (the 3D backbone behind DynamicMeanVFE, the BEV backbone, the
    CenterHead, the grid pool at x_conv2/3/4 and the FCs) to the step
    tolerance or the swap's difference; the running statistics to 1e-5."""
    r = pair
    assert set(r["tb"]) == set(r["jax_tb"]) == TERMS
    assert r["jax_fg"].sum() > 0 and r["tb"]["rcnn_loss_reg"] > 0
    for k, v in r["jax_tb"].items():
        own = abs(r["swapped_tb"][k] - v)
        assert abs(r["tb"][k] - v) <= max(1e-5 * max(abs(v), 1e-6), 4 * own), k
    own = abs(sum(r["swapped_tb"][k] for k in TERMS - {"confidence_head_0"}) - r["jax_loss"])
    assert abs(r["loss"] - r["jax_loss"]) <= max(1e-5 * abs(r["jax_loss"]), 4 * own)
    for prefix in ("backbone_3d.conv_input.", "backbone_3d.conv2.0.", "backbone_3d.conv4.2.",
                   "backbone_2d.", "dense_head.heads_list.0.hm.",
                   "roi_head.roi_grid_pool_layers.0.", "roi_head.roi_grid_pool_layers.2.",
                   "roi_head.shared_fc_layer."):
        assert any(k.startswith(prefix) and np.abs(g).max() > 0
                   for k, g in r["grads"].items()), prefix
    assert set(r["grads"]) == set(r["jax_grads"])
    own = step_tolerance_ratio(r["swapped_grads"], r["jax_grads"])
    assert step_tolerance_ratio(r["grads"], r["jax_grads"]) <= max(1.0, own), own
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)


SHIPPED = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml")
                 if "dataset_configs" not in p.parts)
RAISES = {"configs/kitti_models/CaDDN.yaml": (NotImplementedError, "CaDDN"),
          "configs/kitti_models/voxel_rcnn_car_focal_multimodal.yaml":
              (NotImplementedError, "VoxelBackBone8xFocal"),
          # a head's deblock takes a negative width, in both packages (ROADMAP Queue 3)
          "configs/nuscenes_models/cbgs_second_multihead.yaml": (RuntimeError, "negative")}


def test_shipped_config_census():
    """49 configs ship under ``configs/`` (dataset configs aside): 46 build
    (44 before the MPPNet detector), 2 raise NotImplementedError by name, 1
    a RuntimeError.  The port registers every one's DATA_CONFIG.DATASET
    (KITTI, custom, synthetic, Waymo, nuScenes, Lyft), so all 46 that build
    have their data side too."""
    import com_tpu_torch.data  # noqa: F401  (registers the datasets)
    from com_tpu_torch.utils.config import cfg_from_yaml_file
    from com_tpu_torch.utils.registry import DATASETS

    assert len(SHIPPED) == 49 and set(RAISES) <= set(SHIPPED)
    datasets = {c: cfg_from_yaml_file(str(REPO / c)).DATA_CONFIG.DATASET for c in SHIPPED}
    registered = {c for c, d in datasets.items() if d in DATASETS}
    assert registered == set(SHIPPED)
    assert len(registered - set(RAISES)) == 46
    assert sum(datasets[c] in ("NuScenesDataset", "LyftDataset")
               for c in registered - set(RAISES)) == 6


@pytest.mark.parametrize("config", SHIPPED)
def test_shipped_configs_build_at_their_own_grid(config):
    """Each shipped config's detector built at its own grid (its range over
    its VOXEL_SIZE) and width (the module tree, without ``build_network``'s
    seeded draw of every weight), or the error it is known to raise; the
    three this slice opens with their RPN and RoI head."""
    from com_tpu_torch.ops.voxelize import grid_size_from_range
    from com_tpu_torch.utils.config import cfg_from_yaml_file
    from com_tpu_torch.utils.registry import DETECTORS


    cfg = cfg_from_yaml_file(str(REPO / config))
    dc = cfg.DATA_CONFIG
    pr = list(dc.POINT_CLOUD_RANGE)
    vs = next((list(p.VOXEL_SIZE) for p in dc.get("DATA_PROCESSOR", []) if "VOXEL_SIZE" in p),
              [0.1, 0.1, 0.15])
    feats = len(dc.POINT_FEATURE_ENCODING.used_feature_list) if "POINT_FEATURE_ENCODING" in dc \
        else 4
    meta = DatasetMeta(cfg.CLASS_NAMES, pr, vs, grid_size_from_range(pr, vs), feats)
    if config in RAISES:
        err, name = RAISES[config]
        with pytest.raises(err, match=name):
            DETECTORS.get(cfg.MODEL.NAME)(cfg.MODEL, meta)
        return
    net = DETECTORS.get(cfg.MODEL.NAME)(cfg.MODEL, meta)
    assert type(net).__name__ == cfg.MODEL.NAME
    if config.startswith("configs/waymo_models/mppnet_") and "e2e" not in config:
        assert type(net.roi_head).__name__ == "MPPNetHead" and not hasattr(net, "dense_head")
    if "centerhead" in config or "mppnet_e2e" in config:
        assert meta.grid_size == (1498, 1498, 40)
        assert type(net.dense_head).__name__ == "CenterHead"
        assert type(net.roi_head).__name__ == cfg.MODEL.ROI_HEAD.NAME
        assert not hasattr(net, "anchors")


@pytest.mark.parametrize("which", ["voxel_rcnn", "pv_rcnn", "mppnet"])
def test_chip_smoke_small_case_is_the_tests_config(which):
    """``chip_smoke.centerhead_small_case`` writes the tests' narrowing out
    (the card imports no JAX-side test): the same model config, grid and
    point width."""
    from chip_smoke import centerhead_small_case
    from torch_port_centerhead_setup import small_cfg

    def plain(node):
        if isinstance(node, dict):
            return {k: plain(v) for k, v in node.items()}
        return [plain(v) for v in node] if isinstance(node, (list, tuple)) else node

    cfg, meta, batch = centerhead_small_case(which)
    assert plain(cfg.MODEL) == plain(small_cfg(which).MODEL)
    assert meta.grid_size == GRID and meta.point_cloud_range == PC_RANGE
    assert batch["points"].shape == (2, 3000, 6 if which == "mppnet" else 5)
