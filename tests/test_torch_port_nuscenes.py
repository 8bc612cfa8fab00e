"""The port's nuScenes data side and ``nuscenes_models/cbgs_dyn_pp_centerpoint.
yaml`` fed from it, against ``com_tpu`` on the CPU.

A small nuScenes tree written from a seed by the port's
``com_tpu_torch.tools.dataset_trees`` (2 train and 2 val frames, the key
frame and 9 sweeps of 2,000 points each, a GT database), read by both
packages under the config's own DATA_CONFIG with the same seed, in the same
order on one thread: items (points, 10-column ``gt_boxes``, voxels) and the
collated batch bitwise, with CBGS, both modes, ``PRED_VELOCITY: False`` and
the NaN-velocity zeroing on and off; the missing reseed (an item depends on
the calls before it, alike in both); ``nuscenes_utils`` on
``tests/test_nuscenes_infos.py``'s stub devkit (bitwise); the evaluation's
KITTI-style fallback (APs to 1e-6: the port's IoU is float64, ``com_tpu``'s
float32).  The model at a 64 x 64 x 1 grid (1.6 m pillars over the config's
range), narrowed (one layer a BEV stage, 32 / 64 wide, one conv a head
branch), six CenterHead groups with the velocity head, f32, from the port's loader: the eval step
to 1e-4 and one train step at the step tolerances
(``test_torch_port_train_common``).
"""
import copy
import pickle

import jax
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
from com_tpu.data.nuscenes import nuscenes_dataset as jnd
from com_tpu.data.nuscenes import nuscenes_utils as jnu
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu_torch.data import build_dataloader
from com_tpu_torch.data.nuscenes import nuscenes_dataset as pnd
from com_tpu_torch.data.nuscenes import nuscenes_utils as pnu
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.tools.dataset_trees import NUSCENES_VERSION, write_nuscenes_tree
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.train.step import device_batch_keys, model_input_keys
from com_tpu_torch.utils.jax_weights import load_jax_variables
from test_nuscenes_infos import FakeNusc
from test_torch_port_slice import _match
from torch_port_kitti_setup import assert_same, configs

torch.set_num_threads(2)

CONFIG = "configs/nuscenes_models/cbgs_dyn_pp_centerpoint.yaml"
POINTS = 2000  # a sweep
ATOL = 1e-4
SMALL_VOXEL = [1.6, 1.6, 8.0]  # 64 x 64 x 1 over [-51.2, 51.2]^2


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nuscenes")
    return root, write_nuscenes_tree(root, seed=0, num_train=2, num_val=2, num_points=POINTS)


def pair(root, training, seed=3, **data_cfg):
    """(com_tpu's dataset, the port's) over ``root`` under CONFIG's
    DATA_CONFIG with ``data_cfg`` set."""
    jcfg, pcfg = configs(CONFIG, root)
    for cfg in (jcfg, pcfg):
        cfg.DATA_CONFIG.update(data_cfg)
    return (jnd.NuScenesDataset(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=training,
                                seed=seed),
            pnd.NuScenesDataset(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), training=training,
                                seed=seed))


@pytest.mark.parametrize("training,extra", [
    (True, {}), (False, {}), (True, {"PRED_VELOCITY": False}),
    (True, {"SET_NAN_VELOCITY_TO_ZEROS": False}),
    (False, {"MAX_POINTS_PER_SCENE": 8192})],
    ids=["train", "test", "train-no-velocity", "train-nan-kept", "test-subsampled"])
def test_items_and_batch_match_jax_bitwise(tree, training, extra):
    """Every item of both packages in the same order, then their collate
    (MAX_POINTS_PER_SCENE 8,192 subsamples the ~20,000-point scenes)."""
    root, ids = tree
    jds, pds = pair(root, training, **extra)
    assert len(pds) == len(jds) == (10 if training else 2)  # CBGS: 2 frames -> 10 items
    jitems = [jds[i] for i in range(len(jds))]
    pitems = [pds[i] for i in range(len(pds))]
    for i, (a, b) in enumerate(zip(jitems, pitems)):
        assert_same(a, b, str(i))
    width = 8 if extra.get("PRED_VELOCITY") is False else 10
    assert all(b["gt_boxes"].shape[1] == width for b in pitems)
    nans = sum(int(np.isnan(b["gt_boxes"]).sum()) for b in pitems)
    assert (nans > 0) == (extra.get("SET_NAN_VELOCITY_TO_ZEROS") is False and training)
    assert pitems[0]["points"].shape[1] == 5 and pitems[0]["voxels"].shape[2] == 5
    assert_same(jds.collate_batch(jitems[:4]), pds.collate_batch(pitems[:4]), "batch")


def test_cbgs_and_sweeps_match_jax(tree):
    """CBGS's resampled infos (drawn at construction) and one item's fused
    sweeps: ego points removed from the sweeps only, each sweep moved by
    its transform, the time lag in the fifth column."""
    root, _ = tree
    jds, pds = pair(root, True)
    assert [i["token"] for i in pds.infos] == [i["token"] for i in jds.infos]
    raw = pickle.load(open(root / NUSCENES_VERSION / "nuscenes_infos_10sweeps_train.pkl", "rb"))
    assert len(raw) == 2 and len(pds.infos) == 10
    assert {n for i in raw for n in i["gt_names"]} == set(pds.class_names)
    a, b = jds.get_lidar_with_sweeps(0, 10), pds.get_lidar_with_sweeps(0, 10)
    assert_same(a, b)
    key = np.fromfile(root / NUSCENES_VERSION / raw[0]["lidar_path"], np.float32).reshape(-1, 5)
    near = (np.abs(b[:, 0]) < 1) & (np.abs(b[:, 1]) < 1)
    assert near[: len(key)].sum() > 0 and near[len(key):].sum() == 0
    np.testing.assert_allclose(np.unique(b[:, 4]), 0.05 * np.arange(10), atol=1e-6)


def test_the_missing_reseed_alike(tree):
    """No ``_reseed_for_item`` in either package: item 0 read after item 1
    differs from item 0 read first (the sweep choice and the shuffle
    follow the thread's stream), and both packages differ alike."""
    root, _ = tree
    got = {}
    for order in ((0, 1), (1, 0)):
        jds, pds = pair(root, False)
        ja = {i: jds[i] for i in order}
        pa = {i: pds[i] for i in order}
        assert_same(ja, pa, str(order))
        got[order] = pa[0]["points"]
    assert got[(0, 1)].shape == got[(1, 0)].shape
    assert not np.array_equal(got[(0, 1)], got[(1, 0)])
    assert_same(np.sort(got[(0, 1)], axis=0), np.sort(got[(1, 0)], axis=0))


def test_quaternion_and_result_helpers_match_jax():
    rng = np.random.RandomState(5)
    for _ in range(20):
        q, r = rng.randn(4), rng.randn(4)
        t = rng.randn(3) * 10
        for name, args in (("quat_rotmat", (q,)), ("quat_mul", (q, r)), ("quat_inv", (q,)),
                           ("quaternion_yaw", (q / np.linalg.norm(q),)),
                           ("_quat_elements", (q,)),
                           ("transform_matrix", (t, q)), ("transform_matrix", (t, q, True))):
            assert_same(getattr(jnu, name)(*args), getattr(pnu, name)(*args), name)
    boxes = np.concatenate([rng.randn(6, 7), rng.randn(6, 2)], axis=1)
    names = ["car", "truck", "bus"]
    scores = rng.rand(6)
    assert pnu.boxes_lidar_to_nusc(boxes, scores, [1, 2, 3, 1, 2, 3], names) == \
        jnu.boxes_lidar_to_nusc(boxes, scores, [1, 2, 3, 1, 2, 3], names)
    annos = [{"metadata": {"token": "t0"}, "boxes_lidar": boxes, "score": scores,
              "name": np.array(names * 2)}, {"frame_id": "f1", "boxes_lidar": boxes[:, :7],
                                             "score": scores, "name": np.array(names * 2)}]
    assert pnu.transform_det_annos_to_nusc_annos(annos) == \
        jnu.transform_det_annos_to_nusc_annos(annos)
    assert pnu.MAP_NAME_FROM_GENERAL_TO_DETECTION == jnu.MAP_NAME_FROM_GENERAL_TO_DETECTION


@pytest.mark.parametrize("test", [False, True], ids=["trainval", "test"])
def test_fill_trainval_infos_matches_jax(tmp_path, test):
    """On the stub devkit of ``tests/test_nuscenes_infos.py``: the infos of
    both packages, sweeps and transforms included, bitwise."""
    nusc = FakeNusc(tmp_path)
    want = jnu.fill_trainval_infos(tmp_path, nusc, {"scene_train"}, {"scene_val"}, test=test,
                                   max_sweeps=4)
    got = pnu.fill_trainval_infos(tmp_path, nusc, {"scene_train"}, {"scene_val"}, test=test,
                                  max_sweeps=4)
    assert_same(list(want), list(got))
    assert len(got[0]) == 1 and len(got[1]) == 1
    assert [s["name"] for s in pnu.get_available_scenes(nusc)] == \
        [s["name"] for s in jnu.get_available_scenes(nusc)]


def test_create_nuscenes_info_needs_the_devkit_alike(tmp_path):
    for mod in (jnu, pnu):
        with pytest.raises(ImportError, match="nuscenes-devkit"):
            mod.create_nuscenes_info("v1.0-mini", tmp_path, tmp_path)


def test_evaluation_falls_back_to_kitti_ap_alike(tree):
    """Without the devkit both packages score the val frames by KITTI-style
    AP: the val GT, jittered and scored, as detections."""
    root, _ = tree
    jds, pds = pair(root, False)
    rng = np.random.RandomState(9)
    det_annos = []
    for info in pds.infos:
        g = np.asarray(info["gt_boxes"])[:, :7].copy()
        g[:, :2] += rng.normal(0, 0.15, (len(g), 2))
        det_annos.append({"name": np.asarray(info["gt_names"]), "score": rng.rand(len(g)),
                          "boxes_lidar": g.astype(np.float32), "frame_id": "x"})
    names = list(pds.class_names)
    want_str, want = jds.evaluation(copy.deepcopy(det_annos), names)
    got_str, got = pds.evaluation(copy.deepcopy(det_annos), names)
    assert set(got) == set(want) == {f"{c}_{m}" for c in names for m in ("bev", "3d")}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    # few GT a class: R40 samples only as many recall points as GT
    assert got["car_bev"][0] > 0.0 and got["car_3d"][0] > 0.0 and got_str.count("\n") == 19


def small_model_cfg(cfg):
    """CONFIG narrowed for the CPU at the 64 x 64 x 1 grid (f32)."""
    cfg.DATA_CONFIG.DATA_PROCESSOR[2].VOXEL_SIZE = list(SMALL_VOXEL)
    cfg.DATA_CONFIG.MAX_GT_OBJECTS = 64
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    m.VFE.NUM_FILTERS = [32, 32]
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 32
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1, 1], NUM_FILTERS=[32, 32, 64],
                         NUM_UPSAMPLE_FILTERS=[32, 32, 32])
    m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
    m.DENSE_HEAD.NUM_HM_CONV = 1
    for sub in m.DENSE_HEAD.SEPARATE_HEAD_CFG.HEAD_DICT.values():
        sub.num_conv = 1
    m.DENSE_HEAD.TARGET_ASSIGNER_CONFIG.NUM_MAX_OBJS = 64
    return cfg


def loader_batch(pcfg, training, seed):
    """The first batch of the port's ``build_dataloader`` (one worker)."""
    _, loader = build_dataloader(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), 2, workers=1,
                                 training=training, seed=seed)
    return next(iter(loader))


@pytest.fixture(scope="module")
def model_setup(tree):
    root, _ = tree
    _, pcfg = configs(CONFIG, root)
    cfg = small_model_cfg(pcfg)
    names = list(cfg.CLASS_NAMES)
    args = (names, [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0], SMALL_VOXEL, (64, 64, 1), 5)
    jmeta, pmeta = JaxMeta(*args), DatasetMeta(*args)
    train = loader_batch(cfg, True, seed=4)
    host = {k: np.asarray(train[k]) for k in device_batch_keys(cfg.MODEL)}
    return cfg, names, jmeta, pmeta, host, loader_batch(cfg, False, seed=4)


def nudged(host, seed):
    """``host`` with every point coordinate moved one f32 ulp up or down."""
    rng = np.random.RandomState(seed)
    xyz = host["points"][..., :3]
    pts = host["points"].copy()
    pts[..., :3] = np.where(rng.rand(*xyz.shape) < 0.5, np.nextafter(xyz, np.float32(np.inf)),
                            np.nextafter(xyz, np.float32(-np.inf)))
    return dict(host, points=pts)


@pytest.fixture(scope="module")
def step_pair(model_setup):
    """``run_step_pair`` on the port's training batch, with the JAX
    gradients of the batch nudged by one ulp (``nudged``, 3 seeds) through
    the same jitted step: its own rounding noise."""
    cfg, _, jmeta, _, host, _ = model_setup
    return common.run_step_pair(copy.deepcopy(cfg), jmeta, host, ("points", "points_mask"),
                                probes=[nudged(host, s) for s in range(3)])


def tolerance_ratio(got, want, gmax):
    """The worst |got - want| over ``common.check_grads``' tolerance."""
    return float((np.abs(got - want) / (1e-4 * np.abs(want) + 1e-6 * np.abs(want).max()
                                        + 1e-5 * gmax)).max())


def test_train_step_matches_jax(model_setup, step_pair):
    """One step from the port's training batch (CBGS, GT sampling, world
    augmentations): loss and its 18 terms, gradients, batch statistics, the
    curriculum state and confidences, parameters after Adam.  Each
    gradient within the step tolerance or twice the JAX step's own
    difference when the points move by one ulp, where that is larger: this
    f32 step is not reproducible at 1e-4 in JAX itself (one of the three
    nudges moves the VFE's and the first BEV block's gradients 0.4-8.6x
    the tolerance, as far as the port is from it: a point within rounding
    of a pillar edge, or a kink, decided either way)."""
    r = step_pair
    assert len(r["state"].curriculum) == 6
    assert {f"hm_loss_head_{i}" for i in range(6)} <= set(r["tb"])
    assert (model_setup[4]["gt_boxes"][..., -1] > 0).sum() > 20
    common.check_loss_and_tb(r)
    g, jg = r["grads"], r["jax_grads"]
    assert set(g) == set(jg)
    gmax = max(np.abs(v).max() for v in jg.values())
    for k, want in jg.items():
        own = max(tolerance_ratio(p[k], want, gmax) for p in r["jax_probe_grads"])
        assert tolerance_ratio(g[k], want, gmax) <= max(1.0, 2 * own), (k, own)
    for k, want in r["jax_stats"].items():
        np.testing.assert_allclose(r["stats"][k], want, rtol=1e-5, atol=1e-5, err_msg=k)
    for name in ("avg_confidence", "mean", "std", "initialized"):  # no LOSS_CURRICULUM: kept
        np.testing.assert_array_equal(getattr(r["cur"], name).numpy(),
                                      np.asarray(getattr(r["jax_cur"], name)), err_msg=name)
    # no COM groups either: the (C, G) confidence sums and counts stay 0 in both
    for got, want in zip(r["conf"], r["jax_conf"]):
        np.testing.assert_array_equal(got, want)
    common.check_params_after_step(r)


def test_eval_step_matches_jax(model_setup, step_pair):
    """The eval step of both packages on the port's val batch, the step
    pair's perturbed start with each group's heatmap bias +1.5 and its
    offset, size and velocity kernels x0.02 (an offset is x6.4 m at this
    grid's 1.6 m pillars and stride 4, a size exp()'d): detections to 1e-4
    over the six groups' NMS."""
    cfg, names, jmeta, pmeta, _, val = model_setup
    variables = copy.deepcopy(step_pair["variables"])
    head = next(v for k, v in variables["params"].items() if k.startswith("CenterHead"))
    for i in range(6):
        group = head[f"head_{i}"]
        group["hm_out"]["bias"] = group["hm_out"]["bias"] + 1.5
        for out in ("center_out", "dim_out", "vel_out"):
            group[out]["kernel"] = group[out]["kernel"] * 0.02
    host = {k: np.asarray(val[k]) for k in model_input_keys(cfg.MODEL)}
    jnet = jax_build_network(copy.deepcopy(cfg.MODEL), jmeta)
    jb, js, jl, jv = (np.asarray(o) for o in jax.jit(
        jax_make_eval_step(jnet, cfg.MODEL, names, jmeta))(variables, host))
    net = build_network(cfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, cfg.MODEL, names)
    boxes, scores, labels, valid = (t.numpy() for t in make_eval_step(
        net, cfg.MODEL, names, pmeta, device="cpu")(host))
    assert boxes.shape == jb.shape and boxes.shape[-1] == 9
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 20 and len(np.unique(labels[valid])) >= 6
    for i in range(2):
        rows = lambda b, s, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        worst, one_to_one = _match(rows(boxes, scores, labels, valid), rows(jb, js, jl, jv))
        assert worst <= ATOL and one_to_one, (i, worst)
