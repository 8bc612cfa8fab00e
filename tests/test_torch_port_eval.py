"""Evaluation of the port against the JAX package, on the CPU.

* The host 3D IoU (``ops/host_boxes.py`` ``boxes_iou3d``, ``boxes_overlap_bev``)
  equals ``com_tpu.ops.iou``'s numpy path within 1e-6 on seeded rotated
  boxes; ``recall_stats`` equals ``com_tpu.train.eval.recall_stats`` exactly.
* ``fast_nms_bev`` selects the same candidates with the same validity as
  ``com_tpu.ops.nms.fast_nms_bev`` (post_max_size below and above K, tied
  scores), also through ``post_process_nms`` with ``NMS_TYPE: fast_nms``.
* ``compute_waymo_ap`` equals ``com_tpu``'s within 1e-9 on the cases of
  ``tests/test_waymo_ap.py`` and a seeded multi-frame set;
  ``WaymoDataset.evaluation`` takes the numpy path with the same string.
* ``eval_model`` of both packages over the same synthetic val loader at a
  64x64 grid with the same weights (the JAX variables perturbed from a
  seed, norm biases moved up by 3, carried over by the weight bridge), f32:
  frame ids, counts and names equal, scores within 1e-4, boxes within 1e-4
  plus 1e-5 of their value (the random head decodes sizes up to exp(8)),
  recall counts and ``SyntheticDataset.evaluation`` equal.  One JAX jit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
from com_tpu.data.dataset import build_dataloader as jax_build_dataloader
from com_tpu.data.waymo.waymo_ap import compute_waymo_ap as jax_compute_waymo_ap
from com_tpu.data.waymo.waymo_dataset import WaymoDataset as JaxWaymoDataset
from com_tpu.models.dense_heads.center_head import post_process_nms as jax_post_process_nms
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.ops import iou as jax_iou
from com_tpu.ops.nms import fast_nms_bev as jax_fast_nms_bev
from com_tpu.train import eval as jax_eval
from com_tpu.utils import config as jax_config
from com_tpu_torch.data.dataset import build_dataloader
from com_tpu_torch.data.waymo.waymo_ap import compute_waymo_ap
from com_tpu_torch.data.waymo.waymo_dataset import WaymoDataset
from com_tpu_torch.models.dense_heads.center_head import post_process_nms
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.ops import host_boxes
from com_tpu_torch.ops.nms import fast_nms_bev
from com_tpu_torch.parallel.mesh import DataMesh, make_mesh
from com_tpu_torch.train.eval import eval_model, make_eval_step, recall_stats
from com_tpu_torch.utils import config
from com_tpu_torch.utils.jax_weights import _TRANSFORMS, load_jax_variables

torch.set_num_threads(2)
NAMES = ["Vehicle", "Pedestrian", "Cyclist"]
SYNTH = "configs/synthetic_models/centerpoint_synth_com.yaml"


def _boxes(rng, n, spread=6.0):
    return np.concatenate([rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 1)),
                           rng.uniform(1.0, 4.5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          axis=1).astype(np.float32)


# ------------------------------------------------------------- host IoU, recall

def test_host_iou3d_matches_jax():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    b[:5] = a[:5]  # identical pairs
    b[5:8, 3:6] = 0.0  # padded, zero-size boxes
    for mine, ref in ((host_boxes.boxes_iou3d, jax_iou.boxes_iou3d),
                      (host_boxes.boxes_overlap_bev, jax_iou.boxes_overlap_bev)):
        got, want = mine(a, b), ref(a, b, xp=np)
        assert got.shape == (40, 30) and (want > 0.1).sum() > 10
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.diag(host_boxes.boxes_iou3d(a[:5], a[:5])), 1.0, atol=1e-5)


@pytest.mark.parametrize("case", ["mixed", "no_pred", "no_gt"])
def test_recall_stats_matches_jax(case):
    rng = np.random.RandomState(1)
    gt = np.zeros((16, 8), np.float32)
    gt[:9, :7] = _boxes(rng, 9)
    gt[:9, 7] = rng.randint(1, 4, 9)
    pred = gt[:9, :7] + rng.normal(0, 0.3, (9, 7)).astype(np.float32)
    pred = np.concatenate([pred, _boxes(rng, 4)])
    if case == "no_pred":
        pred = pred[:0]
    if case == "no_gt":
        gt[:, 7] = 0
    want = jax_eval.recall_stats(pred, gt)
    assert recall_stats(pred, gt) == want
    if case == "mixed":
        assert 0 < want["recall_0.7"] < want["recall_0.3"] <= want["gt"] == 9


def test_layout_rules_move_entries_only():
    """Every weight-bridge layout rule is a permutation of the entries (no
    scale), so Adam's second moment maps as its parameter does."""
    a = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    shaped = {"conv2d": a, "deconv2d": a, "copy": a,  # sparse convs: (taps, Cin, Cout)
              "spconv27": np.arange(27 * 2 * 3, dtype=np.float32).reshape(27, 2, 3),
              "spconv3": a.reshape(3, 8, 5),
              # PartA2's pooled-grid convs: dense (kz, ky, kx, Cin, Cout)
              "spconv_dense": np.arange(27 * 2 * 3, dtype=np.float32).reshape(3, 3, 3, 2, 3)}
    for name, fn in _TRANSFORMS.items():
        x = shaped.get(name, a.reshape(6, 20))
        np.testing.assert_array_equal(np.sort(np.asarray(fn(x)).ravel()), x.ravel(),
                                      err_msg=name)


# ------------------------------------------------------------------- fast NMS

def _nms_case(seed, k, ties):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, k, spread=4.0)
    scores = rng.uniform(0, 1, k).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4  # five distinct values
    valid = rng.uniform(size=k) < 0.8
    return boxes, scores, valid


@pytest.mark.parametrize("k,post,ties", [(64, 16, False), (64, 16, True), (48, 80, False),
                                         (48, 80, True)])
def test_fast_nms_matches_jax(k, post, ties):
    """post_max_size below K (kept ranks past it dropped) and above K (the
    rank-K sentinel slot invalid), with and without tied scores."""
    sel_all, val_all = [], []
    for seed in range(3):
        boxes, scores, valid = _nms_case(seed, k, ties)
        js, jv = jax_fast_nms_bev(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                                  0.1, post)
        ps, pv = fast_nms_bev(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                              torch.from_numpy(valid)[None], 0.1, post)
        js, jv = np.asarray(js), np.asarray(jv)
        np.testing.assert_array_equal(pv[0].numpy(), jv)
        np.testing.assert_array_equal(ps[0].numpy()[jv], js[jv])
        sel_all.append(js[jv])
        val_all.append(jv.sum())
    assert min(val_all) > 0 and (post > k or max(val_all) <= post)


def test_post_process_nms_fast_nms_matches_jax():
    rng = np.random.RandomState(5)
    b, k = 2, 64
    boxes = np.stack([_boxes(rng, k, spread=4.0) for _ in range(b)])
    scores = rng.uniform(0, 1, (b, k)).astype(np.float32)
    labels = rng.randint(1, 4, (b, k)).astype(np.int32)
    valid = scores > 0.2
    cfg = {"NMS_TYPE": "fast_nms", "NMS_THRESH": 0.2, "NMS_POST_MAXSIZE": 40}
    want = [np.asarray(x) for x in jax_post_process_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(valid), cfg, 40)]
    got = [x.numpy() for x in post_process_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(labels),
        torch.from_numpy(valid), cfg, 40)]
    np.testing.assert_array_equal(got[3], want[3])
    v = want[3]
    assert v.sum() > 0
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g[v], w[v])


# -------------------------------------------------------------------- Waymo AP

BOX = [0.0, 0.0, 1.0, 4.0, 2.0, 1.8, 0.0]
FAR = [20.0, 5.0, 1.0, 4.0, 2.0, 1.8, 0.0]
SQ = [0.0, 0.0, 1.0, 3.0, 3.0, 1.8, 0.0]


def _info(boxes, names, num_pts, difficulty=True):
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    annos = {"gt_boxes_lidar": boxes, "name": np.asarray(names),
             "num_points_in_gt": np.asarray(num_pts, np.int64)}
    if difficulty:
        annos["difficulty"] = np.zeros(len(boxes), np.int64)
    return {"annos": annos}


def _det(boxes, names, scores):
    return {"boxes_lidar": np.asarray(boxes, np.float64).reshape(-1, 7),
            "name": np.asarray(names), "score": np.asarray(scores, np.float64)}


def _multi_frame(seed):
    rng = np.random.RandomState(seed)
    infos, dets = [], []
    for _ in range(6):
        k = rng.randint(1, 6)
        names = list(rng.choice(["Vehicle", "Pedestrian", "Cyclist"], k))
        gts = [[*rng.uniform(-40, 40, 2), 1.0, *rng.uniform(0.8, 4.5, 3), rng.uniform(-3, 3)]
               for _ in range(k)]
        preds, pnames, scores = [], [], []
        for g, n in zip(gts, names):
            if rng.rand() < 0.8:
                preds.append(list(np.asarray(g) + rng.normal(0, 0.15, 7)))
                pnames.append(n if rng.rand() < 0.9 else "Vehicle")
                scores.append(rng.uniform(0.05, 0.99))
        for _ in range(rng.randint(0, 3)):  # false positives
            preds.append([*rng.uniform(-40, 40, 2), 1.0, 2.0, 2.0, 1.8, 0.0])
            pnames.append("Pedestrian")
            scores.append(rng.uniform(0.05, 0.99))
        infos.append(_info(gts, names, rng.randint(0, 30, k)))
        dets.append(_det(preds if preds else np.zeros((0, 7)), pnames, scores))
    return dets, infos, ["Vehicle", "Pedestrian", "Cyclist"]


def _rot(box, yaw):
    return [*box[:6], yaw]


WAYMO_CASES = {
    "perfect": ([_det([BOX], ["Vehicle"], [0.9])], [_info([BOX], ["Vehicle"], [20])],
                ["Vehicle"]),
    "heading": ([_det([_rot(SQ, np.pi / 2)], ["Vehicle"], [0.9])],
                [_info([SQ], ["Vehicle"], [20])], ["Vehicle"]),
    "low_fp": ([_det([BOX, FAR], ["Vehicle"] * 2, [0.8, 0.3])],
               [_info([BOX], ["Vehicle"], [20])], ["Vehicle"]),
    "high_fp": ([_det([FAR, BOX], ["Vehicle"] * 2, [0.8, 0.3])],
                [_info([BOX], ["Vehicle"], [20])], ["Vehicle"]),
    "level2": ([_det([BOX], ["Vehicle"], [0.9])], [_info([BOX], ["Vehicle"], [3])], ["Vehicle"]),
    "zero_points": ([_det([BOX], ["Vehicle"], [0.9])],
                    [_info([BOX, FAR], ["Vehicle"] * 2, [20, 0])], ["Vehicle"]),
    "l2_ignored": ([_det([BOX, FAR], ["Vehicle"] * 2, [0.9, 0.8])],
                   [_info([BOX, FAR], ["Vehicle"] * 2, [20, 3])], ["Vehicle"]),
    "missed": ([_det([BOX], ["Vehicle"], [0.9])],
               [_info([BOX, FAR], ["Vehicle"] * 2, [20, 20])], ["Vehicle"]),
    "hungarian": ([_det([[0.0, 0.9, 1.0, 4.0, 2.0, 1.8, 0.0], [0.0, 0.1, 1.0, 4.0, 2.0, 1.8, 0.0]],
                        ["Vehicle"] * 2, [0.9, 0.8])], [_info([BOX], ["Vehicle"], [20])],
                  ["Vehicle"]),
    "confusion": ([_det([BOX], ["Pedestrian"], [0.9])], [_info([BOX], ["Vehicle"], [20])],
                  ["Vehicle", "Pedestrian"]),
    "ped_thresh": ([_det([[0.27, 0.0, 1.0, 1.0, 1.0, 1.8, 0.0]], ["Pedestrian"], [0.9])],
                   [_info([[0.0, 0.0, 1.0, 1.0, 1.0, 1.8, 0.0]], ["Pedestrian"], [20])],
                   ["Pedestrian", "Vehicle"]),
    "no_difficulty": ([_det([BOX], ["Vehicle"], [0.9])],
                      [_info([BOX], ["Vehicle"], [20], difficulty=False)], ["Vehicle"]),
    "multi_frame_0": _multi_frame(0),
    "multi_frame_1": _multi_frame(1),
}


@pytest.mark.parametrize("case", sorted(WAYMO_CASES))
def test_waymo_ap_matches_jax(case):
    dets, infos, names = WAYMO_CASES[case]
    want_str, want = jax_compute_waymo_ap(dets, infos, names)
    got_str, got = compute_waymo_ap(dets, infos, names)
    assert got_str == want_str and sorted(got) == sorted(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-9, k
    if case.startswith("multi"):
        assert 0 < want["MEAN_LEVEL_2/mAP"] < 1


def test_waymo_dataset_evaluation_takes_the_numpy_path():
    dets, infos, names = WAYMO_CASES["multi_frame_0"]
    results = []
    for cls in (JaxWaymoDataset, WaymoDataset):
        ds = cls.__new__(cls)
        ds.infos = infos
        results.append(cls.evaluation(ds, dets, names))
    (want_str, want), (got_str, got) = results
    assert got_str.startswith("TF-free numpy AP/APH") and got_str == want_str
    assert got == pytest.approx(want, abs=1e-9)


# ----------------------------------------------------------------- eval_model

def _eval_cfg(mod):
    """The synthetic COM config, small: 6 val scenes of 1,500 ground points
    and up to 8 objects over +-25.6 m at 0.8 m pillars (64x64), a narrow
    one-block backbone, f32."""
    cfg = mod.cfg_from_yaml_file(SYNTH)
    d = cfg.DATA_CONFIG
    d.NUM_SCENES, d.NUM_BG_POINTS, d.NUM_OBJECTS = 6, 1500, 8
    d.POINT_CLOUD_RANGE = [-25.6, -25.6, -2.0, 25.6, 25.6, 4.0]
    d.MAX_POINTS_PER_SCENE, d.MAX_GT_OBJECTS = 6144, 48
    d.DATA_PROCESSOR[2].VOXEL_SIZE = [0.8, 0.8, 6.0]
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    m.VFE.NUM_FILTERS = [16, 16]
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 16
    m.BACKBONE_2D.update(LAYER_NUMS=[1], LAYER_STRIDES=[1], NUM_FILTERS=[16],
                         UPSAMPLE_STRIDES=[1], NUM_UPSAMPLE_FILTERS=[16])
    m.DENSE_HEAD.SHARED_CONV_CHANNEL = 16
    post = m.DENSE_HEAD.POST_PROCESSING
    post.SCORE_THRESH = 0.295
    post.MAX_OBJ_PER_SAMPLE = 64
    post.NMS_CONFIG.NMS_POST_MAXSIZE = 32
    return cfg


def eval_start(jcfg, jds):
    """The JAX net and its perturbed variables for ``_eval_cfg``, with the
    meta of both packages: (jnet, variables, jmeta, pmeta)."""
    grid, vsize = tuple(int(g) for g in jds.grid_size), list(jds.voxel_size)
    assert grid == (64, 64, 1)
    pc_range = list(jcfg.DATA_CONFIG.POINT_CLOUD_RANGE)
    jnet = jax_build_network(jcfg.MODEL, JaxMeta(NAMES, pc_range, vsize, grid, 5))
    pts = np.random.RandomState(0).uniform(-20, 20, (2, 6144, 5)).astype(np.float32)
    variables = jax.jit(jnet.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), {"points": pts, "points_mask": np.ones((2, 6144), bool)},
        train=False)
    variables = common.perturb(jax.tree_util.tree_map(np.asarray, dict(variables)), seed=4)
    # the norms' shifted biases saturate the raw heads: scale the last convs
    # so that scores spread over 0.28-0.32 and sizes stay near real ones
    head = variables["params"]["CenterHead_0"]["head_0"]
    for name, scale, bias in (("hm_out", 0.03, [-1.5] * 3), ("dim_out", 0.01, [1.1, 0.7, 0.5]),
                              ("center_out", 0.01, None), ("center_z_out", 0.01, None)):
        head[name]["kernel"] = head[name]["kernel"] * scale
        if bias is not None:
            head[name]["bias"] = np.asarray(bias, np.float32)
    return (jnet, variables, JaxMeta(NAMES, pc_range, vsize, grid, 5),
            DatasetMeta(NAMES, pc_range, vsize, grid, 5))


@pytest.fixture(scope="module")
def evals():
    jcfg, pcfg = _eval_cfg(jax_config), _eval_cfg(config)
    jds, jloader = jax_build_dataloader(jcfg.DATA_CONFIG, NAMES, 2, training=False, workers=1)
    pds, ploader = build_dataloader(pcfg.DATA_CONFIG, NAMES, 2, training=False, workers=1)
    jnet, variables, jmeta, pmeta = eval_start(jcfg, jds)
    jstep = jax_eval.make_eval_step(jnet, jcfg.MODEL, NAMES, jmeta)
    want = jax_eval.eval_model(jstep, variables, jloader, NAMES)

    net = build_network(pcfg.MODEL, pmeta, device="cpu")
    load_jax_variables(net, variables, pcfg.MODEL, NAMES)
    got = eval_model(make_eval_step(net, pcfg.MODEL, NAMES, pmeta, device="cpu"), ploader, NAMES)
    return dict(want=want, got=got, jds=jds, pds=pds, ploader=ploader, pmeta=pmeta,
                variables=variables)


def test_eval_model_annos_match_jax(evals):
    (want, _, _), (got, _, spf) = evals["want"], evals["got"]
    assert len(got) == len(want) == 6 and spf > 0
    n = [len(a["score"]) for a in want]
    assert 0 < sum(n) and min(n) < 32, n  # some frames have fewer than the slots
    for g, w in zip(got, want):
        assert g["frame_id"] == w["frame_id"]
        assert len(g["score"]) == len(w["score"])
        np.testing.assert_array_equal(g["name"], w["name"])
        np.testing.assert_array_equal(g["pred_labels"], w["pred_labels"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-4)
        # the random head decodes sizes up to exp(8): 1e-5 of the value beside 1e-4
        np.testing.assert_allclose(g["boxes_lidar"], w["boxes_lidar"], rtol=1e-5, atol=1e-4)
        assert (np.diff(g["score"]) <= 0).all()


def test_eval_model_recall_and_evaluation_match_jax(evals):
    (want, want_recall, _), (got, got_recall, _) = evals["want"], evals["got"]
    assert got_recall == want_recall and want_recall["gt"] > 0
    assert evals["pds"].evaluation(got, NAMES) == evals["jds"].evaluation(want, NAMES)


def test_eval_model_mesh_waits(evals):
    """A mesh of one process (no group) evaluates as without a mesh; over
    several ranks the loader must be the rank's shard (the data-parallel
    eval itself: ``test_torch_port_parallel_loop.py``)."""
    net = build_network(_eval_cfg(config).MODEL, evals["pmeta"], device="cpu")
    load_jax_variables(net, evals["variables"], _eval_cfg(config).MODEL, NAMES)
    step = make_eval_step(net, _eval_cfg(config).MODEL, NAMES, evals["pmeta"], device="cpu")
    got, recall, _ = eval_model(step, evals["ploader"], NAMES, mesh=make_mesh("cpu"))
    (want, want_recall, _) = evals["got"]
    assert [a["frame_id"] for a in got] == [a["frame_id"] for a in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["boxes_lidar"], w["boxes_lidar"])
        np.testing.assert_array_equal(g["score"], w["score"])
    assert recall == want_recall
    with pytest.raises(ValueError, match="loader shard"):
        eval_model(step, evals["ploader"], NAMES, mesh=DataMesh(0, 2, torch.device("cpu")))


def test_synthetic_evaluation_matches_jax(evals):
    """Both datasets score the same noisy copies of their scenes' GT alike:
    recall and precision between 0 and 1."""
    rng = np.random.RandomState(7)
    annos = []
    for i, scene in enumerate(evals["jds"]._scenes):
        gt = scene["gt_boxes"]
        keep = rng.uniform(size=len(gt)) < 0.7
        pred = gt[keep] + rng.normal(0, 0.2, (int(keep.sum()), 7)).astype(np.float32)
        annos.append({"frame_id": i, "boxes_lidar": np.concatenate([pred, _boxes(rng, 2)])})
    for a, b in zip(evals["jds"]._scenes, evals["pds"]._scenes):
        np.testing.assert_array_equal(a["gt_boxes"], b["gt_boxes"])
    want = evals["jds"].evaluation(annos, NAMES)
    assert evals["pds"].evaluation(annos, NAMES) == want
    assert 0 < want[1]["recall"] < 1 and 0 < want[1]["precision"] < 1
