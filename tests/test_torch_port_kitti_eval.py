"""The port's KITTI evaluation against ``com_tpu`` on the CPU: the rotated
IoU matrices it matches on (float64 torch against numpy on float64 input,
to 1e-9), the difficulty gates, matching and threshold pieces, the cases of
``tests/test_kitti_eval.py``, seeded random detection / GT sets (AP to
1e-6), ``KittiDataset.evaluation`` over a KITTI tree written from a seed
and ``CustomDataset.evaluation``.
"""
import numpy as np
import pytest
import torch

from com_tpu.data.custom.custom_dataset import CustomDataset as JaxCustom
from com_tpu.data.kitti import kitti_eval as je
from com_tpu.data.kitti.kitti_dataset import KittiDataset as JaxKitti
from com_tpu.ops import iou as jax_iou
from com_tpu_torch.data.custom.custom_dataset import CustomDataset
from com_tpu_torch.data.kitti import kitti_eval as pe
from com_tpu_torch.data.kitti.kitti_dataset import KittiDataset
from com_tpu_torch.ops import iou as port_iou
from test_kitti_eval import make_annos
from torch_port_kitti_setup import configs, small_custom_tree, small_tree

PP = "configs/kitti_models/pointpillar.yaml"
CUSTOM_SECOND = "configs/custom_models/second.yaml"
NAMES = ["Car", "Pedestrian", "Cyclist"]
SIZES = np.array([[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]], np.float32)


def random_sets(seed, n_frames=10):
    """GT of the three classes, Vans and Person_sittings (the neighbour
    classes), with varied occlusion, truncation and 2D heights, and detections:
    jittered copies of most GT (some near the 0.7 / 0.5 gates), misses,
    false positives, wrong classes, projected 2D boxes on half the frames."""
    rng = np.random.RandomState(seed)
    gts, dets = [], []
    names_all = np.array(NAMES + ["Van", "Person_sitting"])
    for f in range(n_frames):
        n = rng.randint(4, 12)
        cls = rng.randint(0, 5, n)
        size = np.where(cls[:, None] < 3, SIZES[np.minimum(cls, 2)], [[4.5, 1.9, 1.9]])
        boxes = np.concatenate([rng.uniform(-30, 30, (n, 2)), rng.uniform(-1.5, 0.5, (n, 1)),
                                size * rng.uniform(0.9, 1.1, (n, 3)),
                                rng.uniform(-np.pi, np.pi, (n, 1))], 1).astype(np.float32)
        gts.append({"name": names_all[cls], "truncated": rng.choice([0.0, 0.2, 0.4, 0.6], n),
                    "occluded": rng.randint(0, 4, n).astype(np.float32),
                    "bbox_height": rng.uniform(15, 80, n), "gt_boxes_lidar": boxes})
        keep = rng.uniform(size=n) < 0.8
        jit = boxes[keep].copy()
        jit[:, :2] += rng.normal(0, rng.choice([0.03, 0.1, 0.25]), (keep.sum(), 2))
        jit[:, 3:6] *= rng.uniform(0.95, 1.05, (keep.sum(), 3))
        fp = np.concatenate([rng.uniform(-30, 30, (3, 2)), rng.uniform(-1.5, 0.5, (3, 1)),
                             SIZES[rng.randint(0, 3, 3)], rng.uniform(-np.pi, np.pi, (3, 1))],
                            1).astype(np.float32)
        det_names = np.concatenate([np.where(cls[keep] < 3, names_all[cls[keep]], "Car"),
                                    np.array(NAMES)[rng.randint(0, 3, 3)]])
        flip = rng.uniform(size=len(det_names)) < 0.1
        det_names[flip] = np.array(NAMES)[rng.randint(0, 3, flip.sum())]
        det = {"name": det_names, "boxes_lidar": np.concatenate([jit, fp]),
               "score": np.concatenate([rng.uniform(0.3, 1.0, keep.sum()),
                                        rng.uniform(0.05, 0.6, 3)]).astype(np.float32)}
        if f % 2:
            h = rng.uniform(10, 80, len(det_names))
            det["bbox"] = np.stack([np.zeros_like(h), np.zeros_like(h), h, h], 1)
        dets.append(det)
    return gts, dets


@pytest.mark.parametrize("fn", ["boxes_iou_bev", "boxes_iou3d"])
def test_iou_matrix_in_float64_matches_jax(fn):
    gts, dets = random_sets(11)
    for g, d in zip(gts, dets):
        want = getattr(jax_iou, fn)(d["boxes_lidar"].astype(np.float64),
                                    g["gt_boxes_lidar"].astype(np.float64), xp=np)
        got = pe.iou_matrix(getattr(port_iou, fn), d["boxes_lidar"], g["gt_boxes_lidar"])
        assert got.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
        assert (got > 0.5).sum() > 0
    assert pe.iou_matrix(port_iou.boxes_iou_bev, np.zeros((1, 7)) + 1, np.ones((1, 9))).shape == (
        1, 1)


def test_gates_matching_and_thresholds_match_jax():
    gts, dets = random_sets(12)
    for g, d in zip(gts, dets):
        for cls in NAMES:
            for diff in (0, 1, 2):
                code = pe._gt_ignore_codes(g, cls, diff)
                np.testing.assert_array_equal(code, je._gt_ignore_codes(g, cls, diff))
        iou = pe.iou_matrix(port_iou.boxes_iou_bev, d["boxes_lidar"], g["gt_boxes_lidar"])
        code = pe._gt_ignore_codes(g, "Car", 1)
        det_code = (np.arange(len(d["score"])) % 3 == 0).astype(np.int64)
        for thresh, fp in ((0.0, False), (0.3, True), (0.6, True)):
            args = (iou, code, d["score"], 0.7, thresh, fp, det_code)
            assert pe._match_stats(*args) == je._match_stats(*args)
    scores = sorted(np.random.RandomState(3).uniform(size=57).tolist(), reverse=True)
    for num_gt in (57, 80, 200):
        assert pe._get_thresholds(scores, num_gt) == je._get_thresholds(scores, num_gt)


@pytest.mark.parametrize("case", ["perfect", "garbage", "half", "difficulty", "report"])
def test_kitti_eval_cases_match_jax(case):
    """``tests/test_kitti_eval.py``'s cases: the same AP in both packages
    (to 1e-6) and the same bounds."""
    rng_seed = {"perfect": 0, "garbage": 1, "half": 2, "difficulty": 3, "report": 4}[case]
    gts, dets = make_annos(np.random.RandomState(rng_seed), perfect=case != "garbage")
    if case == "half":
        for d in dets:
            for k in ("name", "boxes_lidar", "score"):
                d[k] = d[k][: len(d["score"]) // 2]
    if case == "difficulty":
        for g in gts:
            g["occluded"][:] = 2
    if case == "report":
        (ps, pd), (js, jd) = (m.kitti_evaluation(dets, gts, ["Car"]) for m in (pe, je))
        assert ps == js and "Car AP_bev" in ps
        for k in jd:
            np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-6)
        return
    for metric in ("bev", "3d"):
        for diff in (0, 1, 2):
            got = pe.eval_class(gts, dets, "Car", diff, metric)
            assert abs(got - je.eval_class(gts, dets, "Car", diff, metric)) <= 1e-6
    bev = pe.eval_class(gts, dets, "Car", 1, "bev")
    assert {"perfect": bev > 90.0, "garbage": bev < 1.0, "half": 30.0 < bev < 70.0,
            "difficulty": pe.eval_class(gts, dets, "Car", 0, "bev") == 0.0
            and pe.eval_class(gts, dets, "Car", 2, "bev") > 97.0}[case]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_sets_ap_matches_jax(seed):
    gts, dets = random_sets(seed)
    (ps, pd), (js, jd) = (m.kitti_evaluation(dets, gts, NAMES) for m in (pe, je))
    assert sorted(pd) == sorted(jd)
    for k in jd:
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-6, err_msg=k)
    # a few valid GT a class: R40 leaves the unreached recall points at 0
    assert max(max(v) for v in pd.values()) > 1.0


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    return root, small_tree(root, seed=2)


def test_kitti_dataset_evaluation_matches_jax(tree):
    """GT jittered into detections over the tree's val frames (one frame
    with none): the projected 2D boxes and every AP equal."""
    root, ids = tree
    jcfg, pcfg = configs(PP, root)
    jds = JaxKitti(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=False)
    pds = KittiDataset(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), training=False)
    rng = np.random.RandomState(0)
    annos = []
    for n, idx in enumerate(pds.sample_ids):
        gt = pds.frame_gt_annos(idx)
        boxes = gt["gt_boxes_lidar"].copy()
        boxes[:, :2] += rng.normal(0, 0.15, (len(boxes), 2))
        if n == 1:
            boxes = boxes[:0]
        annos.append({"frame_id": idx, "name": gt["name"][: len(boxes)], "boxes_lidar": boxes,
                      "score": rng.uniform(0.2, 1, len(boxes)).astype(np.float32)})
    mine = [dict(a) for a in annos]
    (ps, pd), (js, jd) = pds.evaluation(mine, NAMES), jds.evaluation([dict(a) for a in annos],
                                                                     NAMES)
    assert "bbox" in mine[0] and "bbox" not in mine[1]
    for k in jd:
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-6, err_msg=k)
    assert ps.splitlines()[0].startswith("Car AP_bev R40")
    assert pd["Car_bev"][2] > 10.0


def test_custom_dataset_evaluation_matches_jax(tmp_path):
    small_custom_tree(tmp_path)
    jcfg, pcfg = configs(CUSTOM_SECOND, tmp_path)
    names = list(pcfg.CLASS_NAMES)
    jds = JaxCustom(jcfg.DATA_CONFIG, names, training=False)
    pds = CustomDataset(pcfg.DATA_CONFIG, names, training=False)
    rng = np.random.RandomState(1)
    annos = []
    for idx in pds.sample_ids:
        boxes, labels = pds.get_label(idx)
        boxes = boxes.copy()
        boxes[:, :2] += rng.normal(0, 0.2, (len(boxes), 2))
        annos.append({"frame_id": idx, "name": labels, "boxes_lidar": boxes,
                      "score": rng.uniform(0.2, 1, len(boxes)).astype(np.float32)})
    (ps, pd), (js, jd) = pds.evaluation(annos, names), jds.evaluation(annos, names)
    assert ps == js and "Vehicle AP_3d" in ps
    for k in jd:
        np.testing.assert_allclose(pd[k], jd[k], rtol=0, atol=1e-6, err_msg=k)
    assert pd["Vehicle_bev"][0] > 5.0  # ~10 Vehicles: R40 caps the AP near 25
    assert torch.get_default_dtype() == torch.float32  # the float64 IoU is local to the eval
