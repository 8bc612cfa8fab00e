"""The port's KITTI data side against ``com_tpu`` on the CPU: the
calibration maths (to 1e-6 in float64), labels, GT annotations and dataset
items (bitwise) over a KITTI tree written from a seed
(``torch_port_kitti_setup``), the road-plane lift of pasted objects, the
two behaviours kept from ``com_tpu`` (no FOV crop; the plane read without
calib on a points-only config), and the custom dataset's items.
"""
import numpy as np
import pytest

from com_tpu.data.augmentor.database_sampler import DataBaseSampler as JaxSampler
from com_tpu.data.custom import custom_dataset as jax_custom
from com_tpu.data.kitti import calibration as jcal
from com_tpu.data.kitti import kitti_dataset as jkd
import com_tpu_torch.data  # noqa: F401  (registers the datasets)
from com_tpu_torch.data.augmentor.database_sampler import DataBaseSampler
from com_tpu_torch.data.custom import custom_dataset as port_custom
from com_tpu_torch.data.kitti import calibration as pcal
from com_tpu_torch.data.kitti import kitti_dataset as pkd
from com_tpu_torch.tools.kitti_tree import CALIB, road_z
from com_tpu_torch.utils.registry import DATASETS as REGISTRY
from torch_port_kitti_setup import assert_same, configs, small_custom_tree, small_tree

PP = "configs/kitti_models/pointpillar.yaml"
CUSTOM_SECOND = "configs/custom_models/second.yaml"
# a KITTI plane normalised as get_road_plane does it, and a Car 0.9 m under the sensor
PLANE = np.array([-0.00705, -0.99978, -0.01980, 1.68037])
CAR = np.array([[10.0, 2.0006, -0.9, 3.9, 1.6, 1.56, 0.3]], np.float32)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    return root, small_tree(root)


@pytest.fixture(scope="module")
def custom_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("custom")
    return root, small_custom_tree(root)


def calibs():
    raw = {k: np.asarray(v, np.float64) for k, v in CALIB.items()}
    return jcal.Calibration(dict(raw)), pcal.Calibration(dict(raw))


def camera_boxes(rng, n=20):
    return np.concatenate([rng.uniform(-15, 15, (n, 1)), rng.uniform(0.5, 2.0, (n, 1)),
                           rng.uniform(5, 60, (n, 1)), rng.uniform(0.5, 4.5, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)


def _flat(x):
    return ([a for v in x for a in _flat(v)] if isinstance(x, (list, tuple))
            else [np.asarray(x)])


def _apply(mod, name, cal, rng):
    """One calibration function of ``mod`` on seeded inputs (``rng`` is
    reseeded identically for both packages)."""
    pts = np.concatenate([rng.uniform(2, 60, (50, 1)), rng.uniform(-20, 20, (50, 1)),
                          rng.uniform(-2, 1, (50, 1))], axis=1)
    cam = camera_boxes(rng)
    if name in ("rect_to_lidar", "lidar_to_rect", "rect_to_img", "lidar_to_img"):
        return getattr(cal, name)(pts)
    if name == "img_to_rect":
        return cal.img_to_rect(rng.uniform(0, 1242, 50), rng.uniform(0, 375, 50),
                               rng.uniform(2, 60, 50))
    if name == "boxes3d_kitti_camera_to_lidar":
        return mod.boxes3d_kitti_camera_to_lidar(cam, cal)
    if name == "boxes3d_lidar_to_kitti_camera":
        return mod.boxes3d_lidar_to_kitti_camera(mod.boxes3d_kitti_camera_to_lidar(cam, cal), cal)
    if name == "boxes3d_to_corners3d_kitti_camera":
        return (mod.boxes3d_to_corners3d_kitti_camera(cam),
                mod.boxes3d_to_corners3d_kitti_camera(cam, bottom_center=False))
    if name == "corners_rect_to_camera":
        return [mod.corners_rect_to_camera(c) for c in mod.boxes3d_to_corners3d_kitti_camera(cam)]
    if name == "boxes3d_kitti_camera_to_imageboxes":
        return (mod.boxes3d_kitti_camera_to_imageboxes(cam, cal),
                mod.boxes3d_kitti_camera_to_imageboxes(cam, cal, (375, 1242)))
    if name == "pairwise_iou_2d":
        a = np.sort(rng.uniform(0, 100, (12, 2, 2)), axis=1).transpose(0, 2, 1).reshape(12, 4)
        return (mod.pairwise_iou_2d(a, a[:7]), mod.pairwise_iou_2d(a, np.zeros((0, 4))),
                mod.pairwise_iou_2d(a[:, [2, 3, 0, 1]], a))
    if name == "calib_to_matricies":
        return mod.calib_to_matricies(cal)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "rect_to_lidar", "lidar_to_rect", "rect_to_img", "lidar_to_img", "img_to_rect",
    "boxes3d_kitti_camera_to_lidar", "boxes3d_lidar_to_kitti_camera",
    "boxes3d_to_corners3d_kitti_camera", "corners_rect_to_camera",
    "boxes3d_kitti_camera_to_imageboxes", "pairwise_iou_2d", "calib_to_matricies"])
def test_calibration_matches_jax(name):
    (jc, pc) = calibs()
    want = _apply(jcal, name, jc, np.random.RandomState(7))
    got = _apply(pcal, name, pc, np.random.RandomState(7))
    want, got = _flat(want), _flat(got)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_calibration_file_matches_jax(tree):
    root, ids = tree
    path = root / "training" / "calib" / f"{ids['train'][0]}.txt"
    jc, pc = jcal.Calibration(str(path)), pcal.Calibration(str(path))
    for k in ("P2", "R0", "V2C"):
        np.testing.assert_array_equal(getattr(pc, k), getattr(jc, k))
    # the file holds frame 000000's matrices; a round trip lidar -> rect -> lidar
    pts = np.random.RandomState(1).uniform(-30, 30, (40, 3))
    np.testing.assert_allclose(pc.rect_to_lidar(pc.lidar_to_rect(pts)), pts, atol=1e-9)


def test_labels_and_gt_annos_match_jax_bitwise(tree, tmp_path):
    root, ids = tree
    jcfg, pcfg = configs(PP, root)
    jds = jkd.KittiDataset(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=False)
    pds = pkd.KittiDataset(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), training=False)
    assert pds.sample_ids == jds.sample_ids == ids["val"]
    for idx in ids["train"] + ids["val"]:
        path = root / "training" / "label_2" / f"{idx}.txt"
        assert_same(jkd.parse_label_file(str(path)), pkd.parse_label_file(str(path)), idx)
        assert_same(jds.frame_gt_annos(idx), pds.frame_gt_annos(idx), idx)
        assert "DontCare" not in pds.get_label(idx)["name"]
        assert_same(jds.get_road_plane(idx), pds.get_road_plane(idx), idx)
    # short rows and DontCare rows are dropped alike; a frame with no objects
    odd = tmp_path / "odd.txt"
    odd.write_text("Car 0.5 1\nDontCare -1 -1 -10 1 2 3 4 -1 -1 -1 -1000 -1000 -1000 -10\n")
    assert_same(jkd.parse_label_file(str(odd)), pkd.parse_label_file(str(odd)))
    assert pkd.parse_label_file(str(odd))["bbox"].shape == (0, 4)


@pytest.mark.parametrize("training", [False, True])
def test_dataset_items_match_jax_bitwise(tree, training):
    """``__getitem__`` of both packages on the same frames, the pointpillar
    YAML's processing (and its augmentation when training: GT sampling
    with the road plane, flip, rotation, scaling), seed 3."""
    root, ids = tree
    jcfg, pcfg = configs(PP, root)
    jds = jkd.KittiDataset(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=training, seed=3)
    pds = REGISTRY.get("KittiDataset")(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES),
                                       training=training, seed=3)
    assert len(pds) == len(ids["train" if training else "val"])
    for i in range(len(pds)):
        a, b = jds[i], pds[i]
        assert_same(a, b, str(i))
        assert "calib" not in b and b["road_plane"].shape == (4,)


def test_image_items_raise_by_name(tree):
    root, _ = tree
    _, pcfg = configs(PP, root)
    for item in ("images", "gt_boxes2d", "calib_matricies"):
        pcfg.DATA_CONFIG.GET_ITEM_LIST = ["points", item]
        with pytest.raises(NotImplementedError, match=item):
            pkd.KittiDataset(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), training=False)


def test_calib_item_and_velodyne_glob_match_jax(tree, tmp_path):
    """GET_ITEM_LIST beyond points puts ``calib`` in the item in both; with
    no split file the frames are the velodyne files, sorted."""
    root, ids = tree
    jcfg, pcfg = configs(PP, root)
    for cfg in (jcfg, pcfg):
        cfg.DATA_CONFIG.GET_ITEM_LIST = ["points", "calib"]
        cfg.DATA_CONFIG.DATA_SPLIT = {"train": "train", "test": "trainval"}
    jds = jkd.KittiDataset(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=False)
    pds = pkd.KittiDataset(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), training=False)
    assert pds.sample_ids == jds.sample_ids == sorted(ids["train"] + ids["val"])
    a, b = jds[0], pds[0]
    ca, cb = a.pop("calib"), b.pop("calib")
    assert isinstance(cb, pcal.Calibration)
    for k in ("P2", "R0", "V2C"):
        np.testing.assert_array_equal(getattr(cb, k), getattr(ca, k))
    assert_same(a, b)


def test_fov_points_only_is_ignored_alike(tree):
    """``FOV_POINTS_ONLY: True`` (kitti_dataset.yaml:17) is read by no code
    in ``com_tpu``: points in range but outside the camera's view (|y| > x,
    beside and behind the camera's cone) stay in both packages' items."""
    root, _ = tree
    jcfg, pcfg = configs(PP, root)
    assert pcfg.DATA_CONFIG.FOV_POINTS_ONLY is True
    jds = jkd.KittiDataset(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=False)
    pds = pkd.KittiDataset(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), training=False)
    a, b = jds[0], pds[0]
    assert_same(a, b)
    pts = b["points"]
    raw = pds.get_lidar(pds.sample_ids[0])
    pr = pcfg.DATA_CONFIG.POINT_CLOUD_RANGE
    # the range mask reads x and y only, as pcdet's mask_points_by_range
    in_range = ((raw[:, 0] >= pr[0]) & (raw[:, 0] <= pr[3]) & (raw[:, 1] >= pr[1])
                & (raw[:, 1] <= pr[4]))
    outside_view = np.abs(pts[:, 1]) > pts[:, 0]
    assert outside_view.sum() > 100
    assert len(pts) == in_range.sum()  # every point in range, none cropped to the view
    # and the raw scan is the whole sweep, behind the sensor too
    assert (raw[:, 0] < 0).sum() > 1000


def test_road_plane_without_calib_alike():
    """The sampler's lift: without calib (a points-only config) both read the
    rect-frame plane as a lidar-frame one and sink the Car from z -0.9 m to
    -18.93 m (mv_height 18.03); with calib both seat it on the road (its
    bottom 1.45 m under the sensor there)."""
    jc, pc = calibs()
    jb, jmv = JaxSampler.put_boxes_on_road_planes(CAR, PLANE, None)
    pb, pmv = DataBaseSampler.put_boxes_on_road_planes(CAR, PLANE, None)
    assert_same((jb, jmv), (pb, pmv))
    assert abs(float(pb[0, 2]) - (-18.93)) < 0.01 and abs(float(pmv[0]) - 18.03) < 0.01
    jb, jmv = JaxSampler.put_boxes_on_road_planes(CAR, PLANE, jc)
    pb, pmv = DataBaseSampler.put_boxes_on_road_planes(CAR, PLANE, pc)
    np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pmv, jmv, rtol=0, atol=1e-9)
    bottom = pb[0, 2] - pb[0, 5] / 2
    assert abs(bottom - road_z(pc, PLANE, CAR[:, :2])[0]) < 1e-3


@pytest.mark.parametrize("with_calib", [False, True])
def test_road_plane_lift_through_the_dataset_alike(tree, with_calib):
    """GT sampling with USE_ROAD_PLANE through both datasets (no range mask,
    no world augmentation): the same pasted boxes and points bitwise;
    without calib in the item the pasted boxes sink far under the road,
    with it they sit on the plane."""
    root, _ = tree
    jcfg, pcfg = configs(PP, root)
    for cfg in (jcfg, pcfg):
        dc = cfg.DATA_CONFIG
        dc.GET_ITEM_LIST = ["points", "calib"] if with_calib else ["points"]
        dc.DATA_AUGMENTOR.AUG_CONFIG_LIST = [dc.DATA_AUGMENTOR.AUG_CONFIG_LIST[0]]
        dc.DATA_PROCESSOR = []
        assert dc.DATA_AUGMENTOR.AUG_CONFIG_LIST[0]["USE_ROAD_PLANE"] is True
    jds = jkd.KittiDataset(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=True, seed=5)
    pds = pkd.KittiDataset(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), training=True, seed=5)
    pasted = []
    for i in range(len(pds)):
        a, b = jds[i], pds[i]
        a.pop("calib", None), b.pop("calib", None)
        assert_same(a, b, str(i))
        pasted.append(b["gt_boxes"][b["true_object"] == 2])
    pasted = np.concatenate(pasted)
    assert len(pasted) > 10
    # the road under each pasted box, from the frame's plane through the calib
    bottom = pasted[:, 2] - pasted[:, 5] / 2
    road = np.concatenate([
        road_z(calibs()[1], pds.get_road_plane(idx), b["gt_boxes"][b["true_object"] == 2][:, :2])
        for idx, b in ((pds.sample_ids[i], pds[i]) for i in range(len(pds)))])
    if with_calib:
        # the plane taken at the box's center height, the road here at z 0
        np.testing.assert_allclose(bottom, road, rtol=0, atol=1e-3)
    else:  # tens of metres under or over the road: the box and its points
        assert np.abs(bottom - road).min() > 5.0


@pytest.mark.parametrize("training", [False, True])
def test_custom_dataset_items_match_jax_bitwise(custom_tree, training):
    root, ids = custom_tree
    jcfg, pcfg = configs(CUSTOM_SECOND, root)
    for cfg in (jcfg, pcfg):  # no database of the custom tree: the world augmentations only
        aug = cfg.DATA_CONFIG.DATA_AUGMENTOR
        aug.AUG_CONFIG_LIST = [a for a in aug.AUG_CONFIG_LIST if a["NAME"] != "gt_sampling"]
    jds = jax_custom.CustomDataset(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=training,
                                   seed=2)
    pds = REGISTRY.get("CustomDataset")(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES),
                                        training=training, seed=2)
    assert isinstance(pds, port_custom.CustomDataset)
    assert pds.sample_ids == jds.sample_ids == ids["train" if training else "val"]
    for i in range(len(pds)):
        assert_same(jds.get_label(pds.sample_ids[i]), pds.get_label(pds.sample_ids[i]))
        assert_same(jds[i], pds[i], str(i))
