"""The port's host data pipeline against the JAX package, on the CPU: the
same numpy inputs, made from a seed, through ``com_tpu`` and
``com_tpu_torch``.

* Host ops: the port's native library (``ops.host_native``, built with g++
  at first use) against its numpy versions and against ``com_tpu``'s native
  and numpy versions.  Voxels and masks exact; the IoU of the two libraries
  (one C source) within 1e-6.  The numpy IoU is another algorithm (24
  candidate vertices with a 0.1 mm inside tolerance, in the boxes' dtype):
  in f64 it is held to the library within 1e-4 m of vertex slack, 1e-4 x
  (perimeter a + perimeter b) / union, plus 1e-6 of rounding.
* Transforms, augmentor steps and processor steps: bit-equal under the same
  ``RandomState``.
* The synthetic pipeline end to end (``centerpoint_synth_com.yaml`` scaled
  down, one worker, 3 epochs, the same confidences set after epochs 0 and
  1): bit-equal batches; ``pipeline_presorts_points``; a scene over the
  point cap, which the collate subsamples out of pillar order in both.
* Waymo frames in the reference's on-disk format, with a file-based GT
  database and one multi-frame config: bit-equal batches.
* Host against device COM groups on the database entries; the sampler
  state carried from a JAX checkpoint payload; the batch keys the
  prefetcher copies.
"""
import pickle

import numpy as np
import pytest
import torch

from com_tpu.data import processor as jax_processor
from com_tpu.data.augmentor import data_augmentor as jax_augmentor
from com_tpu.data.augmentor import transforms as jax_transforms
from com_tpu.data.augmentor.database_sampler import split_difficulty_groups as jax_split
from com_tpu.data.dataset import build_dataloader as jax_build_dataloader
from com_tpu.models.dense_heads.target_assign import cluster_com_groups as jax_cluster
from com_tpu.ops import boxes as jax_boxes
from com_tpu.ops import iou as jax_iou
from com_tpu.ops import voxelize as jax_voxelize
from com_tpu.train.step import device_batch_keys as jax_batch_keys
from com_tpu.utils import common as jax_common
from com_tpu.utils import config as jax_config
from com_tpu_torch.data import processor
from com_tpu_torch.data.augmentor import data_augmentor, transforms
from com_tpu_torch.data.augmentor.database_sampler import split_difficulty_groups
from com_tpu_torch.data.dataset import PrefetchLoader, build_dataloader
from com_tpu_torch.data.synthetic import make_synthetic_db_infos
from com_tpu_torch.models.dense_heads.target_assign import cluster_com_groups
from com_tpu_torch.ops import host_boxes, host_native, voxelize
from com_tpu_torch.train.loop import DevicePrefetcher
from com_tpu_torch.train.step import BATCH_KEYS, device_batch_keys
from com_tpu_torch.utils import common, config
from com_tpu_torch.utils.jax_weights import sampler_state_from_jax

NAMES = ["Vehicle", "Pedestrian", "Cyclist"]
SYNTH = "configs/synthetic_models/centerpoint_synth_com.yaml"
FLAGSHIP = "configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml"


@pytest.fixture(scope="module")
def jax_native():
    """``com_tpu``'s native library, loaded: it falls back to numpy silently
    when its first build races another process's, so load it once more."""
    from com_tpu.ops import native

    if native.get_lib() is None:
        native._tried = False
    assert native.get_lib() is not None
    return native


def _boxes(rng, n, span):
    return np.concatenate([rng.uniform(-span, span, (n, 2)), rng.uniform(-1, 1, (n, 1)),
                           rng.uniform(1, 5, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
                          1).astype(np.float32)


# ---------------------------------------------------------------- host ops

@pytest.mark.parametrize("voxel,cap", [((0.5, 0.5, 2.0), 1000), ((0.02, 0.02, 0.02), 5000)],
                         ids=["dense", "hashed"])
def test_native_voxelize_matches_numpy_and_jax(jax_native, voxel, cap):
    """Both grid lookups of the library (a dense grid, a hash map past 16 M
    cells): voxels, coords and counts exact against the port's numpy
    version and both of ``com_tpu``'s, with the voxel cap hit."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-10, 10, (20000, 5)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.5, 2.5, 20000)
    pts[:50] = pts[50:100]  # repeated points: several in one voxel
    args = ([-10, -10, 0, 10, 10, 2], list(voxel), 8, cap)
    got = host_native.voxelize_native(pts, *args)
    assert len(got[0]) == cap and got[2].max() > 1
    for want in (voxelize.voxelize_points(pts, *args), jax_native.voxelize_native(pts, *args),
                 jax_voxelize.voxelize_points(pts, *args)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_native_points_in_rbbox_matches_numpy_and_jax(jax_native):
    """Masks exact: the library against the numpy version in f64 (the
    library's own precision) and against ``com_tpu``'s library; the port's
    numpy version against ``com_tpu``'s in f32."""
    rng = np.random.RandomState(2)
    pts = rng.uniform(-10, 10, (5000, 5)).astype(np.float32)
    boxes = _boxes(rng, 12, 8)
    got = host_native.points_in_rbbox_native(pts, boxes)
    assert got.dtype == bool and got.sum() > 100
    np.testing.assert_array_equal(got, host_boxes.points_in_rbbox(pts.astype(np.float64),
                                                                  boxes.astype(np.float64)))
    np.testing.assert_array_equal(got, jax_native.points_in_rbbox_native(pts, boxes))
    np.testing.assert_array_equal(host_boxes.points_in_rbbox(pts, boxes),
                                  jax_boxes.points_in_rbbox(pts, boxes, xp=np))
    np.testing.assert_array_equal(host_boxes.remove_points_in_boxes3d(pts, boxes),
                                  pts[~got.any(axis=1)])


@pytest.mark.parametrize("span", [10, 60])
def test_native_iou_matches_numpy_and_jax(jax_native, span):
    rng = np.random.RandomState(span)
    a, b = _boxes(rng, 64, span), _boxes(rng, 48, span)
    b[:24, :2] = a[:24, :2] + rng.uniform(-2, 2, (24, 2))  # overlapping pairs
    b[24] = a[0]  # one pair identical
    got = host_native.boxes_iou_bev_native(a, b)
    assert (got > 0).sum() >= 24 and abs(got[0, 24] - 1.0) <= 1e-6
    np.testing.assert_allclose(got, jax_native.boxes_iou_bev_native(a, b), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(host_boxes.boxes_iou_bev(a, b), jax_iou.boxes_iou_bev(a, b))
    want = host_boxes.boxes_iou_bev(a.astype(np.float64), b.astype(np.float64))
    union = ((a[:, 3] * a[:, 4])[:, None] + (b[:, 3] * b[:, 4])[None]) / (1 + want)
    perimeters = 2 * ((a[:, 3] + a[:, 4])[:, None] + (b[:, 3] + b[:, 4])[None])
    assert (np.abs(got - want) <= 1e-4 * perimeters / union + 1e-6).all()


def test_host_box_helpers_match_jax():
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 30, 70)
    pr = np.array([-74.88, -74.88, -2, 74.88, 74.88, 4.0], np.float32)
    for got, want in (
            (host_boxes.boxes_to_corners_bev(boxes), jax_boxes.boxes_to_corners_bev(boxes)),
            (host_boxes.boxes_to_corners_3d(boxes), jax_boxes.boxes_to_corners_3d(boxes)),
            (host_boxes.enlarge_box3d(boxes, [0.1, 0.2, 0.3]),
             jax_boxes.enlarge_box3d(boxes, [0.1, 0.2, 0.3])),
            (host_boxes.mask_boxes_outside_range(boxes, pr, 2),
             jax_boxes.mask_boxes_outside_range(boxes, pr, 2)),
            (voxelize.grid_size_from_range(pr, [0.32, 0.32, 6.0]),
             jax_voxelize.grid_size_from_range(pr, [0.32, 0.32, 6.0])),
            (common.rotate_points_along_z(boxes[None, :, :5], np.array([0.3])),
             jax_common.rotate_points_along_z(boxes[None, :, :5], np.array([0.3]))),
            (common.limit_period(boxes[:, 6] * 3), jax_common.limit_period(boxes[:, 6] * 3))):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, np.asarray(want))


def test_host_library_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """No numpy fallback: without g++, or when g++ fails, a wrapper raises."""
    monkeypatch.setattr(host_native, "_lib", None)
    monkeypatch.setattr(host_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host_native, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(host_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g..? not found"):
        host_native.boxes_iou_bev_native(np.zeros((1, 7)), np.zeros((1, 7)))
    monkeypatch.undo()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(host_native, "_lib", None)
    monkeypatch.setattr(host_native, "SRC", bad)
    monkeypatch.setattr(host_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(host_native, "library_path", lambda: tmp_path / "bad.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host_native.points_in_rbbox_native(np.zeros((1, 3)), np.zeros((1, 7)))
    assert not list(tmp_path.glob("*.tmp")) and not (tmp_path / "bad.so").exists()


def test_host_library_is_the_jax_packages_source():
    """The copied C source keeps ``com_tpu``'s code and C signatures."""
    from pathlib import Path

    def body(path):
        text = Path(path).read_text()
        return text[text.index("#include <cstdint>"):]

    assert body(host_native.SRC) == body("com_tpu/ops/native/src/com_native.cpp")
    assert host_native.library_path().parent == host_native.BUILD_DIR
    assert host_native.BUILD_DIR.parts[-2:] == ("build", "host")


# ------------------------------------------------- transforms, augmentor, processor

def _scene(seed, n=4000, m=10):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([rng.uniform(-60, 60, (n, 2)), rng.uniform(-2, 4, (n, 1)),
                          rng.rand(n, 2)], 1).astype(np.float32)
    gt = np.concatenate([_boxes(rng, m, 60), rng.uniform(-2, 2, (m, 2)).astype(np.float32)], 1)
    return pts, gt


@pytest.mark.parametrize("name,args", [
    ("random_flip_along_x", ()), ("random_flip_along_y", ()),
    ("global_rotation", ([-0.785, 0.785],)), ("global_scaling", ([0.95, 1.05],)),
    ("global_translation", ([0.2, 0.2, 0.1],))])
@pytest.mark.parametrize("width", [7, 9])
def test_world_transforms_match_jax(name, args, width):
    """Bit-equal boxes (with and without velocity columns) and points, and
    the same draws, over several seeds (both flip outcomes)."""
    for seed in range(4):
        pts, gt = _scene(seed)
        outs = []
        for mod in (jax_transforms, transforms):
            rng = np.random.RandomState(seed)
            outs.append((getattr(mod, name)(gt[:, :width].copy(), pts.copy(), *args, rng=rng),
                         rng.rand()))
        (j, jr), (p, pr_) = outs
        assert jr == pr_
        for a, b in zip(j, p):
            np.testing.assert_array_equal(b, a)


def _aug_cfg(mod):
    cfg = mod.cfg_from_yaml_file(FLAGSHIP).DATA_CONFIG.DATA_AUGMENTOR
    cfg.AUG_CONFIG_LIST = [c for c in cfg.AUG_CONFIG_LIST if c.NAME != "gt_sampling"]
    return cfg


def test_world_augmentor_matches_jax():
    """The flagship's world augmentations (flip x and y, rotation, scaling)
    through both ``DataAugmentor``s, heading normalisation included."""
    augs = [m.DataAugmentor(None, _aug_cfg(c), NAMES, rng=np.random.RandomState(0))
            for m, c in ((jax_augmentor, jax_config), (data_augmentor, config))]
    for seed in range(5):
        pts, gt = _scene(seed)
        outs = [a.forward({"points": pts.copy(), "gt_boxes": gt[:, :7].copy()})
                for a in augs]
        assert sorted(outs[0]) == sorted(outs[1])
        for k, v in outs[0].items():
            np.testing.assert_array_equal(outs[1][k], v, err_msg=k)
        assert np.abs(outs[1]["gt_boxes"][:, 6]).max() <= np.pi


# the augmentations that raised until they were ported, with the settings
# of configs/kitti_models/pointpillar_{newaugs,pyramid_aug}.yaml (denser
# pyramid draws, so that each step does work on a small scene)
FORMERLY_UNPORTED = {
    "random_local_rotation": {"LOCAL_ROT_ANGLE": [-0.15707963267, 0.15707963267]},
    "random_local_scaling": {"LOCAL_SCALE_RANGE": [0.95, 1.05]},
    "random_local_translation": {"LOCAL_TRANSLATION_RANGE": [0.95, 1.05],
                                 "ALONG_AXIS_LIST": ["x", "y", "z"]},
    "random_world_frustum_dropout": {"INTENSITY_RANGE": [0, 0.2], "DIRECTION": ["top"]},
    "random_local_frustum_dropout": {"INTENSITY_RANGE": [0, 0.2], "DIRECTION": ["top", "left"]},
    "random_local_sparsify": {"DROP_PROB": 0.3},
    "random_local_pyramid_aug": {"DROP_PROB": 0.25, "SPARSIFY_PROB": 0.5, "SPARSIFY_MAX_NUM": 5,
                                 "SWAP_PROB": 0.5, "SWAP_MAX_NUM": 5},
}


@pytest.mark.parametrize("name", list(FORMERLY_UNPORTED))
def test_unported_augmentations_raise(name):
    """These raised while they were not ported; ``NOT_PORTED`` is empty now,
    and each builds and equals ``com_tpu``'s queue step bitwise (heading
    normalisation included) on scenes with 60 points in each of 10 boxes."""
    assert data_augmentor.NOT_PORTED == ()
    cfg = [{"NAME": name, **FORMERLY_UNPORTED[name]}]
    changed = False
    for seed in range(3):
        pts, gt = _scene(seed)
        rng = np.random.RandomState(seed + 10)
        inside = []
        for box in gt:
            local = rng.uniform(-0.45, 0.45, (60, 3)) * box[3:6]
            c, s_ = np.cos(box[6]), np.sin(box[6])
            xyz = np.stack([local[:, 0] * c - local[:, 1] * s_, local[:, 0] * s_ + local[:, 1] * c,
                            local[:, 2]], 1) + box[:3]
            inside.append(np.concatenate([xyz, rng.rand(60, 2)], 1))
        pts = np.concatenate([np.concatenate(inside).astype(np.float32), pts])
        outs = []
        for mod in (jax_augmentor, data_augmentor):
            aug = mod.DataAugmentor(None, cfg, NAMES, rng=np.random.RandomState(seed))
            outs.append(aug.forward({"points": pts.copy(), "gt_boxes": gt[:, :7].copy()}))
        assert sorted(outs[0]) == sorted(outs[1])
        for k, v in outs[0].items():
            assert outs[1][k].dtype == v.dtype
            np.testing.assert_array_equal(outs[1][k], v, err_msg=k)
        changed |= (len(outs[1]["points"]) != len(pts)
                    or not np.array_equal(outs[1]["points"], pts))
    assert changed


PROCESSORS = {
    "mask": {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True},
    "mask_corners": {"NAME": "mask_points_and_boxes_outside_range", "REMOVE_OUTSIDE_BOXES": True,
                     "USE_CENTER_TO_FILTER": False, "min_num_corners": 2},
    "shuffle": {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}},
    "sort": {"NAME": "sort_points_by_bev_pillar", "VOXEL_SIZE": [0.32, 0.32, 6.0]},
    "voxels": {"NAME": "transform_points_to_voxels", "VOXEL_SIZE": [0.32, 0.32, 6.0],
               "MAX_POINTS_PER_VOXEL": 5, "MAX_NUMBER_OF_VOXELS": {"train": 3000, "test": 3000}},
    "sample_fewer": {"NAME": "sample_points", "NUM_POINTS": {"train": 3000, "test": 3000}},
    "sample_more": {"NAME": "sample_points", "NUM_POINTS": {"train": 5000, "test": 5000}},
}


@pytest.mark.parametrize("step", sorted(PROCESSORS))
def test_processor_steps_match_jax(jax_native, step):
    pr = [-51.2, -51.2, -2.0, 51.2, 51.2, 4.0]
    outs = []
    for mod in (jax_processor, processor):
        proc = mod.DataProcessor([PROCESSORS[step]], pr, True, 5, rng=np.random.RandomState(1))
        pts, gt = _scene(5)
        names = np.array(NAMES * 4)[:len(gt)]
        outs.append(proc.forward({"points": pts, "gt_boxes": gt, "gt_names": names,
                                  "true_object": np.ones(len(gt), np.float32)}))
    assert sorted(outs[0]) == sorted(outs[1])
    for k, v in outs[0].items():
        np.testing.assert_array_equal(outs[1][k], v, err_msg=k)


@pytest.mark.parametrize("steps,vsize,want", [
    (["mask", "shuffle", "sort"], [0.32, 0.32, 6.0], True),
    (["mask", "sort", "shuffle"], [0.32, 0.32, 6.0], False),
    (["mask", "sort"], [0.4, 0.4, 6.0], False),
    (["sort", "sample_fewer"], [0.32, 0.32, 6.0], False),
    (["mask", "shuffle"], [0.32, 0.32, 6.0], False),
    (["sort_default"], [0.5, 0.5, 6.0], True)])
def test_pipeline_presorts_points_matches_jax(steps, vsize, want):
    procs = [PROCESSORS[s] if s != "sort_default" else {"NAME": "sort_points_by_bev_pillar"}
             for s in steps]
    cfgs = [m.CfgNode({"DATA_PROCESSOR": procs}) for m in (jax_config, config)]
    assert processor.pipeline_presorts_points(cfgs[1], vsize) is want
    assert jax_processor.pipeline_presorts_points(cfgs[0], vsize) is want


# --------------------------------------------------------- synthetic end to end

def _synth_cfg(mod, **over):
    cfg = mod.cfg_from_yaml_file(SYNTH)
    d = cfg.DATA_CONFIG
    d.NUM_SCENES, d.NUM_BG_POINTS, d.NUM_OBJECTS = 6, 2000, 8
    d.MAX_POINTS_PER_SCENE, d.MAX_GT_OBJECTS = 8192, 48
    d.DATA_PROCESSOR[2].MAX_NUMBER_OF_VOXELS = {"train": 6000, "test": 6000}
    d.update(over)
    return cfg


def _assert_batches_equal(ja, pa):
    assert len(ja) == len(pa) > 0
    for jb, pb in zip(ja, pa):
        assert sorted(jb) == sorted(pb)
        for k, v in jb.items():
            if isinstance(v, np.ndarray):
                assert pb[k].dtype == v.dtype and pb[k].shape == v.shape, k
                np.testing.assert_array_equal(pb[k], v, err_msg=k)
            else:
                assert pb[k] == v, k


def _epochs(build, cfg, confs, epochs=3, **kw):
    """Every batch of ``epochs`` epochs, ``confs[e]`` handed to the sampler
    after epoch e, as the training loop does."""
    ds, loader = build(cfg.DATA_CONFIG, NAMES, 2, seed=4, workers=1, **kw)
    out = []
    for e in range(epochs):
        loader.set_epoch(e)
        out.append(list(loader))
        if e < len(confs):
            ds.set_confidence_groups(confs[e])
    return ds, out


def test_synthetic_pipeline_matches_jax_over_epochs(jax_native):
    """3 epochs through ``build_dataloader`` with the same confidences set
    after epochs 0 and 1: points, masks, gt, side arrays and voxels
    bit-equal, fixed shapes, pasted objects in every epoch."""
    rng = np.random.RandomState(9)
    confs = [rng.uniform(0, 0.6, (3, 96)).astype(np.float32) for _ in range(2)]
    (jds, jax_epochs), (pds, port_epochs) = (
        _epochs(jax_build_dataloader, _synth_cfg(jax_config), confs),
        _epochs(build_dataloader, _synth_cfg(config), confs))
    for e, (j, p) in enumerate(zip(jax_epochs, port_epochs)):
        _assert_batches_equal(j, p)
        assert all(b["points"].shape == (2, 8192, 5) and b["voxels"].shape == (2, 6000, 20, 5)
                   and b["gt_boxes"].shape == (2, 48, 8) for b in p)
        assert sum(int((b["true_object"] == 2).sum()) for b in p) > 0, e
    assert pds.data_augmentor.gt_sampler.epoch == 2
    np.testing.assert_array_equal(pds.data_augmentor.gt_sampler.confidence_groups, confs[1])


def test_flagship_processors_presort_and_sort_holds():
    """The flagship's DATA_PROCESSOR presorts (ASSUME_SORTED_POINTS), and
    every collated sample's valid points are non-decreasing in the device
    formula's pillar id (``point_voxel_ids``)."""
    cfg = _synth_cfg(config)
    flag = config.cfg_from_yaml_file(FLAGSHIP).DATA_CONFIG
    cfg.DATA_CONFIG.DATA_PROCESSOR = flag.DATA_PROCESSOR
    cfg.DATA_CONFIG.POINT_CLOUD_RANGE = list(flag.POINT_CLOUD_RANGE)
    vsize = [0.32, 0.32, 6.0]
    assert processor.pipeline_presorts_points(cfg.DATA_CONFIG, vsize)
    _, loader = build_dataloader(cfg.DATA_CONFIG, NAMES, 2, seed=4, workers=2)
    loader.set_epoch(0)
    for b in loader:
        ids, _ = voxelize.point_voxel_ids(torch.from_numpy(b["points"][..., :3]),
                                          flag.POINT_CLOUD_RANGE, vsize, (468, 468, 1))
        for i in range(2):
            n = int(b["points_mask"][i].sum())
            assert b["points_mask"][i, :n].all() and not b["points_mask"][i, n:].any()
            assert bool((ids[i, 1:n] >= ids[i, :n - 1]).all())


def test_collate_subsample_breaks_the_presort_in_both():
    """A scene over MAX_POINTS_PER_SCENE: the collate draws the cap without
    replacement, the same rows in both packages, and the pillar order the
    presort made is gone (a ``com_tpu`` behaviour the port keeps)."""
    flag = config.cfg_from_yaml_file(FLAGSHIP).DATA_CONFIG
    outs = []
    for build, mod in ((jax_build_dataloader, jax_config), (build_dataloader, config)):
        cfg = _synth_cfg(mod, MAX_POINTS_PER_SCENE=3000,
                         POINT_CLOUD_RANGE=list(flag.POINT_CLOUD_RANGE))
        cfg.DATA_CONFIG.DATA_PROCESSOR = mod.cfg_from_yaml_file(FLAGSHIP).DATA_CONFIG.DATA_PROCESSOR
        ds, loader = build(cfg.DATA_CONFIG, NAMES, 2, seed=4, workers=1)
        loader.set_epoch(0)
        outs.append(list(loader))
    _assert_batches_equal(*outs)
    b = outs[1][0]
    assert b["points_mask"].all()  # every scene over the cap
    ids, _ = voxelize.point_voxel_ids(torch.from_numpy(b["points"][..., :3]),
                                      flag.POINT_CLOUD_RANGE, [0.32, 0.32, 6.0], (468, 468, 1))
    assert not bool((ids[:, 1:] >= ids[:, :-1]).all())


def test_loader_shards_failures_and_unported_options():
    """Strided shards by process, a worker's failure raised in the consumer,
    ``dist`` without a process group, image batches not ported."""
    cfg = _synth_cfg(config)
    ds, _ = build_dataloader(cfg.DATA_CONFIG, NAMES, 2, seed=4, workers=1)
    orders = []
    for rank in range(2):
        loader = PrefetchLoader(ds, 1, shuffle=True, seed=1, process_index=rank,
                                process_count=2)
        orders.append(loader._shard_order())
        assert len(loader) == 3
    assert sorted(np.concatenate(orders)) == list(range(6))
    # without a process group ``dist`` is one process's whole order, as
    # ``com_tpu``'s (process 0 of 1); the ranks' shards:
    # ``test_torch_port_parallel_loop.py``
    _, single = build_dataloader(cfg.DATA_CONFIG, NAMES, 2, dist=True, seed=4, workers=1)
    assert (single.process_index, single.process_count) == (0, 1)
    np.testing.assert_array_equal(single._shard_order(), build_dataloader(
        cfg.DATA_CONFIG, NAMES, 2, seed=4, workers=1)[1]._shard_order())
    with pytest.raises(NotImplementedError, match="image"):
        ds.collate_batch([{"images": np.zeros((4, 4, 3))}])

    class Broken(type(ds)):
        def __getitem__(self, index):
            if index == 3:
                raise OSError("disk gone")
            return super().__getitem__(index)

    ds.__class__ = Broken
    loader = PrefetchLoader(ds, 2, shuffle=False, num_workers=2)
    with pytest.raises(RuntimeError, match="worker failed") as info:
        list(loader)
    assert isinstance(info.value.__cause__, OSError)


# ---------------------------------------------------------------- waymo frames

def _make_frame(rng, n=5000, n_obj=6):
    """A Waymo-like frame: ground, clusters, boxes with points planted inside;
    (N, 6) [x y z intensity elongation NLZ]."""
    r = 60 * rng.rand(n) ** 0.75
    th = rng.uniform(-np.pi, np.pi, n)
    z = np.where(rng.rand(n) < 0.7, rng.normal(0, 0.05, n), rng.uniform(0.2, 3.0, n))
    nlz = np.where(rng.rand(n) < 0.95, -1.0, 1.0)
    boxes = np.zeros((n_obj, 9), np.float32)
    boxes[:, 0:2] = rng.uniform(-40, 40, (n_obj, 2))
    boxes[:, 2] = rng.uniform(0.5, 1.2, n_obj)
    boxes[:, 3:6] = rng.uniform([3.8, 1.7, 1.5], [5.0, 2.2, 1.9], (n_obj, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_obj)
    boxes[:, 7:9] = rng.uniform(-3, 3, (n_obj, 2))
    planted = []
    for b in boxes:
        k = rng.randint(8, 40)
        local = (rng.rand(k, 3) - 0.5) * b[3:6] * 0.9
        c, s = np.cos(b[6]), np.sin(b[6])
        planted.append(np.stack([b[0] + local[:, 0] * c - local[:, 1] * s,
                                 b[1] + local[:, 0] * s + local[:, 1] * c, b[2] + local[:, 2],
                                 rng.rand(k) * 3, rng.rand(k), -np.ones(k)], 1))
    pts = np.concatenate([np.stack([r * np.cos(th), r * np.sin(th), z, rng.rand(n) * 3,
                                    rng.rand(n), nlz], 1)] + planted, 0).astype(np.float32)
    return pts, boxes


@pytest.fixture(scope="module")
def waymo_root(tmp_path_factory):
    """Two sequences of 3 frames in the reference's layout, 4x4 poses,
    annos with COM side arrays, and a GT database: a db-info pickle and one
    f32 point file an object (box-relative xyz)."""
    root = tmp_path_factory.mktemp("waymo")
    tag = root / "waymo_processed_data_v0_5_0"
    (root / "ImageSets").mkdir()
    (root / "gt_database").mkdir()
    rng = np.random.RandomState(7)
    seqs = ["segment-0000_fixture", "segment-0001_fixture"]
    (root / "ImageSets" / "train.txt").write_text("".join(f"{s}.tfrecord\n" for s in seqs))
    names = np.array(["Vehicle"] * 3 + ["Pedestrian", "Cyclist", "Sign"])
    for s in seqs:
        (tag / s).mkdir(parents=True)
        infos = []
        for i in range(3):
            pts, boxes = _make_frame(rng)
            np.save(tag / s / f"{i:04d}.npy", pts)
            pose = np.eye(4)
            pose[:2, :2] = [[np.cos(0.02 * i), -np.sin(0.02 * i)],
                            [np.sin(0.02 * i), np.cos(0.02 * i)]]
            pose[0, 3] = 2.0 * i
            infos.append({
                "point_cloud": {"lidar_sequence": s, "sample_idx": i},
                "frame_id": f"{s}_{i:03d}", "pose": pose,
                "annos": {"name": names.copy(), "gt_boxes_lidar": boxes.copy(),
                          "num_points_in_gt": rng.randint(0, 40, len(boxes)),
                          "difficulty": np.zeros(len(boxes), np.int64),
                          "occupancy_ratio": rng.rand(len(boxes)).astype(np.float32),
                          "facade_type": rng.randint(0, 4, len(boxes)).astype(np.float32)}})
        with open(tag / s / f"{s}_short.pkl", "wb") as f:
            pickle.dump(infos, f)
    for feats in (5, 6):  # the single-frame scenes' features, and with a timestamp
        db = {}
        for c in NAMES:
            db[c] = make_synthetic_db_infos(np.random.RandomState(8), [c], per_class=24)[c]
            for k, info in enumerate(db[c]):
                pts = info.pop("points")
                pts[:, :3] -= info["box3d_lidar"][:3]
                if feats == 6:
                    pts = np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1)
                info["path"] = f"gt_database/{c}_{k}_{feats}.bin"
                info["difficulty"] = -1 if k % 10 == 3 else 0
                pts.astype(np.float32).tofile(root / info["path"])
        with open(root / f"waymo_dbinfos_{feats}.pkl", "wb") as f:
            pickle.dump(db, f)
    return root


def _waymo_cfg(mod, root, multiframe):
    cfg = mod.cfg_from_yaml_file(FLAGSHIP).DATA_CONFIG
    cfg.DATA_PATH = str(root)
    cfg.SAMPLED_INTERVAL = {"train": 1, "test": 1}
    cfg.MAX_POINTS_PER_SCENE, cfg.MAX_GT_OBJECTS = 16384, 48
    gt = cfg.DATA_AUGMENTOR.AUG_CONFIG_LIST[0]
    gt.SAMPLE_GROUPS = ["Vehicle:8", "Pedestrian:4", "Cyclist:4"]
    gt.DB_INFO_PATH = [f"waymo_dbinfos_{6 if multiframe else 5}.pkl"]
    if multiframe:
        cfg.SEQUENCE_CONFIG = {"ENABLED": True, "SAMPLE_OFFSET": [-2, 0]}
        feats = ["x", "y", "z", "intensity", "elongation", "timestamp"]
        cfg.POINT_FEATURE_ENCODING.used_feature_list = feats
        cfg.POINT_FEATURE_ENCODING.src_feature_list = feats
        gt.NUM_POINT_FEATURES = 6
    return cfg


@pytest.mark.parametrize("multiframe", [False, True], ids=["single", "multiframe"])
def test_waymo_frames_match_jax(jax_native, waymo_root, multiframe):
    """``WaymoDataset`` over the surrogate frames (two sequences, the
    'Sign' class dropped, NLZ points dropped) with the flagship's
    augmentation (GT-paste from the file-based database) and processing: 2
    epochs, confidences set after the first, bit-equal batches."""
    conf = [np.random.RandomState(1).uniform(0, 0.6, (3, 96)).astype(np.float32)]
    runs = []
    for build, mod in ((jax_build_dataloader, jax_config), (build_dataloader, config)):
        cfg = mod.CfgNode({"DATA_CONFIG": _waymo_cfg(mod, waymo_root, multiframe)})
        ds, batches = _epochs(build, cfg, conf, epochs=2)
        assert len(ds) == 6 and type(ds).__name__ == "WaymoDataset"
        runs.append(batches)
    for j, p in zip(*runs):
        _assert_batches_equal(j, p)
    pasted = sum(int((b["true_object"] == 2).sum()) for e in runs[1] for b in e)
    b = runs[1][1][0]
    assert b["points"].shape == (2, 16384, 6 if multiframe else 5) and pasted > 0
    assert np.abs(b["points"][..., 3]).max() <= 1.0  # tanh intensity
    if multiframe:  # past sweeps carry positive time lags
        assert b["points"][..., 5].max() == pytest.approx(0.2, abs=1e-6)


# ------------------------------------------------------ groups, state, keys

def test_host_and_device_groups_on_the_database():
    """The sampler's groups (``split_difficulty_groups``) against the loss's
    (``cluster_com_groups``) on the same database entries, in both packages:
    host group g is device group g + 1 within 75 m; beyond 75 m the host
    puts an object in no group, the device in the last distance bin.
    ``com_tpu`` does the same, so the port keeps it."""
    rng = np.random.RandomState(0)
    db = make_synthetic_db_infos(rng, NAMES, per_class=200)
    for c in NAMES:
        for info in db[c][:40]:  # some beyond 75 m
            info["box3d_lidar"][:2] *= 1.6
    for ci, c in enumerate(NAMES):
        host = np.full(len(db[c]), -1)
        for g, idx in enumerate(split_difficulty_groups(db, c)):
            host[idx] = g
        jhost = np.full(len(db[c]), -1)
        for g, idx in enumerate(jax_split(db, c)):
            jhost[idx] = g
        np.testing.assert_array_equal(host, jhost)
        boxes = np.stack([np.append(i["box3d_lidar"], ci + 1) for i in db[c]]).astype(np.float32)
        occ = np.array([i["occupancy_ratio"] for i in db[c]], np.float32)
        fac = np.array([i["facade_type"] for i in db[c]], np.float32)
        one = np.ones(len(boxes), np.float32)
        dev = cluster_com_groups(torch.from_numpy(boxes), torch.from_numpy(one),
                                 torch.from_numpy(occ), torch.from_numpy(fac)).numpy()
        jdev = np.asarray(jax_cluster(boxes, one, occ, fac))
        np.testing.assert_array_equal(dev, jdev)
        far = np.hypot(boxes[:, 0], boxes[:, 1]) > 75
        assert far.sum() > 0 and (host[far] == -1).all()
        np.testing.assert_array_equal(dev[~far], host[~far] + 1)
        assert (dev[far] > (64 if c == "Vehicle" else 10)).all()


def test_sampler_state_from_jax_gives_the_same_next_epoch(jax_native):
    """A JAX checkpoint's sampler payload carried into the port draws the
    next epoch as the JAX package does with it."""
    conf = np.random.RandomState(2).uniform(0, 0.6, (3, 96)).astype(np.float32)
    payload = {"confidence_groups": conf}
    runs = []
    for build, mod in ((jax_build_dataloader, jax_config), (build_dataloader, config)):
        ds, loader = build(_synth_cfg(mod).DATA_CONFIG, NAMES, 2, seed=4, workers=1)
        loader.set_epoch(1)
        if mod is config:
            got = sampler_state_from_jax(payload, ds)
            np.testing.assert_array_equal(got, conf)
        else:
            ds.set_confidence_groups(payload["confidence_groups"])
        runs.append(list(loader))
    _assert_batches_equal(*runs)
    with pytest.raises(ValueError):
        sampler_state_from_jax({"confidence_groups": conf[0]}, ds)


@pytest.mark.parametrize("model", ["flagship", "voxel", "pfe", "image"])
def test_device_batch_keys_match_jax(model):
    cfg = config.cfg_from_yaml_file(FLAGSHIP).MODEL
    if model == "voxel":
        cfg.VFE.NAME = "PillarVFE"
    elif model == "pfe":
        cfg.VFE.NAME, cfg.PFE = "MeanVFE", {"NAME": "VoxelSetAbstraction"}
    elif model == "image":
        cfg.VFE.NAME = "ImageVFE"
    assert device_batch_keys(cfg) == jax_batch_keys(cfg)
    if model == "flagship":
        assert device_batch_keys(cfg) == set(BATCH_KEYS)


def test_prefetcher_copies_only_the_batch_keys():
    """Unused keys of a collated batch (voxels, frame ids, the augmentations'
    parameters) stay on the host; ``batch_keys=None`` copies every array."""
    cfg = _synth_cfg(config)
    ds, loader = build_dataloader(cfg.DATA_CONFIG, NAMES, 2, seed=4, workers=1)
    loader.set_epoch(0)
    keys = device_batch_keys(cfg.MODEL)
    host = list(loader)
    assert {"voxels", "frame_id", "noise_rot", "flip_x"} <= set(host[0])
    got = list(DevicePrefetcher(iter(host), torch.device("cpu"), keys))
    assert len(got) == len(host)
    for h, d in zip(host, got):
        assert set(d) == keys
        for k in keys:
            np.testing.assert_array_equal(d[k].numpy(), h[k])
    every = next(iter(DevicePrefetcher(iter(host), torch.device("cpu"))))
    assert "voxels" in every and "frame_id" not in every


def test_sampler_state_outlives_the_item_reseed():
    """Each item reseeds the RNG, but the sampler's round-robin pointers are
    shared by every draw: the same item prepared twice pastes other
    objects, in both packages alike.  So with several loader threads the
    draws follow the threads' timing (a ``com_tpu`` behaviour the port
    keeps; the bit-equality tests use one worker)."""
    runs = []
    for build, mod in ((jax_build_dataloader, jax_config), (build_dataloader, config)):
        ds, _ = build(_synth_cfg(mod).DATA_CONFIG, NAMES, 2, seed=4, workers=1)
        runs.append([ds[0], ds[0]])
    for j, p in zip(*runs):
        for k, v in j.items():
            np.testing.assert_array_equal(p[k], v, err_msg=k)
    first, second = runs[1]
    assert not np.array_equal(first["gt_boxes"], second["gt_boxes"])


def test_train_with_speed_and_gt_sampling_fail_alike(waymo_root):
    """TRAIN_WITH_SPEED keeps 9-column boxes, the GT database has 7: the
    paste cannot join them, in ``com_tpu`` as in the port."""
    errors = []
    for build, mod in ((jax_build_dataloader, jax_config), (build_dataloader, config)):
        cfg = _waymo_cfg(mod, waymo_root, False)
        cfg.TRAIN_WITH_SPEED = True
        ds, _ = build(cfg, NAMES, 2, seed=4, workers=1)
        with pytest.raises(ValueError) as info:
            ds[0]
        errors.append(str(info.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("training", [False, True])
def test_loader_yields_in_epoch_order_with_several_workers(training):
    """Three worker threads and a batch of one: the batches come out in the
    epoch's order (the shuffled one in training), whatever the threads'
    timing."""
    cfg = _synth_cfg(config, NUM_SCENES=9)
    _, loader = build_dataloader(cfg.DATA_CONFIG, NAMES, 1, seed=4, workers=3,
                                 training=training)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        frames = [int(f) for b in loader for f in b["frame_id"]]
        assert frames == loader._shard_order().tolist()
        assert sorted(frames) == list(range(9))
