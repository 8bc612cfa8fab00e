"""The port's local, frustum and pyramid augmentations against ``com_tpu``
on the CPU, bitwise for the same ``RandomState`` seed, on the objects and
points of a KITTI frame written from a seed (``torch_port_kitti_setup``);
and ``build_dataloader`` over that tree with the pointpillar,
pointpillar_newaugs and pointpillar_pyramid_aug YAMLs: the collated
batches of both packages equal bitwise (one loader worker).
"""
import numpy as np
import pytest

from com_tpu.data.augmentor import transforms as jt
from com_tpu.data.dataset import build_dataloader as jax_build_dataloader
from com_tpu_torch.data import build_dataloader
from com_tpu_torch.data.augmentor import transforms as pt
from com_tpu_torch.data.kitti.kitti_dataset import KittiDataset
from torch_port_kitti_setup import assert_same, configs, small_tree

PP = "configs/kitti_models/pointpillar.yaml"
NEWAUGS = "configs/kitti_models/pointpillar_newaugs.yaml"
PYRAMID = "configs/kitti_models/pointpillar_pyramid_aug.yaml"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    return root, small_tree(root, seed=4)


@pytest.fixture(scope="module")
def scene(tree):
    """A frame's lidar points and GT boxes (x y z dx dy dz heading)."""
    root, ids = tree
    _, pcfg = configs(PP, root)
    ds = KittiDataset(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), training=False)
    idx = ds.sample_ids[0]
    return ds.get_lidar(idx), ds.frame_gt_annos(idx)["gt_boxes_lidar"][:, :7].copy()


def _pyramid_chain(m, g, p, r):
    """Dropout -> sparsify -> swap, the pyramid chain threaded through."""
    g, p, pyr = m.local_pyramid_dropout(g, p, 0.3, rng=r)
    g, p, pyr = m.local_pyramid_sparsify(g, p, 0.5, 3, pyr, rng=r)
    return m.local_pyramid_swap(g, p, 0.8, 2, pyr, rng=r)


CASES = {
    "local_rotation": lambda m, g, p, r: m.random_local_rotation(g, p, [-0.3, 0.3], rng=r),
    "local_scaling": lambda m, g, p, r: m.random_local_scaling(g, p, [0.9, 1.1], rng=r),
    "local_scaling_degenerate": lambda m, g, p, r: (
        m.random_local_scaling(g, p, [1.0, 1.0], rng=r), r.uniform()),
    "local_translation": lambda m, g, p, r: m.random_local_translation(
        g, p, [0.95, 1.05], ["x", "y", "z"], rng=r),
    "local_frustum_top": lambda m, g, p, r: m.random_local_frustum_dropout(
        g, p, [0.0, 0.5], "top", rng=r),
    "local_frustum_bottom": lambda m, g, p, r: m.random_local_frustum_dropout(
        g, p, [0.0, 0.5], "bottom", rng=r),
    "local_frustum_left": lambda m, g, p, r: m.random_local_frustum_dropout(
        g, p, [0.0, 0.5], "left", rng=r),
    "local_frustum_right": lambda m, g, p, r: m.random_local_frustum_dropout(
        g, p, [0.0, 0.5], "right", rng=r),
    "world_frustum": lambda m, g, p, r: m.random_world_frustum_dropout(
        g, p, [0.0, 0.2], ["top", "bottom", "left", "right"], rng=r),
    "local_sparsify": lambda m, g, p, r: m.random_local_sparsify(g, p, 0.3, rng=r),
    "pyramid_dropout": lambda m, g, p, r: m.local_pyramid_dropout(g, p, 0.5, rng=r),
    "pyramid_sparsify": lambda m, g, p, r: m.local_pyramid_sparsify(g, p, 0.6, 4, rng=r),
    "pyramid_swap": lambda m, g, p, r: m.local_pyramid_swap(g, p, 1.0, 2, rng=r),
    "pyramid_chain": lambda m, g, p, r: _pyramid_chain(m, g, p, r),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(CASES))
def test_augmentation_matches_jax_bitwise(scene, case, seed):
    """Both packages' transform on copies of one frame, each with its own
    ``RandomState(seed)``: outputs and the state of the RNG after equal."""
    pts, gt = scene
    outs = []
    for m in (jt, pt):
        rng = np.random.RandomState(seed)
        outs.append((CASES[case](m, gt.copy(), pts.copy(), rng), rng.uniform()))
    assert_same(outs[0], outs[1], case)


def test_augmentations_change_the_scene(scene):
    """Each case moves or drops something on this frame (so the bitwise
    comparisons above compare work done)."""
    pts, gt = scene
    for case, fn in CASES.items():
        if case == "local_scaling_degenerate":
            continue
        out = fn(pt, gt.copy(), pts.copy(), np.random.RandomState(0))
        g, p = out[0], out[1]
        moved = (len(p) != len(pts) or len(g) != len(gt) or not np.array_equal(p, pts)
                 or not np.array_equal(g, gt))
        assert moved, case


def test_pyramid_helpers_match_jax(scene):
    pts, gt = scene
    pyr_j, pyr_p = jt._ref_face_pyramids(gt), pt._ref_face_pyramids(gt)
    assert_same(pyr_j, pyr_p)
    assert pyr_p.shape == (len(gt), 6, 5, 3)
    assert_same(jt._ref_face_pyramids(gt[:0]), pt._ref_face_pyramids(gt[:0]))
    flat = pyr_p.reshape(-1, 5, 3)
    hits = pt._points_in_hulls(pts, flat)
    assert_same(jt._points_in_hulls(pts, flat), hits)
    assert hits.sum() > 50
    inside = pts[hits[:, 0]]
    ratios = pt._pyramid_ratios(inside, flat[0])
    assert_same(jt._pyramid_ratios(inside, flat[0]), ratios)
    assert_same(jt._points_from_ratios(*ratios, flat[1]), pt._points_from_ratios(*ratios, flat[1]))
    np.testing.assert_allclose(pt._points_from_ratios(*ratios, flat[0]), inside[:, :3],
                               atol=1e-4)
    for box in gt:
        assert_same(jt._points_in_box_margin(pts, box), pt._points_in_box_margin(pts, box))


@pytest.mark.parametrize("path", [PP, NEWAUGS, PYRAMID])
def test_dataloader_over_the_tree_matches_jax_bitwise(tree, path):
    """Two epochs of batch 2 through each package's ``build_dataloader``
    (the YAML's own augmentation: GT sampling from the tree's database,
    the local / frustum / pyramid augmentations, the world ones), seed 3."""
    root, _ = tree
    jcfg, pcfg = configs(path, root)
    runs = []
    for build, cfg in ((jax_build_dataloader, jcfg), (build_dataloader, pcfg)):
        _, loader = build(cfg.DATA_CONFIG, list(cfg.CLASS_NAMES), 2, training=True, seed=3,
                          workers=1)
        batches = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            batches += list(loader)
        runs.append(batches)
    assert len(runs[1]) == 4
    assert_same(runs[0], runs[1], path)
    pasted = sum(int((b["true_object"] == 2).sum()) for b in runs[1])
    if pcfg.DATA_CONFIG.DATA_AUGMENTOR.AUG_CONFIG_LIST[0]["USE_ROAD_PLANE"]:
        # the plane read without calib (a points-only item) lifts every
        # pasted box tens of metres off the road, and the range mask drops
        # them all: kept from com_tpu (test_torch_port_kitti.py)
        assert pasted == 0
    else:
        assert pasted > 0
