"""The port's Lyft and Pandaset data sides and ``lyft_models/
cbgs_second_multihead.yaml`` fed from the port's loader, against
``com_tpu`` on the CPU.

Lyft: a tree written from a seed by ``com_tpu_torch.tools.dataset_trees``
(4 train and 2 val frames, the key frame and 4 sweeps of 1,500 points, a GT
database) read by both packages under the config's own DATA_CONFIG, the
same seed and order on one thread: items and the collated batch bitwise;
``lyft_eval``'s ``get_average_precisions`` and ``format_lyft_results`` on
``tests/test_lyft_eval_golden.py``'s seeded scenes (the port's IoU is
float64 torch, ``com_tpu``'s float64 numpy: APs to 1e-12) and
``LyftDataset.evaluation`` under both metrics (KITTI-style AP to 1e-6:
``com_tpu``'s IoU there is float32).  Pandaset: the pre-extracted layout's
items bitwise, the devkit layout's (pandas frames, needs pandas) items,
infos and GT database bitwise, the prediction round trip to world cuboids,
``set_split``, the 100-frame limit and ``evaluation``.  The missing reseed
of all three datasets alike.  The model at a 64 x 64 x 40 grid (2.5 x 2.5
x 0.2 m voxels over the config's 160 m range), narrowed, f32, its weights
the port's seeded init carried to flax: the eval step's detections to
1e-4 (the class biases +4, the box kernels x0.02).
"""
import copy
import pickle

import jax
import numpy as np
import pytest
import torch

import test_torch_port_train_common as common
from com_tpu.data.lyft import lyft_dataset as jld
from com_tpu.data.lyft import lyft_eval as jle
from com_tpu.data.pandaset import pandaset_dataset as jpd
from com_tpu.data.pandaset import pandaset_utils as jpu
from com_tpu.models.detectors import DatasetMeta as JaxMeta
from com_tpu.models.detectors import build_network as jax_build_network
from com_tpu.train.eval import make_eval_step as jax_make_eval_step
from com_tpu.utils import config as jax_config
from com_tpu_torch.data import build_dataloader
from com_tpu_torch.data.lyft import lyft_dataset as pld
from com_tpu_torch.data.lyft import lyft_eval as ple
from com_tpu_torch.data.pandaset import pandaset_dataset as ppd
from com_tpu_torch.data.pandaset import pandaset_utils as ppu
from com_tpu_torch.models.detectors import DatasetMeta, build_network
from com_tpu_torch.tools.dataset_trees import write_lyft_tree, write_pandaset_tree
from com_tpu_torch.train.eval import make_eval_step
from com_tpu_torch.train.step import model_input_keys
from com_tpu_torch.utils import config as port_config
from com_tpu_torch.utils.jax_weights import load_jax_variables
from test_lyft_eval_golden import _scene, _to_ours
from test_torch_port_slice import _match
from torch_port_centerhead_setup import flax_variables
from torch_port_kitti_setup import REPO, assert_same, configs

torch.set_num_threads(2)

LYFT = "configs/lyft_models/cbgs_second_multihead.yaml"
PANDASET = "configs/dataset_configs/pandaset_dataset.yaml"
ATOL = 1e-4
SMALL_VOXEL = [2.5, 2.5, 0.2]  # 64 x 64 x 40 over [-80, 80]^2 x [-5, 3]


@pytest.fixture(scope="module")
def lyft_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("lyft")
    return root, write_lyft_tree(root, seed=0, num_train=4, num_val=2, num_points=1500)


@pytest.fixture(scope="module")
def pandaset_trees(tmp_path_factory):
    """The pre-extracted layout (2 + 2 frames of 4,000 points) and, where
    pandas is installed, the devkit layout of the same frames."""
    ext = tmp_path_factory.mktemp("pandaset")
    write_pandaset_tree(ext, seed=1, num_train=2, num_val=2, num_points=4000)
    dev = None
    try:
        import pandas  # noqa: F401
    except ImportError:
        pass
    else:
        dev = tmp_path_factory.mktemp("pandaset_devkit")
        write_pandaset_tree(dev, seed=1, num_train=2, num_val=2, num_points=4000,
                            layout="devkit")
    return ext, dev


def lyft_pair(root, training, seed=3):
    jcfg, pcfg = configs(LYFT, root)
    return (jld.LyftDataset(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), training=training,
                            seed=seed),
            pld.LyftDataset(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), training=training,
                            seed=seed))


def pandaset_cfgs(root):
    """(com_tpu's, the port's) PANDASET dataset config with DATA_PATH
    ``root``, and the training categories as class names."""
    out = []
    for conf in (jax_config, port_config):
        cfg = conf.cfg_from_yaml_file(str(REPO / PANDASET), conf.CfgNode())
        cfg.DATA_PATH = str(root)
        out.append(cfg)
    return (*out, sorted(set(out[1].TRAINING_CATEGORIES.values())))


def pandaset_pair(root, training, seed=3, infos=None):
    jcfg, pcfg, names = pandaset_cfgs(root)
    kw = {} if infos is None else {"infos": infos}
    return (jpd.PandasetDataset(jcfg, names, training=training, seed=seed, **copy.deepcopy(kw)),
            ppd.PandasetDataset(pcfg, names, training=training, seed=seed, **copy.deepcopy(kw)))


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_lyft_items_and_batch_match_jax_bitwise(lyft_tree, training):
    """The first 4 sweeps in order, 7-column boxes, GT sampling and the
    world augmentations in training; then the collate."""
    root, _ = lyft_tree
    jds, pds = lyft_pair(root, training)
    assert len(pds) == len(jds) == (4 if training else 2)
    jitems = [jds[i] for i in range(len(jds))]
    pitems = [pds[i] for i in range(len(pds))]
    for i, (a, b) in enumerate(zip(jitems, pitems)):
        assert_same(a, b, str(i))
        assert b["gt_boxes"].shape[1] == 8 and b["points"].shape[1] == 5
    assert_same(jds.collate_batch(jitems[:2]), pds.collate_batch(pitems[:2]), "batch")
    sweeps = pds.get_lidar_with_sweeps(0, 5)
    np.testing.assert_allclose(np.unique(sweeps[:, 4]), 0.05 * np.arange(5), atol=1e-6)
    assert_same(jds.get_lidar_with_sweeps(0, 5), sweeps)


@pytest.mark.parametrize("which", ["lyft", "pandaset"])
def test_the_missing_reseed_alike(lyft_tree, pandaset_trees, which):
    """No ``_reseed_for_item``: a training item 0 read after item 1 differs
    from item 0 read first (the augmentations follow the thread's
    stream), alike in both packages."""
    got = {}
    for order in ((0, 1), (1, 0)):
        jds, pds = (lyft_pair(lyft_tree[0], True) if which == "lyft"
                    else pandaset_pair(pandaset_trees[0], True))
        ja = {i: jds[i] for i in order}
        pa = {i: pds[i] for i in order}
        assert_same(ja, pa, str(order))
        got[order] = pa[0]["points"]
    assert not np.array_equal(got[(0, 1)], got[(1, 0)])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lyft_average_precisions_match_jax(seed):
    rng = np.random.RandomState(seed)
    gt, preds = _scene(rng)
    classes, ious = ["car", "pedestrian"], [0.3, 0.5, 0.7]
    gt, preds = _to_ours(gt), _to_ours(preds, with_score=True)
    want = jle.get_average_precisions(gt, preds, classes, ious)
    got = ple.get_average_precisions(gt, preds, classes, ious)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got.max() > 0
    want_str, want_d = jle.format_lyft_results(want, classes, ious)
    got_str, got_d = ple.format_lyft_results(got, classes, ious)
    assert got_str == want_str and got_d.keys() == want_d.keys()
    for k in want_d:
        assert got_d[k] == pytest.approx(want_d[k], abs=1e-12)
    recs = np.sort(rng.rand(12))
    precs = rng.rand(12)
    assert ple.get_ap(recs.copy(), precs.copy()) == jle.get_ap(recs.copy(), precs.copy())
    assert ple.recall_precision([], [], [0.5]) == jle.recall_precision([], [], [0.5])


@pytest.mark.parametrize("metric", ["lyft", "kitti"])
def test_lyft_evaluation_matches_jax(lyft_tree, metric):
    """The val GT jittered and scored as detections (one frame repeated, as
    a padded multi-process eval repeats it), keyed by token or frame id."""
    root, _ = lyft_tree
    jds, pds = lyft_pair(root, False)
    rng = np.random.RandomState(11)
    det_annos = []
    for k, info in enumerate(pds.infos + pds.infos[:1]):
        g = np.asarray(info["gt_boxes"])[:, :7].copy()
        g[:, :2] += rng.normal(0, 0.1, (len(g), 2))
        key = ({"metadata": {"token": info["token"]}} if k % 2 else
               {"frame_id": info["lidar_path"].split("/")[-1][:-4], "metadata": {}})
        det_annos.append(dict(key, name=np.asarray(info["gt_names"]), score=rng.rand(len(g)),
                              boxes_lidar=g.astype(np.float32)))
    names = list(pds.class_names)
    want_str, want = jds.evaluation(copy.deepcopy(det_annos[:len(pds.infos)] if metric == "kitti"
                                                  else det_annos), names, eval_metric=metric)
    got_str, got = pds.evaluation(copy.deepcopy(det_annos[:len(pds.infos)] if metric == "kitti"
                                                else det_annos), names, eval_metric=metric)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6 if metric == "kitti" else 1e-12,
                                   err_msg=k)
    if metric == "lyft":
        assert got_str == want_str and got["mAP"] > 0.1 and "car" in got


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
def test_pandaset_extracted_items_match_jax_bitwise(pandaset_trees, training):
    root = pandaset_trees[0]
    jds, pds = pandaset_pair(root, training)
    assert len(pds) == len(jds) == 2
    jitems = [jds[i] for i in range(2)]
    pitems = [pds[i] for i in range(2)]
    for i, (a, b) in enumerate(zip(jitems, pitems)):
        assert_same(a, b, str(i))
    assert_same(jds.collate_batch(jitems), pds.collate_batch(pitems), "batch")
    det = [{"name": np.asarray(i["gt_names"]), "score": np.linspace(0.9, 0.1, len(i["gt_names"])),
            "boxes_lidar": np.asarray(i["gt_boxes"])} for i in pds.infos]
    want_str, want = jds.evaluation(copy.deepcopy(det), list(pds.class_names))
    got_str, got = pds.evaluation(copy.deepcopy(det), list(pds.class_names))
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
    assert got["Car_bev"][0] > 0


def test_pandaset_devkit_layout_matches_jax(pandaset_trees, tmp_path):
    """The devkit layout (pandas frames): ``create_pandaset_infos`` (infos and
    the train GT database) and the items read through it, bitwise; the
    normative frame agrees with the pre-extracted one it was written from;
    the prediction round trip; ``set_split``; ``evaluation`` without GT."""
    pytest.importorskip("pandas")
    root = pandaset_trees[1]
    jcfg, pcfg, names = pandaset_cfgs(root)
    for cfg in (jcfg, pcfg):
        cfg.SEQUENCES = {"train": ["001"], "val": ["046"], "test": []}
    outs = []
    for mod, cfg, sub in ((jpu, jcfg, "jax"), (ppu, pcfg, "port")):
        save = tmp_path / sub
        save.mkdir()
        mod.create_pandaset_infos(cfg, names, root, save, with_gt_database=False)
        db = mod.create_groundtruth_database(cfg, root, save / "pandaset_infos_train.pkl")
        infos = {s: pickle.load(open(save / f"pandaset_infos_{s}.pkl", "rb"))
                 for s in ("train", "val", "test")}
        outs.append((infos, db))
    assert_same(outs[0], outs[1])
    assert len(outs[1][0]["train"]) == 2 and sum(len(v) for v in outs[1][1].values()) > 20
    infos = outs[1][0]["val"]
    jds, pds = pandaset_pair(root, False, infos=infos)
    jitems, pitems = [jds[i] for i in range(2)], [pds[i] for i in range(2)]
    for i, (a, b) in enumerate(zip(jitems, pitems)):
        assert_same(a, b, str(i))
    ext = pickle.load(open(pandaset_trees[0] / "pandaset_infos_val.pkl", "rb"))
    assert 0 < len(pitems[0]["gt_boxes"]) <= len(ext[0]["gt_names"])  # one sensor's cuboids
    # the frame's pose fields ride on the items (the collate keeps no such key)
    batch = {k: np.stack([np.asarray(b[k]) for b in pitems])
             for k in ("zrot_world_to_ego", "pose", "frame_idx", "sequence")}
    preds = [{"pred_boxes": torch.from_numpy(np.asarray(b["gt_boxes"])[:, :7]),
              "pred_scores": torch.rand(len(b["gt_boxes"])),
              "pred_labels": torch.from_numpy(np.asarray(b["gt_boxes"])[:, 7].astype(np.int64))}
             for b in pitems]
    want = jds.generate_prediction_dicts(batch, copy.deepcopy(preds), names)
    got = pds.generate_prediction_dicts(batch, copy.deepcopy(preds), names,
                                        output_path=tmp_path / "preds")
    assert_same(want, got)
    import pandas as pd

    written = pd.read_pickle(tmp_path / "preds" / "046" / "predictions" / "cuboids" / "00.pkl.gz")
    np.testing.assert_allclose(written["position.x"].to_numpy(), got[0]["preds"]["position.x"])
    pose = ppu.load_poses(root / "dataset" / "046")[0]
    raw = pd.read_pickle(root / "dataset" / "046" / "annotations" / "cuboids" / "00.pkl.gz")
    raw = raw[raw["cuboids.sensor_id"] != 1]
    np.testing.assert_allclose(got[0]["preds"]["position.x"], raw["position.x"].to_numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(np.cos(got[0]["preds"]["yaw"]), np.cos(raw["yaw"].to_numpy()),
                               atol=1e-5)
    assert pose == jpu.load_poses(root / "dataset" / "046")[0]
    for ds in (jds, pds):
        ds.set_split("test")
    assert pds.split == jds.split == "test" and pds.sequences == jds.sequences
    assert len(pds.sequences) == 22  # the config's official test split
    assert pds.evaluation([], names) == jds.evaluation([], names) == ("", {})


def test_pandaset_sequence_frame_limit_alike(tmp_path):
    lidar = tmp_path / "dataset" / "007" / "lidar"
    lidar.mkdir(parents=True)
    for i in range(101):
        (lidar / f"{i:03d}.pkl.gz").write_bytes(b"")
    for mod in (jpu, ppu):
        with pytest.raises(ValueError, match="100"):
            mod.get_sequence_infos(tmp_path, "007")


def small_lyft_cfg(cfg):
    """LYFT narrowed for the CPU at the 64 x 64 x 40 grid (f32)."""
    dp = cfg.DATA_CONFIG.DATA_PROCESSOR[2]
    dp.VOXEL_SIZE = list(SMALL_VOXEL)
    dp.MAX_NUMBER_OF_VOXELS = {"train": 8192, "test": 8192}
    m = cfg.MODEL
    m.MIXED_PRECISION = False
    m.BACKBONE_3D.update(CHANNELS=[8, 16, 16, 32], VOXEL_CAPS=[8192, 4096, 2048, 1024])
    m.MAP_TO_BEV.NUM_BEV_FEATURES = 64
    m.BACKBONE_2D.update(LAYER_NUMS=[1, 1], NUM_FILTERS=[32, 64], NUM_UPSAMPLE_FILTERS=[32, 32])
    m.DENSE_HEAD.SHARED_CONV_NUM_FILTER = 16
    m.POST_PROCESSING.NMS_CONFIG.NMS_PRE_MAXSIZE = 256
    return cfg


def test_lyft_eval_step_matches_jax(lyft_tree):
    """SECOND-multihead (MeanVFE, VoxelResBackBone8x, AnchorHeadMulti's five
    groups, MULTI_CLASSES_NMS over nine classes) on the port's val batch."""
    root, _ = lyft_tree
    _, pcfg = configs(LYFT, root)
    cfg = small_lyft_cfg(pcfg)
    names = list(cfg.CLASS_NAMES)
    args = (names, [-80.0, -80.0, -5.0, 80.0, 80.0, 3.0], SMALL_VOXEL, (64, 64, 40), 5)
    jmeta, pmeta = JaxMeta(*args), DatasetMeta(*args)
    _, loader = build_dataloader(cfg.DATA_CONFIG, names, 2, workers=1, training=False, seed=4)
    val = next(iter(loader))
    host = {k: np.asarray(val[k]) for k in model_input_keys(cfg.MODEL)}
    net = build_network(cfg.MODEL, pmeta, device="cpu", seed=21)
    variables = common.perturb(flax_variables(
        net, cfg, ("VoxelResBackBone8x_0", "BaseBEVBackbone_0", "AnchorHeadMulti_0")), seed=22)
    head = variables["params"]["AnchorHeadMulti_0"]
    for i in range(len(cfg.MODEL.DENSE_HEAD.RPN_HEAD_CFGS)):
        head[f"h{i}_cls"]["bias"] = head[f"h{i}_cls"]["bias"] + np.float32(4.0)
        head[f"h{i}_box"]["kernel"] = head[f"h{i}_box"]["kernel"] * np.float32(0.02)
    load_jax_variables(net, variables, cfg.MODEL, names)
    jnet = jax_build_network(copy.deepcopy(cfg.MODEL), jmeta)
    jb, js, jl, jv = (np.asarray(o) for o in jax.jit(
        jax_make_eval_step(jnet, cfg.MODEL, names, jmeta))(variables, host))
    boxes, scores, labels, valid = (t.numpy() for t in make_eval_step(
        net, cfg.MODEL, names, pmeta, device="cpu")(host))
    np.testing.assert_array_equal(valid, jv)
    assert valid.sum() > 10 and len(np.unique(labels[valid])) >= 5
    for i in range(2):
        rows = lambda b, s, l, v: np.concatenate(  # noqa: E731
            [b[i][v[i]], s[i][v[i]][:, None], l[i][v[i]][:, None].astype(np.float32)], -1)
        worst, one_to_one = _match(rows(boxes, scores, labels, valid), rows(jb, js, jl, jv))
        assert worst <= ATOL and one_to_one, (i, worst)
