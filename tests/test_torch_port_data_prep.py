"""The port's COM data preparation against ``com_tpu`` on the CPU: the
occupancy / facade annotator, the Waymo GT database, the ``create_data``
CLI, the pure parts of ``waymo_utils`` and the rehearsal's distribution
report.

The annotator's inputs are seeded numpy: boxes of every class (and one
other class) at random poses and rotations, with empty, full, boundary and
random point sets; outputs exactly equal.  The database runs over a Waymo
tree of ``com_tpu_torch.tools.dataset_trees.write_waymo_tree`` (2 train
sequences of 10 frames, ``SAMPLED_INTERVAL`` 5, 1 val sequence of 2 frames,
8,000 points a frame): the pickles equal and the ``.bin`` files byte for
byte.  Each ``create_data --func`` runs in both packages on the same input.
``com_tpu``'s ``create_gt_database`` builds the config's ``gt_sampling``
before it writes the database that sampler reads, so on a fresh tree with a
COM config it raises FileNotFoundError; the port builds the dataset without
it (``database_data_config``) and writes the database ``com_tpu`` writes
from the same config less that augmentation.
"""
import importlib.util
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

from com_tpu.data import annotator as jann
from com_tpu.data import build_dataloader as jax_build_dataloader
from com_tpu.data.waymo import waymo_utils as jwu
from com_tpu_torch.data import annotator as pann
from com_tpu_torch.data import build_dataloader
from com_tpu_torch.data.waymo import waymo_utils as pwu
from com_tpu_torch.tools import com_rehearsal, create_data
from com_tpu_torch.tools.dataset_trees import write_pandaset_tree, write_waymo_tree
from test_dataset_adapters import _stub_frame
from torch_port_kitti_setup import REPO, assert_same, configs

FLAGSHIP = "configs/waymo_models/com/centerpoint_pillar_3cls_com.yaml"
SYNTH = "configs/synthetic_models/centerpoint_synth_com.yaml"
CLASSES = ("Vehicle", "Pedestrian", "Cyclist", "Sign")
SIZES = {"Vehicle": (4.7, 2.1, 1.7), "Pedestrian": (0.9, 0.9, 1.7), "Cyclist": (1.8, 0.8, 1.7),
         "Sign": (0.3, 0.8, 1.0)}


def _load(path):
    spec = importlib.util.spec_from_file_location(f"jax_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_create_data = _load(REPO / "tools" / "create_data.py")
jax_rehearsal = _load(REPO / "tools" / "com_rehearsal.py")


def _box(rng, name, yaw=None, xy=None):
    dims = np.asarray(SIZES[name]) * rng.uniform(0.8, 1.2, 3)
    xy = rng.uniform(-60, 60, 2) if xy is None else np.asarray(xy, np.float64)
    yaw = rng.uniform(-np.pi, np.pi) if yaw is None else yaw
    return np.array([xy[0], xy[1], dims[2] / 2, *dims, yaw], np.float64)


def _points(rng, box, kind):
    """Points for ``box``: none, every cell filled, on the box's faces and
    corners (the +1e-6 slack), or a random share inside and around it."""
    c, s = np.cos(box[6]), np.sin(box[6])
    half = box[3:6] / 2
    if kind == "empty":
        return np.zeros((0, 3))
    if kind == "full":
        g = (np.stack(np.meshgrid(*[np.linspace(-0.45, 0.45, 7)] * 3, indexing="ij"), -1)
             .reshape(-1, 3) * box[3:6])
        local = np.concatenate([g, g * 0.99])
    elif kind == "boundary":
        corners = np.stack(np.meshgrid(*[[-1.0, 0.0, 1.0]] * 3, indexing="ij"), -1).reshape(-1, 3)
        local = np.concatenate([corners * half, corners * (half + 5e-7), corners * (half + 2e-6),
                                corners * half * (1 / 3)])
    else:
        local = rng.uniform(-0.7, 0.7, (rng.randint(1, 60), 3)) * box[3:6]
    return np.stack([local[:, 0] * c - local[:, 1] * s, local[:, 0] * s + local[:, 1] * c,
                     local[:, 2]], 1) + box[:3]


@pytest.mark.parametrize("kind", ["empty", "full", "boundary", "random"])
@pytest.mark.parametrize("name", CLASSES)
def test_occupancy_and_facade_equal(name, kind):
    """``occupancy_ratio`` and ``facade_type`` exactly as ``com_tpu``'s, on
    axis-aligned and rotated boxes, with the angle; every ratio on the
    1/12 lattice."""
    rng = np.random.RandomState(CLASSES.index(name) * 10 + len(kind))
    boxes = [_box(rng, name, yaw=0.0), _box(rng, name, yaw=np.pi / 2)]
    boxes += [_box(rng, name) for _ in range(12)]
    for box in boxes:
        pts = _points(rng, box, kind)
        got = pann.occupancy_ratio(pts, box, name)
        assert got == jann.occupancy_ratio(pts, box, name)
        assert round(got * 12) == got * 12 and 0 <= got <= 1
        assert pann.facade_type(box, name) == jann.facade_type(box, name)
    if kind == "full":
        assert pann.occupancy_ratio(_points(rng, boxes[0], kind), boxes[0], name) == (
            5 / 12 if name in ("Pedestrian", "Cyclist") else 1.0)


def test_facade_type_at_its_angles():
    """Headings on and around each sector's edge (dt 10 degrees and 5), in
    every quadrant: the type and angle as ``com_tpu``'s, -1 off Vehicle."""
    for x, y in ((20.0, 0.0), (0.0, -15.0), (-7.0, 7.0), (30.0, 40.0)):
        view = np.arctan2(y, x)
        for deg in range(0, 360, 5):
            for eps in (-1e-9, 0.0, 1e-9, 0.3):
                box = np.array([x, y, 1.0, 4.0, 2.0, 1.5, view + np.deg2rad(deg + eps)])
                for dt in (10.0, 5.0):
                    assert pann.facade_type(box, "Vehicle", dt) == jann.facade_type(
                        box, "Vehicle", dt)
                assert pann.facade_type(box, "Cyclist") == (-1, 0.0)
    types_seen = {pann.facade_type(np.array([20.0, 0, 1, 4, 2, 1.5, np.deg2rad(d)]),
                                   "Vehicle")[0] for d in range(0, 360, 5)}
    assert types_seen == {0, 1, 2, 3}


def _db_infos(rng, root=None):
    """{class: [entry]}: points in memory, or box-relative ``.bin`` files
    under ``root`` (with the ``path`` key)."""
    db = {}
    for name in CLASSES:
        for i in range(6):
            box = _box(rng, name)
            pts = _points(rng, box, ("empty", "full", "boundary", "random", "random",
                                     "random")[i])
            feats = np.concatenate([pts, rng.uniform(size=(len(pts), 2))], 1).astype(np.float32)
            entry = {"name": name, "box3d_lidar": box.astype(np.float32)}
            if root is None:
                entry["points"] = feats
            else:
                rel = f"gt_database/{name}_{i}.bin"
                (root / "gt_database").mkdir(exist_ok=True)
                rel_pts = feats.copy()
                rel_pts[:, :3] -= box[:3].astype(np.float32)
                rel_pts.tofile(root / rel)
                entry["path"] = rel
            db.setdefault(name, []).append(entry)
    return db


@pytest.mark.parametrize("where", ["memory", "files"])
def test_annotate_db_infos_equal(where, tmp_path):
    """``annotate_db_infos`` exactly as ``com_tpu``'s, with the entries'
    points in memory and in ``.bin`` files (box-relative)."""
    root = None if where == "memory" else tmp_path
    db = _db_infos(np.random.RandomState(3), root)
    got = pann.annotate_db_infos(pickle.loads(pickle.dumps(db)), root_path=root)
    want = jann.annotate_db_infos(pickle.loads(pickle.dumps(db)), root_path=root)
    assert_same(got, want)
    occ = [e["occupancy_ratio"] for v in got.values() for e in v]
    assert len(set(occ)) > 4


def test_annotate_frame_annos_equal():
    """``annotate_frame_annos`` exactly as ``com_tpu``'s over a frame's
    points and 9-column boxes of every class."""
    rng = np.random.RandomState(5)
    names = np.array([CLASSES[i % 4] for i in range(16)])
    boxes = np.stack([_box(rng, n, xy=(8.0 * (i % 4) - 12, 8.0 * (i // 4) - 12))
                      for i, n in enumerate(names)])
    pts = np.concatenate([_points(rng, b, ("full", "boundary", "random", "empty")[i % 4])
                          for i, b in enumerate(boxes)]
                         + [rng.uniform(-20, 20, (500, 3))])
    pts = np.concatenate([pts, rng.uniform(size=(len(pts), 2))], 1).astype(np.float32)
    annos = {"name": names,
             "gt_boxes_lidar": np.concatenate([boxes, np.zeros((16, 2))], 1)}
    got = pann.annotate_frame_annos(dict(annos), pts)
    want = jann.annotate_frame_annos(dict(annos), pts)
    assert_same(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_points_in_rbbox_by_box_is_the_same_mask(dtype):
    """``points_in_rbbox_by_box`` (the test a box at a time on the points
    near it) gives ``points_in_rbbox``'s mask exactly, with points on every
    box's faces, edges and corners, and boxes that overlap."""
    from com_tpu_torch.ops.host_boxes import points_in_rbbox, points_in_rbbox_by_box

    rng = np.random.RandomState(11)
    boxes = np.stack([_box(rng, CLASSES[i % 4], xy=rng.uniform(-20, 20, 2)) for i in range(40)])
    boxes[1, :2] = boxes[0, :2] + 0.3
    pts = np.concatenate([rng.uniform(-25, 25, (20000, 3))]
                         + [_points(rng, b, "boundary") for b in boxes]).astype(dtype)
    boxes = boxes.astype(dtype)
    got = points_in_rbbox_by_box(pts, boxes)
    want = points_in_rbbox(pts, boxes)
    assert got.dtype == want.dtype == bool and np.array_equal(got, want)
    assert want.sum() > 500 and (want.sum(axis=1) > 1).any()


@pytest.fixture(scope="module")
def waymo_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("waymo")
    return root, write_waymo_tree(root, seed=2, num_train=10, num_val=2, num_points=8000,
                                  objects=(10, 16))


def _no_gt_sampling(cfg):
    aug = cfg.DATA_CONFIG.DATA_AUGMENTOR
    aug.AUG_CONFIG_LIST = [a for a in aug.AUG_CONFIG_LIST if a.NAME != "gt_sampling"]
    return cfg


def test_waymo_tree_annotations_and_reader(waymo_tree):
    """The tree's ``_short.pkl`` annos carry ``com_tpu``'s annotation of
    the frame's points as the dataset reads them, and both packages'
    ``WaymoDataset`` read the same thinned train split."""
    root, out = waymo_tree
    jcfg, pcfg = (_no_gt_sampling(c) for c in configs(FLAGSHIP, root))
    jds, _ = jax_build_dataloader(jcfg.DATA_CONFIG, list(jcfg.CLASS_NAMES), 1, training=True,
                                  workers=1)
    pds, _ = build_dataloader(pcfg.DATA_CONFIG, list(pcfg.CLASS_NAMES), 1, training=True,
                              workers=1)
    assert len(pds) == len(jds) == 2 * 10 // 5
    assert_same(pds.infos, jds.infos)
    occ, fac = [], []
    for info in pds.infos:
        pc = info["point_cloud"]
        pts = jds.get_lidar(pc["lidar_sequence"], pc["sample_idx"])
        plain = {k: v for k, v in info["annos"].items()
                 if k not in ("occupancy_ratio", "facade_type")}
        assert_same(info["annos"], jann.annotate_frame_annos(plain, pts))
        assert info["pose"].shape == (4, 4)
        occ += info["annos"]["occupancy_ratio"].tolist()
        fac += info["annos"]["facade_type"].tolist()
    assert len(set(occ)) > 5 and {-1, 3} <= set(fac)
    assert set(out["frames"].values()) == {10, 2}


def test_create_groundtruth_database_equal(waymo_tree, tmp_path):
    """``WaymoDataset.create_groundtruth_database`` over the thinned train
    split: the returned and pickled entries equal and each ``.bin`` byte for
    byte; each entry's count is its file's points (no-label zone dropped)."""
    root, _ = waymo_tree
    jcfg, pcfg = (_no_gt_sampling(c) for c in configs(FLAGSHIP, root))
    names = list(pcfg.CLASS_NAMES)
    jds, _ = jax_build_dataloader(jcfg.DATA_CONFIG, names, 1, training=True, workers=1)
    pds, _ = build_dataloader(pcfg.DATA_CONFIG, names, 1, training=True, workers=1)
    want = jds.create_groundtruth_database(tmp_path / "jax", used_classes=names)
    got = pds.create_groundtruth_database(tmp_path / "port", used_classes=names)
    assert_same(got, want)
    assert_same(pickle.load(open(tmp_path / "port" / "waymo_dbinfos_train.pkl", "rb")),
                pickle.load(open(tmp_path / "jax" / "waymo_dbinfos_train.pkl", "rb")))
    files = sorted(p.name for p in (tmp_path / "jax" / "gt_database").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port" / "gt_database").iterdir())
    for f in files:
        assert ((tmp_path / "port" / "gt_database" / f).read_bytes()
                == (tmp_path / "jax" / "gt_database" / f).read_bytes()), f
    assert set(got) == set(names) and "Sign" not in got
    for entries in got.values():
        for e in entries:
            pts = np.fromfile(tmp_path / "port" / e["path"], np.float32).reshape(-1, 5)
            assert len(pts) == e["num_points_in_gt"]
            assert e["sample_idx"] % 5 == 0


def _yaml(path, cfg):
    import yaml

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x

    path.write_text(yaml.safe_dump(plain(cfg)))
    return str(path)


def _run_jax_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["create_data.py", *argv])
    jax_create_data.main()


def test_create_data_database_funcs_equal(waymo_tree, tmp_path, monkeypatch):
    """``create_gt_database``, ``annotate_database`` and
    ``integrate_database`` through both CLIs: the same pickles, ``.bin``
    files and global array.  The port's ``create_gt_database`` takes the
    flagship's own YAML (its COM2 ``gt_sampling`` left out while the
    database is written); ``com_tpu``'s raises FileNotFoundError on it and
    is run on the YAML less that augmentation."""
    root, _ = waymo_tree
    jcfg, pcfg = configs(FLAGSHIP, root)
    outs = {}
    for side in ("jax", "port"):
        out = tmp_path / side
        if side == "jax":
            with pytest.raises(FileNotFoundError, match="waymo_dbinfos_train.pkl"):
                _run_jax_cli(monkeypatch, ["--func", "create_gt_database", "--cfg_file",
                                           _yaml(tmp_path / "full.yaml", jcfg), "--out_dir",
                                           str(out)])
            run = lambda argv: _run_jax_cli(monkeypatch, argv)  # noqa: E731
            cfg_file = _yaml(tmp_path / "jax.yaml", _no_gt_sampling(jcfg))
        else:
            run = create_data.main
            cfg_file = _yaml(tmp_path / "port.yaml", pcfg)
        run(["--func", "create_gt_database", "--cfg_file", cfg_file, "--out_dir", str(out)])
        db = out / "waymo_dbinfos_train.pkl"
        run(["--func", "annotate_database", "--db_info_path", str(db)])
        run(["--func", "integrate_database", "--db_info_path",
             str(out / "waymo_dbinfos_train_annotated.pkl")])
        outs[side] = out
    for name in ("waymo_dbinfos_train.pkl", "waymo_dbinfos_train_annotated.pkl",
                 "waymo_dbinfos_train_annotated_integrated.pkl"):
        assert_same(pickle.load(open(outs["port"] / name, "rb")),
                    pickle.load(open(outs["jax"] / name, "rb")), name)
    glob = "waymo_dbinfos_train_annotated_global.npy"
    assert (outs["port"] / glob).read_bytes() == (outs["jax"] / glob).read_bytes()
    ann = pickle.load(open(outs["port"] / "waymo_dbinfos_train_annotated.pkl", "rb"))
    for name, entries in ann.items():
        for e in entries:
            assert e["facade_type"] in ((-1,) if name != "Vehicle" else (0, 1, 2, 3))
            assert round(e["occupancy_ratio"] * 12) == e["occupancy_ratio"] * 12


def test_create_data_waymo_and_pandaset_infos_equal(tmp_path, monkeypatch, capsys):
    """``create_waymo_infos``: with no tfrecord both print the same line and
    write nothing; with a record but without tensorflow or waymo-open-dataset
    (neither machine has the latter) both raise ImportError.
    ``create_pandaset_infos`` from a devkit tree (pandas): the same infos
    and GT database."""
    pytest.importorskip("pandas")
    empty = tmp_path / "records"
    empty.mkdir()
    argv = ["--func", "create_waymo_infos", "--root_path", str(empty)]
    _run_jax_cli(monkeypatch, argv)
    jax_out = capsys.readouterr().out
    assert create_data.main(argv) == []
    assert capsys.readouterr().out == jax_out == f"no tfrecords under {empty}\n"
    assert list(empty.iterdir()) == []
    (empty / "segment-0_with_camera_labels.tfrecord").write_bytes(b"")
    with pytest.raises(ImportError):
        _run_jax_cli(monkeypatch, argv)
    with pytest.raises(ImportError):
        create_data.main(argv)

    tree = tmp_path / "pandaset"
    write_pandaset_tree(tree, seed=4, num_train=2, num_val=1, num_points=3000, layout="devkit")
    from com_tpu.utils import config as jax_config
    from com_tpu_torch.utils import config as port_config

    outs = {}
    for side, conf in (("jax", jax_config), ("port", port_config)):
        cfg = conf.cfg_from_yaml_file(str(REPO / "configs/dataset_configs/pandaset_dataset.yaml"),
                                      conf.CfgNode())
        cfg.DATA_PATH = str(tree)
        cfg.SEQUENCES = {"train": ["001"], "val": ["046"], "test": []}
        cfg_file = _yaml(tmp_path / f"{side}.yaml", cfg)
        out = tmp_path / f"out_{side}"
        out.mkdir()
        argv = ["--func", "create_pandaset_infos", "--cfg_file", cfg_file, "--out_dir", str(out)]
        if side == "jax":
            _run_jax_cli(monkeypatch, argv)
        else:
            create_data.main(argv)
        outs[side] = out
    names = sorted(p.name for p in outs["jax"].rglob("*") if p.is_file())
    assert names == sorted(p.name for p in outs["port"].rglob("*") if p.is_file()) and names
    for p in outs["jax"].rglob("*.pkl"):
        assert_same(pickle.load(open(outs["port"] / p.relative_to(outs["jax"]), "rb")),
                    pickle.load(open(p, "rb")), p.name)


def test_waymo_utils_pure_parts_equal():
    """``generate_labels`` (identity and rotated poses) and ``frame_info`` on
    the stub frames of ``tests/test_dataset_adapters.py``; ``drop_unknown``.
    Importing the module imports neither tensorflow nor waymo-open-dataset."""
    frame = _stub_frame()
    c, s = np.cos(0.5), np.sin(0.5)
    rot = np.eye(4, dtype=np.float32)
    rot[:2, :2] = [[c, -s], [s, c]]
    for pose in (np.eye(4, dtype=np.float32), rot):
        assert_same(pwu.generate_labels(frame, pose), jwu.generate_labels(frame, pose))
    assert_same(pwu.frame_info(frame, "seq", 3), jwu.frame_info(frame, "seq", 3))
    assert_same(pwu.frame_info(frame, "seq", 7, has_label=False),
                jwu.frame_info(frame, "seq", 7, has_label=False))
    empty = types.SimpleNamespace(**{**vars(frame), "laser_labels": frame.laser_labels[1:]})
    assert_same(pwu.generate_labels(empty, rot), jwu.generate_labels(empty, rot))
    annos = {"name": np.array(["unknown", "Vehicle"]), "x": np.arange(2), "y": [1, 2, 3]}
    assert_same(pwu.drop_unknown(annos), jwu.drop_unknown(annos))
    probe = ("import sys, com_tpu_torch.data.waymo.waymo_utils; "
             "assert not {'tensorflow', 'waymo_open_dataset'} & set(sys.modules)")
    subprocess.run([sys.executable, "-c", probe], cwd=REPO, check=True)


def test_rehearsal_distribution_report_equal():
    """``sampler_for`` and ``distribution_report`` against ``com_tpu``'s
    rehearsal on the synthetic COM config: the same groups, and at epochs
    0-3 under the same seeded confidences (and none) the same report, the
    probabilities to 1e-12."""
    jcfg, pcfg = configs(SYNTH, "unused")
    jsamp, psamp = jax_rehearsal.sampler_for(jcfg), com_rehearsal.sampler_for(pcfg)
    names = list(pcfg.CLASS_NAMES)
    for c in names:
        assert_same([np.asarray(g) for g in psamp.sample_groups[c]["indices"]],
                    [np.asarray(g) for g in jsamp.sample_groups[c]["indices"]])
    rng = np.random.RandomState(7)
    for epoch, conf in ((0, None), (1, rng.uniform(0, 0.3, (3, 96))),
                        (2, rng.uniform(0, 0.9, (3, 96))), (3, rng.uniform(0, 0.5, (3, 96)))):
        for smp in (jsamp, psamp):
            smp.epoch, smp.confidence_groups = epoch, conf
        got = com_rehearsal.distribution_report(psamp, names)
        want = jax_rehearsal.distribution_report(jsamp, names)
        assert list(got) == list(want) == names
        for c in names:
            np.testing.assert_allclose(got[c]["prob"], want[c]["prob"], rtol=0, atol=1e-12)
            for k in ("num_groups", "top_group"):
                assert got[c][k] == want[c][k]
            for k in ("entropy", "l1_from_size_prior"):
                assert abs(got[c][k] - want[c][k]) <= 1e-12
        if conf is not None:
            assert all(got[c]["l1_from_size_prior"] > 0 for c in names)


def _synthetic_yaml(tmp_path, scenes):
    """The synthetic COM config with ``scenes`` scenes on a 100 x 100 grid
    of 0.8 m pillars (the rest as shipped)."""
    from com_tpu_torch.utils import config as port_config

    cfg = port_config.cfg_from_yaml_file(str(REPO / SYNTH), port_config.CfgNode())
    cfg.DATA_CONFIG.NUM_SCENES = scenes
    (vox,) = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR if p.NAME == "transform_points_to_voxels"]
    vox.VOXEL_SIZE = [0.8, 0.8, 6.0]
    return _yaml(tmp_path / "synth.yaml", cfg)


def test_rehearsal_fails_its_bar_after_one_short_epoch(tmp_path):
    """One epoch of 4 steps through the train CLI (a child process on the
    CPU) moves the sampler too little: the rehearsal raises at its L1 bar
    and writes no report."""
    out = tmp_path / "out"
    with pytest.raises(AssertionError, match="did not shift"):
        com_rehearsal.main(["--device", "cpu", "--epochs", "1", "--cfg",
                            _synthetic_yaml(tmp_path, 8), "--output_dir", str(out)])
    assert len(com_rehearsal.epoch_checkpoints(out)) == 1
    assert not (out / "com_rehearsal.md").exists()


@pytest.mark.slow
def test_rehearsal_passes_on_the_cpu(tmp_path):
    """The port's rehearsal on the CPU over the synthetic COM config (32
    scenes, 16 steps an epoch, 0.8 m pillars) for 5 epochs and the resume:
    every bar met, the report written, the confidences (3, 96)."""
    out = tmp_path / "out"
    result = com_rehearsal.main(["--device", "cpu", "--epochs", "5", "--cfg",
                                 _synthetic_yaml(tmp_path, 32), "--output_dir", str(out)])
    assert result["conf_shape"] == (3, 96) and result["resumed_epoch"] == 6
    assert (out / "com_rehearsal.md").exists() and (out / "com_rehearsal.jsonl").exists()
