"""Write a nuScenes, Lyft or Pandaset tree from a seed, for those datasets'
configs under their own DATA_CONFIG when no scan is at hand (tests, the card
smoke run).

    python -m com_tpu_torch.tools.dataset_trees --kind nuscenes|lyft|pandaset
        --out DIR [--seed 0] [--train N] [--val 8] [--points N]
        [--layout extracted|devkit]

Every tree is a scene around the ego a frame: ground under the sensor, up
to 3 m of clutter above it, and labelled objects of every class of the
dataset's configs, each with points inside its box (and none of the
background's within 0.3 m of it).  A ``.bin`` scan is (N, 5) f32.

* ``nuscenes`` (pcdet's layout under ``DIR/v1.0-trainval``, as
  ``NuScenesDataset`` reads it): ``samples/LIDAR_TOP/*.pcd.bin`` and
  ``sweeps/LIDAR_TOP/*.pcd.bin`` (x y z intensity ring), the key frame and 9
  sweeps 0.05 s apart, each in its own sensor frame (the ego drives on at
  up to 8 m/s and turns) with a ``transform_matrix`` into the key frame and
  ego points within 1 m; moving objects move.  ``--points`` a sweep,
  default 34,000 (the 32-beam sensor's ~34,000 returns), so that a fused
  scene of 10 sweeps passes MAX_POINTS_PER_SCENE 262,144.
  ``nuscenes_infos_10sweeps_{train,val}.pkl`` in ``fill_trainval_infos``'
  schema (9-column ``gt_boxes`` with the velocity, some of it NaN;
  ``num_lidar_pts``, one box a frame seen by radar only), and
  ``gt_database_10sweeps_withvelo/`` with
  ``nuscenes_dbinfos_10sweeps_withvelo.pkl`` (9-column ``box3d_lidar``, the
  points of all 10 sweeps with their time lag) over the train frames.  Frame
  0 holds all ten classes, the others only some, so CBGS has work to do (2
  train frames: 10 items, 2 steps of 4).
* ``lyft`` (under ``DIR``): the same over an 80 m range with the key frame
  and 4 sweeps, 8 train frames (no CBGS in its config: 2 steps of 4), ``--points`` a sweep default 60,000 (5 sweeps pass the
  262,144 cap), 7-column boxes, ``lyft_infos_{train,val}.pkl``,
  ``gt_database/`` and ``lyft_dbinfos_10sweeps.pkl``; the nine Lyft
  classes.
* ``pandaset``: ``--layout extracted`` (the default) writes
  ``extracted/<seq>/<frame>.npy`` ((N, 4) normative x y z intensity in
  [0, 1], default 110,000 points, the Pandar64's ~110,000 a frame) with
  ``pandaset_infos_{train,val}.pkl`` carrying ``gt_boxes`` and the training
  categories as ``gt_names``; ``--layout devkit`` the devkit's pandas frames
  in the world frame, ``poses.json`` and the raw cuboid labels
  (``dataset/<seq>/...``; needs pandas), for ``create_pandaset_infos``.
"""
from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

import numpy as np

from ..data.nuscenes.nuscenes_utils import transform_matrix
from ..ops.host_boxes import enlarge_box3d, points_in_rbbox

# (dx, dy, dz) a class, the configs' anchor sizes
NUSCENES_SIZES = {
    "car": (4.63, 1.97, 1.74), "truck": (6.93, 2.51, 2.84),
    "construction_vehicle": (6.37, 2.85, 3.19), "bus": (10.5, 2.94, 3.47),
    "trailer": (12.29, 2.90, 3.87), "barrier": (0.50, 2.53, 0.98),
    "motorcycle": (2.11, 0.77, 1.47), "bicycle": (1.70, 0.60, 1.28),
    "pedestrian": (0.73, 0.67, 1.77), "traffic_cone": (0.41, 0.41, 1.07)}
LYFT_SIZES = {
    "car": (4.63, 1.97, 1.74), "pedestrian": (0.73, 0.67, 1.77),
    "motorcycle": (2.11, 0.77, 1.47), "bicycle": (1.70, 0.60, 1.28),
    "other_vehicle": (6.37, 2.85, 3.19), "bus": (10.5, 2.94, 3.47),
    "truck": (6.93, 2.51, 2.84), "emergency_vehicle": (12.29, 2.90, 3.87),
    "animal": (0.75, 0.35, 0.50)}
# Pandaset's raw labels and the training category each maps to
# (configs/dataset_configs/pandaset_dataset.yaml TRAINING_CATEGORIES)
PANDASET_LABELS = {
    "Car": ("Car", (4.5, 1.9, 1.6)), "Pickup Truck": ("Car", (5.5, 2.0, 1.9)),
    "Medium-sized Truck": ("Truck", (7.0, 2.5, 3.0)),
    "Semi-truck": ("Truck", (12.0, 2.6, 3.8)),
    "Motorcycle": ("Motorcycle", (2.1, 0.8, 1.5)),
    "Emergency Vehicle": ("Emergency Vehicle", (6.0, 2.4, 2.6)),
    "Bus": ("Bus", (11.0, 2.9, 3.4)),
    "Other Vehicle - Construction Vehicle": ("Other Vehicle", (6.4, 2.8, 3.2)),
    "Pedestrian": ("Pedestrian", (0.7, 0.7, 1.75)),
    "Pedestrian with Object": ("Pedestrian", (0.9, 0.8, 1.75)),
    "Bicycle": ("Bicycle", (1.7, 0.6, 1.3)),
    "Animals - Other": ("Animal", (0.9, 0.4, 0.6))}
MOVERS = {"car", "truck", "bus", "trailer", "construction_vehicle", "motorcycle", "bicycle",
          "pedestrian", "other_vehicle", "emergency_vehicle", "animal"}
GROUND_Z = -1.84  # the roof sensor's height over the road
SWEEP_DT = 0.05  # s between sweeps (a 20 Hz spin)
NUSCENES_VERSION = "v1.0-trainval"


def place_boxes(rng, sizes, count, must, r_max):
    """(count, 7) boxes on the ground around the ego (3 m to ``r_max``), not
    touching in BEV, and their class names: ``must`` first, then drawn from
    ``sizes`` ({name: (dx, dy, dz)}) with weights falling along it."""
    keys = list(sizes)
    w = 1.0 / (1.0 + np.arange(len(keys)))
    rest = [keys[i] for i in rng.choice(len(keys), max(count - len(must), 0), p=w / w.sum())]
    chosen, boxes = list(must) + rest, []
    for name in chosen:
        dims = np.asarray(sizes[name]) * rng.uniform(0.9, 1.1, 3)
        for _ in range(1000):
            r = rng.uniform(3.0 + dims[0] / 2, r_max)
            az = rng.uniform(-np.pi, np.pi)
            x, y = r * np.cos(az), r * np.sin(az)
            if all(np.hypot(x - b[0], y - b[1]) > (dims[0] + b[3]) / 2 + 1.0 for b in boxes):
                break
        boxes.append([x, y, GROUND_Z + dims[2] / 2, *dims, rng.uniform(-np.pi, np.pi)])
    return np.asarray(boxes, np.float64).reshape(-1, 7), np.asarray(chosen)


def box_points(rng, box, count):
    """``count`` points inside a box (a 2 % shell kept clear), xyz."""
    local = rng.uniform(-0.49, 0.49, (count, 3)) * box[3:6]
    c, s = np.cos(box[6]), np.sin(box[6])
    return np.stack([local[:, 0] * c - local[:, 1] * s, local[:, 0] * s + local[:, 1] * c,
                     local[:, 2]], axis=1) + box[:3]


def scene_points(rng, boxes, num_points, r_max, density, shown=None):
    """(num_points, 3) xyz: the points of each box where ``shown`` (8 +
    density / distance), then ground (85 %) and clutter up to 3 m, none
    within 0.3 m of any box."""
    shown = np.ones(len(boxes), bool) if shown is None else shown
    objs = [box_points(rng, b, int(8 + density / max(np.hypot(b[0], b[1]), 1.0)))
            for b in boxes[shown]]
    rest = num_points - sum(len(o) for o in objs)
    if rest < 0:
        raise ValueError(f"the objects take {-rest} points more than the scan's {num_points}")
    draw = int(rest * 1.25) + 64
    az = rng.uniform(-np.pi, np.pi, draw)
    r = 2.0 + (r_max - 2.0) * rng.uniform(0.0, 1.0, draw) ** 2
    z = GROUND_Z + np.where(rng.uniform(size=draw) < 0.85, rng.normal(0.0, 0.03, draw),
                            rng.uniform(0.2, 3.0, draw))
    bg = np.stack([r * np.cos(az), r * np.sin(az), z], axis=1)
    if len(boxes):
        bg = bg[~points_in_rbbox(bg, enlarge_box3d(boxes, (0.6, 0.6, 0.6))).any(axis=1)]
    if len(bg) < rest:
        raise ValueError(f"{len(bg)} background points left of {rest}")
    return np.concatenate(objs + [bg[:rest]])


def _move(xyz, tm):
    return xyz @ tm[:3, :3].T + tm[:3, 3]


def _yaw_q(yaw):
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def _sweeps(rng, boxes, vel, shown, num_sweeps, num_points, r_max, density):
    """The key frame and its sweeps: a list of ((N, 5) f32 scan in the
    sweep's sensor frame, the 4x4 sensor -> key-frame transform, time lag).
    The ego moves ``speed`` m/s along x and turns ``turn`` rad/s; an object
    is where its velocity puts it at the sweep's time (only the ``shown``
    ones get points); 250 returns off the ego's own roof within 1 m."""
    speed, turn = rng.uniform(0.0, 8.0), rng.uniform(-0.3, 0.3)
    out = []
    for j in range(num_sweeps):
        lag = SWEEP_DT * j
        moved = boxes.copy()
        moved[:, 0:2] -= vel * lag
        key_xyz = scene_points(rng, moved, num_points - 250, r_max, density, shown)
        tm = transform_matrix([-speed * lag, 0.0, 0.0], _yaw_q(-turn * lag))
        xyz = _move(key_xyz, np.linalg.inv(tm))
        ego = np.concatenate([rng.uniform(-0.95, 0.95, (250, 2)),
                              rng.uniform(-0.3, 0.1, (250, 1))], axis=1)
        xyz = np.concatenate([xyz, ego])
        scan = np.concatenate([xyz, np.round(rng.uniform(0.0, 255.0, (len(xyz), 1))),
                               rng.randint(0, 32, (len(xyz), 1))], axis=1).astype(np.float32)
        out.append((scan[rng.permutation(len(scan))], tm, lag))
    return out


def _fused(sweeps):
    """All sweeps in the key frame with the time-lag column (N, 5) f32, as
    the dataset fuses them (without the ego-point removal)."""
    parts = []
    for scan, tm, lag in sweeps:
        xyz = _move(scan[:, :3].astype(np.float64), tm) if lag else scan[:, :3]
        parts.append(np.concatenate([xyz, scan[:, 3:4], np.full((len(scan), 1), lag)], axis=1))
    return np.concatenate(parts).astype(np.float32)


def _database(root, db_dir, db, frame, fused, boxes, names):
    """Each box's fused points relative to its centre into ``db_dir``, one
    info a box ({class: [info]}, pcdet's keys)."""
    inside = points_in_rbbox(fused, boxes[:, :7])
    for k, name in enumerate(names):
        pts = fused[inside[:, k]].copy()
        pts[:, :3] -= boxes[k, :3].astype(np.float32)
        rel = f"{db_dir}/{frame}_{name}_{k}.bin"
        pts.tofile(root / rel)
        db.setdefault(str(name), []).append({
            "name": str(name), "path": rel, "image_idx": frame, "gt_idx": k,
            "box3d_lidar": boxes[k].astype(np.float32), "num_points_in_gt": len(pts)})


def _frame_classes(rng, names, frame, always):
    """The classes a frame must hold: every class in frame 0; in the others
    ``always``, the frame's turn of the rest, and each of the rest with
    probability 0.4."""
    rare = [n for n in names if n not in always]
    turn = rare[frame % len(rare)]
    return list(always) + [n for n in rare if frame == 0 or n == turn or rng.uniform() < 0.4]


def _sweep_tree(root, seed, num_train, num_val, num_points, sweeps, names, always, r_max,
                density, velocity, db_dir, db_name, info_name, frame_name):
    """The nuScenes-schema tree both ``write_nuscenes_tree`` and
    ``write_lyft_tree`` write (an object's points a sweep: 8 + ``density``
    / distance); returns {"train": tokens, "val": tokens,
    "db": {class: count}}."""
    root = Path(root)
    for sub in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP", db_dir):
        (root / sub).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    infos, db = [], {}
    for i in range(num_train + num_val):
        token = f"{seed:08x}{i:024x}"
        must = _frame_classes(rng, names, i, always)
        boxes, cls = place_boxes(rng, names, len(must) + rng.randint(8, 17), must, r_max)
        vel = np.where(np.isin(cls, list(MOVERS))[:, None] & (rng.uniform(size=(len(cls), 1))
                                                             < 0.5),
                       rng.uniform(-6.0, 6.0, (len(cls), 2)), 0.0)
        hidden = rng.randint(len(boxes))  # seen by radar only: no lidar point
        shown = np.ones(len(boxes), bool)
        shown[hidden] = False
        scans = _sweeps(rng, boxes, vel, shown, sweeps, num_points, r_max, density)
        ts = 1_533_151_603_000_000 + i * 500_000
        info = {"lidar_path": f"samples/LIDAR_TOP/{frame_name}__LIDAR_TOP__{ts}.pcd.bin",
                "token": token, "sweeps": [], "timestamp": ts * 1e-6,
                "ref_from_car": np.eye(4), "car_from_global": np.eye(4)}
        scans[0][0].tofile(root / info["lidar_path"])
        for j, (scan, tm, lag) in enumerate(scans[1:], 1):
            path = f"sweeps/LIDAR_TOP/{frame_name}__LIDAR_TOP__{ts - j * 50_000}.pcd.bin"
            scan.tofile(root / path)
            info["sweeps"].append({"lidar_path": path, "sample_data_token": f"{token}{j:02d}",
                                   "transform_matrix": tm, "global_from_car": np.eye(4),
                                   "car_from_current": np.eye(4), "time_lag": lag})
        key = scans[0][0]
        lidar_pts = points_in_rbbox(key[:, :3], boxes).sum(0)
        info["gt_names"] = cls
        info["gt_boxes_token"] = np.array([f"{token}b{k:03d}" for k in range(len(cls))])
        info["num_lidar_pts"] = lidar_pts.astype(np.int64)
        info["num_radar_pts"] = np.where(shown, rng.randint(0, 4, len(cls)), 2).astype(np.int64)
        if velocity:
            v = vel.copy()
            v[rng.uniform(size=len(v)) < 0.05] = np.nan  # no neighbouring annotation
            info["gt_boxes"] = np.concatenate([boxes, v], axis=1)
            info["gt_boxes_velocity"] = np.concatenate([v, np.zeros((len(v), 1))], axis=1)
        else:
            info["gt_boxes"] = boxes
        infos.append(info)
        if i < num_train:
            _database(root, db_dir, db, i, _fused(scans), info["gt_boxes"][shown],
                      cls[shown])
    for split, part in (("train", infos[:num_train]), ("val", infos[num_train:])):
        with open(root / info_name.format(split), "wb") as f:
            pickle.dump(part, f)
    with open(root / db_name, "wb") as f:
        pickle.dump(db, f)
    return {"train": [x["token"] for x in infos[:num_train]],
            "val": [x["token"] for x in infos[num_train:]],
            "db": {c: len(v) for c, v in db.items()}}


def write_nuscenes_tree(root, seed=0, num_train=2, num_val=8, num_points=34000, sweeps=10):
    """The nuScenes tree under ``root / NUSCENES_VERSION`` (the module's
    docstring)."""
    return _sweep_tree(Path(root) / NUSCENES_VERSION, seed, num_train, num_val, num_points,
                       sweeps, NUSCENES_SIZES, ("car", "pedestrian", "barrier", "traffic_cone"),
                       48.0, 1500.0 / 34000 * num_points, True, "gt_database_10sweeps_withvelo",
                       "nuscenes_dbinfos_10sweeps_withvelo.pkl",
                       "nuscenes_infos_10sweeps_{}.pkl", "n015-2018-07-24-11-22-45+0800")


def write_lyft_tree(root, seed=0, num_train=8, num_val=8, num_points=60000, sweeps=5):
    """The Lyft tree under ``root`` (the module's docstring)."""
    return _sweep_tree(Path(root), seed, num_train, num_val, num_points, sweeps, LYFT_SIZES,
                       ("car", "pedestrian", "truck"), 75.0, 2500.0 / 60000 * num_points, False, "gt_database",
                       "lyft_dbinfos_10sweeps.pkl", "lyft_infos_{}.pkl", "host-a004")


def _pandaset_frames(rng, count, num_points):
    """(points (N, 4) normative f32, boxes (M, 7), raw labels) a frame over
    Pandaset's range (70 m ahead and behind, 40 m aside)."""
    out = []
    for i in range(count):
        labels = list(PANDASET_LABELS)
        must = [labels[i % len(labels)], "Car", "Pedestrian"]
        boxes, raw = place_boxes(rng, {k: v[1] for k, v in PANDASET_LABELS.items()},
                                 len(must) + rng.randint(15, 31), must, 38.0)
        xyz = scene_points(rng, boxes, num_points, 68.0, 3000.0 / 110000 * num_points)
        pts = np.concatenate([xyz, rng.uniform(0.0, 1.0, (len(xyz), 1))], axis=1)
        out.append((pts[rng.permutation(len(pts))].astype(np.float32), boxes, raw))
    return out


def write_pandaset_tree(root, seed=0, num_train=2, num_val=8, num_points=110000,
                        layout="extracted", sequences=("001", "046")):
    """The Pandaset tree under ``root`` (the module's docstring); the train
    frames are sequence ``sequences[0]``'s, the val frames ``[1]``'s.
    Returns {"train": frame ids, "val": frame ids}."""
    root = Path(root)
    rng = np.random.RandomState(seed)
    frames = _pandaset_frames(rng, num_train + num_val, num_points)
    splits = {"train": (sequences[0], frames[:num_train]), "val": (sequences[1],
                                                                   frames[num_train:])}
    if layout == "devkit":
        return _pandaset_devkit(root, rng, splits)
    out = {}
    for split, (seq, part) in splits.items():
        (root / "extracted" / seq).mkdir(parents=True, exist_ok=True)
        infos = []
        for fi, (pts, boxes, raw) in enumerate(part):
            path = f"extracted/{seq}/{fi:02d}.npy"
            np.save(root / path, pts)
            infos.append({"frame_id": f"{seq}_{fi:02d}", "sequence": seq, "frame_idx": fi,
                          "lidar_path": path, "gt_boxes": boxes.astype(np.float32),
                          "gt_names": np.array([PANDASET_LABELS[r][0] for r in raw])})
        with open(root / f"pandaset_infos_{split}.pkl", "wb") as f:
            pickle.dump(infos, f)
        out[split] = [x["frame_id"] for x in infos]
    return out


def _pandaset_devkit(root, rng, splits):
    """The devkit layout of ``splits``' frames: each frame's normative points
    and boxes carried to the world frame by a seeded pose (the inverse of
    ``pandaset_utils``' chain), written as the devkit's pandas frames (both
    lidars, ``d`` 0 and 1) and cuboids with raw labels and sensor ids."""
    import pandas as pd

    from ..data.pandaset import pandaset_utils as pu

    out = {}
    for split, (seq, part) in splits.items():
        seq_dir = root / "dataset" / seq
        (seq_dir / "lidar").mkdir(parents=True, exist_ok=True)
        (seq_dir / "annotations" / "cuboids").mkdir(parents=True, exist_ok=True)
        poses = []
        for fi, (pts, boxes, raw) in enumerate(part):
            yaw, tilt = rng.uniform(-np.pi, np.pi), rng.normal(0.0, 0.01, 2)
            q = np.array([np.cos(yaw / 2), tilt[0], tilt[1], np.sin(yaw / 2)])
            q /= np.linalg.norm(q)
            pose = {"position": dict(zip("xyz", (float(v) for v in rng.uniform(-200, 200, 3)))),
                    "heading": dict(zip("wxyz", (float(v) for v in q)))}
            poses.append(pose)
            ego = np.stack([-pts[:, 1], pts[:, 0], pts[:, 2]], axis=1).astype(np.float64)
            world = pu.ego_to_world(ego, pose)
            n = len(world)
            pd.DataFrame({"x": world[:, 0], "y": world[:, 1], "z": world[:, 2],
                          "i": np.round(pts[:, 3].astype(np.float64) * 255.0),
                          "t": 1557539924.0 + 0.1 * fi + rng.uniform(0, 0.1, n),
                          "d": (rng.uniform(size=n) < 0.15).astype(np.int64)}).to_pickle(
                seq_dir / "lidar" / f"{fi:02d}.pkl.gz")
            fields = pu.normative_boxes_to_world(boxes, pose, pu.zrot_world_to_ego(pose))
            fields.update(uuid=[f"{seq}-{fi}-{k}" for k in range(len(raw))], label=raw,
                          **{"cuboids.sensor_id": rng.choice([-1, -1, -1, 0, 1], len(raw))})
            pd.DataFrame(fields).to_pickle(seq_dir / "annotations" / "cuboids" /
                                           f"{fi:02d}.pkl.gz")
        with open(seq_dir / "lidar" / "poses.json", "w") as f:
            json.dump(poses, f)
        out[split] = [f"{seq}_{fi:02d}" for fi in range(len(part))]
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kind", required=True, choices=("nuscenes", "lyft", "pandaset"))
    parser.add_argument("--out", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--train", type=int, default=None,
                        help="train frames (default 2 nuScenes: 10 CBGS items; 8 Lyft, 2 Pandaset)")
    parser.add_argument("--val", type=int, default=None, help="val frames (default 8)")
    parser.add_argument("--points", type=int, default=None,
                        help="points a sweep (a frame for pandaset)")
    parser.add_argument("--layout", default="extracted", choices=("extracted", "devkit"))
    args = parser.parse_args(argv)
    kw = {k: v for k, v in (("num_points", args.points), ("num_train", args.train),
                            ("num_val", args.val)) if v is not None}
    if args.kind == "nuscenes":
        out = write_nuscenes_tree(args.out, args.seed, **kw)
    elif args.kind == "lyft":
        out = write_lyft_tree(args.out, args.seed, **kw)
    else:
        out = write_pandaset_tree(args.out, args.seed, layout=args.layout, **kw)
    print(out)
    return out


if __name__ == "__main__":
    main()
