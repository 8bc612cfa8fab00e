"""Pandaset (Hesai) geometry and info creation without the devkit (the
port's copy of ``com_tpu/data/pandaset/pandaset_utils.py``; pcdet
datasets/pandaset/pandaset_dataset.py:20-49 pose <-> numpy, :149-254 the
world -> ego -> normative conversion, :358-436 the infos and GT database,
:441-466 ``create_pandaset_infos``), host numpy.

Layout read (the pandaset devkit's ``DataSet``):
    dataset/<seq>/lidar/{00..NN}.pkl.gz        pandas frame: x y z i t d
    dataset/<seq>/lidar/poses.json             list of {position, heading}
    dataset/<seq>/annotations/cuboids/NN.pkl.gz  position.*, dimensions.*,
                                                 yaw, label, cuboids.sensor_id
pandas is imported only where such a frame is read (``_read_df``).

Coordinate chain: world --(the inverse lidar pose: R(q)^T (p - t))-->
pandaset ego [x right, y forward, z up] --(swap x/y, negate the new y)-->
normative [x forward, y left, z up]; yaw_ego = yaw_world + zrot_world_to_ego,
zrot the z rotation of the ego frame's y axis under the pose.
"""
from __future__ import annotations

import json
import os
import pickle
from pathlib import Path

import numpy as np

from ..nuscenes.nuscenes_utils import quat_rotmat

SPLITS = ("train", "val", "test")


# ---------------------------------------------------------------- pose utils
def pose_dict_to_numpy(pose):
    """{position,heading} dict -> [x y z qw qx qy qz] (ref :20-32)."""
    return np.array([
        pose["position"]["x"], pose["position"]["y"], pose["position"]["z"],
        pose["heading"]["w"], pose["heading"]["x"], pose["heading"]["y"],
        pose["heading"]["z"],
    ], dtype=np.float64)


def pose_numpy_to_dict(pose):
    """[x y z qw qx qy qz] -> {position,heading} dict (ref :35-48)."""
    return {
        "position": {"x": float(pose[0]), "y": float(pose[1]),
                     "z": float(pose[2])},
        "heading": {"w": float(pose[3]), "x": float(pose[4]),
                    "y": float(pose[5]), "z": float(pose[6])},
    }


def _pose_rt(pose):
    """Pose dict -> (R, t): the 3x3 rotation + translation of ego->world."""
    q = pose["heading"]
    R = quat_rotmat(np.array([q["w"], q["x"], q["y"], q["z"]]))
    p = pose["position"]
    t = np.array([p["x"], p["y"], p["z"]], dtype=np.float64)
    return R, t


def world_to_ego(points, pose):
    """Devkit geometry.lidar_points_to_ego: ego = R^T (p - t)."""
    R, t = _pose_rt(pose)
    return (np.asarray(points, np.float64) - t) @ R


def ego_to_world(points, pose):
    """Devkit geometry.ego_to_lidar_points: world = R p + t."""
    R, t = _pose_rt(pose)
    return np.asarray(points, np.float64) @ R.T + t


def zrot_world_to_ego(pose):
    """Z-rotation (rad) taking world yaw to ego yaw (ref :223-231):
    the ego y axis mapped through the inverse pose, measured against +y."""
    yaxis = world_to_ego(np.array([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]]), pose)
    v = yaxis[1] - yaxis[0]
    return float(np.arctan2(-v[0], v[1]))


# ---------------------------------------------------------- frame readers
def load_poses(seq_dir):
    """lidar/poses.json -> list of pose dicts (devkit Lidar._load_poses)."""
    with open(Path(seq_dir) / "lidar" / "poses.json") as f:
        return json.load(f)


def _read_df(path):
    import pandas as pd

    return pd.read_pickle(path)


def read_frame_points(lidar_path, pose, device=0):
    """Frame pickle -> normative-frame (N, 4) float32 [x y z intensity01].

    Matches ref _get_lidar_points (:149-184): keep rows of the requested
    lidar device (column ``d``; -1 = both), intensity / 255, world -> ego
    via the inverse pose, then the axis swap into normative coordinates.
    """
    df = _read_df(lidar_path)
    if device != -1 and "d" in df.columns:
        df = df[df["d"] == device]
    arr = df.to_numpy()
    del df
    xyz_world = arr[:, :3].astype(np.float64)
    inten = arr[:, 3].astype(np.float64) / 255.0
    ego = world_to_ego(xyz_world, pose)
    ego = ego[:, [1, 0, 2]]  # swap x/y
    ego[:, 1] = -ego[:, 1]  # flip y: right-handed x-fwd / y-left
    return np.concatenate(
        [ego, inten[:, None]], axis=1).astype(np.float32)


def read_frame_cuboids(cuboids_path, pose, training_categories=None,
                       device=0):
    """Cuboid pickle -> (boxes (M,7) normative, names (M,), zrot).

    Matches ref _get_annotations (:187-254): drop cuboids exclusive to the
    other sensor, map labels through TRAINING_CATEGORIES, move centers
    through the inverse pose, yaw_ego = yaw_world + zrot, and swap dims
    (dx<->dy) with the axis swap.  The small-pitch approximation is the
    reference's own (its :225-231 warning).
    """
    df = _read_df(cuboids_path)
    if device != -1 and "cuboids.sensor_id" in df.columns:
        df = df[df["cuboids.sensor_id"] != 1 - device]
    centers = np.stack([df["position.x"].to_numpy(),
                        df["position.y"].to_numpy(),
                        df["position.z"].to_numpy()], axis=1)
    dims = np.stack([df["dimensions.x"].to_numpy(),
                     df["dimensions.y"].to_numpy(),
                     df["dimensions.z"].to_numpy()], axis=1)
    yaws = df["yaw"].to_numpy().astype(np.float64)
    labels = df["label"].to_numpy()
    del df
    if training_categories:
        labels = np.array([training_categories.get(str(l), str(l))
                           for l in labels])
    else:
        labels = np.array([str(l) for l in labels])

    zrot = zrot_world_to_ego(pose)
    ego_c = world_to_ego(centers, pose)
    boxes = np.stack([
        ego_c[:, 1], -ego_c[:, 0], ego_c[:, 2],  # normative x, y, z
        dims[:, 1], dims[:, 0], dims[:, 2],  # dx<->dy with the axis swap
        yaws + zrot,
    ], axis=1).astype(np.float32)
    return boxes, labels, zrot


def normative_boxes_to_world(boxes, pose, zrot):
    """Prediction path (ref generate_prediction_dicts :259-321): normative
    boxes back to world-frame cuboid fields."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    ego = np.stack([-boxes[:, 1], boxes[:, 0], boxes[:, 2]], axis=1)
    world_c = ego_to_world(ego, pose)
    return {
        "position.x": world_c[:, 0], "position.y": world_c[:, 1],
        "position.z": world_c[:, 2],
        # dims swap back: normative (dx, dy) came from world (dy, dx)
        "dimensions.x": boxes[:, 4], "dimensions.y": boxes[:, 3],
        "dimensions.z": boxes[:, 5],
        "yaw": (boxes[:, 6] - zrot) % (2 * np.pi),
    }


# --------------------------------------------------------------- info build
def get_sequence_infos(root_path, seq):
    """Enumerate one sequence's frames (ref get_infos :358-384): paths only,
    capped at 100 frames exactly as the reference asserts."""
    root = Path(root_path)
    lidar_dir = root / "dataset" / seq / "lidar"
    frames = sorted(p for p in lidar_dir.iterdir()
                    if p.name[0].isdigit() and ".pkl" in p.suffixes[0] or
                    p.suffixes[:1] == [".pkl"])
    frames = [p for p in frames if not p.name.startswith("poses")]
    if len(frames) > 100:
        raise ValueError(
            f"sequence {seq} has {len(frames)} frames; the pandaset layout "
            "assumes <= 100 per sequence (2-digit frame ids)")
    return [{
        "sequence": seq,
        "frame_idx": ii,
        "lidar_path": os.path.join("dataset", seq, "lidar", frame.name),
        "cuboids_path": os.path.join("dataset", seq, "annotations",
                                     "cuboids", frame.name),
    } for ii, frame in enumerate(frames)]


def create_pandaset_infos(dataset_cfg, class_names, data_path, save_path,
                          with_gt_database=True):
    """Build pandaset_infos_{train,val,test}.pkl + the train GT database
    (ref create_pandaset_infos :441-466 + create_groundtruth_database
    :387-436)."""
    data_path, save_path = Path(data_path), Path(save_path)
    seq_splits = dataset_cfg.get("SEQUENCES", {})
    for split in SPLITS:
        seqs = seq_splits.get(split, [])
        infos = []
        skipped = []
        for seq in seqs:
            if not (data_path / "dataset" / seq / "lidar").is_dir():
                skipped.append(seq)
                continue
            infos.extend(get_sequence_infos(data_path, seq))
        if skipped:
            print(f"pandaset {split}: skipping {len(skipped)} sequence(s) "
                  f"not on disk: {skipped[:5]}{'...' if len(skipped) > 5 else ''}")
        out = save_path / f"pandaset_infos_{split}.pkl"
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"pandaset {split}: {len(infos)} frames -> {out}")
    if with_gt_database:
        create_groundtruth_database(
            dataset_cfg, data_path,
            save_path / "pandaset_infos_train.pkl", split="train")


def create_groundtruth_database(dataset_cfg, root_path, info_path,
                                split="train"):
    """Crop per-object point clouds into gt_database/*.bin + a db-info pkl
    (ref :387-436; points in a box by the host's rotated-box test)."""
    from ...ops.host_boxes import points_in_rbbox

    root = Path(root_path)
    db_dir = root / ("gt_database" if split == "train"
                     else f"gt_database_{split}")
    db_dir.mkdir(parents=True, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)

    device = dataset_cfg.get("LIDAR_DEVICE", 0)
    cats = dataset_cfg.get("TRAINING_CATEGORIES", {})
    all_db_infos = {}
    pose_cache = {}
    for info in infos:
        seq = info["sequence"]
        if seq not in pose_cache:
            pose_cache[seq] = load_poses(root / "dataset" / seq)
        pose = pose_cache[seq][info["frame_idx"]]
        points = read_frame_points(root / info["lidar_path"], pose, device)
        boxes, names, _ = read_frame_cuboids(
            root / info["cuboids_path"], pose, cats, device)
        if len(boxes) == 0:
            continue
        inside = points_in_rbbox(points[:, :3], boxes)  # (N, M)
        for i in range(len(boxes)):
            tmp = str(names[i]).replace("/", "").replace(" ", "")
            filename = f"{info['frame_idx']}_{tmp}_{i}.bin"
            gt_points = points[inside[:, i]]
            gt_points = gt_points.copy()
            gt_points[:, :3] -= boxes[i, :3]
            gt_points.astype(np.float32).tofile(db_dir / filename)
            db_info = {
                "name": str(names[i]),
                "path": os.path.join(db_dir.name, filename),
                "gt_idx": i, "box3d_lidar": boxes[i],
                "num_points_in_gt": int(len(gt_points)),
                "difficulty": -1,
            }
            all_db_infos.setdefault(str(names[i]), []).append(db_info)
    out = root / f"pandaset_dbinfos_{split}.pkl"
    with open(out, "wb") as f:
        pickle.dump(all_db_infos, f)
    print("pandaset gt database:",
          {k: len(v) for k, v in all_db_infos.items()})
    return all_db_infos
