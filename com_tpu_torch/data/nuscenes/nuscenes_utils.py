"""nuScenes info creation and result serialization (the port's copy of
``com_tpu/data/nuscenes/nuscenes_utils.py``; pcdet
datasets/nuscenes/nuscenes_utils.py role), host numpy.

The quaternion and box maths and the result dicts need no devkit;
``fill_trainval_infos`` reads through any object with the devkit's
``NuScenes`` interface, and ``create_nuscenes_info`` imports the devkit
(``nuscenes-devkit``) inside itself, raising ImportError without it.
"""
from __future__ import annotations

import numpy as np


def boxes_lidar_to_nusc(boxes, scores, labels, class_names):
    """(N, 7+) lidar boxes -> list of nusc-style dicts (rotation as yaw)."""
    out = []
    for i in range(len(boxes)):
        b = boxes[i]
        vel = [float(b[7]), float(b[8]), 0.0] if len(b) > 8 else [0.0, 0.0, 0.0]
        out.append({
            "translation": [float(b[0]), float(b[1]), float(b[2])],
            "size": [float(b[4]), float(b[3]), float(b[5])],  # wlh
            "yaw": float(b[6]),
            "velocity": vel[:2],
            "detection_name": class_names[int(labels[i]) - 1],
            "detection_score": float(scores[i]),
        })
    return out


def transform_det_annos_to_nusc_annos(det_annos, nusc=None):
    """Assemble the results dict the nuScenes eval consumes
    (nuscenes_utils.transform_det_annos_to_nusc_annos role).  Sample-token
    keyed; global-frame conversion needs the devkit's ego poses (only applied
    when ``nusc`` is given)."""
    results = {}
    for anno in det_annos:
        token = anno.get("metadata", {}).get("token", anno.get("frame_id"))
        boxes = np.asarray(anno["boxes_lidar"])
        names = anno["name"]
        entries = []
        for i in range(len(boxes)):
            b = boxes[i]
            entries.append({
                "sample_token": token,
                "translation": [float(b[0]), float(b[1]), float(b[2])],
                "size": [float(b[4]), float(b[3]), float(b[5])],
                "velocity": [float(b[7]), float(b[8])] if len(b) > 8 else [0.0, 0.0],
                "detection_name": str(names[i]),
                "detection_score": float(anno["score"][i]),
                "attribute_name": "",
            })
        results[token] = entries
    return results


# general category -> detection class (reference nuscenes_utils.py:16-42,
# kept verbatim: these strings are the nuScenes taxonomy, not code)
MAP_NAME_FROM_GENERAL_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}


# ---- pure-numpy quaternion algebra (replaces the devkit's pyquaternion use
# so the extraction math is unit-testable without any nuScenes install) ----

def quat_rotmat(q):
    """(w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_inv(q):
    q = np.asarray(q, np.float64)
    return q * np.array([1.0, -1.0, -1.0, -1.0]) / (q @ q)


def quaternion_yaw(q):
    """Yaw of a lidar/global-frame box quaternion
    (reference nuscenes_utils.quaternion_yaw:235-250: project the rotated
    x-axis into the xy plane)."""
    v = quat_rotmat(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def transform_matrix(translation, rotation_q, inverse=False):
    """Homogeneous transform from translation + (w,x,y,z) quaternion
    (devkit geometry_utils.transform_matrix role)."""
    tm = np.eye(4)
    R = quat_rotmat(rotation_q)
    t = np.asarray(translation, np.float64)
    if inverse:
        tm[:3, :3] = R.T
        tm[:3, 3] = -(R.T @ t)
    else:
        tm[:3, :3] = R
        tm[:3, 3] = t
    return tm


def _quat_elements(orientation):
    """Accept a pyquaternion Quaternion or a raw (w, x, y, z) sequence."""
    if hasattr(orientation, "elements"):
        return np.asarray(orientation.elements, np.float64)
    return np.asarray(orientation, np.float64)


def get_available_scenes(nusc):
    """Scenes whose first lidar frame exists on disk
    (reference nuscenes_utils.get_available_scenes:157-182)."""
    from pathlib import Path

    available = []
    for scene in nusc.scene:
        sample_rec = nusc.get("sample", scene["first_sample_token"])
        sd_rec = nusc.get("sample_data", sample_rec["data"]["LIDAR_TOP"])
        lidar_path = nusc.get_sample_data_path(sd_rec["token"])
        if Path(lidar_path).exists():
            available.append(scene)
    return available


def get_sample_data(nusc, sample_data_token):
    """Data path + annotations in the sensor frame
    (reference nuscenes_utils.get_sample_data:185-232, re-derived with numpy
    quaternion algebra instead of devkit Box method chains).

    Returns (data_path, boxes) with each box a dict:
    center (3,), wlh (3,), q (4, sensor-frame wxyz), velocity (3, sensor
    frame), name, token.
    """
    sd_record = nusc.get("sample_data", sample_data_token)
    cs_record = nusc.get("calibrated_sensor", sd_record["calibrated_sensor_token"])
    pose_record = nusc.get("ego_pose", sd_record["ego_pose_token"])
    data_path = nusc.get_sample_data_path(sample_data_token)

    t_pose = np.asarray(pose_record["translation"], np.float64)
    q_pose_inv = quat_inv(_quat_elements(pose_record["rotation"]))
    R_pose_inv = quat_rotmat(_quat_elements(pose_record["rotation"])).T
    t_cs = np.asarray(cs_record["translation"], np.float64)
    q_cs_inv = quat_inv(_quat_elements(cs_record["rotation"]))
    R_cs_inv = quat_rotmat(_quat_elements(cs_record["rotation"])).T

    out = []
    for box in nusc.get_boxes(sample_data_token):
        vel = np.asarray(nusc.box_velocity(box.token), np.float64)
        center = np.asarray(box.center, np.float64)
        q = _quat_elements(box.orientation)
        # global -> ego -> sensor (translate then rotate, like Box.translate
        # / Box.rotate)
        center = R_pose_inv @ (center - t_pose)
        center = R_cs_inv @ (center - t_cs)
        q = quat_mul(q_cs_inv, quat_mul(q_pose_inv, q))
        vel = R_cs_inv @ (R_pose_inv @ vel)
        out.append({
            "center": center,
            "wlh": np.asarray(box.wlh, np.float64),
            "q": q,
            "velocity": vel,
            "name": box.name,
            "token": box.token,
        })
    return data_path, out


def fill_trainval_infos(data_path, nusc, train_scenes, val_scenes,
                        test=False, max_sweeps=10):
    """Per-sample info dicts with the multi-sweep transform chain
    (reference nuscenes_utils.fill_trainval_infos:250-384; identical schema:
    lidar_path, sweeps with transform_matrix/time_lag, ref_from_car,
    car_from_global, gt_boxes (locs+dims[l,w,h order swap]+yaw+vel_xy),
    num_lidar/radar_pts, and the >0-points filter)."""
    from pathlib import Path

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        ref_sd_token = sample["data"]["LIDAR_TOP"]
        ref_sd_rec = nusc.get("sample_data", ref_sd_token)
        ref_cs_rec = nusc.get(
            "calibrated_sensor", ref_sd_rec["calibrated_sensor_token"])
        ref_pose_rec = nusc.get("ego_pose", ref_sd_rec["ego_pose_token"])
        ref_time = 1e-6 * ref_sd_rec["timestamp"]
        ref_lidar_path, ref_boxes = get_sample_data(nusc, ref_sd_token)

        ref_from_car = transform_matrix(
            ref_cs_rec["translation"],
            _quat_elements(ref_cs_rec["rotation"]), inverse=True)
        car_from_global = transform_matrix(
            ref_pose_rec["translation"],
            _quat_elements(ref_pose_rec["rotation"]), inverse=True)

        info = {
            "lidar_path": str(Path(ref_lidar_path).relative_to(data_path)),
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }
        # camera record is optional (lidar-only minis lack CAM_FRONT)
        if "CAM_FRONT" in sample["data"]:
            cam_token = sample["data"]["CAM_FRONT"]
            cam_sd = nusc.get("sample_data", cam_token)
            cam_cs = nusc.get(
                "calibrated_sensor", cam_sd["calibrated_sensor_token"])
            info["cam_front_path"] = str(
                Path(nusc.get_sample_data_path(cam_token)).relative_to(data_path))
            info["cam_intrinsic"] = np.asarray(
                cam_cs.get("camera_intrinsic", np.eye(3)), np.float64)

        curr_sd_rec = ref_sd_rec
        sweeps = []
        while len(sweeps) < max_sweeps - 1:
            if curr_sd_rec["prev"] == "":
                if len(sweeps) == 0:
                    sweeps.append({
                        "lidar_path": info["lidar_path"],
                        "sample_data_token": curr_sd_rec["token"],
                        "transform_matrix": None,
                        "time_lag": 0.0,
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr_sd_rec = nusc.get("sample_data", curr_sd_rec["prev"])
                cur_pose = nusc.get("ego_pose", curr_sd_rec["ego_pose_token"])
                global_from_car = transform_matrix(
                    cur_pose["translation"],
                    _quat_elements(cur_pose["rotation"]), inverse=False)
                cur_cs = nusc.get(
                    "calibrated_sensor", curr_sd_rec["calibrated_sensor_token"])
                car_from_current = transform_matrix(
                    cur_cs["translation"],
                    _quat_elements(cur_cs["rotation"]), inverse=False)
                tm = (ref_from_car @ car_from_global
                      @ global_from_car @ car_from_current)
                sweeps.append({
                    "lidar_path": str(Path(
                        nusc.get_sample_data_path(curr_sd_rec["token"])
                    ).relative_to(data_path)),
                    "sample_data_token": curr_sd_rec["token"],
                    "transform_matrix": tm,
                    "global_from_car": global_from_car,
                    "car_from_current": car_from_current,
                    "time_lag": ref_time - 1e-6 * curr_sd_rec["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            annotations = [nusc.get("sample_annotation", t)
                           for t in sample["anns"]]
            num_lidar_pts = np.array(
                [a["num_lidar_pts"] for a in annotations], np.int64)
            num_radar_pts = np.array(
                [a["num_radar_pts"] for a in annotations], np.int64)
            # the points filter gives 0.5-1 mAP (reference :355-357)
            mask = (num_lidar_pts + num_radar_pts) > 0

            locs = np.array([b["center"] for b in ref_boxes]).reshape(-1, 3)
            # wlh -> (l, w, h) == (dx, dy, dz)
            dims = np.array([b["wlh"] for b in ref_boxes]
                            ).reshape(-1, 3)[:, [1, 0, 2]]
            velocity = np.array([b["velocity"] for b in ref_boxes]
                                ).reshape(-1, 3)
            rots = np.array([quaternion_yaw(b["q"]) for b in ref_boxes]
                            ).reshape(-1, 1)
            names = np.array([b["name"] for b in ref_boxes])
            tokens = np.array([b["token"] for b in ref_boxes])
            gt_boxes = np.concatenate(
                [locs, dims, rots, velocity[:, :2]], axis=1)
            assert len(annotations) == len(gt_boxes)

            info["gt_boxes"] = gt_boxes[mask]
            info["gt_boxes_velocity"] = velocity[mask]
            info["gt_names"] = np.array([
                MAP_NAME_FROM_GENERAL_TO_DETECTION.get(n, n) for n in names
            ])[mask]
            info["gt_boxes_token"] = tokens[mask]
            info["num_lidar_pts"] = num_lidar_pts[mask]
            info["num_radar_pts"] = num_radar_pts[mask]

        if sample["scene_token"] in train_scenes:
            train_infos.append(info)
        else:
            val_infos.append(info)
    return train_infos, val_infos


def create_nuscenes_info(version, data_path, save_path, max_sweeps=10):
    """Build info pkls from a raw nuScenes installation (requires
    nuscenes-devkit; reference nuscenes_dataset.py:254-298)."""
    import pickle
    from pathlib import Path

    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils import splits
    except ImportError as e:
        raise ImportError(
            "create_nuscenes_info requires the nuscenes-devkit "
            "(pip install nuscenes-devkit)"
        ) from e

    data_path = Path(data_path) / version
    save_path = Path(save_path) / version
    assert version in ["v1.0-trainval", "v1.0-test", "v1.0-mini"]
    split_map = {
        "v1.0-trainval": (splits.train, splits.val),
        "v1.0-test": (splits.test, []),
        "v1.0-mini": (splits.mini_train, splits.mini_val),
    }
    train_names, val_names = split_map[version]

    nusc = NuScenes(version=version, dataroot=str(data_path), verbose=True)
    available = get_available_scenes(nusc)
    names = [s["name"] for s in available]
    train_scenes = {available[names.index(s)]["token"]
                    for s in train_names if s in names}
    val_scenes = {available[names.index(s)]["token"]
                  for s in val_names if s in names}

    train_infos, val_infos = fill_trainval_infos(
        data_path=data_path, nusc=nusc, train_scenes=train_scenes,
        val_scenes=val_scenes, test="test" in version, max_sweeps=max_sweeps)

    save_path.mkdir(parents=True, exist_ok=True)
    if version == "v1.0-test":
        with open(save_path / f"nuscenes_infos_{max_sweeps}sweeps_test.pkl",
                  "wb") as f:
            pickle.dump(train_infos, f)
    else:
        with open(save_path / f"nuscenes_infos_{max_sweeps}sweeps_train.pkl",
                  "wb") as f:
            pickle.dump(train_infos, f)
        with open(save_path / f"nuscenes_infos_{max_sweeps}sweeps_val.pkl",
                  "wb") as f:
            pickle.dump(val_infos, f)
    return train_infos, val_infos
