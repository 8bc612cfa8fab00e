"""Waymo tfrecord conversion (the port's copy of
``com_tpu/data/waymo/waymo_utils.py``; pcdet waymo_utils.py:23-266).

Turns raw Waymo Open Dataset tfrecords into the per-sequence info pickles
and per-frame ``%04d.npy`` point files that ``WaymoDataset`` reads.
TensorFlow and waymo-open-dataset are imported inside the functions that
need them (``convert_range_image_to_point_cloud``, ``save_lidar_points``,
``process_single_sequence``), so the module imports without them;
``drop_unknown``, ``generate_labels`` and ``frame_info`` read only a frame
proto's attributes and numpy, and run on any object with that interface.

Info schema (the reference's, so data it prepared loads here):
  point_cloud {num_features, lidar_sequence, sample_idx}, frame_id,
  metadata {context_name, timestamp_micros}, image {image_shape_i}, pose,
  annos {name, difficulty, dimensions, location, heading_angles, obj_ids,
  tracking_difficulty, num_points_in_gt, speed_global, accel_global,
  gt_boxes_lidar (9: xyz lwh heading vx vy)}, num_points_of_each_lidar.
"""
from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np

WAYMO_CLASSES = ["unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist"]


def drop_unknown(annos):
    keep = annos["name"] != "unknown"
    return {k: (np.asarray(v)[keep] if len(np.asarray(v)) == len(keep) else v)
            for k, v in annos.items()}


def generate_labels(frame, pose):
    """Frame labels -> anno dict with sensor-frame velocities
    (waymo_utils.py:23-70)."""
    names, difficulty, dims, locs, headings = [], [], [], [], []
    track_diff, speeds, accels, obj_ids, npts = [], [], [], [], []
    for lab in frame.laser_labels:
        box = lab.box
        names.append(WAYMO_CLASSES[lab.type])
        difficulty.append(lab.detection_difficulty_level)
        track_diff.append(lab.tracking_difficulty_level)
        dims.append([box.length, box.width, box.height])
        locs.append([box.center_x, box.center_y, box.center_z])
        headings.append(box.heading)
        obj_ids.append(lab.id)
        npts.append(lab.num_lidar_points_in_box)
        speeds.append([lab.metadata.speed_x, lab.metadata.speed_y])
        accels.append([lab.metadata.accel_x, lab.metadata.accel_y])

    annos = {
        "name": np.asarray(names),
        "difficulty": np.asarray(difficulty),
        "dimensions": np.asarray(dims).reshape(-1, 3),
        "location": np.asarray(locs).reshape(-1, 3),
        "heading_angles": np.asarray(headings),
        "obj_ids": np.asarray(obj_ids),
        "tracking_difficulty": np.asarray(track_diff),
        "num_points_in_gt": np.asarray(npts),
        "speed_global": np.asarray(speeds).reshape(-1, 2),
        "accel_global": np.asarray(accels).reshape(-1, 2),
    }
    annos = drop_unknown(annos)
    if len(annos["name"]):
        # global-frame speed -> sensor frame (waymo_utils.py:58-61)
        gspeed = np.pad(annos["speed_global"], ((0, 0), (0, 1)))
        speed = gspeed @ np.linalg.inv(pose[:3, :3].T)
        annos["gt_boxes_lidar"] = np.concatenate(
            [annos["location"], annos["dimensions"],
             annos["heading_angles"][:, None], speed[:, :2]], axis=1)
    else:
        annos["gt_boxes_lidar"] = np.zeros((0, 9))
    return annos


def convert_range_image_to_point_cloud(frame, range_images, camera_projections,
                                       range_image_top_pose, ri_index=(0, 1)):
    """Range images -> per-laser xyz/intensity/elongation/NLZ arrays
    (waymo_utils.py:73-167; uses the official TF range-image utilities)."""
    import tensorflow as tf
    from waymo_open_dataset import dataset_pb2
    from waymo_open_dataset.utils import range_image_utils, transform_utils

    calibs = sorted(frame.context.laser_calibrations, key=lambda c: c.name)
    frame_pose = tf.convert_to_tensor(
        np.array(frame.pose.transform, np.float32).reshape(4, 4))
    top_pose = tf.reshape(
        tf.convert_to_tensor(range_image_top_pose.data),
        range_image_top_pose.shape.dims)
    rot = transform_utils.get_rotation_matrix(
        top_pose[..., 0], top_pose[..., 1], top_pose[..., 2])
    top_pose = transform_utils.get_transform(rot, top_pose[..., 3:])

    points, nlz, intensity, elongation = [], [], [], []
    for c in calibs:
        per = {k: [] for k in ("p", "n", "i", "e")}
        for ri in ri_index:
            rim = range_images[c.name][ri]
            if len(c.beam_inclinations) == 0:
                incl = range_image_utils.compute_inclination(
                    tf.constant([c.beam_inclination_min,
                                 c.beam_inclination_max]),
                    height=rim.shape.dims[0])
            else:
                incl = tf.constant(c.beam_inclinations)
            incl = tf.reverse(incl, axis=[-1])
            extrinsic = np.array(c.extrinsic.transform).reshape(4, 4)
            rit = tf.reshape(tf.convert_to_tensor(rim.data), rim.shape.dims)
            pixel_pose = frame_pose_l = None
            if c.name == dataset_pb2.LaserName.TOP:
                pixel_pose = tf.expand_dims(top_pose, 0)
                frame_pose_l = tf.expand_dims(frame_pose, 0)
            mask = rit[..., 0] > 0
            cart = range_image_utils.extract_point_cloud_from_range_image(
                tf.expand_dims(rit[..., 0], 0),
                tf.expand_dims(extrinsic, 0),
                tf.expand_dims(incl, 0),
                pixel_pose=pixel_pose, frame_pose=frame_pose_l)
            cart = tf.squeeze(cart, 0)
            per["p"].append(tf.gather_nd(cart, tf.where(mask)).numpy())
            per["n"].append(tf.gather_nd(rit[..., 3], tf.where(mask)).numpy())
            per["i"].append(tf.gather_nd(rit[..., 1], tf.where(mask)).numpy())
            per["e"].append(tf.gather_nd(rit[..., 2], tf.where(mask)).numpy())
        points.append(np.concatenate(per["p"]))
        nlz.append(np.concatenate(per["n"]))
        intensity.append(np.concatenate(per["i"]))
        elongation.append(np.concatenate(per["e"]))
    return points, nlz, intensity, elongation


def save_lidar_points(frame, cur_save_path, use_two_returns=True):
    from waymo_open_dataset.utils import frame_utils

    ret = frame_utils.parse_range_image_and_camera_projection(frame)
    if len(ret) == 4:
        range_images, camera_projections, _seg, top_pose = ret
    else:
        range_images, camera_projections, top_pose = ret
    points, nlz, intensity, elongation = convert_range_image_to_point_cloud(
        frame, range_images, camera_projections, top_pose,
        ri_index=(0, 1) if use_two_returns else (0,))
    per_lidar = [p.shape[0] for p in points]
    out = np.concatenate(
        [np.concatenate(points),
         np.concatenate(intensity).reshape(-1, 1),
         np.concatenate(elongation).reshape(-1, 1),
         np.concatenate(nlz).reshape(-1, 1)], axis=-1).astype(np.float32)
    np.save(cur_save_path, out)
    return per_lidar


def frame_info(frame, sequence_name, cnt, has_label=True):
    """Per-frame info dict assembly (pure proto-attrs; testable)."""
    info = {
        "point_cloud": {"num_features": 5, "lidar_sequence": sequence_name,
                        "sample_idx": cnt},
        "frame_id": sequence_name + ("_%03d" % cnt),
        "metadata": {"context_name": frame.context.name,
                     "timestamp_micros": frame.timestamp_micros},
        "image": {
            "image_shape_%d" % j: (
                frame.context.camera_calibrations[j].height,
                frame.context.camera_calibrations[j].width,
            )
            for j in range(min(5, len(frame.context.camera_calibrations)))
        },
    }
    pose = np.array(frame.pose.transform, np.float32).reshape(4, 4)
    info["pose"] = pose
    if has_label:
        info["annos"] = generate_labels(frame, pose=pose)
    return info


def process_single_sequence(sequence_file, save_path, sampled_interval,
                            has_label=True, use_two_returns=True):
    """tfrecord -> {sequence}.pkl + per-frame %04d.npy
    (waymo_utils.py:199-266)."""
    import tensorflow as tf
    from waymo_open_dataset import dataset_pb2

    sequence_file = Path(sequence_file)
    sequence_name = os.path.splitext(sequence_file.name)[0]
    if not sequence_file.exists():
        return []
    cur_save_dir = Path(save_path) / sequence_name
    cur_save_dir.mkdir(parents=True, exist_ok=True)
    pkl_file = cur_save_dir / f"{sequence_name}.pkl"
    if pkl_file.exists():
        with open(pkl_file, "rb") as f:
            return pickle.load(f)

    infos = []
    dataset = tf.data.TFRecordDataset(str(sequence_file), compression_type="")
    for cnt, data in enumerate(dataset):
        if cnt % sampled_interval != 0:
            continue
        frame = dataset_pb2.Frame()
        frame.ParseFromString(bytearray(data.numpy()))
        info = frame_info(frame, sequence_name, cnt, has_label)
        info["num_points_of_each_lidar"] = save_lidar_points(
            frame, cur_save_dir / ("%04d.npy" % cnt),
            use_two_returns=use_two_returns)
        infos.append(info)
    with open(pkl_file, "wb") as f:
        pickle.dump(infos, f)
    return infos
