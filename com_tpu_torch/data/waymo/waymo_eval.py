"""Official Waymo AP/APH adapter (the port's copy of
``com_tpu/data/waymo/waymo_eval.py``; pcdet/datasets/waymo/waymo_eval.py:23-251).

The array-assembly half (class masking, difficulty re-assignment from
num_points_in_gt, zero-point GT filtering, heading normalization, distance
masking) is pure numpy and unit-testable without TF.  The metric half uses the
waymo-open-dataset TF metrics library when installed (same host-side evaluator
the reference uses); raises ImportError otherwise so callers can fall back
(WaymoDataset.evaluation does).
"""
from __future__ import annotations

import numpy as np

# reference WAYMO_CLASSES ordering: index = waymo type enum
WAYMO_CLASSES = ["unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist"]


def _limit_heading(h):
    # limit_period(offset=0.5, period=2*pi) -> [-pi, pi)
    return h - np.floor(h / (2 * np.pi) + 0.5) * 2 * np.pi


def assemble_gt_arrays(infos, class_names):
    """GT assembly with the reference's difficulty re-assignment
    (waymo_eval.py:42-58): boxes with difficulty 0 get 1 if
    num_points_in_gt > 5 else 2; zero-point boxes are dropped entirely."""
    frame_id, boxes3d, obj_type, difficulty = [], [], [], []
    for fi, info in enumerate(infos):
        name = np.asarray(info["name"])
        box = np.asarray(info["gt_boxes_lidar"], np.float64)
        box_mask = np.array([n in class_names for n in name], bool)
        diff = np.asarray(
            info.get("difficulty", np.zeros(len(name))), np.int64
        ).copy()
        if "num_points_in_gt" in info:
            npts = np.asarray(info["num_points_in_gt"])
            zero = diff == 0
            diff[(npts > 5) & zero] = 1
            diff[(npts <= 5) & zero] = 2
            box_mask = box_mask & (npts > 0)
        else:
            raise ValueError(
                "num_points_in_gt required for Waymo evaluation "
                "(reference waymo_eval.py:50-53)"
            )
        boxes3d.append(box[box_mask][:, :7])
        difficulty.append(diff[box_mask])
        obj_type.extend(WAYMO_CLASSES.index(n) for n in name[box_mask])
        frame_id.append(np.full(int(box_mask.sum()), fi, np.int64))

    boxes3d = np.concatenate(boxes3d) if boxes3d else np.zeros((0, 7))
    boxes3d[:, -1] = _limit_heading(boxes3d[:, -1])
    return (
        np.concatenate(frame_id) if frame_id else np.zeros(0, np.int64),
        boxes3d,
        np.asarray(obj_type, np.int64),
        np.concatenate(difficulty).astype(np.int64)
        if difficulty
        else np.zeros(0, np.int64),
    )


def assemble_pred_arrays(det_annos):
    frame_id, boxes3d, obj_type, score = [], [], [], []
    for fi, a in enumerate(det_annos):
        box = np.asarray(a["boxes_lidar"], np.float64)
        boxes3d.append(box[:, :7])
        score.append(np.asarray(a["score"], np.float64))
        obj_type.extend(WAYMO_CLASSES.index(n) if n in WAYMO_CLASSES else 0
                        for n in a["name"])
        frame_id.append(np.full(len(box), fi, np.int64))
    boxes3d = np.concatenate(boxes3d) if boxes3d else np.zeros((0, 7))
    boxes3d[:, -1] = _limit_heading(boxes3d[:, -1])
    return (
        np.concatenate(frame_id) if frame_id else np.zeros(0, np.int64),
        boxes3d,
        np.asarray(obj_type, np.int64),
        np.concatenate(score) if score else np.zeros(0),
    )


def mask_by_distance(distance_thresh, boxes3d, *args):
    """Drop boxes beyond distance_thresh (+0.5 slack, waymo_eval.py:177-182)."""
    mask = np.linalg.norm(boxes3d[:, 0:2], axis=1) < distance_thresh + 0.5
    return tuple([boxes3d[mask]] + [a[mask] for a in args])


def build_metric_config(metrics_pb2, text_format):
    config = metrics_pb2.Config()
    config_text = """
    breakdown_generator_ids: OBJECT_TYPE
    difficulties { levels: 1 levels: 2 }
    matcher_type: TYPE_HUNGARIAN
    iou_thresholds: 0.0
    iou_thresholds: 0.7
    iou_thresholds: 0.5
    iou_thresholds: 0.5
    iou_thresholds: 0.5
    box_type: TYPE_3D
    """
    text_format.Merge(config_text, config)
    # 101 score cutoffs: 0.00..0.99 step 0.01, plus 1.0 (waymo_eval.py:108-110)
    for x in range(100):
        config.score_cutoffs.append(x * 0.01)
    config.score_cutoffs.append(1.0)
    return config


def waymo_evaluation(det_annos, infos, class_names, distance_thresh=100.0):
    try:
        import tensorflow as tf  # noqa: F401
        from google.protobuf import text_format
        from waymo_open_dataset.metrics.python import detection_metrics
        from waymo_open_dataset.protos import metrics_pb2
    except Exception as e:  # pragma: no cover - optional heavy dep
        raise ImportError(
            "waymo-open-dataset + tensorflow required for official AP/APH"
        ) from e

    gt_infos = [
        {
            "gt_boxes_lidar": info["annos"]["gt_boxes_lidar"],
            "name": info["annos"]["name"],
            "difficulty": info["annos"].get("difficulty"),
            **(
                {"num_points_in_gt": info["annos"]["num_points_in_gt"]}
                if "num_points_in_gt" in info["annos"]
                else {}
            ),
        }
        for info in infos
    ]
    pd_frame, pd_box, pd_type, pd_score = assemble_pred_arrays(det_annos)
    gt_frame, gt_box, gt_type, gt_diff = assemble_gt_arrays(gt_infos, class_names)
    pd_box, pd_frame, pd_type, pd_score = mask_by_distance(
        distance_thresh, pd_box, pd_frame, pd_type, pd_score
    )
    gt_box, gt_frame, gt_type, gt_diff = mask_by_distance(
        distance_thresh, gt_box, gt_frame, gt_type, gt_diff
    )

    config = build_metric_config(metrics_pb2, text_format)
    metrics = detection_metrics.get_detection_metric_ops(
        config,
        prediction_frame_id=tf.constant(pd_frame),
        prediction_bbox=tf.constant(pd_box, tf.float32),
        prediction_type=tf.constant(pd_type, tf.uint8),
        prediction_score=tf.constant(pd_score, tf.float32),
        prediction_overlap_nlz=tf.zeros_like(tf.constant(pd_frame), tf.bool),
        ground_truth_frame_id=tf.constant(gt_frame),
        ground_truth_bbox=tf.constant(gt_box, tf.float32),
        ground_truth_type=tf.constant(gt_type, tf.uint8),
        ground_truth_difficulty=tf.constant(gt_diff, tf.uint8),
    )
    result = {k: float(v[0].numpy()) for k, v in metrics.items()}
    lines = [f"{k}: {v:.4f}" for k, v in sorted(result.items()) if "AP" in k]
    return "\n".join(lines), result
