"""The Lyft mAP loop (the port's copy of ``com_tpu/data/lyft/lyft_eval.py``;
pcdet lyft_mAP_eval/lyft_eval.py:214-396 and lyft_utils.py:258-332 roles),
devkit-free, numpy on the host.

The reference evaluates in the global frame after moving detections by the
devkit's ego poses; the 3D IoU is invariant under that rigid transform, so
the lidar frame against the info GT gives the same mAP.  Boxes are 7-dof
``[x, y, z, dx, dy, dz, yaw]``; the IoU is the port's ``boxes_iou3d``
(``ops/iou.py``) on CPU tensors in float64, as ``com_tpu`` computes it in
numpy float64.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

import torch

from ...ops.iou import boxes_iou3d


def get_envelope(precisions):
    """Monotone max-precision envelope (lyft_eval.get_envelope:229-240)."""
    for i in range(precisions.size - 1, 0, -1):
        precisions[i - 1] = np.maximum(precisions[i - 1], precisions[i])
    return precisions


def get_ap(recalls, precisions):
    """VOC-style AP: sentinels + envelope + delta-recall sum
    (lyft_eval.get_ap:243-265)."""
    recalls = np.concatenate(([0.0], recalls, [1.0]))
    precisions = np.concatenate(([0.0], precisions, [0.0]))
    precisions = get_envelope(precisions)
    i = np.where(recalls[1:] != recalls[:-1])[0]
    return float(np.sum((recalls[i + 1] - recalls[i]) * precisions[i + 1]))


def recall_precision(gt, predictions, iou_threshold_list):
    """Greedy max-IoU matching swept over thresholds
    (lyft_eval.recall_precision:272-342: predictions sorted by score, each
    takes its single best-overlap gt, per-threshold gt_checked flags,
    strict > threshold).

    gt / predictions: lists of dicts with 'sample_token', 'box' (7-dof
    numpy), and 'score' for predictions.
    """
    num_gts = len(gt)
    if num_gts == 0:
        return -1, -1, -1

    image_gts = defaultdict(list)
    for g in gt:
        image_gts[g["sample_token"]].append(g)
    gt_boxes_by_sample = {
        tok: np.stack([g["box"] for g in boxes])
        for tok, boxes in image_gts.items()
    }
    gt_checked = {
        tok: np.zeros((len(boxes), len(iou_threshold_list)))
        for tok, boxes in image_gts.items()
    }

    predictions = sorted(predictions, key=lambda x: x["score"], reverse=True)
    n = len(predictions)
    tp = np.zeros((n, len(iou_threshold_list)))
    fp = np.zeros((n, len(iou_threshold_list)))

    for pi, pred in enumerate(predictions):
        tok = pred["sample_token"]
        max_overlap, jmax = -np.inf, -1
        if tok in gt_boxes_by_sample:
            overlaps = boxes_iou3d(
                torch.as_tensor(pred["box"][None, :7], dtype=torch.float64),
                torch.as_tensor(gt_boxes_by_sample[tok][:, :7], dtype=torch.float64),
            )[0].numpy()
            max_overlap = float(np.max(overlaps))
            jmax = int(np.argmax(overlaps))
        for i, thr in enumerate(iou_threshold_list):
            if max_overlap > thr:
                if gt_checked[tok][jmax, i] == 0:
                    tp[pi, i] = 1.0
                    gt_checked[tok][jmax, i] = 1
                else:
                    fp[pi, i] = 1.0
            else:
                fp[pi, i] = 1.0

    fp = np.cumsum(fp, axis=0)
    tp = np.cumsum(tp, axis=0)
    recalls = tp / float(num_gts)
    precisions = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap_list = [
        get_ap(recalls[:, i], precisions[:, i])
        for i in range(len(iou_threshold_list))
    ]
    return recalls, precisions, ap_list


def get_average_precisions(gt, predictions, class_names, iou_thresholds):
    """Per-class mean AP over the IoU threshold list
    (lyft_eval.get_average_precisions:345-393); classes absent from the gt
    score 0."""
    gt_by_class = defaultdict(list)
    for g in gt:
        gt_by_class[g["name"]].append(g)
    pred_by_class = defaultdict(list)
    for p in predictions:
        pred_by_class[p["name"]].append(p)

    average_precisions = np.zeros(len(class_names))
    for ci, cname in enumerate(class_names):
        if cname not in gt_by_class:
            continue
        _, _, ap_list = recall_precision(
            gt_by_class[cname], pred_by_class.get(cname, []), iou_thresholds)
        if ap_list == -1:
            continue
        average_precisions[ci] = float(np.mean(ap_list))
    return average_precisions


def format_lyft_results(classwise_ap, class_names, iou_threshold_list,
                        version="trainval"):
    """(lyft_utils.format_lyft_results:319-332 role)."""
    ret = {}
    lines = [f"----------------Lyft {version} results-----------------",
             f"Average precision over IoUs: {list(iou_threshold_list)}"]
    for ci, cname in enumerate(class_names):
        lines.append(f"{cname:<20}: \t {classwise_ap[ci]:.4f}")
        ret[cname] = float(classwise_ap[ci])
    mAP = float(np.mean(classwise_ap))
    lines.append("--------------average performance-------------")
    lines.append(f"mAP:\t {mAP:.4f}")
    ret["mAP"] = mAP
    return "\n".join(lines) + "\n", ret
