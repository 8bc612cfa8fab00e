"""KITTI detection AP (R40), numpy on the host (the port's copy of
``com_tpu/data/kitti/kitti_eval.py``; pcdet kitti_object_eval_python
eval.py role).

The official algorithm step for step: difficulty gates (2D height,
occlusion, truncation), per-GT max-overlap matching redone at every score
threshold (compute_statistics_jit), recall-spaced threshold subsampling
(get_thresholds), the monotone precision envelope, AP_R40 the mean
precision over sample points 1..40.  BEV and 3D are computed in the lidar
frame with the port's rotated IoU (``ops/iou.py``) on CPU tensors in
float64: ``com_tpu`` runs the same formulas in numpy, and f32 rounding
could flip a match at the 0.7 / 0.5 gates.
"""
from __future__ import annotations

import numpy as np

import torch

from ...ops.iou import boxes_iou3d, boxes_iou_bev

# official difficulty gates: min bbox height, max occlusion, max truncation
DIFFICULTY = {
    0: {"height": 40, "occlusion": 0, "truncation": 0.15},  # easy
    1: {"height": 25, "occlusion": 1, "truncation": 0.30},  # moderate
    2: {"height": 25, "occlusion": 2, "truncation": 0.50},  # hard
}
MIN_OVERLAP = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5,
               "Vehicle": 0.7, "Van": 0.7, "Truck": 0.7}
N_SAMPLE_PTS = 41
NO_DETECTION = -10000000.0


def _gt_ignore_codes(gt, class_name, difficulty):
    """Per-GT code like clean_data (eval.py:29-74): 0 = valid, 1 = ignored
    (same class but too hard, or neighboring class), -1 = irrelevant."""
    gates = DIFFICULTY[difficulty]
    names = np.char.lower(gt["name"].astype(str))
    n = len(names)
    same = names == class_name.lower()
    neighbor = {"car": ["van"], "pedestrian": ["person_sitting"]}.get(
        class_name.lower(), []
    )
    occ = np.asarray(gt.get("occluded", np.zeros(n)))
    trunc = np.asarray(gt.get("truncated", np.zeros(n)))
    hgt = np.asarray(gt.get("bbox_height", np.full(n, 50.0)))
    too_hard = (occ > gates["occlusion"]) | (trunc > gates["truncation"]) | (
        hgt <= gates["height"]
    )
    code = np.full(n, -1, np.int64)
    code[same & ~too_hard] = 0
    code[same & too_hard] = 1
    code[np.isin(names, neighbor)] = 1
    return code


def _match_stats(iou, gt_code, det_scores, min_overlap, thresh,
                 compute_fp, det_code=None):
    """compute_statistics_jit semantics (eval.py:157-243): greedy per-GT
    assignment — by score when collecting thresholds (compute_fp=False), by
    max overlap when counting tp/fp at a threshold; strict > min_overlap.

    det_code mirrors the reference's ignored_det: 0 = valid, 1 = ignored
    (projected 2D height below the difficulty gate) — ignored detections
    can absorb a GT (no TP) and never count as FP.  DontCare regions need
    no handling here: the reference subtracts them only for metric 0 (2D
    bbox AP, eval.py:250 ``if metric == 0``), which this evaluator does
    not report.

    iou: (num_det, num_gt).  Returns (tp, fp, fn, tp_scores list)."""
    num_det = len(det_scores)
    num_gt = iou.shape[1] if num_det else len(gt_code)
    if det_code is None:
        det_code = np.zeros(num_det, np.int64)
    assigned = np.zeros(num_det, bool)
    ignored_thresh = det_scores < thresh if compute_fp else np.zeros(num_det, bool)
    tp = fp = fn = 0
    tp_scores = []
    for i in range(num_gt):
        if gt_code[i] == -1:
            continue
        det_idx = -1
        if num_det:
            usable = ~assigned & ~ignored_thresh
            ov = np.where(usable, iou[:, i], -1.0)
            cand = ov > min_overlap
            if compute_fp:
                # prefer the highest-overlap VALID det; an ignored det is
                # taken only when no valid det matches (eval.py:199-224)
                valid_cand = cand & (det_code == 0)
                if valid_cand.any():
                    det_idx = int(np.argmax(np.where(valid_cand, ov, -1.0)))
                elif (cand & (det_code == 1)).any():
                    det_idx = int(np.argmax(
                        np.where(cand & (det_code == 1), ov, -1.0)))
            else:
                if cand.any():
                    det_idx = int(np.argmax(
                        np.where(cand, det_scores, NO_DETECTION)))
        if det_idx < 0:
            if gt_code[i] == 0:
                fn += 1
        elif gt_code[i] == 1 or det_code[det_idx] == 1:
            assigned[det_idx] = True
        else:
            tp += 1
            tp_scores.append(float(det_scores[det_idx]))
            assigned[det_idx] = True
    if compute_fp:
        fp = int((~assigned & ~ignored_thresh & (det_code == 0)).sum())
    return tp, fp, fn, tp_scores


def iou_matrix(iou_fn, det_boxes, gt_boxes):
    """(num_det, num_gt) IoU of the boxes' first 7 columns, float64 on the CPU."""
    as64 = lambda b: torch.as_tensor(np.asarray(b)[:, :7], dtype=torch.float64)  # noqa: E731
    return iou_fn(as64(det_boxes), as64(gt_boxes)).numpy()


def _get_thresholds(tp_scores_desc, num_gt):
    """Recall-spaced threshold subsampling (eval.py get_thresholds)."""
    thresholds = []
    current_recall = 0.0
    for i, score in enumerate(tp_scores_desc):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(tp_scores_desc) - 1 else l_recall
        if (r_recall - current_recall) < (current_recall - l_recall) and (
            i < len(tp_scores_desc) - 1
        ):
            continue
        thresholds.append(score)
        current_recall += 1 / (N_SAMPLE_PTS - 1.0)
    return thresholds


def eval_class(gt_annos, det_annos, class_name, difficulty, metric):
    """AP(R40) of one (class, difficulty, metric), the role of eval_class."""
    min_overlap = MIN_OVERLAP.get(class_name, 0.5)
    iou_fn = boxes_iou_bev if metric == "bev" else boxes_iou3d

    frames = []
    total_gt = 0
    all_tp_scores = []
    gates = DIFFICULTY[difficulty]
    for gt, det in zip(gt_annos, det_annos):
        code = _gt_ignore_codes(gt, class_name, difficulty)
        det_mask = np.char.lower(det["name"].astype(str)) == class_name.lower()
        det_boxes = np.asarray(det["boxes_lidar"])[det_mask]
        det_scores = np.asarray(det["score"])[det_mask]
        # reference clean_data:70-82 ignores detections whose projected 2D
        # height falls under the difficulty gate (applies to every metric);
        # dets without a projected bbox stay valid
        if "bbox" in det and len(np.asarray(det["bbox"])):
            h2d = np.asarray(det["bbox"])[det_mask]
            h2d = np.abs(h2d[:, 3] - h2d[:, 1])
            det_code = np.where(h2d < gates["height"], 1, 0).astype(np.int64)
        else:
            det_code = np.zeros(len(det_scores), np.int64)
        gt_boxes = np.asarray(gt["gt_boxes_lidar"])
        iou = (
            iou_matrix(iou_fn, det_boxes, gt_boxes)
            if len(det_boxes) and len(gt_boxes)
            else np.zeros((len(det_boxes), len(gt_boxes)))
        )
        frames.append((iou, code, det_scores, det_code))
        total_gt += int((code == 0).sum())
        _, _, _, tps = _match_stats(iou, code, det_scores, min_overlap, 0.0,
                                    compute_fp=False, det_code=det_code)
        all_tp_scores += tps
    if total_gt == 0:
        return 0.0

    thresholds = _get_thresholds(sorted(all_tp_scores, reverse=True), total_gt)
    prec = np.zeros(N_SAMPLE_PTS)
    for ti, t in enumerate(thresholds[:N_SAMPLE_PTS]):
        tp = fp = fn = 0
        for iou, code, det_scores, det_code in frames:
            tpi, fpi, fni, _ = _match_stats(iou, code, det_scores,
                                            min_overlap, t, compute_fp=True,
                                            det_code=det_code)
            tp += tpi
            fp += fpi
            fn += fni
        prec[ti] = tp / max(tp + fp, 1)
    for i in range(N_SAMPLE_PTS - 2, -1, -1):
        prec[i] = max(prec[i], prec[i + 1])
    return float(prec[1:].sum() / (N_SAMPLE_PTS - 1) * 100.0)


def kitti_evaluation(det_annos, gt_annos, class_names):
    """Returns (result_str, result_dict), the role of get_official_eval_result."""
    result = {}
    lines = []
    for cls in class_names:
        for metric in ("bev", "3d"):
            aps = [eval_class(gt_annos, det_annos, cls, d, metric) for d in (0, 1, 2)]
            key = f"{cls}_{metric}"
            result[key] = aps
            lines.append(
                f"{cls} AP_{metric} R40 easy/mod/hard: "
                f"{aps[0]:.2f} / {aps[1]:.2f} / {aps[2]:.2f}"
            )
    return "\n".join(lines), result
