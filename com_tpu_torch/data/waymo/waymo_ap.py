"""TF-free Waymo AP/APH evaluator (numpy + scipy Hungarian; the port's copy
of ``com_tpu/data/waymo/waymo_ap.py``).

Reimplements the waymo-open-dataset detection metric the reference drives
through TF (pcdet/datasets/waymo/waymo_eval.py:91-113 fixes
the config: OBJECT_TYPE breakdown, LEVEL_1/LEVEL_2 difficulties, Hungarian
matcher, per-type 3D-IoU thresholds [Vehicle 0.7, Pedestrian 0.5,
Cyclist 0.5], 101 score cutoffs 0.00..0.99 + 1.0).  This makes the
BASELINE.md +-0.2 L2 mAPH parity target measurable in an image without
tensorflow/waymo-open-dataset.

Semantics implemented (documented where the WOD C++ leaves room):

- GT assembly with the <=5-points -> LEVEL_2 difficulty re-assignment and
  zero-point GT drop (reference waymo_eval.py:43-47) via
  ``waymo_eval.assemble_gt_arrays``.
- Per (frame, class): predictions are Hungarian-matched to ALL ground truths
  of that class, maximizing total 3D IoU over pairs with IoU >= threshold.
- LEVEL_L counting: a matched pair whose GT difficulty exceeds L is IGNORED
  (the prediction is not a false positive, the GT not a false negative) —
  this only affects LEVEL_1; LEVEL_2 includes every box, so the parity
  target (L2 mAPH) is insensitive to this choice.
- APH: each true positive is weighted by heading accuracy
  ``1 - min(|dh|, 2pi - |dh|) / pi`` in both the precision and recall
  numerators (the WOD definition).
- AP: exact integral of the max-precision envelope over recall across the
  101-cutoff P/R samples (the WOD recall-gap penalty is a no-op at 101
  uniformly spaced cutoffs and is not reproduced).
"""
from __future__ import annotations

import numpy as np

from ...ops.host_boxes import boxes_iou3d
from .waymo_eval import (
    WAYMO_CLASSES,
    assemble_gt_arrays,
    assemble_pred_arrays,
    mask_by_distance,
)

# per-type 3D IoU thresholds, indexed by WAYMO_CLASSES position
# (reference waymo_eval.py:101-106: [0.0, 0.7, 0.5, 0.5, 0.5])
IOU_THRESH = {1: 0.7, 2: 0.5, 3: 0.5, 4: 0.5}

SCORE_CUTOFFS = np.concatenate([np.arange(100) * 0.01, [1.0]])


def _heading_accuracy(dh):
    """1 - wrapped-angle-error / pi, in [0, 1]."""
    dh = np.abs(dh) % (2 * np.pi)
    dh = np.minimum(dh, 2 * np.pi - dh)
    return 1.0 - dh / np.pi


def _match_frame(pd_boxes, pd_scores, gt_boxes, gt_diff, iou_thresh):
    """Per-frame per-class sweep: returns (tp, tp_h, fp) accumulated into the
    101-cutoff grid for each difficulty level, plus the per-level GT counts.

    Output: dict level -> (tp[101], tp_h[101], fp[101]); gt counts (n_l1, n_l2).
    """
    from scipy.optimize import linear_sum_assignment

    order = np.argsort(-pd_scores, kind="stable")
    pd_boxes, pd_scores = pd_boxes[order], pd_scores[order]
    P, G = len(pd_boxes), len(gt_boxes)
    out = {1: np.zeros((3, 101)), 2: np.zeros((3, 101))}
    n_l1 = int((gt_diff <= 1).sum())
    n_l2 = int(G)
    if P == 0:
        return out, (n_l1, n_l2)

    iou = boxes_iou3d(pd_boxes, gt_boxes) if G else np.zeros((P, 0))
    # number of surviving preds at each cutoff (scores sorted desc)
    keep_at = np.searchsorted(-pd_scores, -SCORE_CUTOFFS, side="right")
    # evaluate each distinct prefix length once, broadcast to its cutoffs
    for k in np.unique(keep_at):
        cut_idx = np.nonzero(keep_at == k)[0]
        if k == 0:
            continue  # no predictions survive: tp = fp = 0
        sub = iou[:k]
        if G == 0:
            for lvl in (1, 2):
                out[lvl][2, cut_idx] += k
            continue
        # Hungarian maximizing IoU; pairs below threshold carry zero weight
        # so they never displace a valid match, and are dropped afterwards
        w = np.where(sub >= iou_thresh, sub, 0.0)
        rows, cols = linear_sum_assignment(-w)
        valid = sub[rows, cols] >= iou_thresh
        rows, cols = rows[valid], cols[valid]
        hacc = _heading_accuracy(pd_boxes[rows, 6] - gt_boxes[cols, 6])
        for lvl in (1, 2):
            counted = gt_diff[cols] <= lvl
            tp = int(counted.sum())
            tp_h = float(hacc[counted].sum())
            ignored = int((~counted).sum())
            fp = int(k) - tp - ignored
            out[lvl][0, cut_idx] += tp
            out[lvl][1, cut_idx] += tp_h
            out[lvl][2, cut_idx] += fp
    return out, (n_l1, n_l2)


def _ap_from_pr(precision, recall):
    """Exact integral of the max-precision envelope over recall.

    Points arrive ordered by ascending cutoff (descending recall); the
    envelope at recall r is the max precision among samples with recall >= r.
    """
    order = np.argsort(-recall, kind="stable")
    p, r = precision[order], recall[order]
    env = np.maximum.accumulate(p)
    ap = 0.0
    for i in range(len(r)):
        r_next = r[i + 1] if i + 1 < len(r) else 0.0
        ap += max(r[i] - r_next, 0.0) * env[i]
    return float(ap)


def compute_waymo_ap(det_annos, infos, class_names, distance_thresh=100.0):
    """numpy AP/APH over the same inputs as ``waymo_evaluation``.

    Returns (result_str, result_dict) with WOD-style keys, e.g.
    ``OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/APH``.
    """
    gt_infos = [
        {
            "gt_boxes_lidar": info["annos"]["gt_boxes_lidar"],
            "name": info["annos"]["name"],
            # don't insert a None key: assemble_gt_arrays defaults an
            # ABSENT difficulty to zeros (waymo_dataset.py stores infos
            # without it on some paths)
            **(
                {"difficulty": info["annos"]["difficulty"]}
                if info["annos"].get("difficulty") is not None
                else {}
            ),
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

    result = {}
    for cname in class_names:
        ctype = WAYMO_CLASSES.index(cname)
        thresh = IOU_THRESH.get(ctype, 0.5)
        pm, gm = pd_type == ctype, gt_type == ctype
        # accumulate the 101-cutoff grid across frames
        acc = {1: np.zeros((3, 101)), 2: np.zeros((3, 101))}
        tot = {1: 0, 2: 0}
        frames = set(np.unique(pd_frame[pm])) | set(np.unique(gt_frame[gm]))
        for f in sorted(frames):
            pf = pm & (pd_frame == f)
            gf = gm & (gt_frame == f)
            per, (n1, n2) = _match_frame(
                pd_box[pf], pd_score[pf], gt_box[gf], gt_diff[gf], thresh
            )
            for lvl in (1, 2):
                acc[lvl] += per[lvl]
            tot[1] += n1
            tot[2] += n2

        wod_name = f"OBJECT_TYPE_TYPE_{cname.upper()}_LEVEL"
        for lvl in (1, 2):
            tp, tp_h, fp = acc[lvl]
            denom_p = tp + fp
            precision = np.where(denom_p > 0, tp / np.maximum(denom_p, 1), 0.0)
            precision_h = np.where(
                denom_p > 0, tp_h / np.maximum(denom_p, 1), 0.0
            )
            n_gt = max(tot[lvl], 1)
            recall = tp / n_gt if tot[lvl] else np.zeros(101)
            recall_h = tp_h / n_gt if tot[lvl] else np.zeros(101)
            result[f"{wod_name}_{lvl}/AP"] = _ap_from_pr(precision, recall)
            result[f"{wod_name}_{lvl}/APH"] = _ap_from_pr(
                precision_h, recall_h
            )

    for lvl in (1, 2):
        for m in ("AP", "APH"):
            vals = [
                result[f"OBJECT_TYPE_TYPE_{c.upper()}_LEVEL_{lvl}/{m}"]
                for c in class_names
            ]
            result[f"MEAN_LEVEL_{lvl}/m{m}"] = float(np.mean(vals)) if vals else 0.0

    lines = [f"{k}: {v:.4f}" for k, v in sorted(result.items())]
    return "\n".join(lines), result
