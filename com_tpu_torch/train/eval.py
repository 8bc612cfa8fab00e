"""Evaluation (counterpart of ``com_tpu/train/eval.py``; reference
tools/eval_utils/eval_utils.py:12-136).

``make_eval_step`` (CenterPoint and anchor branches): forward -> per-head
top-K decode -> NMS, or every anchor decoded -> top ``NMS_PRE_MAXSIZE`` ->
NMS, all on the device, fixed shapes with validity masks.  ``eval_model``
runs it over a loader, copies each batch's outputs to the host at once,
trims every frame to its valid detections sorted by score into
``det_annos``, and counts recall against the GT by the rotated 3D IoU
(``recall_stats``, detector3d_template.py:286-328).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..models.dense_heads.anchor_head import (anchor_post_process, box_coder_for,
                                              build_anchors, decode_anchor_boxes)
from ..models.dense_heads.center_head import decode_center_boxes, post_process_nms
from ..ops.host_boxes import boxes_iou3d
from ..utils.device import resolve_device
from .step import model_input_keys


def _head_groups(model_cfg, class_names):
    return [tuple(class_names.index(n) + 1 for n in names if n in class_names)
            for names in model_cfg["DENSE_HEAD"]["CLASS_NAMES_EACH_HEAD"]]


def make_eval_step(net, model_cfg, class_names, meta, device=None):
    """An ``eval_step(batch) -> (boxes, scores, labels, valid)`` over ``net``.

    ``batch`` holds the model's inputs (``model_input_keys``: "points" and
    "points_mask", or a voxel model's "voxels", "voxel_coords" and
    "voxel_num_points"), as numpy arrays or tensors; they move to
    ``device`` (CUDA unless the caller passes another).  Outputs are
    tensors on that device: boxes (B, P, 7), scores and labels (B, P),
    valid (B, P), P = NMS_POST_MAXSIZE per head, heads concatenated (one
    "head" for an anchor head).  Unlike the JAX step, the weights live in
    ``net``.
    """
    if model_cfg.get("ROI_HEAD") is not None:
        raise NotImplementedError("two-stage eval is not ported yet")
    head_cfg = model_cfg["DENSE_HEAD"]
    dev = resolve_device(device)
    if "ANCHOR_GENERATOR_CONFIG" in head_cfg:
        return _make_anchor_eval_step(net, model_cfg, class_names, meta, dev)
    post = head_cfg["POST_PROCESSING"]
    stride = int(head_cfg["TARGET_ASSIGNER_CONFIG"].get("FEATURE_MAP_STRIDE", 1))
    groups = _head_groups(model_cfg, list(class_names))
    nms_cfg = post["NMS_CONFIG"]
    keys = model_input_keys(model_cfg)

    @torch.no_grad()
    def eval_step(batch):
        out = net({k: torch.as_tensor(batch[k], device=dev) for k in keys})
        parts = []
        for pred_dict, class_ids in zip(out["pred_dicts"], groups):
            decoded = decode_center_boxes(
                pred_dict, class_ids, meta.point_cloud_range, meta.voxel_size, stride,
                k=int(post.get("MAX_OBJ_PER_SAMPLE", 500)),
                score_thresh=float(post.get("SCORE_THRESH", 0.1)),
                post_center_limit_range=post.get("POST_CENTER_LIMIT_RANGE"),
                head_order=tuple(head_cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"]))
            parts.append(post_process_nms(*decoded, nms_cfg,
                                          int(nms_cfg.get("NMS_POST_MAXSIZE", 500))))
        return tuple(torch.cat(p, dim=1) for p in zip(*parts))

    return eval_step


def _make_anchor_eval_step(net, model_cfg, class_names, meta, dev):
    """Anchor-head inference (anchor_head_template.generate_predicted_boxes
    and the model's post-processing): every anchor decoded, the top
    ``NMS_PRE_MAXSIZE`` by score, score filter, rotated NMS.  Reads
    ``MODEL.POST_PROCESSING``, with the JAX package's defaults."""
    head_cfg = model_cfg["DENSE_HEAD"]
    post = model_cfg.get("POST_PROCESSING", {})
    nms_cfg = post.get("NMS_CONFIG", {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
                                      "NMS_PRE_MAXSIZE": 4096, "NMS_POST_MAXSIZE": 500})
    score_thresh = float(post.get("SCORE_THRESH", 0.1))
    anchors = torch.as_tensor(build_anchors(head_cfg, list(class_names), meta.grid_size,
                                            meta.point_cloud_range)[0], device=dev)
    coder = box_coder_for(head_cfg)
    dir_cfg = head_cfg if head_cfg.get("USE_DIRECTION_CLASSIFIER") else None
    num_class = len(class_names)
    keys = model_input_keys(model_cfg)

    @torch.no_grad()
    def eval_step(batch):
        out = net({k: torch.as_tensor(batch[k], device=dev) for k in keys})
        boxes, scores, labels = decode_anchor_boxes(out, anchors, num_class, coder, dir_cfg)
        return anchor_post_process(boxes, scores, labels, nms_cfg, score_thresh,
                                   num_classes=num_class)

    return eval_step


def recall_stats(pred_boxes, gt_boxes, thresh_list=(0.3, 0.5, 0.7)):
    """Per-frame recall counts against the GT rows with a class (rotated 3D
    IoU): ``{"recall_{t}": GT boxes whose best IoU exceeds t, "gt": count}``."""
    gt = gt_boxes[gt_boxes[:, -1] > 0]
    out = {f"recall_{t}": 0 for t in thresh_list}
    out["gt"] = len(gt)
    if len(gt) == 0 or len(pred_boxes) == 0:
        return out
    best = boxes_iou3d(pred_boxes[:, :7], gt[:, :7]).max(axis=0)
    for t in thresh_list:
        out[f"recall_{t}"] = int((best > t).sum())
    return out


def _to_host(boxes, scores, labels, valid):
    """The four outputs of a batch in one device -> host copy (labels and the
    mask ride as f32, exact for them)."""
    packed = torch.cat([boxes.float(), scores.float()[..., None], labels.float()[..., None],
                        valid.float()[..., None]], dim=-1).cpu().numpy()
    n = boxes.shape[-1]
    return (packed[..., :n], packed[..., n], packed[..., n + 1].astype(np.int32),
            packed[..., n + 2] > 0)


def eval_model(eval_step, loader, class_names, logger=None, recall_thresh_list=(0.3, 0.5, 0.7),
               mesh=None):
    """Run ``eval_step(batch)`` (``make_eval_step``: the weights live in its
    model) over ``loader``.  Returns (det_annos, recall counts, seconds a
    frame): one anno a frame with its valid detections in descending score
    order (``np.argsort(-scores)`` on the host, as ``com_tpu``), "frame_id",
    "boxes_lidar", "score", "pred_labels", "name" and the batch's
    "metadata" where it has one; recall over the batches that carry
    "gt_boxes".  ``mesh`` (data-parallel eval) waits for the multi-device
    port."""
    if mesh is not None:
        raise NotImplementedError("eval over a device mesh is not ported yet")
    det_annos = []
    recalls = {f"recall_{t}": 0 for t in recall_thresh_list}
    recalls["gt"] = 0
    t0 = time.time()
    n_frames = 0
    for batch in loader:
        boxes, scores, labels, valid = _to_host(*eval_step(batch))
        bs = boxes.shape[0]
        n_frames += bs
        frame_ids = batch.get("frame_id", [None] * bs)
        md = batch.get("metadata")
        for i in range(bs):
            v = valid[i]
            order = np.argsort(-scores[i][v])
            frame_boxes = boxes[i][v][order]
            frame_labels = labels[i][v][order]
            anno = {"frame_id": frame_ids[i], "boxes_lidar": frame_boxes,
                    "score": scores[i][v][order], "pred_labels": frame_labels,
                    "name": np.array([class_names[int(l) - 1] for l in frame_labels])}
            if md is not None and md[i] is not None:
                anno["metadata"] = md[i]
            det_annos.append(anno)
            if "gt_boxes" in batch:
                r = recall_stats(frame_boxes, batch["gt_boxes"][i], recall_thresh_list)
                for k in recalls:
                    recalls[k] += r[k]
    sec_per_example = (time.time() - t0) / max(n_frames, 1)
    if logger:
        gt = max(recalls["gt"], 1)
        logger.info("eval: %d frames, %.4f s/frame, " % (n_frames, sec_per_example)
                    + " ".join(f"{k}={recalls[k] / gt:.3f}" for k in recalls if k != "gt"))
    return det_annos, recalls, sec_per_example
