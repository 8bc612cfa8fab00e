"""Evaluation (counterpart of ``com_tpu/train/eval.py``; reference
tools/eval_utils/eval_utils.py:12-136).

``make_eval_step`` (CenterPoint, anchor and two-stage branches, PointRCNN's
and MPPNetE2E's among the last; ``make_stream_step`` runs MPPNetE2E frame
by frame with its memory bank): forward
-> per-head top-K decode -> NMS, or every anchor decoded -> top
``NMS_PRE_MAXSIZE`` -> NMS, or the RCNN head's boxes -> NMS, all on the
device, fixed shapes with validity masks.  ``eval_model``
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
from ..models.roi_heads.roi_targets import decode_rcnn_boxes
from ..models.roi_heads.second_head import fuse_scores_by_npoints
from ..ops.boxes import points_in_rbbox
from ..ops.host_boxes import boxes_iou3d
from ..ops.nms import nms_bev
from ..parallel.sharding import all_reduce_, gather_objects
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
    dev = resolve_device(device)
    if model_cfg.get("ROI_HEAD") is not None:  # before DENSE_HEAD: PointRCNN has none
        return _make_two_stage_eval_step(net, model_cfg, class_names, meta, dev)
    head_cfg = model_cfg["DENSE_HEAD"]
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


def _make_two_stage_eval_step(net, model_cfg, class_names, meta, dev):
    """Two-stage inference: the forward, then ``two_stage_post_process``."""
    keys = model_input_keys(model_cfg)
    post = two_stage_post_process(model_cfg, class_names, dev)

    @torch.no_grad()
    def eval_step(batch):
        return post(net({k: torch.as_tensor(batch[k], device=dev) for k in keys}), batch)

    return eval_step


def two_stage_post_process(model_cfg, class_names, dev):
    """A ``post(out, batch) -> (boxes, scores, labels, valid)`` over a
    two-stage forward's outputs (detector3d_template post_processing): the
    RCNN head's boxes, not the proposals, are scored, filtered by
    SCORE_THRESH and the RoIs' validity, and NMS'd
    (``MODEL.POST_PROCESSING.NMS_CONFIG``, its TEST entries over it).  A
    head that decodes its own boxes (SECONDHead, MPPNet's) writes
    ``batch_box_preds`` / ``batch_cls_preds``; a refinement head's
    ``rcnn_reg`` decodes against the RoIs.  SCORE_TYPE ranks SECOND-IoU's
    boxes (second_net_iou.py post_processing): "iou" (the default), "cls",
    "weighted_iou_cls", "num_pts_iou_cls" (the blend by the points of
    ``batch["points"]`` in each box) or "score_by_class"."""
    post = model_cfg.get("POST_PROCESSING", {})
    nms_cfg = dict(post.get("NMS_CONFIG", {"NMS_THRESH": 0.7}))
    nms_cfg.update(nms_cfg.get("TEST", {}))
    score_thresh = float(post.get("SCORE_THRESH", 0.1))
    post_max = int(nms_cfg.get("NMS_POST_MAXSIZE", 500))
    thresh = float(nms_cfg.get("NMS_THRESH", 0.7))
    score_type = str(nms_cfg.get("SCORE_TYPE", "iou"))
    if score_type not in ("iou", "cls", "weighted_iou_cls", "num_pts_iou_cls", "score_by_class"):
        raise NotImplementedError(f"SCORE_TYPE {score_type}")

    def fused_scores(out, batch, iou_scores, labels):
        if score_type == "iou" or "roi_scores" not in out:
            return iou_scores
        cls_scores = out["roi_scores"]
        if score_type == "cls":
            return cls_scores
        if score_type == "weighted_iou_cls":
            w = nms_cfg.get("SCORE_WEIGHTS", {})
            return float(w.get("iou", 0.5)) * iou_scores + float(w.get("cls", 0.5)) * cls_scores
        if score_type == "num_pts_iou_cls":
            th = nms_cfg.get("SCORE_THRESH", {})
            pts = torch.as_tensor(batch["points"], device=dev)[..., :3]
            msk = torch.as_tensor(batch["points_mask"], device=dev)
            inb = points_in_rbbox(pts, out["batch_box_preds"][..., :7]) & msk[..., None]
            return fuse_scores_by_npoints(cls_scores, iou_scores,
                                          inb.sum(dim=1).to(iou_scores.dtype),
                                          float(th.get("cls", 10.0)), float(th.get("iou", 100.0)))
        by_class = dict(nms_cfg.get("SCORE_BY_CLASS", {}))
        use_iou = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
        for i, name in enumerate(class_names):
            if str(by_class.get(name, "iou")) == "iou":
                use_iou = use_iou | (labels == i + 1)
        return torch.where(use_iou, iou_scores, cls_scores)

    @torch.no_grad()
    def post_process(out, batch):
        cls_labels = None
        if "batch_box_preds" in out:
            boxes = out["batch_box_preds"][..., :7]
            cls = out["batch_cls_preds"]
            scores = cls
            if cls.dim() == 3:  # the max over the class axis
                scores = cls.max(dim=-1).values
                if cls.shape[-1] > 1:
                    cls_labels = cls.argmax(dim=-1) + 1
            if not out.get("cls_preds_normalized", False):
                scores = torch.sigmoid(scores)
        else:
            boxes = decode_rcnn_boxes(out["rois"][..., :7], out["rcnn_reg"])
            scores = torch.sigmoid(out["rcnn_cls"])
        labels = out.get("roi_labels_sampled", out.get("roi_labels"))
        if labels is None:
            labels = cls_labels if cls_labels is not None else torch.ones_like(
                scores, dtype=torch.int32)
        labels = labels.to(torch.int32)
        scores = fused_scores(out, batch, scores, labels)
        roi_valid = out.get("roi_valid")
        if roi_valid is None:
            roi_valid = torch.ones_like(scores, dtype=torch.bool)
        # padded and suppressed RoI slots never surface as detections
        sel, sel_valid = nms_bev(boxes, scores, (scores > score_thresh) & roi_valid, thresh,
                                 min(post_max, boxes.shape[1]))
        return (torch.gather(boxes, 1, sel[..., None].expand(-1, -1, boxes.shape[-1])),
                torch.gather(scores, 1, sel), torch.gather(labels, 1, sel), sel_valid)

    return post_process


def make_stream_step(net, model_cfg, class_names, meta, device=None):
    """MPPNetE2E's streaming inference: a ``stream_step(batch, bank,
    is_first) -> ((boxes, scores, labels, valid), bank)`` over ``net``
    (``MPPNetE2E.stream_step``: the first stage, the bank started or
    rolled, the memory-bank head) and the two-stage post-processing, as
    ``make_eval_step``'s outputs.  ``batch`` holds the model's inputs (a
    frame's voxels, and its points with their timestamp last); ``bank`` is
    the previous step's (None on a sequence's first frame)."""
    dev = resolve_device(device)
    keys = model_input_keys(model_cfg)
    post = two_stage_post_process(model_cfg, class_names, dev)

    @torch.no_grad()
    def stream_step(batch, bank, is_first: bool):
        out, bank = net.stream_step({k: torch.as_tensor(batch[k], device=dev) for k in keys},
                                    bank, is_first)
        return post(out, batch), bank

    return stream_step


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


def _merge_shards(parts, n_total):
    """The ranks' frame lists (rank r's i-th frame is the padded order's
    i * world + r) back in dataset order, cut to the dataset's length."""
    if len({len(p) for p in parts}) != 1:
        raise ValueError(f"ranks evaluated unequal shards: {[len(p) for p in parts]} frames")
    return [frame for row in zip(*parts) for frame in row][:n_total]


def eval_model(eval_step, loader, class_names, logger=None, recall_thresh_list=(0.3, 0.5, 0.7),
               mesh=None):
    """Run ``eval_step(batch)`` (``make_eval_step``: the weights live in its
    model) over ``loader``.  Returns (det_annos, recall counts, seconds a
    frame): one anno a frame with its valid detections in descending score
    order (``np.argsort(-scores)`` on the host, as ``com_tpu``), "frame_id",
    "boxes_lidar", "score", "pred_labels", "name" and the batch's
    "metadata" where it has one; recall over the batches that carry
    "gt_boxes".

    ``mesh`` (a ``parallel.mesh.DataMesh``) evaluates data-parallel:
    ``loader`` is this rank's shard (``build_dataloader(dist=True)``: the
    dataset's order dealt out in turn, padded by wrapping to equal
    lengths).  Every rank then returns the whole dataset's det_annos in
    its order, the padding's duplicates dropped, as pcdet's
    ``merge_results_dist``; the recall counts are summed over the ranks,
    the duplicates' left out; seconds a frame are the rank's."""
    rank, world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
    if world > 1:
        shard = (getattr(loader, "process_index", None), getattr(loader, "process_count", None))
        if shard != (rank, world):
            raise ValueError(f"eval_model over a mesh of {world} needs rank {rank}'s loader "
                             f"shard, got (index, count) {shard}")
        n_total = len(loader.dataset)
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
            padding = world > 1 and (len(det_annos) - 1) * world + rank >= n_total
            if "gt_boxes" in batch and not padding:
                r = recall_stats(frame_boxes, batch["gt_boxes"][i], recall_thresh_list)
                for k in recalls:
                    recalls[k] += r[k]
    sec_per_example = (time.time() - t0) / max(n_frames, 1)
    if world > 1:
        det_annos = _merge_shards(gather_objects(det_annos, mesh), n_total)
        counts = torch.tensor([recalls[k] for k in recalls], dtype=torch.int64,
                              device=mesh.device)
        all_reduce_(counts, mesh=mesh)
        recalls = dict(zip(recalls, counts.tolist()))
        logger = logger if rank == 0 else None
    if logger:
        gt = max(recalls["gt"], 1)
        logger.info("eval: %d frames, %.4f s/frame, " % (n_frames, sec_per_example)
                    + " ".join(f"{k}={recalls[k] / gt:.3f}" for k in recalls if k != "gt"))
    return det_annos, recalls, sec_per_example
