"""Batched inference step (counterpart of ``com_tpu/train/eval.py``
``make_eval_step``, CenterPoint branch): forward -> per-head top-K decode ->
NMS, all on the device, fixed shapes with validity masks."""
from __future__ import annotations

import torch

from ..models.dense_heads.center_head import decode_center_boxes, post_process_nms
from ..utils.device import resolve_device


def _head_groups(model_cfg, class_names):
    return [tuple(class_names.index(n) + 1 for n in names if n in class_names)
            for names in model_cfg["DENSE_HEAD"]["CLASS_NAMES_EACH_HEAD"]]


def make_eval_step(net, model_cfg, class_names, meta, device=None):
    """An ``eval_step(batch) -> (boxes, scores, labels, valid)`` over ``net``.

    ``batch`` holds "points" (B, N, F) and "points_mask" (B, N), as numpy
    arrays or tensors; they move to ``device`` (CUDA unless the caller passes
    another).  Outputs are tensors on that device: boxes (B, P, 7), scores
    and labels (B, P), valid (B, P), P = NMS_POST_MAXSIZE per head, heads
    concatenated.  Unlike the JAX step, the weights live in ``net``.
    """
    if model_cfg.get("ROI_HEAD") is not None:
        raise NotImplementedError("two-stage eval is not ported yet")
    head_cfg = model_cfg["DENSE_HEAD"]
    if "ANCHOR_GENERATOR_CONFIG" in head_cfg:
        raise NotImplementedError("anchor-head eval is not ported yet")
    dev = resolve_device(device)
    post = head_cfg["POST_PROCESSING"]
    stride = int(head_cfg["TARGET_ASSIGNER_CONFIG"].get("FEATURE_MAP_STRIDE", 1))
    groups = _head_groups(model_cfg, list(class_names))
    nms_cfg = post["NMS_CONFIG"]

    @torch.no_grad()
    def eval_step(batch):
        inputs = {k: torch.as_tensor(batch[k], device=dev) for k in ("points", "points_mask")}
        out = net(inputs)
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
