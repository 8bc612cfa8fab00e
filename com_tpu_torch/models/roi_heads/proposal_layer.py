"""Two-stage proposal layer (counterpart of ``com_tpu/models/roi_heads/
proposal_layer.py``; pcdet roi_head_template.py proposal_layer): the top
``nms_pre`` candidates by score, rotated-BEV NMS over the whole batch in
one call (K4), a fixed ``nms_post`` RoIs a scene."""
from __future__ import annotations

import torch

from ...ops.nms import fast_nms_bev, nms_bev
from ..dense_heads.anchor_head import top_candidates


def take_rows(x, idx):
    """x (B, N) or (B, N, D) at idx (B, K) -> (B, K) or (B, K, D)."""
    if x.dim() == idx.dim():
        return torch.gather(x, 1, idx)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def proposal_layer(boxes, scores, labels, nms_pre: int = 4096, nms_post: int = 512,
                   nms_thresh: float = 0.8, use_fast_nms: bool = False):
    """boxes (B, N, 7+), scores (B, N) (-inf marks a candidate that is not
    one; only the ranking matters), labels (B, N) int32.  The top
    ``nms_pre`` by score with ties to the lower index (``lax.top_k``), then
    ``nms_bev`` (or ``fast_nms_bev`` with ``use_fast_nms``).  Returns (rois
    (B, P, 7+), roi_scores (B, P), roi_labels (B, P), roi_valid (B, P)),
    P = ``nms_post``, each slot multiplied by its validity as the JAX
    package's (a suppressed slot's -inf score becomes NaN there too)."""
    nms_pre = min(nms_pre, boxes.shape[1])
    top, idx = top_candidates(scores, nms_pre)
    bb, ll = take_rows(boxes, idx), take_rows(labels, idx)
    nms = fast_nms_bev if use_fast_nms else nms_bev
    sel, sel_valid = nms(bb[..., :7], top, torch.isfinite(top), nms_thresh, nms_post)
    f = sel_valid.to(boxes.dtype)
    return (take_rows(bb, sel) * f[..., None], take_rows(top, sel) * f, take_rows(ll, sel) * sel_valid,
            sel_valid)
