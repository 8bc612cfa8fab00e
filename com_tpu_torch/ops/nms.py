"""Rotated-BEV NMS, per-class NMS, fast NMS and circle NMS with fixed
shapes, batched (kernel K4 for the greedy ones).

Counterpart of ``com_tpu/ops/nms.py`` and ``com_tpu/ops/pallas/
nms_kernel.py``.  The pairwise IoU (or distance) matrix is built with
library ops, in blocks of 512 rows of one sample past 1,024 candidates
(``_self_iou``); the sequential greedy pass is ``greedy_suppress``, the
registered op ``com_tpu_torch::greedy_suppress`` (so that ``torch.export``
traces the eval step through it), which launches the CUDA kernel
(``csrc/nms.cu``) for CUDA tensors and runs ``greedy_suppress_plain`` for
CPU tensors.  Outputs are padded to a fixed size with validity masks.  The
JAX package vmaps its per-sample functions; here the batch axis is written
out: boxes are (B, K, 7).
"""
from __future__ import annotations

import functools
import math

import torch

from . import _kernels
from .iou import boxes_iou_aligned_bev, boxes_iou_bev

launches = 0  # K4 launches by greedy_suppress since the last reset

_packed: dict[tuple[int, int, int], torch.Tensor] = {}  # (stream, B, K) -> K4's bit rows


@functools.cache
def max_candidates() -> int:
    """The most candidates K4 takes (``csrc/nms.cu`` ``k4_max_candidates``)."""
    return int(_kernels.library("nms").k4_max_candidates())


def _scratch(b: int, k: int, index: int) -> torch.Tensor:
    """The (B, K, ceil(K / 64) | 1) int64 bit rows the pack writes and the
    sweep reads, allocated once for each (stream, B, K) on CUDA device
    ``index``: the calls of one stream run in order, so they can share it."""
    key = (torch._C._cuda_getCurrentRawStream(index), b, k)
    rows = _packed.get(key)
    if rows is None:
        rows = _packed[key] = torch.empty((b, k, -(-k // 64) | 1), dtype=torch.int64,
                                          device=torch.device("cuda", index))
    return rows


def greedy_suppress_plain(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the greedy loop of ``ops/nms.py`` over the
    batch at once."""
    k = over.shape[-1]
    later = torch.arange(k, device=over.device)
    suppressed = ~valid
    keep = torch.zeros_like(valid)
    for i in range(k):
        alive = ~suppressed[:, i] & valid[:, i]
        keep[:, i] = alive
        suppressed = suppressed | (alive[:, None] & (later > i)[None, :] & over[:, i, :])
    return keep


@torch.library.custom_op("com_tpu_torch::greedy_suppress", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _greedy_suppress_op(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K4 as a registered op: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if over.device.type == "cpu":
        return greedy_suppress_plain(over, valid)
    shape = over.shape
    if len(shape) != 3 or shape[1] != shape[2] or valid.shape != shape[:2]:
        raise ValueError(f"greedy_suppress: over {tuple(shape)}, valid {tuple(valid.shape)}")
    if over.dtype != torch.bool or valid.dtype != torch.bool:
        raise TypeError("greedy_suppress: over and valid must be bool")
    index = over.get_device()
    if valid.get_device() != index or not (over.is_contiguous() and valid.is_contiguous()):
        raise ValueError("greedy_suppress: over and valid must be contiguous on one device")
    b, k = shape[:2]
    if k > max_candidates():
        raise ValueError(f"greedy_suppress: K={k} candidates, K4 takes at most "
                         f"{max_candidates()}")
    keep = torch.empty_like(valid)
    if keep.numel() == 0:
        return keep
    _kernels.launch("nms", "k4_greedy_suppress", "greedy_suppress (K4)", index, over.data_ptr(),
                    valid.data_ptr(), keep.data_ptr(), _scratch(b, k, index).data_ptr(), b, k)
    global launches
    launches += 1
    return keep


@_greedy_suppress_op.register_fake
def _(over, valid):
    return torch.empty_like(valid)


def greedy_suppress(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy keep mask over score-sorted candidates.

    Args:
        over: (B, K, K) bool, over[b, i, j]: candidate i suppresses j.
        valid: (B, K) bool.

    Returns:
        (B, K) bool: candidate i is valid and no earlier kept candidate
        suppresses it.
    """
    _kernels.check_device("greedy_suppress", over)
    return _greedy_suppress_op(over, valid)


def _score_order(scores, valid):
    """Descending score order with the tie order of
    ``jnp.argsort(...)[::-1]``: among equal keys the higher index first."""
    neg_inf = torch.full_like(scores, -math.inf)
    key = torch.where(valid, scores, neg_inf)
    return torch.argsort(key, dim=-1, stable=True).flip(-1)


def _kept_slots(keep, order, post_max_size):
    """Kept candidates in score order, padded to post_max_size.  Returns
    (selected (B, P) indices into the unsorted candidates, sel_valid)."""
    b, k = keep.shape
    kept_rank = torch.where(keep, torch.cumsum(keep.to(torch.int64), dim=-1) - 1,
                            torch.full_like(order, k))
    # ranks at or past post_max_size are dropped into a spare last column
    dst = torch.where(kept_rank < post_max_size, kept_rank,
                      torch.full_like(kept_rank, post_max_size))
    slots = torch.full((b, post_max_size + 1), k, dtype=torch.int64, device=keep.device)
    slots.scatter_(1, dst, torch.arange(k, device=keep.device).expand(b, k))
    slots = slots[:, :post_max_size]
    sel_valid = slots < k
    selected = torch.gather(order, 1, torch.clamp(slots, 0, k - 1))
    count = keep.sum(dim=-1, keepdim=True)
    return selected, sel_valid & (torch.arange(post_max_size, device=keep.device) < count)


def _self_iou(sb, use_rotated_iou: bool = True, row_block: int = 512):
    """(B, K, K) IoU of each sample's boxes with themselves.  Past 1,024
    candidates, when ``row_block`` divides K, it is built ``row_block`` rows
    of one sample at a time (``com_tpu/ops/nms.py`` ``_self_iou``): the
    rotated clip's (rows, K, 24, 2) intermediates of a whole (4, 4096)
    batch would take gigabytes each."""
    k = sb.shape[1]
    f = boxes_iou_bev if use_rotated_iou else boxes_iou_aligned_bev
    if k <= 1024 or k % row_block != 0:
        return f(sb, sb)
    out = torch.empty((sb.shape[0], k, k), dtype=sb.dtype, device=sb.device)
    for b in range(sb.shape[0]):
        for r in range(0, k, row_block):
            out[b, r:r + row_block] = f(sb[b, r:r + row_block], sb[b])
    return out


def _sorted(boxes, scores, valid):
    """The score order and the boxes and validity in it."""
    order = _score_order(scores, valid)
    sb = torch.gather(boxes, 1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    return order, sb, torch.gather(valid, 1, order)


def nms_bev(boxes, scores, valid, thresh: float, post_max_size: int,
            use_rotated_iou: bool = True):
    """Rotated-BEV NMS (nms_gpu semantics: sort by score, suppress by BEV IoU
    > thresh).  boxes (B, K, 7+), scores (B, K), valid (B, K) bool.
    Returns (selected (B, post_max_size), sel_valid (B, post_max_size))."""
    order, sb, sv = _sorted(boxes, scores, valid)
    over = _self_iou(sb, use_rotated_iou) > thresh
    keep = greedy_suppress(over.contiguous(), sv.contiguous())
    return _kept_slots(keep, order, post_max_size)


def multi_class_nms_bev(boxes, scores, labels, valid, num_classes: int, thresh: float,
                        post_max_size: int):
    """Per-class rotated NMS (model_nms_utils.multi_classes_nms): one score
    sort and one IoU matrix, cross-class pairs masked out of it, one greedy
    pass (K4) over candidates with a class; then the top ``post_max_size``
    kept by score overall (ties to the lower index, as ``lax.top_k``).
    ``num_classes`` is the JAX signature's; the labels carry the classes.
    Returns (selected (B, P) indices into the candidates, sel_valid)."""
    order, sb, sv = _sorted(boxes, scores, valid)
    sl = torch.gather(labels, 1, order)
    iou = _self_iou(sb)
    iou_cls = torch.where(sl[:, :, None] == sl[:, None, :], iou, torch.zeros_like(iou))
    keep_sorted = greedy_suppress((iou_cls > thresh).contiguous(), (sv & (sl > 0)).contiguous())
    kept = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    keep_scores = torch.where(kept, scores, torch.full_like(scores, -math.inf))
    k = scores.shape[1]
    if k < post_max_size:  # pad with -inf to post_max_size candidates
        keep_scores = torch.cat([keep_scores, keep_scores.new_full(
            (scores.shape[0], post_max_size - k), -math.inf)], dim=1)
    top, idx = torch.sort(keep_scores, dim=-1, descending=True, stable=True)
    return torch.clamp(idx[:, :post_max_size], 0, k - 1), torch.isfinite(top[:, :post_max_size])


def fast_nms_bev(boxes, scores, valid, thresh: float, post_max_size: int):
    """One-shot NMS (YOLACT's "fast NMS", ``NMS_TYPE: fast_nms``): a box is
    kept iff no higher-scoring valid box overlaps it by BEV IoU > thresh,
    whether or not that box is kept itself; no sequential pass, so no K4.
    boxes (B, K, 7+), scores (B, K), valid (B, K) bool.  Returns
    (selected, sel_valid) as ``nms_bev``; kept ranks past post_max_size,
    and the slots past the kept count when post_max_size > K, are invalid."""
    order, sb, sv = _sorted(boxes, scores, valid)
    k = sb.shape[1]
    higher = torch.ones((k, k), dtype=torch.bool, device=sb.device).triu(1)  # [i, j]: i before j
    suppressed = ((_self_iou(sb) > thresh) & higher & sv[:, :, None]).any(dim=1)
    return _kept_slots(sv & ~suppressed, order, post_max_size)


def circle_nms(centers_xy, scores, valid, dist_thresh: float, post_max_size: int):
    """Center-distance NMS: suppress while dist^2 <= thresh.  centers_xy
    (B, K, 2).  Returns (selected, sel_valid) as nms_bev."""
    order = _score_order(scores, valid)
    sc = torch.gather(centers_xy, 1, order[..., None].expand(-1, -1, 2))
    sv = torch.gather(valid, 1, order)
    d2 = ((sc[:, :, None, :] - sc[:, None, :, :]) ** 2).sum(dim=-1)
    over = -d2 > (-float(dist_thresh) - 1e-12)
    keep = greedy_suppress(over.contiguous(), sv.contiguous())
    return _kept_slots(keep, order, post_max_size)
