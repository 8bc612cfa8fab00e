"""Where the anchor head's loss stage spends its time, on the card.

At ``chip_smoke.py`` path E's shapes (KITTI PointPillars, batch 4, 321,408
anchors, 128 object slots with ~40 real objects a scene, predictions from
the full-width model with seeded random weights): CUDA-event times of the
parts of ``train.step.compute_anchor_loss`` (the axis-aligned assignment,
the per-(class, group) confidence sums, the focal loss, the box and
direction losses, the whole loss, its backward into the head's outputs),
means over ``--iters`` calls after a warm-up; then torch.profiler's kernel
table over one loss and its backward.

    python -m com_tpu_torch.tools.perf.anchor_loss [--iters N] [--curriculum]

Run it from a checkout's root (it reads the configs and ``chip_smoke.py``'s
scene generator there).  It needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def timed(fn, iters):
    """Mean ms a call of ``fn`` on the card (CUDA events), after one call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    import chip_smoke
    from com_tpu_torch.losses.anchor_losses import (anchor_group_confidences,
                                                    sigmoid_focal_loss)
    from com_tpu_torch.models.dense_heads.anchor_assign import assign_anchor_targets
    from com_tpu_torch.models.dense_heads.anchor_head import reshape_anchor_preds
    from com_tpu_torch.models.detectors import build_network
    from com_tpu_torch.train.step import AnchorSet, com_groups_for, compute_anchor_loss

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--curriculum", action="store_true",
                        help="with path E's LOSS_CURRICULUM (COM groups on the objects)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("anchor_loss times the card: it needs a CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg, meta = chip_smoke.load_kitti()
    cfg.MODEL.VFE.ASSUME_SORTED_POINTS = True
    if args.curriculum:
        cfg.MODEL.DENSE_HEAD.LOSS_CURRICULUM = dict(chip_smoke.E_CURRICULUM)
    names = list(cfg.CLASS_NAMES)
    batch = chip_smoke.kitti_like_batch(np.random.RandomState(22), chip_smoke.E_BATCH,
                                        meta.point_cloud_range, meta.voxel_size)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    net = build_network(cfg.MODEL, meta, device=dev, seed=0).train()
    out = net({k: batch[k] for k in ("points", "points_mask")})
    raw = {k: out[k].detach().requires_grad_() for k in
           ("cls_preds_raw", "box_preds_raw", "dir_cls_preds_raw")}
    anchors = AnchorSet(cfg.MODEL, names, meta, dev)
    gt = batch["gt_boxes"]
    is_cur = args.curriculum
    group = com_groups_for(batch, gt, is_cur, names)
    state = ()

    def assign():
        return assign_anchor_targets(anchors.anchors, anchors.per_class_index, gt, group,
                                     anchors.class_ids, anchors.matched, anchors.unmatched,
                                     anchors.coder)

    targets = assign()
    cls_flat, _, _ = reshape_anchor_preds(raw, len(names))
    labels = targets.box_cls_labels
    one_hot = torch.nn.functional.one_hot(labels.clamp(min=0).long(), len(names) + 1)[..., 1:]
    groups_oh = one_hot.to(torch.int32) * targets.groups[..., None]
    weights = (labels >= 0).float()

    def loss():
        return compute_anchor_loss({**batch, **raw}, cfg.MODEL, names, meta, state, 0, anchors)

    def loss_backward():
        total = loss()[0]
        torch.autograd.grad(total, list(raw.values()))

    parts = {
        "assign": assign,
        "group_confidences": lambda: anchor_group_confidences(torch.sigmoid(cls_flat),
                                                              groups_oh, len(names)),
        "focal": lambda: sigmoid_focal_loss(cls_flat, one_hot.float(), weights).sum(),
        "loss": loss,
        "loss_and_backward": loss_backward,
    }
    with torch.no_grad():
        ms = {k: timed(v, args.iters) for k, v in parts.items() if k != "loss_and_backward"}
    ms["loss_and_backward"] = timed(loss_backward, args.iters)
    print(f"anchor loss parts, ms a call (mean of {args.iters}; batch {chip_smoke.E_BATCH}, "
          f"{anchors.anchors.shape[0]} anchors, {int((gt[..., 7] > 0).sum())} objects, "
          f"curriculum {is_cur}): {json.dumps({k: round(v, 3) for k, v in ms.items()})} ({smi})")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loss_backward()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=20))


if __name__ == "__main__":
    main()
