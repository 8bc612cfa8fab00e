"""CenterPoint target assignment and COM difficulty clustering, batched.

Counterpart of ``com_tpu/models/dense_heads/target_assign.py``
(curriculum_center_head.py:119-308 ``assign_target_of_single_head`` and
``cluster`` at :431-473): fixed shapes over the NUM_MAX_OBJS-padded objects,
on the device, no per-object loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops.gaussian import draw_gaussians_batched, gaussian_radius


class CenterTargets(NamedTuple):
    heatmaps: torch.Tensor      # (B, H, W, C) f32
    target_boxes: torch.Tensor  # (B, M, 8+)
    inds: torch.Tensor          # (B, M) int64 flat y*W+x, 0 on invalid slots
    mask: torch.Tensor          # (B, M) float 0/1
    center_int: torch.Tensor    # (B, M, 2) int32 [x, y]
    radius: torch.Tensor        # (B, M) int32
    class_local: torch.Tensor   # (B, M) int64 class id within the head
    group: torch.Tensor         # (B, M) int32 COM difficulty group (0 = none)
    class_global: torch.Tensor  # (B, M) int64 global 0-based class (confidence rows)


def cluster_com_groups(gt_boxes, true_object, occupancy_ratio, facade_type, vehicle_ids=(1,)):
    """Per-object COM difficulty group ids (curriculum_center_head.py:431-473).

    Vehicle-like classes (global 1-based ids in ``vehicle_ids``): 3 distance
    x 2 length x 4 facade x 4 occupancy = 96 groups; the others 3 distance x
    5 occupancy = 15.  Only true (not pasted) objects get a group; the rest
    get 0.  Occupancy bins run from high to low (easy to hard)."""
    x, y = gt_boxes[..., 0], gt_boxes[..., 1]
    class_id = gt_boxes[..., -1].to(torch.int32)
    dist = torch.sqrt(x * x + y * y)
    dist_bin = torch.where(dist <= 30, 0, torch.where(dist <= 50, 1, 2))
    length_bin = torch.where(gt_boxes[..., 3] <= 6, 0, 1)
    facade_bin = 3 - facade_type.to(torch.int32)  # facade 3 -> 0, ..., 0 -> 3

    def bin_desc(v, ths):  # bin 0 above the top threshold, thresholds descending
        b = torch.zeros_like(v, dtype=torch.int32)
        for t in ths:
            b = b + (v <= t).to(torch.int32)
        return b

    occ_car = bin_desc(occupancy_ratio, [0.7, 0.5, 0.25])
    s = 5.0 / 12.0
    occ_pc = bin_desc(occupancy_ratio, [0.81 * s, 0.61 * s, 0.41 * s, 0.21 * s])
    car_group = ((dist_bin * 2 + length_bin) * 4 + facade_bin) * 4 + occ_car + 1
    pc_group = dist_bin * 5 + occ_pc + 1

    is_vehicle = torch.zeros_like(class_id, dtype=torch.bool)
    for vid in vehicle_ids:
        is_vehicle = is_vehicle | (class_id == int(vid))
    group = torch.where(is_vehicle, car_group, pc_group)
    is_true = true_object.to(torch.int32) == 1
    valid_facade = (facade_bin >= 0) & (facade_bin <= 3)
    group = torch.where(is_true & (~is_vehicle | valid_facade), group, 0)
    return group.to(torch.int32)


def assign_centerpoint_targets(gt_boxes, npgt, group, class_ids_of_head, fmap_h, fmap_w,
                               point_cloud_range, voxel_size, feature_map_stride,
                               gaussian_overlap=0.1, min_radius=2, min_points=0,
                               epoch_gate=True) -> CenterTargets:
    """Single-head target assignment over (B, M, 8+) boxes whose last column
    is the 1-based class id (0 pads).  Same coordinate clamping (in f32,
    before the int cast), radius formula and clamping, and regression
    encoding (offset, z, log-dims, cos/sin) as the JAX package; the
    heatmap is exactly 1.0 at every valid center."""
    num_classes = len(class_ids_of_head)
    b, m = gt_boxes.shape[:2]
    dtype, dev = gt_boxes.dtype, gt_boxes.device

    gclass = gt_boxes[..., -1].to(torch.int32)
    local = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    for li, gc in enumerate(class_ids_of_head):
        local = torch.where(gclass == gc, li, local)
    handled = local >= 0

    x, y, z = gt_boxes[..., 0], gt_boxes[..., 1], gt_boxes[..., 2]
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    x0, y0 = float(point_cloud_range[0]), float(point_cloud_range[1])
    coord_x = torch.clamp((x - x0) / vx / feature_map_stride, 0, fmap_w - 0.5)
    coord_y = torch.clamp((y - y0) / vy / feature_map_stride, 0, fmap_h - 0.5)
    center = torch.stack([coord_x, coord_y], dim=-1)
    center_int = center.to(torch.int32)

    dx = gt_boxes[..., 3] / vx / feature_map_stride
    dy = gt_boxes[..., 4] / vy / feature_map_stride
    radius = gaussian_radius(dy, dx, min_overlap=gaussian_overlap)
    radius = torch.clamp(radius.to(torch.int32), min=min_radius)

    valid = handled & (dx > 0) & (dy > 0)
    if min_points > 0:
        gate = torch.as_tensor(epoch_gate, device=dev)
        valid = valid & torch.where(gate, npgt >= min_points, True)

    heatmaps = draw_gaussians_batched(center_int, radius, torch.clamp(local, min=0), valid,
                                      num_classes, fmap_h, fmap_w)
    heatmaps = heatmaps.permute(0, 2, 3, 1)  # NHWC

    inds = center_int[..., 1].long() * fmap_w + center_int[..., 0].long()
    mask = valid.to(dtype)
    parts = [center - center_int.to(dtype), z[..., None],
             torch.log(torch.clamp(gt_boxes[..., 3:6], min=1e-4)),
             torch.cos(gt_boxes[..., 6:7]), torch.sin(gt_boxes[..., 6:7])]
    if gt_boxes.shape[-1] > 8:  # extra regression channels, e.g. velocity
        parts.append(gt_boxes[..., 7:-1])
    target_boxes = torch.cat(parts, dim=-1) * mask[..., None]
    vi = valid.to(torch.int32)
    return CenterTargets(
        heatmaps=heatmaps,
        target_boxes=target_boxes,
        inds=torch.where(valid, inds, 0),
        mask=mask,
        center_int=center_int,
        radius=radius * vi,
        class_local=(torch.clamp(local, min=0) * vi).long(),
        group=group.to(torch.int32) * vi,
        class_global=(torch.clamp(gclass - 1, min=0) * vi).long(),
    )
