"""The train step for CenterPoint, anchor-head and two-stage detectors
(counterpart of ``com_tpu/train/step.py``, its CenterPoint, anchor, RoI
and point-head branches).

One call runs forward, target assignment, the CenterNet, anchor or COM
losses (or none, for PointRCNN, which has no dense head), the RoI and
point-head losses of the two-stage detectors, backward, the optimizer
update and the on-device accumulation of the per-(class, group) confidence
statistics, with no sync with the host.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import numpy as np

from ..losses.anchor_losses import (AnchorCurriculumState, anchor_group_confidences,
                                    curriculum_sigmoid_focal_loss, sigmoid_ce_with_logits,
                                    sigmoid_focal_loss, weighted_cross_entropy,
                                    weighted_smooth_l1)
from ..losses.centernet import focal_loss_centernet, reg_loss_centernet, sigmoid_clamped
from ..losses.curriculum import CurriculumAux, focal_loss_center_curriculum, group_confidences
from ..models.dense_heads.anchor_assign import assign_anchor_targets, atss_assign_targets
from ..models.dense_heads.anchor_head import box_coder_for, build_anchors, reshape_anchor_preds
from ..models.dense_heads.point_head import (point_head_box_loss, point_head_loss,
                                             point_part_loss)
from ..models.dense_heads.target_assign import assign_centerpoint_targets, cluster_com_groups
from ..models.detectors import detector_class
from ..models.roi_heads.roi_targets import decode_rcnn_boxes
from ..models.roi_heads.second_head import second_iou_loss
from ..ops.boxes import corner_loss
from ..parallel.sharding import active_mesh, global_sum, reduce_gradients
from .state import check_same_device

_VEHICLE_NAMES = ("vehicle", "car", "truck", "bus", "van", "trailer", "construction_vehicle")
BATCH_KEYS = ("points", "points_mask", "gt_boxes", "num_points_in_gt", "true_object",
              "occupancy_ratio", "facade_type")
GT_KEYS = frozenset({"gt_boxes", "num_points_in_gt", "true_object", "occupancy_ratio",
                     "facade_type"})


def device_batch_keys(model_cfg) -> set:
    """The batch keys the model and loss read (counterpart of
    ``com_tpu/train/step.py`` ``device_batch_keys``): ``DevicePrefetcher``
    copies only these to the device, and the rest of a collated batch
    (voxels, frame ids, the augmentations' parameters) stays on the host."""
    keys = set(GT_KEYS)
    declared = getattr(detector_class(model_cfg), "input_keys", None)
    if declared is not None:
        # a detector that names what it reads (MPPNet: a first stage's boxes,
        # scores and labels a frame, and the points).  The JAX package's eval
        # step feeds the model the whole batch, and its function gives MPPNet
        # the voxel keys instead; this port's steps filter the batch
        return keys | declared
    vfe = model_cfg.get("VFE", {}).get("NAME", "")
    if model_cfg.get("BACKBONE_3D", {}).get("NAME") == "PointNet2MSG":
        # PointRCNN's point backbone reads the raw points.  The JAX package's
        # function gives it the voxel keys instead (so its train CLI cannot
        # initialise it); its step does not filter the batch, this port's
        # does
        keys |= {"points", "points_mask"}
    elif vfe.startswith("Dynamic") or model_cfg.get("VFE", {}).get("VOXELIZE_ON_DEVICE"):
        keys |= {"points", "points_mask"}
    elif vfe == "ImageVFE":
        keys |= {"images", "depth_maps", "trans_lidar_to_cam", "trans_cam_to_img", "gt_boxes2d",
                 "image_shape"}
    else:
        keys |= {"voxels", "voxel_coords", "voxel_num_points"}
    if model_cfg.get("PFE") is not None:  # keypoint abstraction reads raw points
        keys |= {"points", "points_mask"}
    if str((model_cfg.get("ROI_HEAD") or {}).get("NAME", "")).startswith("MPPNet"):
        # MPPNet's head crops the points around its RoIs (the JAX package's
        # eval step feeds the model the whole batch and its function omits them)
        keys |= {"points", "points_mask"}
    if model_cfg.get("BACKBONE_3D", {}).get("USE_IMG"):
        keys |= {"images", "image_shape", "trans_lidar_to_cam", "trans_cam_to_img", "noise_rot",
                 "noise_scale", "flip_x", "flip_y"}
    nms_cfg = dict(model_cfg.get("POST_PROCESSING", {}).get("NMS_CONFIG", {}))
    nms_cfg.update(nms_cfg.get("TEST", {}))
    if model_cfg.get("ROI_HEAD") is not None and nms_cfg.get("SCORE_TYPE") == "num_pts_iou_cls":
        keys |= {"points", "points_mask"}  # the two-stage eval counts points in its boxes
    return keys


def model_input_keys(model_cfg) -> set:
    """The batch keys the model itself reads: ``device_batch_keys`` less
    the ground truth (the eval step's inputs)."""
    return device_batch_keys(model_cfg) - GT_KEYS


def _head_groups(model_cfg, class_names):
    return [tuple(class_names.index(n) + 1 for n in names if n in class_names)
            for names in model_cfg["DENSE_HEAD"]["CLASS_NAMES_EACH_HEAD"]]


def vehicle_class_ids(class_names):
    """Global 1-based ids of the classes that use the 96-group vehicle
    scheme (case-insensitive: Waymo's Vehicle, KITTI's Car, nuScenes' car)."""
    return tuple(i + 1 for i, n in enumerate(class_names) if str(n).lower() in _VEHICLE_NAMES)


def conf_shape_for(model_cfg, class_names):
    """(num_class, num_groups) of the curriculum confidence tensor: 96 groups
    with a vehicle-like class or several classes, else 15."""
    n = len(class_names)
    return (n, 96 if (vehicle_class_ids(class_names) or n > 1) else 15)


def com_groups_for(batch, gt_boxes, is_cur, class_names):
    """Per-object COM group ids, or zeros when the curriculum is off or the
    batch has no COM side arrays."""
    if is_cur and "true_object" in batch:
        zeros = torch.zeros(gt_boxes.shape[:2], dtype=gt_boxes.dtype, device=gt_boxes.device)
        return cluster_com_groups(gt_boxes, batch["true_object"],
                                  batch.get("occupancy_ratio", zeros),
                                  batch.get("facade_type", zeros),
                                  vehicle_ids=vehicle_class_ids(class_names) or (-1,))
    return torch.zeros(gt_boxes.shape[:2], dtype=torch.int32, device=gt_boxes.device)


def compute_centerpoint_loss(batch, model_cfg, class_names, meta, curriculum_states, epoch,
                             fmap_hw):
    """Loss over all head groups.  Returns (loss, new_states, aux_list, tb).
    The heatmap's own size is authoritative over ``fmap_hw``."""
    head_cfg = model_cfg["DENSE_HEAD"]
    ta_cfg = head_cfg["TARGET_ASSIGNER_CONFIG"]
    lw = head_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    stride = int(ta_cfg.get("FEATURE_MAP_STRIDE", 1))
    curriculum_cfg = head_cfg.get("LOSS_CURRICULUM", None)
    is_cur = curriculum_cfg is not None
    num_class, num_groups = conf_shape_for(model_cfg, class_names)
    hm0 = batch["pred_dicts"][0]["hm"]
    fmap_h, fmap_w = int(hm0.shape[1]), int(hm0.shape[2])

    gt_boxes = batch["gt_boxes"]
    npgt = batch.get("num_points_in_gt", torch.zeros(gt_boxes.shape[:2], device=gt_boxes.device))
    group = com_groups_for(batch, gt_boxes, is_cur, class_names)
    head_order = tuple(head_cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"])
    code_w = torch.as_tensor(list(lw["code_weights"]), dtype=torch.float32, device=hm0.device)

    total = 0.0
    new_states, aux_list, tb = [], [], {}
    for idx, (pred_dict, class_ids) in enumerate(zip(batch["pred_dicts"],
                                                     _head_groups(model_cfg, class_names))):
        targets = assign_centerpoint_targets(
            gt_boxes, npgt, group, class_ids, fmap_h, fmap_w, meta.point_cloud_range,
            meta.voxel_size, stride, gaussian_overlap=float(ta_cfg.get("GAUSSIAN_OVERLAP", 0.1)),
            min_radius=int(ta_cfg.get("MIN_RADIUS", 2)), min_points=int(ta_cfg.get("MIN_POINTS", 0)),
            epoch_gate=int(epoch) <= int(ta_cfg.get("EPOCH_THRED", 100)))
        hm = sigmoid_clamped(pred_dict["hm"])
        if is_cur:
            hm_loss, new_state, aux = focal_loss_center_curriculum(
                hm, targets, curriculum_states[idx], curriculum_cfg, epoch, num_class, num_groups)
        else:
            hm_loss = focal_loss_centernet(hm, targets.heatmaps)
            new_state = curriculum_states[idx] if curriculum_states else None
            conf_sum, conf_cnt = group_confidences(hm, targets, num_class, num_groups)
            aux = CurriculumAux(conf_sum, conf_cnt, torch.zeros((), device=hm.device),
                                targets.mask)
        hm_loss = hm_loss * float(lw.get("cls_weight", 1.0))
        pred_boxes = torch.cat([pred_dict[n] for n in head_order], dim=-1)
        reg = reg_loss_centernet(pred_boxes, targets.inds, targets.target_boxes, aux.box_mask)
        loc_loss = (reg * code_w).sum() * float(lw.get("loc_weight", 2.0))
        total = total + hm_loss + loc_loss
        new_states.append(new_state)
        aux_list.append(aux)
        tb[f"hm_loss_head_{idx}"] = hm_loss
        tb[f"loc_loss_head_{idx}"] = loc_loss
        tb[f"confidence_head_{idx}"] = aux.avg_confidence
    return total, tuple(new_states), aux_list, tb


def is_anchor_head(model_cfg) -> bool:
    return "ANCHOR_GENERATOR_CONFIG" in model_cfg.get("DENSE_HEAD", {})


def curriculum_kwargs(model_cfg, class_names) -> dict:
    """``TrainState.create``'s curriculum arguments, as ``tools/train.py``
    chooses them: one state a head group for CenterPoint heads; for anchor
    heads one, of the anchor kind when the head has a ``LOSS_CURRICULUM``;
    without a dense head (PointRCNN) one center-kind state, which the step
    carries unchanged (as ``com_tpu``'s PointRCNN test creates its state)."""
    if model_cfg.get("DENSE_HEAD") is None:
        return {"num_head_groups": 1}
    if is_anchor_head(model_cfg):
        return {"num_head_groups": 1,
                "anchor_num_class": (len(class_names) if "LOSS_CURRICULUM" in
                                     model_cfg["DENSE_HEAD"] else None)}
    return {"num_head_groups": len(model_cfg["DENSE_HEAD"]["CLASS_NAMES_EACH_HEAD"])}


class AnchorSet:
    """A model's static anchors (``build_anchors``) as tensors on a device:
    ``anchors`` (A, 7), ``per_class_index`` [(A_c,) int64], the thresholds
    and class ids, and the box coder of its axis-aligned assigner (the ATSS
    assigner is not ported: it raises by name)."""

    def __init__(self, model_cfg, class_names, meta, device):
        head_cfg = model_cfg["DENSE_HEAD"]
        if head_cfg.get("TARGET_ASSIGNER_CONFIG", {}).get("NAME") == "ATSSTargetAssigner":
            atss_assign_targets()
        anchors, index, self.matched, self.unmatched, self.class_ids = build_anchors(
            head_cfg, list(class_names), meta.grid_size, meta.point_cloud_range)
        self.anchors = torch.as_tensor(anchors, device=device)
        self.per_class_index = [torch.as_tensor(i, dtype=torch.int64, device=device)
                                for i in index]
        self.coder = box_coder_for(head_cfg)


def compute_anchor_loss(batch, model_cfg, class_names, meta, curriculum_states, epoch,
                        anchor_set: AnchorSet):
    """Anchor-head loss (anchor_head_template get_loss and the curriculum
    variants): (curriculum) sigmoid focal over the (B, A, C) one-hot
    classes, smooth-L1 on the sin-difference box encoding and direction
    cross-entropy, both weighted by each anchor's curriculum weight.
    Returns (loss, new_states, aux_list, tb) as the CenterPoint loss."""
    head_cfg = model_cfg["DENSE_HEAD"]
    lw = head_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    curriculum_cfg = head_cfg.get("LOSS_CURRICULUM", None)
    is_cur = curriculum_cfg is not None
    num_class = len(class_names)
    _, num_groups = conf_shape_for(model_cfg, class_names)
    gt_boxes = batch["gt_boxes"]
    coder = anchor_set.coder
    group = com_groups_for(batch, gt_boxes, is_cur, class_names)
    targets = assign_anchor_targets(anchor_set.anchors, anchor_set.per_class_index, gt_boxes,
                                    group, anchor_set.class_ids, anchor_set.matched,
                                    anchor_set.unmatched, coder)
    cls_flat, box_flat, dir_flat = reshape_anchor_preds(batch, num_class,
                                                        code_size=coder.code_size)
    b = cls_flat.shape[0]

    labels = targets.box_cls_labels
    cared, positives, negatives = labels >= 0, labels > 0, labels == 0
    pos_norm = torch.clamp(positives.sum(dim=1, keepdim=True).to(torch.float32), min=1.0)
    cls_w = (negatives.to(torch.float32) + positives.to(torch.float32)) / pos_norm \
        * cared.to(torch.float32)
    one_hot = F.one_hot(torch.where(cared, labels, torch.zeros_like(labels)).long(),
                        num_class + 1)[..., 1:].to(torch.float32)
    groups_oh = one_hot.to(torch.int32) * targets.groups[..., None]  # groups in the class slot

    aux_states = []
    if is_cur:
        state0 = (curriculum_states[0] if curriculum_states
                  else AnchorCurriculumState.create(num_class, cls_flat.device))
        cls_src, cw, new_state, (conf_sum, conf_cnt) = curriculum_sigmoid_focal_loss(
            cls_flat, one_hot, cls_w, groups_oh, state0, curriculum_cfg, epoch,
            num_groups=num_groups)
        cw_anchor = cw.max(dim=-1).values  # one weight an anchor: the max over classes
        aux_states.append(new_state)
    else:
        cls_src = sigmoid_focal_loss(cls_flat, one_hot, cls_w)
        conf_sum, conf_cnt = anchor_group_confidences(torch.sigmoid(cls_flat), groups_oh,
                                                      num_class, num_groups)
        cw_anchor = torch.ones_like(cls_w)
        if curriculum_states:
            aux_states.append(curriculum_states[0])
    sums = {"rpn_loss_cls": (cls_src.sum(), float(lw.get("cls_weight", 1.0)))}

    # the sin-difference heading encoding (add_sin_difference)
    reg_t = targets.box_reg_targets
    p6, t6 = box_flat[..., 6:7], reg_t[..., 6:7]
    box_p = torch.cat([box_flat[..., :6], torch.sin(p6) * torch.cos(t6), box_flat[..., 7:]], -1)
    box_t = torch.cat([reg_t[..., :6], torch.cos(p6) * torch.sin(t6), reg_t[..., 7:]], -1)
    loc_src = weighted_smooth_l1(box_p, box_t, targets.reg_weights * cw_anchor,
                                 code_weights=lw.get("code_weights"))
    sums["rpn_loss_loc"] = (loc_src.sum(), float(lw.get("loc_weight", 2.0)))
    if dir_flat is not None:
        dir_offset = float(head_cfg.get("DIR_OFFSET", 0.78539))
        nbins = int(head_cfg.get("NUM_DIR_BINS", 2))
        off = reg_t[..., 6] + anchor_set.anchors[None, :, 6] - dir_offset
        off = off - torch.floor(off / (2 * math.pi)) * (2 * math.pi)
        dir_t = torch.clamp((off / (2 * math.pi / nbins)).to(torch.int32), 0, nbins - 1)
        dw = positives.to(torch.float32)
        dw = dw / torch.clamp(dw.sum(dim=-1, keepdim=True), min=1.0)
        dir_loss = weighted_cross_entropy(dir_flat, F.one_hot(dir_t.long(), nbins).to(
            torch.float32), dw * cw_anchor)
        sums["rpn_loss_dir"] = (dir_loss.sum(), float(lw.get("dir_weight", 0.2)))
    # each term is a mean over the scenes of every rank (pos_norm and the
    # direction weights above normalise a scene and stay local)
    *totals, b = global_sum(*(t for t, _ in sums.values()), b)
    tb = {k: t / b * w for (k, (_, w)), t in zip(sums.items(), totals)}
    total = tb["rpn_loss_cls"] + tb["rpn_loss_loc"]
    if "rpn_loss_dir" in tb:
        total = total + tb["rpn_loss_dir"]

    aux = CurriculumAux(conf_sum, conf_cnt, torch.zeros((), device=cls_flat.device),
                        targets.reg_weights)
    return total, tuple(aux_states), [aux], tb


def compute_roi_loss(batch, model_cfg):
    """Second-stage losses (roi_head_template.py:150-261): BCE on the
    IoU-derived soft class labels over the labelled RoIs, smooth-L1 on the
    canonical-frame targets of the foreground RoIs, and with
    CORNER_LOSS_REGULARIZATION the corner loss of the decoded foreground
    boxes against their GT.  Returns (loss, tb)."""
    loss_cfg = model_cfg.get("ROI_HEAD", {}).get("LOSS_CONFIG", {})
    lw = loss_cfg.get("LOSS_WEIGHTS", {})
    t = batch["roi_targets"]
    valid = (t.cls_labels >= 0).to(torch.float32)
    cls_loss = sigmoid_ce_with_logits(batch["rcnn_cls"], torch.clamp(t.cls_labels, 0.0, 1.0))
    cls_loss = (cls_loss * valid).sum() / torch.clamp(valid.sum(), min=1.0)
    cls_loss = cls_loss * float(lw.get("rcnn_cls_weight", 1.0))
    fg = t.reg_valid.to(torch.float32)
    fg_norm = torch.clamp(fg.sum(), min=1.0)
    reg_loss = weighted_smooth_l1(batch["rcnn_reg"], t.reg_targets, fg).sum() / fg_norm
    reg_loss = reg_loss * float(lw.get("rcnn_reg_weight", 1.0))
    tb = {"rcnn_loss_cls": cls_loss, "rcnn_loss_reg": reg_loss}
    total = cls_loss + reg_loss
    if loss_cfg.get("CORNER_LOSS_REGULARIZATION", False):
        rois = t.rois.reshape(-1, 7)
        reg = batch["rcnn_reg"].reshape(-1, batch["rcnn_reg"].shape[-1])
        per = corner_loss(decode_rcnn_boxes(rois, reg[:, :7]), t.gt_of_rois_src.reshape(-1, 7))
        c_loss = (per * fg.reshape(-1)).sum() / fg_norm
        c_loss = c_loss * float(lw.get("rcnn_corner_weight", 1.0))
        total = total + c_loss
        tb["rcnn_loss_corner"] = c_loss
    return total, tb


def step_generators(seed: int, step: int, device) -> dict:
    """The step's RoI-sampling and dropout generators on ``device``, seeded
    from (seed, step, stream) alone, as the JAX step folds the step into its
    key: a run is a pure function of its seed."""
    out = {}
    for stream, name in enumerate(("roi_sampling", "dropout")):
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence([int(seed), int(step), stream])
                          .generate_state(1, np.uint64)[0] >> np.uint64(1)))
        out[name] = g
    return out


PORTED_ROI_HEADS = ("VoxelRCNNHead", "SECONDHead", "PVRCNNHead", "PVRCNNPlusPlusHead",
                    "PointRCNNHead", "PartA2FCHead")
PORTED_POINT_HEADS = ("PointHeadSimple", "PointHeadBox", "PointIntraPartOffsetHead")


def make_train_step(net, model_cfg, class_names, meta, optimizer, fmap_hw, device=None,
                    stage_hook=None, seed: int = 17):
    """A ``train_step(state, batch, epoch) -> (state, metrics)`` over ``net``.

    The loss is ``compute_anchor_loss`` for a head with an
    ``ANCHOR_GENERATOR_CONFIG`` (its anchors built once, on the device), else
    ``compute_centerpoint_loss`` (which alone reads ``fmap_hw``).  ``batch``
    holds the ``device_batch_keys`` arrays (numpy or tensors); they move to the
    model's device.  The step updates ``state`` in place (model,
    optimizer, curriculum EMA, confidence accumulators) and returns it with
    device-side metrics.  ``device`` follows the entry-point rule: CUDA
    unless the caller passes another, and it must hold the model.
    ``train_step.loss_fn(state, batch, epoch)`` runs forward and loss only
    (it updates the norms' running statistics), for comparing gradients.
    ``stage_hook(name)``, when given, is called as each stage starts
    ("forward", "loss", "backward", "optimizer") and once at the end ("end").

    A two-stage model (``ROI_HEAD``: Voxel-RCNN's, SECOND-IoU's, the
    PV-RCNN family's, PointRCNN's or PartA2's head) adds ``compute_roi_loss`` or
    ``second_iou_loss`` to the first stage's, and with a ``POINT_HEAD``
    ``point_head_box_loss`` (PointHeadBox and PartA2-free's head:
    "point_loss_cls", "point_loss_box"), then ``point_part_loss``
    (PointIntraPartOffsetHead: "point_loss_part", and "point_loss_cls"
    without the box branch) or ``point_head_loss`` (PointHeadSimple:
    "point_loss_cls"); each step draws its RoI sampling and dropout from
    ``step_generators(seed, state.step)``.  Without a ``DENSE_HEAD``
    (PointRCNN) the first stage's loss is 0, the curriculum is carried
    unchanged and the confidence sums and counts are zeros of
    (num_class, 1), as in the JAX step.
    ``loss_fn(state, batch, epoch, rngs=None)`` takes the model's ``rngs``
    (none: deterministic RoI sampling).

    Under an active data mesh (``parallel.sharding.activate``) ``batch`` is
    the rank's shard: the norms' statistics, the loss, its terms and the
    curriculum EMA are the global batch's on every rank, the gradients are
    averaged over the ranks before the optimizer, and the confidence
    accumulators (and ``metrics``' confidence sums) hold the rank's own
    sums until ``train_model`` reduces them at the epoch's end.
    """
    head_cfg = model_cfg.get("DENSE_HEAD")
    ph_cfg = model_cfg.get("POINT_HEAD")
    if ph_cfg is not None and ph_cfg.get("NAME") not in PORTED_POINT_HEADS:
        raise NotImplementedError(f"the POINT_HEAD loss of {ph_cfg.get('NAME')} is not ported yet")
    reason = getattr(detector_class(model_cfg), "no_step_reason", None)
    if reason is not None:
        raise NotImplementedError(f"make_train_step does not train {model_cfg['NAME']}: {reason}")
    roi_cfg = model_cfg.get("ROI_HEAD")
    if roi_cfg is not None and roi_cfg.get("NAME") not in PORTED_ROI_HEADS:
        raise NotImplementedError(f"the ROI_HEAD loss of {roi_cfg.get('NAME')} is not ported yet")
    dev = check_same_device(net, device)
    class_names = list(class_names)
    hook = stage_hook or (lambda name: None)
    if head_cfg is None:  # point proposals (PointRCNN): no first-stage loss
        def compute_loss(out, curriculum, epoch):
            zero = torch.zeros((len(class_names), 1), device=dev)
            aux = CurriculumAux(zero, zero, torch.zeros((), device=dev),
                                torch.zeros((1, 1), device=dev))
            return torch.zeros((), device=dev), curriculum, [aux], {}
    elif is_anchor_head(model_cfg):
        anchor_set = AnchorSet(model_cfg, class_names, meta, dev)

        def compute_loss(out, curriculum, epoch):
            return compute_anchor_loss(out, model_cfg, class_names, meta, curriculum, epoch,
                                       anchor_set)
    else:
        def compute_loss(out, curriculum, epoch):
            return compute_centerpoint_loss(out, model_cfg, class_names, meta, curriculum,
                                            epoch, fmap_hw)

    if roi_cfg is not None:
        first_stage = compute_loss

        def compute_loss(out, curriculum, epoch):
            loss, new_cur, aux_list, tb = first_stage(out, curriculum, epoch)
            if "rcnn_cls" in out:  # refinement head
                roi_loss, roi_tb = compute_roi_loss(out, model_cfg)
                tb.update(roi_tb)
            else:  # IoU-scoring head
                roi_loss = tb["rcnn_loss_iou"] = second_iou_loss(
                    out, roi_cfg.get("LOSS_CONFIG", {}))
            loss = loss + roi_loss
            if "point_box_preds_raw" in out:  # PointHeadBox
                p_loss, p_tb = point_head_box_loss(out, ph_cfg)
                tb.update(p_tb)
                loss = loss + p_loss
            # not elif, in the JAX step's order: PartA2-free's head has both
            # a box branch and part offsets; its shared class logits take
            # their loss once, from the box loss
            if "point_part_logits" in out:  # PointIntraPartOffsetHead
                p_loss, p_tb = point_part_loss(out,
                                               include_cls="point_box_preds_raw" not in out)
                tb.update(p_tb)
                loss = loss + p_loss
            # else the keypoints' foreground (PointHeadSimple), for a head
            # whose logits no box loss trained
            elif "point_cls_scores_raw" in out and "point_box_preds_raw" not in out:
                p_loss = tb["point_loss_cls"] = point_head_loss(out)
                loss = loss + p_loss
            return loss, new_cur, aux_list, tb

    batch_keys = device_batch_keys(model_cfg)

    def forward(batch, rngs=None):
        if roi_cfg is not None and active_mesh() is not None and active_mesh().world > 1:
            raise NotImplementedError(
                "ROI_HEAD under a data mesh of world > 1 is not ported yet: the RoI losses' "
                "normalisers and the RoI head's norms are not made global")
        inputs = {k: torch.as_tensor(batch[k], device=dev) for k in batch_keys if k in batch}
        if rngs is not None:
            inputs["rngs"] = rngs
        net.train()
        return net(inputs)

    def loss_fn(state, batch, epoch, rngs=None):
        return compute_loss(forward(batch, rngs), state.curriculum, epoch)

    def train_step(state, batch, epoch):
        hook("forward")
        out = forward(batch, step_generators(seed, state.step, dev) if roi_cfg else None)
        hook("loss")
        loss, new_cur, aux_list, tb = compute_loss(out, state.curriculum, epoch)
        hook("backward")
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        hook("optimizer")
        # under a data mesh every rank's loss is the global one, so the mean
        # over ranks is the gradient (parallel/sharding.global_sum); it comes
        # before the optimizer's global-norm clip, which reads it
        reduce_gradients(net.parameters())
        optimizer.step()
        conf_sum = sum(a.confidence_sum for a in aux_list)
        conf_cnt = sum(a.confidence_cnt for a in aux_list)
        if state.conf_sum is not None:  # epoch statistics stay on the device
            state.conf_sum.add_(conf_sum)
            state.conf_cnt.add_(conf_cnt)
        state.curriculum = new_cur
        state.step += 1
        hook("end")
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in tb.items()},
                   "confidence_sum": conf_sum, "confidence_cnt": conf_cnt}
        return state, metrics

    train_step.loss_fn = loss_fn
    return train_step
