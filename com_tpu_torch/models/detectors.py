"""Detector composition (counterpart of ``com_tpu/models/detectors.py``).

A detector is the slot chain vfe -> backbone_3d -> map_to_bev (skipped when
the VFE wrote ``spatial_features``) -> backbone_2d -> dense_head over a
batch dict.  The slots are attributes named as in pcdet, so ``state_dict()``
keys read ``vfe.pfn_layers.0.linear.weight``, ``backbone_3d.conv2.0.0.weight``,
``backbone_2d.blocks.0.1.weight``, ``dense_head.shared_conv.0.weight``...
CenterPoint, PointPillar, SECONDNet and the two-stage VoxelRCNN and
SECONDNetIoU (``roi_head.*``), PV-RCNN and PV-RCNN++ (``pfe.*``,
``point_head.*``, ``roi_head.*``), PointRCNN (``backbone_3d.*``,
``point_head.*``, ``roi_head.*``, no BEV slot; over PointNet2MSG, or over
MeanVFE and UNetV2 for PartA2-free) and PartA2Net (UNetV2, the part head
``point_head.*``, ``roi_head.*``) are ported, for inference and training
(``net.train()`` puts the norms in batch-statistics mode; the dense head
returns raw predictions in both modes).  The two-stage detectors take
their proposals from an anchor head or from a CenterHead
(``decode_center_proposals``: the *_with_centerhead_* configs).
MPPNetE2E (a CenterHead with velocity, then MPPNet's memory-bank head over
its top proposals) is ported for inference; MPPNet (the multi-frame head
over a first stage's stored proposals, ``roi_head.*``) for inference and,
in train mode, its target sampling; CaDDN (``ImageVFE``, ``Conv2DCollapse``)
for inference and training.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..utils.device import resolve_device
from ..utils.registry import (BACKBONES_2D, BACKBONES_3D, DENSE_HEADS, DETECTORS, MAP_TO_BEV,
                              ROI_HEADS, VFES)
from . import backbone2d as _b2  # noqa: F401 (register)
from . import backbone3d as _b3  # noqa: F401
from . import dense_heads as _dh  # noqa: F401
from . import image_vfe as _ivfe  # noqa: F401
from . import map_to_bev as _mb  # noqa: F401
from . import pfe as _pfe  # noqa: F401
from . import pointnet2_backbone as _pn2  # noqa: F401
from . import roi_heads as _rh  # noqa: F401
from . import vfe as _vfe  # noqa: F401
from .backbone2d import Deconv
from .backbone3d import SparseConv3d
from .dense_heads.anchor_head import (box_coder_for, build_anchors, decode_anchor_boxes,
                                      top_candidates)
from .dense_heads.center_head import decode_center_proposals
from .layers import BatchNorm, Conv1x1, Conv2d
from .mppnet.mppnet_e2e import init_bank, mppnet_e2e_stream_step, zero_geo
from .mppnet.mppnet_head import generate_trajectory
from .mppnet.targets import sample_mppnet_targets
from .roi_heads.proposal_layer import proposal_layer, take_rows
from .roi_heads.roi_targets import assign_roi_targets


class DatasetMeta:
    """Static dataset facts the model needs (shapes, ranges, classes)."""

    def __init__(self, class_names, point_cloud_range, voxel_size, grid_size,
                 num_point_features):
        self.class_names = tuple(class_names)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.grid_size = tuple(int(v) for v in grid_size)
        self.num_point_features = int(num_point_features)


class Detector3D(nn.Module):
    """Generic slot-ordered detector."""

    extra_slots = ()  # which of PFE, POINT_HEAD and ROI_HEAD a subclass builds

    def __init__(self, model_cfg, meta: DatasetMeta):
        super().__init__()
        self.model_cfg, self.meta = model_cfg, meta
        for slot in ("PFE", "POINT_HEAD", "ROI_HEAD"):
            if slot not in self.extra_slots and model_cfg.get(slot) is not None:
                raise NotImplementedError(f"{slot} is not ported yet")
        mixed = bool(model_cfg.get("MIXED_PRECISION", False))
        dt = torch.bfloat16 if mixed else None

        vfe_cfg = model_cfg["VFE"]
        if mixed and "MIXED_PRECISION" not in vfe_cfg:
            vfe_cfg = dict(vfe_cfg, MIXED_PRECISION=True)
        self.vfe = VFES.get(vfe_cfg["NAME"])(
            vfe_cfg, meta.num_point_features, meta.voxel_size, meta.point_cloud_range,
            meta.grid_size)
        # a VFE that scatters to the BEV canvas itself says how wide it is
        bev_ch = getattr(self.vfe, "num_bev_features", None)

        b3_cfg = model_cfg.get("BACKBONE_3D")
        self.backbone_3d = None
        if b3_cfg is not None:
            self.backbone_3d = BACKBONES_3D.get(b3_cfg["NAME"])(
                b3_cfg, self.vfe.num_point_features, meta.grid_size, meta.voxel_size,
                meta.point_cloud_range)
        self.map_to_bev = None
        if bev_ch is None:
            m2b_cfg = model_cfg["MAP_TO_BEV"]
            # the dense volume's z-folded width: the 3D backbone's, else an
            # image VFE's (CaDDN)
            vol_ch = (self.backbone_3d.num_bev_features if self.backbone_3d is not None
                      else self.vfe.volume_channels)
            self.map_to_bev = MAP_TO_BEV.get(m2b_cfg["NAME"])(m2b_cfg, vol_ch)
            bev_ch = self.map_to_bev.num_bev_features

        b2_cfg = model_cfg.get("BACKBONE_2D")
        self.backbone_2d = None
        if b2_cfg is not None:
            self.backbone_2d = BACKBONES_2D.get(b2_cfg["NAME"])(b2_cfg, bev_ch, dtype=dt)
            bev_ch = self.backbone_2d.num_bev_features

        dh_cfg = model_cfg["DENSE_HEAD"]
        if mixed and "MIXED_PRECISION" not in dh_cfg:
            dh_cfg = dict(dh_cfg, MIXED_PRECISION=True)
        self.dense_head = DENSE_HEADS.get(dh_cfg["NAME"])(
            dh_cfg, bev_ch, len(meta.class_names), meta.class_names)
        self.bev_channels = bev_ch

    def voxel_stages(self, batch):
        """vfe -> backbone_3d -> map_to_bev."""
        batch = self.vfe(batch)
        if self.backbone_3d is not None:
            batch = self.backbone_3d(batch)
        if self.map_to_bev is not None:
            batch = self.map_to_bev(batch)
        return batch

    def bev_stages(self, batch):
        """backbone_2d -> dense_head."""
        if self.backbone_2d is not None:
            batch = self.backbone_2d(batch)
        return self.dense_head(batch)

    def forward(self, batch):
        return self.bev_stages(self.voxel_stages(batch))


@DETECTORS.register
class CenterPoint(Detector3D):
    """CenterPoint (detectors/centerpoint.py) — COM's primary detector."""


@DETECTORS.register
class PointPillar(Detector3D):
    """PointPillars (detectors/pointpillar.py): its PointPillarScatter is the
    VFE's own scatter into the canvas, as for CenterPoint-Pillar."""


@DETECTORS.register
class SECONDNet(Detector3D):
    """SECOND (detectors/second_net.py): MeanVFE, the sparse 3D backbone,
    HeightCompression, the BEV backbone and an anchor head."""


class RoIStage:
    """The second stage's RoI flow, shared by every two-stage detector (the
    JAX package's ``PVRCNN._stage2_rois``): given a detector's proposals,
    RoI target assignment in training when the batch has "gt_boxes" (random
    when ``batch["rngs"]["roi_sampling"]`` holds a generator or (B, P)
    uniforms, else deterministic), else the RoIs as they are, or with
    ``eval_topk`` the top RoIs by score (NMS_CONFIG.TEST_POST).  Reads
    ``model_cfg`` and ``training``; a detector mixes it in before its
    ``nn.Module`` base."""

    eval_topk: int | None = None

    def _stage2_rois(self, batch, proposals):
        """``proposals`` (rois, roi_scores, roi_labels, roi_valid), (B, P,
        ...), padded and suppressed slots invalid.  Sets batch["rois"] and,
        in training with GT, batch["roi_targets"]; else batch["roi_scores" /
        "roi_labels" / "roi_valid"]."""
        rois, roi_scores, roi_labels, roi_valid = proposals
        # suppressed slots can carry non-finite scores; validity rides in roi_valid
        roi_scores = torch.where(roi_valid, roi_scores, torch.zeros_like(roi_scores))
        if self.training and "gt_boxes" in batch:
            cfg = self.model_cfg.get("ROI_HEAD", {}).get("TARGET_CONFIG", {})
            draw = batch.get("rngs", {}).get("roi_sampling")
            targets = assign_roi_targets(
                rois, roi_scores, roi_labels, roi_valid, batch["gt_boxes"],
                roi_per_image=int(cfg.get("ROI_PER_IMAGE", 128)),
                fg_ratio=float(cfg.get("FG_RATIO", 0.5)),
                reg_fg_thresh=float(cfg.get("REG_FG_THRESH", 0.55)),
                cls_fg_thresh=float(cfg.get("CLS_FG_THRESH", 0.75)),
                cls_bg_thresh=float(cfg.get("CLS_BG_THRESH", 0.25)),
                cls_bg_thresh_lo=float(cfg.get("CLS_BG_THRESH_LO", 0.1)),
                hard_bg_ratio=float(cfg.get("HARD_BG_RATIO", 0.8)),
                generator=draw if isinstance(draw, torch.Generator) else None,
                u=draw if isinstance(draw, torch.Tensor) else None)
            batch["roi_targets"] = targets
            batch["rois"] = targets.rois
            return batch
        if self.eval_topk is not None:
            k = min(int(self.model_cfg.get("ROI_HEAD", {}).get("NMS_CONFIG", {})
                        .get("TEST_POST", self.eval_topk)), int(roi_scores.shape[1]))
            top, idx = top_candidates(torch.where(roi_valid, roi_scores,
                                                  torch.full_like(roi_scores, -math.inf)), k)
            rois, roi_labels = take_rows(rois, idx), take_rows(roi_labels, idx)
            roi_valid = torch.isfinite(top)
            roi_scores = torch.where(roi_valid, top, torch.zeros_like(top))
        batch["rois"] = rois
        batch["roi_scores"] = roi_scores
        batch["roi_labels"] = roi_labels
        batch["roi_valid"] = roi_valid
        return batch

    def nms_config(self) -> dict:
        """ROI_HEAD.NMS_CONFIG with its TRAIN or TEST entries over it, by mode."""
        nms_cfg = dict(self.model_cfg.get("ROI_HEAD", {}).get("NMS_CONFIG", {}))
        nms_cfg.update(nms_cfg.get("TRAIN" if self.training else "TEST", {}))
        return nms_cfg


class TwoStageDetector(RoIStage, Detector3D):
    """A detector with a second stage (the JAX package's ``PVRCNN`` base:
    ``_build_roi_head``, ``_proposals``, ``_stage2_rois``): the first stage
    as ``Detector3D``, then the dense head's decoded boxes (every anchor of
    an anchor head, or a CenterHead's top 512 a head by
    ``decode_center_proposals``) through the proposal layer (``NMS_CONFIG``
    TRAIN or TEST by the module's mode) or, without NMS_THRESH, the top
    TRAIN_PRE / TEST_PRE; the RoI flow of ``RoIStage`` and the RoI head,
    mounted as ``roi_head``.  Voxel-RCNN and SECOND-IoU keep every RoI in
    eval."""

    extra_slots = ("ROI_HEAD",)

    def __init__(self, model_cfg, meta: DatasetMeta):
        super().__init__(model_cfg, meta)
        head_cfg = model_cfg["DENSE_HEAD"]
        self.anchor_rpn = "ANCHOR_GENERATOR_CONFIG" in head_cfg
        if self.anchor_rpn:  # a CenterHead RPN has neither anchors nor a box coder
            anchors = build_anchors(head_cfg, list(meta.class_names), meta.grid_size,
                                    meta.point_cloud_range)[0]
            self.register_buffer("anchors", torch.as_tensor(anchors), persistent=False)
            self.box_coder = box_coder_for(head_cfg)
        roi_cfg = model_cfg["ROI_HEAD"]
        self.roi_head = ROI_HEADS.get(roi_cfg["NAME"])(
            roi_cfg, num_class=1, point_cloud_range=meta.point_cloud_range,
            voxel_size=meta.voxel_size, input_channels=self._roi_input_channels())

    def _roi_input_channels(self):
        raise NotImplementedError

    def _proposals(self, batch):
        """Fixed-size proposals: (rois, roi_scores, roi_labels, roi_valid),
        (B, P, ...), padded and suppressed slots invalid."""
        head_cfg = self.model_cfg["DENSE_HEAD"]
        nms_cfg = self.nms_config()
        with torch.no_grad():
            if self.anchor_rpn:  # every anchor is a candidate
                boxes, scores, labels = decode_anchor_boxes(
                    batch, self.anchors, len(self.meta.class_names), self.box_coder,
                    dir_cfg=head_cfg if head_cfg.get("USE_DIRECTION_CLASSIFIER") else None)
            else:
                boxes, scores, labels, valid = decode_center_proposals(batch, head_cfg, self.meta)
                scores = torch.where(valid, scores, torch.full_like(scores, -math.inf))
        if "NMS_THRESH" in nms_cfg:
            return proposal_layer(
                boxes, scores, labels,
                nms_pre=min(int(nms_cfg.get("NMS_PRE_MAXSIZE", 4096)), int(boxes.shape[1])),
                nms_post=int(nms_cfg.get("NMS_POST_MAXSIZE", 512)),
                nms_thresh=float(nms_cfg["NMS_THRESH"]),
                use_fast_nms=nms_cfg.get("NMS_TYPE") == "fast_nms")
        num_p = min(int(nms_cfg.get("TRAIN_PRE" if self.training else "TEST_PRE", 512)),
                    int(scores.shape[1]))
        top, idx = top_candidates(scores, num_p)
        roi_valid = torch.isfinite(top)
        return (take_rows(boxes, idx), torch.where(roi_valid, top, torch.zeros_like(top)),
                take_rows(labels, idx), roi_valid)

    def forward(self, batch):
        batch = super().forward(batch)
        return self.roi_head(self._stage2_rois(batch, self._proposals(batch)))


@DETECTORS.register
class VoxelRCNN(TwoStageDetector):
    """Voxel-RCNN (detectors/voxel_rcnn.py): SECOND's first stage, the
    anchor head's proposals, ``VoxelRCNNHead`` over the 3D backbone's
    multi-scale sparse volumes."""

    def _roi_input_channels(self):
        return self.backbone_3d.multi_scale_channels


@DETECTORS.register
class SECONDNetIoU(TwoStageDetector):
    """SECOND with the IoU-scoring ``SECONDHead`` over the BEV backbone's map
    (detectors/second_net_iou.py).  Eval ranks by NMS_CONFIG.SCORE_TYPE
    (``train/eval.py``)."""

    def _roi_input_channels(self):
        return self.bev_channels


class _PointStages(TwoStageDetector):
    """A two-stage detector with PV-RCNN's point stages: the keypoint
    encoder ``pfe`` (PFE, ``VoxelSetAbstraction``) over the raw points, the
    BEV map and the 3D backbone's volumes, and the keypoints' foreground
    head ``point_head`` (POINT_HEAD, optional); the RoI head pools the
    keypoints (its input width the PFE's NUM_OUTPUT_FEATURES)."""

    extra_slots = ("PFE", "POINT_HEAD", "ROI_HEAD")

    def __init__(self, model_cfg, meta: DatasetMeta):
        super().__init__(model_cfg, meta)
        pfe_cfg = model_cfg["PFE"]
        self.pfe = BACKBONES_3D.get(pfe_cfg["NAME"])(
            pfe_cfg, meta.num_point_features, meta.grid_size, meta.voxel_size,
            meta.point_cloud_range, bev_channels=self.backbone_3d.num_bev_features,
            multi_scale_channels=self.backbone_3d.multi_scale_channels)
        ph_cfg = model_cfg.get("POINT_HEAD")
        self.point_head = None if ph_cfg is None else DENSE_HEADS.get(ph_cfg["NAME"])(
            ph_cfg, self.pfe.num_point_features)

    def _roi_input_channels(self):
        return int(self.model_cfg["PFE"].get("NUM_OUTPUT_FEATURES", 128))

    def point_head_stage(self, batch):
        return batch if self.point_head is None else self.point_head(batch)


@DETECTORS.register
class PVRCNN(_PointStages):
    """PV-RCNN (detectors/pv_rcnn.py), in the JAX package's order: the voxel
    stages, the keypoints (``pfe``), the BEV backbone and the anchor head,
    the point head, the proposals (the top TEST_POST RoIs in eval) and
    ``PVRCNNHead``."""

    eval_topk = 128

    def forward(self, batch):
        batch = self.point_head_stage(self.bev_stages(self.pfe(self.voxel_stages(batch))))
        return self.roi_head(self._stage2_rois(batch, self._proposals(batch)))


@DETECTORS.register
class PVRCNNPlusPlus(_PointStages):
    """PV-RCNN++ (detectors/pv_rcnn_plusplus.py): the proposals come before
    the keypoints, so that SPC sampling sees the RoIs; then the point head
    and ``PVRCNNPlusPlusHead``."""

    def forward(self, batch):
        batch = self.bev_stages(self.voxel_stages(batch))
        batch = self.pfe(self._stage2_rois(batch, self._proposals(batch)))
        return self.roi_head(self.point_head_stage(batch))


@DETECTORS.register
class PartA2Net(TwoStageDetector):
    """PartA2 (detectors/PartA2_net.py), in the JAX package's order: MeanVFE,
    ``UNetV2`` (the dense tensor for HeightCompression, and features at
    every voxel), the BEV backbone and the anchor head,
    ``PointIntraPartOffsetHead`` (``point_head``: a foreground score and
    the part location a voxel), the anchor proposals through the RoI flow
    (every RoI kept in eval) and ``PartA2FCHead``."""

    extra_slots = ("POINT_HEAD", "ROI_HEAD")

    def __init__(self, model_cfg, meta: DatasetMeta):
        super().__init__(model_cfg, meta)
        self.point_head = DENSE_HEADS.get("PointIntraPartOffsetHead")(
            model_cfg.get("POINT_HEAD", {}), self.backbone_3d.num_point_features, num_class=1)

    def _roi_input_channels(self):
        return self.backbone_3d.num_point_features

    def forward(self, batch):
        batch = self.point_head(Detector3D.forward(self, batch))
        return self.roi_head(self._stage2_rois(batch, self._proposals(batch)))


@DETECTORS.register
class PointRCNN(RoIStage, nn.Module):
    """PointRCNN (detectors/point_rcnn.py): ``PointNet2MSG`` features a
    point (``backbone_3d``), ``PointHeadBox``'s class and box a point
    (``point_head``), the valid points' boxes as proposals (the proposal
    layer's top-k and K4 NMS, NMS_CONFIG TRAIN or TEST by mode), the RoI
    flow of ``RoIStage`` (every RoI kept in eval, as the JAX detector) and
    ``PointRCNNHead`` over the points in each RoI (``roi_head``).  With a
    VFE (PartA2-free, PartA2_free.yaml) the VFE and a voxel backbone
    (UNetV2) give the point features, and its point head
    (``PointIntraPartOffsetHead`` with REG_FC) the boxes."""

    def __init__(self, model_cfg, meta: DatasetMeta):
        super().__init__()
        self.model_cfg, self.meta = model_cfg, meta
        b3_cfg = model_cfg["BACKBONE_3D"]
        self.vfe, channels, grid = None, meta.num_point_features, ()
        if "VFE" in model_cfg:  # a voxel backbone over the VFE's voxels
            vfe_cfg = model_cfg["VFE"]
            self.vfe = VFES.get(vfe_cfg["NAME"])(
                vfe_cfg, channels, meta.voxel_size, meta.point_cloud_range, meta.grid_size)
            channels = self.vfe.num_point_features
            grid = (meta.grid_size, meta.voxel_size, meta.point_cloud_range)
        self.backbone_3d = BACKBONES_3D.get(b3_cfg["NAME"])(b3_cfg, channels, *grid)
        ph_cfg = model_cfg["POINT_HEAD"]
        self.point_head = DENSE_HEADS.get(ph_cfg.get("NAME", "PointHeadBox"))(
            ph_cfg, self.backbone_3d.num_point_features, num_class=len(meta.class_names))
        roi_cfg = model_cfg["ROI_HEAD"]
        self.roi_head = ROI_HEADS.get(roi_cfg["NAME"])(
            roi_cfg, num_class=1, input_channels=self.backbone_3d.num_point_features)

    def _proposals(self, batch):
        """The point head's boxes and scores, a point's -inf where it is not
        valid, through the proposal layer (NMS_PRE_MAXSIZE candidates)."""
        nms_cfg = self.nms_config()
        scores = batch["point_cls_scores"].detach()
        valid = batch.get("point_valid")
        if valid is not None:
            scores = torch.where(valid, scores, torch.full_like(scores, -math.inf))
        return proposal_layer(
            batch["point_box_preds"].detach(), scores,
            batch["point_pred_labels"].to(torch.int32),
            nms_pre=int(nms_cfg.get("NMS_PRE_MAXSIZE", 4096)),
            nms_post=int(nms_cfg.get("NMS_POST_MAXSIZE", 512)),
            nms_thresh=float(nms_cfg.get("NMS_THRESH", 0.8)),
            use_fast_nms=nms_cfg.get("NMS_TYPE") == "fast_nms")

    def forward(self, batch):
        if self.vfe is not None:
            batch = self.vfe(batch)
        batch = self.point_head(self.backbone_3d(batch))
        return self.roi_head(self._stage2_rois(batch, self._proposals(batch)))


@DETECTORS.register
class MPPNetE2E(Detector3D):
    """MPPNet's end-to-end streaming detector (detectors/mppnet_e2e.py), for
    inference: the first stage as ``Detector3D`` (a CenterHead with a
    velocity branch), its top ROI_PER_IMAGE boxes of
    ``decode_center_proposals`` as the RoIs, then ``MPPNetHeadE2E``
    (``roi_head``).  Without ``batch["memory_bank"]`` the bank is the RoIs
    with zero features in every frame, as a sequence's first frame;
    ``stream_step`` rolls a bank from frame to frame."""

    extra_slots = ("ROI_HEAD",)

    def __init__(self, model_cfg, meta: DatasetMeta):
        super().__init__(model_cfg, meta)
        roi_cfg = model_cfg["ROI_HEAD"]
        self.roi_head = ROI_HEADS.get(roi_cfg["NAME"])(
            roi_cfg, num_class=1, num_point_features=meta.num_point_features)

    def proposals(self, batch):
        """The first stage and its RoIs: batch["rois" / "roi_scores" /
        "roi_labels" / "roi_valid"], (B, ROI_PER_IMAGE, ...)."""
        batch = super().forward(batch)
        num_p = int(self.model_cfg["ROI_HEAD"].get("TARGET_CONFIG", {}).get("ROI_PER_IMAGE", 96))
        with torch.no_grad():
            boxes, scores, labels, valid = decode_center_proposals(
                batch, self.model_cfg["DENSE_HEAD"], self.meta, k=num_p)
            top, idx = top_candidates(torch.where(valid, scores,
                                                  torch.full_like(scores, -math.inf)),
                                      min(num_p, int(scores.shape[1])))
        roi_valid = torch.isfinite(top)
        batch.update(rois=take_rows(boxes, idx),
                     roi_scores=torch.where(roi_valid, top, torch.zeros_like(top)),
                     roi_labels=take_rows(labels, idx), roi_valid=roi_valid)
        return batch

    def forward(self, batch):
        batch = self.proposals(batch)
        if "memory_bank" not in batch:
            head_cfg = self.model_cfg["ROI_HEAD"]
            batch["memory_bank"] = init_bank(
                batch["rois"], batch["roi_labels"], batch["roi_scores"],
                zero_geo(head_cfg, batch["rois"]), int(head_cfg["Transformer"]["num_frames"]))
        return self.roi_head(batch)

    def stream_step(self, batch, bank, is_first: bool):
        """One frame of a sequence: the proposals, then
        ``mppnet_e2e_stream_step`` (the bank started or rolled, the head,
        the frame's features written back).  Returns (outputs, bank)."""
        return mppnet_e2e_stream_step(self.roi_head, self.proposals(batch), bank, is_first)


@DETECTORS.register
class MPPNet(nn.Module):
    """MPPNet's second stage alone (detectors/mppnet.py:12-43): a first
    stage's stored boxes a frame (batch["roi_boxes"] (B, F, P, 9+), the
    backward displacement at 7:9; "roi_scores" (B, F, P); "roi_labels" (B,
    P)) linked into trajectories (``generate_trajectory``), then
    ``MPPNetHead`` (``roi_head``) over the fused points (timestamp last).
    In train mode with "gt_boxes" it samples ROI_PER_IMAGE trajectories a
    sample (``sample_mppnet_targets``) and writes batch["mppnet_targets"],
    for ``mppnet_loss``; the head's dropout draws from
    batch["rngs"]["dropout"] where given."""

    # the batch keys it reads besides the ground truth (``device_batch_keys``)
    input_keys = frozenset({"roi_boxes", "roi_scores", "roi_labels", "points", "points_mask"})
    # why ``make_train_step`` and the CLIs do not run it
    no_step_reason = (
        "com_tpu's train step adds no mppnet_loss, and no dataset of either package fills "
        "roi_boxes (the first stage's boxes a frame; USE_PREDBOX / ROI_BOXES_PATH are read by "
        "no code), so com_tpu's step and CLIs cannot run it either; use build_network, "
        "make_eval_step and, for training, the detector in train mode (it samples "
        "batch['mppnet_targets']) with models.mppnet.mppnet_loss")

    def __init__(self, model_cfg, meta: DatasetMeta):
        super().__init__()
        self.model_cfg, self.meta = model_cfg, meta
        roi_cfg = model_cfg["ROI_HEAD"]
        self.roi_head = ROI_HEADS.get(roi_cfg["NAME"])(
            roi_cfg, num_class=1, num_point_features=meta.num_point_features)

    def forward(self, batch):
        proposals = batch["roi_boxes"]
        with torch.no_grad():
            trajectory, valid_length = generate_trajectory(proposals[:, 0], proposals)
        if self.training and "gt_boxes" in batch:
            tc = self.model_cfg["ROI_HEAD"]["TARGET_CONFIG"]
            with torch.no_grad():
                targets = sample_mppnet_targets(
                    trajectory, valid_length, batch["roi_scores"][:, 0], batch["roi_labels"],
                    batch["gt_boxes"], roi_per_image=int(tc.get("ROI_PER_IMAGE", 96)),
                    fg_ratio=float(tc.get("FG_RATIO", 0.5)),
                    reg_fg_thresh=float(tc.get("REG_FG_THRESH", 0.55)),
                    cls_fg_thresh=float(tc.get("CLS_FG_THRESH", 0.75)),
                    cls_bg_thresh=float(tc.get("CLS_BG_THRESH", 0.25)),
                    sample_by_class=bool(tc.get("SAMPLE_ROI_BY_EACH_CLASS", True)))
            batch.update(mppnet_targets=targets, trajectory_rois=targets.trajectory_rois,
                         valid_length=targets.valid_length, roi_labels_sampled=targets.roi_labels)
        else:
            batch.update(trajectory_rois=trajectory, valid_length=valid_length,
                         roi_scores_cur=batch["roi_scores"][:, 0],
                         roi_labels_sampled=batch["roi_labels"])
        return self.roi_head(batch)


@DETECTORS.register
class CaDDN(Detector3D):
    """CaDDN (detectors/caddn.py): ``ImageVFE``'s depth frustum sampled into
    the voxel grid, ``Conv2DCollapse``, the BEV backbone and an anchor head;
    the train step adds ``ddn_loss`` to the anchor loss."""


def init_weights(net: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight from ``generator`` (on the CPU, then copied to the
    net's device): convs, sparse convs and linears uniform in
    +-1/sqrt(fan_in) (PyTorch's default bound; a sparse conv's fan-in is
    taps x Cin), their biases the same, norms at identity, and the
    heatmap's final bias and the anchor heads' class biases at their init
    values (the latter the prior -log((1 - 0.01) / 0.01), as flax's)."""
    from .dense_heads.anchor_head import CLS_BIAS_INIT, AnchorHeadSingle, SingleHead
    from .dense_heads.center_head import SeparateHead

    def draw(t, bound):
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound, generator=generator))

    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (Conv2d, Deconv, nn.Linear, Conv1x1, nn.Conv2d)):
                w = mod.weight
                bound = 1.0 / math.sqrt(w.shape[0] if isinstance(mod, Deconv) else w[0].numel())
                draw(w, bound)
                if getattr(mod, "bias", None) is not None:
                    draw(mod.bias, bound)
            elif isinstance(mod, SparseConv3d):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())  # (kz, ky, kx, Cin)
                draw(mod.weight, bound)
                if mod.bias is not None:
                    draw(mod.bias, bound)
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0 + mod.VAR_SHIFT)
        for mod in net.modules():
            if isinstance(mod, SeparateHead) and "hm" in mod.names:
                mod.hm[-1].bias.fill_(mod.init_bias)
            elif isinstance(mod, (AnchorHeadSingle, SingleHead)):
                mod.conv_cls.bias.fill_(CLS_BIAS_INIT)
    return net


def detector_class(model_cfg):
    """The class ``build_network`` builds for ``model_cfg["NAME"]`` (None
    for a name outside the registry), for what it declares: ``input_keys``
    where it names the batch keys it reads, ``no_step_reason`` where the
    train step and the CLIs do not run it."""
    name = model_cfg.get("NAME")
    return DETECTORS.get(name) if name in DETECTORS else None


def build_network(model_cfg, meta: DatasetMeta, device=None, seed: int = 0):
    """The detector named by ``model_cfg["NAME"]`` in eval mode on ``device``
    (CUDA unless the caller passes another), weights drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    net = DETECTORS.get(model_cfg["NAME"])(model_cfg, meta)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.to(dev).eval()
