"""Detector composition (counterpart of ``com_tpu/models/detectors.py``).

A detector is the slot chain vfe -> backbone_3d -> map_to_bev (skipped when
the VFE wrote ``spatial_features``) -> backbone_2d -> dense_head over a
batch dict.  The slots are attributes named as in pcdet, so ``state_dict()``
keys read ``vfe.pfn_layers.0.linear.weight``, ``backbone_3d.conv2.0.0.weight``,
``backbone_2d.blocks.0.1.weight``, ``dense_head.shared_conv.0.weight``...
CenterPoint, PointPillar, SECONDNet and the two-stage VoxelRCNN and
SECONDNetIoU (``roi_head.*``), PV-RCNN and PV-RCNN++ (``pfe.*``,
``point_head.*``, ``roi_head.*``) and PointRCNN (``backbone_3d.*``,
``point_head.*``, ``roi_head.*``, no voxel or BEV slot) are ported, for
inference and training (``net.train()`` puts the norms in batch-statistics
mode; the dense head returns raw predictions in both modes); the other
two-stage detectors raise by name.
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
from . import map_to_bev as _mb  # noqa: F401
from . import pfe as _pfe  # noqa: F401
from . import pointnet2_backbone as _pn2  # noqa: F401
from . import roi_heads as _rh  # noqa: F401
from . import vfe as _vfe  # noqa: F401
from .backbone2d import Deconv
from .backbone3d import SparseConv3d
from .dense_heads.anchor_head import (box_coder_for, build_anchors, decode_anchor_boxes,
                                      top_candidates)
from .layers import BatchNorm, Conv1x1, Conv2d
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

    two_stage = False  # a subclass that builds ROI_HEAD
    point_stages = False  # a subclass that builds PFE and POINT_HEAD

    def __init__(self, model_cfg, meta: DatasetMeta):
        super().__init__()
        self.model_cfg, self.meta = model_cfg, meta
        for slot in ((() if self.point_stages else ("PFE", "POINT_HEAD"))
                     + (() if self.two_stage else ("ROI_HEAD",))):
            if model_cfg.get(slot) is not None:
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
            self.map_to_bev = MAP_TO_BEV.get(m2b_cfg["NAME"])(m2b_cfg)
            bev_ch = self.backbone_3d.num_bev_features

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
    as ``Detector3D``, then the anchor head's decoded boxes through the
    proposal layer (``NMS_CONFIG`` TRAIN or TEST by the module's mode), the
    RoI flow of ``RoIStage`` and the RoI head, mounted as ``roi_head``.
    Voxel-RCNN and SECOND-IoU keep every RoI in eval."""

    two_stage = True

    def __init__(self, model_cfg, meta: DatasetMeta):
        head_cfg = model_cfg["DENSE_HEAD"]
        if "ANCHOR_GENERATOR_CONFIG" not in head_cfg:
            raise NotImplementedError("decode_center_proposals (the CenterHead RPN of the "
                                      "*_with_centerhead_* configs) is not ported yet")
        super().__init__(model_cfg, meta)
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
            boxes, scores, labels = decode_anchor_boxes(
                batch, self.anchors, len(self.meta.class_names), self.box_coder,
                dir_cfg=head_cfg if head_cfg.get("USE_DIRECTION_CLASSIFIER") else None)
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

    point_stages = True

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
class PointRCNN(RoIStage, nn.Module):
    """PointRCNN (detectors/point_rcnn.py): ``PointNet2MSG`` features a
    point (``backbone_3d``), ``PointHeadBox``'s class and box a point
    (``point_head``), the valid points' boxes as proposals (the proposal
    layer's top-k and K4 NMS, NMS_CONFIG TRAIN or TEST by mode), the RoI
    flow of ``RoIStage`` (every RoI kept in eval, as the JAX detector) and
    ``PointRCNNHead`` over the points in each RoI (``roi_head``).  No VFE:
    the PartA2-free composition (PartA2_free.yaml: MeanVFE and UNetV2 give
    the point features) raises by name."""

    def __init__(self, model_cfg, meta: DatasetMeta):
        super().__init__()
        if "VFE" in model_cfg:
            raise NotImplementedError("PointRCNN over a VFE and UNetV2 (PartA2_free.yaml's "
                                      "composition) is not ported yet")
        self.model_cfg, self.meta = model_cfg, meta
        b3_cfg = model_cfg["BACKBONE_3D"]
        self.backbone_3d = BACKBONES_3D.get(b3_cfg["NAME"])(b3_cfg, meta.num_point_features)
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
        batch = self.point_head(self.backbone_3d(batch))
        return self.roi_head(self._stage2_rois(batch, self._proposals(batch)))


for _name, _what in (("PartA2Net", "UNetV2 and RoI-aware pooling"),
                     ("MPPNet", "multi-frame proxy points"),
                     ("MPPNetE2E", "multi-frame proxy points"),
                     ("CaDDN", "the image depth frustum")):
    DETECTORS.register_unported(_name, _what)


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
            if isinstance(mod, (Conv2d, Deconv, nn.Linear, Conv1x1)):
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


def build_network(model_cfg, meta: DatasetMeta, device=None, seed: int = 0):
    """The detector named by ``model_cfg["NAME"]`` in eval mode on ``device``
    (CUDA unless the caller passes another), weights drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    net = DETECTORS.get(model_cfg["NAME"])(model_cfg, meta)
    init_weights(net, torch.Generator().manual_seed(seed))
    return net.to(dev).eval()
