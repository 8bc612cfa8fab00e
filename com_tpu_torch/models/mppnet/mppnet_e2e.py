"""MPPNetE2E's streaming head with a rolling memory bank (counterpart of
``com_tpu/models/mppnet/mppnet_e2e.py``; pcdet detectors/mppnet_e2e.py and
roi_heads/mppnet_memory_bank_e2e.py): the past frames' proxy geometry
features are kept, so a step crops and pools the current frame alone, rolls
the bank, links the trajectories against the banked proposals and gathers
the matched proposals' features.  The bank is a plain tuple of tensors
(``MemoryBank``) passed through each step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils.registry import ROI_HEADS
from .mppnet_head import (MPPNetHead, crop_trajectory_points, generate_trajectory_with_idx,
                          proxy_points_of_roi)


class MemoryBank(NamedTuple):
    rois: torch.Tensor  # (B, F, P, D) each frame's proposals, newest first
    roi_labels: torch.Tensor  # (B, F, P)
    roi_scores: torch.Tensor  # (B, F, P)
    geo: torch.Tensor  # (B, F, P, g^3, C) each frame's proxy geometry features


def init_bank(rois, labels, scores, geo, num_frames: int) -> MemoryBank:
    """A sequence's first frame repeated into every slot (mppnet_e2e.py:46-50)."""
    rep = lambda x: x[:, None].repeat_interleave(num_frames, dim=1)  # noqa: E731
    return MemoryBank(rep(rois), rep(labels), rep(scores), rep(geo))


def push_bank(bank: MemoryBank, rois, labels, scores, geo) -> MemoryBank:
    """The newest frame in slot 0, the oldest dropped (mppnet_e2e.py:51-58)."""
    sh = lambda old, new: torch.cat([new[:, None], old[:, :-1]], dim=1)  # noqa: E731
    return MemoryBank(sh(bank.rois, rois), sh(bank.roi_labels, labels),
                      sh(bank.roi_scores, scores), sh(bank.geo, geo))


def zero_geo(head_cfg, rois):
    """The zero geometry features of ``rois`` (B, P, ...): (B, P, g^3, C)."""
    g3 = int(head_cfg["Transformer"]["num_proxy_points"])
    return rois.new_zeros((*rois.shape[:2], g3, int(head_cfg["TRANS_INPUT"])), dtype=torch.float32)


@ROI_HEADS.register
class MPPNetHeadE2E(MPPNetHead):
    """The memory-bank head (mppnet_memory_bank_e2e.py): past frames'
    geometry features come from ``batch["memory_bank"]``, only frame 0 is
    cropped and pooled; the current proposals are ``batch["rois" /
    "roi_scores" / "roi_labels"]``.  Writes the current frame's features to
    ``batch["geometry_feature_memory"]`` (B, R, g^3, C).  Has no per-group
    box branch (``bbox_embed``): the JAX head never calls it."""

    uses_bbox_embed = False

    def forward(self, batch):
        bank: MemoryBank = batch["memory_bank"]
        rois = batch["rois"]
        b, r, d = rois.shape
        f, g3, k = self.num_frames, self.num_proxy_points, self.num_lidar_points
        br = b * r
        gen = batch.get("rngs", {}).get("dropout")
        trajectory, valid_length, match_idx = generate_trajectory_with_idx(rois, bank.rois)
        batch["trajectory_rois"], batch["valid_length"] = trajectory, valid_length

        src0 = crop_trajectory_points(batch["points"], batch["points_mask"], trajectory[:, :1],
                                      valid_length[:, :1], k).reshape(br, k, -1)
        valid_pts0 = torch.abs(src0[..., 0:3]).sum(-1) > 0
        geo0, _ = self.geometry_features(src0, trajectory[:, 0].reshape(br, 1, d)[..., :7],
                                         valid_pts0)
        geo_cur = geo0.reshape(b, r, g3, -1)
        batch["geometry_feature_memory"] = geo_cur

        past = []
        for i in range(1, f):
            gi = torch.clamp(match_idx[:, i], 0, bank.geo.shape[2] - 1)
            gathered = torch.gather(bank.geo[:, i], 1,
                                    gi[..., None, None].expand(-1, -1, *bank.geo.shape[3:]))
            ok = (match_idx[:, i] >= 0).to(gathered.dtype)
            past.append(gathered * ok[..., None, None])
        feat_geo = torch.cat([geo_cur[:, :, None], torch.stack(past, 2)], dim=2)
        feat_geo = feat_geo.reshape(br, f * g3, -1)

        seq = trajectory.transpose(1, 2).reshape(br, f, d)
        proxy_g, _ = proxy_points_of_roi(seq[..., :7], self.grid_size)
        feat = feat_geo + self.motion_features(proxy_g.reshape(br, f * g3, 3), seq[..., :7])
        feat = self._empty_mask(feat, trajectory)
        _, feat_box = self.trajectory_branch(seq)
        hs, token_list = self.transformer(feat, self._positions(feat.device), gen)
        point_cls = torch.stack([self.class_embed(tok[0]) for tok in token_list], dim=0)
        joint_reg = self.jointembed(torch.cat([hs.transpose(0, 1).reshape(br, -1), feat_box], -1))
        batch["batch_cls_preds"] = point_cls[-1].reshape(b, r, 1)
        batch["batch_box_preds"] = self.decode_boxes(trajectory[:, 0, :, :7],
                                                     joint_reg.reshape(b, r, -1))
        batch["cls_preds_normalized"] = False
        return batch


def mppnet_e2e_stream_step(head, batch, bank, is_first: bool):
    """One streaming step: the bank started from (``is_first``) or rolled
    onto the current first-stage proposals (``batch["rois" / "roi_labels" /
    "roi_scores"]``), the banked head run, and the current frame's geometry
    features written into slot 0.  Returns (the head's batch, the new
    bank)."""
    rois, labels, scores = batch["rois"], batch["roi_labels"], batch["roi_scores"]
    f = int(head.model_cfg["Transformer"]["num_frames"])
    if is_first:
        bank = init_bank(rois, labels, scores, zero_geo(head.model_cfg, rois), f)
    else:
        bank = push_bank(bank, rois, labels, scores, torch.zeros_like(bank.geo[:, 0]))
    batch = dict(batch, memory_bank=bank)
    out = head(batch)
    geo = bank.geo.clone()
    geo[:, 0] = out["geometry_feature_memory"]
    return out, bank._replace(geo=geo)
