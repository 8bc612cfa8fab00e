"""MPPNet's multi-frame refinement head (counterpart of ``com_tpu/models/
mppnet/mppnet_head.py``; pcdet roi_heads/mppnet_head.py): the trajectory
linking, the point crop a (RoI, frame), the proxy-point geometry and motion
features, the box-sequence embedding, the grouped transformer and the box
decode, over fixed-size (B, F, R, ...) tensors in plain PyTorch as the JAX
package's are plain XLA, and its loss (``mppnet_loss``; the target
sampling is ``targets.py``).

Sub-modules keep the JAX package's scope names (``up_dimension_geometry``,
``up_dimension_motion``, ``seqboxembed``, ``jointembed``, ``transformer``,
``class_embed``, ``bbox_embed.{g}``, ``grid_pos_embeded``, which are pcdet's
too) and ``roi_grid_pool_layers.{radius}.{layer}`` for its ``pool_r{r}_l{l}``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.boxes import ResidualCoder, corner_loss
from ...ops.iou import boxes_iou3d
from ...ops.pointnet2 import query_and_group
from ...utils.registry import ROI_HEADS
from .transformer import MLP, MPPNetTransformer, SeqBoxEmbed


def rotate_z(points, angle):
    """(..., 3) points rotated by ``angle`` (...) about +z."""
    c, s = torch.cos(angle), torch.sin(angle)
    x = points[..., 0] * c - points[..., 1] * s
    y = points[..., 0] * s + points[..., 1] * c
    return torch.stack([x, y, points[..., 2]], dim=-1)


def _bits(g, dtype, device):
    return torch.tensor([[x, y, z] for x in range(g) for y in range(g) for z in range(g)],
                        dtype=dtype, device=device)


def corner_points_of_roi(rois):
    """(..., 7) boxes -> (..., 8, 3) corners: the {0, 1}^3 offsets x-major
    times the size less half of it, rotated, plus the centre
    (mppnet_head.py:367-401)."""
    dims = rois[..., 3:6]
    local = _bits(2, rois.dtype, rois.device) * dims[..., None, :] - dims[..., None, :] / 2
    return rotate_z(local, rois[..., None, 6]) + rois[..., None, 0:3]


def grid_index(g: int, dtype=torch.float32, device=None):
    """(g^3, 3) x-major grid indices: the one order of the proxy points and
    their positional embeddings."""
    return _bits(g, dtype, device)


def proxy_points_of_roi(rois, grid_size: int):
    """(..., 7) boxes -> (global (..., g^3, 3), local (..., g^3, 3)) proxy
    points at the cell centres of a g^3 grid in the box."""
    idx = grid_index(grid_size, rois.dtype, rois.device)
    dims = rois[..., 3:6]
    local = (idx + 0.5) / grid_size * dims[..., None, :] - dims[..., None, :] / 2
    return rotate_z(local, rois[..., None, 6]) + rois[..., None, 0:3], local


def spherical_coordinate(src, diag_dist):
    """(..., 27) xyz offsets from 9 anchors -> (distance over the diagonal,
    phi, theta) of each (mppnet_head.py:454-468)."""
    x, y, z = src[..., 0::3], src[..., 1::3], src[..., 2::3]
    dis = torch.sqrt(x ** 2 + y ** 2 + z ** 2)
    phi = torch.atan(y / (x + 1e-5))
    the = torch.arccos(torch.clamp(z / (dis + 1e-5), -1.0, 1.0))
    return torch.cat([dis / (diag_dist + 1e-5), phi, the], dim=-1)


def generate_trajectory_with_idx(cur_boxes, proposals_list, iou_thresh: float = 0.5):
    """Link the current boxes (B, R, D >= 9, the per-frame backward
    displacement at 7:9) back through each frame's proposals (B, F, P, D):
    a box moved by its displacement matches the frame's proposal of the
    highest 3D IoU (the first on a tie) if that reaches ``iou_thresh``, else
    the row keeps the frame-0 box; the next frame predicts from the stored
    row (mppnet_head.py:635-659).  Returns (trajectory (B, F, R, D),
    valid_length (B, F, R) f32, the matched proposal's index (B, F, R), -1
    where none)."""
    b, f = proposals_list.shape[:2]
    r = cur_boxes.shape[1]
    traj, valid = [cur_boxes], [torch.ones((b, r), dtype=torch.bool, device=cur_boxes.device)]
    idxs = [torch.arange(r, dtype=torch.int64, device=cur_boxes.device).expand(b, r)]
    prev = cur_boxes
    for i in range(1, f):
        pred = torch.cat([prev[..., 0:2] + prev[..., 7:9], prev[..., 2:]], dim=-1)
        iou = boxes_iou3d(pred[..., :7], proposals_list[:, i, :, :7])  # (B, R, P)
        maxov, best = iou.max(dim=2)
        ok = maxov >= iou_thresh
        matched = torch.gather(proposals_list[:, i], 1,
                               best[..., None].expand(-1, -1, proposals_list.shape[-1]))
        stored = torch.where(ok[..., None], matched, cur_boxes)
        traj.append(stored)
        valid.append(ok)
        idxs.append(torch.where(ok, best, torch.full_like(best, -1)))
        prev = stored
    return (torch.stack(traj, 1), torch.stack(valid, 1).to(torch.float32),
            torch.stack(idxs, 1))


def generate_trajectory(cur_boxes, proposals_list, iou_thresh: float = 0.5):
    """``generate_trajectory_with_idx`` without the indices: (trajectory
    (B, F, R, D), valid_length (B, F, R) f32)."""
    return generate_trajectory_with_idx(cur_boxes, proposals_list, iou_thresh)[:2]


def first_hits(ok, k: int):
    """(..., N) bool -> (..., k) indices of the first ``k`` true entries in
    index order (``lax.top_k`` of the 0/1 mask), the slots past the last
    hit repeating the first hit, and (..., k) which are hits."""
    n = ok.shape[-1]
    count = ok.cumsum(dim=-1, dtype=torch.int32)
    want = torch.arange(1, k + 1, dtype=torch.int32, device=ok.device)
    pos = torch.searchsorted(count, want.expand(*ok.shape[:-1], k).contiguous())
    hit = pos < n
    idx = torch.where(hit, pos, pos[..., :1])
    return torch.clamp(idx, max=n - 1), hit


CROP_BLOCK = 1 << 28  # (B, RoIs, points) entries of a crop's distance tensor a block


def crop_trajectory_points(points, pmask, trajectory, valid_length, num_lidar_points: int,
                           frame_dt: float = 0.1):
    """Up to ``num_lidar_points`` points a (RoI, frame) within 1.1 times the
    half diagonal of the frame's box in BEV, taken from the points whose
    timestamp (the last channel) is the frame's (mppnet_head.py:470-549).
    points (B, N, C), trajectory (B, F, R, D).  Returns (B, R, F * K, C - 1),
    the timestamp dropped, a RoI's rows zero where its frame has no hit
    (or, past frame 0, no match).  The RoIs go in blocks of at most
    CROP_BLOCK // (B * N) (at least one): a RoI's points depend on its box
    alone, so the blocks change nothing but the (B, R, N) transients."""
    b, n, c = points.shape
    r = trajectory.shape[2]
    step = max(1, CROP_BLOCK // max(b * n, 1))
    xy, t = points[..., 0:2], points[..., -1]
    outs = []
    for i in range(trajectory.shape[1]):
        tmask = (torch.abs(t - i * frame_dt) < 1e-3) & pmask
        frame = []
        for lo in range(0, r, step):
            boxes = trajectory[:, i, lo:lo + step]
            radii2 = ((boxes[..., 3] / 2) ** 2 + (boxes[..., 4] / 2) ** 2) * (1.1 ** 2)
            d2 = ((xy[:, None, :, :] - boxes[..., None, 0:2]) ** 2).sum(-1)  # (B, r, N)
            ok = (d2 <= radii2[..., None]) & tmask[:, None, :]
            del d2
            idx, hit = first_hits(ok, num_lidar_points)
            rb, k = idx.shape[1:]
            pts = torch.gather(points[:, None].expand(b, rb, -1, c), 2,
                               idx[..., None].expand(-1, -1, -1, c))
            keep = hit.any(dim=-1, keepdim=True)
            if i > 0:
                keep = keep & (valid_length[:, i, lo:lo + step, None] > 0)
            frame.append((pts * keep[..., None].to(pts.dtype))[..., :c - 1])
        outs.append(torch.cat(frame, dim=1))
    return torch.cat(outs, dim=2)


@ROI_HEADS.register
class MPPNetHead(nn.Module):
    """The multi-frame transformer refinement head (mppnet_head.py:298-999).
    ``num_point_features`` is the points' width with the timestamp last (the
    geometry MLP reads 27 spherical offsets and the points' other
    features)."""

    uses_bbox_embed = True

    def __init__(self, model_cfg, num_class: int = 1, num_point_features: int = 6, **_):
        super().__init__()
        self.model_cfg, self.num_class = model_cfg, num_class
        tcfg = model_cfg["Transformer"]
        self.num_lidar_points = int(tcfg["num_lidar_points"])
        self.num_proxy_points = int(tcfg["num_proxy_points"])
        self.num_groups = int(tcfg["num_groups"])
        self.num_frames = int(tcfg["num_frames"])
        self.hidden_dim = int(model_cfg["TRANS_INPUT"])
        self.grid_size = int(model_cfg["ROI_GRID_POOL"]["GRID_SIZE"])
        self.box_coder = ResidualCoder()
        code = self.box_coder.code_size
        pool = model_cfg["ROI_GRID_POOL"]
        self.pool_radii = [float(x) for x in pool["POOL_RADIUS"]]
        self.pool_nsamples = [int(x) for x in pool["NSAMPLE"]]
        geo_ch = self.hidden_dim // len(self.pool_radii)
        self.up_dimension_geometry = MLP(27 + num_point_features - 4, 64, geo_ch, 3)
        self.up_dimension_motion = MLP(30, 64, self.hidden_dim, 3)
        self.seqboxembed = SeqBoxEmbed(self.hidden_dim)
        t_hidden = int(tcfg["hidden_dim"])
        self.jointembed = MLP((self.num_groups + 1) * self.hidden_dim, t_hidden,
                              code * num_class, 4)
        self.transformer = MPPNetTransformer(
            self.hidden_dim, int(tcfg["nheads"]), int(tcfg["enc_layers"]),
            int(tcfg["dim_feedforward"]), self.num_proxy_points, self.num_groups,
            self.num_frames, int(tcfg.get("sequence_stride", 1)),
            int(tcfg["use_mlp_mixer"]["hidden_dim"]), self.grid_size,
            float(tcfg.get("dropout", 0.1)))
        self.class_embed = nn.Linear(self.hidden_dim, 1)
        if self.uses_bbox_embed:
            self.bbox_embed = nn.ModuleList(MLP(self.hidden_dim, t_hidden, code * num_class, 4)
                                            for _ in range(self.num_groups))
        self.grid_pos_embeded = MLP(3, 256, self.hidden_dim, 2)
        layers = []
        for mlp in pool["MLPS"]:
            dims = [3 + geo_ch] + [int(c) for c in mlp]
            layers.append(nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])))
        self.roi_grid_pool_layers = nn.ModuleList(layers)

    def roi_grid_pool(self, src_xyz, src_feat, trajectory, valid_mask):
        """Ball-query pooling of the cropped points' features around each
        frame's proxy points (mppnet_head.py:403-442): src_xyz (BR, F * K,
        3), src_feat (BR, F * K, Cg), trajectory (BR, F, 7).  Returns
        ((BR, F * g^3, hidden), the global proxy points (BR, F * g^3, 3))."""
        br, f = trajectory.shape[:2]
        k, g3 = self.num_lidar_points, self.num_proxy_points
        proxy_g, _ = proxy_points_of_roi(trajectory, self.grid_size)
        xyz_f = src_xyz.reshape(br * f, k, 3)
        feat_f = src_feat.reshape(br * f, k, -1)
        new_f = proxy_g.reshape(br * f, g3, 3)
        valid_f = valid_mask.reshape(br * f, k)
        pooled = []
        for radius, ns, layers in zip(self.pool_radii, self.pool_nsamples,
                                      self.roi_grid_pool_layers):
            x, _, empty, _ = query_and_group(radius, ns, xyz_f, new_f, feat_f, valid=valid_f)
            for layer in layers:
                x = torch.relu(layer(x))
            pooled.append(x.max(dim=2).values * (~empty)[..., None].to(x.dtype))
        return torch.cat(pooled, dim=-1).reshape(br, f * g3, -1), proxy_g.reshape(br, f * g3, 3)

    def _anchor_offsets(self, pts, roi):
        """Spherical coordinates of (BR, N, 3) points from the 8 corners and
        the centre of (BR, 7) boxes."""
        br = roi.shape[0]
        anchor = torch.cat([corner_points_of_roi(roi).reshape(br, 24), roi[:, 0:3]], dim=-1)
        rel = pts.repeat(1, 1, 9) - anchor[:, None, :]
        diag = torch.linalg.norm(roi[:, 3:6], dim=-1)[:, None, None]
        return spherical_coordinate(rel, diag)

    def geometry_features(self, src, trajectory, valid_pts):
        """Proposal-aware point features, pooled at the proxy points
        (mppnet_head.py:551-575): src (BR, F * K, C) cropped points,
        trajectory (BR, F, 7)."""
        k = self.num_lidar_points
        geo = torch.cat([self._anchor_offsets(src[:, i * k:(i + 1) * k, 0:3], trajectory[:, i])
                         for i in range(trajectory.shape[1])], dim=1)
        geo = self.up_dimension_geometry(torch.cat([geo, src[..., 3:]], dim=-1))
        return self.roi_grid_pool(src[..., 0:3], geo, trajectory, valid_pts)

    def motion_features(self, proxy, trajectory):
        """Proxy points against the frame-0 box, with each frame's time
        (mppnet_head.py:577-606)."""
        br, n, _ = proxy.shape
        sph = self._anchor_offsets(proxy, trajectory[:, 0])
        frame_ids = torch.arange(self.num_frames, dtype=proxy.dtype, device=proxy.device)
        frame_ids = frame_ids.repeat_interleave(self.num_proxy_points) * 0.1
        zero = torch.zeros_like(frame_ids)
        time_pad = torch.stack([zero, zero, frame_ids], dim=-1)[None].expand(br, n, 3)
        return self.up_dimension_motion(torch.cat([sph, time_pad], dim=-1))

    def trajectory_branch(self, trajectory):
        """The box sequence (BR, F, D) in the frame-0 box's frame, with each
        frame's time, through ``seqboxembed`` (mppnet_head.py:608-633)."""
        br, f, _ = trajectory.shape
        ts = (torch.arange(f, dtype=trajectory.dtype, device=trajectory.device) * 0.1)
        xyz = trajectory[..., 0:3] - trajectory[:, 0:1, 0:3]
        ry0 = torch.remainder(trajectory[:, 0, 6], 2 * math.pi)
        seq = torch.cat([rotate_z(xyz, -ry0[:, None]), trajectory[..., 3:6],
                         torch.zeros_like(trajectory[..., 6:7]),
                         ts[None, :, None].expand(br, f, 1)], dim=-1)
        return self.seqboxembed(seq)

    def _empty_mask(self, feat, trajectory):
        if self.model_cfg.get("USE_TRAJ_EMPTY_MASK", True):
            empty = trajectory[:, 0, :, :6].sum(-1) == 0  # (B, R)
            feat = feat * (~empty).reshape(-1, 1, 1).to(feat.dtype)
        return feat

    def _positions(self, device):
        pos = self.grid_pos_embeded(grid_index(self.grid_size, device=device))
        return torch.cat([pos.new_zeros((1, self.hidden_dim)), pos], dim=0)

    def forward(self, batch):
        trajectory, valid_length = batch["trajectory_rois"], batch["valid_length"]
        b, f, r, d = trajectory.shape
        br = b * r
        gen = batch.get("rngs", {}).get("dropout")
        src = crop_trajectory_points(batch["points"], batch["points_mask"], trajectory,
                                     valid_length, self.num_lidar_points)
        src = src.reshape(br, f * self.num_lidar_points, -1)
        valid_pts = torch.abs(src[..., 0:3]).sum(-1) > 0
        seq = trajectory.transpose(1, 2).reshape(br, f, d)
        geo, proxy = self.geometry_features(src, seq[..., :7], valid_pts)
        feat = self._empty_mask(geo + self.motion_features(proxy, seq[..., :7]), trajectory)
        box_reg, feat_box = self.trajectory_branch(seq)
        hs, token_list = self.transformer(feat, self._positions(feat.device), gen)
        point_cls = torch.stack([self.class_embed(tok[0]) for tok in token_list], dim=0)
        point_reg = torch.stack([self.bbox_embed[gi](tok[gi]) for gi in range(self.num_groups)
                                 for tok in token_list], dim=0)
        joint_reg = self.jointembed(torch.cat([hs.transpose(0, 1).reshape(br, -1), feat_box], -1))
        batch["mppnet_preds"] = {"rcnn_cls": point_cls, "rcnn_reg": joint_reg,
                                 "point_reg": point_reg, "box_reg": box_reg}
        batch["batch_cls_preds"] = point_cls[-1].reshape(b, r, 1)
        batch["batch_box_preds"] = self.decode_boxes(trajectory[:, 0, :, :7],
                                                     joint_reg.reshape(b, r, -1))
        batch["cls_preds_normalized"] = False
        return batch

    def decode_boxes(self, rois, reg):
        """The canonical regression against ``rois`` (mppnet_head.py:962-999)."""
        local = torch.cat([torch.zeros_like(rois[..., 0:3]), rois[..., 3:6],
                           torch.zeros_like(rois[..., 6:7])], dim=-1)
        dec = self.box_coder.decode(reg[..., :7], local)
        rot = rotate_z(dec[..., 0:3], rois[..., 6])
        return torch.cat([rot + rois[..., 0:3], dec[..., 3:6], dec[..., 6:7] + rois[..., 6:7]],
                         dim=-1)


def mppnet_loss(preds, targets, loss_cfg, box_coder=None):
    """MPPNet's training loss (mppnet_head.py:801-960; ``com_tpu``'s
    ``mppnet_loss``): ``preds`` the head's ``mppnet_preds`` (rcnn_cls (L,
    BR, 1), rcnn_reg (BR, 7), point_reg (G * L, BR, 7), box_reg (BR, 7));
    ``targets`` a dict (or ``MPPNetTargets``) with rois (B, R, 7),
    gt_of_rois_ct, gt_of_rois_src (B, R, 7), cls_labels and reg_valid (B,
    R).  The class loss is each layer's BCE against the soft IoU labels
    (probabilities clipped to [1e-7, 1]), over the labelled RoIs, averaged
    over the layers; the regression a smooth-L1 (beta 1) against the
    ``ResidualCoder`` encoding of the canonical GT on size-only anchors,
    over the foregrounds, for the joint, the sequence and the mean of the
    per-(group, layer) heads, weighted by ``traj_reg_weight``; with
    CORNER_LOSS_REGULARIZATION the joint boxes' corner loss.  Returns
    (total, {"rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner"})."""
    if hasattr(targets, "_asdict"):
        targets = targets._asdict()
    w = loss_cfg["LOSS_WEIGHTS"]
    coder = box_coder or ResidualCoder()
    rois = targets["rois"].reshape(-1, 7)
    code_w = torch.as_tensor(list(w["code_weights"]), dtype=torch.float32, device=rois.device)
    gt_ct = targets["gt_of_rois_ct"].reshape(-1, 7)
    gt_src = targets["gt_of_rois_src"].reshape(-1, 7)
    cls_labels = targets["cls_labels"].reshape(-1)
    fg = targets["reg_valid"].reshape(-1).to(torch.float32)
    fg_sum = torch.clamp(fg.sum(), min=1.0)

    cls_valid = (cls_labels >= 0).to(torch.float32)
    labels = torch.clamp(cls_labels, 0.0, 1.0)[None]
    p = torch.sigmoid(preds["rcnn_cls"][..., 0])  # (L, BR)
    bce = -(labels * torch.log(torch.clamp(p, 1e-7, 1.0))
            + (1 - labels) * torch.log(torch.clamp(1 - p, 1e-7, 1.0)))
    loss_cls = (bce * cls_valid[None]).sum(dim=1) / torch.clamp(cls_valid.sum(), min=1.0)
    loss_cls = loss_cls.mean() * float(w["rcnn_cls_weight"])

    anchor = torch.cat([torch.zeros_like(rois[:, 0:3]), rois[:, 3:6],
                        torch.zeros_like(rois[:, 6:7])], dim=-1)
    reg_targets = coder.encode(gt_ct, anchor)

    def smooth_l1(pred):
        diff = (pred - reg_targets) * code_w[None]
        ad = torch.abs(diff)
        per = torch.where(ad < 1.0, 0.5 * diff ** 2, ad - 0.5)
        return (per.sum(-1) * fg).sum() / fg_sum

    reg_w = float(w["rcnn_reg_weight"])
    traj_w = [float(x) for x in w.get("traj_reg_weight", [2.0, 2.0, 2.0])]
    gl = preds["point_reg"].shape[0]
    loss_reg = (smooth_l1(preds["rcnn_reg"]) * reg_w * traj_w[0]
                + sum(smooth_l1(preds["point_reg"][i]) for i in range(gl)) / gl * reg_w
                * traj_w[2]
                + smooth_l1(preds["box_reg"]) * reg_w * traj_w[1])

    loss_corner = torch.zeros((), device=rois.device)
    if loss_cfg.get("CORNER_LOSS_REGULARIZATION", False):
        dec = coder.decode(preds["rcnn_reg"][:, :7], anchor)
        boxes = torch.cat([rotate_z(dec[..., 0:3], rois[:, 6]) + rois[:, 0:3], dec[..., 3:6],
                           dec[..., 6:7] + rois[:, 6:7]], dim=-1)
        loss_corner = ((corner_loss(boxes, gt_src) * fg).sum() / fg_sum
                       * float(w["rcnn_corner_weight"]))
    total = loss_cls + loss_reg + loss_corner
    return total, {"rcnn_loss_cls": loss_cls, "rcnn_loss_reg": loss_reg,
                   "rcnn_loss_corner": loss_corner}
