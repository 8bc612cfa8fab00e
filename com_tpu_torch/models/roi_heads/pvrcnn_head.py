"""RoI grid points (counterpart of ``com_tpu/models/roi_heads/pvrcnn_head.py``
``roi_grid_points``).  The PV-RCNN heads wait for the keypoint encoder
(PFE): their names raise."""
from __future__ import annotations

import numpy as np
import torch

from ...utils.registry import ROI_HEADS


def roi_grid_points(rois: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(..., R, 7) RoIs -> (..., R, G^3, 3) world-frame grid points: the
    centres of a G x G x G lattice over each box, (x, y, z) index order
    row-major, rotated by the box's heading."""
    g = grid_size
    idx = np.stack(np.meshgrid(*([np.arange(g)] * 3), indexing="ij"), -1).reshape(-1, 3)
    frac = torch.as_tensor((idx + 0.5) / g - 0.5, dtype=torch.float32, device=rois.device)
    local = frac * rois[..., None, 3:6]
    cos, sin = torch.cos(rois[..., 6])[..., None], torch.sin(rois[..., 6])[..., None]
    x = local[..., 0] * cos - local[..., 1] * sin
    y = local[..., 0] * sin + local[..., 1] * cos
    return torch.stack([x, y, local[..., 2]], dim=-1) + rois[..., None, :3]


ROI_HEADS.register_unported("PVRCNNHead", "RoI-grid pooling over PV-RCNN's keypoints")
ROI_HEADS.register_unported("PVRCNNPlusPlusHead", "PV-RCNN++'s vector-pool RoI grid")
ROI_HEADS.register_unported("PartA2FCHead", "PartA2's RoI-aware pooling")
ROI_HEADS.register_unported("PointRCNNHead", "PointRCNN's canonical point pooling")
ROI_HEADS.register_unported("MPPNetHead", "MPPNet's multi-frame proxy points")
ROI_HEADS.register_unported("MPPNetHeadE2E", "MPPNet's multi-frame proxy points")
