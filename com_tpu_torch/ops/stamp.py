"""Per-object window stamping onto a dense canvas (kernel K3).

Counterpart of ``com_tpu/ops/pallas/stamp.py``: the heatmap targets (gauss
mode) and the COM loss mask (last_wins mode) of the training step.
``stamp_windows`` launches the CUDA kernel (``csrc/stamp.cu``) for a CUDA
tensor and runs the plain versions of ``ops.gaussian`` for a CPU tensor.
Both routes see the objects after the TPU kernel's preprocessing: centers
clamped into the map, radius clamped to [0, R], -1 for an invalid object,
class clamped.
"""
from __future__ import annotations

import torch

from . import _kernels
from . import gaussian as _gaussian

gauss_launches = 0      # K3 launches in gauss mode since the last reset
last_wins_launches = 0  # K3 launches in last_wins mode since the last reset

_MODES = {"gauss": 0, "last_wins": 1}


def _preprocess(centers, radii, class_ids, valid, num_classes, fmap_h, fmap_w, max_radius):
    """``_stamp_pallas``'s object preprocessing (stamp.py:130-133), int32."""
    cx = torch.clamp(centers[..., 0].to(torch.int32), 0, fmap_w - 1)
    cy = torch.clamp(centers[..., 1].to(torch.int32), 0, fmap_h - 1)
    rr = torch.where(valid, torch.clamp(radii.to(torch.int32), 0, max_radius),
                     torch.full_like(radii, -1, dtype=torch.int32))
    cls = torch.clamp(class_ids.to(torch.int32), 0, num_classes - 1)
    return cx, cy, rr, cls


def stamp_windows_plain(centers, radii, class_ids, values, valid, num_classes, fmap_h, fmap_w,
                        mode, fill=0.0, max_radius=_gaussian.MAX_STAMP_RADIUS):
    """Plain PyTorch version over the preprocessed objects."""
    cx, cy, rr, cls = _preprocess(centers, radii, class_ids, valid, num_classes, fmap_h, fmap_w,
                                  max_radius)
    c = torch.stack([cx, cy], dim=-1)
    ok = rr >= 0
    if mode == "gauss":
        return _gaussian.draw_gaussians(c, rr, cls, ok, num_classes, fmap_h, fmap_w,
                                        max_radius, fill=float(fill))
    return _gaussian.stamp_squares_last_wins(c, rr, cls, values, ok, num_classes, fmap_h,
                                             fmap_w, fill=float(fill), max_radius=max_radius)


def stamp_windows(centers, radii, class_ids, values, valid, num_classes, fmap_h, fmap_w, mode,
                  fill=0.0, max_radius=_gaussian.MAX_STAMP_RADIUS):
    """Batched window stamping.

    Args:
        centers: (B, N, 2) integer [x, y] cells.
        radii, class_ids: (B, N) integers; values: (B, N) float (last_wins);
        valid: (B, N) bool.
        mode: "gauss" (max of gaussians over ``fill``; stamped values are
            > 0) or "last_wins" (per-object constant squares over ``fill``).

    Returns:
        (B, num_classes, fmap_h, fmap_w) float32.
    """
    if mode not in _MODES:
        raise ValueError(f"stamp_windows: mode must be 'gauss' or 'last_wins', got {mode!r}")
    if not 0 <= int(max_radius) <= _gaussian.MAX_STAMP_RADIUS:
        raise ValueError(f"stamp_windows: max_radius {max_radius} outside [0, 16]")
    if radii.device.type == "cpu":
        return stamp_windows_plain(centers, radii, class_ids, values, valid, num_classes, fmap_h,
                                   fmap_w, mode, fill, max_radius)
    if radii.device.type != "cuda":
        raise ValueError(f"stamp_windows: unsupported device {radii.device}")
    b, n = radii.shape
    if (tuple(centers.shape) != (b, n, 2) or class_ids.shape != radii.shape
            or values.shape != radii.shape or valid.shape != radii.shape):
        raise ValueError(f"stamp_windows: centers {tuple(centers.shape)}, radii {tuple(radii.shape)}, "
                         f"class_ids {tuple(class_ids.shape)}, values {tuple(values.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if (valid.dtype != torch.bool or not values.dtype.is_floating_point
            or any(t.dtype.is_floating_point for t in (centers, radii, class_ids))):
        raise TypeError("stamp_windows: centers, radii and class_ids integer, values float, "
                        "valid bool")
    if any(t.device != radii.device for t in (centers, class_ids, values, valid)):
        raise ValueError("stamp_windows: all inputs on one device")
    cx, cy, rr, cls = (t.contiguous() for t in _preprocess(
        centers, radii, class_ids, valid, num_classes, fmap_h, fmap_w, int(max_radius)))
    vals = values.to(torch.float32).contiguous()
    out = torch.empty((b, num_classes, fmap_h, fmap_w), dtype=torch.float32, device=radii.device)
    if out.numel() == 0:
        return out
    winner = (torch.empty(out.shape, dtype=torch.int32, device=out.device)
              if mode == "last_wins" else None)
    lib = _kernels.library("stamp")
    with torch.cuda.device(out.device):
        err = lib.k3_stamp(cx.data_ptr(), cy.data_ptr(), rr.data_ptr(), cls.data_ptr(),
                           vals.data_ptr(), out.data_ptr(),
                           None if winner is None else winner.data_ptr(),
                           b, n, num_classes, fmap_h, fmap_w, _MODES[mode], float(fill),
                           _kernels.stream_of(out))
    _kernels.check(err, f"stamp_windows {mode} (K3)")
    global gauss_launches, last_wins_launches
    if mode == "gauss":
        gauss_launches += 1
    else:
        last_wins_launches += 1
    return out
