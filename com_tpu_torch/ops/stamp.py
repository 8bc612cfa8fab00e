"""Per-object window stamping onto a dense canvas (kernel K3).

Counterpart of ``com_tpu/ops/pallas/stamp.py``: the heatmap targets (gauss
mode) and the COM loss mask (last_wins mode) of the training step.
``stamp_windows`` launches the CUDA kernel (``csrc/stamp.cu``) for a CUDA
tensor and runs the plain versions of ``ops.gaussian`` for a CPU tensor.
Both routes see the objects after the TPU kernel's preprocessing: centers
clamped into the map, radius clamped to [0, R], -1 for an invalid object,
class clamped (``_preprocess`` on the plain route, the kernel itself on the
card).
"""
from __future__ import annotations

import torch

from . import _kernels
from . import gaussian as _gaussian

gauss_launches = 0      # K3 launches in gauss mode since the last reset
last_wins_launches = 0  # K3 launches in last_wins mode since the last reset

_MODES = {"gauss": 0, "last_wins": 1}
_INT64_BIT = {torch.int32: 0, torch.int64: 1}  # the id dtypes the kernel reads
_WHAT = {mode: f"stamp_windows {mode} (K3)" for mode in _MODES}


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
        radii, class_ids: (B, N) integers; values: (B, N) float (last_wins;
            may be None in gauss mode, which does not read it);
        valid: (B, N) bool.
        mode: "gauss" (max of gaussians over ``fill``; stamped values are
            > 0) or "last_wins" (per-object constant squares over ``fill``).

    Returns:
        (B, num_classes, fmap_h, fmap_w) float32.

    On a CUDA tensor the call allocates the output and makes one C call: the
    kernel clamps the objects itself and reads int32 or int64 ids and
    float32 values as the callers hold them; other dtypes raise TypeError.
    """
    if mode not in _MODES:
        raise ValueError(f"stamp_windows: mode must be 'gauss' or 'last_wins', got {mode!r}")
    if not 0 <= int(max_radius) <= _gaussian.MAX_STAMP_RADIUS:
        raise ValueError(f"stamp_windows: max_radius {max_radius} outside [0, 16]")
    if values is None and mode != "gauss":
        raise ValueError("stamp_windows: last_wins needs values")
    if not radii.is_cuda:
        if radii.device.type == "cpu":
            return stamp_windows_plain(centers, radii, class_ids, values, valid, num_classes,
                                       fmap_h, fmap_w, mode, fill, max_radius)
        raise ValueError(f"stamp_windows: unsupported device {radii.device}")
    b, n = radii.shape
    index = radii.get_device()
    ins = [centers, radii, class_ids, valid] + ([] if values is None else [values])
    int64_mask = 0
    for i, t in enumerate(ins):
        if t.shape != ((b, n, 2) if i == 0 else (b, n)):
            raise ValueError(f"stamp_windows: centers {tuple(centers.shape)} and radii, "
                             f"class_ids, valid, values {[tuple(u.shape) for u in ins[1:]]}: "
                             f"want (B, N, 2) and (B, N)")
        want = (_INT64_BIT if i < 3 else (torch.bool,) if i == 3 else (torch.float32,))
        if t.dtype not in want:
            raise TypeError("stamp_windows: centers, radii and class_ids int32 or int64, "
                            "values float32, valid bool")
        if t.get_device() != index or not t.is_contiguous():
            raise ValueError("stamp_windows: inputs must be contiguous on one device")
        if i < 3:
            int64_mask |= _INT64_BIT[t.dtype] << i
    out = torch.empty((b, num_classes, fmap_h, fmap_w), dtype=torch.float32, device=radii.device)
    if out.numel() == 0:
        return out
    _kernels.launch("stamp", "k3_stamp", _WHAT[mode], index, centers.data_ptr(),
                    radii.data_ptr(), class_ids.data_ptr(),
                    None if values is None else values.data_ptr(), valid.data_ptr(),
                    out.data_ptr(), b, n, num_classes, fmap_h, fmap_w, int(max_radius),
                    _MODES[mode], int64_mask, float(fill))
    global gauss_launches, last_wins_launches
    if mode == "gauss":
        gauss_launches += 1
    else:
        last_wins_launches += 1
    return out
