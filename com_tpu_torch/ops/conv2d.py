"""3x3 stride-1 SAME convolution over NHWC feature maps (kernel K2).

Counterpart of ``com_tpu/ops/pallas/conv2d.py``: every stride-1, bias-free
3x3 conv of the BEV backbone.  Layouts are the JAX package's: x is
(B, H, W, Cin), w is HWIO (3, 3, Cin, Cout); accumulation is f32 and the
output has x's dtype.

``conv3x3`` launches the CUDA kernel (``csrc/conv3x3.cu``) for a CUDA
tensor and runs ``conv3x3_plain`` for a CPU tensor.  The TPU kernel's split
of wide inputs into <=128-channel slices existed only for the TPU's VMEM
and is not carried over.  Forward only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _kernels

launches = 0  # K2 launches by conv3x3 since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: nine shifted (B*H*W, Cin) @ (Cin, Cout)
    products summed in f32 over the zero-padded input."""
    b, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = None
    for dy in range(3):
        for dx in range(3):
            t = xp[:, dy:dy + h, dx:dx + wd, :] @ wf[dy, dx]
            acc = t if acc is None else acc + t
    return acc.to(x.dtype)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv, NHWC (B, H, W, Cin) x HWIO (3, 3, Cin, Cout)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3: unsupported device {x.device}")
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3: x {tuple(x.shape)} and w {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv3x3: x {x.dtype} and w {w.dtype} (want one of f32/bf16)")
    if w.device != x.device or not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv3x3: x and w must be contiguous on one device")
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = _kernels.library("conv3x3")
    with torch.cuda.device(x.device):
        err = lib.k2_conv3x3(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, cin, cout,
                             _DTYPES[x.dtype], _kernels.stream_of(x))
    _kernels.check(err, "conv3x3 (K2)")
    global launches
    launches += 1
    return y
