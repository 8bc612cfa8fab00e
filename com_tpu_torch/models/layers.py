"""Shared building blocks over NHWC tensors: batch norm, conv, ConvBNReLU.

Counterpart of ``com_tpu/models/layers.py``.  Activations stay NHWC as in
the JAX package; weights keep PyTorch's layouts and pcdet's names (Conv2d
(O, I, kH, kW), BatchNorm weight/bias/running_mean/running_var), so a
pcdet state_dict loads as it is.  Library convs see the NHWC tensor as a
channels_last NCHW view, which costs no copy.

In training mode the norms normalise with batch statistics as flax's
``nn.BatchNorm`` and the JAX package's ``MaskedBatchNorm`` do (f32, biased
variance E[x^2] - E[x]^2 clipped at 0) and update their running statistics
with flax's momentum 0.99; torch's own batch norm would keep the unbiased
variance, and its running statistics would drift from the JAX package's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv2d import conv3x3
from ..parallel.sharding import global_sum


class BatchNorm(nn.Module):
    """Batch norm over the last axis, in f32, cast back to the input dtype
    (f32 statistics under mixed precision)."""

    MOMENTUM = 0.99  # flax's: the share of the old running statistics kept

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

    def _batch_stats(self, x: torch.Tensor, mask: torch.Tensor | None):
        """Mean and biased variance over every axis but the last, in f32;
        with a mask only the rows where it is true count."""
        c = x.shape[-1]
        xf = x.float().reshape(-1, c)
        if mask is None:
            cnt = float(xf.shape[0])
            s, sq = xf.sum(0), (xf * xf).sum(0)
        else:
            m = mask.reshape(-1, 1).to(torch.float32)
            cnt = m.sum()
            s, sq = (xf * m).sum(0), (xf * xf * m).sum(0)
        # under a data mesh the statistics are the whole batch's, as flax's
        # norm computes them under SPMD (SyncBatchNorm: the backward of the
        # all-reduce reduces the sums' gradients too)
        s, sq, cnt = global_sum(s, sq, cnt)
        if mask is not None:
            cnt = torch.clamp(cnt, min=1.0)
        mean = s / cnt
        return mean, torch.clamp(sq / cnt - mean * mean, min=0.0)

    VAR_SHIFT = 0.0  # running_var holds the running variance plus this

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        if self.training:
            mean, var = self._batch_stats(x, mask)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                held = var + self.VAR_SHIFT if self.VAR_SHIFT else var
                self.running_var.copy_(m * self.running_var + (1 - m) * held)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
            if self.VAR_SHIFT:
                var = var - self.VAR_SHIFT
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x.float() - mean) * mul + self.bias).to(x.dtype)


class MaskedBatchNorm(BatchNorm):
    """The PFN's norm: in training its statistics exclude the rows where
    ``mask`` is false (padded and out-of-range points); in eval it is
    BatchNorm and ignores the mask."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        return super().forward(x, mask)


class BatchNorm1d(BatchNorm):
    """The RoI heads' and point stages' norm: the JAX package's (eps 1e-3,
    batch statistics in training) holding its running variance as pcdet's
    ``nn.BatchNorm1d`` (eps 1e-5) would, ``running_var`` = variance + (1e-3
    - 1e-5), so that in eval var + 1e-3 is pcdet's running_var + 1e-5 and
    a pcdet state_dict's statistics read as they are.  The point stages
    (PFE, point head, PV-RCNN's grid pool) pass a mask, as
    ``MaskedBatchNorm``."""

    VAR_SHIFT = 1e-3 - 1e-5

    def __init__(self, features: int):
        super().__init__(features)
        self.running_var.fill_(1.0 + self.VAR_SHIFT)


class Conv1x1(nn.Module):
    """pcdet's ``nn.Conv1d(kernel_size=1)`` (``ndim`` 1) or ``nn.Conv2d(
    kernel_size=1)`` (``ndim`` 2, the pointnet2 shared MLPs) over the last
    axis: weight (O, I, 1) or (O, I, 1, 1), as its state_dict holds it."""

    def __init__(self, cin: int, cout: int, bias: bool = False, ndim: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *([1] * ndim)))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight.reshape(self.weight.shape[:2]), self.bias)


class Conv2d(nn.Module):
    """Square conv over NHWC input with symmetric padding kernel // 2.

    Stride-1, bias-free 3x3 convs run on ``conv3x3`` (kernel K2); every other
    shape (strided, with bias, other sizes) is a library conv.  ``dtype``
    casts input and weight for the product (bf16 under mixed precision)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = False, dtype=None, padding: int | None = None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.padding = kernel // 2 if padding is None else padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x = x.to(dt)
        w = self.weight.to(dt)
        if self.kernel == 3 and self.stride == 1 and self.padding == 1 and self.bias is None:
            return conv3x3(x.contiguous(), w.permute(2, 3, 1, 0).contiguous())
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1).contiguous()


class ConvBNReLU(nn.Sequential):
    """Conv + BN + ReLU over NHWC; children ``0`` (conv) and ``1`` (norm)
    as in pcdet's Sequential blocks."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 bias: bool = False, eps: float = 1e-3, dtype=None):
        super().__init__(Conv2d(cin, cout, kernel, stride, bias=bias, dtype=dtype),
                         BatchNorm(cout, eps=eps), nn.ReLU())
