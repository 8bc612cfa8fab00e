"""Per-point run totals over pillar-sorted rows (kernel K1), with gradient.

Counterpart of ``com_tpu/ops/pallas/seg_scan.py``: the dynamic-pillar VFE
reduces over the points of each pillar and broadcasts the result back to
every point, for the cluster mean (sum) and the PFN max feedback (max).  With
points sorted by pillar id each pillar is a contiguous run.

``run_bcast`` is a ``torch.autograd.Function`` whose backward is the JAX
package's VJP (``seg_scan.py:277-299``), built from K1 sums: for sum, the
run sum of g; for max, ``tied * gsum / max(nties, 1)``, the run's gradient
split evenly over its tied maxima.  Every K1 call, forward or backward,
launches the CUDA kernel (``csrc/seg_scan.cu``) for a CUDA tensor and runs
``run_bcast_plain`` for a CPU tensor; there is no other route.
"""
from __future__ import annotations

import math

import torch

from . import _kernels

launches = 0      # K1 launches by run_bcast's forward since the last reset
bwd_launches = 0  # K1 (sum) launches by run_bcast's backward since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def run_bcast_plain(vals: torch.Tensor, seg: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Plain PyTorch version: per-sample segment table over compact run ranks
    (``_run_bcast_ref`` semantics), reduced in f32, cast back to the input
    dtype.  A run is a maximal stretch of equal consecutive ids."""
    b, n, c = vals.shape
    first = torch.ones((b, n), dtype=torch.bool, device=vals.device)
    first[:, 1:] = seg[:, 1:] != seg[:, :-1]
    rank = torch.cumsum(first.to(torch.int64), dim=1) - 1
    idx = (rank + torch.arange(b, device=vals.device)[:, None] * n).reshape(-1)
    v = vals.reshape(b * n, c).float()
    if op == "sum":
        table = torch.zeros((b * n, c), dtype=torch.float32, device=vals.device)
        table = table.index_add(0, idx, v)
    else:
        table = torch.full((b * n, c), -math.inf, dtype=torch.float32, device=vals.device)
        table = table.scatter_reduce(0, idx[:, None].expand(-1, c), v, "amax", include_self=True)
        table = torch.where(torch.isfinite(table), table, torch.zeros((), dtype=table.dtype,
                                                                      device=table.device))
    return table[idx].reshape(b, n, c).to(vals.dtype)


def _k1(vals: torch.Tensor, seg: torch.Tensor, op: str, counter: str) -> torch.Tensor:
    """One K1 call: the kernel for a CUDA tensor, the plain version for a
    CPU tensor.  A launch adds one to the module counter named ``counter``
    (``launches`` or ``bwd_launches``)."""
    if vals.device.type == "cpu":
        return run_bcast_plain(vals, seg, op)
    if vals.device.type != "cuda":
        raise ValueError(f"run_bcast: unsupported device {vals.device}")
    if vals.dim() != 3 or seg.shape != vals.shape[:2]:
        raise ValueError(f"run_bcast: vals {tuple(vals.shape)} and seg {tuple(seg.shape)}")
    if vals.dtype not in _DTYPES or seg.dtype != torch.int32:
        raise TypeError(f"run_bcast: vals {vals.dtype} (want f32/bf16), "
                        f"seg {seg.dtype} (want int32)")
    if seg.device != vals.device or not (vals.is_contiguous() and seg.is_contiguous()):
        raise ValueError("run_bcast: vals and seg must be contiguous on one device")
    b, n, c = vals.shape
    out = torch.empty_like(vals)
    if out.numel() == 0:
        return out
    lib = _kernels.library("seg_scan")
    nt = -(-n // lib.k1_tile_rows())
    head = torch.empty((b, nt, c), dtype=torch.float32, device=vals.device)
    tail = torch.empty_like(head)
    with torch.cuda.device(vals.device):
        err = lib.k1_run_bcast(vals.data_ptr(), seg.data_ptr(), out.data_ptr(),
                               head.data_ptr(), tail.data_ptr(), b, n, c,
                               int(op == "max"), _DTYPES[vals.dtype], _kernels.stream_of(vals))
    _kernels.check(err, "run_bcast (K1)")
    globals()[counter] += 1
    return out


class _RunBcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, seg, op):
        out = _k1(vals, seg, op, "launches")
        ctx.op = op
        if op == "max":
            ctx.save_for_backward(seg, vals, out)
        else:
            ctx.save_for_backward(seg)
        return out

    @staticmethod
    def backward(ctx, g):
        seg = ctx.saved_tensors[0]
        g = g.contiguous()
        gsum = _k1(g, seg, "sum", "bwd_launches")
        if ctx.op == "sum":
            dvals = gsum
        else:
            _, vals, out = ctx.saved_tensors
            # split the run's gradient evenly over tied maxima (under bf16
            # several points of a pillar often round to the same max)
            tied = (vals == out).to(gsum.dtype)
            nties = _k1(tied.contiguous(), seg, "sum", "bwd_launches")
            dvals = tied * gsum / torch.clamp(nties, min=1.0)
        return dvals, None, None


def run_bcast(vals: torch.Tensor, seg: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Per-row run totals, batched per sample, differentiable in ``vals``.

    Args:
        vals: (B, N, C) float32 or bfloat16, contiguous.
        seg: (B, N) int32 ids, sorted within each sample so equal ids are
            contiguous (padded rows carry a large id and sort last).
        op: "sum" or "max".

    Returns:
        (B, N, C) in vals' dtype: at (b, i) the reduction of vals[b] over the
        rows j with seg[b, j] == seg[b, i].
    """
    if op not in ("sum", "max"):
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    return _RunBcast.apply(vals, seg, op)
