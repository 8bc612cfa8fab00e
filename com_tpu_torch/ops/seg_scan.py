"""Per-point run totals over pillar-sorted rows (kernel K1), with gradient.

Counterpart of ``com_tpu/ops/pallas/seg_scan.py``: the dynamic-pillar VFE
reduces over the points of each pillar and broadcasts the result back to
every point, for the cluster mean (sum) and the PFN max feedback (max).  With
points sorted by pillar id each pillar is a contiguous run.

K1 is reached through two registered ops (``torch.library.custom_op``),
so that ``torch.export`` traces a step through them and a loaded program
calls them: ``com_tpu_torch::run_bcast`` (the forward, sum or max) and
``com_tpu_torch::run_bcast_bwd`` (the backward).  The forward's gradient,
registered with ``register_autograd``, is the JAX package's VJP
(``seg_scan.py:277-299``): for sum, the run sum of g (one K1 sum); for max,
``tied * gsum / max(nties, 1)``, the run's gradient split evenly over its
tied maxima, in one fused kernel call that sums g and counts the ties in
f32 and rounds once.  Each op launches the CUDA kernels
(``csrc/seg_scan.cu``, entry ``k1_call``) for a CUDA tensor and runs the
plain version (``run_bcast_plain``, ``run_bcast_max_bwd_plain``) for a CPU
tensor; its fake implementation gives shapes only.  There is no other
route.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _kernels

launches = 0      # run_bcast forward calls that launched K1 since the last reset
bwd_launches = 0  # K1 sum or max-backward launches by run_bcast's backward since the last reset

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_OPS = {"sum": 0, "max": 1, "max_bwd": 2}
_WHAT = {op: f"run_bcast {op} (K1)" for op in _OPS}


def run_bcast_plain(vals: torch.Tensor, seg: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """Plain PyTorch version: per-sample segment table over compact run ranks
    (``_run_bcast_ref`` semantics), reduced in f32 (f64 for f64 input, which
    only the gradient checks use), cast back to the input dtype.  A run is a
    maximal stretch of equal consecutive ids."""
    b, n, c = vals.shape
    first = torch.ones((b, n), dtype=torch.bool, device=vals.device)
    first[:, 1:] = seg[:, 1:] != seg[:, :-1]
    rank = torch.cumsum(first.to(torch.int64), dim=1) - 1
    idx = (rank + torch.arange(b, device=vals.device)[:, None] * n).reshape(-1)
    acc = torch.promote_types(vals.dtype, torch.float32)
    v = vals.reshape(b * n, c).to(acc)
    if op == "sum":
        table = torch.zeros((b * n, c), dtype=acc, device=vals.device)
        table = table.index_add(0, idx, v)
    else:
        table = torch.full((b * n, c), -math.inf, dtype=acc, device=vals.device)
        table = table.scatter_reduce(0, idx[:, None].expand(-1, c), v, "amax", include_self=True)
        table = torch.where(torch.isfinite(table), table, torch.zeros((), dtype=table.dtype,
                                                                      device=table.device))
    return table[idx].reshape(b, n, c).to(vals.dtype)


def run_bcast_max_bwd_plain(g: torch.Tensor, vals: torch.Tensor, out: torch.Tensor,
                            seg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the max's backward (``seg_scan.py:284-299``):
    each run's sum of g split evenly over its tied maxima (rows where vals ==
    out), computed in f32 (f64 for f64 input) and cast once to vals' dtype."""
    acc = torch.promote_types(vals.dtype, torch.float32)
    tied = (vals == out).to(acc)
    gsum = run_bcast_plain(g.to(acc), seg, "sum")
    nties = run_bcast_plain(tied, seg, "sum")
    return (tied * gsum / torch.clamp(nties, min=1.0)).to(vals.dtype)


def _check(what: str, seg: torch.Tensor, *ts: torch.Tensor) -> None:
    """What the kernels take: (B, N, C) f32/bf16 tensors of one dtype and
    (B, N) int32 ids, all contiguous on one CUDA device."""
    v = ts[0]
    if v.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {v.device}")
    if v.dim() != 3 or seg.shape != v.shape[:2] or any(t.shape != v.shape for t in ts):
        raise ValueError(f"{what}: {[tuple(t.shape) for t in ts]} and seg {tuple(seg.shape)}")
    if v.dtype not in _DTYPES or any(t.dtype != v.dtype for t in ts) or seg.dtype != torch.int32:
        raise TypeError(f"{what}: {[t.dtype for t in ts]} (want one of f32/bf16), "
                        f"seg {seg.dtype} (want int32)")
    if any(t.device != v.device or not t.is_contiguous() for t in (*ts, seg)):
        raise ValueError(f"{what}: tensors must be contiguous on one device")


_tile_rows: dict[tuple[int, int, int], int] = {}  # (C, dtype code, op) -> k1_tile_rows


def _scratch(vals: torch.Tensor, op: int, rows: int) -> torch.Tensor:
    """One call's f32 scratch for tiles of ``rows`` rows (``k1_tile_rows``):
    the head and tail partials of the tiles and their carries, (4, B, tiles,
    C) values of one f32 (op 0, 1) or a pair (op 2, the max backward)."""
    b, n, c = vals.shape
    return torch.empty((4, b, -(-n // rows), c, 2 if op == 2 else 1), dtype=torch.float32,
                       device=vals.device)


def _launch(op: str, seg: torch.Tensor, vals: torch.Tensor, counter: str,
            g: torch.Tensor | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """One K1 call on CUDA tensors (``k1_call``): the run totals of vals (op
    "sum" or "max"), or the max's backward from g, vals and the forward's
    out (op "max_bwd").  The launch adds one to the module counter named
    ``counter`` (``launches`` or ``bwd_launches``)."""
    _check(f"run_bcast {op}", seg, *(t for t in (g, vals, out) if t is not None))
    b, n, c = vals.shape
    y = torch.empty_like(vals)
    if y.numel() == 0:
        return y
    code = _OPS[op]
    key = (c, _DTYPES[vals.dtype], code)
    rows = _tile_rows.get(key)
    if rows is None:  # the library is asked once for each (C, dtype, op)
        rows = _tile_rows[key] = _kernels.library("seg_scan").k1_tile_rows(*key)
    scratch = _scratch(vals, code, rows)
    ptrs = (None if t is None else t.data_ptr() for t in (g, vals, out, seg, y, scratch))
    _kernels.launch("seg_scan", "k1_call", _WHAT[op], vals.get_device(), *ptrs, b, n, c, code,
                    _DTYPES[vals.dtype])
    globals()[counter] += 1
    return y


def _k1(vals: torch.Tensor, seg: torch.Tensor, op: str, counter: str) -> torch.Tensor:
    """One K1 sum or max: the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if vals.device.type == "cpu":
        return run_bcast_plain(vals, seg, op)
    return _launch(op, seg, vals, counter)


@torch.library.custom_op("com_tpu_torch::run_bcast", mutates_args=(), device_types=("cpu", "cuda"))
def _run_bcast_op(vals: torch.Tensor, seg: torch.Tensor, op: str) -> torch.Tensor:
    """K1 forward as a registered op: the kernel for CUDA tensors (counted in
    ``launches``), the plain version for CPU tensors."""
    return _k1(vals, seg, op, "launches")


@_run_bcast_op.register_fake
def _(vals, seg, op):
    return torch.empty_like(vals)


@torch.library.custom_op("com_tpu_torch::run_bcast_bwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _run_bcast_bwd_op(g: torch.Tensor, seg: torch.Tensor, vals: Optional[torch.Tensor],
                      out: Optional[torch.Tensor]) -> torch.Tensor:
    """K1's backward as a registered op, counted in ``bwd_launches``: the sum's
    (the run sum of g) when vals and out are None, else the max's from the
    forward's input vals and output out."""
    if vals is None:
        return _k1(g, seg, "sum", "bwd_launches")
    if vals.device.type == "cpu":
        return run_bcast_max_bwd_plain(g, vals, out, seg)
    return _launch("max_bwd", seg, vals, "bwd_launches", g, out)


@_run_bcast_bwd_op.register_fake
def _(g, seg, vals, out):
    return torch.empty_like(g if vals is None else vals)


def run_bcast_max_bwd(g: torch.Tensor, vals: torch.Tensor, out: torch.Tensor,
                      seg: torch.Tensor) -> torch.Tensor:
    """The max's backward in one kernel for CUDA tensors (counted in
    ``bwd_launches``), ``run_bcast_max_bwd_plain`` for CPU tensors.  g, vals
    (the forward's input) and out (its output): (B, N, C) in one dtype;
    returns dvals in that dtype."""
    _kernels.check_device("run_bcast max_bwd", vals)
    return _run_bcast_bwd_op(g, seg, vals, out)


def _setup_context(ctx, inputs, output):
    vals, seg, op = inputs
    ctx.op = op
    if op == "max":
        ctx.save_for_backward(seg, vals, output)
    else:
        ctx.save_for_backward(seg)


def _backward(ctx, grad):
    seg = ctx.saved_tensors[0]
    g = grad.contiguous()
    if ctx.op == "sum":
        return _run_bcast_bwd_op(g, seg, None, None), None, None
    # split the run's gradient evenly over tied maxima (under bf16 several
    # points of a pillar often round to the same max); looked up by name at
    # call time, so that a diagnostic may patch it
    _, vals, out = ctx.saved_tensors
    return run_bcast_max_bwd(g, vals, out, seg), None, None


_run_bcast_op.register_autograd(_backward, setup_context=_setup_context)


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
    _kernels.check_device(f"run_bcast {op}", vals)
    return _run_bcast_op(vals, seg, op)
