"""The active mesh and the reductions XLA makes for ``com_tpu`` under a data
mesh (counterpart of ``com_tpu/parallel/sharding.py``).

``activate(mesh)`` is process-global, as in the JAX package: the mesh is a
per-process training resource, not per-call state.  Under SPMD every batch
sum of ``com_tpu`` is global; the port, one process a rank, makes the same
sums explicit:

* ``global_sum(*tensors)``: one differentiable all-reduce (sum) of the
  tensors, in the batch norms (SyncBatchNorm: the sums, the sums of
  squares and the counts; the all-reduce's backward reduces their
  gradients) and in the losses (numerators, normalisers, the COMLoss and
  anchor EMA statistics);
* ``reduce_gradients(params)``: the gradients before the optimizer;
* ``all_reduce_(*tensors)``: in place, outside autograd (the epoch's
  confidence accumulators; recall counts);
* ``gather_objects(obj)``: every rank's object, in rank order (the eval's
  detections).

With no active mesh, or one without a process group, each is the identity
and issues no collective.  ``constrain`` and ``replicate`` of the JAX
module are left out: on a pure data axis they have nothing to do (the
spatial and model axes are not ported, ``mesh.make_mesh`` raises for them).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_ACTIVE: dict = {"mesh": None}


def activate(mesh) -> None:
    """Set (or clear, with None) the process-global mesh."""
    _ACTIVE["mesh"] = mesh


def active_mesh():
    return _ACTIVE["mesh"]


def _grouped(mesh=None):
    """``mesh`` (default: the active mesh) when it has a process group,
    else None."""
    mesh = mesh or _ACTIVE["mesh"]
    return mesh if mesh is not None and mesh.group is not None else None


class _AllReduceSum(torch.autograd.Function):
    """A sum over the ranks whose backward is the sum of the ranks'
    gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(*values):
    """The sums of ``values`` (tensors or numbers) over every rank, through
    one differentiable all-reduce; the identity without a grouped mesh.

    Convention (the factor-W rule): with these sums every rank computes
    the *global* loss.  The all-reduce's backward sums the ranks' gradients
    of it, so each rank's gradient is W times its shard's share of the
    true gradient, and ``reduce_gradients`` takes the mean over ranks."""
    mesh = _grouped()
    if mesh is None:
        return values[0] if len(values) == 1 else values
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    ref = tensors[0] if tensors else torch.zeros((), device=mesh.device)
    wire = torch.float64 if any(t.dtype == torch.float64 for t in tensors) else torch.float32
    parts = [torch.as_tensor(v, device=ref.device) for v in values]
    flat = _AllReduceSum.apply(torch.cat([p.reshape(-1).to(wire) for p in parts]), mesh.group)
    out, offset = [], 0
    for p in parts:
        dtype = p.dtype if p.is_floating_point() else wire
        out.append(flat[offset:offset + p.numel()].view(p.shape).to(dtype))
        offset += p.numel()
    return out[0] if len(out) == 1 else tuple(out)


def reduce_gradients(params) -> None:
    """Average every parameter's gradient over the ranks, in place: one
    flat all-reduce a dtype (``global_sum``'s convention: the mean).  A
    parameter without a gradient is left so; every rank's graph is the
    same, so it has none on every rank."""
    mesh = _grouped()
    if mesh is None:
        return
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    with torch.no_grad():
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=mesh.group)
            if mesh.world > 1:
                flat.div_(mesh.world)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()


def all_reduce_(*tensors, mesh=None):
    """Sum each tensor over the ranks of ``mesh`` (default: the active
    mesh), in place, outside autograd, in one collective (tensors of one
    dtype and device); the identity without a process group."""
    mesh = _grouped(mesh)
    if mesh is None:
        return tensors
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=mesh.group)
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return tensors


def gather_objects(obj, mesh=None) -> list:
    """Every rank's ``obj`` (picklable) on every rank of ``mesh`` (default:
    the active mesh), in rank order; ``[obj]`` without a process group."""
    mesh = _grouped(mesh)
    if mesh is None:
        return [obj]
    if mesh.backend == "nccl":  # NCCL stages the pickles through the current card
        torch.cuda.set_device(mesh.device)
    out = [None] * mesh.world
    dist.all_gather_object(out, obj, group=mesh.group)
    return out
