"""The data mesh over ``torch.distributed`` (counterpart of
``com_tpu/parallel/mesh.py``, its data axis only).

The JAX package runs one SPMD program over a ``data`` axis of chips: the
batch is sharded, parameters and state are replicated, and XLA makes every
batch reduction global (the gradients, the loss normalisers, the COMLoss
EMA statistics, the batch norms' statistics, the confidence sums).  The
port runs one process a rank, each on its own device with a full replica
of the train state, and makes those reductions itself
(``parallel/sharding.py``): ``global_sum`` in the norms and losses, the
gradient all-reduce before the optimizer, the confidence all-reduce at the
epoch's end.

A ``DataMesh`` is the rank, the world size, the rank's device and the
process group.  A mesh without a group (``make_mesh`` with no group
initialised) is the single process: world 1, no collective.  The spatial
and model axes of the JAX mesh are not ported: ``make_mesh`` raises for
them by name.
"""
from __future__ import annotations

import datetime
import os
import subprocess
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import rank_device

COLLECTIVE_TIMEOUT_S = 1800.0  # a collective that waits longer fails the run


@dataclass(frozen=True)
class DataMesh:
    rank: int
    world: int
    device: torch.device
    group: object = None  # the process group; None: one process, no collective
    backend: str | None = None


def check_axes(spatial: int = 1, model: int = 1) -> None:
    """The JAX mesh's spatial and model axes are not ported: either above 1
    raises by name."""
    if spatial > 1:
        raise NotImplementedError("spatial sharding (--spatial_shard > 1, the mesh's spatial "
                                  "axis) is not ported: the port's mesh has a data axis only")
    if model > 1:
        raise NotImplementedError("model sharding (--model_shard > 1, the mesh's model axis) "
                                  "is not ported: the port's mesh has a data axis only")


def make_mesh(device=None, spatial: int = 1, model: int = 1, group=None) -> DataMesh:
    """The data axis over ``group`` (default: the initialised default group,
    else no group: world 1).  ``device`` follows ``rank_device``: the
    caller's, else ``cuda:LOCAL_RANK``.  ``spatial`` or ``model`` above 1
    raise (``check_axes``)."""
    check_axes(spatial, model)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    dev = rank_device(device)
    if group is None:
        return DataMesh(0, 1, dev)
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("this process is not a member of the mesh's group")
    return DataMesh(rank, dist.get_world_size(group), dev, group, dist.get_backend(group))


def rank_and_world(mesh: DataMesh | None = None) -> tuple[int, int]:
    """(rank, world) of ``mesh``, else of the active mesh, else of the
    initialised default group, else (0, 1)."""
    from .sharding import active_mesh

    mesh = mesh or active_mesh()
    if mesh is not None:
        return mesh.rank, mesh.world
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_batch(batch: dict, mesh: DataMesh) -> dict:
    """The rank's contiguous rows ``[rank * b, (rank + 1) * b)`` of every
    array (and list) of a global batch, b = rows / world (``batch_sharding``
    of the JAX package: the leading axis over ``data``)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor, list, tuple)):
            n = len(v)
            if n % mesh.world:
                raise ValueError(f"batch key {k!r}: {n} rows do not split over {mesh.world} "
                                 "ranks")
            b = n // mesh.world
            v = v[mesh.rank * b:(mesh.rank + 1) * b]
        out[k] = v
    return out


def _state_tensors(state) -> list:
    """Every tensor of a ``TrainState`` in a fixed order: the model's
    parameters and buffers, the optimizer's moments, the curriculum states
    and the confidence accumulators."""
    tensors = list(state.net.state_dict().values())
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            tensors += [v for _, v in sorted(state.optimizer.state.get(p, {}).items())
                        if isinstance(v, torch.Tensor)]
    for c in state.curriculum:
        tensors += list(c)
    if state.conf_sum is not None:
        tensors += [state.conf_sum, state.conf_cnt]
    return tensors


def replicate_state(state, mesh: DataMesh):
    """Make every rank's ``TrainState`` rank 0's (``replicate_state`` of the
    JAX package): its tensors broadcast in place, one collective a dtype,
    and its host counts (the optimizer's ``count``, ``state.step``).  The
    ranks' layouts are checked first; a mesh without a group leaves the
    state as it is."""
    if mesh.group is None:
        return state
    src = dist.get_global_rank(mesh.group, 0)
    tensors = _state_tensors(state)
    layout = [(tuple(t.shape), str(t.dtype)) for t in tensors]
    counts = [layout, int(getattr(state.optimizer, "count", 0)), int(state.step)]
    # NCCL stages the pickles through the rank's card, gloo through the host
    dist.broadcast_object_list(counts, src=src, group=mesh.group, device=(
        mesh.device if mesh.backend == "nccl" else torch.device("cpu")))
    if counts[0] != layout:
        raise ValueError("replicate_state: this rank's train state differs in layout from "
                         "rank 0's")
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for dtype, group in by_dtype.items():
            wire = torch.uint8 if dtype == torch.bool else dtype
            flat = torch.cat([t.reshape(-1).to(wire) for t in group])
            dist.broadcast(flat, src=src, group=mesh.group)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view(t.shape).to(dtype))
                offset += t.numel()
    if hasattr(state.optimizer, "count"):
        state.optimizer.count = counts[1]
    state.step = counts[2]
    return state


def init_multihost(tcp_port: int | None = None, device=None) -> tuple[int, int]:
    """Initialise the default process group (``init_multihost`` of the JAX
    package; the reference's ``init_dist_slurm`` / ``init_dist_pytorch``,
    common_utils.py:144-186) and return (rank, world):

    * under SLURM (``SLURM_PROCID`` set) with ``tcp_port``: the first host
      of the step's node list (``scontrol show hostname``) at ``tcp_port``,
      rank ``SLURM_PROCID`` of ``SLURM_NTASKS``;
    * otherwise ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
      ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the card).

    The backend is NCCL for CUDA (``device``, default ``cuda``) and gloo for
    the CPU; a collective that waits past ``COLLECTIVE_TIMEOUT_S`` raises.
    A group already initialised is kept."""
    device = torch.device(device or "cuda")
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if env.get("SLURM_PROCID") is not None and tcp_port:
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        node_list = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST", ""))
        addr = subprocess.run(["scontrol", "show", "hostname", node_list], check=True,
                              capture_output=True, text=True).stdout.splitlines()[0].strip()
        init_method = f"tcp://{addr}:{int(tcp_port)}"
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in env]
        if missing:
            raise RuntimeError(f"--multihost needs torchrun's environment ({', '.join(missing)} "
                               "unset) or SLURM with --tcp_port")
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init_method = "env://"
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=init_method,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return rank, world
