"""The ranks' side of ``tests/test_torch_port_two_stage_mesh.py``: functions
that ``com_tpu_torch.parallel.launch.run_ranks`` runs in spawned processes
(spawn imports this module afresh, so it imports torch and the port only,
never JAX).  Each reads the spec the test wrote, runs on the rank's rows
of each global batch in the gloo group, and writes its results to
``{out}/rank{r}_{case}.npz``."""
from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from com_tpu_torch.models.dense_heads.point_head import (point_head_box_loss, point_head_loss,
                                                         point_part_loss)
from com_tpu_torch.models.detectors import build_network
from com_tpu_torch.parallel.mesh import make_mesh, shard_batch
from com_tpu_torch.parallel.sharding import activate, reduce_gradients
from com_tpu_torch.train.optim import build_optimizer
from com_tpu_torch.train.state import TrainState
from com_tpu_torch.train.step import conf_shape_for, curriculum_kwargs, make_train_step
from torch_port_parallel_worker import _numpy, _save


def run_case(case, mesh=None):
    """On ``case``'s batch (the rank's rows under ``mesh``): ``loss_fn`` with
    the case's RoI uniforms (the rank's rows) and backward, the gradients
    reduced over the ranks; then from the same start the whole
    ``train_step`` with its own seeded generators (RoI sampling and
    dropout); the loss, terms, gradients and batch statistics of each."""
    cfg, meta = case["cfg"], case["meta"]
    names = list(cfg.CLASS_NAMES)
    batch, u = case["batch"], torch.from_numpy(case["u"])
    if mesh is not None:
        batch = shard_batch(batch, mesh)
        u = shard_batch({"u": u}, mesh)["u"]
    net = build_network(cfg.MODEL, meta, device="cpu")
    net.load_state_dict(case["start"])
    start = copy.deepcopy(net.state_dict())
    opt, _ = build_optimizer(net, cfg.OPTIMIZATION, 100, 10)
    state = TrainState.create(net, opt, conf_shape=conf_shape_for(cfg.MODEL, names),
                              device="cpu", **curriculum_kwargs(cfg.MODEL, names))
    step = make_train_step(net, cfg.MODEL, names, meta, opt, None, device="cpu", seed=5)
    loss, _, _, tb = step.loss_fn(state, batch, 0, rngs={"roi_sampling": u})
    loss.backward()
    reduce_gradients(net.parameters())
    out = dict(loss=_numpy(loss), tb={k: _numpy(v) for k, v in tb.items()},
               grads={k: _numpy(p.grad) for k, p in net.named_parameters()},
               stats={k: _numpy(v) for k, v in net.state_dict().items() if "running" in k})
    net.load_state_dict(start)
    net.zero_grad(set_to_none=True)
    _, metrics = step(state, batch, 0)
    out.update(step_loss=_numpy(metrics["loss"]),
               step_tb={k: _numpy(v) for k, v in metrics.items()
                        if k not in ("loss", "confidence_sum", "confidence_cnt")},
               step_grads={k: _numpy(p.grad) for k, p in net.named_parameters()})
    return out


def point_losses(batch):
    """The three point-head losses of ``batch`` (tensors)."""
    box, _ = point_head_box_loss(batch, {"TARGET_CONFIG": {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2]}})
    part, _ = point_part_loss(batch)
    return dict(box=_numpy(box), part=_numpy(part), simple=_numpy(point_head_loss(batch)))


def mesh_worker(mesh, spec_path, out):
    """Every case on this rank's rows over the 2-rank mesh, and the point-
    head losses of the rank's rows; then rank 0 runs the first case's
    whole batch without a mesh and over a one-rank group (bitwise the
    same)."""
    spec = torch.load(spec_path, weights_only=False)
    for name, case in spec["cases"].items():
        _save(Path(out) / f"rank{mesh.rank}_{name}.npz", **run_case(case, mesh))
    pts = shard_batch({k: torch.from_numpy(v) for k, v in spec["points"].items()}, mesh)
    _save(Path(out) / f"rank{mesh.rank}_points.npz", **point_losses(pts))
    solo = [dist.new_group([r]) for r in range(mesh.world)]  # every rank makes every group
    if mesh.rank == 0:
        case = next(iter(spec["cases"].values()))
        activate(None)
        plain = run_case(case)
        activate(make_mesh("cpu", group=solo[0]))
        grouped = run_case(case, None)
        activate(mesh)
        same = {}
        for key, want in plain.items():
            pairs = want.items() if isinstance(want, dict) else [("", want)]
            for k, v in pairs:
                g = grouped[key][k] if isinstance(want, dict) else grouped[key]
                same[f"{key}/{k}"] = np.array_equal(g, v)
        _save(Path(out) / "world1.npz", same=same)
