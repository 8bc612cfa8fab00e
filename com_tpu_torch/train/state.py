"""Train state (counterpart of ``com_tpu/train/state.py``).

The JAX package's pytree becomes a small mutable holder: the model (its
parameters and batch-norm buffers), the optimizer (its moments), one
curriculum state per head group (``CurriculumState`` for CenterPoint heads,
``AnchorCurriculumState`` for anchor heads with a ``LOSS_CURRICULUM``) and
the per-epoch (num_class, num_groups) confidence accumulators.  Every tensor lives on the model's
device, so a step never syncs with the host; ``step`` is the host-side
count of steps taken.
"""
from __future__ import annotations

import torch

from ..losses.curriculum import CurriculumState
from ..parallel.mesh import replicate_state
from ..parallel.sharding import active_mesh
from ..utils.device import resolve_device


def model_device(net: torch.nn.Module) -> torch.device:
    return next(net.parameters()).device


def check_same_device(net: torch.nn.Module, device=None) -> torch.device:
    """The device an entry point runs on (``resolve_device``), which must
    hold the model; the port never moves a model on its own."""
    def index(d):  # "cuda" means the current card
        if d.index is None and d.type == "cuda":
            return torch.cuda.current_device()
        return d.index or 0

    dev, have = resolve_device(device), model_device(net)
    if have.type != dev.type or index(have) != index(dev):
        raise ValueError(f"the model is on {have}, the entry point was asked for {dev}")
    return have


class TrainState:
    def __init__(self, net, optimizer, curriculum=(), conf_sum=None, conf_cnt=None, step=0):
        self.net, self.optimizer = net, optimizer
        self.curriculum = tuple(curriculum)
        self.conf_sum, self.conf_cnt = conf_sum, conf_cnt
        self.step = step

    @property
    def device(self) -> torch.device:
        return model_device(self.net)

    def reset_epoch_stats(self):
        if self.conf_sum is not None:
            self.conf_sum.zero_()
            self.conf_cnt.zero_()
        return self

    @classmethod
    def create(cls, net, optimizer, num_head_groups: int = 0, conf_shape=None, device=None,
               anchor_num_class: int | None = None):
        """A fresh state over ``net`` on its device; ``device`` follows the
        entry-point rule of ``check_same_device``.  With ``anchor_num_class``
        the curriculum is ``max(num_head_groups, 1)`` (C,) anchor states, as
        ``com_tpu/train/state.py``.  Under an active data mesh every rank's
        state is then rank 0's (``parallel.mesh.replicate_state``)."""
        from ..losses.anchor_losses import AnchorCurriculumState

        dev = check_same_device(net, device)
        conf = [torch.zeros(conf_shape, dtype=torch.float32, device=dev) if conf_shape else None
                for _ in range(2)]
        if anchor_num_class is not None:
            cur = tuple(AnchorCurriculumState.create(anchor_num_class, dev)
                        for _ in range(max(num_head_groups, 1)))
        else:
            cur = tuple(CurriculumState.create(dev) for _ in range(num_head_groups))
        state = cls(net, optimizer, cur, *conf)
        mesh = active_mesh()
        return state if mesh is None else replicate_state(state, mesh)
