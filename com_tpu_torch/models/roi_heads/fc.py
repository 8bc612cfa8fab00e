"""The RoI heads' fully connected stacks in pcdet's layout: Sequentials of
[linear, ``BatchNorm1d``, ReLU] blocks with a slot after some blocks where
pcdet has its ``nn.Dropout``, so that ``state_dict()`` keys read as pcdet's
(``roi_head.shared_fc_layer.4.weight``...).  A slot is a ``Dropout`` drawn
from an explicit generator where the JAX package drops units, else an
``nn.Identity`` that only keeps the numbering."""
from __future__ import annotations

import torch
from torch import nn

from ...parallel.sharding import rank_rand
from ..layers import BatchNorm1d


class Dropout(nn.Module):
    """flax's ``nn.Dropout`` in training (units kept with probability 1 - p,
    scaled by 1 / (1 - p)), the identity in eval; the draw comes from the
    generator passed to ``forward`` (torch's default one when None), under
    a data mesh the rank's rows of the global batch's draw
    (``parallel.sharding.rank_rand``)."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)

    def forward(self, x, generator: torch.Generator | None = None):
        if not self.training or self.p <= 0:
            return x
        u = rank_rand(x.shape, generator, x.device)
        return torch.where(u < 1.0 - self.p, x / (1.0 - self.p), torch.zeros_like(x))


def fc_stack(cin: int, fcs, linear, slot_after, drop: float | None = None,
             out: int | None = None) -> nn.Sequential:
    """[linear(cin, ch), BatchNorm1d, ReLU] for each ``ch`` of ``fcs``, a slot
    after block ``i`` where ``slot_after(i)`` (a ``Dropout(drop)`` when
    ``drop`` is given, else an Identity), then, with ``out``, the biased
    output layer."""
    layers = []
    for i, ch in enumerate(fcs):
        layers += [linear(cin, ch, bias=False), BatchNorm1d(ch), nn.ReLU()]
        if slot_after(i):
            layers.append(Dropout(drop) if drop is not None else nn.Identity())
        cin = ch
    if out is not None:
        layers.append(linear(cin, out, bias=True))
    return nn.Sequential(*layers)


def run_stack(stack: nn.Sequential, x, generator: torch.Generator | None = None):
    for layer in stack:
        x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
    return x
