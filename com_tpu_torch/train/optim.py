"""Optimizer and learning-rate schedule (counterpart of
``com_tpu/train/optim.py``).

``adam_onecycle`` is the JAX package's optax chain (``optim.py:97-121``)
written over tensors, one step at a time:

1. ``clip_by_global_norm(GRAD_NORM_CLIP)`` with optax's formula: the
   gradients are scaled by max_norm / norm when norm >= max_norm;
2. ``scale_by_adam`` with b1 = mom_fn(count), bias correction 1 - b1^t at
   that b1, b2 = 0.999 and eps = 1e-8 outside the square root;
3. ``+ WEIGHT_DECAY * p`` on every parameter (``BN_WD`` defaults to True,
   so the bias/norm mask is off unless it is False);
4. ``* -lr_fn(count)``, count starting at 0.

The schedules are evaluated on the host from the step count, so a step
never waits for the device.  The ``adam`` and ``sgd`` branches are not
ported yet.
"""
from __future__ import annotations

import math

import torch


def one_cycle_schedule(lr_max: float, total_steps: int, moms=(0.95, 0.85),
                       div_factor: float = 10.0, pct_start: float = 0.4):
    """(lr_fn, mom_fn) of the step: two cosine phases, lr/div -> lr over
    pct_start of the steps, then lr -> lr/div/1e4; momentum the other way."""
    up = max(int(total_steps * pct_start), 1)
    down = max(total_steps - up, 1)
    lr_low = lr_max / div_factor
    lr_end = lr_low / 1e4

    def cos_anneal(start, end, pct):
        return end + (start - end) / 2 * (math.cos(math.pi * pct) + 1)

    def phase(step, first, second):
        step = min(step, total_steps)
        if step <= up:
            return cos_anneal(*first, min(max(step / up, 0.0), 1.0))
        return cos_anneal(*second, min(max((step - up) / down, 0.0), 1.0))

    def lr_fn(step):
        return phase(step, (lr_low, lr_max), (lr_max, lr_end))

    def mom_fn(step):
        return phase(step, (moms[0], moms[1]), (moms[1], moms[0]))

    return lr_fn, mom_fn


class AdamOneCycle(torch.optim.Optimizer):
    """The ``adam_onecycle`` chain over a module's parameters.  Moments are
    f32 tensors beside each parameter; ``count`` (the number of updates
    taken) drives the schedules and goes with them into ``state_dict``."""

    def __init__(self, params, lr_fn, mom_fn, b2=0.999, eps=1e-8, weight_decay=0.0,
                 max_grad_norm=0.0, decay_mask=None):
        params = list(params)
        decay = [True] * len(params) if decay_mask is None else list(decay_mask)
        groups = [{"params": [p for p, d in zip(params, decay) if d], "decay": True},
                  {"params": [p for p, d in zip(params, decay) if not d], "decay": False}]
        super().__init__([g for g in groups if g["params"]], {})
        self.lr_fn, self.mom_fn = lr_fn, mom_fn
        self.b2, self.eps, self.wd, self.max_grad_norm = b2, eps, weight_decay, max_grad_norm
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        params, decay = [], []
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    params.append(p)
                    decay.append(group["decay"])
        grads = [p.grad for p in params]
        if not params:
            self.count += 1
            return None
        if self.max_grad_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            factor = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                 self.max_grad_norm / norm)
            grads = torch._foreach_mul(grads, factor)
        b1, b2 = self.mom_fn(self.count), self.b2
        t = self.count + 1
        mus, nus = [], []
        for p in params:
            st = self.state[p]
            if not st:
                st["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            mus.append(st["mu"])
            nus.append(st["nu"])
        torch._foreach_mul_(mus, b1)
        torch._foreach_add_(mus, grads, alpha=1 - b1)       # mu = b1 mu + (1 - b1) g
        torch._foreach_mul_(nus, b2)
        torch._foreach_addcmul_(nus, grads, grads, 1 - b2)  # nu = b2 nu + (1 - b2) g^2
        mu_hat = torch._foreach_div(mus, 1 - b1 ** t)
        nu_hat = torch._foreach_div(nus, 1 - b2 ** t)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        if self.wd > 0:
            for u, p, d in zip(upd, params, decay):
                if d:
                    u.add_(p, alpha=self.wd)
        torch._foreach_add_(params, upd, alpha=-self.lr_fn(self.count))
        self.count += 1
        return None

    def state_dict(self):
        """``torch.optim.Optimizer.state_dict`` and ``count``: without it a
        resumed run would restart the schedules and the bias correction."""
        sd = super().state_dict()
        sd["count"] = self.count
        return sd

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        if "count" not in state_dict:
            raise KeyError("AdamOneCycle.load_state_dict: the state has no 'count'")
        count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
        self.count = count


def build_optimizer(net: torch.nn.Module, optim_cfg, total_steps: int, steps_per_epoch: int):
    """(optimizer, lr_fn) for ``OPTIMIZATION.OPTIMIZER``; only
    ``adam_onecycle`` is ported."""
    name = optim_cfg.get("OPTIMIZER", "adam_onecycle")
    if name != "adam_onecycle":
        raise NotImplementedError(f"optimizer {name!r} is not ported yet (adam_onecycle is)")
    lr_fn, mom_fn = one_cycle_schedule(
        float(optim_cfg["LR"]), total_steps, moms=tuple(optim_cfg.get("MOMS", [0.95, 0.85])),
        div_factor=float(optim_cfg.get("DIV_FACTOR", 10.0)),
        pct_start=float(optim_cfg.get("PCT_START", 0.4)))
    params = list(net.parameters())
    # BN_WD=False opts into fastai's split: no decay on biases and norm scales
    mask = None if optim_cfg.get("BN_WD", True) else [p.dim() > 1 for p in params]
    opt = AdamOneCycle(params, lr_fn, mom_fn, weight_decay=float(optim_cfg.get("WEIGHT_DECAY", 0.0)),
                       max_grad_norm=float(optim_cfg.get("GRAD_NORM_CLIP", 0.0)), decay_mask=mask)
    return opt, lr_fn
