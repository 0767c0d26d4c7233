"""BertAdam as a ``torch.optim.Optimizer`` (counterpart of the tree path of
``cmh_tpu/optim/bert_adam.py:120-214``).

- each parameter's gradient is clipped by its own norm before the moments,
  ``coef = min(max_grad_norm / (‖g‖ + 1e-6), 1)`` (not a global clip);
- Adam moments without bias correction;
- weight decay is added to the update of every parameter;
- the learning rate is the group's ``lr`` times ``scheduled_lr_factor`` at
  the step count before this step (warmup_cosine / warmup_constant /
  warmup_linear over ``t_total``; ``t_total = -1`` means factor 1, and
  ``warmup`` passes through raw).

A parameter whose gradient is ``None`` (one no loss term reaches, such as
CLIP's ``logit_scale``) is updated as with a zero gradient, as cmh_tpu's
functional update does for every leaf: its weight decay still applies.
The update runs under ``torch.no_grad()`` with in-place tensor ops on the
parameter's device and never reads a value back to the host.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch


def warmup_cosine(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 0.5 * (1.0 + math.cos(math.pi * x))


def warmup_constant(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else 1.0


def warmup_linear(x: float, warmup: float = 0.002) -> float:
    return x / warmup if x < warmup else max((x - 1.0) / (warmup - 1.0), 0.0)


SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_constant": warmup_constant,
    "warmup_linear": warmup_linear,
}


def scheduled_lr_factor(step: int, t_total: int, schedule: str = "warmup_linear",
                        warmup: float = -1.0) -> float:
    """The multiplicative schedule factor at ``step``."""
    if t_total == -1:
        return 1.0
    return SCHEDULES[schedule](step / t_total, warmup)


class BertAdam(torch.optim.Optimizer):
    def __init__(self, params: Iterable, lr: float, warmup: float = -1.0,
                 t_total: int = -1, schedule: str = "warmup_linear",
                 b1: float = 0.9, b2: float = 0.999, e: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0) -> None:
        if schedule not in SCHEDULES:
            raise ValueError(f"Invalid schedule parameter: {schedule}")
        defaults = dict(lr=lr, warmup=warmup, t_total=t_total, schedule=schedule,
                        b1=b1, b2=b2, e=e, weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm)
        super().__init__(params, defaults)
        self.step_count = 0     # steps taken; the schedule reads it before the step

    def lr_factor(self, group=None) -> float:
        g = group or self.param_groups[0]
        return scheduled_lr_factor(self.step_count, g["t_total"], g["schedule"],
                                   g["warmup"])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2, e = group["b1"], group["b2"], group["e"]
            wd, max_norm = group["weight_decay"], group["max_grad_norm"]
            lr = group["lr"] * self.lr_factor(group)
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if max_norm > 0:
                    norm = torch.linalg.vector_norm(g.float())
                    g = g * torch.clamp(max_norm / (norm + 1e-6), max=1.0)
                state = self.state[p]
                if not state:
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                m, v = state["m"], state["v"]
                m.mul_(b1).add_(g, alpha=1.0 - b1)
                v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = m / (v.sqrt() + e)
                if wd > 0.0:
                    upd.add_(p, alpha=wd)
                p.add_(upd, alpha=-lr)
        self.step_count += 1
        return loss
