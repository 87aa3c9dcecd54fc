"""Optimizers and the learning-rate schedule (`gimmvfi_tpu/train/optim.py`).

  * `warmup_cosine_schedule`: linear warmup (world-size-scaled multiplier)
    into a cosine decay to `min_lr`, a plain function of the update count.
  * `create_optimizer`: a `torch.optim` optimizer (adam with the weight
    decay as L2 into the gradient, adamw decoupled, sgd with momentum 0.9)
    and a `StepSchedule` that, before each update, sets every group's lr to
    `schedule(count)` times the group's scale and clips the gradients to
    `max_grad_norm` by their global norm. With `ft`, parameters whose name
    enters an `amt_*` module train at the full lr and weight decay, the rest
    at 0.01x.

As in optax, the schedule is read at the count of updates made before this
one: the first update uses `schedule(0)`.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def warmup_cosine_schedule(
    init_lr: float,
    min_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    buffer_steps: int = 0,
    multiplier: float = 1.0,
    mode: str = "fix",
    world_size: int = 1,
    start_from_zero: bool = True,
) -> Callable[[int], float]:
    """The reference's warmup -> cosine composition as a function of the step."""
    if mode == "linear":
        multiplier = max(1.0, multiplier * world_size)
    elif mode == "sqrt":
        multiplier = max(1.0, multiplier * math.sqrt(world_size))
    elif mode == "fix":
        multiplier = max(1.0, multiplier)

    cosine_steps = max(1, total_steps - warmup_steps - buffer_steps)

    def schedule(step: int) -> float:
        step = float(step)
        if warmup_steps and step <= warmup_steps:
            frac = min(1.0, step / max(1, warmup_steps))
            if start_from_zero:
                return init_lr * multiplier * frac
            return init_lr * (1.0 + (multiplier - 1.0) * frac)
        t = min(max(step - warmup_steps - buffer_steps, 0.0), cosine_steps)
        return min_lr + 0.5 * (init_lr - min_lr) * (1.0 + math.cos(math.pi * t / cosine_steps))

    return schedule


def clip_by_global_norm_(params, max_norm: float):
    """Scale the gradients by max_norm / norm where their global norm is at
    least `max_norm` (optax's `clip_by_global_norm`, no epsilon)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale)


class StepSchedule:
    """Runs before each `optimizer.step()` (a step pre-hook): sets each
    group's lr to `schedule(count) * lr_scale`, clips the gradients when
    `max_grad_norm` is set, and counts the update. `state_dict` holds the
    count, so a restored run resumes the schedule."""

    def __init__(self, optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                 max_grad_norm: Optional[float] = None):
        self.optimizer = optimizer
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self._set_lr()
        optimizer.register_step_pre_hook(self._before_update)

    def _set_lr(self):
        lr = float(self.schedule(self.count))
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group["lr_scale"]

    def _before_update(self, optimizer, args, kwargs):
        self._set_lr()
        if self.max_grad_norm is not None:
            clip_by_global_norm_([p for g in optimizer.param_groups for p in g["params"]],
                                 self.max_grad_norm)
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self._set_lr()


def _is_amt(name: str) -> bool:
    return any(part.startswith("amt_") for part in name.split("."))


def create_optimizer(
    model: torch.nn.Module,
    opt_type: str = "adamw",
    init_lr: float = 8e-5,
    weight_decay: float = 4e-5,
    betas: tuple[float, float] = (0.9, 0.999),
    ft: bool = True,
    lr_schedule: Optional[Callable[[int], float]] = None,
    max_grad_norm: Optional[float] = None,
) -> tuple[torch.optim.Optimizer, StepSchedule]:
    """The (optionally two-group) optimizer and its `StepSchedule`.

    `lr_schedule` maps the update count to the lr (constant `init_lr` when
    None); with `ft`, parameters outside the `amt_*` modules get 0.01x the
    lr and the weight decay."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if ft:
        groups = [
            {"params": [p for n, p in named if _is_amt(n)], "lr_scale": 1.0},
            {"params": [p for n, p in named if not _is_amt(n)], "lr_scale": 0.01},
        ]
        groups = [g for g in groups if g["params"]]
    else:
        groups = [{"params": [p for _, p in named], "lr_scale": 1.0}]
    for g in groups:
        g["weight_decay"] = weight_decay * g["lr_scale"]
        g["lr"] = init_lr * g["lr_scale"]

    if opt_type == "adamw":
        opt = torch.optim.AdamW(groups, lr=init_lr, betas=tuple(betas), eps=1e-8)
    elif opt_type == "adam":
        opt = torch.optim.Adam(groups, lr=init_lr, betas=tuple(betas), eps=1e-8)
    elif opt_type == "sgd":
        opt = torch.optim.SGD(groups, lr=init_lr, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer type: {opt_type}")
    schedule = lr_schedule if lr_schedule is not None else (lambda step: init_lr)
    return opt, StepSchedule(opt, schedule, max_grad_norm)
