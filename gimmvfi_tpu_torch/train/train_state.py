"""Training state and the stage-1 GIMM steps (`gimmvfi_tpu/train/train_state.py`).

The JAX package's steps are pure functions over a state pytree; here the
state holds the model, its optimizer, the `StepSchedule` and the EMA, and a
step updates them in place. The stage-1 step (`trainer_gimm.py:103-161`) is
MSE on the normalized flow at t = t_id / 2 against `xs[:, t_id]`; its
validation is the same at t = 0.5 against `xs[:, 1]`. Stage 2's steps are
later work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from .ema import ema_init, ema_update
from .optim import StepSchedule


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: StepSchedule
    ema: Optional[dict[str, torch.Tensor]] = None  # state-dict EMA, or None


def create_train_state(model, optimizer, scheduler, use_ema: bool = True) -> TrainState:
    return TrainState(0, model, optimizer, scheduler, ema_init(model) if use_ema else None)


def _device_batch(batch: Mapping[str, np.ndarray], device: torch.device):
    xs = torch.as_tensor(batch["xs"], dtype=torch.float32).to(device)
    ori = torch.as_tensor(batch["ori_flows"], dtype=torch.float32).to(device)
    return xs, ori


def _flow_metrics(pred: torch.Tensor, target: torch.Tensor) -> tuple[torch.Tensor, dict]:
    n = pred.shape[0]
    mse = ((pred - target) ** 2).reshape(n, -1).mean(dim=-1)
    loss = mse.mean()
    return loss, {"loss_total": loss.detach(), "mse": loss.detach(),
                  "psnr": (-10.0 * torch.log10(mse.detach())).mean()}


def make_gimm_train_step(use_ema: bool = False):
    """Stage-1 step. batch: xs (N, 3, H, W, 2) [f0, f_mid, f1] normalized,
    ori_flows (N, 2, H, W, 2), t_id (N,) in {0, 1, 2}; numpy or tensors.

    `train_step(state, batch)` updates the state in place and returns the
    metrics as 0-d tensors on the model's device (`loss_total`, `mse`,
    `psnr`). The parameters' `.grad` hold this step's gradient afterwards
    (clipped where the schedule clips)."""

    def train_step(state: TrainState, batch) -> dict[str, torch.Tensor]:
        model = state.model
        device = next(model.parameters()).device
        xs, ori = _device_batch(batch, device)
        t_id = torch.as_tensor(batch["t_id"]).to(device=device, dtype=torch.long)
        n = xs.shape[0]
        pred = model(xs[:, [0, 2]], ori, t_id.float() / 2.0)  # (N, 1, H, W, 2)
        target = xs[torch.arange(n, device=device), t_id][:, None]
        loss, metrics = _flow_metrics(pred, target)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        if use_ema and state.ema is not None:
            ema_update(state.ema, model, state.step)
        state.step += 1
        return metrics

    return train_step


def make_gimm_eval_step():
    """Stage-1 validation at t = 0.5 against `xs[:, 1]`
    (`trainer_gimm.py` eval path). `eval_step(model, batch)` returns the
    metrics as 0-d tensors; the caller picks the model (or an EMA copy)."""

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, batch) -> dict[str, torch.Tensor]:
        device = next(model.parameters()).device
        xs, ori = _device_batch(batch, device)
        t = torch.full((xs.shape[0],), 0.5, dtype=torch.float32, device=device)
        pred = model(xs[:, [0, 2]], ori, t)
        return _flow_metrics(pred, xs[:, 1:2])[1]

    return eval_step
