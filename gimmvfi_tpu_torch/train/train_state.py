"""Training state and the train and validation steps of both stages
(`gimmvfi_tpu/train/train_state.py`).

The JAX package's steps are pure functions over a state pytree; here the
state holds the model, its optimizer, the `StepSchedule` and the EMA, and a
step updates them in place. The EMA covers the state dict, so stage 2's
BatchNorm running statistics too, as JAX's `{"params", "batch_stats"}`.

  * Stage 1 (`trainer_gimm.py:103-161`): MSE on the normalized flow at
    t = t_id / 2 against `xs[:, t_id]`; its validation is the same at
    t = 0.5 against `xs[:, 1]`.
  * Stage 2 (`trainer_gimmvfi.py:259-327`): Laplacian, census and
    Charbonnier losses (and LPIPS when given) on the frame at t, half of
    them on the 1/4-scale warp, and `rec_weight` x the MSE of the t = 0 /
    t = 1 flow decodes against the detached normalized RAFT flows at the
    subsampled points; its validation takes the running statistics.

Under a process group (`parallel/dist.py`) every step is a data-parallel
step over the global batch, each rank holding its rows: BatchNorm takes
the global batch's statistics, the gradients are averaged over the ranks
by hand (`average_gradients_`, one flat all-reduce) after `backward` and
before the clip and the update, and the train and validation steps return
the global means of their metrics. Every rank then holds the same
parameters, buffers, optimizer state and EMA after each step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from ..parallel import dist as dist_ops
from . import losses
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
        dist_ops.average_gradients_(model.parameters())
        state.optimizer.step()
        if use_ema and state.ema is not None:
            ema_update(state.ema, model, state.step)
        state.step += 1
        return dist_ops.global_mean(metrics)

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
        return dist_ops.global_mean(_flow_metrics(pred, xs[:, 1:2])[1])

    return eval_step


def _vfi_batch(batch: Mapping, device: torch.device) -> dict[str, torch.Tensor]:
    out = {k: torch.as_tensor(batch[k]).to(device=device, dtype=torch.float32)
           for k in ("img0", "img1", "gt", "t")}
    for k in ("sub_idx0", "sub_idx1"):
        out[k] = torch.as_tensor(batch[k]).to(device=device, dtype=torch.long)
    return out


def _flow_rec_loss(out: dict, sub_idx0: torch.Tensor, sub_idx1: torch.Tensor) -> torch.Tensor:
    """The MSE of the t = 0 / t = 1 decodes against the detached normalized
    RAFT flows (0 -> 1 and the negated 1 -> 0) at the subsampled points."""
    nflow = out["nflow"].detach()  # (N, 2, H, W, 2)
    n = nflow.shape[0]

    def target(time_idx, sub_idx):
        flat = nflow[:, time_idx].reshape(n, -1, 2)
        return torch.gather(flat, 1, sub_idx[..., None].expand(*sub_idx.shape, 2))

    inr0, inr1 = out["ninrflow"]
    return (0.5 * ((inr0 - target(0, sub_idx0)) ** 2).mean()
            + 0.5 * ((inr1 - target(1, sub_idx1)) ** 2).mean())


def make_gimmvfi_train_step(rec_weight: float = 0.1, lpips_fn=None, use_ema: bool = True):
    """Stage-2 step. batch: img0/img1/gt (N, H, W, 3) in [0, 1], t (N,),
    sub_idx0/sub_idx1 (N, K) indices into the H*W pixels; numpy or tensors.
    `lpips_fn(pred, gt)`, channels-last images in [0, 1], returns per-sample
    distances; None leaves the perceptual loss out.

    `train_step(state, batch)` runs `train_forward` with batch statistics
    (moving the BatchNorm running statistics), updates the state in place
    and returns the metrics as 0-d tensors (`loss_total`, `lap`, `census`,
    `l1`, `rec`, `lpips`, `psnr`). The parameters' `.grad` hold this
    step's gradient afterwards."""

    def train_step(state: TrainState, batch) -> dict[str, torch.Tensor]:
        model = state.model
        b = _vfi_batch(batch, next(model.parameters()).device)
        out = model.train_forward(torch.stack([b["img0"], b["img1"]], dim=1), b["t"],
                                  b["sub_idx0"], b["sub_idx1"], train=True)
        gt, pred, aux = b["gt"], out["imgt_pred"], out["img_warp_4"]
        loss_lap = losses.lap_loss(pred, gt) + 0.5 * losses.lap_loss(aux, gt)
        loss_census = losses.census_loss(pred, gt) + 0.5 * losses.census_loss(aux, gt)
        loss_l1 = losses.charbonnier_l1(pred, gt) + 0.5 * losses.charbonnier_l1(aux, gt)
        loss_lpips = torch.zeros((), device=gt.device)
        if lpips_fn is not None:
            loss_lpips = lpips_fn(pred, gt).mean() + 0.5 * lpips_fn(aux, gt).mean()
        loss_rec = _flow_rec_loss(out, b["sub_idx0"], b["sub_idx1"])
        total = loss_census + loss_l1 + rec_weight * loss_rec + loss_lap + loss_lpips
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        dist_ops.average_gradients_(model.parameters())
        state.optimizer.step()
        if use_ema and state.ema is not None:
            ema_update(state.ema, model, state.step)
        state.step += 1
        metrics = {"loss_total": total, "lap": loss_lap, "census": loss_census, "l1": loss_l1,
                   "rec": loss_rec, "lpips": loss_lpips, "psnr": losses.psnr(pred, gt)}
        return dist_ops.global_mean({k: v.detach() for k, v in metrics.items()})

    return train_step


def make_gimmvfi_eval_step(rec_weight: float = 0.1):
    """Stage-2 validation: the losses without LPIPS or the aux warp, on the
    running statistics and the batched inference flow. `eval_step(model,
    batch)` returns `loss_total`, `rec` and `psnr` as 0-d tensors; the
    caller picks the model (or an EMA copy)."""

    @torch.no_grad()
    def eval_step(model: torch.nn.Module, batch) -> dict[str, torch.Tensor]:
        b = _vfi_batch(batch, next(model.parameters()).device)
        out = model.train_forward(torch.stack([b["img0"], b["img1"]], dim=1), b["t"],
                                  b["sub_idx0"], b["sub_idx1"], train=False)
        gt, pred = b["gt"], out["imgt_pred"]
        loss_rec = _flow_rec_loss(out, b["sub_idx0"], b["sub_idx1"])
        total = (losses.charbonnier_l1(pred, gt) + losses.census_loss(pred, gt)
                 + losses.lap_loss(pred, gt) + rec_weight * loss_rec)
        return dist_ops.global_mean({"loss_total": total, "rec": loss_rec,
                                     "psnr": losses.psnr(pred, gt)})

    return eval_step
