"""Exponential moving average of a model's state dict (`gimmvfi_tpu/train/ema.py`).

As the reference does, the EMA covers the full state dict (parameters and
buffers) with mu = min(mu_cap, (1 + step) / (10 + step)) when scheduled, or
a fixed mu_cap otherwise; the initial EMA is a copy of the model.
"""

from __future__ import annotations

import torch


@torch.no_grad()
def ema_init(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """A copy of the model's state dict, detached."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: torch.nn.Module, step: int,
               mu_cap: float = 1.0, scheduled: bool = True) -> dict[str, torch.Tensor]:
    """One EMA step in place: ema = mu * ema + (1 - mu) * model, float32 mu;
    entries that are not floating point are copied. Returns `ema`."""
    mu = torch.tensor(min(mu_cap, (1.0 + step) / (10.0 + step)) if scheduled else mu_cap,
                      dtype=torch.float32)
    mu, one_minus = float(mu), float(1.0 - mu)
    for k, v in model.state_dict().items():
        e = ema[k]
        if e.is_floating_point():
            e.mul_(mu).add_(v.detach(), alpha=one_minus)
        else:
            e.copy_(v)
    return ema
