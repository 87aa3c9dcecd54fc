"""Training checkpoints in the reference's layout (`gimmvfi_tpu/train/checkpoint.py`).

A checkpoint is one `torch.save` file, `<ckpt_dir>/step_<n>.pt`, holding
`{"step", "state_dict", "optimizer", "scheduler", "state_dict_ema"}`, the
last 3 kept. The model sits under `"state_dict"` in the reference's key
layout, so the port's `load_reference_state_dict` and the JAX package's
`load_torch_state_dict` both read it. Files are read back with
`weights_only=True`. `merge_partial` is the strict=False load of the
stage-1 -> stage-2 transfer (`main.py:106-117`). Under data parallelism
every rank holds the same state: rank 0 writes and the others wait for it
at a barrier; every rank reads.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from ..parallel import dist as dist_ops

_NAME = re.compile(r"step_(\d+)\.pt")


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """The steps of the checkpoints in `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.fullmatch, os.listdir(ckpt_dir)) if m)


def save_checkpoint(ckpt_dir: str, step: int, state, keep: int = 3) -> str:
    """Write `state` (a `TrainState`) as `step_<step>.pt` and keep the last
    `keep` checkpoints; returns the path. Under a process group rank 0
    writes and every rank returns once it has."""
    path = os.path.join(ckpt_dir, f"step_{step}.pt")
    if dist_ops.rank() == 0:
        _write(ckpt_dir, path, step, state, keep)
    dist_ops.barrier()
    return path


def _write(ckpt_dir: str, path: str, step: int, state, keep: int):
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt = {
        "step": int(step),
        "state_dict": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "state_dict_ema": None if state.ema is None
        else {k: v.detach().cpu() for k, v in state.ema.items()},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    for old in checkpoint_steps(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, f"step_{old}.pt"))


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None) -> int:
    """Load the checkpoint of `step` (the latest when None) into `state`:
    the model (strict), the optimizer, the scheduler and the EMA. Sets and
    returns `state.step`."""
    steps = checkpoint_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
    step = steps[-1] if step is None else step
    device = next(state.model.parameters()).device
    ckpt = torch.load(os.path.join(ckpt_dir, f"step_{step}.pt"), map_location=device,
                      weights_only=True)
    state.model.load_state_dict(ckpt["state_dict"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    if state.ema is not None:
        if ckpt["state_dict_ema"] is None:
            raise ValueError(f"checkpoint step_{step}.pt holds no EMA")
        for k, v in ckpt["state_dict_ema"].items():
            state.ema[k].copy_(v)
    state.step = int(ckpt["step"])
    return state.step


@torch.no_grad()
def merge_partial(model: torch.nn.Module, loaded: dict[str, torch.Tensor]) -> list[str]:
    """strict=False load: every key of `loaded` that the model has is
    copied in, the rest of the model is kept; returns the keys copied. A
    key with another shape raises."""
    own = model.state_dict()
    taken = []
    for k, v in loaded.items():
        if k in own:
            if own[k].shape != v.shape:
                raise ValueError(f"{k}: shape {tuple(v.shape)} does not fit {tuple(own[k].shape)}")
            own[k].copy_(v)
            taken.append(k)
    return taken
