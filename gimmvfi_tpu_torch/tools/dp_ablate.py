"""The stage-2 recipe step with and without the data-parallel step's parts,
in turns, on one card.

    python -m gimmvfi_tpu_torch.tools.dp_ablate [--steps 6] [--warmup 2]

Card only: without CUDA `main` raises. The R recipe's step
(`configs/gimmvfi/gimmvfi_r_arb.yaml`: GIMMVFI_R(raft_iters=20), remat on
as the train CLI builds it, from seed 0, AdamW with the ft groups, EMA, the perceptual loss of a seeded LPIPS,
batch 4 at 224x224, float32, TF32 off) on a seeded random batch, in the
turns: `plain` (no process group), `group` (a process group of one NCCL
rank: the gradients' flat all-reduce and the metrics' mean run),
`group_no_average` and `group_no_mean` (the group with one of the two
replaced by the identity), `plain` again. Each turn starts from a fresh
state after `gc.collect()`, so no earlier turn's state counts in its peak;
it prints the median, min and max ms a step by CUDA events after the
warm-ups, and the peak allocated.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..models.gimmvfi_r import GIMMVFI_R
from ..parallel import dist as dist_ops
from ..train.lpips import LPIPS
from ..train.optim import create_optimizer
from ..train.train_state import create_train_state, make_gimmvfi_train_step
from ..utils.config import load_config
from ..utils.timing import device_ms

RECIPE = "configs/gimmvfi/gimmvfi_r_arb.yaml"
CROP = 224
TURNS = ("plain", "group", "group_no_average", "group_no_mean", "plain")


def recipe_batch(n: int, seed: int = 0, device="cuda") -> dict:
    """A seeded stage-2 batch at the recipe's crop: random frames, t = k/6
    for sample k (1..5, then again), the loss's subsample of 10% of the
    pixels."""
    rng = np.random.default_rng(seed)
    k = int(CROP * CROP * 0.1)
    out = {key: torch.from_numpy(rng.random((n, CROP, CROP, 3), dtype=np.float32))
           for key in ("img0", "img1", "gt")}
    out["t"] = (torch.arange(n) % 5 + 1).float() / 6.0
    for key in ("sub_idx0", "sub_idx1"):
        out[key] = torch.from_numpy(np.stack([rng.permutation(CROP * CROP)[:k] for _ in range(n)]))
    return {key: v.to(device) for key, v in out.items()}


def time_turn(cfg, batch, steps: int, warmup: int, trace: bool = False) -> dict:
    """A fresh recipe state from seed 0 on the current card; `warmup`
    steps, then `steps` timed; with `trace`, one step more in a
    `torch.profiler` trace: its device time and its NCCL rows."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.manual_seed(0)
    model = GIMMVFI_R(raft_iters=cfg.arch.raft_iter, device="cuda")
    o = cfg.optimizer
    opt, sched = create_optimizer(model, o.type, init_lr=o.init_lr, weight_decay=o.weight_decay,
                                  betas=tuple(o.betas), ft=o.ft, max_grad_norm=o.max_gn)
    state = create_train_state(model, opt, sched, use_ema=bool(cfg.arch.ema))
    torch.manual_seed(0)
    lpips = LPIPS(device="cuda").requires_grad_(False)
    step = make_gimmvfi_train_step(
        cfg.arch.rec_weight, lambda p, g: lpips(p.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2),
                                                normalize=True), use_ema=bool(cfg.arch.ema))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(warmup):
        step(state, batch)
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out = {"median_ms": statistics.median(times), "min_ms": min(times), "max_ms": max(times),
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    if trace:
        out["device_ms"], rows = device_ms(lambda: step(state, batch), iters=1, warmup=0)
        out["nccl_device_ms"] = {k: v for k, v in rows.items() if "nccl" in k.lower()}
    return out


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(prog="python -m gimmvfi_tpu_torch.tools.dp_ablate",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--warmup", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("dp_ablate times the step on a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = load_config(RECIPE)
    batch = recipe_batch(cfg.experiment.batch_size)
    average, mean = dist_ops.average_gradients_, dist_ops.global_mean
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, turn in enumerate(TURNS):
            dist_ops.average_gradients_ = ((lambda params: None) if turn == "group_no_average"
                                           else average)
            dist_ops.global_mean = (lambda metrics: metrics) if turn == "group_no_mean" else mean
            if turn != "plain":
                dist_ops.init(torch.device("cuda", 0), "nccl", rank=0, world=1, local_rank=0,
                              local_world=1, init_method=f"file://{Path(tmp) / f'rendezvous_{i}'}")
            try:
                res = {"turn": turn, **time_turn(cfg, batch, args.steps, args.warmup)}
            finally:
                dist_ops.shutdown()
                dist_ops.average_gradients_, dist_ops.global_mean = average, mean
            print(f"{turn}: {res['median_ms']:.2f} ms a step (median of {args.steps}; "
                  f"{res['min_ms']:.2f}-{res['max_ms']:.2f}), peak {res['peak_mib']:.1f} MiB",
                  flush=True)
            out.append(res)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi or torch.cuda.get_device_name(0), "turns": out}))
    return out


if __name__ == "__main__":
    main()
