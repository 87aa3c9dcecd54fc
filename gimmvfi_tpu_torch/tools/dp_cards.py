"""Data-parallel training across the cards of one node: NCCL ranks against
one process, and the recipe step's time with and without the group.

    torchrun --standalone --nproc_per_node N -m gimmvfi_tpu_torch.tools.dp_cards [--steps 6]

One rank a card (`--device cpu`: gloo ranks on the CPU, for a rehearsal).
Every model is built as the train CLI builds it, remat on (GIMMVFI_R's
default): under the group each rank's backward recomputes its remat units,
BatchNorm's sums all-reduced again. Every rank, first without a process
group:
  1. the check's reference: one stage-2 step (`configs/gimmvfi/
     gimmvfi_r_arb.yaml`'s AdamW with the ft groups and EMA, no perceptual
     loss) of GIMMVFI_R(raft_iters=2) from seed 0 on a seeded batch of N at
     128x128, in one process on its own card;
  2. the R recipe step (`tools/dp_ablate.py: time_turn`: raft_iters 20,
     batch 4 at 224x224, the perceptual loss of a seeded LPIPS) timed by
     CUDA events, the median of `--steps` after `--warmup`;
then the group starts (`parallel/dist.py: init`) and every rank runs
  3. the check's step on its row of the batch: the loss to 1e-5 relative,
     the BatchNorm running statistics to 1e-5 x max(1, max|ref|), each
     gradient within 1e-2 relative L2 of the one-process step's but the
     biases of the convs that feed a normalization, zero in exact
     arithmetic (within 1e-2 x max|g| of their weights) and the alphas
     (within 1e-2 x |g| + 1e-6; ROADMAP C3 holds them by S); every rank's
     parameters, buffers and EMA bitwise equal to rank 0's;
  4. the recipe step again, each rank on its own rows of a global batch
     of 4 N (the data-parallel step: BatchNorm's statistics across the
     ranks, the gradients' flat all-reduce), timed as in 2, then one step
     more in a trace; rank 0 reports its device time and NCCL rows.
Rank 0 prints each reading and one JSON line last; a failed check raises
on the rank that sees it, which fails the run.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

import numpy as np
import torch
import torch.distributed as dist

from ..models.gimmvfi_r import GIMMVFI_R
from ..parallel import dist as dist_ops
from ..train.optim import create_optimizer
from ..train.train_state import create_train_state, make_gimmvfi_train_step
from ..utils.config import load_config
from .dp_ablate import RECIPE, recipe_batch, time_turn

CHECK_HW = 128
# the biases of the convs that feed a normalization (ROADMAP C3)
PRE_NORM_BIAS = re.compile(r"flow_estimator\.(fnet|cnet)\.(conv1|layer\d\.\d\.(conv1|conv2|downsample\.0))"
                           r"\.bias|amt_init_decoder\.upsample\.6\.bias|amt_final_decoder\.upsample\.7\.bias")
ALPHAS = ("alpha_v", "alpha_fe")


def check_batch(n: int) -> dict:
    """A seeded stage-2 batch of `n` at 128x128 on the CPU."""
    rng = np.random.default_rng(1)
    k = int(CHECK_HW * CHECK_HW * 0.1)
    out = {key: torch.from_numpy(rng.random((n, CHECK_HW, CHECK_HW, 3), dtype=np.float32))
           for key in ("img0", "img1", "gt")}
    out["t"] = torch.arange(1, n + 1, dtype=torch.float32) / (n + 1)
    for key in ("sub_idx0", "sub_idx1"):
        out[key] = torch.from_numpy(np.stack([rng.permutation(CHECK_HW ** 2)[:k] for _ in range(n)]))
    return out


def check_step(cfg, device: torch.device, batch: dict) -> dict:
    """One stage-2 step of GIMMVFI_R(raft_iters=2) from seed 0 on `batch`:
    the loss, the gradients and the state dict and EMA after it (CPU)."""
    torch.manual_seed(0)
    model = GIMMVFI_R(raft_iters=2, device=device)
    o = cfg.optimizer
    opt, sched = create_optimizer(model, o.type, init_lr=o.init_lr, weight_decay=o.weight_decay,
                                  betas=tuple(o.betas), ft=o.ft, max_grad_norm=o.max_gn)
    state = create_train_state(model, opt, sched, use_ema=True)
    step = make_gimmvfi_train_step(cfg.arch.rec_weight, None, use_ema=True)
    loss = float(step(state, {k: v.to(device) for k, v in batch.items()})["loss_total"])
    return {"loss": loss, "grads": {k: p.grad.detach().cpu() for k, p in model.named_parameters()},
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "ema": {k: v.detach().cpu() for k, v in state.ema.items()}}


def hold(ref: dict, got: dict) -> dict:
    """The check of 3 (module docstring) on one rank: its readings and the
    misses it found (`misses`, empty when it passes)."""
    misses = []
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    if not loss_rel <= 1e-5:
        misses.append(f"loss {got['loss']} against {ref['loss']} ({loss_rel:.2e})")
    stats_rel = 0.0
    for k, v in ref["state"].items():
        if "running_" in k:
            gap = float((got["state"][k] - v).abs().max()) / max(1.0, float(v.abs().max()))
            if not gap <= 1e-5:
                misses.append(f"running statistic {k} is {gap:.3e} off")
            stats_rel = max(stats_rel, gap)
    worst, worst_name = 0.0, None
    for name, g in ref["grads"].items():
        gg = got["grads"][name]
        if name in ALPHAS:
            ok = abs(float(gg) - float(g)) <= 1e-2 * abs(float(g)) + 1e-6
        elif PRE_NORM_BIAS.fullmatch(name):
            w = float(ref["grads"][name[:-len("bias")] + "weight"].abs().max())
            ok = all(float(x.abs().max()) <= 1e-2 * w for x in (g, gg))
        else:
            gap = float((gg - g).double().norm() / g.double().norm())
            ok = gap <= 1e-2
            if gap > worst:
                worst, worst_name = gap, name
        if not ok:
            misses.append(f"the gradient of {name} is off")
    return {"loss_rel": loss_rel, "stats_rel": stats_rel, "grad_rel_l2": worst,
            "grad_rel_l2_name": worst_name, "misses": misses}


def any_rank(flag: bool, device: torch.device) -> bool:
    """Whether `flag` holds on any rank (every rank gets the answer)."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    dist.all_reduce(t)
    return float(t) > 0


def same_on_every_rank(tensors: dict, device: torch.device) -> bool:
    """Whether `tensors` are bitwise rank 0's on every rank."""
    flat = torch.cat([v.reshape(-1).double() for v in tensors.values()]).to(device)
    ref = flat.clone()
    dist.broadcast(ref, 0)
    return not any_rank(not torch.equal(ref, flat), device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="torchrun ... -m gimmvfi_tpu_torch.tools.dp_cards",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if not dist_ops.launched():
        raise RuntimeError("dp_cards runs under torchrun, one rank a card")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dp_cards runs on CUDA cards (--device cpu for a rehearsal)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    device = (torch.device("cuda", int(os.environ["LOCAL_RANK"])) if args.device == "cuda"
              else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cfg = load_config(RECIPE)
    n = cfg.experiment.batch_size
    batch = check_batch(world)
    ref = check_step(cfg, device, batch)
    plain = time_turn(cfg, recipe_batch(n, seed=rank, device=device), args.steps, args.warmup)

    dist_ops.init(device)
    try:
        got = check_step(cfg, device, {k: v[rank:rank + 1] for k, v in batch.items()})
        readings = hold(ref, got)
        # every rank takes each decision together, so none waits alone in a collective
        if any_rank(bool(readings["misses"]), device):
            raise AssertionError(f"rank {rank}: the check missed: {readings['misses']}")
        if not all(same_on_every_rank(got[key], device) for key in ("state", "ema")):
            raise AssertionError("the ranks' parameters, buffers or EMA differ after the step")
        global_batch = recipe_batch(n * world, device=device)
        rows = {k: v[rank * n:(rank + 1) * n] for k, v in global_batch.items()}
        dp = time_turn(cfg, rows, args.steps, args.warmup, trace=True)
        times = torch.tensor([plain["median_ms"], dp["median_ms"]], dtype=torch.float64,
                             device=device)
        gathered = [torch.zeros_like(times) for _ in range(world)]
        dist.all_gather(gathered, times)
    finally:
        dist_ops.shutdown()
    out = {"world": world, "check": readings, "ranks_bitwise_equal": True,
           "plain_ms": [float(t[0]) for t in gathered], "dp_ms": [float(t[1]) for t in gathered],
           "plain_rank0": plain, "dp_rank0": dp}
    if rank == 0:
        out["cards"] = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                        "--format=csv,noheader"], capture_output=True,
                                       text=True).stdout.strip().splitlines()
                        if device.type == "cuda" else ["cpu"])
        print(f"{world} ranks: the check's step against one process at batch {world}: loss "
              f"{readings['loss_rel']:.2e}, running statistics {readings['stats_rel']:.2e}, "
              f"gradients {readings['grad_rel_l2']:.2e} relative L2 "
              f"({readings['grad_rel_l2_name']}); ranks bitwise equal; the recipe step a rank "
              f"(batch {n}, global {n * world}): plain {out['plain_ms']} ms, data-parallel "
              f"{out['dp_ms']} ms (medians of {args.steps}); rank 0's traced data-parallel step "
              f"{dp.get('device_ms')} ms device, NCCL rows {dp.get('nccl_device_ms')}; "
              f"{out['cards']}", flush=True)
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
