"""GIMM-VFI training, both stages (`gimmvfi_tpu/cli/train.py`, the
reference's `src/main.py` + `trainers/trainer_gimm.py` /
`trainer_gimmvfi.py`).

    stage 1 (GIMM):     python -m gimmvfi_tpu_torch.cli.train --config configs/gimm/gimm.yaml
    stage 2 (GIMM-VFI): python -m gimmvfi_tpu_torch.cli.train \
        --config configs/gimmvfi/gimmvfi_r_arb.yaml --load-path <stage-1 ckpt> \
        [--lpips-path lpips.pt]
    either: [--result-path runs] [--overrides a.b=value ...] [--smoke-test]
        [--load-path ref.pt] [--resume] [--eval] [--device cuda|cpu]

One process a card, the CUDA card by default (`--device cpu` is for the CPU
tests); float32 with TF32 off. Under `torchrun` the run is data-parallel,
one process a card, as the JAX CLI runs one process a host over a mesh of
its devices:

    torchrun --standalone --nproc_per_node 8 -m gimmvfi_tpu_torch.cli.train \
        --config configs/gimmvfi/gimmvfi_r_arb.yaml --load-path <stage-1 ckpt> ...

`experiment.batch_size` is the batch a card, so the global batch is
`batch_size x world` and a node loads `global batch // nodes` a step (the
JAX CLI's batch a device and host batch); `total_batch_size` and the
warmup multiplier's `world_size` go by the global batch and the world, as
there. A rank loads only its rows of its node's batch
(`data/loader.py`); BatchNorm's statistics, the gradients and the metrics
are the global batch's (`parallel/dist.py`); rank 0 alone writes the run
directory (`config.yaml`, the source snapshot, `train.log`, the event
files, `metrics.jsonl`, `ckpt/`), the others log warnings to stderr.
Without torchrun's environment there is no process group and the run is
one process, as before. A failed group start raises, and a rank that fails
ends the run with a non-zero exit.

The run follows the JAX CLI step for step at the same topology: the same
loader batches (seeded by item), the same draws from
`np.random.default_rng(seed)` on every rank in the same order, each the
node batch's size and sliced to this rank's rows (stage 1: one t_id an
iteration; stage 2: the loss's pixel subsample for every train, validation
and image-log batch), the schedule's steps scaled by the grad-accumulation
derivation (`total_batch_size` only scales the schedule), validation (and
EMA validation) every `test_freq` epochs and at the last, stage 2's
reconstruction grid (rank 0's rows) every `test_imlog_freq` epochs,
checkpoints every `save_ckpt_freq` epochs and at the last
(`ckpt/step_<n>.pt`, the last 3 kept), log lines in the JAX CLI's format;
`metrics.jsonl` holds each epoch's summaries unrounded. `--resume` takes an
existing run directory as `--result-path` and re-reads its `config.yaml`;
`--load-path` takes a reference-layout `.pt` or a `ckpt/step_<n>.pt` of
either stage and loads the keys the model has (`merge_partial`: a stage-1
checkpoint gives stage 2 GIMM's encoder, refiner, HypoNet and alphas).
`--lpips-path`, a reference-layout LPIPS `.pt`, adds the perceptual loss
where the config asks for it.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import shutil
import time

import numpy as np
import torch

from ..data import DataLoader, create_dataset
from ..models.gimm import GIMM
from ..models.gimmvfi_f import GIMMVFI_F
from ..models.gimmvfi_r import GIMMVFI_R
from ..parallel import dist as dist_ops
from ..train.checkpoint import merge_partial, restore_checkpoint, save_checkpoint
from ..train.optim import create_optimizer, warmup_cosine_schedule
from ..train.train_state import (
    create_train_state,
    make_gimm_eval_step,
    make_gimm_train_step,
    make_gimmvfi_eval_step,
    make_gimmvfi_train_step,
)
from ..utils.config import load_config, save_config
from ..utils.convert import load_reference_state_dict, read_reference_state_dict
from ..utils.metrics import MetricAccumulator
from ..utils.writer import NullWriter, Writer, reconstruction_grid

logger = logging.getLogger("gimmvfi_tpu_torch.train")
STAGE1_METRICS = ("loss_total", "mse", "psnr")
STAGE2_METRICS = ("loss_total", "lap", "census", "l1", "rec", "lpips", "psnr")
STAGE2_VALID_METRICS = ("loss_total", "rec", "psnr")


def setup_run_dir(result_path: str, cfg, resume: bool = False, stamp: str | None = None,
                  is_main: bool = True) -> str:
    """A timestamped run directory under `result_path` with the config and a
    snapshot of the package, or `result_path` itself when resuming. The
    main process writes it and logs to its `train.log` and to stderr;
    another rank writes nothing and logs warnings to stderr. Every rank
    must pass the same `stamp`."""
    if resume:
        run_dir = result_path
        if not os.path.isdir(os.path.join(run_dir, "ckpt")):
            raise FileNotFoundError(f"--resume expects an existing run dir with a ckpt/: {run_dir}")
    else:
        run_dir = os.path.join(result_path, stamp or time.strftime("%d%m%Y_%H%M%S"))
        if is_main:
            os.makedirs(run_dir, exist_ok=True)
            save_config(cfg, os.path.join(run_dir, "config.yaml"))
            src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            shutil.copytree(src, os.path.join(run_dir, "src_snapshot", "gimmvfi_tpu_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"), dirs_exist_ok=True)
    handlers = [logging.StreamHandler()]
    if is_main:
        handlers.insert(0, logging.FileHandler(os.path.join(run_dir, "train.log")))
    logging.basicConfig(
        level=logging.INFO if is_main else logging.WARNING,
        handlers=handlers,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        force=True,
    )
    return run_dir


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def add_subsample(batch: dict, rng: np.random.Generator, ratio: float,
                  local_rank: int = 0, local_world: int = 1) -> dict:
    """Stage 2's loss subsample, drawn as the JAX CLI draws it for its host
    batch: for each of t = 0 and t = 1, a permutation of the H*W pixels a
    sample of the node batch (`local_world` times this rank's rows), cut to
    int(H*W*ratio), int32; this rank keeps its rows (N, K)."""
    n, h, w = batch["img0"].shape[:3]
    k = int(h * w * ratio)
    for key in ("sub_idx0", "sub_idx1"):
        drawn = np.stack([rng.permutation(h * w)[:k] for _ in range(n * local_world)])
        batch[key] = drawn[local_rank * n:(local_rank + 1) * n].astype(np.int32)
    return batch


def build_model(cfg, arch: str, device: torch.device) -> torch.nn.Module:
    """The config's model, float32, from torch's global generator, built as
    the JAX CLI builds it (`gimmvfi_tpu/cli/train.py`): every option at its
    default except GIMM-VFI-R's `raft_iters`, the config's `arch.raft_iter`,
    and GIMM's `remat`, on (GIMM-VFI-R and -F remat by default)."""
    if arch == "gimm":
        return GIMM(device=device, remat=True)
    if arch == "gimmvfi_r":
        return GIMMVFI_R(raft_iters=cfg.arch.raft_iter, device=device)
    if arch == "gimmvfi_f":
        return GIMMVFI_F(device=device)
    raise ValueError(f"unknown arch: {arch}")


def lpips_loss_fn(path: str, device: torch.device):
    """The perceptual loss of channels-last images in [0, 1]: LPIPS from a
    reference-layout `.pt`, frozen, per-sample distances (N, 1, 1, 1)."""
    from ..train.lpips import LPIPS

    model = load_reference_state_dict(path, LPIPS(device=device)).requires_grad_(False)
    return lambda pred, gt: model(pred.permute(0, 3, 1, 2), gt.permute(0, 3, 1, 2),
                                  normalize=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gimmvfi_tpu_torch.cli.train",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--result-path", default="runs")
    p.add_argument("--load-path", default=None,
                   help="partial init from a reference-layout .pt (keys the model has)")
    p.add_argument("--resume", action="store_true",
                   help="resume: --result-path must be an EXISTING run dir with ckpt/")
    p.add_argument("--overrides", nargs="*", default=[])
    p.add_argument("--smoke-test", action="store_true",
                   help="cut both splits to two batches")
    p.add_argument("--eval", action="store_true",
                   help="validate the loaded weights (--load-path or --resume) and exit")
    p.add_argument("--lpips-path", default=None,
                   help="LPIPS weights (reference-layout .pt): the perceptual loss of the "
                        "-P recipes (stage 2, where loss.perceptual_loss is set)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) or cpu, the latter for the CPU tests")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train (or with `--eval` validate) and return {"run_dir", "steps",
    "epochs": [{"epoch", "train", "seconds", "valid"?}], "writer"}. Under
    torchrun's environment this process is one rank of a data-parallel run
    (`parallel/dist.py: init`), and the group ends with the call."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the train CLI runs on a CUDA card (--device cpu is for the CPU tests)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if not dist_ops.launched():
        return _run(args, dist_ops.Topology(device=torch.device(args.device)))
    topo = dist_ops.init(args.device)
    try:
        return _run(args, topo)
    finally:
        dist_ops.shutdown()


def _run(args: argparse.Namespace, topo: dist_ops.Topology) -> dict:
    device = topo.device
    config_path = args.config
    if args.resume:
        saved = os.path.join(args.result_path, "config.yaml")
        if os.path.exists(saved):
            config_path = saved
    cfg = load_config(config_path, args.overrides)
    arch = cfg.arch.type.lower()
    is_stage2 = arch.startswith("gimmvfi")
    # every rank names the run directory by rank 0's clock
    stamp = dist_ops.broadcast_object(time.strftime("%d%m%Y_%H%M%S"))
    run_dir = setup_run_dir(args.result_path, cfg, resume=args.resume, stamp=stamp,
                            is_main=topo.is_main)
    dist_ops.barrier()
    seed = cfg.experiment.seed
    np_rng = np.random.default_rng(seed)
    writer, writer_kind = NullWriter(), "none"
    if topo.is_main:
        try:
            writer, writer_kind = Writer(run_dir), "tensorboardX"
        except ImportError:
            logger.info("tensorboardX is not installed: no event files; train.log has the numbers")

    batch = cfg.experiment.batch_size  # a card's
    global_batch = batch * topo.world
    host_batch = global_batch // topo.hosts
    logger.info("mesh: %d devices / %d hosts, global batch %d", topo.world, topo.hosts,
                global_batch)
    logger.info("device %s, batch %d a device", device, batch)
    trn, val = create_dataset(cfg.dataset.type, cfg.dataset.path,
                              crop_size=getattr(cfg.dataset, "crop_size", None),
                              aug=getattr(cfg.dataset, "aug", True))
    if args.smoke_test:
        trn.meta_data = trn.meta_data[: 2 * global_batch]
        val.meta_data = val.meta_data[: 2 * global_batch]
    shard = dict(seed=seed, shard_id=topo.host, num_shards=topo.hosts,
                 local_rank=topo.local_rank, local_world=topo.local_world)
    loader = DataLoader(trn, host_batch, **shard)
    val_loader = DataLoader(val, host_batch, shuffle=False, **shard)
    rows = dict(local_rank=topo.local_rank, local_world=topo.local_world)

    torch.manual_seed(seed)
    model = build_model(cfg, arch, device)
    if args.load_path:
        taken = merge_partial(model, read_reference_state_dict(args.load_path))
        logger.info("partially loaded weights from %s (%d tensors)", args.load_path, len(taken))

    # total_batch_size -> grad-accum derivation (`src/utils/config.py:92-105`):
    # as in the reference, it only scales the scheduler's steps
    total_bs = cfg.experiment.total_batch_size or global_batch
    if total_bs % global_batch != 0:
        raise ValueError(f"total_batch_size {total_bs} not divisible by batch_size x "
                         f"devices = {global_batch}")
    grad_accm_steps = max(1, total_bs // global_batch)
    if grad_accm_steps > 1:
        logger.info("grad_accm_steps=%d (scheduler steps scaled)", grad_accm_steps)
    steps_per_epoch = len(loader)
    w = cfg.optimizer.warmup
    schedule = warmup_cosine_schedule(
        cfg.optimizer.init_lr, w.min_lr,
        steps_per_epoch * cfg.experiment.epochs // grad_accm_steps,
        warmup_steps=w.epoch * steps_per_epoch // grad_accm_steps,
        buffer_steps=w.buffer_epoch * steps_per_epoch // grad_accm_steps,
        multiplier=w.multiplier, mode=w.mode, world_size=topo.world,
        start_from_zero=w.start_from_zero,
    )
    optimizer, scheduler = create_optimizer(
        model, opt_type=cfg.optimizer.type, init_lr=cfg.optimizer.init_lr,
        weight_decay=cfg.optimizer.weight_decay, betas=tuple(cfg.optimizer.betas),
        ft=cfg.optimizer.ft, lr_schedule=schedule, max_grad_norm=cfg.optimizer.max_gn,
    )
    use_ema = bool(cfg.arch.ema)
    state = create_train_state(model, optimizer, scheduler, use_ema=use_ema)
    logger.info("#params: %.2fM (%s)", param_count(model) / 1e6, arch)
    if is_stage2:
        lpips_fn = None
        if cfg.loss.perceptual_loss and args.lpips_path:
            lpips_fn = lpips_loss_fn(args.lpips_path, device)
            logger.info("perceptual (LPIPS) loss enabled from %s", args.lpips_path)
        step_fn = make_gimmvfi_train_step(cfg.arch.rec_weight, lpips_fn, use_ema=use_ema)
        eval_fn = make_gimmvfi_eval_step(cfg.arch.rec_weight)
        metric_names, valid_names = STAGE2_METRICS, STAGE2_VALID_METRICS
        ratio = cfg.loss.subsample.ratio
    else:
        step_fn = make_gimm_train_step(use_ema=use_ema)
        eval_fn = make_gimm_eval_step()
        metric_names = valid_names = STAGE1_METRICS

    epoch_st = 0
    if args.resume:
        last = restore_checkpoint(os.path.join(run_dir, "ckpt"), state)
        epoch_st = last // steps_per_epoch
        logger.info("resumed from step %d (epoch %d)", last, epoch_st)

    def run_validation(epoch: int) -> dict:
        """Model (and EMA) validation (`trainers/trainer.py:94-130`)."""
        eval_sets = [("valid", model)]
        if use_ema and state.ema is not None:
            ema_model = copy.deepcopy(model)
            ema_model.load_state_dict(state.ema)
            eval_sets.append(("valid_ema", ema_model))
        out = {}
        for tag, ev_model in eval_sets:
            vaccm = MetricAccumulator(valid_names)
            for vb in val_loader:
                if is_stage2:
                    add_subsample(vb, np_rng, ratio, **rows)
                vaccm.update({k: float(v) for k, v in eval_fn(ev_model, vb).items()})
            logger.info("epoch %d [%s]: %s", epoch, tag, vaccm.print_line())
            writer.add_scalars(vaccm.summary(), tag, epoch)
            out[tag] = vaccm.summary()
        return out

    @torch.no_grad()
    def log_reconstruction(epoch: int):
        """The first validation batch's reconstruction grid
        (`trainer_gimmvfi.py:384-421`), running statistics, of rank 0's
        rows; every rank draws its subsample."""
        vb = add_subsample(next(iter(val_loader)), np_rng, ratio, **rows)
        if not topo.is_main:
            return
        out = model.train_forward(
            torch.stack([torch.as_tensor(vb["img0"]), torch.as_tensor(vb["img1"])], dim=1),
            torch.as_tensor(vb["t"]), torch.as_tensor(vb["sub_idx0"]),
            torch.as_tensor(vb["sub_idx1"]), train=False)
        flowt = out["flowt"].cpu().numpy()
        grid = reconstruction_grid(vb["img0"], out["imgt_pred"].cpu().numpy(), vb["gt"],
                                   vb["img1"], flowt * -0.5, flowt * 0.5)
        writer.add_image("reconstruction", grid, "valid", epoch)

    def keep(record: dict):
        """An epoch's summaries, unrounded, as a line of `metrics.jsonl`."""
        result["epochs"].append(record)
        if topo.is_main:
            with open(os.path.join(run_dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(record) + "\n")

    result = {"run_dir": run_dir, "writer": writer_kind, "epochs": []}
    if args.eval:
        keep({"epoch": epoch_st, **run_validation(epoch_st)})
        result["steps"] = state.step
        writer.close()
        return result

    for epoch in range(epoch_st, cfg.experiment.epochs):
        loader.set_epoch(epoch)
        accm = MetricAccumulator(metric_names)
        t0 = time.time()
        for b in loader:
            if is_stage2:
                add_subsample(b, np_rng, ratio, **rows)
            else:
                # one shared t_id an iteration (`trainer_gimm.py:125-132`)
                b["t_id"] = np.full((b["xs"].shape[0],), np_rng.integers(0, 3), np.int32)
            metrics = step_fn(state, b)
            accm.update({k: float(v) for k, v in metrics.items()})
        seconds = time.time() - t0
        logger.info("epoch %d: %s (%.1fs)", epoch, accm.print_line(), seconds)
        writer.add_scalars(accm.summary(), "train", epoch)
        record = {"epoch": epoch, "train": accm.summary(), "seconds": seconds}

        last_epoch = epoch == cfg.experiment.epochs - 1
        if (epoch + 1) % cfg.experiment.test_freq == 0 or last_epoch:
            record.update(run_validation(epoch))
        if is_stage2 and (epoch + 1) % cfg.experiment.test_imlog_freq == 0:
            log_reconstruction(epoch)
        if (epoch + 1) % cfg.experiment.save_ckpt_freq == 0 or last_epoch:
            save_checkpoint(os.path.join(run_dir, "ckpt"), state.step, state)
        keep(record)
    writer.close()
    logger.info("training done: %s", run_dir)
    result["steps"] = state.step
    return result


if __name__ == "__main__":
    main()
