"""Stage-1 GIMM training (`gimmvfi_tpu/cli/train.py`, the reference's
`src/main.py` + `trainers/trainer_gimm.py`).

    python -m gimmvfi_tpu_torch.cli.train --config configs/gimm/gimm.yaml \
        [--result-path runs] [--overrides a.b=value ...] [--smoke-test] \
        [--load-path gimm.pt] [--resume] [--eval] [--device cuda|cpu]

One process on one device, the CUDA card by default (`--device cpu` is for
the CPU tests); TF32 is off, so float32 means float32. The run follows the
JAX CLI step for step: the same loader batches (seeded by item), one t_id
an iteration from `np.random.default_rng(seed)`, the schedule's steps
scaled by the grad-accumulation derivation, validation every `test_freq`
epochs and at the last, checkpoints every `save_ckpt_freq` epochs and at
the last (`ckpt/step_<n>.pt`, the last 3 kept), log lines in the JAX CLI's
format. `--resume` takes an existing run directory as `--result-path` and
re-reads its `config.yaml`; `--load-path` takes a reference-layout `.pt`
and loads the keys the model has (`merge_partial`). Stage-2 configs
(`gimmvfi_*`) are later work (ROADMAP A13b); data parallelism is A13c.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import shutil
import time

import numpy as np
import torch

from ..data import DataLoader, create_dataset
from ..models.gimm import GIMM
from ..train.checkpoint import merge_partial, restore_checkpoint, save_checkpoint
from ..train.optim import create_optimizer, warmup_cosine_schedule
from ..train.train_state import create_train_state, make_gimm_eval_step, make_gimm_train_step
from ..utils.config import load_config, save_config
from ..utils.convert import read_reference_state_dict
from ..utils.metrics import MetricAccumulator
from ..utils.writer import NullWriter, Writer

logger = logging.getLogger("gimmvfi_tpu_torch.train")
METRICS = ("loss_total", "mse", "psnr")


def setup_run_dir(result_path: str, cfg, resume: bool = False, stamp: str | None = None) -> str:
    """A timestamped run directory under `result_path` with the config and a
    snapshot of the package, or `result_path` itself when resuming; logs go
    to its `train.log` and to stderr."""
    if resume:
        run_dir = result_path
        if not os.path.isdir(os.path.join(run_dir, "ckpt")):
            raise FileNotFoundError(f"--resume expects an existing run dir with a ckpt/: {run_dir}")
    else:
        run_dir = os.path.join(result_path, stamp or time.strftime("%d%m%Y_%H%M%S"))
        os.makedirs(run_dir, exist_ok=True)
        save_config(cfg, os.path.join(run_dir, "config.yaml"))
        src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        shutil.copytree(src, os.path.join(run_dir, "src_snapshot", "gimmvfi_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"), dirs_exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        handlers=[logging.FileHandler(os.path.join(run_dir, "train.log")), logging.StreamHandler()],
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        force=True,
    )
    return run_dir


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


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
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default) or cpu, the latter for the CPU tests")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Train (or with `--eval` validate) and return {"run_dir", "steps",
    "epochs": [{"epoch", "train", "seconds", "valid"?}], "writer"}."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the train CLI runs on a CUDA card (--device cpu is for the CPU tests)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)

    config_path = args.config
    if args.resume:
        saved = os.path.join(args.result_path, "config.yaml")
        if os.path.exists(saved):
            config_path = saved
    cfg = load_config(config_path, args.overrides)
    arch = cfg.arch.type.lower()
    if arch.startswith("gimmvfi"):
        raise NotImplementedError(f"{arch}: stage-2 training is not ported yet (ROADMAP A13b)")
    if arch != "gimm":
        raise ValueError(f"unknown arch: {arch}")
    run_dir = setup_run_dir(args.result_path, cfg, resume=args.resume)
    seed = cfg.experiment.seed
    np_rng = np.random.default_rng(seed)
    try:
        writer, writer_kind = Writer(run_dir), "tensorboardX"
    except ImportError:
        writer, writer_kind = NullWriter(), "none"
        logger.info("tensorboardX is not installed: no event files; train.log has the numbers")

    batch = cfg.experiment.batch_size
    logger.info("device %s, batch %d", device, batch)
    trn, val = create_dataset(cfg.dataset.type, cfg.dataset.path,
                              crop_size=getattr(cfg.dataset, "crop_size", None))
    if args.smoke_test:
        trn.meta_data = trn.meta_data[: 2 * batch]
        val.meta_data = val.meta_data[: 2 * batch]
    loader = DataLoader(trn, batch, seed=seed)
    val_loader = DataLoader(val, batch, seed=seed, shuffle=False)

    torch.manual_seed(seed)
    model = GIMM(coord_range=tuple(cfg.arch.coord_range), device=device)
    if args.load_path:
        taken = merge_partial(model, read_reference_state_dict(args.load_path))
        logger.info("partially loaded weights from %s (%d tensors)", args.load_path, len(taken))

    # total_batch_size -> grad-accum derivation (`src/utils/config.py:92-105`):
    # as in the reference, it only scales the scheduler's steps
    total_bs = cfg.experiment.total_batch_size or batch
    if total_bs % batch != 0:
        raise ValueError(f"total_batch_size {total_bs} not divisible by batch_size {batch}")
    grad_accm_steps = max(1, total_bs // batch)
    if grad_accm_steps > 1:
        logger.info("grad_accm_steps=%d (scheduler steps scaled)", grad_accm_steps)
    steps_per_epoch = len(loader)
    w = cfg.optimizer.warmup
    schedule = warmup_cosine_schedule(
        cfg.optimizer.init_lr, w.min_lr,
        steps_per_epoch * cfg.experiment.epochs // grad_accm_steps,
        warmup_steps=w.epoch * steps_per_epoch // grad_accm_steps,
        buffer_steps=w.buffer_epoch * steps_per_epoch // grad_accm_steps,
        multiplier=w.multiplier, mode=w.mode, world_size=1,
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
    step_fn = make_gimm_train_step(use_ema=use_ema)
    eval_fn = make_gimm_eval_step()

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
            vaccm = MetricAccumulator(METRICS)
            for vb in val_loader:
                vaccm.update({k: float(v) for k, v in eval_fn(ev_model, vb).items()})
            logger.info("epoch %d [%s]: %s", epoch, tag, vaccm.print_line())
            writer.add_scalars(vaccm.summary(), tag, epoch)
            out[tag] = vaccm.summary()
        return out

    result = {"run_dir": run_dir, "writer": writer_kind, "epochs": []}
    if args.eval:
        result["epochs"].append({"epoch": epoch_st, **run_validation(epoch_st)})
        result["steps"] = state.step
        writer.close()
        return result

    for epoch in range(epoch_st, cfg.experiment.epochs):
        loader.set_epoch(epoch)
        accm = MetricAccumulator(METRICS)
        t0 = time.time()
        for b in loader:
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
        if (epoch + 1) % cfg.experiment.save_ckpt_freq == 0 or last_epoch:
            save_checkpoint(os.path.join(run_dir, "ckpt"), state.step, state)
        result["epochs"].append(record)
    writer.close()
    logger.info("training done: %s", run_dir)
    result["steps"] = state.step
    return result


if __name__ == "__main__":
    main()
