"""Training throughput of both recipes on one CUDA card: the counterpart of
the repo's `tools/tpu_train_throughput.py` (`TRAIN_TPU.json`).

    python -m gimmvfi_tpu_torch.tools.train_throughput [--steps 100] [--out PATH]

Runs each stage for `--steps` real steps on fabricated data, drawn from
`np.random.default_rng(0)` in the JAX tool's order, with random weights
(`init_normal_`, normal 0.02 from seed 0; BatchNorm statistics 0 / 1),
float32 with TF32 off:

  stage 1 (GIMM motion pretraining): GIMM(remat=True), batch 32 at 256x256, AdamW
      at 1e-4 without the ft groups, EMA, one shared `t_id` a step
      (`configs/gimm/gimm.yaml`);
  stage 2 (GIMM-VFI-R fine-tuning): GIMMVFI_R(raft_iters=20) (remat on,
      its default), batch 4 at 224x224, AdamW at 8e-5 with the ft groups, EMA, no perceptual loss
      (`configs/gimmvfi/gimmvfi_r_arb.yaml`), the same batch every step.

Each stage reports `TRAIN_TPU.json`'s fields: steps/sec over steps 1..N-1
(the host clock from a synchronize after step 0 to one after the last
step), a 5-point loss curve and `loss_decreased` (the losses stay on the
device until the end), the peak (`max_memory_allocated`, MiB) as
`peak_hbm_mib`, and `first_step_s` in place of `compile_s`: nothing
compiles here, the first step holds the kernels' builds and cuDNN's
choices. The last line printed is the record, with the card's name and
power limit from `nvidia-smi`; `--out PATH` also writes it to PATH.

The default device is the card, and without one `main` raises;
`--device cpu` is for the CPU tests, which also cut the shapes and the
flow iterations through `run_stage1`'s and `run_stage2`'s arguments.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..bench import card_info
from ..models.gimm import GIMM
from ..models.gimmvfi_r import GIMMVFI_R
from ..nn.layers import init_normal_
from ..train.optim import create_optimizer
from ..train.train_state import create_train_state, make_gimm_train_step, make_gimmvfi_train_step

SEED = 0


def stage1_data(steps: int, batch: int, hw) -> dict:
    """The JAX tool's stage-1 draws (`tools/tpu_train_throughput.py:72-74,
    87`), in its order: xs (batch, 3, H, W, 2) uniform, ori_flows
    (batch, 2, H, W, 2) normal with std 3, both float32, then one t_id in
    {0, 1, 2} a step (int64)."""
    rng = np.random.default_rng(0)
    h, w = hw
    xs = rng.random((batch, 3, h, w, 2)).astype(np.float32)
    ori = rng.normal(0, 3, (batch, 2, h, w, 2)).astype(np.float32)
    return {"xs": xs, "ori_flows": ori, "t_ids": rng.integers(0, 3, size=steps)}


def stage2_batch(batch: int, hw) -> dict:
    """The JAX tool's stage-2 batch (`tools/tpu_train_throughput.py:
    127-141`), in its order: img0, img1 uniform float32, gt their mean,
    t = 0.5, and each sample's first 10% of a permutation of the pixels
    for sub_idx0, then for sub_idx1 (int32)."""
    rng = np.random.default_rng(0)
    h, w = hw
    k = int(h * w * 0.1)
    img0 = rng.random((batch, h, w, 3)).astype(np.float32)
    img1 = rng.random((batch, h, w, 3)).astype(np.float32)
    out = {"img0": img0, "img1": img1, "gt": np.float32(0.5) * (img0 + img1),
           "t": np.full((batch,), 0.5, np.float32)}
    for key in ("sub_idx0", "sub_idx1"):
        out[key] = np.stack([rng.permutation(h * w)[:k] for _ in range(batch)]).astype(np.int32)
    return out


def loss_points(losses: list[float], k: int = 5) -> list[list]:
    """k evenly spaced (step, loss) points of the curve."""
    idx = np.linspace(0, len(losses) - 1, k).astype(int)
    return [[int(i), float(losses[i])] for i in idx]


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def run_steps(stage: int, shape: str, steps: int, step_fn, device: torch.device) -> dict:
    """`steps` calls of `step_fn(i)`, which returns the step's loss as a
    0-d tensor on the device: the first timed alone, the rest together;
    the losses read back once at the end."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    losses.append(step_fn(0))
    sync(device)
    t_loop = time.perf_counter()
    first_step_s = t_loop - t0
    for i in range(1, steps):
        losses.append(step_fn(i))
    sync(device)
    elapsed = time.perf_counter() - t_loop
    curve = torch.stack(losses).cpu().tolist()
    return {
        "stage": stage,
        "shape": shape,
        "steps": steps,
        "first_step_s": first_step_s,
        "steps_per_sec": (steps - 1) / elapsed if steps > 1 else None,
        "loss_curve": loss_points(curve),
        "loss_decreased": bool(curve[-1] < curve[0]),
        "peak_hbm_mib": (torch.cuda.max_memory_allocated() / 2**20
                         if device.type == "cuda" else None),
    }


def run_stage1(steps: int, device="cuda", batch: int = 32, hw=(256, 256)) -> dict:
    """Stage 1: GIMM(remat=True), as the JAX tool builds it, AdamW at 1e-4
    without the ft groups, EMA, at the recipe's batch and crop
    (`configs/gimm/gimm.yaml`) unless given."""
    device = torch.device(device)
    data = stage1_data(steps, batch, hw)
    xs = torch.from_numpy(data["xs"]).to(device)
    ori = torch.from_numpy(data["ori_flows"]).to(device)
    model = init_normal_(GIMM(device=device, remat=True), SEED)
    opt, sched = create_optimizer(model, ft=False, init_lr=1e-4)
    state = create_train_state(model, opt, sched, use_ema=True)
    train_step = make_gimm_train_step(use_ema=True)

    def step(i):
        # one shared t_id a step (`trainer_gimm.py:125-132`)
        t_id = torch.full((batch,), int(data["t_ids"][i]), dtype=torch.long, device=device)
        return train_step(state, {"xs": xs, "ori_flows": ori, "t_id": t_id})["loss_total"]

    return run_steps(1, f"bs{batch} {hw[0]}x{hw[1]}", steps, step, device)


def run_stage2(steps: int, device="cuda", batch: int = 4, hw=(224, 224),
               raft_iters: int = 20) -> dict:
    """Stage 2: GIMMVFI_R, AdamW at 8e-5 with the ft groups, EMA, no
    perceptual loss, the same batch every step, at the recipe's batch,
    crop and flow iterations (`configs/gimmvfi/gimmvfi_r_arb.yaml`) unless
    given."""
    device = torch.device(device)
    data = {k: torch.from_numpy(v).to(device) for k, v in stage2_batch(batch, hw).items()}
    model = init_normal_(GIMMVFI_R(raft_iters=raft_iters, device=device), SEED)
    opt, sched = create_optimizer(model, ft=True, init_lr=8e-5)
    state = create_train_state(model, opt, sched, use_ema=True)
    train_step = make_gimmvfi_train_step(use_ema=True)
    return run_steps(2, f"bs{batch} {hw[0]}x{hw[1]}", steps,
                     lambda i: train_step(state, data)["loss_total"], device)


def main(argv=None) -> dict:
    """Run both stages; returns the record that the last line prints."""
    p = argparse.ArgumentParser(prog="python -m gimmvfi_tpu_torch.tools.train_throughput",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", default=None, help="also write the record to this file")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default); cpu only for the CPU tests")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the training throughput needs a CUDA card "
                           "(--device cpu is for the CPU tests only)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    record = {"device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"}
    record["name"], record["power_limit"] = (card_info() if device.type == "cuda"
                                             else (None, None))
    record["stage1"] = run_stage1(args.steps, device)
    print("stage1:", json.dumps(record["stage1"]), flush=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    record["stage2"] = run_stage2(args.steps, device)
    print("stage2:", json.dumps(record["stage2"]), flush=True)
    line = json.dumps(record)
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return record


if __name__ == "__main__":
    main()
