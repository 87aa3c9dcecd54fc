#!/usr/bin/env python3
"""Drive the PyTorch port's GIMM-VFI-R 8x path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):
  1. the card: CUDA must be present; prints nvidia-smi's name and power limit;
  2. builds the CUDA splat kernel from gimmvfi_tpu_torch/csrc/;
  3. kernel against its plain PyTorch version on the card, float32, at the
     main path's 736x1280x17 shape, the reference test shapes, and a case
     with non-finite and far out-of-frame flows; times both at 720p;
  4. GIMMVFI_R(raft_iters=2) float32 at 128x192 on the card (kernel) against
     the CPU (plain core), same seeded weights, TF32 off: PSNR >= 50 dB;
  5. the main path: GIMMVFI_R(raft_iters=20, dtype=bfloat16) on a seeded
     736x1280 pair, 7 timesteps through interpolate_sequential; checks shape,
     finiteness, range and exactly 14 kernel launches; prints fps, stage ms
     and peak memory from CUDA events after one warm-up.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R, interpolate_sequential
from gimmvfi_tpu_torch.nn.layers import init_normal_
from gimmvfi_tpu_torch.ops.softsplat import SPLAT_KERNEL, splat_sum_plain

H, W = 736, 1280
N_T = 7
SEED = 0


def check_card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this check needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)
    return smi


def build_kernel():
    t0 = time.perf_counter()
    log = SPLAT_KERNEL.build()
    dt = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"[2] built {SPLAT_KERNEL.source} in {dt:.2f} s; ptxas: {' | '.join(ptxas)}", flush=True)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Median ms of fn() over `iters` runs, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernel() -> dict:
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")

    def case(shape, flow_std, corrupt=False):
        n, h, w, c = shape
        vals = rng.standard_normal(shape).astype(np.float32)
        flow = (rng.standard_normal((n, h, w, 2)) * flow_std).astype(np.float32)
        if corrupt:
            pick = rng.random((n, h, w, 2))
            flow[pick < 0.01] = np.nan
            flow[(pick >= 0.01) & (pick < 0.02)] = np.inf
            flow[(pick >= 0.02) & (pick < 0.03)] = -np.inf
            flow[(pick >= 0.03) & (pick < 0.08)] *= 1e4
        return torch.from_numpy(vals).to(dev), torch.from_numpy(flow).to(dev)

    cases = [
        ((1, H, W, 17), 20.0, False),
        ((1, H, W, 17), 20.0, True),
        ((1, 16, 24, 5), 3.0, False),
        ((2, 24, 16, 3), 30.0, False),
        ((1, 8, 8, 1), 0.6, False),
    ]
    worst = 0.0
    for shape, std, corrupt in cases:
        vals, flow = case(shape, std, corrupt)
        got = SPLAT_KERNEL(vals, flow)
        ref = splat_sum_plain(vals, flow)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        bound = 1e-5 * max(1.0, float(ref.abs().max()))
        print(f"[3] splat {shape} flow_std={std} non-finite={corrupt}: "
              f"max_abs_err={err:.3e} (bound {bound:.3e})", flush=True)
        if not err <= bound:
            raise AssertionError(f"splat kernel disagrees with its plain version at {shape}")
        worst = max(worst, err)

    vals, flow = case((1, H, W, 17), 20.0)
    ms = cuda_ms(lambda: SPLAT_KERNEL(vals, flow))
    plain_ms = cuda_ms(lambda: splat_sum_plain(vals, flow))
    print(f"[3] splat (1,{H},{W},17) median: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def check_small_e2e():
    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(rng.random((1, 2, 128, 192, 3), dtype=np.float32))
    ts = [0.25, 0.5, 0.75]
    cpu_model = init_normal_(GIMMVFI_R(raft_iters=2), SEED)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    ref = interpolate_sequential(cpu_model, img, ts)["imgt_pred"]
    got = interpolate_sequential(gpu_model, img.cuda(), ts)["imgt_pred"].cpu()
    db = psnr(got, ref)
    print(f"[4] GIMMVFI_R(raft_iters=2) f32 128x192, t={ts}: GPU vs CPU PSNR {db:.2f} dB", flush=True)
    if not db >= 50.0:
        raise AssertionError(f"GPU and CPU disagree: {db:.2f} dB < 50 dB")


def run_main_path() -> int:
    dev = torch.device("cuda")
    model = init_normal_(GIMMVFI_R(raft_iters=20, dtype=torch.bfloat16), SEED).to(dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    img_xs = torch.rand((1, 2, H, W, 3), generator=gen).to(dev)
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]

    interpolate_sequential(model, img_xs, ts)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    SPLAT_KERNEL.launches = 0
    start.record()
    out = interpolate_sequential(model, img_xs, ts)
    end.record()
    end.synchronize()
    launches = SPLAT_KERNEL.launches
    total_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()

    imgs = out["imgt_pred"]
    if tuple(imgs.shape) != (N_T, 1, H, W, 3):
        raise AssertionError(f"imgt_pred shape {tuple(imgs.shape)}")
    if not bool(torch.isfinite(imgs).all()):
        raise AssertionError("imgt_pred has non-finite values")
    if not (float(imgs.min()) >= 0.0 and float(imgs.max()) <= 1.0):
        raise AssertionError("imgt_pred leaves [0, 1]")
    if launches != 2 * N_T:
        raise AssertionError(f"{launches} splat kernel launches, expected {2 * N_T}")

    # stage split, same inputs, CUDA events around prepare and each decode_one
    events = [torch.cuda.Event(enable_timing=True) for _ in range(N_T + 2)]
    with torch.inference_mode():
        events[0].record()
        prep = model.prepare(img_xs)
        events[1].record()
        for i, tv in enumerate(ts):
            model.decode_one(prep, tv)
            events[i + 2].record()
    torch.cuda.synchronize()
    prepare_ms = events[0].elapsed_time(events[1])
    decode_ms = [events[i + 1].elapsed_time(events[i + 2]) for i in range(N_T)]

    print(f"[5] main path bf16 {H}x{W} 8x: imgt_pred {tuple(imgs.shape)} finite in "
          f"[{float(imgs.min()):.4f}, {float(imgs.max()):.4f}]; splat launches {launches}", flush=True)
    print(f"[5] {N_T / (total_ms / 1000):.4f} fps ({total_ms:.2f} ms per pair); "
          f"prepare {prepare_ms:.2f} ms; decode_one mean {statistics.mean(decode_ms):.2f} ms; "
          f"peak allocated {peak} B ({peak / 2**30:.3f} GiB)", flush=True)
    return launches


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    check_card()
    build_kernel()
    kstats = check_kernel()
    check_small_e2e()
    launches = run_main_path()
    record = {
        "name": SPLAT_KERNEL.name, "route": "cuda", "source": SPLAT_KERNEL.source,
        "replaces": SPLAT_KERNEL.replaces, "launches": launches, **kstats,
    }
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
