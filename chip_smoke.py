#!/usr/bin/env python3
"""Drive the PyTorch port's GIMM-VFI-R 8x path and its two probe entry
points once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):
  1. the card: CUDA must be present; prints nvidia-smi's name and power limit;
  2. builds the CUDA sources of gimmvfi_tpu_torch/csrc/ (softsplat.cu,
     conv3x3.cu, gather_probe.cu) all at once, one nvcc each;
  3. the splat kernel against its plain PyTorch version on the card, float32,
     in every case of `tools/splat_ablate.py: CHECK_CASES` (the main path's
     (1,736,1280,17) on a random, a smooth and a non-finite/far flow field;
     C in {1, 3, 5, 17, 33, 64}; N = 2; value counts off a multiple of 4);
     times it at 720p on the random and the smooth field, and reads the
     launch floor, the device time of one block at (1,8,8,1);
  4. GIMMVFI_R(raft_iters=2) float32 at 128x192 on the card (kernel) against
     the CPU (plain core), same seeded weights, TF32 off: PSNR >= 50 dB;
  5. the main path: GIMMVFI_R(raft_iters=20, dtype=bfloat16) on a seeded
     736x1280 pair, 7 timesteps through interpolate_sequential; checks shape,
     finiteness, range and exactly 14 kernel launches; prints fps, stage ms
     and peak memory from CUDA events after one warm-up; then reads the
     splat where it runs: its device time in a trace of one decode_one, and
     the kernel timed alone on the two inputs that decode_one gave it;
  6. the probes: the conv kernel against its plain version at the probe
     shape (1,736,1280,256) and six ragged shapes, each gather kernel
     against its plain version at its probe shape and with out-of-range
     indices; then the two probe entry points, `conv_proto.main` (kernel,
     cuDNN NCHW, cuDNN channels-last, plain, bound) and
     `gather_cost_probe.main` (torch.gather / torch.sort table, kernels),
     each of whose kernels must launch.
Phase 2 prints ptxas's registers, spills and warnings for each source and
whether it serialised `wgmma.mma_async`. Phases 3 and 6 time each kernel
with CUDA events around each call (`ms`) and also read its own device time
from a `torch.profiler` trace (`device_ms`; for the probes' library calls
`library_device_ms`; the conv and cuDNN are traced in turns). The launch
counts are set to 0 just before each path (5 and the probes of 6) and read
just after it. The line before the last is the kernels' JSON record; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R, interpolate_sequential
from gimmvfi_tpu_torch.nn.layers import init_normal_
from gimmvfi_tpu_torch.ops import softsplat as softsplat_ops
from gimmvfi_tpu_torch.ops.softsplat import SPLAT_KERNEL, splat_sum_plain
from gimmvfi_tpu_torch.tools import conv_proto, gather_cost_probe
from gimmvfi_tpu_torch.tools.conv_proto import CONV3X3_KERNEL, conv3x3_plain
from gimmvfi_tpu_torch.tools.gather_cost_probe import GATHERS
from gimmvfi_tpu_torch.tools.splat_ablate import (
    CHECK_CASES,
    MAIN_SHAPE,
    kernel_bound_ok,
    splat_bound,
    splat_inputs,
)
from gimmvfi_tpu_torch.utils.kernel_build import build_libraries
from gimmvfi_tpu_torch.utils.timing import cuda_ms, device_ms, fmt_ms

H, W = 736, 1280
N_T = 7
SEED = 0
PROBE_KERNELS = [CONV3X3_KERNEL] + [g[0] for g in GATHERS.values()]
KERNELS = [SPLAT_KERNEL] + PROBE_KERNELS
# (x shape, Cout): the probe shape, then ragged rows, tiles and channel chunks;
# then one pixel, W one over a 128-pixel tile multiple, and Cin off the
# 64-channel chunk with Cout under a 256-channel tile (the TMA zero fill)
CONV_CASES = [((1, H, W, 256), 256), ((1, 17, 23, 256), 256), ((2, 33, 40, 64), 64),
              ((1, 5, 130, 48), 80), ((1, 1, 1, 16), 16), ((2, 9, 257, 64), 256),
              ((1, 7, 200, 80), 96)]


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


def build_kernels():
    t0 = time.perf_counter()
    logs = build_libraries(Path(k.source).name for k in KERNELS)
    dt = time.perf_counter() - t0
    for k in KERNELS:
        k.build()  # loads the library just built
    for name, log in logs.items():
        lines = [ln.strip() for ln in log.splitlines()]
        keep = ("registers", "spill", "wgmma", "setmaxnreg")
        ptxas = [ln for ln in lines if any(k in ln for k in keep) or "warning" in ln.lower()]
        serial = [ln for ln in lines if "wgmma" in ln and "serializ" in ln]
        print(f"[2] built gimmvfi_tpu_torch/csrc/{name} (nvcc, sm_90a); ptxas: {' | '.join(ptxas)}",
              flush=True)
        print(f"[2] {name}: wgmma.mma_async serialised by ptxas: "
              f"{'yes: ' + ' | '.join(serial) if serial else 'no'}", flush=True)
    print(f"[2] {len(logs)} sources built in parallel in {dt:.2f} s", flush=True)


def splat_reading(vals, flow, label: str) -> dict:
    """Events time, device time (the kernel alone and the call with its zero
    fill) and plain time of the splat on these inputs, printed against the
    bound."""
    ms = cuda_ms(lambda: SPLAT_KERNEL(vals, flow), warmup=3)
    plain_ms = cuda_ms(lambda: splat_sum_plain(vals, flow), warmup=3)
    dev_ms, by_name = device_ms(lambda: SPLAT_KERNEL(vals, flow))
    own = kernel_row(by_name)
    bound, bound_by = splat_bound(vals)
    print(f"{label}: kernel {ms:.4f} ms by events ({100 * bound / ms:.1f}% of bound), device "
          f"{own:.4f} ms ({100 * bound / own:.1f}% of bound), call with zero fill "
          f"{fmt_ms(dev_ms)}; plain {plain_ms:.4f} ms; bound {bound:.4f} ms ({bound_by}) "
          f"[{'; '.join(f'{k[:60]} {v:.4f}' for k, v in by_name.items())}]", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "kernel_device_ms": own, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by}


def kernel_row(by_name: dict) -> float:
    """The splat kernel's own row of a `device_ms` reading."""
    rows = [v for k, v in by_name.items() if "splat_sum_kernel" in k]
    if len(rows) != 1:
        raise AssertionError(f"no single splat kernel row in the trace: {list(by_name)}")
    return rows[0]


def check_kernel() -> dict:
    worst = 0.0
    for i, (shape, field, std) in enumerate(CHECK_CASES):
        vals, flow = splat_inputs(shape, field, std, seed=SEED + i)
        got = SPLAT_KERNEL(vals, flow)
        ref = splat_sum_plain(vals, flow)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        ok, bound = kernel_bound_ok(err, ref)
        print(f"[3] splat {shape} {field} flow std {std}: max_abs_err={err:.3e} "
              f"(bound {bound:.3e})", flush=True)
        if not ok:
            raise AssertionError(f"splat kernel disagrees with its plain version at {shape} {field}")
        worst = max(worst, err)

    stats = {"max_abs_err": worst}
    for field in ("random", "smooth"):
        vals, flow = splat_inputs(MAIN_SHAPE, field, 20.0, seed=SEED)
        reading = splat_reading(vals, flow, f"[3] splat {MAIN_SHAPE} {field} flow std 20")
        if field == "random":
            stats.update(reading, library_ms=None)
        else:
            stats.update({f"smooth_{k}": reading[k]
                          for k in ("ms", "kernel_device_ms", "plain_ms")})
    # the launch floor: one block of one channel
    vals, flow = splat_inputs((1, 8, 8, 1), "random", 0.6, seed=SEED)
    _, by_name = device_ms(lambda: SPLAT_KERNEL(vals, flow), iters=50)
    stats["floor_device_ms"] = kernel_row(by_name)
    print(f"[3] splat (1, 8, 8, 1), one block: device {stats['floor_device_ms']:.6f} ms "
          f"(the launch floor)", flush=True)
    return stats


class SplatRecorder:
    """Stands in for the splat kernel in `ops.softsplat` and keeps a copy of
    each input it is given."""

    def __init__(self):
        self.inputs = []

    def __call__(self, vals, flow):
        self.inputs.append((vals.clone(), flow.clone()))
        return SPLAT_KERNEL(vals, flow)


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def check_small_e2e():
    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(rng.random((1, 2, 128, 192, 3), dtype=np.float32))
    ts = [0.25, 0.5, 0.75]
    cpu_model = init_normal_(GIMMVFI_R(raft_iters=2, device="cpu"), SEED)
    gpu_model = init_normal_(GIMMVFI_R(raft_iters=2), SEED)  # the card, same seeded weights
    ref = interpolate_sequential(cpu_model, img, ts)["imgt_pred"]
    # the host frames go in as they are: prepare moves them to the card
    got = interpolate_sequential(gpu_model, img, ts)["imgt_pred"].cpu()
    db = psnr(got, ref)
    print(f"[4] GIMMVFI_R(raft_iters=2) f32 128x192, t={ts}: GPU vs CPU PSNR {db:.2f} dB", flush=True)
    if not db >= 50.0:
        raise AssertionError(f"GPU and CPU disagree: {db:.2f} dB < 50 dB")


def run_main_path() -> tuple[int, dict]:
    model = init_normal_(GIMMVFI_R(raft_iters=20, dtype=torch.bfloat16), SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    # loading the frames is set-up: they are on the card before the clock starts
    img_xs = torch.rand((1, 2, H, W, 3), generator=gen).cuda()
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]

    interpolate_sequential(model, img_xs, ts)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
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

    # the splat where it runs: its own device time in a trace of one
    # decode_one (2 launches), then the kernel alone on the inputs the path
    # gave it in that call
    with torch.inference_mode():
        _, by_name = device_ms(lambda: model.decode_one(prep, ts[N_T // 2]), iters=3)
        recorder = SplatRecorder()
        softsplat_ops.SPLAT_KERNEL = recorder
        try:
            model.decode_one(prep, ts[N_T // 2])
        finally:
            softsplat_ops.SPLAT_KERNEL = SPLAT_KERNEL
    in_situ = kernel_row(by_name) / 2
    readings = [splat_reading(vals, flow, f"[5] splat on the main path's input {k} "
                                          f"{tuple(vals.shape)} at t={ts[N_T // 2]}")
                for k, (vals, flow) in enumerate(recorder.inputs)]
    if len(readings) != 2 or any(tuple(v.shape) != MAIN_SHAPE for v, _ in recorder.inputs):
        raise AssertionError(f"decode_one gave the splat {[tuple(v.shape) for v, _ in recorder.inputs]}")
    splat = {"main_path_in_situ_device_ms": in_situ}
    for key in ("ms", "kernel_device_ms", "plain_ms"):
        splat[f"main_path_{key}"] = statistics.mean(r[key] for r in readings)
    print(f"[5] splat inside decode_one: device {in_situ:.4f} ms a launch "
          f"({100 * readings[0]['bound_ms'] / in_situ:.1f}% of bound)", flush=True)

    print(f"[5] main path bf16 {H}x{W} 8x: imgt_pred {tuple(imgs.shape)} finite in "
          f"[{float(imgs.min()):.4f}, {float(imgs.max()):.4f}]; splat launches {launches}", flush=True)
    print(f"[5] {N_T / (total_ms / 1000):.4f} fps ({total_ms:.2f} ms per pair); "
          f"prepare {prepare_ms:.2f} ms; decode_one mean {statistics.mean(decode_ms):.2f} ms; "
          f"peak allocated {peak} B ({peak / 2**30:.3f} GiB)", flush=True)
    return launches, splat


def reset_counts():
    for k in KERNELS:
        k.launches = 0


def check_conv() -> float:
    """The conv kernel against conv3x3_plain on the card, elementwise in f32:
    |got - plain| <= 2**-6 |plain| + 1e-4 max|plain| (two bf16 roundings of
    f32 sums taken in another order, plus slack for outputs near zero)."""
    worst = 0.0
    for i, (shape, cout) in enumerate(CONV_CASES):
        x, w = conv_proto.probe_inputs(shape, cout, seed=SEED + i)
        got = CONV3X3_KERNEL(x, w).float()
        ref = conv3x3_plain(x, w).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        limit = 2.0**-6 * ref.abs() + 1e-4 * float(ref.abs().max())
        bad = int((err > limit).sum()) + int((~torch.isfinite(got)).sum())
        print(f"[6] conv3x3 {shape}x(3,3,{shape[3]},{cout}): max_abs_err "
              f"{float(err.max()):.3e}, max|plain| {float(ref.abs().max()):.3e}, "
              f"{bad} elements over the bound", flush=True)
        if bad:
            raise AssertionError(f"conv3x3 kernel disagrees with its plain version at {shape}")
        worst = max(worst, float(err.max()))
    return worst


def check_gathers() -> dict:
    """Each gather kernel against its plain version at its probe shape, and
    with out-of-range and negative indices: exactly equal, NaN at the same
    places (none for subgather_grid, whose `% 512` keeps every index in range)."""
    rng = np.random.default_rng(SEED)
    worst = {}
    for name, (xn, idxn) in gather_cost_probe.gather_tables(SEED).items():
        kernel, plain, _ = GATHERS[name]
        n = xn.shape[1] if name == "lanegather" else xn.shape[0]
        bad_idx = idxn.copy()
        pick = rng.random(idxn.shape) < 0.05
        bad_idx[pick] = rng.choice([-1, -n, n, n + 7, -n - 1, 2**31 - 1, -2**31], int(pick.sum()))
        worst[name] = 0.0
        for label, idx_np in (("probe", idxn), ("out-of-range", bad_idx)):
            x, idx = torch.from_numpy(xn).cuda(), torch.from_numpy(idx_np).cuda()
            got = kernel(x, idx)
            ref = plain(x, idx)
            torch.cuda.synchronize()
            nan = torch.isnan(ref)
            same = torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], ref[~nan])
            n_nan = int(nan.sum())
            err = float((got[~nan] - ref[~nan]).abs().max())
            worst[name] = max(worst[name], err)
            print(f"[6] {name} {tuple(x.shape)} {label} indices: equal {same}, "
                  f"max_abs_err {err:.3e}, NaN {n_nan}", flush=True)
            if not same:
                raise AssertionError(f"{name} kernel differs from its plain version ({label})")
            if label == "out-of-range" and (n_nan == 0) != (name == "subgather_grid"):
                raise AssertionError(f"{name}: wrong NaN fill for out-of-range indices")
    return worst


def run_probes() -> tuple[dict, dict, dict]:
    """The two probe entry points, with the probe kernels' counts from 0."""
    reset_counts()
    conv = conv_proto.main()
    table, gathers = gather_cost_probe.main()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in PROBE_KERNELS}
    print(f"[6] probe kernel launches: {launches}", flush=True)
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"the probe path launched {name} no time")
    return conv, gathers, launches


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = check_card()
    build_kernels()
    kstats = check_kernel()
    check_small_e2e()
    splat_launches, main_splat = run_main_path()
    torch.cuda.empty_cache()
    conv_err = check_conv()
    gather_err = check_gathers()
    conv, gathers, launches = run_probes()
    print(f"[6] conv3x3 (1,{H},{W},256): kernel {conv['kernel_ms']:.4f} ms "
          f"({100 * conv['bound_ms'] / conv['kernel_ms']:.1f}% of its {conv['bound_ms']:.4f} ms "
          f"bound; device time {fmt_ms(conv['kernel_device_ms'])}), cuDNN NCHW "
          f"{conv['cudnn_nchw_ms']:.4f} ms, cuDNN channels-last {conv['cudnn_channels_last_ms']:.4f} "
          f"ms (device time {fmt_ms(conv['cudnn_channels_last_device_ms'])}), plain "
          f"{conv['plain_ms']:.4f} ms; {smi}",
          flush=True)

    def record(kernel, launches, **numbers):
        return {"name": kernel.name, "route": "cuda", "source": kernel.source,
                "replaces": kernel.replaces, "launches": launches, **numbers}

    records = [
        record(SPLAT_KERNEL, splat_launches, **kstats, **main_splat),
        record(CONV3X3_KERNEL, launches[CONV3X3_KERNEL.name], max_abs_err=conv_err,
               ms=conv["kernel_ms"], device_ms=conv["kernel_device_ms"],
               plain_ms=conv["plain_ms"], bound_ms=conv["bound_ms"], bound_by=conv["bound_by"],
               library_ms=conv["cudnn_channels_last_ms"],
               library_device_ms=conv["cudnn_channels_last_device_ms"]),
    ] + [
        record(GATHERS[name][0], launches[name], max_abs_err=gather_err[name], **gathers[name])
        for name in GATHERS
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
