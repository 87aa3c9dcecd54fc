#!/usr/bin/env python3
"""Drive the PyTorch port's GIMM-VFI-R 8x paths (720p, and 2K/4K through
DS_SCALE and the windowed correlation), its GIMM-VFI-F 8x path at 720p,
its bench entry and its two probe entry points once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):
  1. the card: CUDA must be present; prints nvidia-smi's name and power limit;
  2. builds the CUDA sources of gimmvfi_tpu_torch/csrc/ (softsplat.cu,
     windowed_corr_mma.cu, windowed_corr.cu, conv3x3.cu, gather_probe.cu)
     all at once, one nvcc each; counts the HMMA (tensor-core) instructions
     in windowed_corr_mma's SASS (`cuobjdump -sass`) and fails on none;
  3. the splat kernel against its plain PyTorch version on the card, float32,
     in every case of `tools/splat_ablate.py: CHECK_CASES` (the main path's
     (1,736,1280,17) on a random, a smooth and a non-finite/far flow field;
     C in {1, 3, 5, 17, 33, 64}; N = 2; value counts off a multiple of 4);
     times it at 720p on the random and the smooth field;
  4. GIMMVFI_R(raft_iters=2) float32 at 128x192 on the card (kernel) against
     the CPU (plain core), same seeded weights, TF32 off: PSNR >= 50 dB;
  5. the main path: GIMMVFI_R(raft_iters=20, dtype=bfloat16) on a seeded
     736x1280 pair, 7 timesteps through interpolate_sequential; checks shape,
     finiteness, range, exactly 14 splat launches and no windowed-correlation
     launch (the 720p volumes fit under the 2 GiB limit); prints fps, stage ms
     and peak memory from CUDA events after one warm-up; then reads the
     splat where it runs: its device time in a trace of one decode_one, and
     the kernel timed alone on the two inputs that decode_one gave it;
  6. the probes: the conv kernel against its plain version at the probe
     shape (1,736,1280,256) and six ragged shapes, each gather kernel
     against its plain version at its probe shape and with out-of-range
     indices; then the two probe entry points, `conv_proto.main` (kernel,
     cuDNN NCHW, cuDNN channels-last, plain, bound) and
     `gather_cost_probe.main` (torch.gather / torch.sort table, kernels),
     each of whose kernels must launch; then the launch floor, the device
     time of an empty kernel, and each gather against max(floor, bound);
  7. the windowed lookup's two kernels against the plain version on the
     card, each through the route (`ops/corr.py: windowed_corr_kernel_for`:
     bf16 to the tensor-core `windowed_corr_mma.cu`, float32 to the
     CUDA-core `windowed_corr.cu`; `tools/windowed_ablate.py:
     windowed_agreement`: float32 <= 1e-5 of the largest value, bf16 within
     one bf16 step, NaN at the same places), in `WINDOWED_CASES` and
     `MMA_CASES` (C = 256 and small C, an odd level size, in-frame, smooth,
     border and far or non-finite coordinates, each float32 case also in
     bf16), and at the shapes the 2048x1088 DS 1.0 path gives it (RAFT's
     (2,136,256) and the AMT's (1,136,256), C = 256, bf16) on in-frame and
     smooth coordinates; the float32 lookup against the materialized
     `corr_lookup` at the 720p fmap (92x160, C = 256, <= 1e-4); then both
     kernels timed in bf16 in the same run, against the bound, with the
     tile walk's union extent (`mma_tile_extents`): at the 2048x1088 DS 1.0
     RAFT lookup on in-frame and smooth coordinates, at 720p beside the
     materialized lookup, and (after phase 8 (c)) on the inputs of the
     first and last RAFT lookups of a `prepare` of that path, captured;
  8. three more main paths, each 8x bf16 with 7 timesteps and counts from 0:
     (a) 2048x1088 at DS 0.5, (b) 4096x2176 at DS 0.25, both materialized at
     1024x544, and (c) 2048x1088 at DS 1.0, windowed in RAFT and the AMT;
     checks shapes, finiteness, range, 14 splat launches and exactly 0, 0
     and 20 + 2 x 7 launches of the tensor-core windowed kernel, and none
     of the CUDA-core one; prints fps, the prepare/decode_one
     split and peak memory (beside the reference's V100 envelopes for (a)
     and (b)); then GPU vs CPU float32 >= 50 dB with the windowed path
     forced at 128x192 (float32 lookups: the CUDA-core kernel, 8 launches
     counted from 0) and with DS 0.5 at 256x384;
  9. GIMM-VFI-F: (a) GIMMVFI_F(ff_iters=32, dtype=bfloat16) on the seeded
     736x1280 pair, 7 timesteps, through `drive_path`: shape, finiteness,
     range, exactly 14 splat, 14 `windowed_corr` and 0 `windowed_corr_mma`
     launches (FlowFormer's float32 feature map gives a 2.31 GB volume,
     over the limit, so the AMT takes the float32 windowed route); fps,
     split, peak and FlowFormer alone beside the card's name and power
     limit; then the CUDA-core kernel on the captured inputs of one AMT
     lookup of that path against its plain version (<= 1e-5 max|plain|),
     timed by events and device against its bound at the float32 peak;
     (b) `gimmvfi_tpu_torch.bench.main` for `--model r` and `--model f` at
     736x1280 in this process, each printing one JSON line with its label;
     (c) GIMMVFI_F(ff_iters=2) float32 at 128x192, GPU vs CPU >= 50 dB, at
     the default limit and at `corr_max_volume_bytes=0` (exactly 2 x 3
     CUDA-core launches: only the AMT goes windowed).
Phase 2 prints ptxas's registers, spills and warnings for each source and
whether it serialised `wgmma.mma_async`. Phases 3 and 6 time each kernel
with CUDA events around each call (`ms`) and also read its own device time
from a `torch.profiler` trace (`device_ms`; for the probes' library calls
`library_device_ms`; the conv and cuDNN are traced in turns). Where the
profiler records no device activity, those readings are null and print as
"not measured"; the events' times, the checks and the counts stand. The launch
counts are set to 0 just before each path (5, the probes of 6, each path
of 8, 9 (a) and each GPU-vs-CPU run) and read just after it. The line before the last is the kernels' JSON record; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from gimmvfi_tpu_torch import bench
from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R, interpolate_sequential
from gimmvfi_tpu_torch.nn.layers import init_normal_
from gimmvfi_tpu_torch.ops import corr as corr_ops
from gimmvfi_tpu_torch.ops.corr import (
    WINDOWED_CORR_KERNEL,
    WINDOWED_CORR_MMA_KERNEL,
    WindowedCorr,
    windowed_corr_lookup_plain,
)
from gimmvfi_tpu_torch.ops import softsplat as softsplat_ops
from gimmvfi_tpu_torch.ops.softsplat import SPLAT_KERNEL, splat_sum_plain
from gimmvfi_tpu_torch.tools import conv_proto, gather_cost_probe
from gimmvfi_tpu_torch.tools.conv_proto import CONV3X3_KERNEL, conv3x3_plain
from gimmvfi_tpu_torch.tools.gather_cost_probe import GATHERS
from gimmvfi_tpu_torch.tools.windowed_ablate import (
    AMT_2K,
    MMA_CASES,
    PATH_KINDS,
    RAFT_2K,
    RAFT_720P,
    WINDOWED_CASES,
    extent_summary,
    fmt_extent,
    mma_tile_extents,
    windowed_agreement,
    windowed_inputs,
)
from gimmvfi_tpu_torch.tools.splat_ablate import (
    CHECK_CASES,
    MAIN_SHAPE,
    kernel_bound_ok,
    splat_bound,
    splat_inputs,
)
from gimmvfi_tpu_torch.utils.kernel_build import build_libraries, find_nvcc, library_path
from gimmvfi_tpu_torch.utils.timing import (
    H100_F32_FLOPS,
    bound_ms,
    cuda_ms,
    device_ms,
    fmt_ms,
    fmt_share,
    kernel_row,
    launch_floor_ms,
)

H, W = 736, 1280
N_T = 7
SEED = 0
PROBE_KERNELS = [CONV3X3_KERNEL] + [g[0] for g in GATHERS.values()]
KERNELS = [SPLAT_KERNEL, WINDOWED_CORR_MMA_KERNEL, WINDOWED_CORR_KERNEL] + PROBE_KERNELS
# (x shape, Cout): the probe shape, then ragged rows, tiles and channel chunks;
# then one pixel, W one over a 128-pixel tile multiple, and Cin off the
# 64-channel chunk with Cout under a 256-channel tile (the TMA zero fill)
CONV_CASES = [((1, H, W, 256), 256), ((1, 17, 23, 256), 256), ((2, 33, 40, 64), 64),
              ((1, 5, 130, 48), 80), ((1, 1, 1, 16), 16), ((2, 9, 257, 64), 256),
              ((1, 7, 200, 80), 96)]


def check_card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this check needs a CUDA card")
    smi = ", ".join(bench.card_info())
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
    name = Path(WINDOWED_CORR_MMA_KERNEL.source).name
    sass = subprocess.run([str(Path(find_nvcc()).with_name("cuobjdump")), "-sass",
                           str(library_path(name))], capture_output=True, text=True, check=True)
    hmma = sum("HMMA" in ln for ln in sass.stdout.splitlines())
    print(f"[2] {name}: {hmma} HMMA instructions in its SASS (cuobjdump -sass)", flush=True)
    if not hmma:
        raise AssertionError(f"{name} holds no tensor-core instruction")


def splat_reading(vals, flow, label: str) -> dict:
    """Events time, device time (the kernel alone and the call with its zero
    fill) and plain time of the splat on these inputs, printed against the
    bound."""
    ms = cuda_ms(lambda: SPLAT_KERNEL(vals, flow), warmup=3)
    plain_ms = cuda_ms(lambda: splat_sum_plain(vals, flow), warmup=3)
    dev_ms, by_name = device_ms(lambda: SPLAT_KERNEL(vals, flow))
    own = kernel_row(by_name, "splat_sum_kernel")
    bound, bound_by = splat_bound(vals)
    print(f"{label}: kernel {ms:.4f} ms by events ({fmt_share(bound, ms)}), device "
          f"{fmt_ms(own)} ({fmt_share(bound, own)}), call with zero fill "
          f"{fmt_ms(dev_ms)}; plain {plain_ms:.4f} ms; bound {bound:.4f} ms ({bound_by}) "
          f"[{'; '.join(f'{k[:60]} {v:.4f}' for k, v in by_name.items())}]", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "kernel_device_ms": own, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by}


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


def check_small_e2e(phase=4, hw=(128, 192), ds_factor=None,
                    limit=corr_ops.MAX_VOLUME_BYTES, family=GIMMVFI_R) -> tuple[float, int]:
    """GPU vs CPU float32 on one small pair, same seeded weights, of
    `family` with 2 flow iterations; the card's windowed lookups are
    float32, so they go to the CUDA-core kernel. Returns (PSNR, that
    kernel's launches, counted from 0)."""
    rng = np.random.default_rng(SEED)
    img = torch.from_numpy(rng.random((1, 2, *hw, 3), dtype=np.float32))
    ts = [0.25, 0.5, 0.75]
    cpu_model = init_normal_(family(2, device="cpu", corr_max_volume_bytes=limit), SEED)
    # the card, same seeded weights
    gpu_model = init_normal_(family(2, corr_max_volume_bytes=limit), SEED)
    ref = interpolate_sequential(cpu_model, img, ts, ds_factor)["imgt_pred"]
    # the host frames go in as they are: prepare moves them to the card
    reset_counts()
    got = interpolate_sequential(gpu_model, img, ts, ds_factor)["imgt_pred"].cpu()
    windowed, mma = WINDOWED_CORR_KERNEL.launches, WINDOWED_CORR_MMA_KERNEL.launches
    if got.shape != (len(ts), 1, *hw, 3):
        raise AssertionError(f"imgt_pred shape {tuple(got.shape)}")
    # RAFT's 2 lookups (FlowFormer's own volume is always materialized),
    # then the AMT's two a timestep
    flow_lookups = 2 if family is GIMMVFI_R else 0
    if windowed != (flow_lookups + 2 * len(ts) if limit == 0 else 0) or mma:
        raise AssertionError(f"{windowed} windowed-correlation launches, {mma} of the mma kernel")
    db = psnr(got, ref)
    print(f"[{phase}] {family.__name__}(2) f32 {hw[0]}x{hw[1]}, ds_factor={ds_factor}, "
          f"corr_max_volume_bytes={limit}, t={ts}: GPU vs CPU PSNR {db:.2f} dB "
          f"({windowed} windowed-correlation launches on the card)", flush=True)
    if not db >= 50.0:
        raise AssertionError(f"GPU and CPU disagree: {db:.2f} dB < 50 dB")
    return db, windowed


def drive_path(model, img_xs, ts, ds_factor, windowed_expected: int, label: str,
               cuda_core_expected: int = 0):
    """One main path through `interpolate_sequential`: a warm-up, then the
    timed run with every count set to 0 just before it and read just after;
    checks the shapes, finiteness, range and launch counts (14 splats,
    `windowed_expected` of the tensor-core lookup, `cuda_core_expected` of
    the CUDA-core one); then the stage split on the same inputs, CUDA events
    around `prepare` and each `decode_one`. Returns (numbers, the split
    run's prepare output)."""
    _, _, h, w, _ = img_xs.shape
    scale = ds_factor or 1
    interpolate_sequential(model, img_xs, ts, ds_factor)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    reset_counts()
    start.record()
    out = interpolate_sequential(model, img_xs, ts, ds_factor)
    end.record()
    end.synchronize()
    splats, wins = SPLAT_KERNEL.launches, WINDOWED_CORR_MMA_KERNEL.launches
    cuda_core = WINDOWED_CORR_KERNEL.launches
    total_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()

    imgs, flows = out["imgt_pred"], out["flowt"]
    if tuple(imgs.shape) != (len(ts), 1, h, w, 3):
        raise AssertionError(f"{label}: imgt_pred shape {tuple(imgs.shape)}")
    if tuple(flows.shape) != (len(ts), 1, int(h * scale), int(w * scale), 2):
        raise AssertionError(f"{label}: flowt shape {tuple(flows.shape)}")
    if not (bool(torch.isfinite(imgs).all()) and bool(torch.isfinite(flows).all())):
        raise AssertionError(f"{label}: non-finite outputs")
    lo, hi = float(imgs.min()), float(imgs.max())
    if not (lo >= 0.0 and hi <= 1.0):
        raise AssertionError(f"{label}: imgt_pred leaves [0, 1]")
    if splats != 2 * len(ts) or wins != windowed_expected or cuda_core != cuda_core_expected:
        raise AssertionError(f"{label}: {splats} splat, {wins} windowed_corr_mma and {cuda_core} "
                             f"windowed_corr launches, expected {2 * len(ts)}, "
                             f"{windowed_expected} and {cuda_core_expected}")
    del out, imgs, flows

    events = [torch.cuda.Event(enable_timing=True) for _ in range(len(ts) + 2)]
    with torch.inference_mode():
        events[0].record()
        prep = model.prepare(img_xs, ds_factor)
        events[1].record()
        for i, tv in enumerate(ts):
            model.decode_one(prep, tv)
            events[i + 2].record()
    torch.cuda.synchronize()
    decode_ms = [events[i + 1].elapsed_time(events[i + 2]) for i in range(len(ts))]
    return {"fps": len(ts) / (total_ms / 1000), "pair_ms": total_ms,
            "prepare_ms": events[0].elapsed_time(events[1]),
            "decode_ms": statistics.mean(decode_ms), "peak_bytes": peak,
            "splat_launches": splats, "windowed_launches": wins,
            "cuda_core_launches": cuda_core, "range": (lo, hi)}, prep


def path_lines(phase: int, res: dict) -> str:
    return (f"imgt_pred finite in [{res['range'][0]:.4f}, {res['range'][1]:.4f}]; splat launches "
            f"{res['splat_launches']}, windowed_corr_mma launches {res['windowed_launches']}, "
            f"windowed_corr launches {res['cuda_core_launches']}\n"
            f"[{phase}] {res['fps']:.4f} fps ({res['pair_ms']:.2f} ms per pair); prepare "
            f"{res['prepare_ms']:.2f} ms; decode_one mean {res['decode_ms']:.2f} ms; peak "
            f"allocated {res['peak_bytes']} B ({res['peak_bytes'] / 2**20:.1f} MiB)")


def run_main_path() -> tuple[int, dict]:
    model = init_normal_(GIMMVFI_R(raft_iters=20, dtype=torch.bfloat16), SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    # loading the frames is set-up: they are on the card before the clock starts
    img_xs = torch.rand((1, 2, H, W, 3), generator=gen).cuda()
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    # the 720p volumes (1.16 GB) fit under the limit: no windowed lookup
    res, prep = drive_path(model, img_xs, ts, None, 0, "720p")

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
    row = kernel_row(by_name, "splat_sum_kernel")
    in_situ = None if row is None else row / 2
    readings = [splat_reading(vals, flow, f"[5] splat on the main path's input {k} "
                                          f"{tuple(vals.shape)} at t={ts[N_T // 2]}")
                for k, (vals, flow) in enumerate(recorder.inputs)]
    if len(readings) != 2 or any(tuple(v.shape) != MAIN_SHAPE for v, _ in recorder.inputs):
        raise AssertionError(f"decode_one gave the splat {[tuple(v.shape) for v, _ in recorder.inputs]}")
    splat = {"main_path_in_situ_device_ms": in_situ}
    for key in ("ms", "kernel_device_ms", "plain_ms"):
        values = [r[key] for r in readings]
        splat[f"main_path_{key}"] = None if None in values else statistics.mean(values)
    print(f"[5] splat inside decode_one: device {fmt_ms(in_situ)} a launch "
          f"({fmt_share(readings[0]['bound_ms'], in_situ)})", flush=True)
    print(f"[5] main path bf16 {H}x{W} 8x: {path_lines(5, res)}", flush=True)
    return res["splat_launches"], splat


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


def windowed_agrees(label: str, wc, coords, radius: int = 4) -> float:
    """The routed kernel (`windowed_corr_kernel_for` the features' dtype)
    against the plain version on these inputs, by `windowed_agreement`'s
    tolerance; checks that the routed kernel launched once; prints the line
    and raises on disagreement. Returns the max-abs error."""
    kernel = corr_ops.windowed_corr_kernel_for(wc.f1.dtype)
    before = kernel.launches
    got = corr_ops.windowed_corr_lookup(wc, coords, radius)
    ref = windowed_corr_lookup_plain(wc, coords, radius)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        raise AssertionError(f"{label}: the lookup did not launch {kernel.name}")
    agree = windowed_agreement(got, ref)
    print(f"{label} ({kernel.name}): max_abs_err {agree['max_abs_err']:.3e}, max|plain| "
          f"{agree['scale']:.3e}, NaN {agree['nan']}, {agree['bad']} over the bound, agrees "
          f"{agree['ok']}", flush=True)
    if not agree["ok"]:
        raise AssertionError(f"windowed kernel disagrees with its plain version: {label}")
    return agree["max_abs_err"]


# (record key prefix, wrapper, the kernel's row in a trace)
WINDOWED_TIMED = [("mma", WINDOWED_CORR_MMA_KERNEL, "windowed_corr_mma_kernel"),
                  ("cuda_core", WINDOWED_CORR_KERNEL, "windowed_corr_kernel")]


def windowed_reading(wc, coords, label: str, levels_mat=None) -> dict:
    """Both windowed kernels on the same bf16 inputs, in the same run: events
    and device time of each against the bound; the tile walk's extents; with
    `levels_mat` (a materialized pyramid of the same maps), that lookup's
    times beside them."""
    nbytes, flops = corr_ops.windowed_corr_work(wc, coords)
    bound, bound_by = bound_ms(nbytes, flops)
    ext = extent_summary(mma_tile_extents(wc, coords), wc.f1.shape[-1])
    out = {"bound_ms": bound, "bound_by": bound_by, "bytes": nbytes, "flops": flops, **ext}
    parts = []
    for key, kernel, row in WINDOWED_TIMED:
        call = lambda k=kernel: k(wc, coords)  # noqa: E731
        ms = cuda_ms(call, warmup=3)
        _, by_name = device_ms(call)
        own = kernel_row(by_name, row)
        out[f"{key}_ms"], out[f"{key}_device_ms"] = ms, own
        parts.append(f"{kernel.name} {ms:.4f} ms by events ({fmt_share(bound, ms)}), device "
                     f"{fmt_ms(own)} ({fmt_share(bound, own)})")
    text = (f"{label} {tuple(coords.shape)} C={wc.f1.shape[-1]} bf16: {'; '.join(parts)}; bound "
            f"{bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
            f"tile walk: {fmt_extent(ext)}")
    if levels_mat is not None:
        mat = lambda: corr_ops.corr_lookup(levels_mat, coords)  # noqa: E731
        out["materialized_ms"] = cuda_ms(mat, warmup=3)
        out["materialized_device_ms"], _ = device_ms(mat)
        text += (f"; materialized corr_lookup (grid_sample over the bf16 volume) "
                 f"{out['materialized_ms']:.4f} ms by events, "
                 f"device {fmt_ms(out['materialized_device_ms'])}")
    print(text, flush=True)
    return out


def check_windowed() -> dict:
    """Phase 7: the routed windowed kernels against the plain version in the
    check cases (float32 on the CUDA-core kernel, bf16 on the tensor-core
    one) and at the 2K DS 1.0 path's two lookup shapes on in-frame and
    smooth coordinates; the float32 lookup against the materialized one;
    then both kernels' times in bf16."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for i, (c, dtype, kind, radius, levels, shape) in enumerate(WINDOWED_CASES + MMA_CASES):
        wc, coords, _ = windowed_inputs(shape, c, dtype, kind, levels, seed=SEED + i)
        err = windowed_agrees(f"[7] windowed {shape} C={c} {str(dtype)[6:]} r={radius} "
                              f"L={levels} {kind}", wc, coords, radius)
        worst[dtype] = max(worst[dtype], err)

    # the shapes the 2K DS 1.0 path gives it: RAFT's (both directions) and
    # the AMT's (one direction)
    path_err = 0.0
    for label, shape in (("RAFT", RAFT_2K), ("AMT", AMT_2K)):
        for kind in PATH_KINDS:
            wc, coords, _ = windowed_inputs(shape, 256, torch.bfloat16, kind, seed=SEED)
            path_err = max(path_err, windowed_agrees(
                f"[7] windowed at the 2048x1088 DS 1.0 {label} lookup {shape} C=256 bf16 r=4 L=4 "
                f"{kind}", wc, coords))
            del wc, coords
            torch.cuda.empty_cache()

    # the identity the windowed path rests on, at the 720p fmap
    wc, coords, (f1, f2) = windowed_inputs((1, 92, 160), 256, torch.float32, "in_frame")
    got = corr_ops.windowed_corr_lookup(wc, coords)
    ref = corr_ops.corr_lookup(corr_ops.corr_pyramid(f1, f2), coords)
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"[7] windowed_corr vs materialized corr_lookup (1, 92, 160) C=256 f32: "
          f"max_abs_err {err:.3e}, max|materialized| {scale:.3e}", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError("windowed and materialized lookups disagree at 720p")
    del wc, coords, f1, f2, got, ref
    torch.cuda.empty_cache()

    stats = {"path_err": path_err, "max_abs_err_cases_f32": worst[torch.float32],
             "max_abs_err_cases_bf16": worst[torch.bfloat16],
             "tolerance": "bf16 2**-7 |plain| + 1e-6 max|plain|; f32 1e-5 max|plain|"}
    for kind in PATH_KINDS:
        wc, coords, _ = windowed_inputs(RAFT_2K, 256, torch.bfloat16, kind)
        stats[kind] = windowed_reading(
            wc, coords, f"[7] at the 2048x1088 DS 1.0 RAFT lookup, {kind} coordinates")
        if kind == "in_frame":
            stats["plain_ms"] = cuda_ms(lambda: windowed_corr_lookup_plain(wc, coords), iters=3)
            print(f"[7] plain windowed_corr_lookup_plain there: {stats['plain_ms']:.4f} ms",
                  flush=True)
        del wc, coords
        torch.cuda.empty_cache()
    wc, coords, (f1, f2) = windowed_inputs(RAFT_720P, 256, torch.bfloat16, "in_frame")
    n = RAFT_720P[0] // 2
    fwd, bwd = corr_ops.bidir_corr_pyramid(f1[:n], f2[:n])
    levels = tuple(torch.cat([a, b], dim=0) for a, b in zip(fwd, bwd))
    stats["p720"] = windowed_reading(wc, coords, "[7] at the 720p RAFT lookup, in_frame "
                                     "coordinates", levels)
    del wc, coords, f1, f2, fwd, bwd, levels
    torch.cuda.empty_cache()
    return stats


class LookupRecorder:
    """Stands in for a windowed kernel in `ops.corr` and keeps a copy of the
    inputs of the calls numbered in `keep` (from 0)."""

    def __init__(self, keep, kernel=WINDOWED_CORR_MMA_KERNEL):
        self.keep, self.kernel, self.calls, self.inputs = set(keep), kernel, 0, {}

    def __call__(self, wc, coords, radius=4):
        if self.calls in self.keep:
            self.inputs[self.calls] = (WindowedCorr(wc.f1.clone(), tuple(x.clone() for x in wc.f2_levels),
                                                    wc.shape_hw), coords.clone(), radius)
        self.calls += 1
        return self.kernel(wc, coords, radius)


def path_lookup_readings(model, img_xs, ds) -> dict:
    """The tensor-core kernel where the 2K DS 1.0 path runs it: the inputs
    of the first and the last RAFT lookup of one `prepare`, captured, each
    checked against the plain version and timed beside the CUDA-core
    kernel."""
    iters = model.flow_estimator.iters
    recorder = LookupRecorder([0, iters - 1])
    corr_ops.WINDOWED_CORR_MMA_KERNEL = recorder
    try:
        with torch.inference_mode():
            prep = model.prepare(img_xs, ds)
    finally:
        corr_ops.WINDOWED_CORR_MMA_KERNEL = WINDOWED_CORR_MMA_KERNEL
    del prep
    if recorder.calls != iters or len(recorder.inputs) != 2:
        raise AssertionError(f"prepare made {recorder.calls} windowed lookups, expected {iters}")
    out = {}
    for call, name in ((0, "first"), (iters - 1, "last")):
        wc, coords, radius = recorder.inputs[call]
        label = f"[7] the 2048x1088 DS 1.0 path's {name} RAFT lookup (captured in phase 8 (c))"
        err = windowed_agrees(label, wc, coords, radius)
        out[name] = {**windowed_reading(wc, coords, label), "max_abs_err": err}
    torch.cuda.empty_cache()
    return out


# (label, (H, W), ds_factor, the reference's V100 envelope in MiB or None)
DS_PATHS = [
    ("a", (1088, 2048), 0.5, 7932),
    ("b", (2176, 4096), 0.25, 10922),
    ("c", (1088, 2048), 1.0, None),
]


def run_ds_paths() -> dict:
    """Phase 8: the 2K/4K main paths, then GPU vs CPU at two small points."""
    model = init_normal_(GIMMVFI_R(raft_iters=20, dtype=torch.bfloat16), SEED)
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    results = {}
    for label, (h, w), ds, envelope in DS_PATHS:
        gen = torch.Generator(device="cpu").manual_seed(SEED + 2)
        img_xs = torch.rand((1, 2, h, w, 3), generator=gen).cuda()
        # counted from the code, by each volume's bf16 size against the
        # limit: one lookup each RAFT iteration (both directions batched),
        # two a timestep in the AMT (one a direction)
        fmap = (int(h * ds) // 8) * (int(w * ds) // 8)
        limit = model.corr_max_volume_bytes
        raft_windowed = 2 * (fmap * fmap * 2 * 4 // 3) > limit
        amt_windowed = 2 * fmap * fmap * 2 * 4 // 3 > limit
        expect = model.flow_estimator.iters * raft_windowed + 2 * N_T * amt_windowed
        res, prep = drive_path(model, img_xs, ts, ds, expect, f"({label})")
        del prep
        mib = res["peak_bytes"] / 2**20
        env = (f" (the reference's V100 envelope {envelope} MiB: {100 * mib / envelope:.1f}%)"
               if envelope else "")
        print(f"[8] ({label}) {w}x{h} DS {ds} bf16 8x, working {int(w * ds)}x{int(h * ds)}, "
              f"{'windowed' if expect else 'materialized'} correlation: "
              f"{path_lines(8, res)}{env}", flush=True)
        results[label] = res
        torch.cuda.empty_cache()
        if raft_windowed:
            results["lookups"] = path_lookup_readings(model, img_xs, ds)
        del img_xs
    del model
    torch.cuda.empty_cache()
    results["db_windowed"], results["f32_windowed_launches"] = check_small_e2e(8, (128, 192), None, 0)
    results["db_ds"], _ = check_small_e2e(8, (256, 384), 0.5)
    return results


def cuda_core_reading(wc, coords, label: str) -> dict:
    """The CUDA-core kernel on these float32 inputs: events and device time
    against the bound (float32 operations over the CUDA-core peak) and the
    plain version's time."""
    nbytes, flops = corr_ops.windowed_corr_work(wc, coords)
    bound, bound_by = bound_ms(nbytes, flops, H100_F32_FLOPS)
    call = lambda: WINDOWED_CORR_KERNEL(wc, coords)  # noqa: E731
    ms = cuda_ms(call, warmup=3)
    _, by_name = device_ms(call)
    own = kernel_row(by_name, "windowed_corr_kernel")
    plain_ms = cuda_ms(lambda: windowed_corr_lookup_plain(wc, coords), iters=3)
    print(f"{label} {tuple(coords.shape)} C={wc.f1.shape[-1]} f32: {WINDOWED_CORR_KERNEL.name} "
          f"{ms:.4f} ms by events ({fmt_share(bound, ms)}), device {fmt_ms(own)} "
          f"({fmt_share(bound, own)}); plain {plain_ms:.4f} ms; bound {bound:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP at the float32 CUDA-core peak)",
          flush=True)
    return {"ms": ms, "device_ms": own, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "bytes": nbytes, "flops": flops}


def run_f_path(smi: str) -> dict:
    """Phase 9 (a): GIMMVFI_F(ff_iters=32, bf16) at 720p, 7 timesteps. The
    float32 feature map's bidirectional volume (2.31 GB) is over the limit,
    so the AMT looks up the float32 windowed state: 14 CUDA-core launches a
    pair. Then the flow estimator alone, and the CUDA-core kernel on the
    inputs of the first AMT lookup of one `decode_one`, captured, against
    its plain version and timed."""
    model = init_normal_(GIMMVFI_F(ff_iters=32, dtype=torch.bfloat16), SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    img_xs = torch.rand((1, 2, H, W, 3), generator=gen).cuda()
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    res, prep = drive_path(model, img_xs, ts, None, 0, "F 720p", cuda_core_expected=2 * N_T)
    img0, img1 = 255.0 * prep["img0"], 255.0 * prep["img1"]
    with torch.inference_mode():
        res["flow_ms"] = cuda_ms(lambda: model.bidir_flow(img0, img1), iters=3)
        recorder = LookupRecorder([0], WINDOWED_CORR_KERNEL)
        corr_ops.WINDOWED_CORR_KERNEL = recorder
        try:
            model.decode_one(prep, ts[N_T // 2])
        finally:
            corr_ops.WINDOWED_CORR_KERNEL = WINDOWED_CORR_KERNEL
    print(f"[9] (a) GIMMVFI_F(ff_iters=32) bf16 {H}x{W} 8x, float32 windowed AMT correlation: "
          f"{path_lines(9, res)}; FlowFormer alone (both directions) {res['flow_ms']:.2f} ms; "
          f"{smi}", flush=True)
    if recorder.calls != 2:
        raise AssertionError(f"decode_one made {recorder.calls} float32 windowed lookups, expected 2")
    del model, prep, img0, img1, img_xs
    torch.cuda.empty_cache()
    wc, coords, radius = recorder.inputs[0]
    label = "[9] (a) windowed_corr on the F path's first AMT lookup (captured)"
    res["lookup_max_abs_err"] = windowed_agrees(label, wc, coords, radius)
    res["lookup"] = cuda_core_reading(wc, coords, label)
    return res


def run_bench_entries() -> dict:
    """Phase 9 (b): `gimmvfi_tpu_torch.bench.main` for R and F at 720p, in
    this process; each must print one JSON line, last, with its label."""
    records = {}
    for family in ("r", "f"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            record = bench.main(["--model", family])
        lines = out.getvalue().strip().splitlines()
        for line in lines:
            print(f"[9] (b) bench --model {family}: {line}", flush=True)
        label = bench.metric_label(family, "736x1280", None)
        if (json.loads(lines[-1]) != record or record["metric"] != label
                or sum(line.startswith("{") for line in lines) != 1):
            raise AssertionError(f"bench --model {family} printed no single {label} line")
        records[family] = record
        torch.cuda.empty_cache()
    return records


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
    floor = launch_floor_ms()
    print(f"[6] launch floor: an empty kernel of one warp, device {fmt_ms(floor, 6)}", flush=True)
    for name, g in gathers.items():
        g["floor_ms"] = floor
        g["floor_bound_ms"] = None if floor is None else max(floor, g["bound_ms"])
        dev = g["device_ms"]
        share = ("not measured" if g["floor_bound_ms"] is None
                 else fmt_share(g["floor_bound_ms"], dev))
        print(f"[6] {name}: device {fmt_ms(dev, 6)}; against max(launch floor, bound) "
              f"{fmt_ms(g['floor_bound_ms'], 6)}: {share}", flush=True)
    print(f"[6] conv3x3 (1,{H},{W},256): kernel {conv['kernel_ms']:.4f} ms "
          f"({100 * conv['bound_ms'] / conv['kernel_ms']:.1f}% of its {conv['bound_ms']:.4f} ms "
          f"bound; device time {fmt_ms(conv['kernel_device_ms'])}), cuDNN NCHW "
          f"{conv['cudnn_nchw_ms']:.4f} ms, cuDNN channels-last {conv['cudnn_channels_last_ms']:.4f} "
          f"ms (device time {fmt_ms(conv['cudnn_channels_last_device_ms'])}), plain "
          f"{conv['plain_ms']:.4f} ms; {smi}",
          flush=True)
    torch.cuda.empty_cache()
    wstats = check_windowed()
    ds = run_ds_paths()
    f720 = run_f_path(smi)
    benches = run_bench_entries()
    f_db = {label: check_small_e2e(9, (128, 192), None, limit, family=GIMMVFI_F)
            for label, limit in (("materialized", corr_ops.MAX_VOLUME_BYTES), ("windowed", 0))}

    def record(kernel, launches, **numbers):
        return {"name": kernel.name, "route": "cuda", "source": kernel.source,
                "replaces": kernel.replaces, "launches": launches, **numbers}

    def windowed_numbers(key):
        """One windowed kernel's times from phase 7 (and the path's lookups)."""
        main, lk = wstats["in_frame"], ds["lookups"]
        out = {"ms": main[f"{key}_ms"], "device_ms": main[f"{key}_device_ms"],
               "plain_ms": wstats["plain_ms"], "bound_ms": main["bound_ms"],
               "bound_by": main["bound_by"], "library_ms": None}
        for label, reading in (("smooth", wstats["smooth"]), ("p720", wstats["p720"]),
                               ("path_first", lk["first"]), ("path_last", lk["last"])):
            out.update({f"{label}_{k}": reading[f"{key}_{k}"] for k in ("ms", "device_ms")})
            out[f"{label}_bound_ms"] = reading["bound_ms"]
        out["p720_materialized_ms"] = wstats["p720"]["materialized_ms"]
        out["p720_materialized_device_ms"] = wstats["p720"]["materialized_device_ms"]
        return out

    records = [
        record(SPLAT_KERNEL, splat_launches, **kstats, **main_splat),
        record(WINDOWED_CORR_MMA_KERNEL, ds["c"]["windowed_launches"],
               max_abs_err=max(wstats["path_err"], ds["lookups"]["first"]["max_abs_err"],
                               ds["lookups"]["last"]["max_abs_err"]),
               max_abs_err_cases_bf16=wstats["max_abs_err_cases_bf16"],
               tolerance=wstats["tolerance"], **windowed_numbers("mma"),
               extent_in_frame=fmt_extent(wstats["in_frame"]),
               extent_smooth=fmt_extent(wstats["smooth"]),
               extent_path_first=fmt_extent(ds["lookups"]["first"])),
        # the float32 route, on the 720p F path: its launches there and its
        # times on that path's captured AMT lookup; the bf16_* times are the
        # tensor-core kernel's "before" at the 2K DS 1.0 lookups
        record(WINDOWED_CORR_KERNEL, f720["cuda_core_launches"],
               launches_f720=f720["cuda_core_launches"],
               launches_f32_gpu_vs_cpu={"r": ds["f32_windowed_launches"],
                                        "f": f_db["windowed"][1]},
               max_abs_err=f720["lookup_max_abs_err"],
               max_abs_err_cases_f32=wstats["max_abs_err_cases_f32"],
               tolerance=wstats["tolerance"], times_dtype="float32",
               **{k: f720["lookup"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                 "bound_by")},
               library_ms=None,
               **{f"bf16_{k}": v for k, v in windowed_numbers("cuda_core").items()
                  if k != "library_ms"}),
        record(CONV3X3_KERNEL, launches[CONV3X3_KERNEL.name], max_abs_err=conv_err,
               ms=conv["kernel_ms"], device_ms=conv["kernel_device_ms"],
               plain_ms=conv["plain_ms"], bound_ms=conv["bound_ms"], bound_by=conv["bound_by"],
               library_ms=conv["cudnn_channels_last_ms"],
               library_device_ms=conv["cudnn_channels_last_device_ms"]),
    ] + [
        record(GATHERS[name][0], launches[name], max_abs_err=gather_err[name], **gathers[name])
        for name in GATHERS
    ]
    print(f"[9] F path: {f720['fps']:.4f} fps at 720p; bench lines "
          f"{json.dumps(benches)}; GPU vs CPU F {f_db['materialized'][0]:.2f} dB materialized, "
          f"{f_db['windowed'][0]:.2f} dB windowed", flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
