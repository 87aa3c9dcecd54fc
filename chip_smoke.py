#!/usr/bin/env python3
"""Drive the PyTorch port's GIMM-VFI-R 8x paths (720p, and 2K/4K through
DS_SCALE and the windowed correlation), its GIMM-VFI-F 8x path at 720p,
its bench entry, its two probe entry points, its serving entry points
(stage-1 GIMM, the video CLI, the four benchmark harnesses) and stage-1
GIMM training (the recipe's step and the train CLI) once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is skipped):
  1. the card: CUDA must be present; prints nvidia-smi's name and power limit;
  2. builds the CUDA sources of gimmvfi_tpu_torch/csrc/ (softsplat.cu,
     softsplat_bwd.cu, windowed_corr_mma.cu, windowed_corr_tf32.cu, windowed_corr.cu,
     conv3x3.cu, gather_probe.cu) all at once, one nvcc each; counts the
     HMMA (tensor-core) instructions in the SASS of windowed_corr_mma and
     windowed_corr_tf32 (`cuobjdump -sass`) and fails on none; prints the
     shared memory a block and the blocks an SM of windowed_corr_tf32 at
     C = 256, from its library;
  3. the splat kernel against its plain PyTorch version on the card, float32,
     in every case of `tools/splat_ablate.py: CHECK_CASES` (the main path's
     (1,736,1280,17) on a random, a smooth and a non-finite/far flow field;
     C in {1, 3, 5, 17, 33, 64}; N = 2; value counts off a multiple of 4);
     times it at 720p on the random and the smooth field, beside its
     PyTorch yardstick (`aten.grid_sampler_2d_backward`'s input gradient
     on NCHW views, `tools/splat_ablate.py: library_calls`), held to the
     plain version first (1e-4 x max(1, max|plain|));
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
     indices, subgather also on three ragged tables; then the two probe entry points, `conv_proto.main` (kernel,
     cuDNN NCHW, cuDNN channels-last, plain, bound) and
     `gather_cost_probe.main` (torch.gather / torch.sort table, kernels),
     each of whose kernels must launch; then the launch floor, the device
     time of an empty kernel, and each gather against max(floor, bound);
  7. the windowed lookup's kernels against the plain version on the card,
     each through the route (`ops/corr.py: windowed_corr_kernel_for`: bf16
     to the tensor-core `windowed_corr_mma.cu`, float32 to the 3xTF32
     tensor-core `windowed_corr_tf32.cu`; `tools/windowed_ablate.py:
     windowed_agreement`: float32 <= 1e-5 of the largest value, bf16 within
     one bf16 step, NaN at the same places), in `WINDOWED_CASES`,
     `MMA_CASES` and `TF32_CASES` (C = 256 and small C, C = 200, an odd
     level size, in-frame, smooth, border and far or non-finite
     coordinates, each float32 case also in bf16), at the shapes the
     2048x1088 DS 1.0 path gives it (RAFT's (2,136,256) and the AMT's
     (1,136,256), C = 256, bf16), the 720p F path's AMT shape (1,92,160)
     and the float32 720p R path's RAFT shape (2,92,160), both C = 256,
     float32, on in-frame and smooth coordinates; the
     float32 lookup against the materialized `corr_lookup` at the 720p
     fmap (92x160, C = 256, <= 1e-4); the CUDA-core `windowed_corr.cu`,
     called directly, on the float32 cases of `WINDOWED_CASES`; then the
     bf16 kernel and the CUDA-core one, each checked on the inputs first,
     timed in bf16 in the same run, against the bound, with
     the tile walk's union extent (`mma_tile_extents`): at the 2048x1088
     DS 1.0 RAFT lookup on in-frame and smooth coordinates, at 720p beside
     the materialized lookup, and (after phase 8 (c)) on the inputs of the
     first and last RAFT lookups of a `prepare` of that path, captured;
  8. three more main paths, each 8x bf16 with 7 timesteps and counts from 0:
     (a) 2048x1088 at DS 0.5, (b) 4096x2176 at DS 0.25, both materialized at
     1024x544, and (c) 2048x1088 at DS 1.0, windowed in RAFT and the AMT;
     checks shapes, finiteness, range, 14 splat launches and exactly 0, 0
     and 20 + 2 x 7 launches of the bf16 tensor-core windowed kernel, and
     none of the float32 or the CUDA-core one; prints fps, the
     prepare/decode_one split and peak memory (beside the reference's V100
     envelopes for (a) and (b)); then GPU vs CPU float32 >= 50 dB with the
     windowed path forced at 128x192 (float32 lookups: the 3xTF32 kernel,
     8 launches counted from 0) and with DS 0.5 at 256x384;
  9. GIMM-VFI-F: (a) GIMMVFI_F(ff_iters=32, dtype=bfloat16) on the seeded
     736x1280 pair, 7 timesteps, through `drive_path`: shape, finiteness,
     range, exactly 14 splat, 14 `windowed_corr_tf32`, 0 `windowed_corr`
     and 0 `windowed_corr_mma` launches (FlowFormer's float32 feature map
     gives a 2.31 GB volume, over the limit, so the AMT takes the float32
     windowed route); fps, split, peak and FlowFormer alone beside the
     card's name and power limit; then, on the captured inputs of one AMT
     lookup of that path, the routed 3xTF32 kernel and the CUDA-core
     kernel against the plain version (<= 1e-5 max|plain|) and the
     3xTF32 kernel against the materialized `corr_lookup` over a pyramid
     of the same maps (<= 1e-4 max); the two kernels and that materialized
     lookup timed in the same run by events and device time, each kernel
     against its own bound (the 3xTF32 kernel: its bytes, or three TF32
     products a float32 one at the TF32 tensor-core peak; the CUDA-core
     kernel: float32 operations at the CUDA-core peak);
     (b) `gimmvfi_tpu_torch.bench.main` for `--model r` and `--model f` at
     736x1280 in this process, each printing one JSON line with its label;
     (c) GIMMVFI_F(ff_iters=2) float32 at 128x192, GPU vs CPU >= 50 dB, at
     the default limit and at `corr_max_volume_bytes=0` (exactly 2 x 3
     3xTF32 launches: only the AMT goes windowed);
 10. the serving entry points, float32 (TF32 off), in build/chip_smoke_phase10/:
     (a) stage-1 GIMM at full width with seeded weights on seeded smooth
     flows at Vimeo's 256x448: one `forward` at t = 0.5 (exactly 2 splat
     launches) and one `forward_multi` over VSF's five timesteps (10), each
     by CUDA events after a warm-up, GPU vs CPU >= 50 dB on the normalized
     flow; (b) the video CLI, `cli.video_nx.main`, on three seeded 720x1280
     PPM frames, 8x, with a seeded GIMMVFI_R(raft_iters=20) saved as a
     reference checkpoint (`state_dict` wrapper, `module.` prefixes,
     `g_filter`, `num_batches_tracked`): 2 pairs, 17 frames written (mp4 or
     PPM), exactly 28 splat launches and 2 x 34 float32 windowed lookups
     (the 720p float32 volumes, 2 x 1.16 GB, are over the 2 GiB limit, so
     RAFT's 20 lookups and the AMT's 2 a timestep are windowed), none of
     the other two; ms a pair, the whole CLI's seconds and the peak; then,
     on a model loaded from the same checkpoint, `interpolate_pair` on the
     first pair against `interpolate_sequential` on inputs padded here
     (<= 1e-5 max-abs: two runs differ by the order of the splat's float
     atomics, up to 4.1e-6 measured), the CLI's frames of that pair against
     the latter's quantized (<= 1 level), and the inputs of the pair's
     first RAFT lookup (2,92,160) and first AMT lookup (1,92,160),
     captured, held against the plain version; (c)
     the four harnesses through `cli.benchmarks.main` on fabricated data:
     SNU-FILM-arb medium (one row of five 720x1280 frames) and X4K 2k (one
     scene of 33 4096x2160 frames, links to three: 7 items at DS 0.5), both
     with a seeded LPIPS checkpoint; VTF and VSF on seeded 256x448 `.flo`
     files with a seeded GIMM checkpoint; each JSON result finite, exact
     launch counts, each harness's seconds;
 11. stage-1 GIMM training, float32 (TF32 off), in build/chip_smoke_phase11/:
     (a) the splat's backward kernel (`csrc/softsplat_bwd.cu`) against
     `splat_sum_backward_plain` in `tools/splat_ablate.py: BWD_CASES` (the
     recipe step's (32, 256, 256, 17) on a random, a smooth and a
     non-finite/far field, the small `CHECK_CASES`, C = 130, 34 and 16,
     widths off its 32-column tile; d_vals and d_flow <= 1e-5 x max(1,
     max|plain|); d_vals without d_flow equal); two calls bitwise equal in
     both modes on the random and the non-finite field; both modes timed
     by events and device rows against each mode's bound, beside the plain
     version, the forward kernel at that shape and the PyTorch yardsticks
     (`F.grid_sample` for d_vals, `aten.grid_sampler_2d_backward`'s grid
     gradient for d_flow, the forward's too), each held to the plain
     version first;
     (b) the recipe's step (`configs/gimm/gimm.yaml`: GIMM, Adam lr 1e-4,
     batch 32, 256^2) on seeded smooth flows: one step counted from 0
     (exactly 2 forward and 2 backward splat launches, no windowed one), 10
     timed after 3 warm-ups (median ms, peak, finite loss, parameters
     moved), and the device time of one step and its splats in a trace;
     (c) one step at 64x64, batch 2, GPU vs CPU from the same seeded
     weights and batch, 3 seeds and 2 runs on the card each: loss <= 1e-5
     relative, each gradient <= 1e-4 x max|g_cpu|; the scalar `alpha_v`
     and `alpha_fe`, whose gradients are near-cancelling sums over pixels,
     <= 1e-4 x the sum of their terms' magnitudes, with the fields they
     contract held to 1e-4 x max (every reading printed); (d) `cli.train.main` with the recipe's config and
     `--smoke-test` on a fabricated tree of 256x448 `.flo` triplets: one
     epoch of 2 steps with validation and a checkpoint, then `--resume` for
     a second, exact launches, steps, seconds an epoch, the PyYAML version
     and whether tensorboardX was found.
Phase 2 prints ptxas's registers, spills and warnings for each source and
whether it serialised `wgmma.mma_async`. Phases 3 and 6 time each kernel
with CUDA events around each call (`ms`) and also read its own device time
from a `torch.profiler` trace (`device_ms`; for the probes' library calls
`library_device_ms`; the conv and cuDNN are traced in turns). Where the
profiler records no device activity, those readings are null and print as
"not measured"; the events' times, the checks and the counts stand. The launch
counts are set to 0 just before each path (5, the probes of 6, each path
of 8, 9 (a), each GPU-vs-CPU run, each path of 10 and the counted step
and each CLI call of 11) and read just after it; the splat's and the
3xTF32 kernel's records carry their phase 10 counts (`launches_phase10`),
the splat backward's `launches` are those of the counted recipe step. The line before the last is the kernels' JSON record; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from gimmvfi_tpu_torch import bench
from gimmvfi_tpu_torch.cli import benchmarks as bench_cli
from gimmvfi_tpu_torch.cli import video_nx
from gimmvfi_tpu_torch.data.frame_io import read_image, read_ppm, write_flo, write_ppm
from gimmvfi_tpu_torch.models import gimm as gimm_model
from gimmvfi_tpu_torch.models.gimm import GIMM
from gimmvfi_tpu_torch.models.gimmvfi_f import GIMMVFI_F
from gimmvfi_tpu_torch.models.gimmvfi_r import GIMMVFI_R, interpolate_sequential
from gimmvfi_tpu_torch.nn.layers import init_normal_
from gimmvfi_tpu_torch.ops import corr as corr_ops
from gimmvfi_tpu_torch.ops.corr import (
    WINDOWED_CORR_KERNEL,
    WINDOWED_CORR_MMA_KERNEL,
    WINDOWED_CORR_TF32_KERNEL,
    WindowedCorr,
    windowed_corr_lookup_plain,
)
from gimmvfi_tpu_torch.ops import softsplat as softsplat_ops
from gimmvfi_tpu_torch.ops.pad import InputPadder
from gimmvfi_tpu_torch.ops.softsplat import (
    SPLAT_BACKWARD_KERNEL,
    SPLAT_KERNEL,
    splat_sum_backward_plain,
    splat_sum_plain,
)
from gimmvfi_tpu_torch.tools import conv_proto, gather_ablate, gather_cost_probe
from gimmvfi_tpu_torch.tools.conv_proto import CONV3X3_KERNEL, conv3x3_plain
from gimmvfi_tpu_torch.tools.gather_cost_probe import GATHERS, SUBGATHER_KERNEL, subgather_plain
from gimmvfi_tpu_torch.tools.windowed_ablate import (
    AMT_2K,
    F_AMT_720P,
    MMA_CASES,
    PATH_KINDS,
    RAFT_2K,
    RAFT_720P,
    TF32_CASES,
    WINDOWED_CASES,
    extent_summary,
    f32_lookup_bounds,
    fmt_extent,
    mma_tile_extents,
    tf32_config,
    windowed_agreement,
    windowed_inputs,
)
from gimmvfi_tpu_torch.tools.splat_ablate import (
    BWD_CASES,
    CHECK_CASES,
    MAIN_SHAPE,
    TRAIN_SPLAT,
    TRAIN_STD,
    bwd_inputs,
    kernel_bound_ok,
    library_agreement,
    library_calls,
    splat_bound,
    splat_bwd_bound,
    splat_inputs,
)
from gimmvfi_tpu_torch.cli import train as train_cli
from gimmvfi_tpu_torch.train.lpips import LPIPS
from gimmvfi_tpu_torch.train.optim import create_optimizer
from gimmvfi_tpu_torch.train.train_state import create_train_state, make_gimm_train_step
from gimmvfi_tpu_torch.utils.config import load_config
from gimmvfi_tpu_torch.utils.kernel_build import CSRC, build_libraries, find_nvcc, library_path
from gimmvfi_tpu_torch.utils.timing import (
    H100_BYTES_PER_S,
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
KERNELS = [SPLAT_KERNEL, SPLAT_BACKWARD_KERNEL, WINDOWED_CORR_MMA_KERNEL,
           WINDOWED_CORR_TF32_KERNEL, WINDOWED_CORR_KERNEL] + PROBE_KERNELS
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
    for kernel in (WINDOWED_CORR_MMA_KERNEL, WINDOWED_CORR_TF32_KERNEL):
        name = Path(kernel.source).name
        sass = subprocess.run([str(Path(find_nvcc()).with_name("cuobjdump")), "-sass",
                               str(library_path(name))], capture_output=True, text=True, check=True)
        hmma = sum("HMMA" in ln for ln in sass.stdout.splitlines())
        print(f"[2] {name}: {hmma} HMMA instructions in its SASS (cuobjdump -sass)", flush=True)
        if not hmma:
            raise AssertionError(f"{name} holds no tensor-core instruction")
    name = Path(WINDOWED_CORR_TF32_KERNEL.source).name
    warps = tf32_config((CSRC / name).read_text())[0]
    lib = ctypes.CDLL(str(library_path(name)))
    print(f"[2] {name}: {lib.windowed_corr_tf32_smem_bytes(256)} B of shared memory a block, "
          f"{lib.windowed_corr_tf32_blocks_per_sm(256)} blocks of {warps} warps an SM at C=256",
          flush=True)


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


def yardstick_readings(vals, flow, g=None, label: str = "") -> dict:
    """The PyTorch calls that compute the splat's functions (`splat_ablate:
    library_calls`), first held to the plain version on these inputs
    (1e-4 x max(1, max|plain|): the normalized-coordinate round trip), then
    each timed by events and by its device rows (all of them: the call's
    kernels and fills). Returns {name: {"ms", "device_ms", "max_abs_err",
    "tolerance", "layout"}}; the port never calls them."""
    agree = library_agreement(vals, flow, g)
    res = {}
    for name, call in library_calls(vals, flow, g).items():
        err, tol, layout = agree[name]
        ms = cuda_ms(call, warmup=3)
        dev, rows = device_ms(call)
        res[name] = {"ms": ms, "device_ms": dev, "max_abs_err": err, "tolerance": tol,
                     "layout": f"inputs NCHW views of the channels-last tensors (no copy), "
                               f"{layout}"}
        print(f"{label} yardstick {name}: {ms:.4f} ms by events, device {fmt_ms(dev)} "
              f"[{'; '.join(f'{k[:50]} {v:.4f}' for k, v in rows.items())}]; max_abs_err "
              f"{err:.3e} against the plain version (tolerance {tol:.3e}); {res[name]['layout']}",
              flush=True)
    return res


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
        label = f"[3] splat {MAIN_SHAPE} {field} flow std 20"
        reading = splat_reading(vals, flow, label)
        lib = yardstick_readings(vals, flow, label=label)["forward"]
        reading.update(library_ms=lib["ms"], library_device_ms=lib["device_ms"])
        if field == "random":
            stats.update(reading, library_call="aten.grid_sampler_2d_backward, input gradient",
                         library_layout=lib["layout"], library_max_abs_err=lib["max_abs_err"],
                         library_tolerance=lib["tolerance"])
        else:
            stats.update({f"smooth_{k}": reading[k] for k in (
                "ms", "kernel_device_ms", "plain_ms", "library_ms", "library_device_ms")})
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
    float32, so they go to the 3xTF32 kernel. Returns (PSNR, that kernel's
    launches, counted from 0)."""
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
    windowed, mma = WINDOWED_CORR_TF32_KERNEL.launches, WINDOWED_CORR_MMA_KERNEL.launches
    cuda_core = WINDOWED_CORR_KERNEL.launches
    if got.shape != (len(ts), 1, *hw, 3):
        raise AssertionError(f"imgt_pred shape {tuple(got.shape)}")
    # RAFT's 2 lookups (FlowFormer's own volume is always materialized),
    # then the AMT's two a timestep
    flow_lookups = 2 if family is GIMMVFI_R else 0
    if windowed != (flow_lookups + 2 * len(ts) if limit == 0 else 0) or mma or cuda_core:
        raise AssertionError(f"{windowed} float32 windowed-correlation launches, {mma} of the "
                             f"bf16 kernel, {cuda_core} of the CUDA-core one")
    db = psnr(got, ref)
    print(f"[{phase}] {family.__name__}(2) f32 {hw[0]}x{hw[1]}, ds_factor={ds_factor}, "
          f"corr_max_volume_bytes={limit}, t={ts}: GPU vs CPU PSNR {db:.2f} dB "
          f"({windowed} windowed-correlation launches on the card)", flush=True)
    if not db >= 50.0:
        raise AssertionError(f"GPU and CPU disagree: {db:.2f} dB < 50 dB")
    return db, windowed


def drive_path(model, img_xs, ts, ds_factor, windowed_expected: int, label: str,
               tf32_expected: int = 0):
    """One main path through `interpolate_sequential`: a warm-up, then the
    timed run with every count set to 0 just before it and read just after;
    checks the shapes, finiteness, range and launch counts (14 splats,
    `windowed_expected` of the bf16 tensor-core lookup, `tf32_expected` of
    the float32 one, none of the CUDA-core one); then the stage split on the
    same inputs, CUDA events around `prepare` and each `decode_one`.
    Returns (numbers, the split run's prepare output)."""
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
    tf32, cuda_core = WINDOWED_CORR_TF32_KERNEL.launches, WINDOWED_CORR_KERNEL.launches
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
    if (splats != 2 * len(ts) or wins != windowed_expected or tf32 != tf32_expected
            or cuda_core != 0):
        raise AssertionError(f"{label}: {splats} splat, {wins} windowed_corr_mma, {tf32} "
                             f"windowed_corr_tf32 and {cuda_core} windowed_corr launches, expected "
                             f"{2 * len(ts)}, {windowed_expected}, {tf32_expected} and 0")
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
            "splat_launches": splats, "windowed_launches": wins, "tf32_launches": tf32,
            "cuda_core_launches": cuda_core, "range": (lo, hi)}, prep


def path_lines(phase: int, res: dict) -> str:
    return (f"imgt_pred finite in [{res['range'][0]:.4f}, {res['range'][1]:.4f}]; splat launches "
            f"{res['splat_launches']}, windowed_corr_mma launches {res['windowed_launches']}, "
            f"windowed_corr_tf32 launches {res['tf32_launches']}, "
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
    places (none for subgather_grid, whose `% 512` keeps every index in
    range); subgather first on the ragged tables of `gather_ablate.RAGGED`."""
    rng = np.random.default_rng(SEED)
    worst = {}
    for xn, idxn in gather_ablate.check_tables(SEED)[2:]:
        x, idx = torch.from_numpy(xn).cuda(), torch.from_numpy(idxn).cuda()
        got, ref = SUBGATHER_KERNEL(x, idx), subgather_plain(x, idx)
        torch.cuda.synchronize()
        nan = torch.isnan(ref)
        if not (torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], ref[~nan])):
            raise AssertionError(f"subgather kernel differs from its plain version at "
                                 f"{tuple(x.shape)}")
        print(f"[6] subgather {tuple(x.shape)} (ragged) indices in [-rows - 3, rows + 3): equal "
              f"True, NaN {int(nan.sum())}", flush=True)
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


def windowed_agrees(label: str, wc, coords, radius: int = 4, kernel=None) -> float:
    """The routed kernel (`windowed_corr_kernel_for` the features' dtype), or
    `kernel` called directly, against the plain version on these inputs, by
    `windowed_agreement`'s tolerance; checks that the kernel launched once;
    prints the line and raises on disagreement. Returns the max-abs error."""
    routed = kernel is None
    kernel = corr_ops.windowed_corr_kernel_for(wc.f1.dtype) if routed else kernel
    before = kernel.launches
    got = (corr_ops.windowed_corr_lookup(wc, coords, radius) if routed
           else kernel(wc, coords.float().contiguous(), radius))
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
    """Both windowed kernels on the same bf16 inputs, in the same run, each
    checked against the plain version first: events and device time of each
    against the bound; the tile walk's extents; with `levels_mat` (a
    materialized pyramid of the same maps), that lookup's times beside
    them."""
    nbytes, flops = corr_ops.windowed_corr_work(wc, coords)
    bound, bound_by = bound_ms(nbytes, flops)
    ext = extent_summary(mma_tile_extents(wc, coords), wc.f1.shape[-1])
    out = {"bound_ms": bound, "bound_by": bound_by, "bytes": nbytes, "flops": flops, **ext}
    parts = []
    for key, kernel, row in WINDOWED_TIMED:
        out[f"{key}_max_abs_err"] = windowed_agrees(f"{label}, {kernel.name} called directly",
                                                    wc, coords, kernel=kernel)
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
    check cases (float32 on the 3xTF32 kernel, bf16 on the bf16 tensor-core
    one), at the 2K DS 1.0 path's two lookup shapes, the 720p F path's
    AMT shape and the float32 720p R path's RAFT shape on in-frame and
    smooth coordinates; the float32 lookup against
    the materialized one; then the bf16 kernel's and the CUDA-core kernel's
    times in bf16."""
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cuda_core_err = 0.0
    cases = WINDOWED_CASES + MMA_CASES + TF32_CASES
    for i, (c, dtype, kind, radius, levels, shape) in enumerate(cases):
        wc, coords, _ = windowed_inputs(shape, c, dtype, kind, levels, seed=SEED + i)
        label = f"[7] windowed {shape} C={c} {str(dtype)[6:]} r={radius} L={levels} {kind}"
        worst[dtype] = max(worst[dtype], windowed_agrees(label, wc, coords, radius))
        # the CUDA-core kernel, timed beside the tensor-core ones, on the
        # float32 cases the route sent it before the 3xTF32 kernel
        if i < len(WINDOWED_CASES) and dtype == torch.float32:
            cuda_core_err = max(cuda_core_err, windowed_agrees(
                f"{label}, called directly", wc, coords, radius, kernel=WINDOWED_CORR_KERNEL))

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
    # the float32 shapes: the 720p F path's AMT lookup, and the float32
    # 720p R path's RAFT lookup (both directions; the video CLI's)
    for label, shape in (("F AMT", F_AMT_720P), ("R RAFT", RAFT_720P)):
        for kind in PATH_KINDS:
            wc, coords, _ = windowed_inputs(shape, 256, torch.float32, kind, seed=SEED)
            worst[torch.float32] = max(worst[torch.float32], windowed_agrees(
                f"[7] windowed at the 720p {label} lookup {shape} C=256 f32 r=4 L=4 {kind}",
                wc, coords))
            del wc, coords

    # the identity the windowed path rests on, at the 720p fmap
    wc, coords, (f1, f2) = windowed_inputs((1, 92, 160), 256, torch.float32, "in_frame")
    got = corr_ops.windowed_corr_lookup(wc, coords)
    ref = corr_ops.corr_lookup(corr_ops.corr_pyramid(f1, f2), coords)
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"[7] windowed_corr_tf32 vs materialized corr_lookup (1, 92, 160) C=256 f32: "
          f"max_abs_err {err:.3e}, max|materialized| {scale:.3e}", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError("windowed and materialized lookups disagree at 720p")
    # with grad on, the routed kernel refuses coordinates that need grad
    # (it has no backward) instead of returning an output cut from the graph
    coords.requires_grad_()
    before = WINDOWED_CORR_TF32_KERNEL.launches
    try:
        with torch.enable_grad():
            corr_ops.windowed_corr_lookup(wc, coords)
    except NotImplementedError as e:
        print(f"[7] with grad on: windowed_corr_lookup raised NotImplementedError ({e})",
              flush=True)
    else:
        raise AssertionError("the windowed lookup returned a tensor cut from the graph")
    if WINDOWED_CORR_TF32_KERNEL.launches != before:
        raise AssertionError("the windowed kernel launched on an input that needs grad")
    del wc, coords, f1, f2, got, ref
    torch.cuda.empty_cache()

    stats = {"path_err": path_err, "max_abs_err_cases_f32": worst[torch.float32],
             "max_abs_err_cases_bf16": worst[torch.bfloat16],
             "cuda_core_max_abs_err_cases_f32": cuda_core_err,
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


# (record key, wrapper, the kernel's row in a trace) of the float32 kernels
F32_TIMED = [("tf32", WINDOWED_CORR_TF32_KERNEL, "windowed_corr_tf32_kernel"),
             ("cuda_core", WINDOWED_CORR_KERNEL, "windowed_corr_kernel")]


def f32_lookup_reading(wc, coords, label: str) -> dict:
    """The two float32 windowed kernels on these inputs in the same run, by
    events and device time, each against its bound (`f32_lookup_bounds`:
    the 3xTF32 kernel's three TF32 products a float32 one at the TF32
    tensor-core peak, or its bytes; the CUDA-core kernel's float32
    operations at the CUDA-core peak); the CUDA-core kernel checked
    against the plain version and the 3xTF32 one against the materialized
    `corr_lookup` over a pyramid of the same maps (<= 1e-4 of the largest
    value), whose lookup is timed beside them (the pyramid is built before
    the clock starts); the plain version's time."""
    bounds = f32_lookup_bounds(wc, coords)
    nbytes, flops = bounds["bytes"], bounds["flops"]
    out = {"bytes_bound_ms": 1e3 * nbytes / H100_BYTES_PER_S, "bytes": nbytes, "flops": flops}
    for key in ("tf32", "cuda_core"):
        out[f"{key}_bound_ms"], out[f"{key}_bound_by"] = bounds[key]
    out["cuda_core_max_abs_err"] = windowed_agrees(
        f"{label}, {WINDOWED_CORR_KERNEL.name} called directly", wc, coords,
        kernel=WINDOWED_CORR_KERNEL)
    n, _, c = wc.f1.shape
    h, w = coords.shape[-2:]
    fmap1 = (wc.f1 * math.sqrt(c)).transpose(1, 2).reshape(n, c, h, w)
    levels = corr_ops.corr_pyramid(fmap1, wc.f2_levels[0].permute(0, 3, 1, 2), len(wc.f2_levels))
    got = WINDOWED_CORR_TF32_KERNEL(wc, coords)
    ref = corr_ops.corr_lookup(levels, coords)
    torch.cuda.synchronize()
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"{label}: {WINDOWED_CORR_TF32_KERNEL.name} vs materialized corr_lookup: max_abs_err "
          f"{err:.3e}, max|materialized| {scale:.3e}", flush=True)
    if not err <= 1e-4 * scale:
        raise AssertionError(f"{label}: the 3xTF32 lookup and the materialized one disagree")
    parts = []
    for key, kernel, row in F32_TIMED:
        call = lambda k=kernel: k(wc, coords)  # noqa: E731
        ms = cuda_ms(call, warmup=3)
        _, by_name = device_ms(call)
        own = kernel_row(by_name, row)
        out[f"{key}_ms"], out[f"{key}_device_ms"] = ms, own
        bound = out[f"{key}_bound_ms"]
        parts.append(f"{kernel.name} {ms:.4f} ms by events ({fmt_share(bound, ms)}), device "
                     f"{fmt_ms(own)} ({fmt_share(bound, own)} {bound:.4f} ms, "
                     f"{out[f'{key}_bound_by']})")
    mat = lambda: corr_ops.corr_lookup(levels, coords)  # noqa: E731
    out["materialized_ms"] = cuda_ms(mat, warmup=3)
    out["materialized_device_ms"], _ = device_ms(mat)
    out["plain_ms"] = cuda_ms(lambda: windowed_corr_lookup_plain(wc, coords), iters=3)
    ext = extent_summary(mma_tile_extents(wc, coords), c, 4)
    out["extent"] = fmt_extent(ext)
    print(f"{label} {tuple(coords.shape)} C={c} f32: {'; '.join(parts)}; materialized "
          f"corr_lookup (grid_sample over the float32 volume) {out['materialized_ms']:.4f} ms "
          f"by events, device {fmt_ms(out['materialized_device_ms'])}; plain "
          f"{out['plain_ms']:.4f} ms; {flops / 1e9:.2f} GFLOP float32 (x3 in TF32), "
          f"{nbytes / 1e6:.1f} MB: {out['bytes_bound_ms']:.4f} ms; tile walk: {out['extent']}",
          flush=True)
    return out


def decode_turns(model, prep, tv, iters: int = 5) -> dict:
    """`decode_one` by CUDA events with the float32 route's kernel as it is
    and with the CUDA-core kernel in its place, in turns (3xTF32, CUDA
    core, CUDA core, 3xTF32): the lookups' change end to end, in one run."""
    times = {"tf32": [], "cuda_core": []}
    for key in ("tf32", "cuda_core", "cuda_core", "tf32"):
        corr_ops.WINDOWED_CORR_TF32_KERNEL = (WINDOWED_CORR_TF32_KERNEL if key == "tf32"
                                              else WINDOWED_CORR_KERNEL)
        try:
            with torch.inference_mode():
                times[key].append(cuda_ms(lambda: model.decode_one(prep, tv), iters=iters))
        finally:
            corr_ops.WINDOWED_CORR_TF32_KERNEL = WINDOWED_CORR_TF32_KERNEL
    return {k: statistics.mean(v) for k, v in times.items()}


def run_f_path(smi: str) -> dict:
    """Phase 9 (a): GIMMVFI_F(ff_iters=32, bf16) at 720p, 7 timesteps. The
    float32 feature map's bidirectional volume (2.31 GB) is over the limit,
    so the AMT looks up the float32 windowed state: 14 launches of the
    3xTF32 kernel a pair. Then the flow estimator alone, `decode_one` with
    either float32 kernel in turns, and both kernels on the inputs of the
    first AMT lookup of one `decode_one`, captured: checked and timed."""
    model = init_normal_(GIMMVFI_F(ff_iters=32, dtype=torch.bfloat16), SEED)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    img_xs = torch.rand((1, 2, H, W, 3), generator=gen).cuda()
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    res, prep = drive_path(model, img_xs, ts, None, 0, "F 720p", tf32_expected=2 * N_T)
    img0, img1 = 255.0 * prep["img0"], 255.0 * prep["img1"]
    with torch.inference_mode():
        res["flow_ms"] = cuda_ms(lambda: model.bidir_flow(img0, img1), iters=3)
        recorder = LookupRecorder([0], WINDOWED_CORR_TF32_KERNEL)
        corr_ops.WINDOWED_CORR_TF32_KERNEL = recorder
        try:
            model.decode_one(prep, ts[N_T // 2])
        finally:
            corr_ops.WINDOWED_CORR_TF32_KERNEL = WINDOWED_CORR_TF32_KERNEL
    res["decode_turns"] = decode_turns(model, prep, ts[N_T // 2])
    print(f"[9] (a) GIMMVFI_F(ff_iters=32) bf16 {H}x{W} 8x, float32 windowed AMT correlation: "
          f"{path_lines(9, res)}; FlowFormer alone (both directions) {res['flow_ms']:.2f} ms; "
          f"decode_one at t={ts[N_T // 2]} in turns: {res['decode_turns']['tf32']:.3f} ms with "
          f"{WINDOWED_CORR_TF32_KERNEL.name}, {res['decode_turns']['cuda_core']:.3f} ms with "
          f"{WINDOWED_CORR_KERNEL.name}; {smi}", flush=True)
    if recorder.calls != 2:
        raise AssertionError(f"decode_one made {recorder.calls} float32 windowed lookups, expected 2")
    del model, prep, img0, img1, img_xs
    torch.cuda.empty_cache()
    wc, coords, radius = recorder.inputs[0]
    label = "[9] (a) the F path's first AMT lookup (captured)"
    res["lookup_max_abs_err"] = windowed_agrees(label, wc, coords, radius)
    res["lookup"] = f32_lookup_reading(wc, coords, label)
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

# ------------------------------------------------------------------ phase 10
WORK = Path(__file__).resolve().parent / "build" / "chip_smoke_phase10"
GIMM_HW = (256, 448)  # Vimeo's frame size, VTF's and VSF's flows
VSF_TS = [t_id / 6.0 for t_id in range(2, 7)]
VIDEO_HW = (720, 1280)
VIDEO_N = 8
X4K_HW = (2160, 4096)


def counts() -> dict:
    return {"splat": SPLAT_KERNEL.launches, "splat_bwd": SPLAT_BACKWARD_KERNEL.launches,
            "tf32": WINDOWED_CORR_TF32_KERNEL.launches,
            "mma": WINDOWED_CORR_MMA_KERNEL.launches, "cuda_core": WINDOWED_CORR_KERNEL.launches}


def expect_counts(label: str, got: dict, splat: int, tf32: int = 0, splat_bwd: int = 0,
                  phase: int = 10):
    """Exact launch counts of a phase 10 or 11 path: `splat` splats,
    `splat_bwd` splat backwards, `tf32` float32 windowed lookups, no bf16
    or CUDA-core lookup."""
    want = {"splat": splat, "splat_bwd": splat_bwd, "tf32": tf32, "mma": 0, "cuda_core": 0}
    if got != want:
        raise AssertionError(f"[{phase}] {label}: launches {got}, expected {want}")


# float32 windowed lookups a GIMMVFI_R(raft_iters=20) pair makes at 720p
# with n_t timesteps: both 1/8-map volumes (92x160 squared, 2 x 1.16 GB) are
# over the 2 GiB limit, so RAFT looks up the windowed state once an
# iteration and the AMT twice a timestep. At X4K's 1024x544 (DS 0.5 of the
# padded 2k frame) they are 2 x 0.40 GB and materialized: no lookup.
def f32_windowed_720p(n_t: int) -> int:
    return 20 + 2 * n_t


def seeded_flows(hw, seed: int):
    """(normalized xs, raw flows), (1, 2, H, W, 2) float32: smooth seeded
    flows of a few pixels, normalized by their largest magnitude as VTF does."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    coarse = torch.randn((2, 2, hw[0] // 16, hw[1] // 16), generator=gen) * 6.0
    ori = torch.nn.functional.interpolate(coarse, size=hw, mode="bilinear", align_corners=False)
    ori = ori.permute(0, 2, 3, 1)[None].contiguous()
    return (ori / ori.abs().max() + 1.0) / 2.0, ori


def run_gimm() -> dict:
    """Phase 10 (a): stage-1 GIMM, float32, at Vimeo's 256x448 on seeded
    flows: one `forward` at t = 0.5 and one `forward_multi` over VSF's five
    timesteps, each after a warm-up, with the counts from 0 (exactly 2 and
    10 splats), by CUDA events; the same calls on the CPU with the same
    seeded weights, PSNR of the normalized flow >= 50 dB."""
    xs, ori = seeded_flows(GIMM_HW, SEED + 3)
    t = torch.tensor([0.5])
    gpu, cpu = (init_normal_(GIMM(device=d), SEED).eval() for d in (None, "cpu"))
    res = {}
    with torch.inference_mode():
        for label, call, n_splat in (
                ("forward", lambda m: m(xs, ori, t), 2),
                ("forward_multi", lambda m: m.forward_multi(xs, ori, VSF_TS), 2 * len(VSF_TS))):
            call(gpu)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            got, ms = bench.timed(lambda: call(gpu), torch.device("cuda"))
            got_counts = counts()
            expect_counts(f"(a) GIMM.{label}", got_counts, n_splat)
            db = psnr(got.cpu(), call(cpu))
            print(f"[10] (a) GIMM.{label} float32 {GIMM_HW[0]}x{GIMM_HW[1]}: {ms:.3f} ms by "
                  f"events, {n_splat} splat launches, output {tuple(got.shape)}, GPU vs CPU "
                  f"{db:.2f} dB", flush=True)
            if not (bool(torch.isfinite(got).all()) and db >= 50.0):
                raise AssertionError(f"[10] (a) GIMM.{label}: non-finite or GPU vs CPU {db:.2f} dB")
            res[label] = {"ms": ms, "db": db, "launches": got_counts}
    res["ms_per_t"] = res["forward_multi"]["ms"] / len(VSF_TS)
    return res


def reference_checkpoint(model: torch.nn.Module, path: Path, extras: dict) -> str:
    """Save `model`'s weights as a reference training checkpoint has them: a
    `state_dict` wrapper, DDP `module.` prefixes and keys the port holds
    no parameter for (`extras`)."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    sd.update(extras)
    sd.update({f"{k[:-len('running_mean')]}num_batches_tracked": torch.tensor(0)
               for k in list(sd) if k.endswith("running_mean")})
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    return str(path)


def seeded_frames(hw, k: int, seed: int) -> list[np.ndarray]:
    """k (H, W, 3) uint8 frames: shifted crops of one seeded smooth image,
    so the pair has motion to find."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    big = (hw[0] + 4 * k, hw[1] + 8 * k)
    coarse = torch.rand((1, 3, big[0] // 8, big[1] // 8), generator=gen)
    img = torch.nn.functional.interpolate(coarse, size=big, mode="bilinear", align_corners=False)
    img = (img[0].permute(1, 2, 0).numpy() * 255).astype(np.uint8)
    return [np.ascontiguousarray(img[4 * i:4 * i + hw[0], 8 * i:8 * i + hw[1]]) for i in range(k)]


def run_video_cli(smi: str) -> dict:
    """Phase 10 (b): `video_nx.main` on three seeded 720x1280 PPM frames
    with a seeded R checkpoint in the reference's layout, 8x, float32, on
    the card, counts from 0: 2 pairs, 1 + 2 x 8 frames, 28 splats and
    2 x 34 float32 windowed lookups. Then, on a model loaded from the same
    checkpoint, the first pair through `interpolate_pair` against
    `interpolate_sequential` on inputs padded here (<= 1e-5 max-abs: two
    runs differ by the order in which the splat's float atomics add), the
    CLI's frames of that pair against the latter's quantized (<= 1 level),
    and the inputs of the pair's first RAFT and first AMT lookup, captured,
    against the plain version."""
    src = WORK / "video_frames"
    src.mkdir(parents=True)
    for i, frame in enumerate(seeded_frames(VIDEO_HW, 3, SEED + 4)):
        write_ppm(str(src / f"{i:03d}.ppm"), frame)
    model = init_normal_(GIMMVFI_R(raft_iters=20), SEED)
    ckpt = reference_checkpoint(model, WORK / "gimmvfi_r_random.pt",
                                {"g_filter": torch.full((1, 1, 3, 3), 1 / 9)})
    del model
    torch.cuda.empty_cache()
    n_t = VIDEO_N - 1

    out_dir = WORK / "video_out"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = video_nx.main(["--source-path", str(src), "--N", str(VIDEO_N), "--ckpt", ckpt,
                         "--output-path", str(out_dir)])
    total_s = time.perf_counter() - t0
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    n_frames = 1 + 2 * VIDEO_N
    if len(res["pair_ms"]) != 2 or len(res["frames"]) != n_frames:
        raise AssertionError(f"[10] (b) {len(res['pair_ms'])} pairs, {len(res['frames'])} frames")
    expect_counts("(b) video CLI", got, 2 * 2 * n_t, 2 * f32_windowed_720p(n_t))
    written = res["written"]["output"]
    if written.endswith(".frames"):
        names = sorted(os.listdir(written))
        if len(names) != n_frames:
            raise AssertionError(f"[10] (b) {len(names)} PPM frames in {written}")
        if not np.array_equal(read_ppm(os.path.join(written, names[1])), res["frames"][1]):
            raise AssertionError("[10] (b) the PPM written is not the frame made")
    elif not os.path.getsize(written):
        raise AssertionError(f"[10] (b) {written} is empty")
    print(f"[10] (b) video_nx.main {VIDEO_HW[0]}x{VIDEO_HW[1]} float32 8x: 2 pairs, {len(res['frames'])} frames "
          f"written to {written}; launches {got}; ms a pair (host clock around interpolate_pair): "
          f"{', '.join(f'{ms:.2f}' for ms in res['pair_ms'])}; the whole CLI {total_s:.2f} s; "
          f"peak allocated {peak / 2**20:.1f} MiB; {smi}", flush=True)

    # the first pair again on a reloaded model: interpolate_pair, with the
    # float32 lookups' inputs captured, against interpolate_sequential on
    # inputs padded here
    i0, i1 = (read_image(str(src / f"{i:03d}.ppm")) for i in range(2))
    model = video_nx.load_model(ckpt)
    raft_iters = model.flow_estimator.iters
    recorder = LookupRecorder([0, raft_iters], WINDOWED_CORR_TF32_KERNEL)
    corr_ops.WINDOWED_CORR_TF32_KERNEL = recorder
    try:
        pair, _ = video_nx.interpolate_pair(model, i0, i1, VIDEO_N, None)
    finally:
        corr_ops.WINDOWED_CORR_TF32_KERNEL = WINDOWED_CORR_TF32_KERNEL
    padder = InputPadder(VIDEO_HW, 32)
    xs = padder.pad(torch.from_numpy(np.stack([i0, i1])).permute(0, 3, 1, 2))
    ref = interpolate_sequential(model, xs.permute(0, 2, 3, 1)[None].cuda(),
                                 [i / VIDEO_N for i in range(1, VIDEO_N)])["imgt_pred"][:, 0]
    ref = padder.unpad(ref.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).cpu().numpy()
    pair = np.stack(pair)
    pair_err, pair_db = float(np.abs(pair - ref).max()), psnr(torch.from_numpy(pair), torch.from_numpy(ref))
    cli_frames = np.stack([f[:, VIDEO_HW[1]:] for f in res["frames"][1:VIDEO_N]])
    levels = int(np.abs(cli_frames.astype(np.int16) - (np.clip(ref, 0, 1) * 255).astype(np.uint8)
                        ).max())
    print(f"[10] (b) the first pair: interpolate_pair vs interpolate_sequential on inputs padded "
          f"here: max_abs_err {pair_err:.3e}, {pair_db:.2f} dB; "
          f"the CLI's frames vs the latter quantized: {levels} level(s) apart; "
          f"{recorder.calls} float32 windowed lookups", flush=True)
    if not (pair_err <= 1e-5 and levels <= 1 and recorder.calls == f32_windowed_720p(n_t)):
        raise AssertionError(f"[10] (b) the first pair: {pair_err:.3e} off, CLI frames {levels} "
                             f"levels off, {recorder.calls} float32 windowed lookups")
    del model, pair, ref
    torch.cuda.empty_cache()
    lookup_err = {}
    for call, label, shape in ((0, "RAFT", RAFT_720P), (raft_iters, "AMT", F_AMT_720P)):
        wc, coords, radius = recorder.inputs[call]
        if (coords.shape[0], *coords.shape[-2:]) != shape or wc.f1.dtype != torch.float32:
            raise AssertionError(f"[10] (b) the first {label} lookup: {tuple(coords.shape)} "
                                 f"{wc.f1.dtype}, expected {shape} float32")
        lookup_err[label] = windowed_agrees(
            f"[10] (b) the video CLI pair's first {label} lookup {shape} C={wc.f1.shape[-1]} f32 "
            f"(captured)", wc, coords, radius)
    del recorder
    torch.cuda.empty_cache()
    return {"pair_ms": res["pair_ms"], "total_s": total_s, "peak_bytes": peak,
            "launches": got, "pair_err": pair_err, "lookup_max_abs_err": lookup_err, "ckpt": ckpt}


def harness(argv: list[str]) -> tuple[dict, dict, float]:
    """One harness through `benchmarks.main` with the counts from 0: its
    result (the JSON line it printed last, which must be finite), the
    launches and its seconds."""
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = bench_cli.main(argv)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        print(f"[10] (c) {argv[0]}: {line}", flush=True)
    values = [v for r in (res.values() if argv[0] == "snu_film_arb" else [res])
              for v in r.values()]
    if json.loads(lines[-1]) != json.loads(json.dumps(res)) or not all(
            v is not None and math.isfinite(v) for v in values):
        raise AssertionError(f"[10] (c) {argv[0]}: no finite JSON result last")
    return res, counts(), seconds


def run_harnesses(vfi_ckpt: str) -> dict:
    """Phase 10 (c): the four harnesses on fabricated data, float32 on the
    card: SNU-FILM-arb medium (one row of five 720x1280 frames) with a
    seeded LPIPS checkpoint; X4K 2k, with it too (one scene of 33 4096x2160 frames,
    links to three distinct ones: 7 items at DS 0.5); VTF and VSF on
    seeded 256x448 `.flo` files with a seeded GIMM checkpoint. Each JSON
    result finite; exact launch counts."""
    root = WORK / "data"
    lpips = reference_checkpoint(
        init_normal_(LPIPS(), SEED), WORK / "lpips_random.pt",
        {"scaling_layer.shift": torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1),
         "scaling_layer.scale": torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)})
    gimm = reference_checkpoint(init_normal_(GIMM(), SEED), WORK / "gimm_random.pt",
                                {"g_filter": torch.full((1, 1, 3, 3), 1 / 9)})
    results = {}

    snu = root / "snu"
    (snu / "frames").mkdir(parents=True)
    row = []
    for k, frame in enumerate(seeded_frames(VIDEO_HW, 5, SEED + 5)):
        write_ppm(str(snu / "frames" / f"{k}.ppm"), frame)
        row.append(f"frames/{k}.ppm")
    (snu / "test-arb-medium.txt").write_text(" ".join(row) + "\n")
    res, got, sec = harness(["snu_film_arb", "--data-root", str(snu), "--ckpt", vfi_ckpt,
                             "--lpips-path", lpips])
    expect_counts("(c) snu_film_arb", got, 2 * 3, f32_windowed_720p(3))
    results["snu_film_arb"] = {"result": res, "launches": got, "seconds": sec}

    scene = root / "x4k" / "Type1" / "TEST01"
    scene.mkdir(parents=True)
    distinct = [WORK / f"x4k_{k}.ppm" for k in range(3)]
    for path, frame in zip(distinct, seeded_frames(X4K_HW, 3, SEED + 6)):
        write_ppm(str(path), frame)
    for i in range(33):
        os.symlink(distinct[0 if i == 0 else 2 if i == 32 else 1], scene / f"{i:04d}.ppm")
    res, got, sec = harness(["x4k", "--data-root", str(root / "x4k"), "--ckpt", vfi_ckpt,
                             "--split", "2k", "--lpips-path", lpips])
    expect_counts("(c) x4k 2k", got, 2 * 7)
    results["x4k"] = {"result": res, "launches": got, "seconds": sec}

    rng = np.random.default_rng(SEED + 7)
    seqs = ["00001/0001", "00001/0002"]
    for bench_name, names, listing in (
            ("vtf", ["im1_im3", "im2_im3", "im2_im1", "im3_im1"], "tri_testlist.txt"),
            ("vsf", ["im1_im7", "im7_im1"] + [f"im{t}_im{e}" for t in range(2, 7) for e in (1, 7)],
             "sep_testlist.txt")):
        data = root / bench_name
        for seq in seqs:
            (data / "flow_sequences" / seq).mkdir(parents=True)
            for name in names:
                _, flow = seeded_flows(GIMM_HW, int(rng.integers(1 << 30)))
                write_flo(str(data / "flow_sequences" / seq / f"{name}.flo"), flow[0, 0].numpy())
        (data / listing).write_text("\n".join(seqs) + "\n")
        res, got, sec = harness([bench_name, "--data-root", str(data), "--ckpt", gimm])
        per_seq = 1 if bench_name == "vtf" else len(VSF_TS)
        expect_counts(f"(c) {bench_name}", got, 2 * per_seq * len(seqs))
        results[bench_name] = {"result": res, "launches": got, "seconds": sec}
    print(f"[10] (c) harness seconds: "
          f"{', '.join(f'{k} {v['seconds']:.2f}' for k, v in results.items())}", flush=True)
    return results


def run_phase10(smi: str) -> dict:
    """Phase 10: stage-1 GIMM, the video CLI and the four harnesses, in a
    scratch directory under build/."""
    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    gimm = run_gimm()
    video = run_video_cli(smi)
    harnesses = run_harnesses(video["ckpt"])
    print(f"[10] phase 10 took {time.perf_counter() - t0:.2f} s", flush=True)
    return {"gimm": gimm, "video": video, "harnesses": harnesses}


# ------------------------------------------------------------------ phase 11
WORK11 = Path(__file__).resolve().parent / "build" / "chip_smoke_phase11"
RECIPE = "configs/gimm/gimm.yaml"  # stage-1 GIMM: Adam, lr 1e-4, batch 32, 256^2 crop
CROP = 256  # the flow dataset's crop (`data/flow_dataset.py`); TRAIN_SPLAT's H and W
TIMED_STEPS = 10


def check_backward() -> dict:
    """Phase 11 (a): the backward kernel against `splat_sum_backward_plain`
    in `BWD_CASES` (the recipe step's (32, 256, 256, 17) on a random, a
    smooth and a non-finite/far field, the small `CHECK_CASES`, C above one
    d_flow chunk, W off the 32-column tile): d_vals and d_flow <= 1e-5 x
    max(1, max|plain|), and d_vals alone (no d_flow) equal to the full
    call's. Then, at the recipe shape on the random and the non-finite
    field, two calls in each mode must give the same bits. Then its times
    there in both modes (events and device rows, against each mode's
    bound) beside the plain version's, the forward kernel's and the PyTorch
    yardsticks' (`F.grid_sample` for d_vals, `aten.grid_sampler_2d_backward`
    for d_flow; each held to the plain version first)."""
    worst, worst_share = 0.0, 0.0
    for i, (shape, field, std) in enumerate(BWD_CASES):
        vals, flow, g = bwd_inputs(shape, field, std, SEED + i)
        d_vals, d_flow = SPLAT_BACKWARD_KERNEL(vals, flow, g)
        d_vals_only, none = SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=False)
        ref_vals, ref_flow = splat_sum_backward_plain(vals, flow, g)
        torch.cuda.synchronize()
        errs = []
        for what, got, ref in (("d_vals", d_vals, ref_vals), ("d_flow", d_flow, ref_flow)):
            err = float((got - ref).abs().max())
            bound = 1e-5 * max(1.0, float(ref.abs().max()))
            errs.append(f"{what} {err:.3e} (bound {bound:.3e})")
            if not err <= bound:
                raise AssertionError(f"[11] (a) splat backward {what} disagrees with the plain "
                                     f"version at {shape} {field}: {err:.3e} > {bound:.3e}")
            worst, worst_share = max(worst, err), max(worst_share, err / bound)
        if none is not None or not torch.equal(d_vals_only, d_vals):
            raise AssertionError(f"[11] (a) d_vals without d_flow differs at {shape} {field}")
        print(f"[11] (a) splat backward {shape} {field} flow std {std}: {'; '.join(errs)}",
              flush=True)
        del vals, flow, g, d_vals, d_flow, d_vals_only, ref_vals, ref_flow
    torch.cuda.empty_cache()

    for field in ("random", "non_finite"):
        vals, flow, g = bwd_inputs(TRAIN_SPLAT, field, TRAIN_STD, SEED)
        for need_flow in (True, False):
            first = SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=need_flow)
            second = SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=need_flow)
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in zip(first, second) if a is not None]
            if not all(same):
                raise AssertionError(f"[11] (a) two calls of the backward differ at {TRAIN_SPLAT} "
                                     f"{field}, need_flow={need_flow}: equal {same}")
        print(f"[11] (a) splat backward {TRAIN_SPLAT} {field}: two calls give the same bits, "
              f"d_vals and d_flow, in both modes", flush=True)
        del vals, flow, g, first, second
    torch.cuda.empty_cache()

    stats = {"max_abs_err": worst, "max_err_over_bound": worst_share,
             "tolerance": "1e-5 max(1, max|plain|), d_vals and d_flow", "deterministic": True}
    for field in ("random", "smooth"):
        vals, flow, g = bwd_inputs(TRAIN_SPLAT, field, TRAIN_STD, SEED)
        bound, bound_by = splat_bwd_bound(vals)
        vals_bound = splat_bwd_bound(vals, need_flow=False)[0]
        ms = cuda_ms(lambda: SPLAT_BACKWARD_KERNEL(vals, flow, g), warmup=3)
        _, rows = device_ms(lambda: SPLAT_BACKWARD_KERNEL(vals, flow, g))
        dev = kernel_row(rows, "splat_sum_bwd_kernel")
        vals_ms = cuda_ms(lambda: SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=False), warmup=3)
        _, rows = device_ms(lambda: SPLAT_BACKWARD_KERNEL(vals, flow, g, need_flow=False))
        vals_dev = kernel_row(rows, "splat_sum_bwd_kernel")
        plain_ms = cuda_ms(lambda: splat_sum_backward_plain(vals, flow, g), iters=5)
        fwd_ms = cuda_ms(lambda: SPLAT_KERNEL(vals, flow), warmup=3)
        _, fwd_rows = device_ms(lambda: SPLAT_KERNEL(vals, flow))
        fwd_dev = kernel_row(fwd_rows, "splat_sum_kernel")
        fwd_bound = splat_bound(vals)[0]
        label = f"[11] (a) splat backward {TRAIN_SPLAT} {field} flow std {TRAIN_STD:g}"
        lib = yardstick_readings(vals, flow, g, label=label)
        lib_ms = lib["d_vals"]["ms"] + lib["d_flow"]["ms"]
        lib_dev = (None if lib["d_vals"]["device_ms"] is None or lib["d_flow"]["device_ms"] is None
                   else lib["d_vals"]["device_ms"] + lib["d_flow"]["device_ms"])
        print(f"{label}: full (d_vals and d_flow) {ms:.4f} ms by events ({fmt_share(bound, ms)}), "
              f"device {fmt_ms(dev)} ({fmt_share(bound, dev)}), bound {bound:.4f} ms "
              f"({bound_by}); d_vals alone {vals_ms:.4f} ms by events, device {fmt_ms(vals_dev)} "
              f"({fmt_share(vals_bound, vals_dev)} of {vals_bound:.4f} ms); yardsticks: "
              f"F.grid_sample {fmt_ms(lib['d_vals']['device_ms'])} device, with the d_flow call "
              f"{fmt_ms(lib_dev)}; plain {plain_ms:.4f} ms; the forward kernel there "
              f"{fwd_ms:.4f} ms by events, device {fmt_ms(fwd_dev)} "
              f"({fmt_share(fwd_bound, fwd_dev)} of {fwd_bound:.4f} ms)", flush=True)
        reading = {"ms": ms, "device_ms": dev, "d_vals_only_ms": vals_ms,
                   "d_vals_only_device_ms": vals_dev, "d_vals_only_bound_ms": vals_bound,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                   "library_ms": lib_ms, "library_device_ms": lib_dev,
                   "library_d_vals_ms": lib["d_vals"]["ms"],
                   "library_d_vals_device_ms": lib["d_vals"]["device_ms"],
                   "library_d_flow_ms": lib["d_flow"]["ms"],
                   "library_d_flow_device_ms": lib["d_flow"]["device_ms"],
                   "forward_ms": fwd_ms, "forward_device_ms": fwd_dev,
                   "forward_bound_ms": fwd_bound, "forward_library_ms": lib["forward"]["ms"],
                   "forward_library_device_ms": lib["forward"]["device_ms"]}
        if field == "random":
            stats.update(reading, library_call="F.grid_sample (d_vals) + "
                         "aten.grid_sampler_2d_backward grid gradient (d_flow)",
                         library_layout={k: v["layout"] for k, v in lib.items()},
                         library_max_abs_err={k: v["max_abs_err"] for k, v in lib.items()})
        else:
            stats.update({f"smooth_{k}": v for k, v in reading.items() if k != "bound_by"})
        del vals, flow, g
    torch.cuda.empty_cache()
    return stats


def flow_batch(n: int, hw, seed: int, device="cuda") -> dict:
    """A stage-1 batch as `data/flow_dataset.py` makes it, from seeded
    smooth flows of a few pixels: xs (N, 3, H, W, 2) normalized by the
    endpoint flows' largest magnitude, ori_flows (N, 2, H, W, 2)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    coarse = torch.randn((n * 3, 2, hw[0] // 16, hw[1] // 16), generator=gen) * 4.0
    flows = torch.nn.functional.interpolate(coarse, size=hw, mode="bilinear",
                                            align_corners=False)
    flows = flows.view(n, 3, 2, *hw).permute(0, 1, 3, 4, 2).contiguous()
    scaler = flows[:, [0, 2]].abs().amax(dim=(1, 2, 3, 4)).view(n, 1, 1, 1, 1)
    return {"xs": ((flows / scaler + 1.0) / 2.0).to(device),
            "ori_flows": torch.stack([flows[:, 0], -flows[:, 2]], dim=1).to(device)}


def recipe_state(cfg, device=None, seed=SEED):
    """GIMM from a seed (its own initialization) and the recipe's optimizer."""
    torch.manual_seed(seed)
    model = GIMM(device=device)
    o = cfg.optimizer
    opt, sched = create_optimizer(model, o.type, init_lr=o.init_lr, weight_decay=o.weight_decay,
                                  betas=tuple(o.betas), ft=o.ft, max_grad_norm=o.max_gn)
    return create_train_state(model, opt, sched, use_ema=bool(cfg.arch.ema))


def run_recipe_step(smi: str) -> dict:
    """Phase 11 (b): the recipe's step on the card, float32, TF32 off:
    GIMM, Adam lr 1e-4, batch 32 at 256^2 on seeded smooth flows, one t_id
    a step. One step counted from 0 (exactly 2 forward and 2 backward
    splat launches, no windowed lookup), 2 more warm-ups, then 10 timed by
    CUDA events: median ms a step, peak allocated, loss finite, parameters
    moved; then the device time of one step and of its splats in a trace."""
    cfg = load_config(RECIPE)
    n = cfg.experiment.batch_size
    state = recipe_state(cfg)
    step = make_gimm_train_step(use_ema=bool(cfg.arch.ema))
    batch = flow_batch(n, (CROP, CROP), SEED + 11)
    rng = np.random.default_rng(SEED)

    def one():
        batch["t_id"] = np.full((n,), rng.integers(0, 3), np.int32)
        return step(state, batch)

    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    one()
    torch.cuda.synchronize()
    got = counts()
    expect_counts("(b) the recipe step", got, 2, splat_bwd=2, phase=11)
    one()
    one()
    times, losses = [], []
    for _ in range(TIMED_STEPS):
        metrics, ms = bench.timed(one, torch.device("cuda"))
        times.append(ms)
        losses.append(float(metrics["loss_total"]))
    peak = torch.cuda.max_memory_allocated()
    moved = max(float((v - before[k]).abs().max()) for k, v in state.model.state_dict().items())
    if not (all(math.isfinite(x) for x in losses) and moved > 0):
        raise AssertionError(f"[11] (b) losses {losses}, largest parameter move {moved}")
    step_dev, rows = device_ms(one, iters=1, warmup=0)
    fwd = kernel_row(rows, "splat_sum_kernel")
    bwd = kernel_row(rows, "splat_sum_bwd_kernel")
    med = statistics.median(times)
    splat_dev = None if fwd is None or bwd is None else fwd + bwd
    print(f"[11] (b) the recipe step ({RECIPE}: {cfg.optimizer.type} lr {cfg.optimizer.init_lr}, "
          f"batch {n}, {CROP}x{CROP}, float32): {med:.2f} ms a step (median of {TIMED_STEPS} by "
          f"events; {min(times):.2f}-{max(times):.2f}); peak allocated {peak / 2**20:.1f} MiB; "
          f"launches a step {got}; losses {losses[0]:.5f} -> {losses[-1]:.5f}; largest parameter "
          f"move {moved:.3e}; device time of one traced step {fmt_ms(step_dev)} (the "
          f"trace's rows, summed); its splats: forward {fmt_ms(fwd)} (2 launches), backward "
          f"{fmt_ms(bwd)} (2 launches), "
          f"{'not measured' if splat_dev is None else f'{100 * splat_dev / med:.2f}%'} of the "
          f"step; {smi}", flush=True)
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:6]
    print(f"[11] (b) the step's largest device rows: "
          f"{'; '.join(f'{v:.3f} ms {k[:70]}' for k, v in top)}", flush=True)
    res = {"step_ms": med, "step_ms_all": times, "peak_bytes": peak, "launches": got,
           "losses": losses, "step_device_ms": step_dev, "splat_fwd_device_ms": fwd,
           "splat_bwd_device_ms": bwd}
    del state, batch
    torch.cuda.empty_cache()
    return res


GRAD_SEEDS = (SEED, SEED + 1, SEED + 2)  # phase 11 (c): weights and batch of each reading
GPU_RERUNS = 2  # the card's step from the same weights, for its own atomic order
ALPHAS = ("alpha_v", "alpha_fe")  # GIMM's scalar splat-weight parameters


def step_fields(cfg, device: str, weights: dict, batch: dict) -> dict:
    """One recipe step from `weights` on `batch`: the loss, each parameter's
    gradient, and the fields that the gradients of `ALPHAS` contract:
    u = dL/d(w1, w2), the gradient reaching the splat weights, and for each
    alpha c = d(w1, w2)/d alpha, pixel by pixel (forward mode). Gradients
    on the CPU, fields flattened to float64."""
    weights_fn, fields = gimm_model.splatting_weights, {}

    def spy(flow01, flow10, alpha_v, alpha_fe):
        w1, w2 = weights_fn(flow01, flow10, alpha_v, alpha_fe)
        w1.retain_grad()
        w2.retain_grad()
        f01, f10, a_v, a_fe = (x.detach() for x in (flow01, flow10, alpha_v, alpha_fe))
        one = torch.ones_like(a_v)
        fields["alpha_v"] = torch.func.jvp(lambda a: weights_fn(f01, f10, a, a_fe), (a_v,), (one,))[1]
        fields["alpha_fe"] = torch.func.jvp(lambda a: weights_fn(f01, f10, a_v, a), (a_fe,), (one,))[1]
        fields["w"] = (w1, w2)
        return w1, w2

    state = recipe_state(cfg, device=device)
    state.model.load_state_dict(weights)
    gimm_model.splatting_weights = spy
    try:
        loss = float(make_gimm_train_step()(state, batch)["loss_total"])
    finally:
        gimm_model.splatting_weights = weights_fn
    w1, w2 = fields.pop("w")
    flat = lambda pair: torch.cat([t.detach().reshape(-1) for t in pair]).cpu().double()
    return {"loss": loss, "u": flat((w1.grad, w2.grad)),
            "grads": {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()},
            **{k: flat(v) for k, v in fields.items()}}


def check_step_gpu_vs_cpu() -> dict:
    """Phase 11 (c): one recipe step of GIMM at 64x64, batch 2 (t_id 1 and
    2), on the card and on the CPU from the same seeded weights and batch,
    for each of `GRAD_SEEDS`, `GPU_RERUNS` times on the card. The loss
    agrees to 1e-5 relative, and each gradient tensor to 1e-4 x max|g_cpu|,
    but those of `ALPHAS`. Each of these is one sum over every pixel,
    sum_p u_p c_p (`step_fields`), that nearly cancels (the normalised
    splat hardly changes when its weights scale together): float32 holds
    such a sum only relative to the size of its terms, S = sum_p |u_p c_p|,
    not to its own. So the fields u and c are held to 1e-4 x max|cpu| as
    the gradients are; on each device the alpha's gradient is the float64
    contraction of its own fields, within a float32 dot product's rounding
    ((log2 n + 4) x 2^-24 x S, n terms); and GPU vs CPU it agrees to 1e-4 x
    S. Its gap relative to itself is printed beside, with S / |g|."""
    cfg = load_config(RECIPE)
    loss_rel, worst, worst_name, readings = 0.0, 0.0, None, []
    for seed in GRAD_SEEDS:
        torch.manual_seed(seed)
        weights = GIMM(device="cpu").state_dict()
        batch = flow_batch(2, (64, 64), seed + 12, device="cpu")
        batch["t_id"] = np.asarray([1, 2], np.int32)
        cpu = step_fields(cfg, "cpu", weights, batch)
        for run in range(GPU_RERUNS):
            gpu = step_fields(cfg, "cuda", weights, batch)
            where = f"[11] (c) seed {seed} run {run}"
            rel = abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])
            if not rel <= 1e-5:
                raise AssertionError(f"{where}: loss {gpu['loss']} vs {cpu['loss']} ({rel:.2e})")
            loss_rel = max(loss_rel, rel)
            for name, gc in cpu["grads"].items():
                gap = float((gpu["grads"][name] - gc).abs().max()) / float(gc.abs().max())
                if name not in ALPHAS and not gap <= 1e-4:
                    raise AssertionError(f"{where}: the gradient of {name} is {gap:.3e} x max|g_cpu| off")
                if name not in ALPHAS and gap > worst:
                    worst, worst_name = gap, name
            for field in ("u", *ALPHAS):
                gap = float((gpu[field] - cpu[field]).abs().max() / cpu[field].abs().max())
                if not gap <= 1e-4:
                    raise AssertionError(f"{where}: the field {field} is {gap:.3e} x max|cpu| off")
            for name in ALPHAS:
                terms = {"cpu": cpu["u"] * cpu[name], "gpu": gpu["u"] * gpu[name]}
                sums = {d: float(t.abs().sum()) for d, t in terms.items()}
                for d, r in (("cpu", cpu), ("gpu", gpu)):
                    off = abs(float(r["grads"][name]) - float(terms[d].sum()))
                    if not off <= (math.log2(terms[d].numel()) + 4) * 2**-24 * sums[d]:
                        raise AssertionError(f"{where}: {d} gradient of {name} is {off:.3e} off "
                                             f"its fields' contraction (S {sums[d]:.3e})")
                g_cpu = float(cpu["grads"][name])
                gap = abs(float(gpu["grads"][name]) - g_cpu)
                if not gap <= 1e-4 * sums["cpu"]:
                    raise AssertionError(f"{where}: the gradient of {name} is {gap:.3e} off "
                                         f"(1e-4 x S = {1e-4 * sums['cpu']:.3e})")
                readings.append({"seed": seed, "run": run, "tensor": name,
                                 "gap_over_S": gap / sums["cpu"], "gap_over_itself": gap / abs(g_cpu),
                                 "S_over_itself": sums["cpu"] / abs(g_cpu)})
    print(f"[11] (c) one step at 64x64, batch 2, GPU vs CPU, seeds {list(GRAD_SEEDS)} x "
          f"{GPU_RERUNS} runs on the card: loss within {loss_rel:.2e} relative; largest gradient "
          f"gap {worst:.2e} x max|g_cpu| ({worst_name}); {', '.join(ALPHAS)}: "
          f"{json.dumps(readings)}", flush=True)
    return {"loss_rel": loss_rel, "grad_rel": worst, "alpha_readings": readings}


def flow_tree(root: Path, n_seq: int, hw, seed: int):
    """A Vimeo-like flow tree: `n_seq` sequences of 4 `.flo` fields at
    `hw`, linked to 8 seeded smooth fields a name, listed for both splits."""
    rng = np.random.default_rng(seed)
    names = ("im1_im3", "im2_im3", "im2_im1", "im3_im1")
    distinct = root / "distinct"
    distinct.mkdir(parents=True)
    for name in names:
        for k in range(8):
            _, flow = seeded_flows(hw, int(rng.integers(1 << 30)))
            write_flo(str(distinct / f"{name}_{k}.flo"), flow[0, 0].numpy())
    seqs = [f"00001/{i:04d}" for i in range(n_seq)]
    for i, seq in enumerate(seqs):
        d = root / "flow_sequences" / seq
        d.mkdir(parents=True)
        for name in names:
            os.symlink(distinct / f"{name}_{i % 8}.flo", d / f"{name}.flo")
    for listing in ("tri_trainlist.txt", "tri_testlist.txt"):
        (root / listing).write_text("\n".join(seqs) + "\n")


def run_train_cli(smi: str) -> dict:
    """Phase 11 (d): `cli/train.py` on the card with the recipe's config and
    `--smoke-test` on a fabricated tree of 256x448 `.flo` triplets (Vimeo's
    frame size): one epoch (2 steps of 32 at the 256^2 crop, validation at
    256x448, a checkpoint), then `--resume` for a second; exact splat
    launches; steps run, seconds an epoch, and which writer it found."""
    cfg = load_config(RECIPE)
    n = cfg.experiment.batch_size
    root = WORK11 / "vimeo_triplet"
    flow_tree(root, 2 * n, GIMM_HW, SEED + 13)
    runs = WORK11 / "runs"
    argv = ["--config", RECIPE, "--result-path", str(runs), "--overrides",
            f"dataset.path={root}", "experiment.epochs=1", "--smoke-test"]
    out = []
    for label, args in (("first epoch", argv),
                        ("--resume", None)):
        if args is None:
            args = ["--config", RECIPE, "--result-path", out[0]["run_dir"], "--resume",
                    "--overrides", "experiment.epochs=2", "--smoke-test"]
        reset_counts()
        t0 = time.perf_counter()
        res = train_cli.main(args)
        seconds = time.perf_counter() - t0
        got = counts()
        # an epoch: 2 steps (2 forward and 2 backward splats each) and 2
        # validation batches (2 forward splats each)
        expect_counts(f"(d) train CLI, {label}", got, 8, splat_bwd=4, phase=11)
        epoch = res["epochs"][-1]
        numbers = [*epoch["train"].values(), *epoch["valid"].values()]
        if not all(math.isfinite(v) for v in numbers):
            raise AssertionError(f"[11] (d) {label}: {epoch}")
        print(f"[11] (d) train CLI {label}: {res['steps']} steps run in all, epoch "
              f"{epoch['epoch']} {epoch['seconds']:.2f} s, the call {seconds:.2f} s; train "
              f"{json.dumps(epoch['train'])}; valid {json.dumps(epoch['valid'])}; launches {got}; "
              f"writer {res['writer']}; {smi}", flush=True)
        out.append({**res, "seconds": seconds, "launches": got})
    log = (Path(out[0]["run_dir"]) / "train.log").read_text()
    ckpts = sorted(os.listdir(Path(out[0]["run_dir"]) / "ckpt"))
    if not (out[0]["steps"] == 2 and out[1]["steps"] == 4 and "resumed from step 2" in log
            and ckpts == ["step_2.pt", "step_4.pt"]):
        raise AssertionError(f"[11] (d) steps {out[0]['steps']}, {out[1]['steps']}; "
                             f"checkpoints {ckpts}")
    return {"steps": out[1]["steps"], "epoch_seconds": [o["epochs"][-1]["seconds"] for o in out],
            "call_seconds": [o["seconds"] for o in out],
            "writer": out[0]["writer"], "launches": out[0]["launches"]}


def run_phase11(smi: str) -> dict:
    """Phase 11: stage-1 GIMM training on the card, float32, TF32 off."""
    shutil.rmtree(WORK11, ignore_errors=True)
    WORK11.mkdir(parents=True)
    t0 = time.perf_counter()
    res = {"backward": check_backward(), "step": run_recipe_step(smi),
           "gpu_vs_cpu": check_step_gpu_vs_cpu(), "cli": run_train_cli(smi)}
    print(f"[11] phase 11 took {time.perf_counter() - t0:.2f} s", flush=True)
    return res


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
    torch.cuda.empty_cache()
    p10 = run_phase10(smi)
    torch.cuda.empty_cache()
    p11 = run_phase11(smi)
    # each kernel's launches on the phase 10 paths, each counted from 0
    p10_paths = {"gimm_forward": p10["gimm"]["forward"], "gimm_forward_multi": p10["gimm"][
        "forward_multi"], "video_cli": p10["video"], **p10["harnesses"]}
    p10_launches = {key: {k: v["launches"][key] for k, v in p10_paths.items()}
                    for key in ("splat", "tf32")}

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

    lk = f720["lookup"]
    records = [
        record(SPLAT_KERNEL, splat_launches, **kstats, **main_splat,
               launches_phase10=p10_launches["splat"],
               launches_phase11_step=p11["step"]["launches"]["splat"],
               train_shape_ms=p11["backward"]["forward_ms"],
               train_shape_device_ms=p11["backward"]["forward_device_ms"],
               train_shape_bound_ms=p11["backward"]["forward_bound_ms"],
               train_shape_library_ms=p11["backward"]["forward_library_ms"],
               train_shape_library_device_ms=p11["backward"]["forward_library_device_ms"]),
        # the training path's kernel: its launches in one recipe step
        # (phase 11 (b), counted from 0), its times at that step's shape
        record(SPLAT_BACKWARD_KERNEL, p11["step"]["launches"]["splat_bwd"],
               **{k: v for k, v in p11["backward"].items() if not k.startswith("forward_")},
               step_device_ms=p11["step"]["splat_bwd_device_ms"],
               launches_phase11_cli=p11["cli"]["launches"]["splat_bwd"]),
        record(WINDOWED_CORR_MMA_KERNEL, ds["c"]["windowed_launches"],
               max_abs_err=max(wstats["path_err"], ds["lookups"]["first"]["max_abs_err"],
                               ds["lookups"]["last"]["max_abs_err"]),
               max_abs_err_cases_bf16=wstats["max_abs_err_cases_bf16"],
               tolerance=wstats["tolerance"], **windowed_numbers("mma"),
               extent_in_frame=fmt_extent(wstats["in_frame"]),
               extent_smooth=fmt_extent(wstats["smooth"]),
               extent_path_first=fmt_extent(ds["lookups"]["first"])),
        # the float32 route, on the 720p F path: its launches there and its
        # times on that path's captured AMT lookup, beside the materialized
        # float32 lookup's (library_ms stays null: no PyTorch call computes
        # the lookup from the same inputs)
        record(WINDOWED_CORR_TF32_KERNEL, f720["tf32_launches"],
               launches_f32_gpu_vs_cpu={"r": ds["f32_windowed_launches"],
                                        "f": f_db["windowed"][1]},
               max_abs_err=max(f720["lookup_max_abs_err"],
                               *p10["video"]["lookup_max_abs_err"].values()),
               max_abs_err_phase10=p10["video"]["lookup_max_abs_err"],
               max_abs_err_cases_f32=wstats["max_abs_err_cases_f32"],
               tolerance=wstats["tolerance"], ms=lk["tf32_ms"], device_ms=lk["tf32_device_ms"],
               plain_ms=lk["plain_ms"], bound_ms=lk["tf32_bound_ms"], bound_by=lk["tf32_bound_by"],
               bytes_bound_ms=lk["bytes_bound_ms"], library_ms=None,
               materialized_ms=lk["materialized_ms"],
               materialized_device_ms=lk["materialized_device_ms"], extent=lk["extent"],
               decode_one_ms=f720["decode_turns"]["tf32"],
               launches_phase10=p10_launches["tf32"]),
        # the "before" kernel, on no path: its times on the same captured
        # lookup in the same run; the bf16_* times are the bf16 tensor-core
        # kernel's "before" at the 2K DS 1.0 lookups
        record(WINDOWED_CORR_KERNEL, f720["cuda_core_launches"],
               max_abs_err=lk["cuda_core_max_abs_err"],
               max_abs_err_cases_f32=wstats["cuda_core_max_abs_err_cases_f32"],
               max_abs_err_bf16_timed=max(wstats[k]["cuda_core_max_abs_err"]
                                          for k in PATH_KINDS + ("p720",)),
               tolerance=wstats["tolerance"], times_dtype="float32", ms=lk["cuda_core_ms"],
               device_ms=lk["cuda_core_device_ms"], plain_ms=lk["plain_ms"],
               bound_ms=lk["cuda_core_bound_ms"], bound_by=lk["cuda_core_bound_by"],
               library_ms=None, decode_one_ms=f720["decode_turns"]["cuda_core"],
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
    video, gimm = p10["video"], p10["gimm"]
    print(f"[10] GIMM {gimm['forward']['ms']:.3f} ms a forward, {gimm['ms_per_t']:.3f} ms a "
          f"forward_multi timestep; video CLI 720p float32 8x: "
          f"{', '.join(f'{ms:.2f}' for ms in video['pair_ms'])} ms a pair, peak "
          f"{video['peak_bytes'] / 2**20:.1f} MiB; harnesses "
          f"{json.dumps({k: v['result'] for k, v in p10['harnesses'].items()})}; {smi}",
          flush=True)
    step, cli = p11["step"], p11["cli"]
    print(f"[11] stage-1 training: {step['step_ms']:.2f} ms a recipe step (batch 32, 256x256), "
          f"peak {step['peak_bytes'] / 2**20:.1f} MiB; the splat backward "
          f"{fmt_ms(p11['backward']['device_ms'])} device against its "
          f"{p11['backward']['bound_ms']:.4f} ms bound; GPU vs CPU loss "
          f"{p11['gpu_vs_cpu']['loss_rel']:.2e}, gradients {p11['gpu_vs_cpu']['grad_rel']:.2e}; "
          f"the CLI {cli['steps']} steps, {', '.join(f'{x:.2f}' for x in cli['epoch_seconds'])} s "
          f"an epoch, PyYAML {yaml.__version__}, "
          f"tensorboardX {'found' if cli['writer'] == 'tensorboardX' else 'not found'}; {smi}",
          flush=True)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
