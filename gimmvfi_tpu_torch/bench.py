"""Interpolated frames per second of the port's 8x path, GIMM-VFI-R or
GIMM-VFI-F, on one CUDA card: the counterpart of the repo's `bench.py`.

    python -m gimmvfi_tpu_torch.bench [--model r|f] [--size 736x1280]
        [--ds 0.5] [--f32] [--profile] [--trace-dir DIR] [--append-results]

`--model r` builds GIMMVFI_R(raft_iters=20), `--model f`
GIMMVFI_F(ff_iters=32), both without remat as JAX's bench does; bf16
unless `--f32`; random weights (normal 0.02 from a seed, `init_normal_`)
and a seeded random frame pair of `--size` (HxW), 7 timesteps through
`interpolate_sequential`, with DS_SCALE `--ds`. TF32 is off. One warm-up
call, then the median of 3 calls timed with CUDA events (their min and max
on an earlier line). `--profile` first prints the stage split of one more
pair: `prepare`, each `decode_one`, and the flow estimator alone.
`--trace-dir DIR` writes a `torch.profiler` Chrome trace (CPU and, on the
card, CUDA activity) of one more call after the warm-up, untimed, as the
JAX bench's `--trace-dir` does: `prepare` and each `decode_one` sit in
spans of those names (`interpolate_sequential`); its path is printed. The
last line is one JSON object with the JAX bench's metric label
(`interp_frames_per_sec_720p_8x`, or
`interp_frames_per_sec_{size}_ds{ds}_8x`; `_f` appended for F), the
allocator's peak (`peak_mib`) and the card's name and power limit from
`nvidia-smi`. `--append-results` appends that line to
`bench_results_torch.jsonl` (never to `bench_results.jsonl`, the TPU
record).

After the timed calls and the peak, one more call, untimed, is counted
(`pipeline_flops`): the record gains the JAX bench's four fields
(`bench.py:285-297`): `pipeline_tflops`, `v100_speed_of_light_fps` (the
fps a V100 would reach doing that work at its published float32 peak,
`V100_F32_PEAK_FLOPS`, with every gather free: the reference runs on a
V100 in float32), `vs_baseline` (fps over that bound) and
`baseline_is_flop_bound`, and the exact count, `pipeline_flops`. The line
before the record gives the achieved TFLOP/s (the count times fps over
7) with the card's name and power limit. `--profile` also prints the
count of `prepare` and of one `decode_one`.

`--device cpu` is for the CPU tests only: it times with the host clock and
has no card, peak or power limit. The default is the card, and without one
the bench raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

from .models.gimmvfi_f import GIMMVFI_F
from .models.gimmvfi_r import GIMMVFI_R, interpolate_sequential
from .nn.layers import init_normal_
from .ops import corr as corr_ops

N_T = 7  # 8x: 7 frames between the pair
TIMED_CALLS = 3
SEED = 0
RESULTS_PATH = Path(__file__).resolve().parent.parent / "bench_results_torch.jsonl"
# The V100's published float32 peak (15.7 TFLOP/s), the reference's card,
# as the JAX bench defines it (`bench.py:26`): the denominator of its
# speed-of-light bound, not a number measured here.
V100_F32_PEAK_FLOPS = 15.7e12
WINDOWED_LOOKUP_OP = "windowed_corr_lookup"  # the count's key for the lookups' dots


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gimmvfi_tpu_torch.bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=("r", "f"), default="r",
                   help="r = GIMM-VFI-R (RAFT flow), f = GIMM-VFI-F (FlowFormer flow)")
    p.add_argument("--size", default="736x1280", help="frame size HxW (720p padded to /32)")
    p.add_argument("--ds", type=float, default=None,
                   help="DS_SCALE working-resolution factor, e.g. --size 1088x2048 --ds 0.5")
    p.add_argument("--f32", action="store_true", help="float32 compute (default bf16)")
    p.add_argument("--profile", action="store_true",
                   help="print the prepare / decode_one / flow-estimator split first")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace of one call into this directory")
    p.add_argument("--append-results", action="store_true",
                   help=f"append the JSON line to {RESULTS_PATH.name}")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda (default); cpu only for the CPU tests")
    return p.parse_args(argv)


def metric_label(model: str, size: str, ds: float | None) -> str:
    """The JAX bench's label for this run (`bench.py:299-305`)."""
    label = ("interp_frames_per_sec_720p_8x" if size == "736x1280" and not ds
             else f"interp_frames_per_sec_{size}_ds{ds or 1}_8x")
    return label if model == "r" else f"{label}_{model}"


def card_info() -> tuple[str, str]:
    """The card's name and power limit as `nvidia-smi` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    name, limit = out.strip().splitlines()[0].split(", ")
    return name, limit


def timed(fn, device: torch.device):
    """(fn(), its ms): CUDA events around it on the card, the host clock on
    the CPU, where the work is done when fn returns."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def build(args, device: torch.device) -> GIMMVFI_R:
    dtype = None if args.f32 else torch.bfloat16
    if args.model == "f":
        model = GIMMVFI_F(ff_iters=32, dtype=dtype, device=device, remat=False)
    else:
        model = GIMMVFI_R(raft_iters=20, dtype=dtype, device=device, remat=False)
    return init_normal_(model, SEED)


def write_trace(run, args, device: torch.device) -> Path:
    """One call of `run` under `torch.profiler` (CPU activity, and CUDA on
    the card), exported as a Chrome trace into `args.trace_dir`; prints
    and returns its path. The call is not one of the timed ones."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run()
        if device.type == "cuda":
            torch.cuda.synchronize()
    out = Path(args.trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / (f"bench_{args.model}_{args.size}_ds{args.ds or 1}_"
                  f"{'f32' if args.f32 else 'bf16'}.trace.json")
    prof.export_chrome_trace(str(path))
    print(f"trace of one call (spans prepare, decode_one): {path}", flush=True)
    return path


def count_flops(model: torch.nn.Module, fn) -> dict:
    """The FLOPs of one call of `fn()` by `torch.utils.flop_counter`: the
    products of matmuls and convolutions (sdpa too), two a multiply-add.
    Returns {op name: FLOPs} (an op's total over the call).

    What it leaves out: elementwise work, resizes, pooling and bilinear
    lookups (`grid_sample` is a gather) and the splat, on every device.
    The JAX bench's count (XLA's cost analysis) counts elementwise work
    too, and the JAX package's TPU formulations of gathers as the dots
    they are there: `ops/corr.py: corr_lookup`'s tent einsums,
    `ops/interp.py: bilinear_sample`'s corner-weight einsum; the splat's
    Pallas kernel counts nothing there. `flow/raft.py:
    convex_upsample_8x` is an einsum there and a broadcast product here.
    A float32 `GemmConv2d` counts as its matmul, the same number as the
    conv.

    A windowed correlation lookup (`ops/corr.py: windowed_corr_lookup`)
    is charged the dots of `windowed_corr_work` on its inputs, the work
    its kernel's bound counts, under the key `WINDOWED_LOOKUP_OP`, and its
    own ops run outside the count: the card's kernel is invisible to the
    counter and the CPU's plain version would count its own formulation,
    so the count is the same on both devices. The parameters are set not
    to need grad while it counts (and restored after): the counter's module
    tracker fails on an expanded Parameter under inference mode."""
    counter = FlopCounterMode(display=False)
    lookup = corr_ops.windowed_corr_lookup

    def charged(wc, coords, radius=4):
        counter.flop_counts["Global"][WINDOWED_LOOKUP_OP] += corr_ops.windowed_corr_work(
            wc, coords, radius)[1]
        registry, counter.flop_registry = counter.flop_registry, {}
        try:
            return lookup(wc, coords, radius)
        finally:
            counter.flop_registry = registry

    trained = [p for p in model.parameters() if p.requires_grad]
    corr_ops.windowed_corr_lookup = charged
    try:
        for p in trained:
            p.requires_grad_(False)
        with counter:
            fn()
    finally:
        corr_ops.windowed_corr_lookup = lookup
        for p in trained:
            p.requires_grad_(True)
    return {str(op): n for op, n in counter.get_flop_counts().get("Global", {}).items()}


def pipeline_flops(model: GIMMVFI_R, img_xs, ts, ds) -> int:
    """The FLOPs of one 8x call, `interpolate_sequential(model, img_xs, ts,
    ds)`, counted eagerly as `count_flops` counts (the counterpart of the
    JAX bench's `pipeline_flops`, which composes its count from parts only
    because XLA counts a scan body once). The call runs once more, untimed."""
    return sum(count_flops(model, lambda: interpolate_sequential(model, img_xs, ts, ds)).values())


def flop_fields(flops: int, fps: float, n_t: int) -> dict:
    """The JAX bench's four fields for a pipeline of `n_t` frames and
    `flops` run at `fps`, and the exact count."""
    v100_fps = n_t * V100_F32_PEAK_FLOPS / flops
    return {"pipeline_tflops": round(flops / 1e12, 2),
            "v100_speed_of_light_fps": round(v100_fps, 3),
            "vs_baseline": round(fps / v100_fps, 3),
            "baseline_is_flop_bound": True,
            "pipeline_flops": flops}


@torch.inference_mode()
def profile_stages(model: GIMMVFI_R, img_xs, ts, ds, device) -> dict:
    """One more pair in stages: `prepare`, each `decode_one`, and the flow
    estimator alone on the working-size pair; prints and returns the ms."""
    prep, prep_ms = timed(lambda: model.prepare(img_xs, ds), device)
    decode = [timed(lambda tv=tv: model.decode_one(prep, tv), device)[1] for tv in ts]
    img0, img1 = 255.0 * prep["img0"], 255.0 * prep["img1"]
    _, flow_ms = timed(lambda: model.bidir_flow(img0, img1), device)
    name = type(model.flow_estimator).__name__
    split = {"prepare_ms": prep_ms, "decode_ms": statistics.mean(decode), "flow_ms": flow_ms}
    print(f"prepare (flow, features, correlation, latents): {prep_ms:.2f} ms", flush=True)
    print(f"decode_one (splat + INR + AMT synthesis): mean {split['decode_ms']:.2f} ms over "
          f"{len(ts)} calls (min {min(decode):.2f}, max {max(decode):.2f})", flush=True)
    print(f"flow estimator alone ({name}, both directions): {flow_ms:.2f} ms", flush=True)
    print(f"=> modeled total for {len(ts)} frames: {prep_ms + sum(decode):.2f} ms", flush=True)
    split["prepare_flops"] = sum(count_flops(model, lambda: model.prepare(img_xs, ds)).values())
    split["decode_flops"] = sum(count_flops(model, lambda: model.decode_one(prep, ts[0])).values())
    print(f"FLOPs: prepare {split['prepare_flops']}, one decode_one (t={ts[0]}) "
          f"{split['decode_flops']}", flush=True)
    return split


def main(argv=None) -> dict:
    """Run the bench; returns the record that its last line prints."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench needs a CUDA card (--device cpu is for the CPU tests only)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = (int(s) for s in args.size.split("x"))
    model = build(args, device)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
    # loading the frames is set-up: they are on the device before the clock starts
    img_xs = torch.rand((1, 2, h, w, 3), generator=gen).to(device)
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]

    def run():
        return interpolate_sequential(model, img_xs, ts, args.ds)["imgt_pred"]

    run()  # warm-up
    if args.profile:
        profile_stages(model, img_xs, ts, args.ds, device)
    if args.trace_dir:
        write_trace(run, args, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    pair_ms = [timed(run, device)[1] for _ in range(TIMED_CALLS)]
    fps = [N_T / (ms / 1e3) for ms in pair_ms]
    median_ms = statistics.median(pair_ms)
    print(f"{TIMED_CALLS} calls of {N_T} frames: median {median_ms:.2f} ms a pair; fps min "
          f"{min(fps):.4f}, max {max(fps):.4f}", flush=True)

    name = power_limit = peak_mib = None
    if device.type == "cuda":
        name, power_limit = card_info()
        peak_mib = round(torch.cuda.max_memory_allocated() / 2**20, 1)
    # counted after the timed calls and the peak, so that it moves neither
    flops = pipeline_flops(model, img_xs, ts, args.ds)
    value = N_T / (median_ms / 1e3)
    print(f"pipeline FLOPs {flops} ({flops / 1e12:.4f} TFLOP a pair); achieved "
          f"{flops / (median_ms / 1e3) / 1e12:.2f} TFLOP/s at the median; "
          f"{name or args.device}, power limit {power_limit or 'none'}", flush=True)
    record = {
        "metric": metric_label(args.model, args.size, args.ds),
        "value": round(value, 4),
        "unit": "frames/sec",
        **flop_fields(flops, value, N_T),
        "dtype": "float32" if args.f32 else "bfloat16",
        "peak_mib": peak_mib,
        "name": name,
        "power_limit": power_limit,
        "device": args.device,
    }
    line = json.dumps(record)
    print(line, flush=True)
    if args.append_results:
        with open(RESULTS_PATH, "a") as f:
            f.write(line + "\n")
    return record


if __name__ == "__main__":
    main()
