"""Interpolated frames per second of the port's 8x path, GIMM-VFI-R or
GIMM-VFI-F, on one CUDA card: the counterpart of the repo's `bench.py`.

    python -m gimmvfi_tpu_torch.bench [--model r|f] [--size 736x1280]
        [--ds 0.5] [--f32] [--profile] [--append-results]

`--model r` builds GIMMVFI_R(raft_iters=20), `--model f`
GIMMVFI_F(ff_iters=32); bf16 unless `--f32`; random weights (normal 0.02
from a seed, `init_normal_`) and a seeded random frame pair of `--size`
(HxW), 7 timesteps through `interpolate_sequential`, with DS_SCALE
`--ds`. TF32 is off. One warm-up call, then the median of 3 calls timed
with CUDA events (their min and max on an earlier line). `--profile` first
prints the stage split of one more pair: `prepare`, each `decode_one`, and
the flow estimator alone. The last line is one JSON object with the JAX
bench's metric label (`interp_frames_per_sec_720p_8x`, or
`interp_frames_per_sec_{size}_ds{ds}_8x`; `_f` appended for F), the
allocator's peak (`peak_mib`) and the card's name and power limit from
`nvidia-smi`. `--append-results` appends that line to
`bench_results_torch.jsonl` (never to `bench_results.jsonl`, the TPU
record).

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

from .models.gimmvfi_f import GIMMVFI_F
from .models.gimmvfi_r import GIMMVFI_R, interpolate_sequential
from .nn.layers import init_normal_

N_T = 7  # 8x: 7 frames between the pair
TIMED_CALLS = 3
SEED = 0
RESULTS_PATH = Path(__file__).resolve().parent.parent / "bench_results_torch.jsonl"


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
        model = GIMMVFI_F(ff_iters=32, dtype=dtype, device=device)
    else:
        model = GIMMVFI_R(raft_iters=20, dtype=dtype, device=device)
    return init_normal_(model, SEED)


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
    record = {
        "metric": metric_label(args.model, args.size, args.ds),
        "value": round(N_T / (median_ms / 1e3), 4),
        "unit": "frames/sec",
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
