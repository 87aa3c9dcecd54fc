"""Where FlowFormer's time goes on the card: CUDA events around each of its
submodules and its cost-window lookup, then the kernels by device time.

    python -m gimmvfi_tpu_torch.tools.flowformer_profile [--iters 32] [--size 736x1280]

Card only: without CUDA `main` raises. FlowFormer(iters) with random
weights (`init_normal_`, seed 0) on a seeded random pair of `--size`
(HxW), both directions batched as GIMMVFI_F runs it, float32, TF32 off.
After one warm-up: one forward timed alone; one with a CUDA event pair
around every module up to three levels deep (and the decoder's update
block, cross-attention, vertical blocks, patch embed and input layer one
level further) and around each `corr_lookup`, printed by total ms with
their call counts (a parent's row holds its children's); then the ten
kernels with the most device time in a `torch.profiler` trace of one more
forward; then the motion encoder's two float32 3x3 convs over 256
channels alone, through cuDNN and as the GEMM FlowFormer uses
(`GemmConv2d`), with the same weights.
"""

from __future__ import annotations

import argparse
import collections

import torch

from ..flow import flowformer as ff
from ..nn.layers import Conv2d, GemmConv2d, init_normal_
from ..utils.timing import cuda_ms, per_call_ms

DEEPER = ("update_block.", "cross_attend", "local_block", "global_block", "patch_embed",
          "input_layer")


def hooked_modules(model: torch.nn.Module) -> dict[torch.nn.Module, str]:
    """The modules timed: all to three dots deep, the `DEEPER` ones to five."""
    names = {}
    for name, mod in model.named_modules():
        depth = name.count(".")
        if depth <= 3 or (depth <= 5 and any(k in name for k in DEEPER)):
            names[mod] = name or "FlowFormer"
    return names


def stage_ms(model, image1, image2) -> list[tuple[float, int, str]]:
    """(total ms, calls, name) of every hooked module and of `corr_lookup`
    over one bidirectional forward, most time first."""
    names = hooked_modules(model)
    open_events, spans = collections.defaultdict(list), collections.defaultdict(list)

    def start(mod, _):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        open_events[mod].append(ev)

    def stop(mod, _, __):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans[names[mod]].append((open_events[mod].pop(), ev))

    lookup = ff.corr_ops.corr_lookup

    def timed_lookup(*args, **kwargs):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = lookup(*args, **kwargs)
        e.record()
        spans["corr_lookup"].append((s, e))
        return out

    hooks = [h for mod in names for h in (mod.register_forward_pre_hook(start),
                                          mod.register_forward_hook(stop))]
    ff.corr_ops.corr_lookup = timed_lookup
    try:
        model(image1, image2, bidir=True)
        torch.cuda.synchronize()
    finally:
        ff.corr_ops.corr_lookup = lookup
        for h in hooks:
            h.remove()
    return sorted(((sum(s.elapsed_time(e) for s, e in v), len(v), k) for k, v in spans.items()),
                  reverse=True)


def motion_conv_ms(h: int, w: int) -> list[dict]:
    """The motion encoder's two 3x3 convs over 256 channels at the 1/8 grid
    of a bidirectional (h, w) pair, float32: cuDNN (`Conv2d`) and the GEMM
    (`GemmConv2d`) with the same seeded weights, CUDA-event ms (median of
    3) and their max-abs difference; prints a line for each."""
    rows = []
    gen = torch.Generator(device="cpu").manual_seed(2)
    for cin, cout in ((256, 192), (256, 126)):
        cudnn = Conv2d(cin, cout, 3, 1, 1)
        gemm = GemmConv2d(cin, cout, 3, 1, 1)
        init_normal_(cudnn, 3)
        gemm.load_state_dict(cudnn.state_dict())
        cudnn, gemm = cudnn.cuda(), gemm.cuda()
        x = torch.randn((2, cin, h // 8, w // 8), generator=gen).cuda()
        row = {"shape": (2, cin, h // 8, w // 8), "cout": cout,
               "cudnn_ms": cuda_ms(lambda: cudnn(x), iters=3),
               "gemm_ms": cuda_ms(lambda: gemm(x), iters=3),
               "max_abs_diff": float((cudnn(x) - gemm(x)).abs().max())}
        print(f"conv {row['shape']} -> {cout} 3x3 float32: cuDNN {row['cudnn_ms']:.3f} ms, "
              f"GEMM {row['gemm_ms']:.3f} ms, max-abs difference {row['max_abs_diff']:.2e}",
              flush=True)
        rows.append(row)
    return rows


@torch.inference_mode()
def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m gimmvfi_tpu_torch.tools.flowformer_profile")
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--size", default="736x1280", help="HxW")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this profile needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    h, w = (int(s) for s in args.size.split("x"))
    model = init_normal_(ff.FlowFormer(args.iters), 0).eval()
    gen = torch.Generator(device="cpu").manual_seed(1)
    image1, image2 = ((torch.rand((1, 3, h, w), generator=gen) * 255).cuda() for _ in range(2))
    model(image1, image2, bidir=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    model(image1, image2, bidir=True)
    end.record()
    end.synchronize()
    forward_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated()
    print(f"FlowFormer({args.iters}) {h}x{w} bidirectional float32: {forward_ms:.2f} ms, peak "
          f"allocated {peak / 2**20:.1f} MiB", flush=True)
    rows = stage_ms(model, image1, image2)
    for ms, calls, name in rows:
        print(f"{ms:10.2f} ms {calls:4d} calls  {name}", flush=True)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        model(image1, image2, bidir=True)
        torch.cuda.synchronize()
    kernels = sorted(per_call_ms(prof.key_averages(), 1).items(), key=lambda kv: -kv[1])[:10]
    for name, ms in kernels:
        print(f"{ms:10.2f} ms device  {name[:100]}", flush=True)
    convs = motion_conv_ms(h, w)
    return {"forward_ms": forward_ms, "peak_bytes": peak, "stages": rows, "kernels": kernels,
            "motion_convs": convs}


if __name__ == "__main__":
    main()
