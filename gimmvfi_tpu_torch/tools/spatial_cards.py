"""Spatial sharding across the cards of one node: an 8x pair's frames per
second, stage split and peak memory a rank at world 1, 2 and 4.

    torchrun --standalone --nproc_per_node 4 -m gimmvfi_tpu_torch.tools.spatial_cards \
        [--model r|f] [--repeats 3]

One rank a card, NCCL (`--device cpu`: gloo ranks on the CPU, for a
rehearsal at a small `--points` and `--raft-iters` / `--ff-iters`). For
each point (`--points`, HxW, default 2048x1088 and 4096x2176 at DS 1.0
for R, 2048x1088 for F) the ranks build GIMMVFI_R(raft_iters=20,
dtype=bfloat16), or with `--model f` GIMMVFI_F(ff_iters=32,
dtype=bfloat16), without remat as the inference entry points, with
seeded weights and a seeded pair, 7 timesteps; for each world w of 1, 2 and the node's ranks (1 alone on one card), the
first w ranks (a subgroup; the others wait) run
`parallel/spatial.py: interpolate_spatial_sharded`: one warm-up call,
then `--repeats` calls timed by CUDA events (fps = 7 / the call, the
median), `prepare_sharded` alone timed as many times (decode ms a
timestep = (call - prepare) / 7, medians) and its sharded flow estimator
alone (`RAFT.forward_sharded` or `FlowFormer.forward_sharded`; the
replicated rest is prepare - the flow estimator), and the peak allocated
bytes of each rank over the timed calls. Rank 0 holds world w's
imgt_pred against world 1's (>= 50 dB; bf16 convs of other widths may
take other cuDNN algorithms). A world whose call runs out of device
memory is recorded as such, and the worlds above it still run (unchecked
without world 1). Rank 0 prints a line a reading, with the cards' names
and power limits, and one JSON line last.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess

import numpy as np
import torch
import torch.distributed as dist

from ..bench import timed
from ..models.gimmvfi_f import GIMMVFI_F
from ..models.gimmvfi_r import GIMMVFI_R
from ..nn.layers import init_normal_
from ..parallel import dist as dist_ops
from ..parallel.spatial import interpolate_spatial_sharded, pad_width, strip_bounds

N_T = 7
SEED = 0
MIN_DB = 50.0


def psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(((a.float() - b.float()) ** 2).mean())
    return float("inf") if mse == 0 else float(10 * np.log10(1.0 / mse))


def run_world(model, img_xs, ts, group, repeats: int, device: torch.device) -> dict:
    """The readings of one world on this rank (module docstring)."""
    interpolate_spatial_sharded(model, img_xs, ts, None, group)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    padded = pad_width(img_xs, dist.get_world_size(group))
    pair = [255.0 * padded[:, i].permute(0, 3, 1, 2).float() for i in range(2)]
    strips = strip_bounds(padded.shape[3] // 8, dist.get_world_size(group), 1)
    calls, prepares, rafts = [], [], []
    for _ in range(repeats):
        out, ms = timed(lambda: interpolate_spatial_sharded(model, img_xs, ts, None, group), device)
        calls.append(ms)
        with torch.inference_mode():
            _, ms = timed(lambda: model.prepare_sharded(padded, None, group), device)
            prepares.append(ms)
            _, ms = timed(lambda: model.flow_estimator.forward_sharded(*pair, strips, group),
                          device)
            rafts.append(ms)
    call, prep = statistics.median(calls), statistics.median(prepares)
    return {"fps": len(ts) / (call / 1000), "call_ms": calls, "prepare_ms": prepares,
            "flow_sharded_ms": rafts, "rest_ms": prep - statistics.median(rafts),
            "decode_ms": (call - prep) / len(ts),
            "peak_bytes": torch.cuda.max_memory_allocated() if device.type == "cuda" else 0,
            "imgt_pred": out["imgt_pred"].cpu()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="torchrun ... -m gimmvfi_tpu_torch.tools.spatial_cards",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=("r", "f"), default="r",
                   help="r = GIMM-VFI-R (RAFT flow), f = GIMM-VFI-F (FlowFormer flow)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--points", default=None,
                   help="frame sizes HxW (default 1088x2048,2176x4096 for r, 1088x2048 for f)")
    p.add_argument("--raft-iters", type=int, default=20)
    p.add_argument("--ff-iters", type=int, default=32)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    points = args.points or ("1088x2048,2176x4096" if args.model == "r" else "1088x2048")
    family, iters = ((GIMMVFI_R, args.raft_iters) if args.model == "r"
                     else (GIMMVFI_F, args.ff_iters))
    if not dist_ops.launched():
        raise RuntimeError("spatial_cards runs under torchrun, one rank a card")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("spatial_cards runs on CUDA cards (--device cpu for a rehearsal)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    topo = dist_ops.init(args.device)
    device, rank, world = topo.device, topo.rank, topo.world
    cards = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip().splitlines()
             if device.type == "cuda" else ["cpu"])
    worlds = sorted({1, min(2, world), world})
    # every rank creates every subgroup, in one order
    groups = {w: dist.new_group(list(range(w))) for w in worlds}
    ts = [(i + 1) / (N_T + 1) for i in range(N_T)]
    readings = []
    try:
        for point in points.split(","):
            h, w = (int(x) for x in point.split("x"))
            model = init_normal_(family(iters, dtype=torch.bfloat16, device=device, remat=False),
                                 SEED)
            gen = torch.Generator(device="cpu").manual_seed(SEED + 1)
            img_xs = torch.rand((1, 2, h, w, 3), generator=gen).to(device)
            ref = None
            for w_ranks in worlds:
                res = {"model": family.__name__, "point": f"{w}x{h}", "ds": 1.0,
                       "world": w_ranks}
                status = torch.zeros(1, device=device)
                if rank < w_ranks:
                    try:
                        got = run_world(model, img_xs, ts, groups[w_ranks], args.repeats, device)
                    except torch.cuda.OutOfMemoryError as e:
                        got = {"out_of_memory": str(e).splitlines()[0]}
                        status += 1
                    gc.collect()
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
                else:
                    got = {}
                dist.all_reduce(status)
                peaks = [torch.zeros(1, dtype=torch.float64, device=device) for _ in range(world)]
                dist.all_gather(peaks, torch.tensor([float(got.get("peak_bytes", 0))],
                                                    dtype=torch.float64, device=device))
                if rank == 0:
                    img = got.pop("imgt_pred", None)
                    res.update(got)
                    res["peak_bytes_a_rank"] = [float(x) for x in peaks[:w_ranks]]
                    if float(status):
                        res["out_of_memory"] = res.get("out_of_memory", "on another rank")
                    elif w_ranks == 1:
                        ref = img
                    elif ref is not None:
                        res["db_vs_world1"] = psnr(img, ref)
                    print(f"{family.__name__}({iters}) {res['point']} DS 1.0 bf16 8x on "
                          f"{w_ranks} rank(s): "
                          + (f"out of memory ({res['out_of_memory']})" if "out_of_memory" in res
                             else f"{res['fps']:.4f} fps (median of {args.repeats}; calls "
                                  f"{', '.join(f'{x:.2f}' for x in res['call_ms'])} ms), prepare "
                                  f"{statistics.median(res['prepare_ms']):.2f} ms (the flow "
                                  f"estimator sharded "
                                  f"{statistics.median(res['flow_sharded_ms']):.2f}, the "
                                  f"replicated rest {res['rest_ms']:.2f}), decode "
                                  f"{res['decode_ms']:.2f} ms a timestep, peak a rank "
                                  f"{', '.join(f'{x / 2**20:.1f}' for x in res['peak_bytes_a_rank'])} "
                                  f"MiB"
                                  + (f", {res['db_vs_world1']:.2f} dB against world 1"
                                     if "db_vs_world1" in res else ""))
                          + f"; {cards}", flush=True)
                    readings.append(res)
                dist_ops.barrier()
            del model, img_xs, ref
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist_ops.shutdown()
    out = {"world": world, "cards": cards, "readings": readings}
    if rank == 0:
        bad = [r for r in readings if "db_vs_world1" in r and not r["db_vs_world1"] >= MIN_DB]
        print(json.dumps(out))
        if bad:
            raise AssertionError(f"below {MIN_DB} dB against world 1: {bad}")
    return out


if __name__ == "__main__":
    main()
