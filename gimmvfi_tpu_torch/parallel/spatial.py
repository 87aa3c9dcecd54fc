"""Spatial sharding: one frame pair interpolated with its work split by
frame width over the ranks of a process group
(`gimmvfi_tpu/parallel/spatial.py: interpolate_spatial_sharded`).

The JAX package shards the width over a mesh axis and lets GSPMD partition
all of `interpolate_sequential`, with a halo exchange at every conv. The
port shards the work that grows with the width: the flow estimator (most
of `prepare`) with a halo exchange an iteration, and the full-resolution
decode, whose halos are recomputed so that it exchanges nothing. On every
rank of the group (one process a card under `torchrun`, NCCL; `dist.py`),
per pair:

  1. `GIMMVFI_R.prepare_sharded`: the DS resize whole; the flow estimator
     on the rank's strip of 1/8-scale columns, its flows and features
     gathered whole: for R, `RAFT.forward_sharded` (the encoders on a
     window with halo 7 and whole-frame instance-norm statistics, the
     correlation state of the strip's queries against the whole other
     map, the 20-iteration loop with one halo exchange of 14 columns an
     iteration, the convex upsample); for F, `FlowFormer.forward_sharded`
     (the Twins encoders whole, the cost rows of the strip's queries of
     each direction against the whole other map, the cost perceiver on
     them with a halo of 6 for the local vertical attention and the
     global one's keys from the gathered map, the 32-iteration decoder on
     the strip with GMA's attention of its window's rows, a halo exchange
     of 14 columns and a gather of the motion features an iteration);
     then replicated: the 1x1 projections (R) and the AMT's correlation
     state, `normalize_flow`, the motion latents, the splat weights and
     `f8_up` / `f4_up`. Every later read of a whole frame is served from
     it;
and per timestep:
  2. replicated: both latent splats on the whole frame, so a splat whose
     target crosses a strip edge needs nothing special;
  3. sharded, halo R1: the latent refiner on the rank's strip +- R1
     working columns, the HypoNet at the strip's points of the whole
     grid (`GIMMVFI_R.flow_strip`); one `gather_disjoint` gives every rank
     the whole flow (steps 2-5 are `GIMMVFI_R.decode_strip`);
  4. replicated: the AMT at 1/8 and 1/4 scale (`synthesize_quarter`),
     1/16 of the pixels; the aux `img_warp_4`, which
     `interpolate_sequential` does not return, is not computed;
  5. sharded, halo R2: the MultiFlowDecoder on the strip +- R2 of the 1/4
     state, the DS upsample and the combine, cropped to the strip
     (`synthesize_strip`); the warps read the replicated `f4_up` and frames
     at global positions;
and after the last timestep one `gather_disjoint` of the image strips.

Strips (`strip_bounds`) start on the grid of 4 working columns, the
MultiFlowDecoder's 1/4 scale, so the x4 resize of a window is the same
map as the whole frame's; the full-resolution start is start / ds, an
integer for DS 1, 0.5 and 0.25. RAFT's strips are even ones of the
1/8-scale columns, so its strided convs see windows on their own grid.

Halos (`halos`). A stage's output at column x is exact when its window
holds, computed exactly, every column x depends on. A conv of kernel k
reads k // 2 columns on each side (zeros or reflections past a window
edge, which stay within that reach of it); pointwise ops read none; a
warp reads a whole replicated source at global positions. Every path
through a module passes each of its convs at most once, so the sum of
k // 2 over its convs bounds its reach (`receptive_radius`; a strided
stack's is `strided_reach`, `RAFT.halos`):
  * R1, the refiner (`gimm_core.py: latent_refiner`): two 3x3 convs, a
    LateralBlock of two, the reflect 3x3: 5, so 8 on the grid;
  * R2, in working columns: the decoder's conv block (a 3x3, three
    ResBlocks of five chained 3x3, a 3x3) 17; the x4 bilinear resize of
    the 1/4 state, which reads the next 1/4-scale column and clamps at a
    window edge, 4; under DS the x(1/ds) resize to full resolution, which
    reads the next working column, 1; the combine's two 7x7 convs, 6
    full-resolution columns, ceil(6 ds) working ones. 27 at DS 1 and 25
    at DS 0.5, so 28; 24 at DS 0.25.
A window that reaches the true image border ends there, where its
padding and resize clamps are the frame's own. `tests/test_torch_spatial.py`
holds the stitched strips against one window and the sharded `prepare`
against one process's, and shows that halos of 0 miss.
"""

from __future__ import annotations

import functools
import gc
import math
import os
import time

import torch
import torch.distributed as dist

from ..nn.layers import receptive_radius
from ..ops import corr as corr_ops
from ..ops import softsplat as softsplat_ops
from . import dist as dist_ops

GRID = 4  # the MultiFlowDecoder's 1/4 scale, in working columns


def _on_grid(x: int) -> int:
    return -(-x // GRID) * GRID


def halos(model, ds_factor: float | None = None) -> tuple[int, int]:
    """(R1, R2) in working columns, on the grid: the refiner's halo and the
    full-resolution decode's (module docstring)."""
    ds = 1.0 if ds_factor is None else ds_factor
    r1 = receptive_radius(model.res_conv)
    r2 = (receptive_radius(model.amt_final_decoder.convblock) + GRID
          + math.ceil(receptive_radius(model.amt_comb_block) * ds) + (ds != 1))
    return _on_grid(r1), _on_grid(r2)


def strip_bounds(width: int, world: int, grid: int = GRID) -> list[tuple[int, int]]:
    """`world` strips (a, b) of the columns [0, width), starts on the grid
    (of 4 working columns by default), as even as the grid allows."""
    if width % grid:
        raise ValueError(f"the width {width} is not a multiple of {grid}")
    units = width // grid
    edges = [grid * (units * r // world) for r in range(world + 1)]
    return list(zip(edges[:-1], edges[1:]))


def window(strip: tuple[int, int], halo: int, width: int) -> tuple[int, int]:
    """The strip widened by `halo` on each side, inside [0, width)."""
    return max(0, strip[0] - halo), min(width, strip[1] + halo)


def _rank_world(group) -> tuple[int, int]:
    if not dist_ops.group_up():
        if group is not None:
            raise ValueError("a group was given but no process group is up")
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def pad_width(img_xs, world: int) -> torch.Tensor:
    """img_xs (N, 2, H, W, 3) edge-padded on W to a multiple of
    lcm(world, 8), as the JAX function pads."""
    img_xs = torch.as_tensor(img_xs)
    mult = math.lcm(world, 8)
    pad = -(-img_xs.shape[3] // mult) * mult - img_xs.shape[3]
    if pad:
        img_xs = torch.cat([img_xs, img_xs[:, :, :, -1:].expand(-1, -1, -1, pad, -1)], dim=3)
    return img_xs


def interpolate_spatial_sharded(model, img_xs, t_values, ds_factor: float | None = None,
                                group=None) -> dict:
    """Nx interpolation of one pair with the width split over the ranks of
    `group` (the default group if None; with no group up, one rank).

    img_xs (N, 2, H, W, 3) in [0, 1]. Every parameter and buffer is first
    broadcast from the group's rank 0. W is edge-padded to a multiple of
    lcm(world, 8), as the JAX function pads (`pad_width`); `prepare_sharded`
    (the flow estimator on a strip a rank) runs on the padded pair; the outputs are cropped back,
    `imgt_pred` (T, N, H, W, 3) to W and `flowt` (T, N, h, w', 2) to
    int(W * ds). Every rank gets the whole result, on its device. Equals
    `interpolate_sequential` on the padded pair up to float rounding."""
    rank, world = _rank_world(group)
    if world > 1:
        dist_ops.broadcast_module_(model, group)
    w = torch.as_tensor(img_xs).shape[3]
    img_xs = pad_width(img_xs, world)
    w_full = img_xs.shape[3]
    with torch.inference_mode():
        prep = model.prepare_sharded(img_xs, ds_factor, group)
        h, wk = prep["img0"].shape[2:]
        scale = w_full // wk
        if scale * wk != w_full or (prep["full_img"] is not None
                                    and prep["full_img"][0].shape[2] != scale * h):
            raise ValueError(f"the full-resolution width {w_full} is not an integer multiple "
                             f"of the working {wk} in both axes")
        strip = strip_bounds(wk, world)[rank]
        r1, r2 = halos(model, ds_factor)
        windows = window(strip, r1, wk), window(strip, r2, wk)
        gather = functools.partial(dist_ops.gather_disjoint, lo=strip[0], hi=strip[1], size=wk,
                                   dim=2, group=group)
        imgs, flows = [], []
        for tv in t_values:
            out = model.decode_strip(prep, tv, strip, windows, gather)
            imgs.append(out["imgt_pred"])
            flows.append(out["flowt"])
        a, b = strip
        imgt = dist_ops.gather_disjoint(torch.stack(imgs), a * scale, b * scale, w_full, 3, group)
    ds = 1.0 if ds_factor is None else ds_factor
    return {"imgt_pred": imgt[..., :w, :], "flowt": torch.stack(flows)[..., :int(w * ds), :]}


PATH_KERNELS = (softsplat_ops.SPLAT_SORTED_KERNEL, corr_ops.WINDOWED_CORR_MMA_KERNEL,
                corr_ops.WINDOWED_CORR_TF32_KERNEL, corr_ops.WINDOWED_CORR_BWD_KERNEL)


def interpolate_on_rank(cases_path: str, out_dir: str, num_threads: int | None = None) -> None:
    """One rank of `dist.spawn_ranks` that runs `interpolate_spatial_sharded`
    over the default group for each case of the list saved at `cases_path`
    (`torch.save`; files through which the ranks meet no shared-memory
    limit), a dict of `family`, `model_kw`, `state`, `img_xs`, `t_values`
    and `ds_factor`. Each rank builds `family(**model_kw)` from a seed of
    its own and only rank 0 loads `state`, so the ranks compute with one
    set of weights through the entry's broadcast. TF32 is off (a spawned
    process starts with torch's defaults). Saves `out_dir/rank<r>.pt`: for
    each case the outputs on the CPU, the launches of the splat and both
    tensor-core windowed lookups counted from 0 around the call, its
    seconds (host clock, synchronized), on a card the peak allocated bytes
    over the call, and the seconds of one more `prepare_sharded` alone."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if num_threads is not None:
        torch.set_num_threads(num_threads)
    rank = dist_ops.rank()
    results = []
    for case in torch.load(cases_path, weights_only=False):  # written by the caller
        torch.manual_seed(1000 + rank)
        model = case["family"](**case["model_kw"])
        if rank == 0:
            model.load_state_dict(case["state"])
        del case["state"]
        cuda = next(model.parameters()).is_cuda
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for k in PATH_KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        out = interpolate_spatial_sharded(model, case["img_xs"], case["t_values"], case["ds_factor"])
        if cuda:
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k.name: k.launches for k in PATH_KERNELS}
        peak = torch.cuda.max_memory_allocated() if cuda else None
        # `prepare_sharded` once more, alone, after the counted call
        img_xs = pad_width(case["img_xs"], dist_ops.world_size())
        t0 = time.perf_counter()
        with torch.inference_mode():
            model.prepare_sharded(img_xs, case["ds_factor"])
        if cuda:
            torch.cuda.synchronize()
        results.append({"imgt_pred": out["imgt_pred"].cpu(), "flowt": out["flowt"].cpu(),
                        "launches": launches, "seconds": seconds, "peak_bytes": peak,
                        "prepare_seconds": time.perf_counter() - t0})
        del model, out
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
