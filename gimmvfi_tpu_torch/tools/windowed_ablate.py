"""The windowed-correlation kernels' inputs, their check on the card, their
ablations, and a CPU model of the tensor-core kernel's tile walk.

    python -m gimmvfi_tpu_torch.tools.windowed_ablate          # CUDA-core kernel
    python -m gimmvfi_tpu_torch.tools.windowed_ablate --mma    # bf16 tensor-core kernel
    python -m gimmvfi_tpu_torch.tools.windowed_ablate --tf32   # float32 tensor-core kernel
    python -m gimmvfi_tpu_torch.tools.windowed_ablate --bwd    # the lookup's backward kernel

Card only: without CUDA `main` raises. Each variant is a kernel's source
with text substitutions, built with the same nvcc flags into
`build/kernels/ablate/`. Without `--mma`, the variants of
`csrc/windowed_corr.cu`; the design's steps, each variant with the steps
before it and none after:
  - first: one query's levels inside the block's query loop, one FMA chain
    over a lane's chunks, no unroll of the tap loop, no minimum of blocks
    an SM in `__launch_bounds__`, the output staging in rows of 32 queries;
  - levels_outer: the block sweeps one level at a time over its queries,
    so its warps read neighbouring windows of one map together;
  - chains: one FMA chain a chunk, so the chunks' FMAs overlap;
  - unroll2: the tap loop unrolled twice;
  - blocks3: `__launch_bounds__` asks for 3 blocks an SM (<= 85 registers);
  - kernel: the source as it is, whose staging rows hold 33 queries, so
    that a warp's blend writes (one query, 32 rows) fall in 32 banks.
And three ablations of `kernel`, which do not compute the lookup and are
not checked:
  - no_f2_loads: the window's pixels are not read; each tap dots f1 with
    itself (the FMAs and everything else stay);
  - no_fmas: the window's pixels are read with the same 16-byte loads and
    folded with one xor a load instead of 8 FMAs (bf16: every byte is read;
    float32 reads half of each chunk);
  - skeleton: neither: the tap loop's bounds checks, shuffles, blend and
    stores.
Every variant that computes the lookup is checked against
`windowed_corr_lookup_plain` in `WINDOWED_CASES` and at `AMT_2K`; then each
variant is timed by its own device time from a `torch.profiler` trace, at
`RAFT_2K` and `RAFT_720P` in bf16, twice, in opposite orders.

With `--mma`, `csrc/windowed_corr_mma.cu` as it is (`mma`), beside
`csrc/windowed_corr.cu` as it is (`cuda_core`), and two ablations of the
new kernel (`MMA_ABLATIONS`), which do not compute the lookup:
  - mma_no_stage: no `cp.async` of the window rows (the ring's stale
    contents are multiplied; the A staging, the walk and the waits stay);
  - mma_no_dots: no `mma`; the staged rows are still read by `ldmatrix` and
    folded into the accumulators with one xor.
`mma` is checked against `windowed_corr_lookup_plain` in the bf16 cases and
at both path shapes on `in_frame` and `smooth` coordinates; all four are
timed at `RAFT_2K` on both kinds, twice, in opposite orders.

With `--tf32`, `csrc/windowed_corr_tf32.cu` as it is (`tf32`), beside its
stage configurations (`TF32_CONFIGS`: warps a block, each a slice of the
channels; pixels a stage; ring stages a warp; each built as a variant where
it is not the source's own) and two ablations that do not compute the
lookup (`TF32_ABLATIONS`):
  - tf32_no_stage: no `cp.async` of the window pixels (the ring's stale
    contents are multiplied; the walk and the waits stay);
  - tf32_no_mma: no `mma`; the B fragments are still loaded and split, and
    folded into the accumulators with one xor;
and `csrc/windowed_corr.cu` as it is (`cuda_core`). The ones that compute
the lookup are checked against `windowed_corr_lookup_plain` in the float32
cases of `WINDOWED_CASES`, in `TF32_CASES` and at `F_AMT_720P` on
`in_frame` and `smooth` coordinates; then all are timed at `F_AMT_720P`
on both kinds, twice, in opposite orders, with each configuration's shared
memory and blocks an SM (read from its library) and ptxas lines, against
the 3xTF32 bound and the CUDA-core one (`f32_lookup_bounds`).

With `--bwd`, `csrc/windowed_corr_bwd.cu` as it is (`bwd`, checked, d_levels
bitwise over two calls) beside `BWD_VARIANTS`, ablations that do not
compute the backward and are not checked: `bwd_no_levels` (the destination
side's kernels not launched; the sort still runs) and `bwd_no_stage` (the
query side without the cp.async of the window rows); each call timed with
its parts (query side, order, destination side, chunk sum) at the stage-2
AMT lookup's shape, `F_AMT_720P` and `RAFT_2K`, twice, in opposite orders.

`mma_tile_walk` computes the lookup by the tensor-core kernels' own
decomposition in plain torch, with a `dot` for the products (float32, or
`split_tf32_dot`: the float32 kernel's 3xTF32), and `mma_tile_extents`
its union extents alone, for the CPU tests and `chip_smoke.py` phase 7.
`bwd_order_model` computes the backward by the backward kernel's own
partition and order (query tiles, destination keys, runs and chunks), the
written statement of the order it sums d_levels in.

`WINDOWED_CASES`, `MMA_CASES`, `TF32_CASES`, the lookup shapes,
`windowed_inputs` and `windowed_agreement` are shared with `chip_smoke.py`
phases 7 and 9; `WINDOWED_BWD_CASES` and `windowed_bwd_agreement` (the backward
kernel's) with phases 7 and 12.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import corr as corr_ops
from ..ops.corr import (
    WindowedCorr,
    WindowedCorrBwdKernel,
    WindowedCorrKernel,
    WindowedCorrMmaKernel,
    WindowedCorrTf32Kernel,
    _window_base,
    windowed_corr_lookup_backward_plain,
    windowed_corr_lookup_plain,
)
from ..utils.kernel_build import CSRC, build_text, substitute
from ..utils.timing import H100_BF16_FLOPS, H100_F32_FLOPS, H100_TF32_FLOPS, bound_ms, device_ms
from .splat_ablate import smooth_flow

# (C, dtype, coordinate kind, radius, levels, (N, h, w)): the path's C at
# two sizes; a small C on an odd size (13x23 pools to 6x11, 3x5, 1x2);
# other radii and level counts
WINDOWED_CASES = [
    (256, torch.float32, "in_frame", 4, 4, (2, 40, 48)),
    (256, torch.bfloat16, "in_frame", 4, 4, (2, 40, 48)),
    (256, torch.float32, "border", 4, 4, (1, 36, 64)),
    (256, torch.bfloat16, "far", 4, 4, (1, 36, 64)),
    (24, torch.float32, "border", 4, 4, (2, 13, 23)),
    (24, torch.bfloat16, "far", 4, 4, (2, 13, 23)),
    (16, torch.float32, "in_frame", 4, 4, (1, 13, 23)),
    (64, torch.float32, "far", 3, 2, (1, 9, 15)),
    (8, torch.bfloat16, "border", 1, 1, (2, 7, 9)),
]
# the lookups of the 2048x1088 DS 1.0 path (C = 256, bf16, 4 levels, r = 4):
# RAFT's, both directions batched, and the AMT's, one a direction; and
# RAFT's at the 720p fmap
RAFT_2K = (2, 136, 256)
AMT_2K = (1, 136, 256)
RAFT_720P = (2, 92, 160)
# the AMT lookup of the 720p GIMM-VFI-F path (one direction; float32,
# FlowFormer's feature map)
F_AMT_720P = (1, 92, 160)
# the tensor-core kernel's bf16 checks beyond the bf16 cases of
# WINDOWED_CASES: bf16 copies of its float32 cases, and smooth coordinates at
# C = 256 and C = 8; and the coordinate kinds it is checked and timed on at
# the path shapes
MMA_CASES = [(c, torch.bfloat16, kind, radius, levels, shape)
             for c, dtype, kind, radius, levels, shape in WINDOWED_CASES
             if dtype == torch.float32] + [
    (256, torch.bfloat16, "smooth", 4, 4, (2, 40, 48)),
    (8, torch.bfloat16, "smooth", 4, 4, (1, 36, 64)),
]
PATH_KINDS = ("in_frame", "smooth")
# the float32 tensor-core kernel's checks beyond the float32 cases of
# WINDOWED_CASES: smooth coordinates at C = 256 and C = 8, a C whose 25
# k-steps of 8 channels the 4 warps of a block split unevenly (6, 6, 6, 7),
# and far coordinates at r = 1 with one level
TF32_CASES = [
    (256, torch.float32, "smooth", 4, 4, (2, 40, 48)),
    (8, torch.float32, "smooth", 4, 4, (1, 36, 64)),
    (200, torch.float32, "in_frame", 4, 4, (1, 13, 40)),
    (24, torch.float32, "far", 1, 1, (2, 7, 9)),
]
# the backward kernel's checks beyond the lookup's cases: the radii and
# level counts those leave out (0, 2; 3 levels), at C 32 and 40
WINDOWED_BWD_CASES = [
    (32, torch.float32, "in_frame", 0, 3, (2, 12, 20)),
    (40, torch.float32, "smooth", 2, 4, (1, 13, 23)),
    (40, torch.bfloat16, "border", 2, 3, (2, 12, 20)),
]
# the kernels' general case (radius past 4 or more than 4 levels): each
# (radius, levels) in both dtypes, in-frame, border and far or non-finite
# coordinates, every level at least 2 px a side
BIG_WINDOW_CASES = [
    (256, torch.bfloat16, "in_frame", 5, 4, (2, 40, 48)),
    (256, torch.float32, "border", 5, 4, (2, 40, 48)),
    (64, torch.bfloat16, "far", 8, 4, (1, 36, 64)),
    (256, torch.float32, "in_frame", 8, 4, (1, 36, 64)),
    (32, torch.float32, "far", 4, 5, (1, 40, 48)),
    (256, torch.bfloat16, "border", 4, 5, (1, 40, 48)),
    (40, torch.bfloat16, "in_frame", 4, 6, (1, 64, 64)),
    (256, torch.float32, "far", 4, 6, (1, 64, 72)),
    (24, torch.float32, "in_frame", 6, 5, (2, 40, 48)),
    (256, torch.bfloat16, "far", 6, 5, (1, 48, 64)),
]
# (radius, levels) of the readings: the fast case, then the general case at
# radius 8 and at 6 levels
WINDOW_READINGS = [(4, 4), (8, 4), (4, 6)]
# the AMT lookup of a stage-2 training step (batch 4 at 224x224, float32)
STAGE2_AMT = (4, 28, 28)
TILE_Q = 16  # queries a tile of csrc/windowed_corr_mma.cu: the mma's M
DEST_BATCH = 32  # candidates a staging batch of csrc/windowed_corr_bwd.cu's destination side
DEST_KSTEP = 8  # entries a k-step of its products (the mma's K)

_LEVELS_OUTER = """  for (int l = 0; l < levels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float scale = 1.0f / (float)(1 << l);  // exact: a power of two
    for (int lq = warp; lq < kQueries; lq += kWarps) {
"""
_LEVELS_INNER = """  for (int lq = warp; lq < kQueries; lq += kWarps) {
    for (int l = 0; l < levels; ++l) {
    const int hl = lv.h[l], wl = lv.w[l];
    const float scale = 1.0f / (float)(1 << l);  // exact: a power of two
"""
_CHAINS = """          float part[kMaxChunks];
#pragma unroll
          for (int k = 0; k < kMaxChunks; ++k) {
            part[k] = a[k][0] * b[k][0];
#pragma unroll
            for (int j = 1; j < 8; ++j) part[k] = fmaf(a[k][j], b[k][j], part[k]);
          }
          acc = (part[0] + part[1]) + (part[2] + part[3]);
"""
_ONE_CHAIN = """#pragma unroll
          for (int k = 0; k < kMaxChunks; ++k) {
#pragma unroll
            for (int j = 0; j < 8; ++j) acc = fmaf(a[k][j], b[k][j], acc);
          }
"""
_F2_LOAD = "load8(px + ch * 8, b[k]);"
_B_DECL = "float b[kMaxChunks][8];"
# the design's steps, last first: (the variant that ends with the step, the
# substitutions that undo it)
STEPS = [
    ("kernel", [("s_out[kMaxLevels * kMaxWin * kMaxWin][kQueries + 1]",
                 "s_out[kMaxLevels * kMaxWin * kMaxWin][kQueries]")]),
    ("blocks3", [("constexpr int kBlocksPerSM = 3;", "constexpr int kBlocksPerSM = 1;")]),
    ("unroll2", [("#pragma unroll 2\n", "#pragma unroll 1\n")]),
    ("chains", [(_CHAINS, _ONE_CHAIN)]),
    ("levels_outer", [(_LEVELS_OUTER, _LEVELS_INNER)]),
]
ABLATIONS = {
    "no_f2_loads": [(_F2_LOAD, "for (int j = 0; j < 8; ++j) b[k][j] = a[k][j];")],
    "no_fmas": [
        (_B_DECL, _B_DECL + "\n          uint32_t bits = 0u;"),
        (_F2_LOAD, "const uint4 u = __ldg(reinterpret_cast<const uint4*>(px + ch * 8));\n"
                   "              bits ^= u.x ^ u.y ^ u.z ^ u.w;"),
        (_CHAINS, "          acc = __uint_as_float(bits & 0x007fffffu);\n"),
    ],
    "skeleton": [(_F2_LOAD, "b[k][0] = 0.0f;"), (_CHAINS, "          acc = (float)(x + y);\n")],
}


def _variants() -> dict[str, tuple[list, bool]]:
    """variant name -> (substitutions into the kernel's source, whether it
    computes the lookup): `first`, then each step in the design's order
    (a step's variant undoes the steps after it), then the ablations."""
    out = {"first": ([sub for _, subs in STEPS for sub in subs], True)}
    for i in reversed(range(len(STEPS))):
        out[STEPS[i][0]] = ([sub for _, subs in STEPS[:i] for sub in subs], True)
    out.update({name: (subs, False) for name, subs in ABLATIONS.items()})
    return out


VARIANTS = _variants()

# ablations of csrc/windowed_corr_mma.cu, which do not compute the lookup
_MMA_STAGE = ("    cp_async16(dst + px * px_bytes + ch * 16, real ? row + px * c + ch * 8 : any, "
              "real ? 16 : 0);\n")
_MMA_DOTS = "mma_bf16(acc[t][ks & 1], a[ks], b[2 * t], b[2 * t + 1]);"
_MMA_STAGE_FAST = "      cp_async16(to, src, 16);\n"
MMA_ABLATIONS = {
    "mma_no_stage": [(_MMA_STAGE_FAST, "      (void)src;\n"), (_MMA_STAGE, "    (void)real;\n")],
    "mma_no_dots": [(_MMA_DOTS, "acc[t][ks & 1][0] += __uint_as_float("
                                "(b[2 * t] ^ b[2 * t + 1] ^ a[ks][0]) & 0x007fffffu);")],
}


def variant_source(name: str, src: str) -> str:
    """`src` with variant `name`'s substitutions; each must match exactly once."""
    subs = MMA_ABLATIONS[name] if name in MMA_ABLATIONS else VARIANTS[name][0]
    return substitute(src, subs, f"variant {name}")


# configurations of csrc/windowed_corr_tf32.cu: name -> (warps a block,
# each a slice of the channels; target pixels a stage; ring stages a warp):
# 2 x 16-pixel stages, 2 x 8-pixel stages, and a 4-deep ring of 16 pixels
# of a warp's 64 channels
TF32_CONFIGS = {
    "w4px16x2": (4, 16, 2),
    "w4px8x2": (4, 8, 2),
    "w4px16x4": (4, 16, 4),
}
_TF32_CONSTANTS = ("kWarps", "kStagePx", "kStages")
_TF32_MMA = """        mma_tf32(acc[nt][0], ahi[ks], bhi[0], bhi[1]);
        mma_tf32(acc[nt][1], alo[ks], bhi[0], bhi[1]);
        mma_tf32(acc[nt][1], ahi[ks], blo[0], blo[1]);
"""
_TF32_STAGE = "    cp_async16(smem_addr(dst + px * rs + 4 * ch), src + px * c + 4 * ch);\n"
TF32_ABLATIONS = {
    "tf32_no_stage": [(_TF32_STAGE, "    (void)src;\n")],
    "tf32_no_mma": [(_TF32_MMA, "        acc[nt][0][0] += __uint_as_float((ahi[ks][0] ^ alo[ks][1] ^ bhi[0] ^ "
                                "bhi[1] ^ blo[0] ^ blo[1]) & 0x007fffffu);\n")],
}
TF32_PRODUCTS = 3  # TF32 `mma` products a float32 product takes in 3xTF32
# TF32 `mma` products the backward's ds x feature products take: ds split
# in two, a float32 feature split too (the small x small term dropped), a
# bf16 one exact in TF32
BWD_PRODUCTS_TF32 = {torch.float32: 3, torch.bfloat16: 2}


# ablations of csrc/windowed_corr_bwd.cu for `--bwd`, which do not compute
# the backward: name -> substitutions
_BWD_DEST = "  if (tiles > 0) {\n    cudaError_t err"
_BWD_STAGE = "    cp_async16(smem_addr(dst + px * rs + per * ch), src + px * c + per * ch);\n"
BWD_VARIANTS = {
    # part 2 skipped: the sort still runs, nothing writes d_levels
    "bwd_no_levels": [(_BWD_DEST, "  if (false) {\n    cudaError_t err")],
    # part 1 without the cp.async of the window rows (the rings' stale
    # contents are multiplied; the walk, the waits and the products stay)
    "bwd_no_stage": [(_BWD_STAGE, "    (void)src;\n")],
}


def bwd_variant_source(name: str, src: str) -> str:
    """`csrc/windowed_corr_bwd.cu` with variant `name`'s substitutions."""
    return substitute(src, BWD_VARIANTS[name], f"variant {name}")


def tf32_config(src: str) -> tuple[int, int, int]:
    """The (warps a block, pixels a stage, stages a warp) a float32 kernel
    source is built with."""
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in _TF32_CONSTANTS)


def tf32_variant_source(name: str, src: str) -> str:
    """`csrc/windowed_corr_tf32.cu`'s text `src` as variant `name`: a
    configuration of `TF32_CONFIGS` or an ablation of `TF32_ABLATIONS`.
    Each substitution must match exactly once."""
    if name in TF32_CONFIGS:
        for const, value in zip(_TF32_CONSTANTS, TF32_CONFIGS[name]):
            src, count = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};", src)
            if count != 1:
                raise ValueError(f"variant {name}: {const} is set {count} times in the source")
        return src
    return substitute(src, TF32_ABLATIONS[name], f"variant {name}")


def f32_lookup_bounds(wc: WindowedCorr, coords: torch.Tensor) -> dict:
    """The float32 lookup's bounds on these inputs, each (ms, what bounds
    it): `tf32`, the 3xTF32 kernel's (its bytes, or `TF32_PRODUCTS` TF32
    products a float32 one at the dense TF32 tensor-core peak), and
    `cuda_core`, the CUDA-core kernel's (float32 FMAs at the CUDA-core
    peak); the bytes and float32 operations they come from."""
    nbytes, flops = corr_ops.windowed_corr_work(wc, coords)
    return {"tf32": bound_ms(nbytes, TF32_PRODUCTS * flops, H100_TF32_FLOPS),
            "cuda_core": bound_ms(nbytes, flops, H100_F32_FLOPS),
            "bytes": nbytes, "flops": flops}


def bwd_bound(wc: WindowedCorr, coords: torch.Tensor, radius: int = 4,
              need_coords: bool = True) -> dict:
    """The backward's bound on these inputs (`windowed_corr_bwd_work`): the
    larger of its bytes over the HBM rate and its operations, each at the
    peak of the unit that takes it in `csrc/windowed_corr_bwd.cu`, summed:
    the dots on the tensor cores, bf16 products at the dense bf16 peak for
    bf16 features, `TF32_PRODUCTS` TF32 products a float32 one at the dense
    TF32 peak for float32 ones (3xTF32); the d_f1 and d_f2 products (float32
    ds by the features) at the TF32 peak, `BWD_PRODUCTS_TF32[dtype]` TF32
    products each (ds split in two, a float32 feature in two as well).
    Returns `bound_ms`, `bound_by`, `bytes`, `dot_flops` and
    `product_flops`."""
    nbytes, dots, products = corr_ops.windowed_corr_bwd_work(wc, coords, radius, need_coords)
    if wc.f1.dtype == torch.bfloat16:
        dot_tf32 = dots * H100_TF32_FLOPS / H100_BF16_FLOPS  # the same time at the TF32 peak
    else:
        dot_tf32 = TF32_PRODUCTS * dots
    ops = dot_tf32 + BWD_PRODUCTS_TF32[wc.f1.dtype] * products
    bound, bound_by = bound_ms(nbytes, ops, H100_TF32_FLOPS)
    return {"bound_ms": bound, "bound_by": bound_by, "bytes": nbytes, "dot_flops": dots,
            "product_flops": products}


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as `cvt.rna.tf32.f32`: half of the 13 dropped bits' range is
    added to the magnitude's bits, which are then cut. Non-finite values
    pass unchanged."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x.float())


def _tile_products(a: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """(16, C) by (blocks, 8, C) -> (16, blocks, 8), float32 sums."""
    return torch.einsum("qc,kpc->qkp", a, pix)


def split_tf32_dot(a: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """`_tile_products` in 3xTF32, as `csrc/windowed_corr_tf32.cu` takes
    them: each operand split into big = rna(x) and small = rna(x - big);
    big*big + (small*big + big*small), the small*small term dropped. Each
    product of two TF32 values is exact in float32."""
    ahi, bhi = tf32_rna(a), tf32_rna(pix)
    alo, blo = tf32_rna(a - ahi), tf32_rna(pix - bhi)
    return _tile_products(ahi, bhi) + (_tile_products(alo, bhi) + _tile_products(ahi, blo))


def one_pass_tf32_dot(a: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """`_tile_products` of the operands rounded once to TF32 (1xTF32)."""
    return _tile_products(tf32_rna(a), tf32_rna(pix))


SMOOTH_STD = 4.0  # px at the fmap, the `smooth` kind's flow


def windowed_inputs(shape, c, dtype, kind, levels=4, seed=0, device="cuda"):
    """A windowed state from seeded NCHW maps and (N, 2, h, w) coordinates:
    in the frame (the grid plus independent N(0, 3 px) a query), the grid
    plus a smooth flow (`splat_ablate.smooth_flow`, std 4 px at the fmap, one
    independent vector every ~12 px), around its border, or far off it (1e3
    and 1e10 px, NaN and inf). Returns (state, coords, (f1, f2))."""
    n, h, w = shape
    gen = torch.Generator(device="cpu").manual_seed(seed)
    f1, f2 = (torch.randn((n, c, h, w), generator=gen).to(dtype) for _ in range(2))
    grid = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(h), indexing="xy")).float()
    if kind == "in_frame":
        coords = grid + 3.0 * torch.randn((n, 2, h, w), generator=gen)
    elif kind == "smooth":
        flow = smooth_flow(np.random.default_rng(seed), n, h, w, SMOOTH_STD,
                           coarse=(max(2, h // 12), max(2, w // 12)))
        coords = grid + torch.from_numpy(flow).permute(0, 3, 1, 2)
    elif kind == "border":
        edge = torch.tensor([-4.5, -1.25, -0.5, 0.0, 0.75])[
            torch.randint(5, (n, 2, h, w), generator=gen)]
        far = torch.rand((n, 2, h, w), generator=gen) < 0.5
        coords = torch.where(far, torch.tensor([w, h]).view(1, 2, 1, 1) - 1 - edge, edge)
    elif kind == "far":
        coords = torch.tensor([-1e3, 1e3, -1e10, 1e10, 3.5])[
            torch.randint(5, (n, 2, h, w), generator=gen)]
        bad = torch.rand((n, 2, h, w), generator=gen) < 0.1
        coords[bad] = torch.tensor([float("nan"), float("inf"), -float("inf")])[
            torch.randint(3, (int(bad.sum()),), generator=gen)]
    else:
        raise ValueError(f"unknown coordinate kind {kind!r}")
    f1, f2 = f1.to(device), f2.to(device)
    wc = corr_ops.windowed_corr_pyramid(f1, f2, levels)
    return wc, coords.float().to(device), (f1, f2)


def windowed_agreement(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The kernel's tolerance against the plain version, in the output's
    dtype: float32 within 1e-5 of the largest value (sums in another
    order); bf16 within one bf16 step, 2**-7 |plain| + 1e-6 max|plain| (the
    two float32 sums may round either way); NaN at the same places.
    Returns the max-abs error, the largest |plain|, the elements over the
    bound, the NaN count and whether they agree."""
    bf16 = ref.dtype == torch.bfloat16
    got, ref = got.float(), ref.float()
    nan = torch.isnan(ref)
    err = (got[~nan] - ref[~nan]).abs()
    scale = float(ref[~nan].abs().max()) if err.numel() else 0.0
    limit = 2.0**-7 * ref[~nan].abs() + 1e-6 * scale if bf16 else 1e-5 * scale
    bad = int((err > limit).sum())
    same_nan = torch.equal(torch.isnan(got), nan)
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0, "scale": scale,
            "bad": bad, "nan": int(nan.sum()), "ok": bad == 0 and same_nan}


def windowed_bwd_agreement(got, ref) -> dict:
    """The backward kernel's tolerance against its plain version: `got`
    and `ref` are (d_f1, d_levels, d_coords), `ref` float32. d_f1 and
    d_levels in `got`'s dtype: float32 within 1e-5 x max(1, max|plain|)
    (sums in other orders, d_levels' by atomics), bf16 within one bf16 step
    of the plain sums cast once, 2**-7 |plain| + 1e-6 max|plain|; d_coords
    (float32) within 1e-4 x max(1, max|plain|) (the blend's differences of
    the dots summed over the window and the levels); NaN at the same
    places in each. Returns each tensor's max-abs error, largest |plain|,
    NaN count and elements over the bound, the largest error of d_f1 and
    d_levels and of d_coords, and whether they agree. A `got` without
    d_coords (None: the backward asked for none) is held on the rest."""
    pairs = ([("d_f1", got[0], ref[0])]
             + [(f"d_level{i}", a, b) for i, (a, b) in enumerate(zip(got[1], ref[1]))]
             + ([] if got[2] is None else [("d_coords", got[2], ref[2])]))
    ok = len(got[1]) == len(ref[1])
    out = {"tensors": {}, "max_abs_err": 0.0, "coords_max_abs_err": 0.0}
    for name, a, b in pairs:
        bf16 = a.dtype == torch.bfloat16
        a, b = a.float(), (b.to(a.dtype) if bf16 else b).float()
        nan = torch.isnan(b)
        err = (a[~nan] - b[~nan]).abs()
        scale = float(b[~nan].abs().max()) if err.numel() else 0.0
        if bf16:
            limit = 2.0**-7 * b[~nan].abs() + 1e-6 * scale
        else:
            limit = (1e-4 if name == "d_coords" else 1e-5) * max(1.0, scale)
        bad = int((err > limit).sum())
        worst = float(err.max()) if err.numel() else 0.0
        out["tensors"][name] = {"max_abs_err": worst, "scale": scale, "nan": int(nan.sum()),
                                "bad": bad}
        key = "coords_max_abs_err" if name == "d_coords" else "max_abs_err"
        out[key] = max(out[key], worst)
        ok = ok and bad == 0 and torch.equal(torch.isnan(a), nan)
    out["ok"] = ok
    return out


def bind(name: str, text: str, kind=WindowedCorrKernel) -> tuple[WindowedCorrKernel, str]:
    """Build a source with the launcher of wrapper class `kind`; returns a
    wrapper that launches it (with launch counts of its own; its library as
    `library`) and the ptxas lines."""
    lib, log = build_text(f"windowed_corr_{name}", text)
    kernel = kind()
    kernel.library = lib
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    kernel._fn = fn
    if hasattr(kernel, "attach"):  # a launcher of its own besides the counted one
        kernel.attach(lib)
    keep = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return kernel, " | ".join(keep)


def _level_windows(coords: torch.Tensor, radius: int, level: int, hl: int, wl: int):
    """Level `level`'s windows of (N, 2, H, W) coordinates, each (N, H, W):
    the start (x0, y0) and fractional offsets (fx, fy) as the plain version
    takes them, and the window's part on the map [wx0, wx1) x [wy0, wy1),
    with `live` false where it is empty (a window off the map, or a
    non-finite coordinate)."""
    span = 2 * radius + 2
    flat = coords.float()
    x0, fx = _window_base(flat[:, 0] / 2.0**level, radius, wl)
    y0, fy = _window_base(flat[:, 1] / 2.0**level, radius, hl)
    wx0, wx1 = x0.clamp(min=0), (x0 + span).clamp(max=wl)
    wy0, wy1 = y0.clamp(min=0), (y0 + span).clamp(max=hl)
    return x0, y0, fx, fy, (wx0 < wx1) & (wy0 < wy1), wx0, wx1, wy0, wy1


EXTENT_KEYS = ("rows", "blocks", "pixels")
TAP_TILE = 9  # outputs a side of the kernels' general case's tap tiles


def tap_tiles(radius: int, levels: int) -> list[tuple[int, int, int, int]]:
    """The kernels' tap tiles (i0, ni, j0, nj), each the outputs of x offset
    i0 .. i0 + ni - 1 and y offset j0 .. j0 + nj - 1 and the (ni + 1) x
    (nj + 1) integer taps from (x0 + i0, y0 + j0): the whole window in the
    fast case (`ops/corr.py: fast_case`); in the general case the 2r + 1
    offsets of each axis cut into parts = ceil((2r + 1) / TAP_TILE) pieces,
    piece t from t (2r + 1) // parts, in the kernels' order (the x piece
    outer)."""
    win = 2 * radius + 1
    if corr_ops.fast_case(levels, radius):
        return [(0, win, 0, win)]
    parts = -(-win // TAP_TILE)
    cuts = [t * win // parts for t in range(parts + 1)]
    return [(cuts[ti], cuts[ti + 1] - cuts[ti], cuts[tj], cuts[tj + 1] - cuts[tj])
            for ti in range(parts) for tj in range(parts)]


def _tile_windows(x0, y0, i0: int, ni: int, j0: int, nj: int, hl: int, wl: int):
    """A tap tile's windows from the full windows' starts (x0, y0): the
    tile's start, and its part on the map [wx0, wx1) x [wy0, wy1) with
    `live` false where it is empty."""
    tx0, ty0 = x0 + i0, y0 + j0
    wx0, wx1 = tx0.clamp(min=0), (tx0 + ni + 1).clamp(max=wl)
    wy0, wy1 = ty0.clamp(min=0), (ty0 + nj + 1).clamp(max=hl)
    return tx0, ty0, (wx0 < wx1) & (wy0 < wy1), wx0, wx1, wy0, wy1


def mma_tile_walk(wc: WindowedCorr, coords: torch.Tensor, radius: int = 4,
                  dot=_tile_products):
    """The lookup by the tensor-core kernels' own decomposition
    (`csrc/windowed_corr_mma.cu`, `csrc/windowed_corr_tf32.cu`), in float32
    on the host (slow: a Python loop over tiles and rows).

    Tiles of 16 consecutive queries of one image row (the last one of a row
    short). For each level and tap tile (`tap_tiles`: the whole window in
    the fast case), the union of the tile's windows over its live queries
    (finite coordinates, window touching the map), clipped to the map;
    walked one union row at a time, a row's columns those of the windows
    that cover it, in blocks of 8 pixels (the last one past the row's end
    zero); each block a (16 x C) @ (C x 8) product by `dot` (float32 sums,
    or `split_tf32_dot`); each product element (query, pixel) put into the
    query's sums `s` of the tile's taps if the pixel lies in its window;
    then the plain version's tent blend of the tile's outputs and one cast.
    Returns (out (N, L*(2r+1)^2, H, W), extents): `extents` maps
    "rows" (union rows walked), "blocks" (8-pixel blocks over those rows,
    the n-tiles a k-step multiplies) and "pixels" (pixels staged) to
    (L, N, H, tiles a row) integer tensors, summed over the tap tiles."""
    n, _, c = wc.f1.shape
    h, w = coords.shape[-2:]
    win = 2 * radius + 1
    nl = len(wc.f2_levels)
    tiles_x = -(-w // TILE_Q)
    f1 = wc.f1.float().reshape(n, h, w, c)
    out = torch.empty((n, nl, win, win, h, w))  # [.., x offset i, y offset j, ..]
    extents = {k: torch.zeros((nl, n, h, tiles_x), dtype=torch.long) for k in EXTENT_KEYS}
    for lvl, f2 in enumerate(wc.f2_levels):
        hl, wl = f2.shape[1:3]
        f2 = f2.float()
        x0_full, y0_full, fx, fy, *_ = _level_windows(coords, radius, lvl, hl, wl)
        for i0, ni, j0, nj in tap_tiles(radius, nl):
            x0, y0, live, wx0, wx1, wy0, wy1 = _tile_windows(x0_full, y0_full, i0, ni, j0, nj,
                                                             hl, wl)
            for b in range(n):
                for qy in range(h):
                    for tx in range(tiles_x):
                        q = slice(tx * TILE_Q, min(w, (tx + 1) * TILE_Q))
                        m = q.stop - q.start
                        a = torch.zeros(TILE_Q, c)
                        a[:m] = f1[b, qy, q]
                        s = torch.zeros(TILE_Q, nj + 1, ni + 1)
                        ok, ty0, ty1 = live[b, qy, q], wy0[b, qy, q], wy1[b, qy, q]
                        rows = range(int(ty0[ok].min()), int(ty1[ok].max())) if ok.any() else ()
                        for y in rows:
                            cover = ok & (ty0 <= y) & (y < ty1)
                            if not cover.any():
                                continue
                            rx0 = int(wx0[b, qy, q][cover].min())
                            rx1 = int(wx1[b, qy, q][cover].max())
                            nb = -(-(rx1 - rx0) // 8)
                            pix = torch.zeros(nb * 8, c)
                            pix[:rx1 - rx0] = f2[b, y, rx0:rx1]
                            prod = dot(a, pix.view(nb, 8, c)).reshape(TILE_Q, -1)
                            cols = rx0 + torch.arange(nb * 8)
                            dy = y - y0[b, qy, q]
                            dx = cols.view(1, -1) - x0[b, qy, q].view(-1, 1)
                            take = (((dy >= 0) & (dy <= nj)).view(-1, 1) & (dx >= 0) & (dx <= ni)
                                    & (cols < rx1).view(1, -1))
                            r, k = take.nonzero(as_tuple=True)
                            s[r, dy[r], dx[r, k]] = prod[r, k]
                            for key, v in zip(EXTENT_KEYS, (1, nb, rx1 - rx0)):
                                extents[key][lvl, b, qy, tx] += v
                        fyq, fxq = fy[b, qy, q].view(m, 1, 1), fx[b, qy, q].view(m, 1, 1)
                        sy = s[:m, :nj] * (1.0 - fyq) + s[:m, 1:] * fyq
                        v = sy[..., :ni] * (1.0 - fxq) + sy[..., 1:] * fxq  # (query, y, x)
                        out[b, lvl, i0:i0 + ni, j0:j0 + nj, qy, q] = v.permute(2, 1, 0)
    return out.reshape(n, nl * win * win, h, w).to(wc.f1.dtype), extents


def mma_tile_extents(wc: WindowedCorr, coords: torch.Tensor, radius: int = 4) -> dict:
    """`mma_tile_walk`'s extents without the dots, vectorised over tiles (on
    the coordinates' device)."""
    n = coords.shape[0]
    h, w = coords.shape[-2:]
    tiles_x = -(-w // TILE_Q)
    far = 1 << 30

    def tiles(t, fill):
        out = torch.full((n, h, tiles_x * TILE_Q), fill, dtype=t.dtype, device=t.device)
        out[..., :w] = t
        return out.view(n, h, tiles_x, TILE_Q)

    per_level = {k: [] for k in EXTENT_KEYS}
    for lvl, f2 in enumerate(wc.f2_levels):
        hl, wl = f2.shape[1:3]
        x0, y0, *_ = _level_windows(coords, radius, lvl, hl, wl)
        got = {k: torch.zeros((n, h, tiles_x), dtype=torch.long, device=coords.device)
               for k in EXTENT_KEYS}
        for i0, ni, j0, nj in tap_tiles(radius, len(wc.f2_levels)):
            _, _, live, wx0, wx1, wy0, wy1 = _tile_windows(x0, y0, i0, ni, j0, nj, hl, wl)
            live, wx0, wx1, wy0, wy1 = (tiles(t, f) for t, f in
                                        ((live, False), (wx0, 0), (wx1, 0), (wy0, 0), (wy1, 0)))
            uy0 = torch.where(live, wy0, far).amin(-1)
            height = (torch.where(live, wy1, -far).amax(-1) - uy0).clamp(min=0)
            for d in range(int(height.max()) if height.numel() else 0):
                y = (uy0 + d).unsqueeze(-1)
                cover = live & (wy0 <= y) & (y < wy1)
                width = (torch.where(cover, wx1, -far).amax(-1)
                         - torch.where(cover, wx0, far).amin(-1)).clamp(min=0)
                got["rows"] += width > 0
                got["blocks"] += (width + 7) // 8
                got["pixels"] += width
        for k in EXTENT_KEYS:
            per_level[k].append(got[k])
    return {k: torch.stack(v) for k, v in per_level.items()}


def bwd_query_ds(wc: WindowedCorr, coords: torch.Tensor, g: torch.Tensor, radius: int, level: int):
    """Level `level`'s ds of every query, (N, H, W, 2r+2, 2r+2) [query, tap
    row, tap column], float32: g's blend backward as the plain backward
    takes it; with dsy (N, H, W, 2r+1, 2r+2) and gv (N, H, W, 2r+1, 2r+1)
    [query, y offset j, x offset i] for d_coords."""
    n, _, h, w = coords.shape
    win, span = 2 * radius + 1, 2 * radius + 2
    hl, wl = wc.f2_levels[level].shape[1:3]
    _, _, fx, fy, *_ = _level_windows(coords, radius, level, hl, wl)
    gv = g.float().reshape(n, len(wc.f2_levels), win, win, h, w)[:, level].permute(0, 3, 4, 2, 1)
    fx_, fy_ = fx[..., None, None], fy[..., None, None]
    dsy = torch.zeros((n, h, w, win, span))
    dsy[..., :win] += gv * (1.0 - fx_)
    dsy[..., 1:] += gv * fx_
    ds = torch.zeros((n, h, w, span, span))
    ds[..., :win, :] += dsy * (1.0 - fy_)
    ds[..., 1:, :] += dsy * fy_
    return ds, dsy, gv


def bwd_order_model(wc: WindowedCorr, coords: torch.Tensor, g: torch.Tensor, radius: int = 4,
                    chunk_q: int | None = None, dot=_tile_products):
    """The backward by the kernel's own partition and order
    (`csrc/windowed_corr_bwd.cu`), float32 on the host (slow: Python loops
    over tiles, rows and entries). The written statement of the order the
    kernel sums d_levels in.

    The levels go as one group in the fast case (`ops/corr.py: fast_case`),
    else in groups of `LEVEL_GROUP` (`level_groups`), each a backward of its
    own with the radius's key geometry (`bwd_plan_sizes(..., general=True)`).

    Query side: tiles of 16 consecutive queries of one image row. For each
    level, every query's ds (`bwd_query_ds`), key and base: a live window
    (finite coordinate, touching the map) has key n * keys_per_image +
    key_base[l] + ((y0 + pad) // 8) * KX_l + (x0 + pad) // 8 (pad 16 in the
    fast case; the group's level index l), any other the sentinel. For each
    tap tile (`tap_tiles`: the whole window in the fast case), the union of
    the tile's live windows is walked as `mma_tile_walk` walks it, a row at
    a time in blocks of 8 pixels: d_f1 += ds_block (16 queries x 8 pixels,
    ds on the taps the tile owns, zero elsewhere and off a query's window) @
    pixels, and the dots (by `dot`) into each query's sums of the tile's
    taps, from which the tile's outputs' dfx, dfy. A non-finite ds on a tap
    off the map makes the query's d_f1 NaN.

    Destination side, for each group: its entries (N, levels of the group,
    P) sorted stably by key, so a key's run holds its entries in index
    order; a destination tile (8x8 pixels of level l) takes as candidates
    the runs of its reach key rows, ty .. ty + reach - 1, each the key tiles
    tx .. tx + reach - 1, in row order (reach 3 in the fast case); the list
    is cut into chunks of `chunk_q` entries (default `bwd_chunk_queries`; at
    least one chunk, maybe empty); a chunk takes its candidates in batches
    of `DEST_BATCH`, keeps those whose window reaches the tile, in list
    order, and adds their ds x f1 over the tile's pixels to its partial a
    k-step of `DEST_KSTEP` entries at a time (the tensor cores sum a
    k-step's products in an order of their own); the tile's d_f2 is the
    partials added in chunk order, cast once to the features' dtype.

    Returns ((d_f1, d_levels, d_coords) in the kernel's dtypes, plan): plan
    holds, for the first group, `sorted_keys`, `order`, `offsets` (each
    key's first sorted entry), `sizes` (`BwdPlanSizes`), and `tiles` of
    every group, one dict a destination tile: (n, l, ty, tx) (l the level's
    index in the lookup), its `runs` (start, end) in sorted order, its
    `list` of entries, its `chunks` (start, end) in the list and their
    `partials` (8, 8, C)."""
    n, p, c = wc.f1.shape
    h, w = coords.shape[-2:]
    win, span = 2 * radius + 1, 2 * radius + 2
    nl = len(wc.f2_levels)
    general = not corr_ops.fast_case(nl, radius)
    groups = corr_ops.level_groups(nl) if general else [(0, nl)]
    tiles_x = -(-w // TILE_Q)
    f1 = wc.f1.float().reshape(n, h, w, c)
    d_f1 = torch.zeros((n, h, w, c))
    d_coords = torch.zeros((n, 2, h, w))
    bad = torch.zeros((n, h, w), dtype=torch.bool)
    ds_all, x0_all, y0_all = [], [], []
    sizes_of = [corr_ops.bwd_plan_sizes([tuple(f2.shape[1:3]) for f2 in wc.f2_levels[l0:l0 + k]],
                                        n, p, radius, general) for l0, k in groups]
    keys = [torch.empty((n, k, h, w), dtype=torch.long) for _, k in groups]
    for lvl, f2 in enumerate(wc.f2_levels):
        hl, wl = f2.shape[1:3]
        f2 = f2.float()
        gi = lvl // corr_ops.LEVEL_GROUP if general else 0
        sizes, lg = sizes_of[gi], lvl - groups[gi][0]
        x0, y0, fx, fy, live, *_ = _level_windows(coords, radius, lvl, hl, wl)
        ds, dsy, gv = bwd_query_ds(wc, coords, g, radius, lvl)
        ds_all.append(ds)
        x0_all.append(x0)
        y0_all.append(y0)
        key = (torch.arange(n).view(n, 1, 1) * sizes.keys_per_image + sizes.key_base[lg]
               + torch.div(y0 + sizes.pad, 8, rounding_mode="floor") * sizes.kx[lg]
               + torch.div(x0 + sizes.pad, 8, rounding_mode="floor"))
        keys[gi][:, lg] = torch.where(live, key, sizes.sentinel)
        ty_ = y0.view(n, h, w, 1, 1) + torch.arange(span).view(1, 1, 1, span, 1)
        tx_ = x0.view(n, h, w, 1, 1) + torch.arange(span).view(1, 1, 1, 1, span)
        off = (ty_ < 0) | (ty_ >= hl) | (tx_ < 0) | (tx_ >= wl)
        bad |= (off & ~torch.isfinite(ds)).flatten(3).any(-1)
        fxq, fyq = fx[..., None, None], fy[..., None, None]
        tiles = tap_tiles(radius, nl)
        parts = int(round(len(tiles) ** 0.5))
        for t, (i0, ni, j0, nj) in enumerate(tiles):
            tx0, ty0, tlive, wx0, wx1, wy0, wy1 = _tile_windows(x0, y0, i0, ni, j0, nj, hl, wl)
            # the taps the tile owns: its first ni columns and nj rows, the
            # last tile of a row or column also the window's last
            ox, oy = ni + (t // parts == parts - 1), nj + (t % parts == parts - 1)
            own = torch.zeros((n, h, w, nj + 1, ni + 1))
            own[..., :oy, :ox] = ds[..., j0:j0 + oy, i0:i0 + ox]
            for b in range(n):
                for qy in range(h):
                    for tx in range(tiles_x):
                        q = slice(tx * TILE_Q, min(w, (tx + 1) * TILE_Q))
                        m = q.stop - q.start
                        a = f1[b, qy, q]
                        s = torch.zeros(m, nj + 1, ni + 1)
                        ok, ry0, ry1 = tlive[b, qy, q], wy0[b, qy, q], wy1[b, qy, q]
                        rows = range(int(ry0[ok].min()), int(ry1[ok].max())) if ok.any() else ()
                        for y in rows:
                            cover = ok & (ry0 <= y) & (y < ry1)
                            if not cover.any():
                                continue
                            rx0 = int(wx0[b, qy, q][cover].min())
                            rx1 = int(wx1[b, qy, q][cover].max())
                            nb = -(-(rx1 - rx0) // 8)
                            pix = torch.zeros(nb * 8, c)
                            pix[:rx1 - rx0] = f2[b, y, rx0:rx1]
                            cols = rx0 + torch.arange(nb * 8)
                            dy = (y - ty0[b, qy, q]).view(-1, 1)
                            dx = cols.view(1, -1) - tx0[b, qy, q].view(-1, 1)
                            take = ((dy >= 0) & (dy <= nj) & (dx >= 0) & (dx <= ni)
                                    & (cols < rx1).view(1, -1))
                            r, k = take.nonzero(as_tuple=True)
                            block = torch.zeros(m, nb * 8)
                            block[r, k] = own[b, qy, q][r, dy[r, 0], dx[r, k]]
                            for i in range(nb):  # k-steps of 8 pixels
                                d_f1[b, qy, q] += block[:, 8 * i:8 * i + 8] @ pix[8 * i:8 * i + 8]
                            prod = dot(a, pix.view(nb, 8, c)).reshape(m, -1)
                            s[r, dy[r, 0], dx[r, k]] = prod[r, k]
                        fyb, fxb = fyq[b, qy, q], fxq[b, qy, q]
                        if general:
                            # the tile's outputs: g times their blends' x and y derivatives
                            gt = gv[b, qy, q, j0:j0 + nj, i0:i0 + ni]
                            sy = s[:, :nj] * (1.0 - fyb) + s[:, 1:] * fyb
                            dfx = (gt * (sy[..., 1:] - sy[..., :ni])).sum(dim=(1, 2))
                            dfy = (gt * ((1.0 - fxb) * (s[:, 1:, :ni] - s[:, :nj, :ni])
                                         + fxb * (s[:, 1:, 1:] - s[:, :nj, 1:]))).sum(dim=(1, 2))
                        else:
                            sy = s[:, :win] * (1.0 - fyb) + s[:, 1:] * fyb
                            dfx = (gv[b, qy, q] * (sy[..., 1:] - sy[..., :win])).sum(dim=(1, 2))
                            dfy = (dsy[b, qy, q] * (s[:, 1:] - s[:, :win])).sum(dim=(1, 2))
                        d_coords[b, 0, qy, q] += dfx / 2.0**lvl
                        d_coords[b, 1, qy, q] += dfy / 2.0**lvl
    d_f1 = d_f1 + torch.where(bad, float("nan"), 0.0).unsqueeze(-1)

    d_levels = [torch.zeros(f2.shape) for f2 in wc.f2_levels]
    plan_tiles, first = [], None
    for (l0, count), sizes, gkeys in zip(groups, sizes_of, keys):
        sorted_keys, order = torch.sort(gkeys.reshape(-1), stable=True)
        offsets = torch.searchsorted(sorted_keys, torch.arange(sizes.sentinel + 1))
        first = first or (sorted_keys, order, offsets, sizes)
        q_size = chunk_q or sizes.chunk_q
        reach = sizes.reach
        for b in range(n):
            for lg in range(count):
                lvl = l0 + lg
                hl, wl = wc.f2_levels[lvl].shape[1:3]
                kx = sizes.kx[lg]
                for ty in range(sizes.ty[lg]):
                    for tx in range(sizes.tx[lg]):
                        k0 = b * sizes.keys_per_image + sizes.key_base[lg] + ty * kx + tx
                        runs = [(int(offsets[k0 + r * kx]), int(offsets[k0 + r * kx + reach]))
                                for r in range(reach)]
                        lst = torch.cat([order[s0:s1] for s0, s1 in runs])
                        bounds = [(i, min(i + q_size, len(lst)))
                                  for i in range(0, max(1, len(lst)), q_size)]
                        partials = []
                        for c0, c1 in bounds:
                            acc = torch.zeros(8, 8, c)
                            cand = lst[c0:c1].tolist()
                            for s0 in range(0, len(cand), DEST_BATCH):
                                kept = []  # the batch's candidates whose window reaches the tile
                                for e in cand[s0:s0 + DEST_BATCH]:
                                    qy, qx = divmod(e - (b * count + lg) * p, w)
                                    ex0 = int(x0_all[lvl][b, qy, qx])
                                    ey0 = int(y0_all[lvl][b, qy, qx])
                                    ya, yb = max(ey0, 8 * ty), min(ey0 + span, 8 * ty + 8)
                                    xa, xb = max(ex0, 8 * tx), min(ex0 + span, 8 * tx + 8)
                                    if ya < yb and xa < xb:
                                        kept.append((qy, qx, ex0, ey0, ya, yb, xa, xb))
                                for k in range(0, len(kept), DEST_KSTEP):
                                    step = torch.zeros(8, 8, c)  # one k-step's products
                                    for qy, qx, ex0, ey0, ya, yb, xa, xb in kept[k:k + DEST_KSTEP]:
                                        d = ds_all[lvl][b, qy, qx, ya - ey0:yb - ey0,
                                                        xa - ex0:xb - ex0]
                                        step[ya - 8 * ty:yb - 8 * ty, xa - 8 * tx:xb - 8 * tx] += (
                                            d.unsqueeze(-1) * f1[b, qy, qx])
                                    acc = acc + step
                            partials.append(acc)
                        total = partials[0]
                        for part in partials[1:]:
                            total = total + part
                        rows, cols = min(8, hl - 8 * ty), min(8, wl - 8 * tx)
                        d_levels[lvl][b, 8 * ty:8 * ty + rows, 8 * tx:8 * tx + cols] = (
                            total[:rows, :cols])
                        plan_tiles.append({"tile": (b, lvl, ty, tx), "runs": runs, "list": lst,
                                           "chunks": bounds, "partials": partials})
    dtype = wc.f1.dtype
    grads = (d_f1.reshape(n, p, c).to(dtype), tuple(d.to(dtype) for d in d_levels), d_coords)
    sorted_keys, order, offsets, sizes = first
    plan = {"sorted_keys": sorted_keys, "order": order, "offsets": offsets, "sizes": sizes,
            "chunk_q": chunk_q or sizes.chunk_q, "tiles": plan_tiles}
    return grads, plan


def extent_summary(extents: dict, c: int, esize: int = 2) -> dict:
    """What a tensor-core lookup walks, from `mma_tile_extents`: the mean
    level-0 union of a tile (rows, and 8-pixel-rounded columns a row, over
    tiles with any row), the bytes staged from the levels (`esize` bytes a
    value) and the `mma` issued: in bf16 m16n8k16 (K = C padded to 16), in
    float32 three m16n8k8 a k-step of 8 channels (3xTF32)."""
    rows, blocks = extents["rows"][0].float(), extents["blocks"][0].float()
    walked = rows > 0
    per_block = -(-c // 16) if esize == 2 else 3 * (c // 8)
    return {"rows0": float(rows[walked].mean()) if walked.any() else 0.0,
            "cols0": float(8 * blocks[walked].sum() / rows[walked].sum()) if walked.any() else 0.0,
            "staged_bytes": int(extents["pixels"].sum()) * c * esize,
            "mma": int(extents["blocks"].sum()) * per_block}


def fmt_extent(ext: dict) -> str:
    return (f"mean level-0 union {ext['rows0']:.2f} rows x {ext['cols0']:.2f} columns; "
            f"{ext['staged_bytes'] / 1e9:.3f} GB staged, {ext['mma'] / 1e6:.3f} M mma")


def _card() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return smi


def _timed_turns(built: dict, wc, coords, iters: int, g=None) -> dict[str, list[float]]:
    """Each built kernel's own device time on these inputs (with the
    output's gradient `g`, a backward's), twice, the second turn in the
    opposite order."""
    calls = {name: (lambda k=kernel: k(wc, coords) if g is None else k(wc, coords, g))
             for name, (kernel, _) in built.items()}
    times = {name: [] for name in calls}
    for order in (list(calls), list(reversed(calls))):
        for name in order:
            _, by_name = device_ms(calls[name], iters=iters)
            times[name].append(sum(v for k, v in by_name.items() if "windowed_corr" in k))
    return times


def _print_turns(times: dict, label: str, bound: float, bound_by: str, smi: str) -> None:
    for name, turns in times.items():
        print(f"windowed_corr {label} {name:13s} device "
              f"{' / '.join(f'{t:.4f}' for t in turns)} ms "
              f"({' / '.join(f'{100 * bound / t:.1f}' if t else 'n/a' for t in turns)}% of the "
              f"{bound:.4f} ms {bound_by} bound); {smi}", flush=True)


def main_mma(iters=10):
    """The tensor-core kernel, its two ablations and the CUDA-core kernel:
    checked (the two that compute the lookup), then timed at `RAFT_2K`."""
    smi = _card()
    mma_src = (CSRC / "windowed_corr_mma.cu").read_text()
    texts = {"mma": (mma_src, WindowedCorrMmaKernel)}
    texts.update({name: (variant_source(name, mma_src), WindowedCorrMmaKernel)
                  for name in MMA_ABLATIONS})
    texts["cuda_core"] = ((CSRC / "windowed_corr.cu").read_text(), WindowedCorrKernel)
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda name: bind(name, *texts[name]), texts)))
    for name, (_, log) in built.items():
        print(f"{name}: ptxas {log}", flush=True)

    checks = [(shape, c, kind, radius, levels)
              for c, dtype, kind, radius, levels, shape in WINDOWED_CASES + MMA_CASES
              if dtype == torch.bfloat16]
    checks += [(shape, 256, kind, 4, 4) for shape in (RAFT_2K, AMT_2K) for kind in PATH_KINDS]
    for i, (shape, c, kind, radius, levels) in enumerate(checks):
        wc, coords, _ = windowed_inputs(shape, c, torch.bfloat16, kind, levels, seed=i)
        ref = windowed_corr_lookup_plain(wc, coords, radius)
        for name in ("mma", "cuda_core"):
            agree = windowed_agreement(built[name][0](wc, coords, radius), ref)
            print(f"{name} {shape} C={c} r={radius} L={levels} {kind}: {agree}", flush=True)
            if not agree["ok"]:
                raise AssertionError(f"{name} disagrees with the plain version at {shape} "
                                     f"C={c} {kind}: {agree}")
        del wc, coords, ref
        torch.cuda.empty_cache()

    res = {}
    for kind in PATH_KINDS:
        wc, coords, _ = windowed_inputs(RAFT_2K, 256, torch.bfloat16, kind)
        bound, bound_by = bound_ms(*corr_ops.windowed_corr_work(wc, coords))
        print(f"{kind}: {fmt_extent(extent_summary(mma_tile_extents(wc, coords), 256))}",
              flush=True)
        res[kind] = _timed_turns(built, wc, coords, iters)
        _print_turns(res[kind], f"2048x1088 DS 1.0 RAFT {RAFT_2K} C=256 bf16 {kind}",
                     bound, bound_by, smi)
        del wc, coords
        torch.cuda.empty_cache()
    return res


def tf32_variants(src: str) -> dict[str, tuple[str, bool]]:
    """name -> (source text, whether it computes the lookup) of the float32
    kernel `src` (`tf32`), its configurations other than its own and the
    ablations."""
    own = tf32_config(src)
    out = {"tf32": (src, True)}
    out.update({name: (tf32_variant_source(name, src), True)
                for name, cfg in TF32_CONFIGS.items() if cfg != own})
    out.update({name: (tf32_variant_source(name, src), False) for name in TF32_ABLATIONS})
    return out


def main_tf32(iters=10):
    """The float32 tensor-core kernel, its stage configurations, its
    ablations and the CUDA-core kernel: those that compute the lookup
    checked, then all timed at `F_AMT_720P`."""
    smi = _card()
    src = (CSRC / "windowed_corr_tf32.cu").read_text()
    variants = tf32_variants(src)
    texts = {name: (text, WindowedCorrTf32Kernel) for name, (text, _) in variants.items()}
    texts["cuda_core"] = ((CSRC / "windowed_corr.cu").read_text(), WindowedCorrKernel)
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda name: bind(name, *texts[name]), texts)))
    for name, (kernel, log) in built.items():
        occupancy = ""
        if name != "cuda_core":
            cfg = tf32_config(texts[name][0])
            smem = kernel.library.windowed_corr_tf32_smem_bytes(256)
            blocks = kernel.library.windowed_corr_tf32_blocks_per_sm(256)
            occupancy = (f"; config (warps, px, stages) {cfg}, {smem} B of shared memory a "
                         f"block at C=256, {blocks} blocks = {blocks * cfg[0]} warps an SM")
        print(f"{name}: ptxas {log}{occupancy}", flush=True)

    checks = [(shape, c, kind, radius, levels)
              for c, dtype, kind, radius, levels, shape in WINDOWED_CASES + TF32_CASES
              if dtype == torch.float32]
    checks += [(F_AMT_720P, 256, kind, 4, 4) for kind in PATH_KINDS]
    computes = [name for name in built if name == "cuda_core" or variants[name][1]]
    for i, (shape, c, kind, radius, levels) in enumerate(checks):
        wc, coords, _ = windowed_inputs(shape, c, torch.float32, kind, levels, seed=i)
        ref = windowed_corr_lookup_plain(wc, coords, radius)
        for name in computes:
            agree = windowed_agreement(built[name][0](wc, coords, radius), ref)
            print(f"{name} {shape} C={c} r={radius} L={levels} {kind}: {agree}", flush=True)
            if not agree["ok"]:
                raise AssertionError(f"{name} disagrees with the plain version at {shape} "
                                     f"C={c} {kind}: {agree}")
        del wc, coords, ref
        torch.cuda.empty_cache()

    res = {}
    for kind in PATH_KINDS:
        wc, coords, _ = windowed_inputs(F_AMT_720P, 256, torch.float32, kind)
        bounds = f32_lookup_bounds(wc, coords)
        (bound, bound_by), (cc_bound, cc_by) = bounds["tf32"], bounds["cuda_core"]
        print(f"{kind}: {fmt_extent(extent_summary(mma_tile_extents(wc, coords), 256, 4))}; "
              f"{bounds['bytes'] / 1e6:.1f} MB, {bounds['flops'] / 1e9:.2f} GFLOP float32; the "
              f"CUDA-core kernel's bound {cc_bound:.4f} ms ({cc_by})", flush=True)
        res[kind] = _timed_turns(built, wc, coords, iters)
        _print_turns(res[kind], f"720p F AMT {F_AMT_720P} C=256 f32 {kind}", bound,
                     f"3xTF32 {bound_by}", smi)
        del wc, coords
        torch.cuda.empty_cache()
    return res


BWD_SHAPES = [("stage-2 AMT", (4, 28, 28), torch.float32),
              ("720p F AMT", F_AMT_720P, torch.float32),
              ("2048x1088 DS 1.0 RAFT", RAFT_2K, torch.bfloat16)]
# the backward's own kernels by part: the query side (with its level sum
# where it splits the levels), the destination side, the chunk sum
BWD_PARTS = {"query": ("query", "level_sum"), "dest": ("dest",), "chunk_sum": ("chunk_sum",)}


def bitwise_equal(xs, ys) -> bool:
    """Whether two sequences of float32 or bf16 tensors hold the same bits."""
    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    return len(xs) == len(ys) and all(torch.equal(bits(a), bits(b)) for a, b in zip(xs, ys))


def bwd_parts(total: float | None, rows: dict) -> dict:
    """A backward call's device time by part from a `device_ms` reading:
    the query side, the order (the sort, the offsets and plan kernels: the
    rest of the call), the destination side and the chunk sum."""
    if total is None:
        return {"query": None, "order": None, "dest": None, "chunk_sum": None}
    own = {part: sum(v for k, v in rows.items()
                     if any(f"windowed_corr_bwd_{name}_kernel" in k for name in names))
           for part, names in BWD_PARTS.items()}
    return {"query": own["query"], "order": total - sum(own.values()), "dest": own["dest"],
            "chunk_sum": own["chunk_sum"]}


def main_bwd(iters=10):
    """The backward (`bwd`) beside its ablations (`BWD_VARIANTS`): `bwd`
    checked against `windowed_corr_lookup_backward_plain`
    (`windowed_bwd_agreement`) in the cases of `WINDOWED_CASES`,
    `TF32_CASES` and `WINDOWED_BWD_CASES`, with and without d_coords, two
    calls' d_levels bitwise equal; then all timed by the device time of
    their whole call and its parts (`bwd_parts`) at `BWD_SHAPES`, in-frame
    coordinates, twice, in opposite orders, against the bound
    (`bwd_bound`)."""
    smi = _card()
    src = (CSRC / "windowed_corr_bwd.cu").read_text()
    texts = {"bwd": src, **{name: bwd_variant_source(name, src) for name in BWD_VARIANTS}}
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        built = dict(zip(texts, pool.map(
            lambda name: bind(name, texts[name], WindowedCorrBwdKernel), texts)))
    for name, (_, log) in built.items():
        print(f"{name}: ptxas {log}", flush=True)
    kernel = built["bwd"][0]
    cases = WINDOWED_CASES + TF32_CASES + WINDOWED_BWD_CASES
    for i, (c, dtype, kind, radius, levels, shape) in enumerate(cases):
        wc, coords, _ = windowed_inputs(shape, c, dtype, kind, levels, seed=i)
        out_shape = (shape[0], levels * (2 * radius + 1) ** 2, *shape[1:])
        gen = torch.Generator(device="cpu").manual_seed(i)
        g = torch.randn(out_shape, generator=gen).to(dtype).cuda()
        ref = windowed_corr_lookup_backward_plain(wc, coords, g, radius)
        for need_coords in (True, False):
            got = kernel(wc, coords, g, radius, need_coords)
            again = kernel(wc, coords, g, radius, need_coords)
            agree = windowed_bwd_agreement(got, ref)
            same = bitwise_equal(got[1], again[1])
            if not agree["ok"] or not same or (got[2] is None) == need_coords:
                raise AssertionError(f"bwd disagrees with the plain backward at {shape} C={c} "
                                     f"{dtype} {kind}, need_coords {need_coords} (d_levels "
                                     f"bitwise over two calls: {same}): {agree}")
        del wc, coords, g, ref
    print(f"bwd agrees with the plain backward in all {len(cases)} cases, d_levels bitwise "
          f"equal over two calls", flush=True)
    res = {}
    for label, shape, dtype in BWD_SHAPES:
        wc, coords, _ = windowed_inputs(shape, 256, dtype, "in_frame")
        gen = torch.Generator(device="cpu").manual_seed(1)
        g = torch.randn((shape[0], 4 * 81, *shape[1:]), generator=gen).to(dtype).cuda()
        bound = bwd_bound(wc, coords)
        times = {name: [] for name in built}
        for order in (list(built), list(reversed(built))):
            for name in order:
                total, rows = device_ms(lambda k=built[name][0]: k(wc, coords, g), iters=iters)
                times[name].append((total, bwd_parts(total, rows)))
        for name, turns in times.items():
            print(f"windowed_corr backward {label} {shape} C=256 {str(dtype)[6:]} {name:13s} "
                  f"device {' / '.join('n/a' if t is None else f'{t:.4f}' for t, _ in turns)} ms "
                  f"({' / '.join('n/a' if t is None else f'{100 * bound['bound_ms'] / t:.1f}' for t, _ in turns)}"
                  f"% of the {bound['bound_ms']:.4f} ms {bound['bound_by']} bound); parts "
                  + " / ".join(", ".join(f"{k} {'n/a' if v is None else f'{v:.4f}'}"
                                         for k, v in parts.items()) for _, parts in turns)
                  + f"; {smi}", flush=True)
        res[label] = times
        del wc, coords, g
        torch.cuda.empty_cache()
    return res


def main(iters=10):
    smi = _card()
    src = (CSRC / "windowed_corr.cu").read_text()
    texts = {name: variant_source(name, src) for name in VARIANTS}
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda name: bind(name, texts[name]), texts)))
    for name, (_, log) in built.items():
        print(f"{name}: ptxas {log}", flush=True)

    checks = [(shape, c, dtype, kind, radius, levels)
              for c, dtype, kind, radius, levels, shape in WINDOWED_CASES]
    checks.append((AMT_2K, 256, torch.bfloat16, "in_frame", 4, 4))
    for i, (shape, c, dtype, kind, radius, levels) in enumerate(checks):
        wc, coords, _ = windowed_inputs(shape, c, dtype, kind, levels, seed=i)
        ref = windowed_corr_lookup_plain(wc, coords, radius)
        for name, (kernel, _) in built.items():
            if VARIANTS[name][1]:
                agree = windowed_agreement(kernel(wc, coords, radius), ref)
                if not agree["ok"]:
                    raise AssertionError(f"variant {name} disagrees with the plain version at "
                                         f"{shape} C={c} {dtype} {kind}: {agree}")
        del wc, coords, ref
    print(f"every variant that computes the lookup agrees with the plain version in all "
          f"{len(checks)} cases", flush=True)

    res = {}
    for label, shape in (("2048x1088 DS 1.0 RAFT", RAFT_2K), ("720p RAFT", RAFT_720P)):
        wc, coords, _ = windowed_inputs(shape, 256, torch.bfloat16, "in_frame")
        bound, bound_by = bound_ms(*corr_ops.windowed_corr_work(wc, coords))
        times = _timed_turns(built, wc, coords, iters)
        _print_turns(times, f"{label} {shape} C=256 bf16", bound, bound_by, smi)
        res[label] = times
        del wc, coords
        torch.cuda.empty_cache()
    return res


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = parser.add_mutually_exclusive_group()
    which.add_argument("--mma", action="store_true",
                       help="the bf16 tensor-core kernel and its ablations, beside the CUDA-core kernel")
    which.add_argument("--tf32", action="store_true",
                       help="the float32 tensor-core kernel, its stage configurations and "
                            "ablations, beside the CUDA-core kernel")
    which.add_argument("--bwd", action="store_true",
                       help="the backward beside its ablations")
    args = parser.parse_args()
    (main_mma if args.mma else main_tf32 if args.tf32 else main_bwd if args.bwd else main)()
