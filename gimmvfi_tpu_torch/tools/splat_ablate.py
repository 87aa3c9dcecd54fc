"""The splat kernels' inputs, their check cases on the card, their PyTorch
yardsticks and their ablations.

    python -m gimmvfi_tpu_torch.tools.splat_ablate [--backward] [--against SOURCE ...]

Card only: without CUDA `main` raises. Without `--backward` it ablates the
forward kernel; each variant is `csrc/softsplat.cu` with a text
substitution, built with the same nvcc flags into `build/kernels/ablate/`:
  - kernel: the source as it is (128 pixels a block, one value a lane);
  - pixels256: a block owns 256 source pixels instead of 128;
  - vec4_loads: each lane reads 4 consecutive values with one 16-byte load
    and adds them one by one;
  - streaming_loads: the values are read with `__ldcs` (evict first), which
    keeps them from taking L2 lines that the atomics use;
  - red_v2, red_v4: lanes over runs of 2 or 4 channels of a pixel, one
    float2 or float4 atomicAdd a corner (sm_90, global memory), into an
    output whose channel pitch is C rounded up to 2 or 4: the runner
    allocates and zeroes that padded output and returns a view of its first
    C channels;
  - no_loads: every value is 1, so nothing of vals is read: the atomics'
    cost with the geometry;
  - no_atomics: the values and their geometry are read and summed in a
    register, and nothing is added: the cost of all but the atomics.
The last two do not compute the splat and are not checked.
`--against` adds any other source with the same `softsplat_sum_f32`
launcher, e.g. an earlier version of the kernel taken from git history.
Every variant is checked against `splat_sum_plain`, then each is timed at
(1, 736, 1280, 17) on a random flow field (std 20 px) and on a smooth one
(`smooth_flow`), by its own device time from a `torch.profiler` trace, twice,
in opposite orders. A timed call is what the wrapper does: a zero fill and
one launch; both are printed, the kernel alone and the call.

With `--backward` it ablates the backward kernel, `csrc/softsplat_bwd.cu`,
at stage-1 training's (32, 256, 256, 17) (`TRAIN_SPLAT`) on a random and a
smooth field of std 8 px, by device rows, twice in opposite orders, in
the modes of each variant of `BWD_VARIANTS`: "full" (d_vals and d_flow)
and "d_vals" (no d_flow, vals not read, every path's mode). A variant
lists one set of substitutions for each design it knows (this kernel's,
and the earlier warp-shuffle kernel's); a source takes the first set that
applies, and a variant none of whose sets applies is left out for that
source. The variants:
  - kernel: the source as it is;
  - no_flow_sum: full mode without the per-pixel sums over channels (this
    design: the pixel threads' adds; the warp-shuffle design's: the segmented
    sum, its shared-memory atomics left);
  - one_gather: d_vals mode with one gather of g instead of four;
  - no_gathers: d_vals mode with g never read (every corner reads 1);
  - vals_tile4x32, flow_raster: the d_vals mode's tile as 4 rows of 32
    pixels (not one row of 128), or the d_flow mode's as one row (not 4);
  - vals_unroll2, flow_unroll2: 2 values in flight a thread in d_vals
    mode (not 1), or with d_flow (not 4);
  - pitch17, pitch5: d_flow chunks of 17 or 5 channels (not 9);
  - flow_uncapped: the d_flow kernel's registers not capped to let 8
    blocks share an SM (ptxas gives it 80);
  - streaming: d_vals written and vals and flow read with the
    evict-first hints (`__stcs`, `__ldcs`), leaving L2 to g.
The variants that compute the backward are checked against
`splat_sum_backward_plain` in `BWD_CASES` first. `--against` adds any
other source with the same launcher as the source it names (a forward's
`softsplat_sum_f32` or a backward's `softsplat_sum_bwd_f32`), e.g. an
earlier version taken from git history; a backward source gets the
variants too. The backward section also times the PyTorch calls that
compute the same functions (`library_calls`) beside the kernel.

`splat_inputs`, `CHECK_CASES`, `bwd_inputs`, `BWD_CASES`,
`library_calls` and `library_agreement` are shared with `chip_smoke.py`
phases 3 and 11 and the card tests of `tests/test_torch_softsplat.py` and
`tests/test_torch_splat_backward.py`.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.softsplat import splat_sum_backward_plain, splat_sum_plain
from ..utils.kernel_build import CSRC, build_text, substitute
from ..utils.timing import bound_ms, device_ms, fmt_ms, kernel_row

MAIN_SHAPE = (1, 736, 1280, 17)  # one latent splat of the 720p main path
COARSE = (12, 20)  # the smooth field's grid of independent vectors at 720p
# (shape, flow field, flow std in px): the main path's shape on both fields
# and with non-finite and far flows; C in {1, 3, 5, 17, 33, 64}; N = 2; value
# counts that are not a multiple of 4 (the 16-byte loads' ragged tail:
# 2*37*53*17 and 7*13*5); one pixel block of one channel
CHECK_CASES = [
    (MAIN_SHAPE, "random", 20.0),
    (MAIN_SHAPE, "smooth", 20.0),
    (MAIN_SHAPE, "non_finite", 20.0),
    ((1, 64, 96, 1), "random", 3.0),
    ((1, 64, 96, 3), "smooth", 4.0),
    ((1, 48, 80, 5), "random", 6.0),
    ((1, 40, 72, 33), "smooth", 8.0),
    ((1, 32, 48, 64), "random", 5.0),
    ((2, 37, 53, 17), "smooth", 6.0),
    ((2, 24, 16, 3), "random", 30.0),
    ((1, 7, 13, 5), "random", 2.0),
    ((1, 8, 8, 1), "random", 0.6),
]
# the kernel's walk over its block's values, which some variants replace
WALK = """  const int m = np * c;  // values this block owns
  const int dq = kPixels / c, dr = kPixels % c;
  int q = t / c, r = t % c;  // pixel and channel of the lane's value
#pragma unroll 4
  for (int e = t; e < m; e += kPixels) {
    splat_value(src[e], s_dst[q], s_wgt[q], c, r, out);
    q += dq;
    r += dr;
    if (r >= c) {
      r -= c;
      ++q;
    }
  }
"""
# 4 values a lane from one 16-byte load (the block's first value is 16-byte
# aligned, kPixels being a multiple of 4), a scalar tail
VEC4_LOADS_WALK = """  const int m = np * c;  // values this block owns
  const int m4 = m / 4;
  const int dq = 4 * kPixels / c, dr = 4 * kPixels % c;
  int q = 4 * t / c, r = 4 * t % c;  // pixel and channel of the lane's first value
  for (int e4 = t; e4 < m4; e4 += kPixels) {
    const float4 v = reinterpret_cast<const float4*>(src)[e4];
    const float vs[4] = {v.x, v.y, v.z, v.w};
    int qq = q, rr = r;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      splat_value(vs[k], s_dst[qq], s_wgt[qq], c, rr, out);
      if (++rr == c) {
        rr = 0;
        ++qq;
      }
    }
    q += dq;
    r += dr;
    if (r >= c) {
      r -= c;
      ++q;
    }
  }
  for (int e = 4 * m4 + t; e < m; e += kPixels) {
    const int qq = e / c;
    splat_value(src[e], s_dst[qq], s_wgt[qq], c, e - qq * c, out);
  }
"""
# lanes over (pixel, run of VEC channels), one VEC-wide atomic a corner into
# an output whose channel pitch is C rounded up to VEC (the runner pads it)
VECTOR_RED_WALK = """  constexpr int kVec = VEC;
  const int cp = (c + kVec - 1) / kVec * kVec;  // the padded output's channel pitch
  const int nv = cp / kVec;  // channel runs a pixel
  const int m = np * nv;
  const int dq = kPixels / nv, dg = kPixels % nv;
  int q = t / nv, g = t % nv;  // pixel and channel run of the lane
  for (int e = t; e < m; e += kPixels) {
    const int ch = g * kVec;
    float v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = ch + k < c ? src[q * c + ch + k] : 0.0f;
    const int4 d = s_dst[q];
    const float4 wg = s_wgt[q];
    const int dd[4] = {d.x, d.y, d.z, d.w};
    const float ww[4] = {wg.x, wg.y, wg.z, wg.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (dd[k] < 0) continue;
      float* o = out + (int64_t)dd[k] * cp + ch;
      RED;
    }
    q += dq;
    g += dg;
    if (g >= nv) {
      g -= nv;
      ++q;
    }
  }
"""
RED2 = "atomicAdd(reinterpret_cast<float2*>(o), make_float2(v[0] * ww[k], v[1] * ww[k]))"
RED4 = ("atomicAdd(reinterpret_cast<float4*>(o), make_float4(v[0] * ww[k], v[1] * ww[k], "
        "v[2] * ww[k], v[3] * ww[k]))")
# the walk with no atomics: the values and their geometry are read and
# kept alive in a sum that is stored only if it hits a value it never takes
NO_ATOMICS_WALK = WALK.replace(
    "#pragma unroll 4\n", "  float keep = 0.0f;\n#pragma unroll 4\n").replace(
    "    splat_value(src[e], s_dst[q], s_wgt[q], c, r, out);\n",
    "    const int4 d = s_dst[q];\n"
    "    const float4 wg = s_wgt[q];\n"
    "    keep += src[e] * (wg.x + wg.y + wg.z + wg.w) + (float)(d.x + d.y + d.z + d.w + r);\n"
) + "  if (keep == 1.2345e-38f) out[t] = keep;\n"
# variant name -> (substitutions into the kernel's source, output channel
# pitch multiple, whether it computes the splat)
VARIANTS = {
    "kernel": ([], 1, True),
    "pixels256": ([("constexpr int kPixels = 128;", "constexpr int kPixels = 256;")], 1, True),
    "vec4_loads": ([(WALK, VEC4_LOADS_WALK)], 1, True),
    "streaming_loads": ([("splat_value(src[e], s_dst[q]", "splat_value(__ldcs(src + e), s_dst[q]")],
                        1, True),
    "red_v2": ([(WALK, VECTOR_RED_WALK.replace("VEC", "2").replace("RED", RED2))], 2, True),
    "red_v4": ([(WALK, VECTOR_RED_WALK.replace("VEC", "4").replace("RED", RED4))], 4, True),
    "no_loads": ([("splat_value(src[e], s_dst[q]", "splat_value(1.0f, s_dst[q]")], 1, False),
    "no_atomics": ([(WALK, NO_ATOMICS_WALK)], 1, False),
}


TRAIN_SPLAT = (32, 256, 256, 17)  # stage-1 training's splats: batch 32, 256^2, 16 channels + weight
TRAIN_STD = 8.0
# the backward's check cases: the training shape on all three fields, then
# the small forward cases; C above one d_flow chunk (130, 34), even C under
# one (16), widths off the 32-column tile (37, 53, 13) and heights off its
# 4 rows
BWD_CASES = [(TRAIN_SPLAT, field, TRAIN_STD) for field in ("random", "smooth", "non_finite")] + [
    c for c in CHECK_CASES if c[0] != MAIN_SHAPE] + [
    ((2, 19, 37, 130), "smooth", 5.0),
    ((1, 9, 53, 34), "random", 4.0),
    ((3, 6, 45, 16), "random", 3.0),
]
# this design's per-pixel sums, made dead at run time (the products are
# still written)
_PIXEL_SUMS = "if (t < np) {\n        const float4* sp"
_D_VALS_STORE = ("      d_vals[(int64_t)s_src[qs[u]] * c + c0 + rs[u]] =\n"
                 "          wt.x * gk[u][0] + wt.y * gk[u][1] + wt.z * gk[u][2] + wt.w * gk[u][3];")
# variant -> (one list of substitutions for each design it knows, the
# modes it is timed in, whether it computes the backward)
BWD_VARIANTS = {
    "kernel": ([[]], ("full", "d_vals"), True),
    "no_flow_sum": ([
        [(_PIXEL_SUMS, _PIXEL_SUMS.replace("t < np", "t < np && h < 0"))],
        [("for (int o = 1; o < 32; o <<= 1)", "for (int o = 32; o < 32; o <<= 1)")],
    ], ("full",), False),
    "one_gather": ([
        [(f"gk[u][{k}] = gather(g, d.{a}, c, c0 + r);", f"gk[u][{k}] = gk[u][0];")
         for k, a in ((1, "y"), (2, "z"), (3, "w"))],
        [(f"g{k} = gather(g, d.{a}, c, r);", f"g{k} = g0;") for k, a in ((1, "y"), (2, "z"), (3, "w"))],
    ], ("d_vals",), False),
    "no_gathers": ([[("return dst >= 0 ? __ldg(g + (int64_t)dst * c + ch) : 0.0f;",
                      "return dst >= 0 ? 1.0f : 0.0f;")]], ("d_vals",), False),
    "vals_tile4x32": ([[("constexpr int kTileRowsVals = 1;", "constexpr int kTileRowsVals = 4;")]],
                      ("d_vals",), True),
    "flow_raster": ([[("constexpr int kTileRowsFlow = 4;", "constexpr int kTileRowsFlow = 1;")]],
                    ("full",), True),
    "vals_unroll2": ([[("constexpr int kUnrollVals = 1;", "constexpr int kUnrollVals = 2;")]],
                     ("d_vals",), True),
    "flow_unroll2": ([[("constexpr int kUnrollFlow = 4;", "constexpr int kUnrollFlow = 2;")]],
                     ("full",), True),
    "pitch17": ([[("constexpr int kPitch = 9;", "constexpr int kPitch = 17;")]], ("full",), True),
    "pitch5": ([[("constexpr int kPitch = 9;", "constexpr int kPitch = 5;")]], ("full",), True),
    "flow_uncapped": ([[("constexpr int kMinBlocksFlow = 8;", "constexpr int kMinBlocksFlow = 1;")]],
                      ("full",), True),
    "streaming": ([[(_D_VALS_STORE,
                     "      __stcs(d_vals + (int64_t)s_src[qs[u]] * c + c0 + rs[u],\n"
                     "             wt.x * gk[u][0] + wt.y * gk[u][1] + wt.z * gk[u][2] + "
                     "wt.w * gk[u][3]);"),
                    ("v[u] = __ldg(vals + (int64_t)s_src[q] * c + c0 + r);",
                     "v[u] = __ldcs(vals + (int64_t)s_src[q] * c + c0 + r);"),
                    ("const float2 f = flow[p];", "const float2 f = __ldcs(flow + p);")]],
                  ("full", "d_vals"), True),
}


def smooth_flow(rng: np.random.Generator, n: int, h: int, w: int, std: float,
                coarse=COARSE) -> np.ndarray:
    """A smooth flow field (N, H, W, 2) float32: a coarse grid of N(0, std)
    vectors, bilinearly upsampled to (H, W)."""
    grid = rng.standard_normal((n, 2, *coarse)).astype(np.float32) * std
    up = F.interpolate(torch.from_numpy(grid), size=(h, w), mode="bilinear", align_corners=False)
    return up.permute(0, 2, 3, 1).contiguous().numpy()


def splat_inputs(shape, field: str, std: float, seed: int = 0, device="cuda"):
    """vals ~ N(0, 1) and a flow field from a seed, float32 on `device`.

    field: "random" (independent N(0, std) vectors), "smooth"
    (`smooth_flow`) or "non_finite" (random, then 1% NaN, 1% +inf, 1% -inf
    and 5% scaled by 1e4)."""
    n, h, w, _ = shape
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(shape).astype(np.float32)
    if field == "smooth":
        flow = smooth_flow(rng, n, h, w, std)
    elif field in ("random", "non_finite"):
        flow = (rng.standard_normal((n, h, w, 2)) * std).astype(np.float32)
    else:
        raise ValueError(f"unknown flow field {field!r}")
    if field == "non_finite":
        pick = rng.random((n, h, w, 2))
        flow[pick < 0.01] = np.nan
        flow[(pick >= 0.01) & (pick < 0.02)] = np.inf
        flow[(pick >= 0.02) & (pick < 0.03)] = -np.inf
        flow[(pick >= 0.03) & (pick < 0.08)] *= 1e4
    return torch.from_numpy(vals).to(device), torch.from_numpy(flow).to(device)


def splat_bound(vals: torch.Tensor) -> tuple[float, str]:
    """Least time on the card: vals and flow read once, the output written once."""
    n, h, w, c = vals.shape
    return bound_ms(4 * n * h * w * (c + 2 + c))


def kernel_bound_ok(err: float, ref: torch.Tensor) -> tuple[bool, float]:
    """The kernel's tolerance against the plain version: 1e-5 x max(1,
    max|plain|), float32 sums in another (atomic) order. Returns (ok, bound)."""
    bound = 1e-5 * max(1.0, float(ref.abs().max()))
    return err <= bound, bound


def variant_source(name: str, src: str) -> str:
    """`src` with variant `name`'s substitutions; each must match exactly once."""
    return substitute(src, VARIANTS[name][0], f"variant {name}")


def build_source(name: str, text: str):
    """Build `text` as build/kernels/ablate/softsplat_<name>.cu and bind its
    launcher; returns (function, ptxas register lines)."""
    lib, log = build_text(f"softsplat_{name}", text)
    fn = lib.softsplat_sum_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keep = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return fn, " | ".join(keep)



def bwd_inputs(shape, field: str, std: float, seed: int, device="cuda"):
    """`splat_inputs` and a seeded N(0, 1) output gradient g."""
    vals, flow = splat_inputs(shape, field, std, seed=seed, device=device)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1000)
    return vals, flow, torch.randn(shape, generator=gen).to(device)


def splat_bwd_bound(vals: torch.Tensor, need_flow: bool = True) -> tuple[float, str]:
    """Least time of one backward: flow and g read once and d_vals written
    once; with d_flow, vals read and d_flow written once too."""
    n, h, w, c = vals.shape
    return bound_ms(4 * n * h * w * (2 + c + c + ((c + 2) if need_flow else 0)))


def bwd_variant_source(name: str, src: str) -> str | None:
    """`src` with the first of variant `name`'s substitution sets that
    applies (each `old` exactly once), or None where none does."""
    for subs in BWD_VARIANTS[name][0]:
        if all(src.count(old) == 1 for old, _ in subs):
            return substitute(src, subs, f"backward variant {name}")
    return None


def grid_sample_grid(flow: torch.Tensor) -> torch.Tensor:
    """The splat positions (j + u, i + v) as `grid_sample`'s normalized grid
    (align_corners=True: -1 and 1 are the centres of the edge pixels),
    (N, H, W, 2); a non-finite position goes to (-10, -10), as in the
    kernels. H and W must exceed 1."""
    n, h, w, _ = flow.shape
    jj = torch.arange(w, dtype=torch.float32, device=flow.device).view(1, 1, w)
    ii = torch.arange(h, dtype=torch.float32, device=flow.device).view(1, h, 1)
    x, y = jj + flow[..., 0], ii + flow[..., 1]
    finite = torch.isfinite(x) & torch.isfinite(y)
    x, y = torch.where(finite, x, -10.0), torch.where(finite, y, -10.0)
    return torch.stack([x * (2.0 / (w - 1)) - 1.0, y * (2.0 / (h - 1)) - 1.0], dim=-1)


def library_calls(vals: torch.Tensor, flow: torch.Tensor, g: torch.Tensor | None = None) -> dict:
    """The single PyTorch calls that compute the splat's functions, as
    closures over inputs made here, outside any timed region: the
    normalized grid (`grid_sample_grid`) and NCHW views of the
    channels-last tensors (`permute(0, 3, 1, 2)`: no copy, channels-last
    strides), each call's output as it comes (NCHW; a permute reads it as
    (N, H, W, C)). The splat is `grid_sample`'s bilinear, zeros-padded,
    align_corners geometry at (j + u, i + v):
      forward: `aten.grid_sampler_2d_backward(vals, zeros, grid, 0, 0, True,
               [True, False])`, the input gradient: the splat itself;
      d_vals:  `F.grid_sample(g, grid, "bilinear", "zeros", True)`;
      d_flow:  `aten.grid_sampler_2d_backward(vals, g, grid, 0, 0, True,
               [False, True])`, the grid gradient: d_flow times
               ((W - 1) / 2, (H - 1) / 2).
    Without g, only the forward."""
    grid = grid_sample_grid(flow)
    v = vals.permute(0, 3, 1, 2)
    zeros = torch.zeros_like(vals).permute(0, 3, 1, 2)
    backward = torch.ops.aten.grid_sampler_2d_backward
    calls = {"forward": lambda: backward(v, zeros, grid, 0, 0, True, [True, False])[0]}
    if g is not None:
        gv = g.permute(0, 3, 1, 2)
        calls["d_vals"] = lambda: F.grid_sample(gv, grid, mode="bilinear", padding_mode="zeros",
                                                align_corners=True)
        calls["d_flow"] = lambda: backward(v, gv, grid, 0, 0, True, [False, True])[1]
    return calls


def kernel_layout(name: str, out: torch.Tensor) -> torch.Tensor:
    """Yardstick `name`'s output in the kernels' layout: (N, H, W, C) for
    the forward and d_vals, d_flow (N, H, W, 2) from the grid gradient."""
    if name != "d_flow":
        return out.permute(0, 2, 3, 1)
    h, w = out.shape[1:3]
    return out / torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], device=out.device)


def near_integer(flow: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """(N, H, W, 2): where the splat position's x (component 0) or y
    (component 1) lies within `eps` px of an integer. There d_flow's
    component jumps (the bilinear cell changes), so a position moved by
    the normalized-coordinate round trip (~1e-5 px) may read the other
    side; the yardstick's d_flow is held everywhere else."""
    n, h, w, _ = flow.shape
    jj = torch.arange(w, dtype=torch.float32, device=flow.device).view(1, 1, w)
    ii = torch.arange(h, dtype=torch.float32, device=flow.device).view(1, h, 1)
    pos = torch.stack([jj + flow[..., 0], ii + flow[..., 1]], dim=-1)
    return (pos - pos.round()).abs() < eps


def library_tolerance(ref: torch.Tensor) -> float:
    """1e-4 x max(1, max|plain|): the yardsticks take each position through
    normalized coordinates and back, about 1e-6 of it relative, which moves
    the bilinear weights by that much; float32 sums in another order come
    on top. Ample for both."""
    return 1e-4 * max(1.0, float(ref.abs().max()))


def library_agreement(vals, flow, g=None) -> dict:
    """Each yardstick of `library_calls` against the plain version on these
    inputs (finite flows): {name: (max abs error, tolerance, layout of the
    call's output, and for d_flow the components left out)}. d_flow is held
    where the position is not within 1e-3 px of an integer in that
    component (`near_integer`). Raises where one is over its tolerance."""
    calls = library_calls(vals, flow, g)
    plain = {"forward": splat_sum_plain(vals, flow)}
    if g is not None:
        plain["d_vals"], plain["d_flow"] = splat_sum_backward_plain(vals, flow, g)
    res = {}
    for name, call in calls.items():
        raw = call()
        layout = f"output {tuple(raw.shape)} strides {tuple(raw.stride())}"
        gap = (kernel_layout(name, raw) - plain[name]).abs()
        if name == "d_flow":
            skip = near_integer(flow)
            gap = torch.where(skip, 0.0, gap)
            layout += (f"; {int(skip.sum())} of {skip.numel()} components within 1e-3 px of "
                       f"an integer position left out")
        err = float(gap.max())
        tol = library_tolerance(plain[name])
        res[name] = (err, tol, layout)
        if not err <= tol:
            raise AssertionError(f"yardstick {name} disagrees with the plain version at "
                                 f"{tuple(vals.shape)}: {err:.3e} > {tol:.3e}")
    return res


def build_bwd_source(name: str, text: str):
    """Build a backward source `text` as build/kernels/ablate/softsplat_bwd_<name>.cu
    and bind its launcher; returns (function, ptxas lines)."""
    lib, log = build_text(f"softsplat_bwd_{name}", text)
    fn = lib.softsplat_sum_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keep = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln]
    return fn, " | ".join(keep)


def bwd_runner(fn, vals, flow, g, mode: str):
    """One launch of a backward build into outputs allocated here: mode
    "full" (d_vals and d_flow) or "d_vals"; returns (d_vals, d_flow or None)."""
    n, h, w, c = vals.shape
    d_vals = torch.empty_like(vals)
    d_flow = torch.empty_like(flow) if mode == "full" else None

    def run():
        err = fn(vals.data_ptr(), flow.data_ptr(), g.data_ptr(), d_vals.data_ptr(),
                 0 if d_flow is None else d_flow.data_ptr(), n, h, w, c,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"softsplat_sum_bwd_f32 launch failed: error {err}")
        return d_vals, d_flow
    return run


def backward_main(against, smi: str, iters: int = 20) -> dict:
    """The backward section (see the module's docstring); returns
    {field: {(build, mode): [device ms of each turn]}}."""
    sources = {"kernel": (CSRC / "softsplat_bwd.cu").read_text()}
    sources.update({f"against_{Path(path).stem}": Path(path).read_text() for path in against})
    specs = {}  # build name -> (source text, modes, computes the backward)
    for src_name, text in sources.items():
        for variant, (_, modes, computes) in BWD_VARIANTS.items():
            out = bwd_variant_source(variant, text)
            if out is None:
                print(f"backward variant {variant} does not apply to {src_name}", flush=True)
                continue
            name = src_name if variant == "kernel" else f"{src_name}:{variant}"
            specs[name] = (out, modes, computes)
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        built = dict(zip(specs, pool.map(
            lambda name: build_bwd_source(name.replace(":", "_"), specs[name][0]), specs)))
    for name, (_, log) in built.items():
        print(f"{name}: ptxas {log}", flush=True)

    checked = [name for name in built if specs[name][2]]
    for i, (shape, field, std) in enumerate(BWD_CASES):
        vals, flow, g = bwd_inputs(shape, field, std, seed=i)
        ref = splat_sum_backward_plain(vals, flow, g)
        for name in checked:
            for mode in ("full", "d_vals"):
                got = bwd_runner(built[name][0], vals, flow, g, mode)()
                for what, a, b in zip(("d_vals", "d_flow"), got, ref):
                    if a is None:
                        continue
                    err = float((a - b).abs().max())
                    ok, bound = kernel_bound_ok(err, b)
                    if not ok:
                        raise AssertionError(f"backward {name} ({mode}) {what} disagrees with "
                                             f"the plain version at {shape} {field}: "
                                             f"{err:.3e} > {bound:.3e}")
        del vals, flow, g, ref
    print(f"backward builds that compute it ({', '.join(checked)}) agree with the plain "
          f"version in both modes in all {len(BWD_CASES)} cases", flush=True)

    res = {}
    for field in ("random", "smooth"):
        vals, flow, g = bwd_inputs(TRAIN_SPLAT, field, TRAIN_STD, seed=0)
        calls = {(name, mode): bwd_runner(built[name][0], vals, flow, g, mode)
                 for name in built for mode in specs[name][1]}
        times = {key: [] for key in calls}
        for order in (list(calls), list(reversed(calls))):
            for key in order:
                _, by_name = device_ms(calls[key], iters=iters)
                times[key].append(kernel_row(by_name, "splat_sum_bwd"))
        for (name, mode), turns in times.items():
            bound, bound_by = splat_bwd_bound(vals, mode == "full")
            print(f"backward {TRAIN_SPLAT} {field} flow std {TRAIN_STD:g} {name:32s} {mode:6s} "
                  f"device {' / '.join(fmt_ms(x) for x in turns)} "
                  f"({' / '.join('-' if x is None else f'{100 * bound / x:.1f}' for x in turns)}% "
                  f"of the {bound:.4f} ms {bound_by} bound); {smi}", flush=True)
        lib = library_calls(vals, flow, g)
        agree = library_agreement(vals, flow, g)
        lib_times = {name: [device_ms(lib[name], iters=iters)[0] for _ in range(2)] for name in lib}
        for name, turns in lib_times.items():
            err, tol, layout = agree[name]
            print(f"backward {TRAIN_SPLAT} {field} yardstick {name:8s} device "
                  f"{' / '.join(fmt_ms(x) for x in turns)} (max_abs_err {err:.3e}, tolerance "
                  f"{tol:.3e}; {layout}); {smi}", flush=True)
        res[field] = {"kernels": times, "library": lib_times}
        del vals, flow, g, calls, lib
        torch.cuda.empty_cache()
    return res


def main(argv=None, iters=20):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--backward", action="store_true",
                        help="ablate the backward kernel instead of the forward one")
    parser.add_argument("--against", nargs="*", default=[],
                        help="other sources with the launcher of the kernel ablated")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if args.backward:
        return backward_main(args.against, smi, iters=iters)
    kernel_src = (CSRC / "softsplat.cu").read_text()
    # name -> (source text, output channel pitch multiple, computes the splat)
    specs = {name: (variant_source(name, kernel_src), multiple, computes)
             for name, (_, multiple, computes) in VARIANTS.items()}
    for path in args.against:
        specs[f"against_{Path(path).stem}"] = (Path(path).read_text(), 1, True)
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        built = dict(zip(specs, pool.map(lambda name: build_source(name, specs[name][0]), specs)))
    for name, (_, log) in built.items():
        print(f"{name}: ptxas {log}", flush=True)

    def runner(name, vals, flow):
        fn, multiple = built[name][0], specs[name][1]
        n, h, w, c = vals.shape
        pitch = -(-c // multiple) * multiple

        def run():
            out = torch.zeros((n, h, w, pitch), dtype=vals.dtype, device=vals.device)
            err = fn(vals.data_ptr(), flow.data_ptr(), out.data_ptr(), n, h, w, c,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"softsplat_sum_f32 launch failed: error {err}")
            return out[..., :c]
        return run

    for shape, field, std in CHECK_CASES:
        vals, flow = splat_inputs(shape, field, std)
        ref = splat_sum_plain(vals, flow)
        for name in (name for name in built if specs[name][2]):
            err = float((runner(name, vals, flow)() - ref).abs().max())
            ok, bound = kernel_bound_ok(err, ref)
            if not ok:
                raise AssertionError(f"variant {name} disagrees with the plain version at "
                                     f"{shape} {field}: {err:.3e} > {bound:.3e}")
    print(f"every variant that computes the splat agrees with the plain version in all "
          f"{len(CHECK_CASES)} cases", flush=True)

    res = {}
    for field in ("random", "smooth"):
        vals, flow = splat_inputs(MAIN_SHAPE, field, 20.0)
        bound, bound_by = splat_bound(vals)
        calls = {name: runner(name, vals, flow) for name in built}
        times = {name: [] for name in calls}
        for order in (list(calls), list(reversed(calls))):
            for name in order:
                total, by_name = device_ms(calls[name], iters=iters)
                own = sum(v for k, v in by_name.items() if "splat" in k)
                times[name].append((own, total))
        for name, turns in times.items():
            print(f"splat {MAIN_SHAPE} {field} flow std 20 {name:28s} kernel "
                  f"{' / '.join(f'{own:.4f}' for own, _ in turns)} ms "
                  f"({' / '.join(f'{100 * bound / own:.1f}' for own, _ in turns)}% of the "
                  f"{bound:.4f} ms {bound_by} bound), call with zero fill "
                  f"{' / '.join(f'{total:.4f}' for _, total in turns)} ms; {smi}", flush=True)
        res[field] = times
    return res


if __name__ == "__main__":
    main()
