"""The splat kernel's inputs, its check cases on the card, and its ablations.

    python -m gimmvfi_tpu_torch.tools.splat_ablate [--against SOURCE ...]

Card only: without CUDA `main` raises. Each variant is `csrc/softsplat.cu`
with a text substitution, built with the same nvcc flags into
`build/kernels/ablate/`:
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

`splat_inputs` and `CHECK_CASES` are shared with `chip_smoke.py` phase 3
and the card tests of `tests/test_torch_softsplat.py`.
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

from ..ops.softsplat import splat_sum_plain
from ..utils.kernel_build import CSRC, build_text, substitute
from ..utils.timing import bound_ms, device_ms

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


def main(argv=None, iters=20):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", nargs="*", default=[],
                        help="other sources with the same softsplat_sum_f32 launcher")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
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
